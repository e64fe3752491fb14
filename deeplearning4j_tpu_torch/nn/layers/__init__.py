"""Layer implementations; importing this registers every ported layer."""
from . import attention, convolution, dense, normalization, pooling, recurrent  # noqa: F401
