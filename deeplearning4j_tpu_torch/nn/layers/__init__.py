"""Layer implementations; importing this registers every ported layer."""
from . import attention, convolution, dense, moe, normalization, pooling, recurrent  # noqa: F401
