"""Layer implementations; importing this registers every ported layer."""
from . import attention, dense, recurrent  # noqa: F401
