"""Layer implementations; importing this registers every ported layer."""
from . import (attention, center_loss, convolution, dense, frozen, moe, normalization,  # noqa: F401
               pooling, pretrain, recurrent, variational)
