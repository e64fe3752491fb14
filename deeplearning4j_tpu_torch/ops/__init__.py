"""Op dispatch of the port: hand-written kernels for CUDA tensors, plain
PyTorch for CPU tensors.

Counterpart of ``deeplearning4j_tpu/ops/__init__.py``. There is no knob and
no fallback: a CUDA tensor goes to the kernel, which raises on what it does
not take; a CPU tensor goes to the kernel's plain version. ``variant(t,
lstm_variant)`` reports which of the two runs, under the JAX package's
variant names ("seqfused" for the sequence kernels, "fusedcell" for the
per-step cell kernels, "reference" for the plain math). The LSTM route is
the caller's explicit choice (``MultiLayerNetwork(..., lstm_variant=...)``),
never an environment variable.
"""

from __future__ import annotations

from . import adam as _adam
from . import flash_attention as _flash_attention
from . import lrn as _lrn
from . import lstm_cell as _lstm_cell
from . import lstm_sequence as _lstm_sequence
from . import softmax_xent as _softmax_xent
from .adam import adam_update_reference, fused_adam_update
from .flash_attention import (
    FlashAttentionFunction,
    flash_attention,
    flash_attention_backward,
    flash_attention_backward_reference,
    flash_attention_dkv,
    flash_attention_dkv_reference,
    flash_attention_dq,
    flash_attention_dq_reference,
    flash_attention_forward,
    flash_attention_reference,
)
from .lrn import (
    LrnFunction,
    fused_lrn,
    lrn_backward,
    lrn_backward_reference,
    lrn_forward,
    lrn_reference,
)
from .lstm_cell import (
    LstmCellFunction,
    fused_lstm_cell,
    lstm_cell_backward,
    lstm_cell_backward_reference,
    lstm_cell_forward,
    lstm_cell_forward_reference,
)
from .lstm_sequence import (
    LSTM_VARIANTS,
    LstmSequenceFunction,
    check_lstm_variant,
    fused_lstm_sequence,
    fused_lstm_sequence_masked,
    lstm_sequence_apply,
    lstm_sequence_backward,
    lstm_sequence_backward_reference,
    lstm_sequence_masked_backward,
    lstm_sequence_masked_backward_reference,
    lstm_sequence_masked_reference,
    lstm_sequence_masked_train_forward,
    lstm_sequence_masked_train_reference,
    lstm_sequence_reference,
    lstm_sequence_train_forward,
    lstm_sequence_train_reference,
    supported_lstm_activations,
    variant,
)
from .softmax_xent import (
    SoftmaxXentFunction,
    fused_softmax_xent,
    softmax_xent_backward,
    softmax_xent_backward_reference,
    softmax_xent_reference,
)


_COUNTED = (_lstm_sequence, _softmax_xent, _adam, _flash_attention, _lrn, _lstm_cell)


def counters() -> dict:
    """A snapshot of every kernel's launch count, by kernel name (each op
    module keeps its own ``launches`` dict)."""
    return {name: n for module in _COUNTED for name, n in module.launches.items()}


def reset_counters() -> None:
    """Set every kernel's launch count to 0."""
    for counts in (module.launches for module in _COUNTED):
        for name in counts:
            counts[name] = 0


def lstm_cell(zx, h_prev, c_prev, RW, pF, pI, pO, act_name: str = "tanh",
              gate_name: str = "sigmoid"):
    """One LSTM step (h, c) (the JAX package's ``ops.lstm_cell``): the cell
    kernels on CUDA, their plain versions on the CPU. Unknown activations
    raise ValueError, as there; there is no VMEM budget to fall back from
    (the JAX ``_cell_fits``), so every shape runs the cell. This function
    shadows the ``ops.lstm_cell`` module as an attribute of ``ops``."""
    if not supported_lstm_activations(act_name, gate_name):
        raise ValueError(f"Unknown LSTM activations ({act_name}, {gate_name})")
    return fused_lstm_cell(zx, h_prev, c_prev, RW, pF, pI, pO, act_name, gate_name)


def lrn(x, k: float = 2.0, n: int = 5, alpha: float = 1e-4, beta: float = 0.75):
    """Cross-channel LRN over the trailing axis (the JAX package's
    ``ops.lrn``): the kernels on CUDA, the plain versions on the CPU. There
    is no variant to pick; this function shadows the ``ops.lrn`` module as an
    attribute of ``ops``."""
    return fused_lrn(x, k, n, alpha, beta)


def softmax_xent_rows(labels2d, preout2d):
    """Per-row softmax cross-entropy for 2D [N, C] logits/labels (the JAX
    package's argument order): the kernels on CUDA, the plain versions on
    the CPU, in ``promote_types(dtype, float32)`` (``losses.mcxent`` routes
    here)."""
    return fused_softmax_xent(preout2d, labels2d)


__all__ = [
    "FlashAttentionFunction",
    "LSTM_VARIANTS",
    "LrnFunction",
    "LstmCellFunction",
    "LstmSequenceFunction",
    "SoftmaxXentFunction",
    "adam_update_reference",
    "check_lstm_variant",
    "counters",
    "flash_attention",
    "flash_attention_backward",
    "flash_attention_backward_reference",
    "flash_attention_dkv",
    "flash_attention_dkv_reference",
    "flash_attention_dq",
    "flash_attention_dq_reference",
    "flash_attention_forward",
    "flash_attention_reference",
    "fused_adam_update",
    "fused_lrn",
    "fused_lstm_cell",
    "fused_lstm_sequence",
    "fused_lstm_sequence_masked",
    "lrn",
    "lrn_backward",
    "lrn_backward_reference",
    "lrn_forward",
    "lrn_reference",
    "lstm_cell",
    "lstm_cell_backward",
    "lstm_cell_backward_reference",
    "lstm_cell_forward",
    "lstm_cell_forward_reference",
    "lstm_sequence_apply",
    "lstm_sequence_backward",
    "lstm_sequence_backward_reference",
    "lstm_sequence_masked_backward",
    "lstm_sequence_masked_backward_reference",
    "lstm_sequence_masked_reference",
    "lstm_sequence_masked_train_forward",
    "lstm_sequence_masked_train_reference",
    "lstm_sequence_reference",
    "lstm_sequence_train_forward",
    "lstm_sequence_train_reference",
    "reset_counters",
    "fused_softmax_xent",
    "softmax_xent_backward",
    "softmax_xent_backward_reference",
    "softmax_xent_reference",
    "softmax_xent_rows",
    "supported_lstm_activations",
    "variant",
]
