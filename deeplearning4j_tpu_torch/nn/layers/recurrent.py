"""Recurrent layers: GravesLSTM with peepholes, bidirectional, RNN output head,
the sequence embedding and the last-step layer (counterpart of
``deeplearning4j_tpu/nn/layers/recurrent.py``).

Gate semantics as in the JAX package: columns [a, f, o, i]; f and i see
c_{t-1} through peepholes pF/pI, o sees c_t through pO; c_t = f*c_{t-1} + i*a;
h_t = o * act(c_t). Data is [batch, time, features]. The input projection
``x @ W + b`` for all steps is one product, computed time-major and left to
``torch.matmul`` under autograd, as the JAX package leaves it to XLA; the
recurrence is the sequence op of ``ops`` (the CUDA kernels on the card,
their plain versions on the CPU) on one of two routes, which the caller
picks with ``lstm_variant``:

- "seqfused" (the default): ``ops.lstm_sequence_apply`` runs the whole
  sequence, under grad ``ops.LstmSequenceFunction`` (training forward and
  backward kernels, masked or not), the lean primal otherwise;
- "fusedcell": a loop over the T steps calls ``ops.fused_lstm_cell`` (the
  per-step cell kernels, under grad ``ops.LstmCellFunction``) and masks
  outside the kernel, as the JAX package's scan does under its "fusedcell"
  variant.

The bidirectional layer's reverse direction runs the same route on
time-flipped input and a time-flipped mask.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from ... import ops
from ..activations import get_activation, is_builtin
from ..conf.inputs import InputType
from ..losses import get_loss
from .base import BaseLayer, Params, maybe_dropout, register_layer
from .dense import DenseLayer

RecurrentState = Dict[str, torch.Tensor]


def _cell_scan(zx, m, h, c, RW, pF, pI, pO, act: str, gate: str,
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The "fusedcell" route over ``zx`` [T, B, 4H] (``m`` [T, B, 1] or
    None): ``ops.fused_lstm_cell`` at each step, then, with a mask,
    h = m*h + (1-m)*h_prev and the same for c (the JAX scan body). Returns
    (ys [T, B, H], h_T, c_T)."""
    masks = m.unbind(0) if m is not None else (None,) * zx.shape[0]
    ys = []
    for z, m_t in zip(zx.unbind(0), masks):
        h_new, c_new = ops.fused_lstm_cell(z, h, c, RW, pF, pI, pO, act, gate)
        if m_t is not None:
            h_new = m_t * h_new + (1.0 - m_t) * h
            c_new = m_t * c_new + (1.0 - m_t) * c
        h, c = h_new, c_new
        ys.append(h)
    if not ys:
        return zx.new_empty((0,) + tuple(h.shape)), h, c
    return torch.stack(ys), h, c


def _lstm_scan(prefix: str, params: Params, x: torch.Tensor, h0: torch.Tensor,
               c0: torch.Tensor, act_name: str, gate_name: str,
               mask: Optional[torch.Tensor], reverse: bool = False,
               variant: str = "seqfused",
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run one LSTM direction over ``x`` [B, T, n_in]; returns
    (y [B, T, H], h_T, c_T). ``prefix`` selects the direction's weights ("" or
    "bwd_"). Masked steps (``mask`` [B, T] == 0) carry h/c unchanged. A
    reverse direction is the forward route on time-flipped input.
    ``variant`` is the route, "seqfused" or "fusedcell" (ValueError
    otherwise)."""
    ops.check_lstm_variant(variant)
    p = prefix
    W, RW, b = params[p + "W"], params[p + "RW"], params[p + "b"]
    pF, pI, pO = params[p + "pF"], params[p + "pI"], params[p + "pO"]
    zx = (torch.matmul(x.transpose(0, 1), W) + b).contiguous()  # [T, B, 4H]
    m = None
    if mask is not None:
        m = mask.to(zx.dtype).transpose(0, 1).unsqueeze(-1).contiguous()
    if reverse:
        zx = torch.flip(zx, (0,))
        m = None if m is None else torch.flip(m, (0,))
    act, gate = act_name.lower(), gate_name.lower()
    if (ops.supported_lstm_activations(act, gate)
            and is_builtin(act) and is_builtin(gate)):
        if variant == "fusedcell":
            ys, h, c = _cell_scan(zx, m, h0, c0, RW, pF, pI, pO, act, gate)
        else:
            ys, h, c = ops.lstm_sequence_apply(zx, h0, c0, RW, pF, pI, pO, act, gate,
                                               mask=m)
    elif zx.is_cuda:
        raise NotImplementedError(
            f"LSTM activations ({act_name}, {gate_name}) have no CUDA kernel; "
            f"the kernel takes builtin {sorted(ops.lstm_sequence.ACT)}")
    else:
        ys, h, c = ops.lstm_sequence_masked_reference(
            zx, m, h0, c0, RW, pF, pI, pO, get_activation(act_name),
            get_activation(gate_name))
    if reverse:
        ys = torch.flip(ys, (0,))
    return ys.transpose(0, 1), h, c


@register_layer
@dataclass
class GravesLSTM(BaseLayer):
    """LSTM with peephole connections. Params: "W" [n_in, 4H], "RW" [H, 4H],
    "b" [4H], peepholes "pF"/"pI"/"pO" [H]."""

    n_in: int = 0
    n_out: int = 0
    forget_gate_bias_init: float = 1.0
    gate_activation: str = "sigmoid"
    activation: str = "tanh"

    @property
    def is_recurrent(self) -> bool:
        return True

    def get_output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.timesteps)

    def infer_n_in(self, input_type: InputType) -> int:
        return self.n_in or input_type.size

    def _direction_params(self, gen, n_in: int, prefix: str = "") -> Params:
        H = self.n_out
        b = torch.zeros(4 * H)
        b[H:2 * H] = self.forget_gate_bias_init
        return {
            prefix + "W": self._init_weight(gen, (n_in, 4 * H), n_in, H),
            prefix + "RW": self._init_weight(gen, (H, 4 * H), H, H),
            prefix + "b": b,
            prefix + "pF": torch.zeros(H),
            prefix + "pI": torch.zeros(H),
            prefix + "pO": torch.zeros(H),
        }

    def init_params(self, gen, input_type: InputType) -> Params:
        return self._direction_params(gen, self.infer_n_in(input_type))

    # ---- recurrent-state API (streaming rnn_time_step) ----
    def init_recurrent_state(self, batch: int, dtype: torch.dtype,
                             device: torch.device) -> RecurrentState:
        H = self.n_out
        return {"h": torch.zeros((batch, H), dtype=dtype, device=device),
                "c": torch.zeros((batch, H), dtype=dtype, device=device)}

    def apply_seq(self, params: Params, x: torch.Tensor, rstate: RecurrentState,
                  *, mask: Optional[torch.Tensor] = None, train: bool = False,
                  generator: Optional[torch.Generator] = None,
                  lstm_variant: str = "seqfused",
                  ) -> Tuple[torch.Tensor, RecurrentState]:
        x = maybe_dropout(x, self.dropout, train, generator)
        h0 = rstate["h"].to(x.dtype).contiguous()
        c0 = rstate["c"].to(x.dtype).contiguous()
        y, h, c = _lstm_scan("", params, x, h0, c0, self.activation,
                             self.gate_activation, mask, variant=lstm_variant)
        return y, {"h": h, "c": c}

    def apply(self, params, x, state, *, mask=None, train=False, generator=None,
              lstm_variant: str = "seqfused"):
        rstate = self.init_recurrent_state(x.shape[0], x.dtype, x.device)
        y, _ = self.apply_seq(params, x, rstate, mask=mask, train=train,
                              generator=generator, lstm_variant=lstm_variant)
        return y, state


@register_layer
@dataclass
class GravesBidirectionalLSTM(GravesLSTM):
    """Bidirectional peephole LSTM; the two directions are summed. It has no
    streaming state."""

    def init_params(self, gen, input_type: InputType) -> Params:
        n_in = self.infer_n_in(input_type)
        p = self._direction_params(gen, n_in)
        p.update(self._direction_params(gen, n_in, prefix="bwd_"))
        return p

    def apply_seq(self, params, x, rstate, *, mask=None, train=False,
                  generator=None, lstm_variant="seqfused"):
        raise NotImplementedError(
            "Bidirectional LSTM has no streaming or TBPTT state")

    def apply(self, params, x, state, *, mask=None, train=False, generator=None,
              lstm_variant: str = "seqfused"):
        x = maybe_dropout(x, self.dropout, train, generator)
        zeros = torch.zeros((x.shape[0], self.n_out), dtype=x.dtype, device=x.device)
        y_f, _, _ = _lstm_scan("", params, x, zeros, zeros, self.activation,
                               self.gate_activation, mask, variant=lstm_variant)
        y_b, _, _ = _lstm_scan("bwd_", params, x, zeros, zeros, self.activation,
                               self.gate_activation, mask, reverse=True,
                               variant=lstm_variant)
        return y_f + y_b, state


@register_layer
@dataclass
class RnnOutputLayer(DenseLayer):
    """Per-timestep dense + loss head over [B, T, C]; the loss flattens time
    into the batch, with the [B, T] label mask alongside."""

    loss: str = "mcxent"

    @property
    def is_recurrent(self) -> bool:
        return True

    def get_output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.timesteps)

    def infer_n_in(self, input_type: InputType) -> int:
        return self.n_in or input_type.size

    def pre_output(self, params: Params, x):
        z = x @ params["W"]  # [B, T, C]: keeps time, unlike DenseLayer
        if self.has_bias:
            z = z + params["b"]
        return z

    def compute_loss(self, params, x, labels, mask=None, *, train=False,
                     generator=None):
        """The loss over [B*T, C] rows of ``labels`` against the pre-output on
        ``x`` [B, T, H]; ``mask`` [B, T] weights the rows."""
        x = maybe_dropout(x, self.dropout, train, generator)
        preout = self.pre_output(params, x)
        C = preout.shape[-1]
        mask1d = None if mask is None else mask.reshape(-1)
        return get_loss(self.loss)(labels.reshape(-1, C), preout.reshape(-1, C),
                                   self.activation, mask1d)


@register_layer
@dataclass
class RnnEmbeddingLayer(BaseLayer):
    """Sequence token embedding: ids [B, T] (or [B, T, 1]), integer or
    floating (truncated), to rows [B, T, n_out] of W [n_in, n_out], through
    the activation; dropout acts on the looked-up rows. No bias, as in the
    JAX package."""

    n_in: int = 0  # vocab
    n_out: int = 0

    @property
    def is_recurrent(self) -> bool:
        return True

    def get_output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.timesteps)

    def init_params(self, gen, input_type: InputType) -> Params:
        n_in = self.n_in or input_type.size
        return {"W": self._init_weight(gen, (n_in, self.n_out), n_in, self.n_out)}

    def apply(self, params, x, state, *, mask=None, train=False, generator=None):
        idx = x.to(torch.int64)
        if idx.dim() == 3 and idx.shape[-1] == 1:
            idx = idx[..., 0]
        z = maybe_dropout(params["W"][idx], self.dropout, train, generator)
        return self._activate(z), state


@register_layer
@dataclass
class LastTimeStepLayer(BaseLayer):
    """[B, T, F] -> [B, F] at each row's last unmasked step (the layer form
    of ``LastTimeStepVertex``): without a mask the last step; with a [B, T]
    mask the last nonzero index of each row, so a mask with gaps counts
    its last live step, and a row with none takes step 0."""

    def get_output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(input_type.size)

    def apply(self, params, x, state, *, mask=None, train=False, generator=None):
        if mask is None:
            return x[:, -1, :], state
        steps = torch.arange(x.shape[1], device=x.device)
        last = torch.where(mask > 0, steps, -1).amax(dim=1).clamp(min=0)
        return x[torch.arange(x.shape[0], device=x.device), last], state
