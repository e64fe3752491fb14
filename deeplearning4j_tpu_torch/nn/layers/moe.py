"""Mixture-of-Experts layer (counterpart of
``deeplearning4j_tpu/nn/layers/moe.py``).

Top-k gating with the capacity-bucketed dense dispatch of the JAX package:
each token's position in its expert's buffer comes from a cumulative sum of
one-hot assignments (every earlier round's fill counted), so no shape
depends on the data; the expert FFNs run as one batched product over the
expert dimension, then a weighted combine. Tokens routed past an expert's
capacity are dropped by the combine (their MoE output is zero), and the
residual connection, on by default, carries them. The products are plain
PyTorch einsums, as they are XLA einsums outside any Pallas kernel in the
JAX package.

The JAX package shards the expert-stacked weights over an "expert" mesh
axis; the port runs on one card, and that expert-parallel layout waits for
the port's mesh (ROADMAP.md Queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..activations import get_activation
from ..conf.inputs import InputType
from .base import BaseLayer, Params, maybe_dropout, register_layer


@register_layer
@dataclass
class MixtureOfExpertsLayer(BaseLayer):
    """Top-k routed expert FFN block over [B, T, F] (or [B, F]) inputs.
    Params: gate Wg [F, E]; experts W1 [E, F, hidden], b1 [E, hidden], W2
    [E, hidden, n_out], b2 [E, n_out]."""

    n_out: int = 0
    n_experts: int = 4
    hidden: int = 0  # expert FFN hidden width (default 4*n_out)
    top_k: int = 1  # 1 = Switch routing, 2 = GShard-style
    capacity_factor: float = 1.25
    residual: bool = True  # x + moe(x); requires n_out == n_in
    expert_activation: str = "relu"

    def get_output_type(self, input_type: InputType) -> InputType:
        if input_type.kind == "rnn":
            return InputType.recurrent(self.n_out, input_type.timesteps)
        return InputType.feed_forward(self.n_out)

    def init_params(self, gen, input_type: InputType) -> Params:
        n_in = input_type.size
        if self.residual and n_in != self.n_out:
            raise ValueError(f"residual MoE needs n_in == n_out, got {n_in} != {self.n_out}")
        h = self.hidden or 4 * self.n_out
        e = self.n_experts
        return {
            "Wg": self._init_weight(gen, (n_in, e), n_in, e),
            "W1": self._init_weight(gen, (e, n_in, h), n_in, h),
            "b1": self._init_bias((e, h)),
            "W2": self._init_weight(gen, (e, h, self.n_out), h, self.n_out),
            "b2": self._init_bias((e, self.n_out)),
        }

    def _capacity(self, n_tokens: int) -> int:
        """The slots of each expert's buffer, shared by apply() and the
        diagnostics."""
        return max(1, int(self.capacity_factor * n_tokens * self.top_k / self.n_experts))

    def apply(self, params, x, state, *, mask=None, train=False, generator=None):
        lead = x.shape[:-1]
        tokens = x.reshape(-1, x.shape[-1])  # [N, F]
        n, e = tokens.shape[0], self.n_experts
        capacity = self._capacity(n)
        # pad steps of a [B, T] mask claim no capacity and add no output
        token_mask = None
        if mask is not None and x.dim() == 3 and mask.dim() == 2:
            token_mask = mask.reshape(-1).to(torch.int32)
        probs = torch.softmax(tokens @ params["Wg"], dim=-1)  # [N, E]
        slots = torch.arange(capacity, device=x.device)
        dispatch = combine = None  # [N, E, C]: the first round's, then sums (0 + v is v)
        remaining = probs
        expert_fill = torch.zeros(e, dtype=torch.int32, device=x.device)
        for _ in range(self.top_k):
            # the first largest, as jnp.argmax takes it (topk's tie order is
            # not documented)
            idx = torch.argmax(remaining, dim=-1)  # [N]
            gate = torch.gather(remaining, 1, idx[:, None])[:, 0]
            onehot = torch.nn.functional.one_hot(idx, e).to(torch.int32)  # [N, E]
            if token_mask is not None:
                onehot = onehot * token_mask[:, None]
            pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - 1 + expert_fill[None, :]
            expert_fill = expert_fill + onehot.sum(dim=0, dtype=torch.int32)
            within = (pos < capacity) & (onehot > 0)
            # one-hot of the slot in x's dtype; a row past capacity is all zero
            pos_onehot = ((pos[..., None] == slots) & within[..., None]).to(x.dtype)  # [N, E, C]
            weighted = pos_onehot * gate[:, None, None]
            dispatch = pos_onehot if dispatch is None else dispatch + pos_onehot
            combine = weighted if combine is None else combine + weighted
            remaining = remaining * (1 - onehot.to(remaining.dtype))
        act = get_activation(self.expert_activation)
        expert_in = torch.einsum("nec,nf->ecf", dispatch, tokens)  # [E, C, F]
        hcur = act(torch.einsum("ecf,efh->ech", expert_in, params["W1"])
                   + params["b1"][:, None, :])
        expert_out = (torch.einsum("ech,eho->eco", hcur, params["W2"])
                      + params["b2"][:, None, :])  # [E, C, O]
        out = torch.einsum("nec,eco->no", combine, expert_out)  # [N, O]
        if self.residual:
            out = out + tokens
        out = maybe_dropout(out.reshape(lead + (self.n_out,)), self.dropout, train, generator)
        return self._activate(out), state

    @torch.no_grad()
    def load_balance_stats(self, params, x) -> dict:
        """Routing diagnostics over the tokens of ``x``, every one counted
        (pass only the real tokens of a padded batch): each expert's share
        of all top_k assignments (they sum to top_k), the tokens past
        capacity and the capacity, by apply()'s formula."""
        x = torch.as_tensor(x)
        tokens = x.reshape(-1, x.shape[-1]).to(params["Wg"].dtype)
        remaining = torch.softmax(tokens @ params["Wg"], dim=-1)
        counts = torch.zeros(self.n_experts, dtype=torch.int64, device=tokens.device)
        for _ in range(self.top_k):
            idx = torch.argmax(remaining, dim=-1)
            counts = counts + torch.bincount(idx, minlength=self.n_experts)
            remaining = remaining * (1 - torch.nn.functional.one_hot(
                idx, self.n_experts).to(remaining.dtype))
        cap = self._capacity(tokens.shape[0])
        return {"expert_fraction": counts / tokens.shape[0],
                "dropped_tokens": int((counts - cap).clamp(min=0).sum()), "capacity": cap}
