"""Pretrain layers: AutoEncoder and RBM (counterpart of
``deeplearning4j_tpu/nn/layers/pretrain.py``).

Reference: nn/layers/feedforward/autoencoder/AutoEncoder.java (denoising
autoencoder, tied decoder weights W^T and a visible bias "vb") and
nn/layers/feedforward/rbm/RBM.java (contrastive divergence, CD-k).

CD-k takes its gradient from the free-energy surrogate
L = mean FE(v_data) - mean FE(v_model), whose gradient is the CD update; the
Gibbs chain that gives v_model runs under ``torch.no_grad()`` (its samples
are constants, as in the reference).

The noise has a seam. The JAX package draws ``jax.random.bernoulli(key, p)``,
which is ``jax.random.uniform(key, shape, p.dtype) < p``; here each
``pretrain_loss`` takes its uniforms as an argument (``uniforms``) and
draws them from ``generator`` when none are given, so a caller that
regenerates the JAX package's uniforms from its keys gets its losses and
gradients. ``MultiLayerNetwork.pretrain`` trains a layer through its
``pretrain_loss``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..conf.inputs import InputType
from ..losses import get_loss
from .base import BaseLayer, Params, maybe_dropout, register_layer


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1) if x.dim() > 2 else x


def _uniform(shape, like: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=like.device, dtype=like.dtype)


def _visible_params(layer, gen, input_type: InputType) -> Params:
    """W [n_in, n_out], the hidden bias b and the visible bias vb
    (reference: PretrainParamInitializer)."""
    n_in = layer.n_in or input_type.flat_size()
    return {"W": layer._init_weight(gen, (n_in, layer.n_out), n_in, layer.n_out),
            "b": layer._init_bias((layer.n_out,)),
            "vb": layer._init_bias((n_in,))}


@register_layer
@dataclass
class AutoEncoder(BaseLayer):
    """Denoising autoencoder (reference: conf/layers/AutoEncoder.java:
    corruptionLevel, sparsity; decoder W^T with visible bias "vb")."""

    n_in: int = 0
    n_out: int = 0
    corruption_level: float = 0.3
    sparsity: float = 0.0
    loss: str = "mse"

    @property
    def is_pretrain_layer(self) -> bool:
        return True

    def get_output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def init_params(self, gen, input_type: InputType) -> Params:
        return _visible_params(self, gen, input_type)

    def encode(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return self._activate(x @ params["W"] + params["b"])

    def decode(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        return self._activate(h @ params["W"].t() + params["vb"])

    def apply(self, params, x, state, *, mask=None, train=False, generator=None):
        x = maybe_dropout(_flat(x), self.dropout, train, generator)
        return self.encode(params, x), state

    def pretrain_loss(self, params: Params, x: torch.Tensor, *,
                      generator: Optional[torch.Generator] = None,
                      uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Reconstruction loss of x from its corrupted copy: each input is
        kept where its uniform is below 1 - ``corruption_level`` (uniforms
        shaped as x, drawn from ``generator`` when not given; with neither,
        x is not corrupted), plus the KL sparsity penalty."""
        x = _flat(x)
        corrupted = x
        if self.corruption_level > 0 and (uniforms is not None or generator is not None):
            u = uniforms if uniforms is not None else _uniform(x.shape, x, generator)
            corrupted = torch.where(u.to(x.device) < 1.0 - self.corruption_level, x,
                                    torch.zeros_like(x))
        h = self.encode(params, corrupted)
        recon = self.decode(params, h)
        loss = get_loss(self.loss)(x, recon, "identity", None)
        if self.sparsity > 0:
            # KL(sparsity || mean activation)
            rho_hat = torch.clamp(torch.mean(h, dim=0), 1e-7, 1 - 1e-7)
            rho = self.sparsity
            loss = loss + torch.sum(rho * torch.log(rho / rho_hat)
                                    + (1 - rho) * torch.log((1 - rho) / (1 - rho_hat)))
        return loss


@register_layer
@dataclass
class RBM(BaseLayer):
    """Restricted Boltzmann machine trained by CD-k (reference:
    conf/layers/RBM.java, nn/layers/feedforward/rbm/RBM.java).
    ``hidden_unit``/``visible_unit``: "binary" or "gaussian"."""

    n_in: int = 0
    n_out: int = 0
    k: int = 1  # CD-k Gibbs steps
    hidden_unit: str = "binary"
    visible_unit: str = "binary"
    activation: str = "sigmoid"

    @property
    def is_pretrain_layer(self) -> bool:
        return True

    def get_output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def init_params(self, gen, input_type: InputType) -> Params:
        return _visible_params(self, gen, input_type)

    # the conditionals (reference: propUp, propDown)
    def prop_up(self, params: Params, v: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(v @ params["W"] + params["b"])

    def prop_down(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        mean = h @ params["W"].t() + params["vb"]
        return mean if self.visible_unit == "gaussian" else torch.sigmoid(mean)

    def apply(self, params, x, state, *, mask=None, train=False, generator=None):
        return self.prop_up(params, _flat(x)), state

    def free_energy(self, params: Params, v: torch.Tensor) -> torch.Tensor:
        """FE(v) = -v.vb - sum softplus(vW + b) for binary visible units;
        Gaussian visible units add ||v||^2 / 2."""
        term = -(v @ params["vb"]) - torch.sum(F.softplus(v @ params["W"] + params["b"]),
                                              dim=-1)
        if self.visible_unit == "gaussian":
            term = term + 0.5 * torch.sum(v * v, dim=-1)
        return term

    def pretrain_loss(self, params: Params, x: torch.Tensor, *,
                      generator: Optional[torch.Generator] = None,
                      uniforms: Optional[Sequence[Tuple[Optional[torch.Tensor],
                                                        Optional[torch.Tensor]]]] = None
                      ) -> torch.Tensor:
        """CD-k through the free-energy surrogate. Gibbs step i samples the
        binary hidden units as ``u_h < p(h|v)`` and the binary visible ones
        as ``u_v < p(v|h)`` from ``uniforms[i] = (u_h, u_v)`` ([B, n_out]
        and [B, n_in]; None where that unit is Gaussian), drawn from
        ``generator`` when not given (with neither, from a generator seeded
        0: fixed noise, as the JAX package's key 0 is). The negative phase
        takes the last step's mean-field visible probabilities."""
        x = _flat(x)
        if uniforms is None and generator is None:
            generator = torch.Generator(device=x.device).manual_seed(0)
        with torch.no_grad():
            v = v_prob = x
            for step in range(self.k):
                u_h, u_v = uniforms[step] if uniforms is not None else (None, None)
                h_prob = self.prop_up(params, v)
                h = h_prob
                if self.hidden_unit == "binary":
                    u_h = u_h if u_h is not None else _uniform(h_prob.shape, h_prob, generator)
                    h = (u_h.to(h_prob.device) < h_prob).to(x.dtype)
                v_prob = self.prop_down(params, h)
                v = v_prob
                if self.visible_unit == "binary":
                    u_v = u_v if u_v is not None else _uniform(v_prob.shape, v_prob, generator)
                    v = (u_v.to(v_prob.device) < v_prob).to(x.dtype)
        return torch.mean(self.free_energy(params, x)) - torch.mean(
            self.free_energy(params, v_prob))

    def reconstruction_error(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """Mean-field reconstruction MSE (a monitoring metric)."""
        x = _flat(x)
        recon = self.prop_down(params, self.prop_up(params, x))
        return torch.mean((x - recon) ** 2)
