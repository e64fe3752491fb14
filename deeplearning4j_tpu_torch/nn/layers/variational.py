"""Variational autoencoder and its reconstruction distributions (counterpart
of ``deeplearning4j_tpu/nn/layers/variational.py``).

Reference: nn/conf/layers/variational/VariationalAutoencoder.java and the
five reconstruction distributions of variational/*.java: Bernoulli,
Gaussian, Exponential, LossFunctionWrapper and Composite, with their
``@type`` JSON.

The negative ELBO, KL[q(z|x) || N(0, I)] - E_q[log p(x|z)], is one function
of the params; autograd differentiates through the reparameterization
z = mean + exp(log_var / 2) * eps. The arithmetic is the JAX package's:
``pzx_activation`` maps both the posterior mean and its log-variance, and
the log-variance is clipped to [-10, 10]. Used in a network the layer
outputs the posterior mean (reference: VariationalAutoencoder.activate).

The noise has a seam, as ``pretrain.py``'s: ``pretrain_loss`` and
``reconstruction_log_probability`` take ``eps`` ([samples, B, n_out]) and
draw it from ``generator`` when it is not given. The JAX package draws
``jax.random.normal(key, mean.shape, mean.dtype)`` for each key of
``jax.random.split(rng, num_samples)``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..activations import get_activation
from ..conf.inputs import InputType
from ..losses import get_loss
from .base import BaseLayer, Params, register_layer

_DIST_REGISTRY: Dict[str, type] = {}


def register_distribution(cls):
    _DIST_REGISTRY[cls.__name__] = cls
    return cls


def distribution_from_dict(d: dict):
    d = dict(d)
    cls = _DIST_REGISTRY[d.pop("@type")]
    return cls.from_dict(d)


class ReconstructionDistribution:
    """p(x|z) (reference: variational/ReconstructionDistribution.java):
    ``log_prob`` per example from the decoder's pre-activation output."""

    def num_dist_params(self, data_size: int) -> int:
        raise NotImplementedError

    def log_prob(self, x: torch.Tensor, preout: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def mean(self, preout: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def to_dict(self) -> dict:
        return {"@type": type(self).__name__}

    @classmethod
    def from_dict(cls, d: dict):
        return cls(**d)


@register_distribution
class BernoulliReconstruction(ReconstructionDistribution):
    """Reference: BernoulliReconstructionDistribution.java."""

    def __init__(self, activation: str = "sigmoid"):
        self.activation = activation

    def num_dist_params(self, data_size: int) -> int:
        return data_size

    def log_prob(self, x, preout):
        if self.activation == "sigmoid":  # log p and log(1-p) from the logits
            logp, log1mp = -F.softplus(-preout), -F.softplus(preout)
        else:
            p = torch.clamp(get_activation(self.activation)(preout), 1e-7, 1 - 1e-7)
            logp, log1mp = torch.log(p), torch.log1p(-p)
        return torch.sum(x * logp + (1 - x) * log1mp, dim=-1)

    def mean(self, preout):
        return get_activation(self.activation)(preout)

    def to_dict(self):
        return {"@type": type(self).__name__, "activation": self.activation}


@register_distribution
class GaussianReconstruction(ReconstructionDistribution):
    """Reference: GaussianReconstructionDistribution.java: the decoder gives
    [mean, log(sigma^2)] on the feature axis."""

    def __init__(self, activation: str = "identity"):
        self.activation = activation

    def num_dist_params(self, data_size: int) -> int:
        return 2 * data_size

    def _split(self, preout):
        n = preout.shape[-1] // 2
        return get_activation(self.activation)(preout[..., :n]), preout[..., n:]

    def log_prob(self, x, preout):
        mean, log_var = self._split(preout)
        log_var = torch.clamp(log_var, -10.0, 10.0)
        return torch.sum(-0.5 * (math.log(2 * math.pi) + log_var
                                 + (x - mean) ** 2 / torch.exp(log_var)), dim=-1)

    def mean(self, preout):
        return self._split(preout)[0]

    def to_dict(self):
        return {"@type": type(self).__name__, "activation": self.activation}


@register_distribution
class ExponentialReconstruction(ReconstructionDistribution):
    """Reference: ExponentialReconstructionDistribution.java: preout gamma,
    lambda = exp(gamma), log p(x) = gamma - x exp(gamma)."""

    def __init__(self, activation: str = "identity"):
        self.activation = activation

    def num_dist_params(self, data_size: int) -> int:
        return data_size

    def log_prob(self, x, preout):
        gamma = torch.clamp(get_activation(self.activation)(preout), -10.0, 10.0)
        return torch.sum(gamma - x * torch.exp(gamma), dim=-1)

    def mean(self, preout):
        return torch.exp(-get_activation(self.activation)(preout))  # E[x] = 1/lambda

    def to_dict(self):
        return {"@type": type(self).__name__, "activation": self.activation}


@register_distribution
class LossFunctionWrapper(ReconstructionDistribution):
    """A loss of the catalog as -log p (reference: LossFunctionWrapper.java).
    As in the JAX package, the batch's mean loss stands for every example's."""

    def __init__(self, loss: str = "mse", activation: str = "identity"):
        self.loss = loss
        self.activation = activation

    def num_dist_params(self, data_size: int) -> int:
        return data_size

    def log_prob(self, x, preout):
        scores = get_loss(self.loss)(x, preout, self.activation, None)
        return -scores * torch.ones(x.shape[0], dtype=scores.dtype, device=x.device)

    def mean(self, preout):
        return get_activation(self.activation)(preout)

    def to_dict(self):
        return {"@type": type(self).__name__, "loss": self.loss,
                "activation": self.activation}


@register_distribution
class CompositeReconstruction(ReconstructionDistribution):
    """Distributions over column ranges (reference:
    CompositeReconstructionDistribution.java): ``parts`` is
    [(data_size, distribution or its dict), ...]."""

    def __init__(self, parts: Optional[List] = None):
        self.parts = [(int(s), distribution_from_dict(d) if isinstance(d, dict) else d)
                      for s, d in (parts or [])]

    def num_dist_params(self, data_size: int) -> int:
        return sum(d.num_dist_params(s) for s, d in self.parts)

    def log_prob(self, x, preout):
        total = 0.0
        xi = pi = 0
        for s, d in self.parts:
            n = d.num_dist_params(s)
            total = total + d.log_prob(x[..., xi:xi + s], preout[..., pi:pi + n])
            xi += s
            pi += n
        return total

    def mean(self, preout):
        outs = []
        pi = 0
        for s, d in self.parts:
            n = d.num_dist_params(s)
            outs.append(d.mean(preout[..., pi:pi + n]))
            pi += n
        return torch.cat(outs, dim=-1)

    def to_dict(self):
        return {"@type": type(self).__name__,
                "parts": [[s, d.to_dict()] for s, d in self.parts]}


@register_layer
@dataclass
class VariationalAutoencoder(BaseLayer):
    """Reference: conf/layers/variational/VariationalAutoencoder.java.
    ``n_out`` is the latent size; the encoder and decoder are MLP stacks
    (``encoder_layer_sizes``, ``decoder_layer_sizes``) with ``activation``;
    ``num_samples`` Monte Carlo draws of the ELBO. Params: ``eW{i}``/``eb{i}``,
    ``pzxMeanW``/``pzxMeanB``, ``pzxLogStd2W``/``pzxLogStd2B``,
    ``dW{i}``/``db{i}``, ``pxzW``/``pxzB``."""

    n_in: int = 0
    n_out: int = 0
    encoder_layer_sizes: Tuple[int, ...] = (100,)
    decoder_layer_sizes: Tuple[int, ...] = (100,)
    pzx_activation: str = "identity"
    num_samples: int = 1
    activation: str = "tanh"
    reconstruction: Any = field(default_factory=BernoulliReconstruction)

    def __post_init__(self):
        if isinstance(self.reconstruction, dict):
            self.reconstruction = distribution_from_dict(self.reconstruction)
        self.encoder_layer_sizes = tuple(self.encoder_layer_sizes)
        self.decoder_layer_sizes = tuple(self.decoder_layer_sizes)

    def to_dict(self) -> dict:
        d = super().to_dict()
        d["reconstruction"] = self.reconstruction.to_dict()
        return d

    @property
    def is_pretrain_layer(self) -> bool:
        return True

    def get_output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def init_params(self, gen, input_type: InputType) -> Params:
        n_in = self.n_in or input_type.flat_size()
        sizes_e = [n_in, *self.encoder_layer_sizes]
        sizes_d = [self.n_out, *self.decoder_layer_sizes]
        n_dist = self.reconstruction.num_dist_params(n_in)
        p: Params = {}

        def dense(w, b, n_a, n_b):
            p[w] = self._init_weight(gen, (n_a, n_b), n_a, n_b)
            p[b] = self._init_bias((n_b,))

        for i in range(len(sizes_e) - 1):
            dense(f"eW{i}", f"eb{i}", sizes_e[i], sizes_e[i + 1])
        dense("pzxMeanW", "pzxMeanB", sizes_e[-1], self.n_out)
        dense("pzxLogStd2W", "pzxLogStd2B", sizes_e[-1], self.n_out)
        for i in range(len(sizes_d) - 1):
            dense(f"dW{i}", f"db{i}", sizes_d[i], sizes_d[i + 1])
        dense("pxzW", "pxzB", sizes_d[-1], n_dist)
        return p

    def encode(self, params: Params, x: torch.Tensor):
        """(the posterior mean, its log-variance clipped to [-10, 10])."""
        act = get_activation(self.activation)
        h = x
        for i in range(len(self.encoder_layer_sizes)):
            h = act(h @ params[f"eW{i}"] + params[f"eb{i}"])
        pzx = get_activation(self.pzx_activation)
        mean = pzx(h @ params["pzxMeanW"] + params["pzxMeanB"])
        log_var = pzx(h @ params["pzxLogStd2W"] + params["pzxLogStd2B"])
        return mean, torch.clamp(log_var, -10.0, 10.0)

    def decode(self, params: Params, z: torch.Tensor) -> torch.Tensor:
        """The reconstruction distribution's pre-activations."""
        act = get_activation(self.activation)
        h = z
        for i in range(len(self.decoder_layer_sizes)):
            h = act(h @ params[f"dW{i}"] + params[f"db{i}"])
        return h @ params["pxzW"] + params["pxzB"]

    def apply(self, params, x, state, *, mask=None, train=False, generator=None):
        x = x.reshape(x.shape[0], -1) if x.dim() > 2 else x
        return self.encode(params, x)[0], state

    @staticmethod
    def _eps(eps, n: int, mean: torch.Tensor, generator) -> torch.Tensor:
        if eps is not None:
            return eps.to(mean.device, mean.dtype)
        gen = generator if generator is not None else torch.Generator(
            device=mean.device).manual_seed(0)
        return torch.randn((n, *mean.shape), generator=gen, device=mean.device,
                           dtype=mean.dtype)

    def pretrain_loss(self, params: Params, x: torch.Tensor, *,
                      generator: Optional[torch.Generator] = None,
                      eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The negative ELBO, averaged over ``num_samples`` draws of eps
        ([num_samples, B, n_out], drawn from ``generator`` when not given;
        with neither, from a generator seeded 0)."""
        x = x.reshape(x.shape[0], -1) if x.dim() > 2 else x
        mean, log_var = self.encode(params, x)
        kl = -0.5 * torch.sum(1 + log_var - mean ** 2 - torch.exp(log_var), dim=-1)
        e = self._eps(eps, self.num_samples, mean, generator)
        std = torch.exp(0.5 * log_var)
        logp = torch.stack([self.reconstruction.log_prob(x, self.decode(params, mean + std * e_s))
                            for e_s in e]).mean(dim=0)
        return torch.mean(kl - logp)

    def reconstruction_log_probability(self, params: Params, x: torch.Tensor, *,
                                       generator: Optional[torch.Generator] = None,
                                       eps: Optional[torch.Tensor] = None,
                                       num_samples: Optional[int] = None) -> torch.Tensor:
        """Importance-sampled log p(x) per example (reference:
        VariationalAutoencoder.reconstructionLogProbability) over
        ``num_samples`` draws (default max(num_samples, 8))."""
        x = x.reshape(x.shape[0], -1) if x.dim() > 2 else x
        k = num_samples or max(self.num_samples, 8)
        mean, log_var = self.encode(params, x)
        std = torch.exp(0.5 * log_var)
        log_2pi = math.log(2 * math.pi)
        ws = []
        for e_s in self._eps(eps, k, mean, generator):
            z = mean + std * e_s
            logp_xz = self.reconstruction.log_prob(x, self.decode(params, z))
            logp_z = torch.sum(-0.5 * (log_2pi + z ** 2), dim=-1)
            logq = torch.sum(-0.5 * (log_2pi + log_var + e_s ** 2), dim=-1)
            ws.append(logp_xz + logp_z - logq)
        return torch.logsumexp(torch.stack(ws), dim=0) - math.log(k)

    def generate_at_mean_given_z(self, params: Params, z: torch.Tensor) -> torch.Tensor:
        """Reference: generateAtMeanGivenZ: the decoder's mean output."""
        return self.reconstruction.mean(self.decode(params, z))
