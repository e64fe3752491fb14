"""Flash attention with its gradient.

Port of ``deeplearning4j_tpu/ops/flash_attention.py``: softmax attention of
q, k, v [B, H, T, D] with an optional key mask [B, T] (> 0: a real key) and
causal masking, computed in f32 whatever the input type (f32 or bf16) and
returned in the input type. The forward also returns lse [B, H, T] (f32),
which the backward reads; a row with no real key gets out = 0 and lse = 0,
so its gradient is 0 too. :class:`FlashAttentionFunction` is the custom VJP
(``_flash_core``): it saves (q, k, v, mask, out, lse) as ``_flash_fwd`` does
and its backward computes delta = rowsum(dO * O), then dq, dk and dv.

For CUDA tensors the forward launches the hand-written kernel of
``csrc/flash_attn.cu`` (``_flash_call``) and the backward the two of
``csrc/flash_attn_bwd.cu`` (``_flash_bwd``: :func:`flash_attention_dq`
over key tiles, with delta; :func:`flash_attention_dkv` over query tiles);
they raise on what they do not take (``TypeError``
for dtypes, ``ValueError`` for shapes, a head dim not in ``HEAD_DIMS`` or
tensors on different devices). For CPU tensors the plain versions run,
:func:`flash_attention_reference`, :func:`flash_attention_dq_reference`
and :func:`flash_attention_dkv_reference`, on the whole [T, T] scores.
Neither has the JAX wrapper's fallback to the XLA path past a VMEM budget:
that is a TPU limit, and the kernels here stage K/V tile by tile.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

# count of wrapper calls that launched each kernel (one launch each)
launches = {"flash_attn_fwd": 0, "flash_attn_bwd_dq": 0, "flash_attn_bwd_dkv": 0}

NEG_INF = -1e30  # the Pallas kernels' sentinel for a masked score, not -inf
HEAD_DIMS = (4, 8, 16, 32, 64, 128)  # head dims the kernels are instantiated for
_MAX_T = 65535 * 16  # the kernels' grid holds at most 65535 tiles of >= 16 rows


def _scale(scale: Optional[float], d: int) -> float:
    return float(scale if scale is not None else d ** -0.5)


def _valid(key_mask: Optional[torch.Tensor], T: int, causal: bool,
           device) -> torch.Tensor:
    """[B or 1, 1, T, T] bool: the key is real and, under ``causal``, not
    after the row."""
    valid = torch.ones((1, 1, T, T), dtype=torch.bool, device=device)
    if causal:
        valid = torch.tril(valid)
    if key_mask is not None:
        valid = valid & (key_mask > 0)[:, None, None, :]
    return valid


# ------------------------------------------------------------ plain versions
def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              key_mask: Optional[torch.Tensor] = None,
                              causal: bool = False, scale: Optional[float] = None,
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward (``_fwd_kernel`` over one tile that
    holds every key): (out [B, H, T, D] in q's dtype, lse [B, H, T] f32),
    with the kernel's guards for rows that have no real key."""
    B, H, T, D = q.shape
    scale = _scale(scale, D)
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    s = torch.where(_valid(key_mask, T, causal, q.device), s, NEG_INF)
    m = s.amax(-1) if T else s.sum(-1)
    m_safe = torch.where(m <= NEG_INF / 2, 0.0, m)
    p = torch.exp(s - m_safe[..., None])
    l = p.sum(-1)
    l_safe = l.clamp_min(1e-30)
    out = torch.matmul(p, vf) / l_safe[..., None]
    lse = torch.where(l > 0, m_safe + torch.log(l_safe), 0.0)
    return out.to(q.dtype), lse


def _probs(q, k, key_mask, lse, causal, scale):
    """p = exp(s - lse) of the backward, in f32, as each backward kernel
    recomputes it."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = torch.where(_valid(key_mask, q.shape[2], causal, q.device), s, NEG_INF)
    return torch.exp(s - lse[..., None])


def flash_attention_dq_reference(q, k, v, key_mask, out, lse, g, causal: bool = False,
                                 scale: Optional[float] = None):
    """Plain version of the dq kernel (``_dq_kernel`` and the delta of
    ``_flash_bwd``): (dq in q's dtype, delta = rowsum(g * out) [B, H, T] f32)."""
    scale = _scale(scale, q.shape[-1])
    gf = g.float()
    delta = (gf * out.float()).sum(-1)
    p = _probs(q, k, key_mask, lse, causal, scale)
    ds = p * (torch.matmul(gf, v.float().transpose(-1, -2)) - delta[..., None])
    return (torch.matmul(ds, k.float()) * scale).to(q.dtype), delta


def flash_attention_dkv_reference(q, k, v, key_mask, lse, delta, g, causal: bool = False,
                                  scale: Optional[float] = None):
    """Plain version of the dk/dv kernel (``_dkv_kernel``): (dk, dv) in the
    inputs' dtypes from the delta of the dq step."""
    scale = _scale(scale, q.shape[-1])
    gf = g.float()
    p = _probs(q, k, key_mask, lse, causal, scale)
    dv = torch.matmul(p.transpose(-1, -2), gf)
    ds = p * (torch.matmul(gf, v.float().transpose(-1, -2)) - delta[..., None])
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_backward_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        key_mask: Optional[torch.Tensor], out: torch.Tensor, lse: torch.Tensor,
        g: torch.Tensor, causal: bool = False, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward (``_flash_bwd``), the formulas written
    out: (dq, dk, dv) in the inputs' dtypes from the upstream gradient ``g``
    of ``out``."""
    dq, delta = flash_attention_dq_reference(q, k, v, key_mask, out, lse, g, causal, scale)
    return (dq,) + flash_attention_dkv_reference(q, k, v, key_mask, lse, delta, g, causal,
                                                 scale)


# ------------------------------------------------------------------ kernels
def _check(q, k, v, key_mask) -> None:
    if q.dim() != 4:
        raise ValueError(f"q must be [B, H, T, D], got {tuple(q.shape)}")
    B, H, T, D = q.shape
    tensors = [("k", k), ("v", v)]
    for name, t in tensors:
        if tuple(t.shape) != tuple(q.shape):
            raise ValueError(f"{name} must match q's shape {tuple(q.shape)}, got "
                             f"{tuple(t.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the CUDA flash-attention kernels take float32 or bfloat16 "
                        f"q, k, v, not {q.dtype}")
    for name, t in tensors:
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} has no CUDA flash-attention kernel "
                         f"(instantiated: {HEAD_DIMS})")
    if T > _MAX_T:
        raise ValueError(f"sequence length {T} exceeds the kernels' grid ({_MAX_T})")
    if key_mask is not None:
        tensors.append(("key_mask", key_mask))
        if tuple(key_mask.shape) != (B, T) or key_mask.dtype != torch.float32:
            raise ValueError(f"key_mask must be float32 [{B}, {T}], got "
                             f"{key_mask.dtype} {tuple(key_mask.shape)}")
    for name, t in [("q", q)] + tensors:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _mask_f32(key_mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The key mask as the kernels take it (the JAX wrapper's astype(f32))."""
    return None if key_mask is None else key_mask.to(torch.float32).contiguous()


def _ints(q, causal):
    """The kernels' int arguments: BH, H, T, D, causal, bf16."""
    B, H, T, D = q.shape
    return B * H, H, T, D, int(causal), int(q.dtype == torch.bfloat16)


def _kernel_fwd(q, k, v, mask, causal, scale):
    _check(q, k, v, mask)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    fn = _build.bind("flash_attn", "dl4j_flash_attn_fwd", 6, 6, 1)
    _build.launch(launches, "flash_attn_fwd", fn, q.device, q, k, v, mask, out, lse,
                  *_ints(q, causal), scale)
    return out, lse


def _check_rows(q, **tensors) -> None:
    """Per-row tensors of the backward: out and g as q, lse and delta f32
    [B, H, T], all contiguous on q's device."""
    for name, t in tensors.items():
        want, dt = ((tuple(q.shape[:3]), torch.float32) if name in ("lse", "delta")
                    else (tuple(q.shape), q.dtype))
        if tuple(t.shape) != want or t.dtype != dt:
            raise ValueError(f"{name} must be {dt} {want}, got {t.dtype} {tuple(t.shape)}")
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")


def _kernel_dq(q, k, v, mask, out, lse, g, causal, scale):
    _check(q, k, v, mask)
    _check_rows(q, out=out, lse=lse, g=g)
    dq = torch.empty_like(q)
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return dq, delta
    fn = _build.bind("flash_attn_bwd", "dl4j_flash_attn_bwd_dq", 9, 6, 1)
    _build.launch(launches, "flash_attn_bwd_dq", fn, q.device, q, k, v, mask, out, g,
                  lse, delta, dq, *_ints(q, causal), scale)
    return dq, delta


def _kernel_dkv(q, k, v, mask, lse, delta, g, causal, scale):
    _check(q, k, v, mask)
    _check_rows(q, lse=lse, delta=delta, g=g)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dk, dv
    fn = _build.bind("flash_attn_bwd", "dl4j_flash_attn_bwd_dkv", 9, 6, 1)
    _build.launch(launches, "flash_attn_bwd_dkv", fn, q.device, q, k, v, mask, g, lse,
                  delta, dk, dv, *_ints(q, causal), scale)
    return dk, dv


def _on_card(*tensors) -> bool:
    return any(t is not None and t.is_cuda for t in tensors)


def flash_attention_forward(q, k, v, key_mask=None, causal: bool = False,
                            scale: Optional[float] = None):
    """(out, lse) of q, k, v [B, H, T, D]: the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    scale = _scale(scale, q.shape[-1])
    if _on_card(q, k, v, key_mask):
        return _kernel_fwd(q, k, v, _mask_f32(key_mask), causal, scale)
    return flash_attention_reference(q, k, v, key_mask, causal, scale)


def flash_attention_dq(q, k, v, key_mask, out, lse, g, causal: bool = False,
                       scale: Optional[float] = None):
    """(dq, delta): the dq kernel for CUDA tensors, its plain version for
    CPU tensors."""
    scale = _scale(scale, q.shape[-1])
    if _on_card(q, k, v, key_mask, out, lse, g):
        return _kernel_dq(q, k, v, _mask_f32(key_mask), out, lse, g, causal, scale)
    return flash_attention_dq_reference(q, k, v, key_mask, out, lse, g, causal, scale)


def flash_attention_dkv(q, k, v, key_mask, lse, delta, g, causal: bool = False,
                        scale: Optional[float] = None):
    """(dk, dv) from the delta of :func:`flash_attention_dq`: the dk/dv
    kernel for CUDA tensors, its plain version for CPU tensors."""
    scale = _scale(scale, q.shape[-1])
    if _on_card(q, k, v, key_mask, lse, delta, g):
        return _kernel_dkv(q, k, v, _mask_f32(key_mask), lse, delta, g, causal, scale)
    return flash_attention_dkv_reference(q, k, v, key_mask, lse, delta, g, causal, scale)


def flash_attention_backward(q, k, v, key_mask, out, lse, g, causal: bool = False,
                             scale: Optional[float] = None):
    """(dq, dk, dv) from the upstream gradient ``g`` of ``out``: the two
    kernels for CUDA tensors (dq with delta, then dk/dv), the plain versions
    for CPU tensors."""
    dq, delta = flash_attention_dq(q, k, v, key_mask, out, lse, g, causal, scale)
    return (dq,) + flash_attention_dkv(q, k, v, key_mask, lse, delta, g, causal, scale)


class FlashAttentionFunction(torch.autograd.Function):
    """out of (q, k, v, key_mask, causal, scale) under autograd; q, k and v
    take gradients, the key mask none."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, causal, scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        mask = _mask_f32(key_mask)
        out, lse = flash_attention_forward(q, k, v, mask, causal, scale)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, mask, out, lse, g.contiguous(),
                                              ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None,
                    key_mask: Optional[torch.Tensor] = None, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """Softmax attention of q, k, v [B, H, T, D] (the JAX signature);
    ``key_mask`` [B, T] (1 = real key); any T. ``block_q`` and ``block_k``
    are taken for the signature: block sizes do not change the result, and
    the kernels choose their own."""
    del block_q, block_k
    return FlashAttentionFunction.apply(q, k, v, key_mask, bool(causal),
                                        _scale(scale, q.shape[-1]))
