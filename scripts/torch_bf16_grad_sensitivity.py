#!/usr/bin/env python3
"""How far a wrong bf16 LSTM backward lands from the right one.

    python3 scripts/torch_bf16_grad_sensitivity.py [--steps 6 50] [--batch 16]

Runs the port's plain bf16 backward, unmasked
(``lstm_sequence_backward_reference``) and masked
(``lstm_sequence_masked_backward_reference``, with a mask of all zeros,
leading, interior and trailing zeros as chip_smoke.py's ``train_mask``),
and variants of its loop that each get one thing wrong: a term left out of
the cell-state gradient or its carry, a gradient rounded once where the
plain version rounds after each product, the recurrent ``dh`` left in f32,
the output peephole's gradient taken against c_{t-1}; masked, also the
(1-m) carry-through of dh or of dc left out. For each variant it
prints, per output and per gate column of dzx, max |err| / max |ref| and
mean |err| / mean |ref| against the right one: the size a kernel with that
fault would show, which chip_smoke.py's bf16 limits must stay below. On the
CPU, at H=512 and the given lengths and batch; inputs scaled as
chip_smoke.py scales them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from deeplearning4j_tpu_torch.ops import lstm_sequence as ls  # noqa: E402

H = 512
GRADS = ("dzx", "dh0", "dc0", "dRW", "dpF", "dpI", "dpO")
VARIANTS = ("no_do_pO", "no_df_pF", "do_one_rounding", "da_one_rounding",
            "dh_in_f32", "dpO_on_c_prev")
MASKED_VARIANTS = VARIANTS + ("no_dh_carry_through", "no_dc_carry_through")


def train_mask(T, B, rng):
    """[T, B, 1]: row 0 all zeros, row 1 leading zeros, row 2 an interior
    gap, the other rows ragged lengths (chip_smoke.py's ``train_mask``)."""
    lengths = rng.integers(max(1, T // 3), T + 1, B)
    rows = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float64)
    rows[0] = 0.0
    rows[1, :max(1, T // 4)] = 0.0
    rows[2, T // 3:max(T // 3 + 1, T // 2)] = 0.0
    return torch.as_tensor(rows.T[..., None], dtype=torch.bfloat16)


def backward(dys, dhT, dcT, mask, ys, a, f, o, i, c, h0, c0, RW, pF, pI, pO, fault=None):
    """The plain backward's loop (tanh/sigmoid; ``mask`` None or [T, B, 1]),
    with ``fault`` applied."""
    act, dact, dgate = ls.ACT["tanh"], ls.DACT["tanh"], ls.DACT["sigmoid"]
    dt, acc = ys.dtype, torch.float32
    T = ys.shape[0]
    RWt = RW.to(acc).t()
    dRW = torch.zeros(RW.shape, dtype=acc)
    dp = [torch.zeros(pF.shape, dtype=acc) for _ in range(3)]
    dzx, dh_carry, dc = [], dhT, dcT
    for t in reversed(range(T)):
        c_prev = c0 if t == 0 else c[t - 1]
        h_prev = h0 if t == 0 else ys[t - 1]
        ct = f[t] * c_prev + i[t] * a[t]
        cact = act(ct)
        dh = dh_t = dys[t] + dh_carry
        dc_t = dc
        if mask is not None:
            dh, dc = mask[t] * dh_t, mask[t] * dc_t
        if fault == "do_one_rounding":
            d_o = (dh.float() * cact.float() * dgate(o[t]).float()).to(dt)
        else:
            d_o = dh * cact * dgate(o[t])
        dc_tot = dc + dh * o[t] * dact(cact)
        if fault != "no_do_pO":
            dc_tot = dc_tot + d_o * pO
        d_f = dc_tot * c_prev * dgate(f[t])
        d_i = dc_tot * a[t] * dgate(i[t])
        if fault == "da_one_rounding":
            d_a = (dc_tot.float() * i[t].float() * dact(a[t]).float()).to(dt)
        else:
            d_a = dc_tot * i[t] * dact(a[t])
        dz = torch.cat([d_a, d_f, d_o, d_i], dim=-1)
        dzx.append(dz)
        dh_carry = torch.matmul(dz.to(acc), RWt)
        if fault != "dh_in_f32":
            dh_carry = dh_carry.to(dt)
        dc = dc_tot * f[t]
        if fault != "no_df_pF":
            dc = dc + d_f * pF
        dc = dc + d_i * pI
        if mask is not None:
            keep = 1.0 - mask[t]
            if fault != "no_dh_carry_through":
                dh_carry = dh_carry + keep * dh_t
            if fault != "no_dc_carry_through":
                dc = dc + keep * dc_t
        dRW += torch.matmul(h_prev.to(acc).t(), dz.to(acc))
        c_o = c_prev if fault == "dpO_on_c_prev" else ct
        for s, term in zip(dp, (d_f * c_prev, d_i * c_prev, d_o * c_o)):
            s += term.to(acc).sum(0)
    return ((torch.stack(dzx[::-1]), dh_carry.to(dt), dc, dRW.to(dt))
            + tuple(s.to(dt) for s in dp))


def by_output(grads):
    out = dict(zip(GRADS, grads))
    for k, g in zip("afoi", grads[0].split(H, -1)):
        out["dzx_" + k] = g
    return out


def measures(got, want):
    err, ref = (got.float() - want.float()).abs(), want.float().abs()
    return {"max_rel": float(err.max() / ref.max()),
            "mean_rel": float(err.mean() / ref.mean())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, nargs="+", default=[6, 50])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seed", type=int, default=5)
    args = ap.parse_args()
    for T in args.steps:
        rng = np.random.default_rng(args.seed)
        B = args.batch
        zx = rng.normal(0.0, 0.5, (T, B, 4 * H))
        zx[..., H:2 * H] += 1.0
        arrs = [zx, rng.normal(0.0, 0.5, (B, H)), rng.normal(0.0, 0.5, (B, H)),
                rng.normal(0.0, (1.0 / H) ** 0.5, (H, 4 * H))]
        arrs += [rng.normal(0.0, 0.1, H) for _ in range(3)]
        inp = [torch.as_tensor(x, dtype=torch.bfloat16) for x in arrs]
        up = [torch.as_tensor(rng.normal(0.0, 0.1, s), dtype=torch.bfloat16)
              for s in ((T, B, H), (B, H), (B, H))]
        for mask in (None, train_mask(T, B, rng)):
            res = ls.lstm_sequence_masked_train_reference(inp[0], mask, *inp[1:])
            residuals = tuple(res[:6]) + tuple(inp[1:])
            right = by_output(ls.lstm_sequence_masked_backward_reference(
                *up, mask, *residuals))
            same = by_output(backward(*up, mask, *residuals))
            if any(not torch.equal(same[k], right[k]) for k in right):
                raise AssertionError("the unfaulted loop differs from the plain backward")
            masked = mask is not None
            print(json.dumps({"T": T, "B": B, "H": H, "masked": masked, "max_abs_ref": {
                k: float(v.float().abs().max()) for k, v in right.items()}}))
            for fault in MASKED_VARIANTS if masked else VARIANTS:
                wrong = by_output(backward(*up, mask, *residuals, fault=fault))
                print(json.dumps({"T": T, "masked": masked, "fault": fault, "by_output": {
                    k: measures(wrong[k], right[k]) for k in right}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
