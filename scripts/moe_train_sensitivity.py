#!/usr/bin/env python3
"""How far the MoE block's training moves under a rounding-sized change of
its start, and how far under chip_smoke.py's wrong MoE.

    python3 scripts/moe_train_sensitivity.py [--runs 3]

chip_smoke.py's ``train_moe_attention`` holds the card's training of the
long-context block (the attention net with a MixtureOfExpertsLayer after
each LayerNorm) against the same training on the CPU at T <= 512
(``moe_small_run``: two epochs, 4 Adam updates at lr 3e-3). The card sums
in other orders than the CPU, so each product differs in its last bits;
where two experts' gate probabilities are that close, a token's top-1
expert (``argmax``) differs, and the token's whole FFN output with it.
This script trains on the CPU from the smoke's seed weights, then again
from the same weights each multiplied by (1 + 2^-23 n), n a seeded normal
(``--runs`` draws), f32 and bf16, and again with pad tokens claiming
capacity (``pads_claim_capacity``), and prints chip_smoke.py's readings
(``recipe_readings``) of each against the unperturbed run, with the tokens
whose top-1 expert differs in each MoE layer's first forward. The limits
(``MOE_TRAIN_LIMITS``) must sit above the perturbed runs and below the
wrong one. About two minutes on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from deeplearning4j_tpu_torch.nn.layers import moe  # noqa: E402


class FirstRouting:
    """Records each MoE layer's top-1 expert of every real token in its
    first forward."""

    def __enter__(self):
        self.real = moe.MixtureOfExpertsLayer.apply
        self.seen = []
        real = self.real

        def apply(layer, params, x, state, mask=None, **kw):
            if len(self.seen) < 2:
                tokens = x.detach().reshape(-1, x.shape[-1])
                expert = torch.argmax(tokens @ params["Wg"].detach(), dim=-1)
                live = (torch.ones(len(expert), dtype=torch.bool) if mask is None
                        else mask.reshape(-1) > 0)
                self.seen.append(expert[live])
            return real(layer, params, x, state, mask=mask, **kw)

        moe.MixtureOfExpertsLayer.apply = apply
        return self

    def __exit__(self, *exc):
        moe.MixtureOfExpertsLayer.apply = self.real


def perturbed(host, seed: int):
    rng = np.random.default_rng(seed)
    return [{k: (np.asarray(v, np.float32)
                 * (1.0 + 2.0 ** -23 * rng.normal(size=np.shape(v)))).astype(np.float32)
             for k, v in layer.items()} for layer in host]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=3, help="perturbed starts per dtype")
    args = ap.parse_args()
    host = chip_smoke.moe_attention_params(chip_smoke.SEED)
    for dtype in ("float32", "bfloat16"):
        conf = chip_smoke.moe_attention_conf(dtype)
        with FirstRouting() as ref_routing:
            ref = chip_smoke.moe_small_run(conf, host, "cpu")
        lines = {}
        for i in range(args.runs):
            with FirstRouting() as routing:
                run = chip_smoke.moe_small_run(conf, perturbed(host, i), "cpu")
            r = chip_smoke.recipe_readings(run, ref, host, lr=chip_smoke.ATTN_LR)
            r["tokens_routed_elsewhere"] = [int((a != b).sum()) for a, b in
                                            zip(routing.seen, ref_routing.seen)]
            lines[f"perturbed_{i}"] = r
        wrong = chip_smoke.moe_small_run(conf, host, "cpu", fault=True)
        lines["pads_claim_capacity"] = chip_smoke.recipe_readings(wrong, ref, host,
                                                                  lr=chip_smoke.ATTN_LR)
        print(json.dumps({"dtype": dtype, "real_tokens_first_batch": len(ref_routing.seen[0]),
                          "losses": ref[1].tolist(), "readings_vs_unperturbed": lines,
                          "limits": chip_smoke.MOE_TRAIN_LIMITS[dtype]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
