#!/usr/bin/env python3
"""How far the DBN's and the VAE's pretraining and fine-tuning move under a
rounding-sized change of their start, and how far under chip_smoke.py's
wrong versions.

    python3 scripts/dbn_vae_sensitivity.py [--runs 3]

chip_smoke.py's ``train_dbn`` and ``pretrain_vae`` hold the card's run
(``pretrain_run``: pretrain from the seed params with the noise drawn on
the host and passed through pretrain's seam, then a few fine-tune updates)
against the same run on the CPU, by ``pretrain_readings``. The card rounds
otherwise than the CPU; an RBM samples its binary units as u < p, so where
a p lies within a rounding of its u, a unit flips. This script runs on the
CPU from the smoke's seed params, then again from the same params each
multiplied by (1 + 2^-23 n), n a seeded normal (``--runs`` draws), and
under the wrong versions (``pretrain_faults``: the RBM's negative phase
with the wrong sign, the VAE's ELBO without its KL term), and prints the
readings of each against the unperturbed run. The limits (``DBN_LIMITS``,
``VAE_LIMITS``) must sit above the perturbed runs and below the wrong ones.
About half a minute on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from deeplearning4j_tpu_torch import dbn_conf  # noqa: E402


def perturbed(host, seed: int):
    rng = np.random.default_rng(seed)
    return [{k: (np.asarray(v, np.float32)
                 * (1.0 + 2.0 ** -23 * rng.normal(size=np.shape(v)))).astype(np.float32)
             for k, v in layer.items()} for layer in host]


def cases():
    """name -> (conf, pre batches, fine batches, draws, lr, the wrong
    version, the limits), as chip_smoke.py's phases make them."""
    dbn = dbn_conf(updater="adam")
    vae = chip_smoke.vae_conf()
    return {
        "dbn": (dbn, chip_smoke.dbn_batches(chip_smoke.DBN_PRETRAIN_BATCHES, chip_smoke.SEED + 50),
                chip_smoke.dbn_batches(chip_smoke.DBN_FINETUNE_UPDATES, chip_smoke.SEED + 51),
                chip_smoke.rbm_draws(dbn, chip_smoke.DBN_PRETRAIN_BATCHES, chip_smoke.SEED + 52),
                dbn.updater["learning_rate"], "rbm_negative_phase_sign", chip_smoke.DBN_LIMITS),
        "vae": (vae, chip_smoke.dbn_batches(chip_smoke.VAE_PRETRAIN_BATCHES, chip_smoke.SEED + 56),
                chip_smoke.dbn_batches(chip_smoke.VAE_FIT_UPDATES, chip_smoke.SEED + 57),
                chip_smoke.vae_draws(vae.layers[0], chip_smoke.VAE_PRETRAIN_BATCHES,
                                     chip_smoke.SEED + 58),
                chip_smoke.VAE_LR, "vae_kl_dropped", chip_smoke.VAE_LIMITS),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=3, help="perturbed starts")
    args = ap.parse_args()
    for name, (conf, pre, fine, draws, lr, fault, limits) in cases().items():
        host = chip_smoke.conf_host(conf)
        ref = chip_smoke.pretrain_run(conf, host, pre, fine, draws, "cpu")
        lines = {}
        for i in range(args.runs):
            run = chip_smoke.pretrain_run(conf, perturbed(host, i), pre, fine, draws, "cpu")
            lines[f"perturbed_{i}"] = chip_smoke.pretrain_readings(run, ref, lr)
        wrong = chip_smoke.pretrain_run(conf, host, pre, fine, draws, "cpu", fault)
        lines[fault] = chip_smoke.pretrain_readings(wrong, ref, lr)
        print(json.dumps({"model": name, "pretrain_losses": ref["pre_losses"].tolist(),
                          "fit_losses": ref["fit_losses"].tolist(),
                          "readings_vs_unperturbed": lines, "limits": limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
