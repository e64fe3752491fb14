"""CLI: ``python -m deeplearning4j_tpu_torch.tune --model mlp --budget 60s``
(counterpart of ``deeplearning4j_tpu/tune/__main__.py``).

Runs the autopilot for one (model, objective) workload, prints the rung
progress as it goes, and finishes with ONE JSON line (the same contract
bench.py uses) so the result is machine-readable. The winning config
persists to TUNED.json unless ``--no-persist``. The search runs on the card;
``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys

from .search import parse_budget, run_autotune
from .store import TunedStore, tuned_path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.tune",
        description="closed-loop performance autotuner")
    ap.add_argument("--model", default="mlp",
                    help="workload model (default: mlp)")
    ap.add_argument("--objective", default="fit", choices=("fit", "serve"),
                    help="tune for training throughput or serving "
                         "load/p99 (default: fit)")
    ap.add_argument("--budget", default="60s",
                    help="search budget, e.g. 60s / 2m (default: 60s)")
    ap.add_argument("--rungs", type=int, default=2,
                    help="successive-halving rungs (default: 2)")
    ap.add_argument("--device", default="cuda",
                    help="where the trials run (default: cuda)")
    ap.add_argument("--store", default=None,
                    help=f"TUNED.json path (default: {tuned_path()})")
    ap.add_argument("--no-persist", action="store_true",
                    help="search only; do not write TUNED.json")
    ap.add_argument("--show", action="store_true",
                    help="print the current TUNED.json entries and exit")
    args = ap.parse_args(argv)

    if args.show:
        store = TunedStore(args.store)
        print(f"# {store.path}")
        for key in store.keys():
            print(json.dumps({"key": key, **(store.get(key) or {})},
                             sort_keys=True))
        return 0

    result = run_autotune(
        model=args.model, objective=args.objective,
        budget_s=parse_budget(args.budget), rungs=args.rungs,
        store_path=args.store, device=args.device,
        persist=not args.no_persist,
        log=lambda m: print(f"# {m}", file=sys.stderr))
    d = result.as_dict()
    summary = {
        "metric": f"autotune_{result.objective}_{result.metric}",
        "value": result.best.measured,
        "unit": result.metric,
        "best_config": result.best.config,
        "default_value": result.default.measured,
        "ratio_vs_default": (
            round(result.best.measured / result.default.measured, 4)
            if result.default.measured else None),
        "pruned_count": d["pruned_count"],
        "trials": len(result.trials),
        "env_ok": result.env_ok,
        "key": result.key,
        "store_path": result.store_path,
        "elapsed_s": d["elapsed_s"],
    }
    print(json.dumps(summary, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
