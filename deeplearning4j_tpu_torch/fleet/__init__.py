"""The serving fleet (counterpart of ``deeplearning4j_tpu/fleet/``):
multi-process serving scale-out.

N independent single-process workers (no cross-process collectives — each
owns its own :class:`~deeplearning4j_tpu_torch.serving.InferenceService`)
behind a thin routing front, with the
:class:`~deeplearning4j_tpu_torch.runtime.checkpoint.CheckpointStore` as
the train→fleet version-propagation bus. On one card every worker shares
the card, each with its own CUDA context and its graphs' own pool.

Pieces:

- :mod:`fleet.artifacts` — the **warm-boot bundle**: what a fresh worker
  needs to serve its first request with ZERO captures (the TUNED.json
  slice and the warmup bucket list), persisted per (model-signature,
  backend, topology) next to the checkpoints.
- :mod:`fleet.worker` — standalone serving process
  (``python -m deeplearning4j_tpu_torch.fleet.worker``): boots from a store
  path, installs the bundle, captures every bucket BEFORE reporting ready,
  serves HTTP, watches the store for new versions (hot_swap, no restart),
  drains gracefully on SIGTERM / POST /drain.
- :mod:`fleet.router` — HTTP front that spawns/supervises N workers
  (respawn-on-death with backoff), routes by least outstanding requests,
  sheds with 429 + Retry-After, rolls new checkpoint versions across the
  fleet one worker at a time, and aggregates ``/metrics`` +
  ``/api/fleet`` (``python -m deeplearning4j_tpu_torch.fleet.router``).
"""

from .artifacts import (BUNDLE_VERSION, build_bundle, bundle_filename,
                        install_bundle, load_bundle, save_bundle)
from .router import FleetRouter, get_fleet_routers
from .worker import FleetWorker

__all__ = [
    "BUNDLE_VERSION",
    "FleetRouter",
    "FleetWorker",
    "build_bundle",
    "bundle_filename",
    "get_fleet_routers",
    "install_bundle",
    "load_bundle",
    "save_bundle",
]
