"""Warm-boot bundles (counterpart of ``deeplearning4j_tpu/fleet/artifacts.py``):
what a fresh fleet worker needs to serve its first request with no capture.

A bundle is one JSON sidecar living NEXT TO the checkpoints (via
``CheckpointStore.artifact_path``), keyed per (model-signature, backend,
topology) — the same key family as TUNED.json. It carries:

- the **TUNED.json slice** for the model's config key (micro-batcher +
  admission knobs land through the normal ``auto_apply`` path);
- the **warmup spec**: pow2 row-bucket list, example trailing
  shape/dtype, the argmax flag, and for a recurrent net the request
  lengths to warm (``time_lengths``: a length that pads to its power of two
  is served by a masked graph, an exact power of two by an unmasked one) —
  the worker captures every bucket BEFORE reporting ready, so its first
  live request makes zero captures (the compile manager's counter pins
  this).

The JAX bundle's ``xla_cache_dir`` pointer and ``kernel`` block (kernel
selections and their calibration) have no counterpart: a CUDA graph cannot
be saved, and the port has no selection between a kernel and its plain
version. A JAX-written bundle loads, and those two blocks are ignored.

``build_bundle`` captures it from a live process (the trainer or a CLI),
``save_bundle``/``load_bundle`` move it through the checkpoint directory,
``install_bundle`` applies it inside a fresh worker before first traffic.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional, Sequence

import numpy as np

__all__ = ["BUNDLE_VERSION", "build_bundle", "bundle_filename",
           "install_bundle", "load_bundle", "save_bundle"]

BUNDLE_VERSION = 1


def bundle_filename(signature: str, backend: str, topology: str) -> str:
    return f"warmboot-{signature}.{backend}.{topology}.json"


def _store_dir(store_or_dir) -> str:
    return getattr(store_or_dir, "directory", None) or str(store_or_dir)


def _example_spec(net, example) -> tuple:
    """(trailing shape, dtype name) of one request row: ``[n_in]`` for a
    feed-forward net, ``[T, n_in]`` for a recurrent one. Derived from the
    net's declared input type when no example is given (a recurrent type
    must then declare its length)."""
    if example is not None:
        example = np.asarray(example)
        return tuple(int(d) for d in example.shape[1:]), str(example.dtype)
    it = getattr(net.conf, "input_type", None)
    kind = getattr(it, "kind", None)
    if kind == "ff":
        return (int(it.size),), "float32"
    if kind == "rnn" and it.timesteps is not None:
        return (int(it.timesteps), int(it.size)), "float32"
    raise ValueError(
        "build_bundle needs example= for this model (the warmup spec "
        "records one request's trailing shape; a recurrent input type "
        "without a length does not give one)")


def build_bundle(net, *, model: str = "default", example=None,
                 argmax: bool = True,
                 max_batch: Optional[int] = None,
                 time_lengths: Optional[Sequence[int]] = None) -> dict:
    """Capture a warm-boot bundle from THIS process for ``net``.

    ``max_batch`` bounds the warmup bucket list (default: the same
    env → TUNED.json → 64 resolution the micro-batcher will apply in
    the worker). ``argmax=True`` also warms the fused-argmax variants.
    ``time_lengths`` (a recurrent example only) lists further request
    lengths the worker warms beside the example's.
    """
    from ..runtime.compile_manager import next_pow2  # noqa: PLC0415
    from ..serving.batcher import MAX_BATCH_ENV  # noqa: PLC0415
    from ..tune import store as _tuned  # noqa: PLC0415

    sig = _tuned.model_signature(net)
    backend = _tuned.backend_name(net)
    topology = _tuned.topology_of(net)
    key = _tuned.config_key(sig, backend, topology)
    tuned_entry = _tuned.tuned_slice(key)

    if max_batch is None:
        raw = os.environ.get(MAX_BATCH_ENV)
        if raw is not None:
            max_batch = int(float(raw))
        elif tuned_entry and isinstance(tuned_entry.get("config"), dict):
            max_batch = tuned_entry["config"].get("serve_max_batch")
    if max_batch is None:
        max_batch = 64
    cap = next_pow2(int(max_batch))
    buckets, rows = [], 1
    while rows <= cap:
        buckets.append(rows)
        rows *= 2

    shape, dtype = _example_spec(net, example)
    warmup = {
        "buckets": buckets,
        "max_batch": int(max_batch),
        "example_shape": list(shape),
        "example_dtype": dtype,
        "argmax": bool(argmax),
    }
    if time_lengths:
        if len(shape) != 2:
            raise ValueError("time_lengths needs a recurrent example [T, n_in]")
        warmup["time_lengths"] = sorted({int(t) for t in time_lengths})
    return {
        "bundle_version": BUNDLE_VERSION,
        "built_at": time.time(),
        "model": str(model),
        "signature": sig,
        "backend": backend,
        "topology": topology,
        "tuned": ({"key": key, "entry": tuned_entry}
                  if tuned_entry else None),
        "warmup": warmup,
    }


def save_bundle(store_or_dir, bundle: dict) -> str:
    """Atomically persist ``bundle`` next to the checkpoints; returns the
    path. One file per (signature, backend, topology) — a newer bundle
    for the same key replaces the old one."""
    directory = _store_dir(store_or_dir)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, bundle_filename(
        bundle["signature"], bundle["backend"], bundle["topology"]))
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(bundle, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def load_bundle(store_or_dir, net=None, *,
                signature: Optional[str] = None,
                backend: Optional[str] = None,
                topology: Optional[str] = None) -> Optional[dict]:
    """Find the bundle matching ``net`` (or the explicit key parts) in a
    checkpoint directory. Key parts left unspecified match any single
    candidate — a worker that restored the net can match purely on the
    config signature even if the bundle was built on another backend. Returns
    None when no bundle (or an ambiguous set) is found."""
    from ..tune import store as _tuned  # noqa: PLC0415

    directory = _store_dir(store_or_dir)
    if net is not None:
        signature = signature or _tuned.model_signature(net)
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return None
    hits = []
    for name in names:
        if not (name.startswith("warmboot-") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(directory, name)) as f:
                bundle = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        if not isinstance(bundle, dict):
            continue
        if int(bundle.get("bundle_version", 0)) > BUNDLE_VERSION:
            continue  # newer schema than this code: skip, don't guess
        if signature and bundle.get("signature") != signature:
            continue
        if backend and bundle.get("backend") != backend:
            continue
        if topology and bundle.get("topology") != topology:
            continue
        hits.append(bundle)
    if len(hits) != 1:
        return None
    return hits[0]


def install_bundle(bundle: dict) -> dict:
    """Apply a bundle inside a FRESH worker, before first traffic: the
    tuned slice must precede ``register()``'s ``auto_apply``. Returns a
    report of what was installed plus the bundle's warmup spec (the worker
    drives ``InferenceService.warmup`` from it, then reads the capture
    counter and reports ready)."""
    from ..tune import store as _tuned  # noqa: PLC0415

    report = {"tuned": False}
    tuned = bundle.get("tuned") or None
    if tuned and tuned.get("key") and tuned.get("entry"):
        report["tuned"] = _tuned.install_slice(
            str(tuned["key"]), tuned["entry"]) is not None
    report["warmup"] = dict(bundle.get("warmup") or {})
    return report
