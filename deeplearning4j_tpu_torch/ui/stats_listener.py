"""StatsListener: rich per-iteration stats routed to a StatsStorage
(counterpart of ``deeplearning4j_tpu/ui/stats_listener.py``).

Reference: deeplearning4j-ui-model/.../stats/BaseStatsListener.java (score,
timing, memory :259-273; per-layer parameter/gradient/update histograms and
mean magnitudes :419-437). Records are plain dicts with the JAX package's
keys: score, iteration timing, process and device memory, per-layer
per-parameter mean magnitude and histogram of the parameters, gradients and
updates, and a static model report carrying the graph the flow view
renders.

The gradients and updates are the network's ``_last_grads`` and
``_last_updates``, which the update keeps only on the iterations a
``needs_gradients`` listener's ``frequency`` selects (``BaseNetwork.
_wants_grad_stats``), so an update pays for them only when a dashboard asks.
A report's leaves come to the host in one batched copy (one ``torch.cat`` of
every leaf of a dtype on the card, one copy back), not in one synchronizing
copy per leaf; the arithmetic is then the JAX package's numpy (mean of the
magnitudes in the leaf's dtype, 20-bin ``np.histogram`` in float64), so the
records agree with JAX's for the same arrays. bf16 leaves are widened to
float32 on the host.
"""

from __future__ import annotations

import os
import time
import uuid
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..optimize.listeners import TrainingListener
from .storage import StatsStorageRouter


def _mean_magnitude(arr) -> float:
    a = np.asarray(arr)
    return float(np.mean(np.abs(a))) if a.size else 0.0


def _histogram(arr, bins: int = 20) -> Dict[str, Any]:
    a = np.asarray(arr).ravel().astype(np.float64)
    if a.size == 0:
        return {"bins": [], "counts": []}
    counts, edges = np.histogram(a[np.isfinite(a)], bins=bins)
    return {"bins": edges.tolist(), "counts": counts.tolist()}


def _process_memory_bytes() -> Optional[int]:
    try:
        import resource  # noqa: PLC0415

        # ru_maxrss is KiB on Linux
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except (ImportError, OSError):  # pragma: no cover
        return None


def host_arrays(tensors: List[torch.Tensor]) -> List[np.ndarray]:
    """Host copies of ``tensors``: the leaves of one dtype on one card are
    joined by one ``torch.cat`` and copied back in one transfer (one
    synchronization for the lot); CPU leaves are read in place. bf16 comes
    back as float32."""
    out: List[Optional[np.ndarray]] = [None] * len(tensors)
    groups: Dict[tuple, List[int]] = {}
    for i, t in enumerate(tensors):
        t = t.detach()
        if t.device.type == "cpu":
            out[i] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        else:
            groups.setdefault((t.device, t.dtype), []).append(i)
    for (_, dtype), idx in groups.items():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        if dtype == torch.bfloat16:
            flat = flat.float()
        host = flat.cpu().numpy()
        start = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = host[start:start + n].reshape(tuple(tensors[i].shape))
            start += n
    return out


def _named_param_groups(model, tree) -> List[tuple]:
    """[(group name, {param name: leaf})] of a param-shaped list in the
    network's ``_leaves()`` order: the layer index for a
    MultiLayerNetwork, the vertex name for a ComputationGraph (the JAX
    package's group names); groups without params are left out."""
    if tree is None:
        return []
    names = getattr(model, "_names", None)
    return [(str(i) if names is None else str(names[i]), p)
            for i, p in enumerate(tree) if p]


def model_graph_info(model) -> Dict[str, Any]:
    """Node/edge structure for the flow view (reference: FlowIterationListener
    / FlowListenerModule build the same description from the live model)."""
    conf = getattr(model, "conf", None)
    nodes: List[dict] = []
    edges: List[list] = []
    if conf is None:
        return {"nodes": nodes, "edges": edges}
    if hasattr(conf, "vertices"):  # ComputationGraph
        for inp in conf.network_inputs:
            nodes.append({"name": inp, "type": "Input"})
        for name, vertex in conf.vertices.items():
            nodes.append({
                "name": name,
                "type": type(vertex).__name__,
                "output": name in conf.network_outputs,
            })
            for src in conf.vertex_inputs.get(name, []):
                edges.append([src, name])
    elif hasattr(conf, "layers"):  # MultiLayerNetwork
        nodes.append({"name": "input", "type": "Input"})
        prev = "input"
        for i, layer in enumerate(conf.layers):
            name = f"{i}_{type(layer).__name__}"
            nodes.append({"name": name, "type": type(layer).__name__,
                          "output": i == len(conf.layers) - 1})
            edges.append([prev, name])
            prev = name
    return {"nodes": nodes, "edges": edges}


class StatsListener(TrainingListener):
    """Collects and routes training statistics every ``frequency`` iterations."""

    def __init__(
        self,
        router: StatsStorageRouter,
        frequency: int = 1,
        session_id: Optional[str] = None,
        worker_id: str = "0",
        collect_histograms: bool = True,
        collect_gradients: bool = True,
        histogram_bins: int = 20,
    ):
        self.router = router
        self.frequency = max(1, frequency)
        self.session_id = session_id or f"session_{uuid.uuid4().hex[:8]}"
        self.worker_id = worker_id
        self.collect_histograms = collect_histograms
        self.collect_gradients = collect_gradients
        self.histogram_bins = histogram_bins
        self._static_sent = False
        self._last_time: Optional[float] = None

    @property
    def needs_gradients(self) -> bool:
        """The networks keep the update's gradients and updates for this
        listener's iterations when it is True."""
        return self.collect_gradients

    # -- static info: model architecture, once (reference: initial report) --
    def _send_static(self, model) -> None:
        conf = getattr(model, "conf", None)
        layers = []
        if conf is not None and hasattr(conf, "layers"):
            layers = [type(l).__name__ for l in conf.layers]
        elif conf is not None and hasattr(conf, "vertices"):
            layers = [type(v).__name__ for v in conf.vertices.values()]
        param_counts = {
            name: {k: int(v.numel()) for k, v in group.items()}
            for name, group in _named_param_groups(model, model._leaves())
        }
        self.router.put_static_info(
            {
                "session_id": self.session_id,
                "worker_id": self.worker_id,
                "timestamp": time.time(),
                "model_class": type(model).__name__,
                "layers": layers,
                "graph": model_graph_info(model),
                "param_counts": param_counts,
                "num_params": model.num_params(),
                "pid": os.getpid(),
                "backend": _backend_name(),
            }
        )
        self._static_sent = True

    def _trees(self, model) -> List[tuple]:
        """(key prefix, named groups) of the trees this report reads; a
        tree the update did not keep (a TBPTT segment's) is left out."""
        trees = [("param", model._leaves())]
        if self.collect_gradients:
            trees += [("gradient", getattr(model, "_last_grads", None)),
                      ("update", getattr(model, "_last_updates", None))]
        return [(prefix, _named_param_groups(model, tree))
                for prefix, tree in trees if tree is not None]

    def _collect(self, record: Dict[str, Any], model) -> None:
        trees = self._trees(model)
        leaves = [v for _, groups in trees for _, group in groups for v in group.values()]
        host = iter(host_arrays(leaves))
        for prefix, groups in trees:
            mm: Dict[str, float] = {}
            hists: Dict[str, Any] = {}
            for gname, group in groups:
                for k in group:
                    a = next(host)
                    name = f"{gname}_{k}"
                    mm[name] = _mean_magnitude(a)
                    if self.collect_histograms:
                        hists[name] = _histogram(a, self.histogram_bins)
            record[f"{prefix}_mean_magnitudes"] = mm
            if self.collect_histograms:
                record[f"{prefix}_histograms"] = hists

    def iteration_done(self, model, iteration: int, score) -> None:
        if iteration % self.frequency:
            return
        if not self._static_sent:
            self._send_static(model)
        now = time.time()
        record: Dict[str, Any] = {
            "session_id": self.session_id,
            "worker_id": self.worker_id,
            "timestamp": now,
            "iteration": iteration,
            "score": float(score),
        }
        if self._last_time is not None:
            record["iteration_time_ms"] = (now - self._last_time) * 1e3
        self._last_time = now
        mem = _process_memory_bytes()
        if mem is not None:
            record["memory_rss_bytes"] = mem
        dev = _device_memory_stats()
        if dev:
            record["device_memory"] = dev
        # phase breakdown where a trainer attached its StepTimer to the model
        timer = getattr(model, "_phase_timer", None)
        if timer is not None and timer.totals:
            record["phase_timings"] = timer.breakdown()
        self._collect(record, model)
        self.router.put_update(record)


def _backend_name() -> str:
    """The JAX package's ``jax.default_backend()`` names: ``gpu`` where
    CUDA is available, else ``cpu``."""
    return "gpu" if torch.cuda.is_available() else "cpu"


def _device_memory_stats() -> List[dict]:
    """The profiler's per-card allocator rows, each with the card's name
    (``device_kind``, PJRT's word for it)."""
    from ..profiler import device_memory_stats  # noqa: PLC0415

    return [dict(row, device_kind=torch.cuda.get_device_name(row["device"]))
            for row in device_memory_stats()]
