"""Device-memory accounting: where the bytes go, before and while they go
there (counterpart of ``deeplearning4j_tpu/telemetry/memory.py``).

Two sources feed one registry:

- **Projected, from the model.** :func:`memory_report` walks a net's layers
  or vertices through a forward on ``meta`` tensors (shapes and dtypes only:
  no arithmetic, nothing allocated; the kernel wrappers take a tensor that
  is not on the card to their plain versions) and attributes param +
  gradient + optimizer-state + activation bytes per layer, for both
  ``MultiLayerNetwork`` and ``ComputationGraph``, with the same integers as
  the JAX package's report. :func:`preflight` compares the projected peak
  against the live limit and raises a "will not fit, biggest consumers are
  X/Y/Z" error before the first fit pays for a doomed allocation.
- **Live, from the caching allocator.** :func:`device_memory_stats` reads
  ``torch.cuda.memory_stats`` (in use, peak) and ``torch.cuda.mem_get_info``
  (the limit) per device; :func:`sample_device_memory` additionally records
  registry gauges + a peak watermark and is called on every telemetry fetch
  — live memory rides the same K-step cadence as the training metrics,
  never a per-step sync. On a machine without CUDA the list is empty.

- **Captured, from the graphs' pool.** :func:`executable_memory` is the
  counterpart of the JAX package's (XLA's ``memory_analysis`` of a compiled
  program): it reads the memory pool a captured CUDA graph allocates from
  (the bytes the caching allocator has reserved for that pool and those
  allocated in it, from ``torch.cuda.memory_snapshot``'s segments), and
  keeps the JAX ``{"available": False, "reason": ...}`` shape where it
  cannot read them (an eager entry on the CPU). Every graph of one network
  shares its pool, so the compile manager's summary counts a pool once.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional

from .registry import MetricsRegistry, get_registry

# env knob: explicit per-device memory budget for preflight where no device
# reports its limit
HBM_LIMIT_ENV = "DL4JTPU_HBM_LIMIT_BYTES"

# timesteps probe substituted for variable-length recurrent inputs (the
# JAX package's DEFAULT_TIMESTEPS_PROBE)
DEFAULT_TIMESTEPS_PROBE = 16


def _fmt_bytes(n: float) -> str:
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024.0:
            return f"{n:.1f} {unit}"
        n /= 1024.0
    return f"{n:.1f} TiB"


# ------------------------------------------------------------- captured
def pool_segments() -> Optional[list]:
    """The caching allocator's segments (``torch.cuda.memory_snapshot``),
    or None where there is no CUDA device."""
    try:
        import torch  # noqa: PLC0415

        if not torch.cuda.is_available():
            return None
        return torch.cuda.memory_snapshot()
    except Exception:  # pragma: no cover - a CUDA runtime error reads as none
        return None


def executable_memory(entry, segments: Optional[list] = None) -> dict:
    """Byte accounting of one captured program: the memory pool of its CUDA
    graph (``entry.pool``, the handle ``CUDAGraph.pool()`` gave), summed
    over the allocator's segments of that pool: ``reserved_bytes`` (the
    segments' size), ``allocated_bytes`` (the blocks in use in them) and
    ``total_bytes`` (= reserved, what the pool holds on the card). Always
    returns a record: where the pool cannot be read, ``available: False``
    and a reason. ``segments`` is a snapshot to read (one for many
    entries); else one is taken."""
    pool = getattr(entry, "pool", None)
    if getattr(entry, "graph", None) is None or pool is None:
        return {"available": False,
                "reason": "no captured graph: an eager entry (the CPU)"}
    if segments is None:
        segments = pool_segments()
    if segments is None:
        return {"available": False, "reason": "no CUDA device"}
    if segments and "segment_pool_id" not in segments[0]:
        return {"available": False,
                "reason": "this torch's memory snapshot names no segment pools"}
    want = tuple(int(v) for v in pool)
    reserved = allocated = 0
    for seg in segments:
        pid = seg.get("segment_pool_id")
        if pid is not None and tuple(int(v) for v in pid) == want:
            reserved += int(seg.get("total_size", 0))
            allocated += int(seg.get("allocated_size", 0))
    return {"available": True, "pool": list(want), "reserved_bytes": reserved,
            "allocated_bytes": allocated, "total_bytes": reserved}


def network_pool_bytes(net) -> int:
    """Reserved bytes of the memory pools of ``net``'s captured graphs (the
    compile manager's entries under its token, served buckets and training
    steps, each pool counted once); 0 where nothing is captured (the CPU)."""
    from ..runtime.compile_manager import get_compile_manager  # noqa: PLC0415

    segments = pool_segments()
    seen, total = set(), 0
    for _, entry in get_compile_manager().owned(net._cm_token):  # noqa: SLF001
        rec = executable_memory(entry, segments)
        pool = tuple(rec.get("pool") or ())
        if rec.get("available") and pool not in seen:
            seen.add(pool)
            total += int(rec["total_bytes"])
    return total


# ------------------------------------------------------------------ live
def device_memory_stats(registry: Optional[MetricsRegistry] = None) -> List[dict]:
    """Per-device allocator stats — the live-memory source the telemetry
    fetch and the flight recorder read: ``bytes_in_use`` and
    ``peak_bytes_in_use`` from ``torch.cuda.memory_stats``, ``bytes_limit``
    the device's total from ``torch.cuda.mem_get_info``. With ``registry``
    the rows also land as ``dl4jtpu_device_hbm_bytes{device,kind}`` gauges
    (the JAX package's names)."""
    out: List[dict] = []
    try:
        import torch  # noqa: PLC0415

        if torch.cuda.is_available():
            for d in range(torch.cuda.device_count()):
                ms = torch.cuda.memory_stats(d)
                out.append({
                    "device": int(d),
                    "bytes_in_use": int(ms.get("allocated_bytes.all.current", 0)),
                    "peak_bytes_in_use": int(ms.get("allocated_bytes.all.peak", 0)),
                    "bytes_limit": int(torch.cuda.mem_get_info(d)[1]),
                })
    except Exception:  # pragma: no cover - a CUDA runtime error reads as no device
        out = []
    if registry is not None and out:
        fam = registry.gauge(
            "dl4jtpu_device_hbm_bytes",
            "live per-device HBM (PJRT memory_stats)",
            labelnames=("device", "kind"),
        )
        for row in out:
            for kind in ("bytes_in_use", "bytes_limit"):
                if row.get(kind) is not None:
                    fam.labels(device=row["device"],
                               kind=kind.replace("bytes_", "").replace(
                                   "_bytes", "")).set(row[kind])
    return out


def sample_device_memory(registry: Optional[MetricsRegistry] = None,
                         flight=None) -> List[dict]:
    """Record live memory gauges + a sticky peak watermark; called on every
    telemetry fetch (K-step cadence — never per step). ``flight``: a
    :class:`~.flight_recorder.FlightRecorder` to drop a ``memory`` event
    into (the post-mortem trail of watermarks)."""
    reg = registry if registry is not None else get_registry()
    rows = device_memory_stats(reg)
    if not rows:
        return rows
    peak_fam = reg.gauge(
        "dl4jtpu_device_hbm_peak_bytes",
        "peak HBM watermark per device (sticky max of PJRT peaks)",
        labelnames=("device",),
    )
    for row in rows:
        peak = row.get("peak_bytes_in_use") or row.get("bytes_in_use") or 0
        child = peak_fam.labels(device=row["device"])
        if peak > child.value:
            child.set(peak)
    if flight is not None:
        try:
            flight.record("memory", devices=[
                {k: row.get(k) for k in ("device", "bytes_in_use",
                                         "peak_bytes_in_use")}
                for row in rows
            ])
        except Exception:  # observability must never kill the train loop
            pass
    return rows


# ------------------------------------------------- projected (the model)
def _nbytes(tensors) -> int:
    return int(sum(t.numel() * t.element_size() for t in tensors))


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _meta(t):
    import torch  # noqa: PLC0415

    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _input_metas(net, batch_or_struct):
    """Input meta tensors for a net: an int batch size builds them from the
    declared input types (f32; a variable-length recurrent input takes
    DEFAULT_TIMESTEPS_PROBE steps); arrays, tensors or (shape, dtype)-like
    objects (or a list of them for multi-input graphs) give shape and dtype
    only."""
    import numpy as np  # noqa: PLC0415
    import torch  # noqa: PLC0415

    conf = net.conf

    def shell(a):
        if isinstance(a, torch.Tensor):
            return _meta(a)
        if not hasattr(a, "dtype"):
            a = np.asarray(a)
        dt = a.dtype
        if not isinstance(dt, torch.dtype):
            dt = torch.from_numpy(np.zeros((), np.dtype(dt))).dtype
        return torch.empty(tuple(a.shape), dtype=dt, device="meta")

    if batch_or_struct is None:
        batch_or_struct = 32
    if isinstance(batch_or_struct, (int, np.integer)):
        b = int(batch_or_struct)
        if hasattr(conf, "vertices"):
            its = conf.input_types
        else:
            if conf.input_type is None:
                raise ValueError(
                    "memory_report needs conf.input_type (or pass example "
                    "arrays instead of a batch size)")
            its = [conf.input_type]
        out = []
        for it in its:
            if getattr(it, "kind", None) == "rnn" and it.timesteps is None:
                shape = (DEFAULT_TIMESTEPS_PROBE, it.size)
            else:
                shape = it.example_shape()
            out.append(torch.empty((b,) + tuple(shape), dtype=torch.float32, device="meta"))
        return out
    if isinstance(batch_or_struct, (list, tuple)):
        return [shell(a) for a in batch_or_struct]
    return [shell(batch_or_struct)]


def _core_state_bytes(updater, layer_params: dict) -> int:
    """Bytes of the updater's state for one layer's params alone (moments
    per leaf plus the scalar counts, as optax's ``init`` on the layer's
    subtree counts them), from meta tensors."""
    from ..nn.updaters import opt_state_leaves  # noqa: PLC0415

    state = updater.init([{k: _meta(v) for k, v in layer_params.items()}])
    return _nbytes(opt_state_leaves(state))


def memory_report(net, batch_or_struct=None) -> dict:
    """Per-layer/vertex device-memory attribution for a
    ``MultiLayerNetwork`` or ``ComputationGraph`` — a forward on meta
    tensors, nothing allocates.

    ``batch_or_struct``: an int batch size (default 32), example arrays or
    tensors (a list for multi-input graphs).

    Returns ``{"layers": [...], "totals": {...}, "top_consumers": [...]}``,
    the JAX package's dict. Param and optimizer totals are exact (counted
    off the live tensors; the updater's state from meta tensors if it has
    not been built yet); activation bytes are each layer's output at the
    given batch in the compute dtype; the projected peak models one training
    step's working set::

        params + gradients(= params) + optimizer state + activations + inputs

    The caching allocator's reuse can beat this — treat it as the planning
    number, not a measurement (``torch.cuda.max_memory_allocated`` is the
    measured one).
    """
    import torch  # noqa: PLC0415

    from ..nn.updaters import UpdaterConfig, opt_state_leaves  # noqa: PLC0415

    net.init()
    conf = net.conf
    inputs = _input_metas(net, batch_or_struct)
    is_graph = hasattr(conf, "vertices")
    leaves = net._leaves()
    updater = net._updater if net._updater is not None else \
        UpdaterConfig.from_dict(conf.updater).build()
    meta_state = [{k: _meta(v) for k, v in d.items()} for d in net._state_dicts()]

    def as_input(t):
        return t.to(net.compute_dtype) if t.is_floating_point() else t

    with torch.no_grad():
        if is_graph:
            params = {n: {k: _meta(v).to(net.compute_dtype) for k, v in p.items()}
                      for n, p in net.vertex_params.items()}
            state = dict(zip(net._names, meta_state))
            acts, _, _ = net._activations(params, [as_input(x) for x in inputs],
                                          state=state)
            names = list(net._topo)
            by_name = dict(zip(net._names, leaves))
            params_of = lambda n: by_name[n]  # noqa: E731
            act_of = lambda n: acts.get(n)  # noqa: E731
            label_of = lambda n: n  # noqa: E731
            type_of = lambda n: (  # noqa: E731
                type(getattr(conf.vertices[n], "layer", None)).__name__
                if getattr(conf.vertices[n], "layer", None) is not None
                else type(conf.vertices[n]).__name__)
        else:
            params = [{k: _meta(v).to(net.compute_dtype) for k, v in p.items()}
                      for p in leaves]
            acts: list = []
            net._forward(params, as_input(inputs[0]), tuple(meta_state), acts=acts)
            names = list(range(len(conf.layers)))
            params_of = lambda i: leaves[i]  # noqa: E731
            act_of = lambda i: acts[i]  # noqa: E731
            label_of = lambda i: f"layer[{i}]"  # noqa: E731
            type_of = lambda i: type(conf.layers[i]).__name__  # noqa: E731

    rows = []
    for n in names:
        p_bytes = _nbytes(params_of(n).values())
        a = act_of(n)
        a_bytes = _nbytes([a]) if isinstance(a, torch.Tensor) else 0
        o_bytes = _core_state_bytes(updater, params_of(n)) if p_bytes else 0
        rows.append({
            "name": label_of(n),
            "type": type_of(n),
            "param_bytes": p_bytes,
            "grad_bytes": p_bytes,  # autodiff mirrors the params
            "opt_state_bytes": o_bytes,
            "activation_bytes": a_bytes,
            "activation_shape": (list(a.shape) if isinstance(a, torch.Tensor) else None),
            "total_bytes": 2 * p_bytes + o_bytes + a_bytes,
        })

    param_total = _nbytes([v for layer in leaves for v in layer.values()])
    opt_state = net._opt_state if net._opt_state is not None else \
        updater.init([{k: _meta(v) for k, v in layer.items()} for layer in leaves])
    opt_total = _nbytes(opt_state_leaves(opt_state))
    act_total = sum(r["activation_bytes"] for r in rows)
    input_total = _nbytes(inputs)
    projected = 2 * param_total + opt_total + act_total + input_total
    return {
        "model": type(net).__name__,
        "dtype": conf.dtype,
        "remat": bool(getattr(conf, "remat", False)),
        "inputs": [{"shape": list(s.shape), "dtype": _dtype_name(s.dtype),
                    "bytes": _nbytes([s])} for s in inputs],
        "layers": rows,
        "totals": {
            "param_bytes": param_total,
            "grad_bytes": param_total,
            "opt_state_bytes": opt_total,
            "activation_bytes": act_total,
            "input_bytes": input_total,
            "projected_peak_bytes": projected,
        },
        "top_consumers": [
            {"name": r["name"], "type": r["type"],
             "total_bytes": r["total_bytes"],
             "human": _fmt_bytes(r["total_bytes"])}
            for r in sorted(rows, key=lambda r: -r["total_bytes"])[:3]
        ],
    }


# ----------------------------------------------------------------- preflight
class MemoryPreflightError(RuntimeError):
    """Raised when the projected peak will not fit the memory budget;
    carries the full :func:`memory_report` as ``.report``."""

    def __init__(self, message: str, report: dict,
                 projected_bytes: int, limit_bytes: int):
        super().__init__(message)
        self.report = report
        self.projected_bytes = projected_bytes
        self.limit_bytes = limit_bytes


def _hbm_limit() -> tuple:
    """(limit_bytes, source) — the device's total, the env override, or
    host MemAvailable as the CPU stand-in; (None, reason) when nothing
    knows."""
    for row in device_memory_stats():
        if row.get("bytes_limit"):
            return int(row["bytes_limit"]), f"device {row['device']} memory_stats"
    env = os.environ.get(HBM_LIMIT_ENV)
    if env:
        try:
            return int(env), f"env {HBM_LIMIT_ENV}"
        except ValueError:
            pass
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024, \
                        "host MemAvailable (cpu stand-in)"
    except OSError:
        pass
    return None, "no memory_stats, env override, or /proc/meminfo"


def preflight(net, batch_or_struct=None, *, limit_bytes: Optional[int] = None,
              headroom: float = 0.9, registry: Optional[MetricsRegistry] = None,
              flight: Optional[Any] = None, layout: Optional[Any] = None) -> dict:
    """Will this net + batch fit? Raises :class:`MemoryPreflightError` with
    the biggest consumers named before any fit pays a doomed allocation;
    returns the annotated :func:`memory_report` when it fits (or when no
    limit source exists — ``report["preflight"]["checked"]`` says which).
    ``headroom`` reserves a fraction of the limit for the allocator's
    fragmentation and the kernels' scratch. The JAX package's IR scan (its
    ``"ir"`` section) and per-device ``layout=`` projection are not ported:
    ``layout`` raises ``NotImplementedError``."""
    if layout is not None:
        raise NotImplementedError(
            "preflight(layout=...) is not ported yet (ROADMAP.md Queue 1 item 8, "
            "the mesh layouts)")
    report = memory_report(net, batch_or_struct)
    source = "explicit limit_bytes"
    if limit_bytes is None:
        limit_bytes, source = _hbm_limit()
    if flight is not None:
        try:
            flight.attach_memory_report(report)
        except Exception:
            pass
    if limit_bytes is None:
        report["preflight"] = {"checked": False, "reason": source}
        return report
    projected = report["totals"]["projected_peak_bytes"]
    budget = int(limit_bytes * headroom)
    report["preflight"] = {
        "checked": True,
        "fits": projected <= budget,
        "projected_peak_bytes": projected,
        "per_device": False,
        "limit_bytes": int(limit_bytes),
        "headroom": headroom,
        "limit_source": source,
    }
    if registry is not None:
        registry.gauge(
            "dl4jtpu_projected_peak_hbm_bytes",
            "memory_report projected training peak of the last preflight",
        ).set(projected)
    if projected > budget:
        top = ", ".join(
            f"{c['name']} ({c['type']}, {c['human']})"
            for c in report["top_consumers"])
        raise MemoryPreflightError(
            f"projected training peak {_fmt_bytes(projected)} exceeds "
            f"{_fmt_bytes(budget)} ({headroom:.0%} of "
            f"{_fmt_bytes(limit_bytes)} from {source}); "
            f"biggest consumers: {top}",
            report, projected, int(limit_bytes),
        )
    return report
