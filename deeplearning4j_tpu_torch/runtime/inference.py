"""Bucketed inference, replayed as CUDA graphs (counterpart of
``deeplearning4j_tpu/runtime/inference.py``).

``output()``, ``predict()`` and ``rnn_time_step()`` of both networks come
here unless ``DL4JTPU_INFER=legacy`` (or ``0``/``off``) asks for the eager,
shape-exact dispatch, which is the yardstick this path is held against. It
does what the JAX package's fast path does, with a CUDA graph where XLA has
an executable:

- **The boundary cast.** A request stays where it lies: a card tensor is
  cast to the compute dtype on the card and copied into the graph's input
  there, with no trip through the host; a host request crosses as float32
  (f64 and f16 cast on the host) and a bf16 network rounds it on the card
  after the copy (``_request``). Either way an f64 request takes the f32
  request's graph.
- **Power-of-two buckets with exact padding.** Rows pad to the next power
  of two with zeros (not for a network with BatchNormalization, whose batch
  statistics couple the rows: ``_pad_examples_ok``; see ``_pads`` for the
  networks that keep the request's rows or steps), time to the next power
  of two with the features mask extended by zeros, so the padded steps hold
  LSTM h/c, drop out of attention and of mask-aware pooling. Unlike the JAX
  package, a mask is made only where the time axis is padded or the caller
  gave one: a request of a power-of-two length runs the unmasked kernels,
  as the eager path does, and the key carries whether a mask is present.
- **One graph a bucket, in the process-wide manager.** Each bucket's
  forward is an entry of ``runtime.compile_manager`` under the network's
  token (kinds ``mln_infer``, ``mln_rnn_step``, ``graph_infer``,
  ``graph_rnn_step``). On the card the entry is a CUDA graph, captured
  once (one eager warm-up run on a side stream first, where the kernels
  build and cuDNN picks its algorithms; nothing inside the capture reads
  the host) and replayed for every request of that bucket; on the CPU it
  is the eager callable of the bucket. The graphs of one network share one
  memory pool.
- **Fixed buffers.** A graph reads its static inputs, the network's params
  in the compute dtype (``_params()``: on the f32 path the leaves
  themselves; cast buffers otherwise, refreshed in place after an update or
  a ``swap_params``), the served copy of the layer state (``_served_state``,
  refreshed in place when ``fit`` rebinds or writes the state) and, for a
  streaming step, the network's streaming-state buffers of that batch size,
  which the graph updates in place. So an update or a hot swap changes what
  the next replay computes without a new capture.
- **One lock a network.** ``net._infer_lock`` is held from the copy into a
  graph's static inputs to the host copy of its output: the graphs of one
  network share their pool and their inputs, and a service replays them
  from several threads.
- **Fused argmax.** ``predict()`` computes the argmax inside the graph;
  only int32 indices come to the host.
- **The padding cut off.** The real rows (and steps) are cut from the
  output before its copy to the host, a view, not a program per size.

Results are host ``np.ndarray``s (bf16 as float32, which holds it
exactly).
"""

from __future__ import annotations

import os
import time
import weakref
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import ops
from ..datasets.bucketing import _padded_mask
from ..telemetry.tracing import current_trace, record_trace_event
from .compile_manager import get_compile_manager, next_pow2, signature

__all__ = [
    "INFER_ENV",
    "ServedGraph",
    "canonicalize_input",
    "fast_path_enabled",
    "graph_output",
    "graph_rnn_step",
    "mln_output",
    "mln_rnn_step",
]

# env knob: "legacy" (or "0"/"off") restores the eager, shape-exact dispatch
INFER_ENV = "DL4JTPU_INFER"

# eager runs of a bucket's forward on a side stream before its capture
INFER_WARMUP = 1


def fast_path_enabled() -> bool:
    return os.environ.get(INFER_ENV, "").lower() not in ("legacy", "0", "off")


def canonicalize_input(x, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A request as a tensor where it lies (arrays and host tensors on the
    host, card tensors on the card): floating values in ``dtype``, the
    network's compute dtype (f64, f16 and numpy bf16 requests included),
    integer ids as they are."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
    else:
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":  # numpy's bf16 has no torch view
            a = a.astype(np.float32)
        t = torch.from_numpy(np.ascontiguousarray(a))
    if t.is_floating_point() and t.dtype != dtype:
        t = t.to(dtype)
    return t


def _request(net, x) -> torch.Tensor:
    """A request as it crosses to the network: a card tensor in the compute
    dtype; a host request in the compute dtype for a network on the CPU,
    float32 for one on the card, where the card rounds it to bf16 after the
    copy (torch's host cast of a 128-image batch to bf16 took longer than
    the copy of the bytes it saves: ``PERF.md``)."""
    on_card = isinstance(x, torch.Tensor) and x.device.type == "cuda"
    wire = torch.float32 if net.device.type == "cuda" and not on_card else net.compute_dtype
    return canonicalize_input(x, wire)


def _bucket_plan(b: int, t: Optional[int], pad_rows: bool,
                 pad_time: bool = True) -> Tuple[int, Optional[int]]:
    """(target_b, target_t) power-of-two buckets for one request shape."""
    target_b = next_pow2(b) if pad_rows else b
    target_t = next_pow2(t) if t is not None and pad_time else t
    return target_b, target_t


def _unwrapped(obj) -> list:
    """A layer without its FrozenLayer wrapper, or a preprocessor with a
    ComposableInputPreProcessor's children, as a list."""
    children = getattr(obj, "children", None)
    if isinstance(children, list):
        return [c for child in children for c in _unwrapped(child)]
    inner = getattr(obj, "layer", None)
    return [obj] if inner is None else _unwrapped(inner)


def _pads(net) -> Tuple[bool, bool]:
    """(pad rows, pad time) for a network's requests, each only where it
    leaves every real row and step as the eager forward computes it:

    - rows where ``_pad_examples_ok`` allows it (no BatchNormalization);
    - neither where a preprocessor folds time into rows or rows into time
      (padding would put padded rows or steps inside real examples) or a
      MixtureOfExperts layer sits (its expert capacity counts every token
      of the batch, padded ones too, so padding changes which real tokens
      an expert drops);
    - no time where a layer mixes neighbouring steps without the mask
      (Convolution1D, ZeroPadding, Subsampling): the last real steps would
      read the padded steps (a masked LSTM holds h there) where the eager
      forward reads zeros."""
    from ..nn.conf import preprocessors as pre
    from ..nn.layers.convolution import Convolution1DLayer, ZeroPaddingLayer
    from ..nn.layers.moe import MixtureOfExpertsLayer
    from ..nn.layers.pooling import SubsamplingLayer

    if net._served_pads is not None:
        return net._served_pads
    conf = net.conf
    if hasattr(conf, "layers"):
        parts = list(conf.layers) + list(conf.preprocessors.values())
    else:
        parts = [getattr(v, k, None) for v in conf.vertices.values()
                 for k in ("layer", "preprocessor")]
    parts = [p for part in parts if part is not None for p in _unwrapped(part)]
    folds = (pre.RnnToFeedForwardPreProcessor, pre.FeedForwardToRnnPreProcessor,
             pre.RnnToCnnPreProcessor, MixtureOfExpertsLayer)
    mixes = (Convolution1DLayer, ZeroPaddingLayer, SubsamplingLayer)
    if any(isinstance(p, folds) for p in parts):
        pads = (False, False)
    else:
        pads = (net._pad_examples_ok(), not any(isinstance(p, mixes) for p in parts))
    net._served_pads = pads
    return pads


def _slice_output(out, b: int, t: Optional[int], target_t: Optional[int],
                  argmax: bool = False):
    """Cut the padding off one output: rows always, time only where the
    output's time axis is the padded bucket (a pooled [B, C] output has
    none). The argmax drops the class axis, so its time-preserving shape is
    [B, T]."""
    res = out[:b]
    time_ndim = 2 if argmax else 3
    if (t is not None and target_t is not None and t != target_t
            and res.ndim == time_ndim and res.shape[1] == target_t):
        res = res[:, :t]
    return res


def _host(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().cpu().numpy()


def _mask_for(mask, b: int, t: Optional[int], target_b: int, target_t: Optional[int],
              dtype: torch.dtype = torch.float32) -> Optional[torch.Tensor]:
    """The padded features mask of a request, a host tensor in ``dtype``: the
    caller's, extended with zeros (a [B, T] mask of integer ids [B, T], or a
    per-example [B] mask, over the padded rows alone), or ones over the real
    steps where only the time axis is padded; None for a request with no
    mask and no time padding."""
    if mask is None:
        if t is None or t == target_t:
            return None
    else:
        mask = canonicalize_input(mask).float().cpu().numpy()
        if t is None and mask.ndim == 2:  # [B, T] integer ids: rows alone are padded
            t = target_t = mask.shape[1]
    return torch.from_numpy(_padded_mask(mask, b, t, target_b, target_t)).to(dtype)


def _padded_shape(x: torch.Tensor, target_b: int, target_t: Optional[int]) -> tuple:
    shape = (target_b,) + tuple(x.shape[1:])
    if target_t is not None and x.ndim == 3:
        shape = (shape[0], target_t) + shape[2:]
    return shape


def _leaf_tensors(tree) -> list:
    """The tensors of nested dicts, lists and tuples, in order (dicts by
    sorted key)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaf_tensors(tree[k])]
    return [t for part in tree for t in _leaf_tensors(part)]


def _load(dst: torch.Tensor, src) -> None:
    """Copy a request (a tensor on the host or the card, ``_request``; or a
    host array) into the leading region of a static input and zero the rest
    (the padded rows and steps)."""
    if not isinstance(src, torch.Tensor):
        src = torch.from_numpy(np.ascontiguousarray(src))
    if src.dtype != dst.dtype and src.device != dst.device:
        # cast on the static input's device: a copy that changes the dtype
        # on the way casts on the host first, element by element
        src = src.to(dst.device)
    if tuple(src.shape) == tuple(dst.shape):
        dst.copy_(src)
        return
    dst[tuple(slice(0, n) for n in src.shape)].copy_(src)
    b = src.shape[0]
    if b < dst.shape[0]:
        dst[b:].zero_()
    if src.dim() >= 2 and src.shape[1] < dst.shape[1]:
        dst[:b, src.shape[1]:].zero_()


class ServedGraph:
    """One bucket of one network's served forward: the static inputs (None
    for an absent mask), the outputs, the tensors the forward reads or
    writes (``keep``: params, served state, streaming state, which live as
    long as the graph), and on the card the graph, its pool, the kernel
    launches its capture counted (those of one replay) and its replays. On
    the CPU ``run`` is the eager forward, called on every request."""

    def __init__(self, kind: str, inputs: list, run, keep: tuple, writes: list):
        self.kind = kind
        self.inputs = inputs
        self.run = run
        self.keep = keep
        self.writes = writes  # tensors the forward writes (streaming state)
        self.outputs: Optional[list] = None
        self.graph = None
        self.pool = None
        self.launches: dict = {}
        self.replays = 0

    def load(self, arrays) -> None:
        for dst, src in zip(self.inputs, arrays):
            if dst is not None:
                _load(dst, src)

    def execute(self) -> list:
        """Run the bucket on its static inputs: replay the graph, or (on the
        CPU) run the forward."""
        if self.graph is not None:
            self.graph.replay()
            self.replays += 1
            return self.outputs
        self.outputs = self.run(self.inputs)
        return self.outputs

    def capture(self, device, pool) -> None:
        """Capture the forward in a CUDA graph: one eager warm-up run on a
        side stream (the streaming state it advances is put back), then the
        capture into ``pool`` (None: a new pool). Raises if the capture
        fails."""
        saved = [t.clone() for t in self.writes]
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(INFER_WARMUP):
                self.run(self.inputs)
        current.wait_stream(side)
        for t, v in zip(self.writes, saved):
            t.copy_(v)
        graph = torch.cuda.CUDAGraph()
        before = ops.counters()
        with torch.cuda.graph(graph, pool=pool):
            self.outputs = self.run(self.inputs)
        self.launches = {k: n - before[k] for k, n in ops.counters().items() if n != before[k]}
        self.graph = graph
        self.pool = graph.pool() if pool is None else pool
        self.run = None  # the graph holds the work; no reference to the network


def _static(net, spec) -> Optional[torch.Tensor]:
    """A zero static input of ``spec`` = (shape, dtype), None for an absent
    mask."""
    if spec is None:
        return None
    shape, dtype = spec
    return torch.zeros(shape, dtype=dtype, device=net.device)


def _dispatch(net, key, specs: list, arrays: list, forward, fetch, stream_batch=None,
              adopt: bool = True):
    """One request through its bucket, under the network's lock: the entry
    for ``key`` from the compile manager (on a miss its zero static inputs
    of ``specs`` are made and, on the card, the graph is captured on them,
    which the manager times as the entry's compile), ``arrays`` loaded into
    it, one run (a replay on the card), and ``fetch(outputs)`` (the host
    copies) before the lock is let go: the network's graphs share their
    pool. ``forward(net, inputs, params, state, stream)`` is the bucket's
    forward, returning (outputs, new streaming state or None); with
    ``stream_batch`` it runs on the streaming buffers of that many rows
    (``stream_buffers``), which it updates in place."""
    with torch.no_grad(), net._infer_lock:
        params, state = net._params(), net._served_state()
        bufs = None if stream_batch is None else stream_buffers(net, stream_batch, adopt)
        writes = _leaf_tensors(bufs)
        ref = weakref.ref(net)

        def run(inputs):
            outs, new = forward(ref(), inputs, params, state, bufs)
            for dst, src in zip(writes, _leaf_tensors(new)):
                dst.copy_(src)
            return outs

        def build() -> ServedGraph:
            entry = ServedGraph(key[1], [_static(net, s) for s in specs], run,
                                (params, state, bufs), writes)
            if net.device.type == "cuda":
                entry.capture(net.device, net._infer_pool)
                if net._infer_pool is None:
                    net._infer_pool = entry.pool
            return entry

        entry = get_compile_manager().admit(key, build)
        entry.load(arrays)
        return fetch(entry.execute())


def _traced(kind: str, rows: Optional[int], bucket_rows: Optional[int], fn):
    """Run ``fn`` recording an ``infer.dispatch`` span when the thread
    carries a sampled trace (the batcher installs its batch's context):
    the span says whether this request captured (``compiles``) or hit the
    cache, the proof that warm traffic makes no capture."""
    ctx = current_trace()
    if ctx is None or not ctx.sampled:
        return fn()
    cm = get_compile_manager()
    t0, ts_us = time.perf_counter(), time.time() * 1e6
    c0, h0 = cm.compiles.value, cm.cache_hits.value
    try:
        out = fn()
    except Exception as e:
        record_trace_event(ctx.child(), "infer.dispatch", duration_s=time.perf_counter() - t0,
                           ts_us=ts_us, kind=kind, error=f"{type(e).__name__}: {e}"[:200])
        raise
    record_trace_event(
        ctx.child(), "infer.dispatch", duration_s=time.perf_counter() - t0, ts_us=ts_us,
        kind=kind, rows=None if rows is None else int(rows),
        bucket_rows=None if bucket_rows is None else int(bucket_rows),
        compiles=int(cm.compiles.value - c0), cache_hit=bool(cm.cache_hits.value - h0 > 0))
    return out


# ------------------------------------------------------------ MultiLayer
def mln_output(net, x, features_mask=None, argmax: bool = False) -> np.ndarray:
    """Bucketed forward of a :class:`MultiLayerNetwork`; with ``argmax`` the
    graph returns int32 class indices."""
    net.init()
    x = _request(net, x)
    b = int(x.shape[0])
    t = int(x.shape[1]) if x.ndim == 3 else None
    target_b, target_t = _bucket_plan(b, t, *_pads(net))
    fm = _mask_for(features_mask, b, t, target_b, target_t, net.compute_dtype)
    specs = _specs(net, [x], [target_b], [target_t], [fm])
    key = (net._cm_token, "mln_infer", signature(bool(argmax), specs))

    def forward(n, inputs, params, state, _):
        out = n._forward(params, inputs[0], state, inputs[1])[0]
        return [torch.argmax(out, dim=-1).to(torch.int32) if argmax else out], None

    return _traced("mln_infer", b, target_b, lambda: _dispatch(
        net, key, specs, [x, fm], forward,
        lambda outs: _host(_slice_output(outs[0], b, t, target_t, argmax=argmax))))


def stream_buffers(net, batch: int, adopt: bool = True):
    """The network's streaming-state buffers for ``batch`` rows, which the
    graphs of ``rnn_time_step`` read and update in place, made ready for the
    next step: zeroed when the stream was cleared or last ran at another
    batch size; when ``adopt``, a state bound by other code (the legacy
    path, a caller) is copied in; else the buffers go on as they are."""
    bufs = net._infer_rnn.get(batch)
    if bufs is None:
        bufs = net._infer_rnn[batch] = net._init_rnn_states(batch)
    cur = net._rnn_state
    if cur is bufs:
        return bufs
    mine = _leaf_tensors(bufs)
    theirs = _leaf_tensors(cur)
    with torch.no_grad():
        if cur is not None and adopt and len(theirs) == len(mine) and all(
                a.shape == b.shape for a, b in zip(theirs, mine)):
            for dst, src in zip(mine, theirs):
                dst.copy_(src)
        elif cur is None or not theirs or theirs[0].shape[0] != batch:
            for t in mine:
                t.zero_()
    net._rnn_state = bufs
    return bufs


def mln_rnn_step(net, x, features_mask=None, adopt: bool = True) -> np.ndarray:
    """Streaming step of a :class:`MultiLayerNetwork`: the time axis in a
    power-of-two bucket with the mask extended (the padded steps hold h/c,
    so the state after the call is the state after the real steps), the
    streaming state in the network's buffers for this batch size, updated
    in place by the graph. ``adopt`` as in :func:`stream_buffers`."""
    net.init()
    x = _request(net, x)
    single_step = x.ndim == 2
    if single_step:
        x = x[:, None, :]
    b, t = int(x.shape[0]), int(x.shape[1])
    target_t = _bucket_plan(b, t, False, _pads(net)[1])[1]
    fm = _mask_for(features_mask, b, t, b, target_t, net.compute_dtype)
    specs = _specs(net, [x], [b], [target_t], [fm])
    key = (net._cm_token, "mln_rnn_step", signature(specs))

    def forward(n, inputs, params, state, stream):
        out, _, new = n._forward(params, inputs[0], state, inputs[1], stream)
        return [out], new

    def fetch(outs):
        res = _slice_output(outs[0], b, t, target_t)
        return _host(res[:, 0, :] if single_step and res.ndim == 3 else res)

    return _traced("mln_rnn_step", b, None, lambda: _dispatch(
        net, key, specs, [x, fm], forward, fetch, stream_batch=b, adopt=adopt))


# ------------------------------------------------------- ComputationGraph
def _graph_masks_list(net, masks, name: str = "masks") -> List[Optional[np.ndarray]]:
    """The graph mask argument ``name`` (None, a dict by input name, a list
    aligned with ``conf.network_inputs``, or one bare mask for a
    single-input graph) as a list aligned with the inputs."""
    names = net.conf.network_inputs
    if masks is None:
        return [None] * len(names)
    if isinstance(masks, dict):
        return [None if masks.get(n) is None else masks[n] for n in names]
    if not isinstance(masks, (list, tuple)):
        masks = [masks]
    masks = list(masks)
    if len(masks) != len(names):
        raise ValueError(f"{name} has {len(masks)} entries but the graph has "
                         f"{len(names)} inputs ({names})")
    return masks


def _graph_plan(net, xs, mask_list, pad_rows: bool, pad_time: bool):
    """The shared row bucket and every input's time bucket and padded mask;
    returns (b, target_b, [(t, target_t)] per input, masks)."""
    b = int(xs[0].shape[0])
    if any(int(x.shape[0]) != b for x in xs):
        raise ValueError("graph inputs disagree on batch size")
    target_b = _bucket_plan(b, None, pad_rows)[0]
    times = [_time_plan(x, pad_time) for x in xs]
    masks = [_mask_for(m, b, t, target_b, tt, net.compute_dtype)
             for m, (t, tt) in zip(mask_list, times)]
    return b, target_b, times, masks


def _time_plan(x: torch.Tensor, pad_time: bool = True):
    t = int(x.shape[1]) if x.ndim == 3 else None
    return t, _bucket_plan(1, t, False, pad_time)[1]


def _specs(net, xs, target_bs, target_ts, masks) -> list:
    """The static inputs' (shape, dtype): each input padded (floating ones
    in the compute dtype), then each mask (None where absent)."""
    return ([(_padded_shape(x, tb, tt), net.compute_dtype if x.is_floating_point() else x.dtype)
             for x, tb, tt in zip(xs, target_bs, target_ts)]
            + [None if m is None else (m.shape, m.dtype) for m in masks])


def _graph_forward(net, inputs, params, state, stream):
    """The graph's forward on static inputs (inputs, then a mask per
    input): the network outputs' activations and the new streaming state."""
    n_in = len(net.conf.network_inputs)
    ins, mk = inputs[:n_in], inputs[n_in:]
    masks = None if all(m is None for m in mk) else dict(zip(net.conf.network_inputs, mk))
    acts, _, new = net._activations(params, ins, masks, state=state, rnn_state=stream)
    return [acts[o] for o in net.conf.network_outputs], new


def graph_output(net, inputs, masks=None, argmax: bool = False) -> list:
    """Bucketed forward of a :class:`ComputationGraph`; returns a list of
    host arrays aligned with ``conf.network_outputs``."""
    net.init()
    xs = [_request(net, x) for x in inputs]
    b, target_b, times, fms = _graph_plan(net, xs, _graph_masks_list(net, masks), *_pads(net))
    specs = _specs(net, xs, [target_b] * len(xs), [tt for _, tt in times], fms)
    key = (net._cm_token, "graph_infer", signature(bool(argmax), specs))

    def forward(n, inputs, params, state, stream):
        outs, _ = _graph_forward(n, inputs, params, state, stream)
        return [torch.argmax(o, dim=-1).to(torch.int32) for o in outs] if argmax else outs, None

    t0, tt0 = times[0]
    return _traced("graph_infer", b, target_b, lambda: _dispatch(
        net, key, specs, xs + fms, forward,
        lambda outs: [_host(_slice_output(o, b, t0, tt0, argmax=argmax)) for o in outs]))


def graph_rnn_step(net, inputs, features_masks=None, adopt: bool = True) -> list:
    """Streaming step of a :class:`ComputationGraph` (see
    :func:`mln_rnn_step`); returns a list of host arrays."""
    net.init()
    xs = [_request(net, x) for x in inputs]
    single_step = all(x.ndim == 2 for x in xs)
    if single_step:
        xs = [x[:, None, :] for x in xs]
    mask_list = _graph_masks_list(net, features_masks, "features_masks")
    b, _, times, fms = _graph_plan(net, xs, mask_list, False, _pads(net)[1])
    specs = _specs(net, xs, [b] * len(xs), [tt for _, tt in times], fms)
    key = (net._cm_token, "graph_rnn_step", signature(specs))
    t0, tt0 = times[0]

    def fetch(outs):
        res = [_slice_output(o, b, t0, tt0) for o in outs]
        return [_host(o[:, 0, :] if single_step and o.ndim == 3 else o) for o in res]

    return _traced("graph_rnn_step", b, None, lambda: _dispatch(
        net, key, specs, xs + fms, _graph_forward, fetch, stream_batch=b, adopt=adopt))


def served_graphs(net) -> List[ServedGraph]:
    """The live served graphs of ``net`` (its current token's entries)."""
    return [v for _, v in get_compile_manager().owned(net._cm_token)
            if isinstance(v, ServedGraph)]
