"""ComputationGraph (counterpart of
``deeplearning4j_tpu/nn/graph/computation_graph.py``): a DAG network,
served and trained.

The network is an ``nn.Module`` holding one ``nn.ParameterDict`` per vertex
on an explicit device, sharing ``MultiLayerNetwork``'s helpers
(``BaseNetwork``): the card unless the caller passes ``device="cpu"``, the
compute and param dtypes, the listeners, the updater and its state.

- The forward runs the vertices in ``conf.topological_order()``; the
  initial params are drawn in that order from one generator seeded by
  ``conf.seed``. A graph with a single features mask hands it to every
  layer (the JAX package's one-mask convenience); ``LastTimeStepVertex``
  reads its network input's own mask.
- The params are held, updated and saved as the JAX package's params dict
  keyed by vertex name is, in ``jax.tree_util.tree_leaves`` order: sorted
  vertex name, then sorted param key. Vertices without params add no
  leaves.
- The training loss sums every network output's ``compute_loss`` (each an
  output layer) over f32 inputs and f32 params, plus every vertex's
  regularization; one update per batch.
- ``output`` and ``predict`` take one array per network input and return
  host arrays: one for a single-output graph, else a list.
- ``state`` is the layer state, a dict of vertex name to dict ({} but for
  BatchNormalization's running mean and variance), f32 on the device,
  threaded through the topological loop: ``fit`` stores what the training
  forward returns after each update, serving, ``evaluate`` and ``score``
  read it. Its leaves (``state_leaves``) are in sorted vertex name, then
  key order, "mean" before "var", as the JAX package saves them.

- ``fit`` prefetches as ``MultiLayerNetwork.fit`` does, and
  ``fit(stage_on_device=K)``, ``fit_on_device`` and ``warmup`` are its
  staged loop (one captured step replayed per update on the card), with one
  array per network input and output, and masks per input and output.

- Recurrent use: ``fit`` under ``backprop_type="tbptt"`` (one update per
  time segment, h/c carried across segments with their gradient cut) and
  the streaming ``rnn_time_step``, ``rnn_clear_previous_state`` and
  ``rnn_get_previous_state``; h/c live in a dict by vertex name ({} for a
  vertex without them). ``fit`` leaves the streaming state as it was.

- Telemetry (``set_telemetry``), the listeners' gradient view
  (``needs_gradients``), ``memory_report`` and ``preflight`` are
  ``MultiLayerNetwork``'s (``BaseNetwork``). ``analyze_ir`` is not ported
  yet (ROADMAP.md Queue 1) and raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ...datasets.iterators import MultiDataSet, as_iterator, as_multi
from ...eval.evaluation import Evaluation
from ...runtime import inference as _inf
from ..conf.computation_graph import ComputationGraphConfiguration
from ..layers.normalization import BatchNormalization
from ..multilayer import (BaseNetwork, _materialize, _real_batches, _staged_dim0,
                          _summary_table, to_host)
from .vertices import LayerVertex

# losses whose heads ``evaluate`` scores as classifiers
_CLASS_LOSSES = ("mcxent", "negativeloglikelihood", "xent", "binary_xent")


def _later(what: str):
    def method(self, *args, **kwargs):
        raise NotImplementedError(
            f"ComputationGraph.{what} is not ported yet (ROADMAP.md Queue 1)")
    method.__name__ = what
    return method


class ComputationGraph(BaseNetwork):
    """DAG network over a :class:`ComputationGraphConfiguration`."""

    _flight_name = "graph"  # the staged window's flight-recorder event names it

    def __init__(self, conf: ComputationGraphConfiguration, device="cuda"):
        super().__init__(conf, device)
        self._topo = conf.topological_order()
        self._names = sorted(conf.vertices)  # the leaf order
        self.vertex_params: Dict[str, torch.nn.ParameterDict] = {}
        self._param_modules = torch.nn.ModuleList()  # the same, registered
        self._rnn_state = None  # streaming state: vertex name -> h/c ({} if none)

    # ------------------------------------------------------------------ init
    def init(self, params: Optional[Dict[str, dict]] = None, force: bool = False,
             generator: Optional[torch.Generator] = None) -> "ComputationGraph":
        """Create the params: from ``params`` (vertex name -> dict of arrays;
        a vertex without params may be left out), else drawn vertex by
        vertex in topological order from ``generator`` (default: seeded by
        ``conf.seed``). Resets the layer state, the updater state and the
        iteration count."""
        if self._initialized and not force and params is None:
            return self
        vit = self.conf.vertex_input_types()
        if params is None:
            gen = generator if generator is not None else torch.Generator().manual_seed(
                self.conf.seed)
            params = {name: self.conf.vertices[name].init_params(gen, *vit[name])
                      for name in self._topo}
        unknown = sorted(set(params) - set(self.conf.vertices))
        if unknown:
            raise ValueError(f"params for vertices the graph does not have: {unknown}")
        self.vertex_params = {name: self._param_dict(params.get(name, {}))
                              for name in self._topo}
        self._param_modules = torch.nn.ModuleList(self.vertex_params[n] for n in self._names)
        self.state = {name: self._device_state(self.conf.vertices[name].init_state(*vit[name]))
                      for name in self._topo}
        self._rnn_state = None
        self._reset()
        return self

    def _twin(self) -> "ComputationGraph":
        return ComputationGraph(ComputationGraphConfiguration.from_dict(self.conf.to_dict()),
                                device=self.device)

    def _leaves(self) -> List[dict]:
        """The trainable params, one dict per vertex by sorted vertex name."""
        return [dict(self.vertex_params[n].items()) for n in self._names]

    def _params_from_leaves(self, dicts: List[dict]) -> Dict[str, dict]:
        return dict(zip(self._names, dicts))

    def _state_dicts(self) -> List[dict]:
        return [self.state[n] for n in self._names]

    def _set_state_dicts(self, dicts: List[dict]) -> None:
        self.state = dict(zip(self._names, dicts))

    def _cast_params(self) -> Dict[str, dict]:
        """Params in the compute dtype, as casts of the leaves that autograd
        follows (the leaf itself where the dtypes agree)."""
        dt = self.compute_dtype
        return {name: {k: v.to(dt) for k, v in p.items()}
                for name, p in self.vertex_params.items()}

    def _params(self) -> Dict[str, dict]:
        """Params in the compute dtype for inference: cast once, and again
        after every update, into the same buffers (``_fill_param_buffers``)."""
        if self._compute_params is None:
            with torch.no_grad():
                self._compute_params = self._fill_param_buffers(
                    {name: {k: v.detach() for k, v in p.items()}
                     for name, p in self._cast_params().items()})
        return self._compute_params

    def _state_layout(self, dicts: List[dict]):
        return dict(zip(self._names, dicts))

    def _swap_leaves(self, tree) -> List[dict]:
        if isinstance(tree, dict):
            return [tree.get(n, {}) for n in self._names]
        return list(tree)

    def _masks(self, masks) -> Optional[Dict[str, Optional[torch.Tensor]]]:
        """Network-input name -> features mask on the device."""
        if not masks:
            return None
        return {name: self._mask(m) for name, m in masks.items()}

    def _input_masks(self, mds: MultiDataSet):
        if mds.features_masks is None or all(m is None for m in mds.features_masks):
            return None
        return self._masks(dict(zip(self.conf.network_inputs, mds.features_masks)))

    def _labels_masks(self, mds: MultiDataSet):
        if mds.labels_masks is None or all(m is None for m in mds.labels_masks):
            return None
        return [self._labels_mask(m) for m in mds.labels_masks]

    # ------------------------------------------------------- functional core
    def _activations(self, params, inputs, masks=None, *, train: bool = False,
                     skip=(), rnn_state=None, state=None):
        """The topological forward (reference: ComputationGraph's
        feed-forward loop): every vertex's activation but those in
        ``skip``, the new layer state, from ``self.state``, and the new
        recurrent state. ``inputs`` align with ``conf.network_inputs``;
        ``masks`` maps network-input names to [b, t] masks. ``train`` turns
        dropout on and has the layers train (BatchNormalization on batch
        stats). ``rnn_state`` (vertex name -> h/c dict, {} for a stateless
        vertex; reference: rnnActivateUsingStoredState) threads LSTM h/c
        across TBPTT segments and streaming calls: a vertex with h/c runs
        ``apply_seq`` from it. Returns (acts, new layer state, new recurrent
        state or None). ``state`` stands in for ``self.state`` (the memory
        report's meta tensors)."""
        conf = self.conf
        state = self.state if state is None else state
        acts = dict(zip(conf.network_inputs, inputs))
        vmasks = dict(masks or {})
        # the one-mask convenience: a single mask reaches every layer
        non_null = [m for m in vmasks.values() if m is not None]
        vmasks["features"] = non_null[0] if len(non_null) == 1 else None
        gen = self._generator if train else None
        new_state = dict(state)
        new_rnn = dict(rnn_state) if rnn_state is not None else None
        for name in self._topo:
            if name in skip:
                continue
            vertex, ins = conf.vertices[name], [acts[src] for src in conf.vertex_inputs[name]]
            if new_rnn is not None and new_rnn.get(name):
                acts[name], new_rnn[name] = vertex.apply_seq(
                    params[name], ins, new_rnn[name], train=train, generator=gen, masks=vmasks)
            else:
                acts[name], new_state[name] = vertex.apply(
                    params[name], ins, state[name], train=train, generator=gen,
                    masks=vmasks)
        return acts, new_state, new_rnn

    def _loss(self, inputs, labels, labels_masks=None, masks=None, train: bool = True,
              rnn_state=None):
        """The sum of the output layers' losses plus regularization
        (reference: ComputationGraph.computeGradientAndScore), the new
        layer state and the new recurrent state (see ``_activations``). The
        vertices run in the compute dtype; each output layer takes f32
        inputs and f32 params, as the JAX package upcasts bf16 there. An
        output layer that no vertex reads is not run forward: its loss
        takes its input."""
        conf = self.conf
        outs = conf.network_outputs
        for name in outs:
            vertex = conf.vertices[name]
            if not (isinstance(vertex, LayerVertex) and vertex.is_output_layer):
                raise ValueError(f"Training output '{name}' is not an output layer vertex")
        acts, new_state, new_rnn = self._activations(
            self._cast_params(), inputs, masks, train=train, skip=self._unread_outputs(),
            rnn_state=rnn_state)
        gen = self._generator if train else None
        total = 0.0
        for i, name in enumerate(outs):
            vertex = conf.vertices[name]
            h = vertex.layer_input([acts[src] for src in conf.vertex_inputs[name]])
            h32 = h.float() if h.dtype == torch.bfloat16 else h
            p = {k: v.float() if v.dtype == torch.bfloat16 else v
                 for k, v in self.vertex_params[name].items()}
            lm = labels_masks[i] if labels_masks is not None else None
            total = total + vertex.layer.compute_loss(p, h32, labels[i], lm, train=train,
                                                      generator=gen)
        reg = sum(conf.vertices[n].regularization_loss(dict(self.vertex_params[n].items()))
                  for n in self._topo)
        return total + reg, new_state, new_rnn

    def _unread_outputs(self) -> set:
        """The output layers that no vertex reads (their loss takes their
        input; a forward for the loss skips them)."""
        read = {src for ins in self.conf.vertex_inputs.values() for src in ins}
        return set(self.conf.network_outputs) - read

    def loss_fn(self, inputs, labels, *, train: bool = False, labels_masks=None,
                masks=None) -> torch.Tensor:
        """Scalar loss of the current params, differentiable: one array per
        network input and output, masks as ``fit`` takes them."""
        self.init()
        lms = None if labels_masks is None else [self._labels_mask(m) for m in labels_masks]
        return self._loss([self._input(x) for x in inputs], [self._labels(y) for y in labels],
                          lms, self._masks(masks), train=train)[0]

    @torch.no_grad()
    def forward(self, *inputs, masks=None) -> List[torch.Tensor]:
        """Device-side inference: one tensor per network output."""
        self.init()
        acts, _, _ = self._activations(self._params(), [self._input(x) for x in inputs],
                                       self._masks(masks))
        return [acts[o] for o in self.conf.network_outputs]

    # -------------------------------------------------------------- inference
    @staticmethod
    def _as_inputs(inputs):
        if len(inputs) == 1 and isinstance(inputs[0], (list, tuple)):
            return tuple(inputs[0])
        return inputs

    def output(self, *inputs, masks=None):
        """Output activations as host arrays (reference:
        ComputationGraph.output): one array for a single-output graph, else
        a list. ``inputs``: one array per network input (or one list of
        them); ``masks``: network-input name -> features mask (or a list
        aligned with the inputs). Through the bucketed path of
        ``runtime.inference`` (each bucket a CUDA graph replayed on the
        card); ``DL4JTPU_INFER=legacy`` runs the vertices eagerly at the
        request's exact shape."""
        if _inf.fast_path_enabled():
            outs = _inf.graph_output(self, self._as_inputs(inputs), masks)
        else:
            outs = [to_host(o) for o in self.forward(*self._as_inputs(inputs),
                                                     masks=self._mask_dict(masks))]
        return outs[0] if len(outs) == 1 else outs

    def predict(self, *inputs, masks=None):
        """Class indices (argmax over the last axis) per output as int32:
        one array for a single-output graph, else a list. On the bucketed
        path the argmax runs inside the graph."""
        if _inf.fast_path_enabled():
            outs = _inf.graph_output(self, self._as_inputs(inputs), masks, argmax=True)
        else:
            outs = [to_host(torch.argmax(o, dim=-1).to(torch.int32))
                    for o in self.forward(*self._as_inputs(inputs),
                                          masks=self._mask_dict(masks))]
        return outs[0] if len(outs) == 1 else outs

    def _mask_dict(self, masks):
        """A masks argument (dict, list aligned with the inputs, one bare
        mask) as the dict by input name ``forward`` takes."""
        if masks is None or isinstance(masks, dict):
            return masks
        return dict(zip(self.conf.network_inputs, _inf._graph_masks_list(self, masks)))

    def score(self, dataset=None) -> float:
        """Loss on a dataset (inference mode: no dropout), or the last
        training loss."""
        if dataset is None:
            return float(self._last_loss) if self._last_loss is not None else float("nan")
        mds = as_multi(dataset)
        with torch.no_grad():
            self.init()
            return float(self._loss([self._input(x) for x in mds.features],
                                    [self._labels(y) for y in mds.labels],
                                    self._labels_masks(mds), self._input_masks(mds),
                                    train=False)[0])

    def evaluate(self, data, top_n: int = 1):
        """Classification evaluation of ``output`` over ``data`` (reference:
        ComputationGraph.evaluate). A single-output graph returns one
        :class:`Evaluation`; otherwise ``{output name: Evaluation}`` over
        the classification heads (mcxent, negativeloglikelihood, xent,
        binary_xent losses). As in the JAX package, labels masks are not
        applied, and a batch's ``example_metadata`` goes to each head's
        ``Evaluation`` (its ``predictions``) unless that output is a time
        series."""
        outs = self.conf.network_outputs
        single = len(outs) == 1
        names = [n for n in outs
                 if single or getattr(getattr(self.conf.vertices[n], "layer", None), "loss",
                                      None) in _CLASS_LOSSES]
        if not names:
            losses = [getattr(getattr(self.conf.vertices[n], "layer", None), "loss", None)
                      for n in outs]
            raise ValueError(f"evaluate(): no classification output heads (losses: "
                             f"{', '.join(map(str, losses))}); use score() for regression "
                             "heads")
        idx = {n: i for i, n in enumerate(outs)}
        evs = {n: Evaluation(top_n=top_n) for n in names}
        for ds in as_iterator(data):
            mds = as_multi(ds)
            got = self.output(*mds.features, masks=self._input_masks(mds))
            got = got if isinstance(got, list) else [got]
            if len(got) != len(mds.labels):
                raise ValueError(f"{len(got)} outputs but {len(mds.labels)} label arrays")
            for n, ev in evs.items():
                # each example's provenance, where the batch carries it; a
                # time-series output flattens to B*T rows, which it no
                # longer matches
                meta = mds.example_metadata if got[idx[n]].ndim != 3 else None
                ev.eval(mds.labels[idx[n]], got[idx[n]], record_metadata=meta)
        return evs[names[0]] if single else evs

    def summary(self) -> str:
        """Vertex table in topological order: name, type, inputs, output
        type, param count (reference: ComputationGraph.summary())."""
        self.init()
        vit = self.conf.vertex_input_types()
        rows = [("vertex", "type", "inputs", "out", "params")]
        total = 0
        for name in self._topo:
            vertex = self.conf.vertices[name]
            n = sum(v.numel() for v in self.vertex_params[name].values())
            total += n
            vtype = (type(vertex.layer).__name__ if isinstance(vertex, LayerVertex)
                     else type(vertex).__name__)
            rows.append((name, vtype, ",".join(self.conf.vertex_inputs[name]),
                         str(vertex.get_output_type(*vit[name])), f"{n:,}"))
        return _summary_table(rows, total)

    # --------------------------------------------------------------- training
    def fit(self, data, epochs: int = 1, stage_on_device: Optional[int] = None,
            bucketing: bool = True) -> "ComputationGraph":
        """Train (reference: ComputationGraph.fit(MultiDataSet)).

        ``data``: a MultiDataSet, a DataSet, an (x, y) tuple, or an iterable
        of any of them (an iterator with ``reset()`` is reset before each
        epoch; one whose ``prefetch_supported`` is true is read ahead as
        ``MultiLayerNetwork.fit`` reads it). One update per batch.
        ``stage_on_device`` and ``bucketing`` as in
        ``MultiLayerNetwork.fit``."""
        self._updater_ready()
        stage = self._fit_stage(stage_on_device)
        for it, reader in self._epochs(data, epochs, stage > 1):
            if stage > 1:
                self._fit_staged_epoch(it, reader, stage, bucketing, self._normalize,
                                       lambda ds: self._fit_batch(as_multi(ds)),
                                       self._dispatch)
            else:
                for ds in it:
                    self._fit_batch(as_multi(ds))
        if self.telemetry is not None:
            self.telemetry.flush()  # a partial K-window at the end of fit
        return self

    @staticmethod
    def _normalize(ds):
        """A batch as the stager's per-position lists."""
        mds = as_multi(ds)
        n_in, n_out = len(mds.features), len(mds.labels)
        return ([np.asarray(f) for f in mds.features], [np.asarray(y) for y in mds.labels],
                list(mds.features_masks or [None] * n_in),
                list(mds.labels_masks or [None] * n_out))

    def _dispatch(self, win):
        """Queue a staged window's updates (``_start_window``)."""
        stacked = self._staged_args(win.features, win.labels, win.features_masks,
                                    win.labels_masks)
        return self._start_window(stacked, win.n_real, win.n_real)

    def _pad_examples_ok(self) -> bool:
        return not any(isinstance(getattr(v, "layer", None), BatchNormalization)
                       for v in self.conf.vertices.values())

    @staticmethod
    def _as_stage_list(value, n: int, kind: str):
        """A masks argument as a list of ``n`` (None entries allowed); a bare
        array stands for the one input or output."""
        if value is None:
            return None
        if not isinstance(value, (list, tuple)):
            value = [value]
        if len(value) != n:
            raise ValueError(f"{kind} has {len(value)} entries, expected {n}")
        return list(value)

    def _staged_args(self, features, labels, features_masks, labels_masks) -> list:
        """Checked staged arrays as device tensors: the inputs, the labels,
        then a features mask per input and a labels mask per output (None
        where absent), each [K, ...]."""
        if self.conf.backprop_type == "tbptt":
            raise ValueError("fit_on_device does not support TBPTT; use fit()")
        xs = list(features) if isinstance(features, (list, tuple)) else [features]
        ys = list(labels) if isinstance(labels, (list, tuple)) else [labels]
        n_in, n_out = len(self.conf.network_inputs), len(self.conf.network_outputs)
        fms = self._as_stage_list(features_masks, n_in, "features_masks") or [None] * n_in
        lms = self._as_stage_list(labels_masks, n_out, "labels_masks") or [None] * n_out
        num_slots = _staged_dim0(xs[0])
        for i, arr in enumerate(xs + ys):
            if _staged_dim0(arr) != num_slots:
                kind, idx = ("input", i) if i < len(xs) else ("label", i - len(xs))
                raise ValueError(f"{kind} array {idx} stages {_staged_dim0(arr)} batches, "
                                 f"expected {num_slots}")
        for masks, kind in ((fms, "features mask"), (lms, "labels mask")):
            for i, m in enumerate(masks):
                if m is not None and _staged_dim0(m) != num_slots:
                    raise ValueError(f"{kind} {i} stages {_staged_dim0(m)} batches, "
                                     f"expected {num_slots}")
        return ([self._input(x) for x in xs] + [self._labels(y) for y in ys]
                + [self._mask(m) for m in fms] + [self._labels_mask(m) for m in lms])

    def _staged_loss(self, batch: list):
        n_in, n_out = len(self.conf.network_inputs), len(self.conf.network_outputs)
        xs, ys = batch[:n_in], batch[n_in:n_in + n_out]
        fms, lms = batch[n_in + n_out:n_in + n_out + n_in], batch[n_in + n_out + n_in:]
        loss, new_state, _ = self._loss(xs, ys, None if all(m is None for m in lms) else lms,
                                        self._masks_of(fms))
        return loss, [new_state[n] for n in self._names]

    def warmup(self, features, labels, steps: Optional[int] = None, features_masks=None,
               labels_masks=None, real_batches: Optional[int] = None) -> "ComputationGraph":
        """Capture ahead (see ``MultiLayerNetwork.warmup``): one array (or
        meta tensor) per network input and output, masks per input and
        output. A matching TUNED.json entry retargets the telemetry cadence
        (``tune/store.py``)."""
        self.init()
        self._updater_ready()
        from ...tune import store as _tuned  # noqa: PLC0415

        _tuned.auto_apply(self, "warmup")

        def mat(v):
            if isinstance(v, (list, tuple)):
                return [None if a is None else _materialize(a) for a in v]
            return None if v is None else _materialize(v)

        stacked = self._staged_args(mat(features), mat(labels), mat(features_masks),
                                    mat(labels_masks))
        _real_batches(_staged_dim0(stacked[0]), steps, real_batches)
        self._step_entry(stacked)
        return self

    def fit_on_device(self, features, labels, steps: Optional[int] = None,
                      features_masks=None, labels_masks=None,
                      real_batches: Optional[int] = None) -> np.ndarray:
        """Train on batches staged on the device (see
        ``MultiLayerNetwork.fit_on_device``). ``features``/``labels``: one
        stacked array ``[K, B, ...]`` per network input and output (a bare
        array for a single input or output); ``features_masks`` and
        ``labels_masks``: one stacked mask (or None) per input and output.
        Returns the per-step losses as a host array. TBPTT raises
        ``ValueError``, and so does a staged count that differs from the
        first input's, naming the array."""
        self.init()
        self._updater_ready()
        stacked = self._staged_args(features, labels, features_masks, labels_masks)
        return self._staged_window(stacked, steps, real_batches)

    def _fit_batch(self, mds: MultiDataSet) -> None:
        self.last_batch_size = int(mds.features[0].shape[0])
        if self.conf.backprop_type == "tbptt" and any(len(f.shape) == 3
                                                      for f in mds.features):
            self._fit_tbptt(mds)
            return
        loss, self.state, _ = self._loss([self._input(x) for x in mds.features],
                                         [self._labels(y) for y in mds.labels],
                                         self._labels_masks(mds), self._input_masks(mds))
        self._update(loss)

    # ------------------------------------------------------- TBPTT (graphs)
    def _init_rnn_states(self, batch: int) -> Dict[str, dict]:
        """Vertex name -> zero h/c in the compute dtype ({} for a vertex
        without streaming state)."""
        return {name: (self.conf.vertices[name].init_recurrent_state(
                    batch, self.compute_dtype, self.device)
                       if getattr(self.conf.vertices[name], "is_recurrent", False) else {})
                for name in self._topo}

    def _fit_tbptt(self, mds: MultiDataSet) -> None:
        """Truncated BPTT over the DAG (reference: doTruncatedBPTT from
        ComputationGraph.fit): every 3-D input and label is cut into
        ``tbptt_fwd_length`` segments, one update each, a shorter trailing
        segment included; 2-D ones go whole into every segment. Each
        recurrent vertex's h/c carry from one segment to the next with their
        gradient cut, and the layer state is threaded. With
        ``tbptt_back_length`` below a segment's length, its first steps only
        advance h/c and the layer state, without gradient, and the loss
        covers the last ``tbptt_back_length`` steps. Features masks (per
        input) and labels masks (per output) are cut alongside."""
        feats = [self._input(f) for f in mds.features]
        labs = [self._labels(y) for y in mds.labels]
        n_in, n_out = len(feats), len(labs)
        fmasks = [self._mask(m) for m in (mds.features_masks or [None] * n_in)]
        lmasks = [self._labels_mask(m) for m in (mds.labels_masks or [None] * n_out)]
        seq_lens = {a.shape[1] for a in feats + labs if a.dim() == 3}
        if len(seq_lens) != 1:
            raise ValueError(
                f"TBPTT requires one shared sequence length; got {sorted(seq_lens)}")
        T, L = seq_lens.pop(), self.conf.tbptt_fwd_length
        back = int(self.conf.tbptt_back_length or 0)

        def cut(arrs, sl):
            return [a[:, sl] if a.dim() == 3 else a for a in arrs]

        def cut_masks(ms, sl):
            return [None if m is None else m[:, sl] for m in ms]

        rnn = self._init_rnn_states(feats[0].shape[0])
        for t0 in range(0, T, L):
            seg = slice(t0, t0 + min(L, T - t0))
            xs, ys = cut(feats, seg), cut(labs, seg)
            fms, lms = cut_masks(fmasks, seg), cut_masks(lmasks, seg)
            n = next(a.shape[1] for a in xs if a.dim() == 3)
            k = n if back <= 0 else min(back, n)
            if k < n:
                split = slice(None, n - k)
                with torch.no_grad():
                    _, self.state, rnn = self._activations(
                        self._cast_params(), cut(xs, split),
                        self._masks_of(cut_masks(fms, split)), train=True,
                        skip=self._unread_outputs(), rnn_state=rnn)
                rest = slice(n - k, None)
                xs, ys = cut(xs, rest), cut(ys, rest)
                fms, lms = cut_masks(fms, rest), cut_masks(lms, rest)
            loss, self.state, new_rnn = self._loss(
                xs, ys, None if all(m is None for m in lms) else lms, self._masks_of(fms),
                rnn_state=rnn)
            self._update(loss, tbptt=True)
            rnn = {name: {key: t.detach() for key, t in st.items()}
                   for name, st in new_rnn.items()}

    def _masks_of(self, fms) -> Optional[Dict[str, Optional[torch.Tensor]]]:
        """Device features masks, one per network input, as ``_activations``
        takes them (None where every one is None)."""
        if all(m is None for m in fms):
            return None
        return dict(zip(self.conf.network_inputs, fms))

    # ------------------------------------------------------------- streaming
    @torch.no_grad()
    def rnn_time_step(self, *inputs, features_masks=None):
        """Stateful streaming inference (reference:
        ComputationGraph.rnnTimeStep): one array per network input (or one
        list of them), each [batch, features] (one step) or [batch, time,
        features]. The recurrent vertices' h/c persist across calls until
        :meth:`rnn_clear_previous_state`; a new batch size starts them from
        zeros. ``features_masks``: one [batch, time] mask, a list aligned
        with ``conf.network_inputs``, or a dict by input name; masked steps
        hold h/c. Returns host arrays, one for a single-output graph, else
        a list. On the bucketed path the time axes pad to powers of two with
        the masks extended, and h/c live in the network's streaming buffers
        for the batch size, updated in place by the replayed graph;
        ``DL4JTPU_INFER=legacy`` steps eagerly at the exact shape."""
        if _inf.fast_path_enabled():
            outs = _inf.graph_rnn_step(self, self._as_inputs(inputs), features_masks)
            return outs[0] if len(outs) == 1 else outs
        self.init()
        xs = [self._input(x) for x in self._as_inputs(inputs)]
        single_step = all(x.dim() == 2 for x in xs)
        if single_step:
            xs = [x[:, None, :] for x in xs]
        if features_masks is not None and not isinstance(features_masks, (list, tuple, dict)):
            features_masks = [features_masks]
        if isinstance(features_masks, (list, tuple)):
            if len(features_masks) != len(self.conf.network_inputs):
                raise ValueError(
                    f"features_masks has {len(features_masks)} entries but the graph has "
                    f"{len(self.conf.network_inputs)} inputs ({self.conf.network_inputs})")
            features_masks = dict(zip(self.conf.network_inputs, features_masks))
        batch = xs[0].shape[0]
        leaves = [t for st in (self._rnn_state or {}).values() for t in st.values()]
        if self._rnn_state is None or (leaves and leaves[0].shape[0] != batch):
            self._rnn_state = self._init_rnn_states(batch)
        acts, _, self._rnn_state = self._activations(
            self._params(), xs, self._masks(features_masks), rnn_state=self._rnn_state)
        outs = [acts[o] for o in self.conf.network_outputs]
        if single_step:
            outs = [o[:, 0, :] if o.dim() == 3 else o for o in outs]
        outs = [to_host(o) for o in outs]
        return outs[0] if len(outs) == 1 else outs

    def rnn_clear_previous_state(self) -> None:
        """Reference: ComputationGraph.rnnClearPreviousState."""
        self._rnn_state = None

    def rnn_get_previous_state(self, vertex_name: str) -> Optional[dict]:
        """A copy of a vertex's streaming h/c as a dict of device tensors
        (reference: ComputationGraph.rnnGetPreviousState); None for a
        stateless vertex or a cleared state."""
        if self._rnn_state is None:
            return None
        st = self._rnn_state.get(vertex_name)
        return {k: v.clone() for k, v in st.items()} if st else None

    # ------------------------------------------------- not ported yet (later)
    analyze_ir = _later("analyze_ir")


__all__ = ["ComputationGraph"]
