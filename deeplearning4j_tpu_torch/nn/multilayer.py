"""MultiLayerNetwork (counterpart of ``deeplearning4j_tpu/nn/multilayer.py``):
inference, streaming and training.

The network is an ``nn.Module`` holding one ``nn.ParameterDict`` per layer on
an explicit device. It runs on the card unless the caller passes
``device="cpu"``; with the default device and no CUDA, construction raises.
``lstm_variant`` picks the route of every LSTM layer: "seqfused" (the
default, the whole-sequence kernels) or "fusedcell" (a loop of per-step cell
kernels); any other value raises ValueError. It is not part of the conf.

- ``output``, ``predict`` and ``rnn_time_step`` take host arrays (or
  tensors) and return host numpy arrays, as the JAX package's inference fast
  path does; bfloat16 results come back as float32, which holds them
  exactly. They run under ``torch.no_grad()``, so the LSTM layers launch the
  lean sequence kernel, and go through ``runtime.inference``: power-of-two
  buckets, each a CUDA graph replayed on the card, reading the network's
  fixed buffers (``_params``, ``_served_state``, the streaming buffers),
  under the network's lock; ``DL4JTPU_INFER=legacy`` runs the layers
  eagerly at the request's shape. ``swap_params`` writes new params into
  the network in place (what ``InferenceService.hot_swap`` calls).
- ``fit`` trains on an (x, y) pair, a ``DataSet`` or an iterable of either
  (e.g. a ``BucketingSequenceIterator`` of padded, masked batches), one
  update per batch (``backprop_type="standard"``) or one per time segment
  (``"tbptt"``). An iterator whose ``prefetch_supported`` is true is read
  by a host thread one queue ahead (``AsyncDataSetIterator``); on the card
  ``DevicePrefetchIterator`` does that and copies each batch through pinned
  buffers on a side stream one batch ahead of its update (batches under
  8 MiB as they come). ``fit(stage_on_device=K)`` groups the batches into
  windows of K (``datasets.bucketing.BucketedStager``: ragged batches padded
  with masks, sequences to power-of-two lengths) and trains each window as
  ``fit_on_device`` does, window i+1 read, stacked, pinned and its copy
  started while window i's updates run. The params are trainable leaves in
  ``params_dtype``; each step casts them to the compute dtype under
  autograd, and the loss head runs in f32 on f32 params as in the JAX
  package. The updater
  (``conf.updater``, the JAX JSON dict) is built when first needed; updates
  run in an f32 island (``updaters.optimizer_update``) and are written into
  the leaves in place. ``updater_state_leaves`` and
  ``set_updater_state_leaves`` read and set its state as the leaves of the
  JAX package's optax state (``utils/serialization.py`` saves them).
- ``fit_on_device`` trains on K batches staged on the device ([K, B, ...]),
  step i on batch ``i % real_batches``: on the card one training step
  (forward, gradients, update, the layer state's writes) is captured once
  in a CUDA graph (``runtime.step_graphs``) and replayed once per update;
  before each replay the host enqueues the copies of the step's batch and
  of its row of the updater's scalar table (``updaters.step_scalars``)
  into the graph's static buffers, and the losses are read once, after the
  window. ``warmup`` captures the step without training (the graph's
  warm-up steps run on a copy of the state, which is put back exactly). On
  the CPU the same step runs in a Python loop, through the same buffers,
  table and in-place update: the plain version of the capture, bit for bit
  the per-batch ``fit``'s. A capture or replay that fails raises; nothing
  falls back to an eager loop on the card.
- ``evaluate`` runs ``output`` over a dataset and returns an
  ``Evaluation``, with a ``Prediction`` per example where the batches carry
  record metadata.
- ``state`` holds the layers' state (BatchNormalization's running mean and
  variance), one dict per layer, f32 on the net's device. Training
  forwards read it, and ``fit`` stores what they return (no autograd
  history) with each update, before the listeners run; ``output``,
  ``predict``, ``evaluate``, ``score`` and ``feed_forward`` (unless asked
  to train) read it as it is.
  ``state_leaves`` and ``set_state_leaves`` read and set it as the leaves
  of the JAX package's ``net.state`` (``utils/serialization.py`` saves
  them).
- ``summary``, ``feed_forward`` and ``clone`` are the JAX package's.
- ``pretrain`` and ``pretrain_layer`` train the AutoEncoder, RBM and
  VariationalAutoencoder layers alone, bottom up, each on its
  ``pretrain_loss`` (the JAX package's layerwise pretraining), with their
  noise from the network's generator or from a caller's ``noise``.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import ops
from ..datasets.bucketing import BucketedStager
from ..datasets.iterators import (AsyncDataSetIterator, DataSet, DevicePrefetchIterator,
                                  MultiDataSet, as_iterator)
from ..eval.evaluation import Evaluation
from ..runtime import inference as _inf
from ..runtime.compile_manager import get_compile_manager, signature
from ..runtime.step_graphs import StepGraph, StepGraphs
from ..telemetry import device as _tdev
from .conf.multi_layer import MultiLayerConfiguration
from .layers.frozen import FrozenLayer
from .layers.normalization import BatchNormalization
from .layers.recurrent import GravesLSTM
from .updaters import (UpdaterConfig, _leaves, _map, advance_counts, opt_state_from_leaves,
                       opt_state_leaves, optimizer_update, optimizer_update_in_place,
                       scaled_loss, step_scalars, unscale_grads)

# eager steps on a side stream before a capture: they build the kernels,
# load their modules, create the library handles and pick cuDNN's algorithms
# (none of which may happen while a stream is captured); their changes to the
# state are put back
WARMUP_STEPS = 2

_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must be present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU unless asked "
            "otherwise; pass device='cpu' to run on the CPU")
    return dev


def to_host(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().cpu().numpy()


def _as_tensor(a) -> torch.Tensor:
    """A tensor as it is; anything else (numpy, JAX arrays) through numpy."""
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))


def _staged_dim0(arr) -> int:
    """Leading (staged-batch) dim of an array or tensor."""
    shape = getattr(arr, "shape", None)
    if shape is None:
        shape = np.shape(arr)
    return int(shape[0])


def _check_staged_counts(num_batches: int, named_arrays) -> None:
    """``fit_on_device``'s guard: every staged array holds as many batches
    as the features, or step i would pair features i with other labels."""
    for name, arr in named_arrays:
        if arr is not None and _staged_dim0(arr) != num_batches:
            raise ValueError(f"{name} stages {_staged_dim0(arr)} batches, "
                             f"expected {num_batches}")


def _real_batches(num_slots: int, steps, real_batches):
    """(steps, real batch count) of a window of ``num_slots`` staged batches,
    checked: ``real_batches`` defaults to every slot, ``steps`` to one pass
    over the real batches."""
    if num_slots == 0:
        raise ValueError("fit_on_device needs at least one staged batch")
    n_real = num_slots if real_batches is None else int(real_batches)
    if not 1 <= n_real <= num_slots:
        raise ValueError(f"real_batches={n_real} outside [1, {num_slots}]")
    return (int(steps) if steps is not None else n_real), n_real


def _materialize(a):
    """A staged array for ``warmup``: a meta tensor (shape and dtype only)
    becomes zeros of its shape on the CPU."""
    if isinstance(a, torch.Tensor) and a.is_meta:
        return torch.zeros(a.shape, dtype=a.dtype)
    return a


def _summary_table(rows, total: int) -> str:
    """Fixed-width table and a totals line, as the JAX package prints it."""
    widths = [max(len(r[c]) for r in rows) for c in range(len(rows[0]))]
    lines = ["  ".join(v.ljust(w) for v, w in zip(r, widths)).rstrip() for r in rows]
    lines.insert(1, "-" * max(len(l) for l in lines))
    lines.append(f"Total params: {total:,}")
    return "\n".join(lines)


class BaseNetwork(torch.nn.Module):
    """What MultiLayerNetwork and ComputationGraph share: the device, the
    compute and param dtypes, inputs and labels on the device, the
    listeners, the updater and its state, the layer state's leaves, the
    update itself, ``clone``, and the staged loop's captured steps.
    ``_leaves()`` and ``_state_dicts()`` (the
    trainable params and the layer state as lists of dicts in the order of
    the JAX package's ``jax.tree_util.tree_leaves``), and their inverses
    ``_params_from_leaves`` and ``_set_state_dicts``, are each network's
    own."""

    def __init__(self, conf, device="cuda"):
        super().__init__()
        if conf.dtype not in _COMPUTE_DTYPES:
            raise ValueError(f"dtype={conf.dtype!r} is not supported "
                             f"(use {sorted(_COMPUTE_DTYPES)})")
        if conf.params_dtype not in (None, "float32", "bfloat16"):
            raise ValueError(f"params_dtype={conf.params_dtype!r} is not supported "
                             "(use None, 'float32' or 'bfloat16')")
        self.conf = conf
        self.device = resolve_device(device)
        self._initialized = False
        self._compute_params = None
        self.iteration = 0  # updates taken
        self.epoch = 0  # passes of fit over its data
        self._last_loss: Optional[torch.Tensor] = None
        self._updater = None  # built from conf.updater when first needed
        self._opt_state = None
        self._generator: Optional[torch.Generator] = None  # dropout draws
        self.listeners: List = []
        self.state = None  # layer state; set by init
        self._step_graphs = StepGraphs()  # the staged loop's captured steps
        self._statics = None  # (updater state, layer state) tensors they hold
        # the served forward (runtime.inference): the compile manager's owner
        # token (one per init), the lock held from a graph's inputs to its
        # output's host copy, the graphs' pool, the params' fixed buffers,
        # the served copy of the layer state and the streaming-state buffers
        # by batch size
        self._cm_token = None
        self._cm_finalizer = None
        self._infer_lock = threading.RLock()
        self._infer_pool = None
        self._param_buffers = None
        self._served = None
        self._served_pads = None  # runtime.inference._pads
        self._infer_rnn: dict = {}
        self.last_batch_size: Optional[int] = None
        self.staged_steps_total = 0  # updates taken by fit_on_device
        self.staged_step_time: Optional[float] = None  # set while its listeners run
        self.telemetry = None  # telemetry.Telemetry session (set_telemetry)
        # what a listener's flags ask for, kept only while it runs:
        # needs_input (the batch's features), needs_gradients (the update's
        # gradients and updates, on its frequency's iterations)
        self._last_input = None
        self._last_grads = None
        self._last_updates = None

    @property
    def params_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.conf.params_dtype == "bfloat16" else torch.float32

    @property
    def compute_dtype(self) -> torch.dtype:
        """bf16 for bf16 models, else f32 (bf16-stored params are upcast,
        as _compute_cast does)."""
        return _COMPUTE_DTYPES[self.conf.dtype]

    def _param_dict(self, params: dict) -> torch.nn.ParameterDict:
        """One layer's or vertex's params as trainable leaves on this
        network's device, in ``params_dtype``."""
        return torch.nn.ParameterDict({
            k: torch.nn.Parameter(torch.as_tensor(v).to(self.device, self.params_dtype))
            for k, v in params.items()})

    def _reset(self) -> None:
        """After new params: no cached casts, a fresh updater state, the
        iteration count at 0 and the dropout generator reseeded."""
        self._initialized = True
        self._compute_params = None
        self._updater = None
        self._opt_state = None
        self.iteration = 0
        self._generator = torch.Generator(device=self.device).manual_seed(self.conf.seed)
        self._step_graphs.clear()  # they hold the old params
        self._statics = None
        self._new_token()

    def _new_token(self) -> None:
        """Retire the previous generation's captured programs (they read the
        old params) and take a fresh compile-manager token; the token is
        also dropped when the network is collected."""
        cm = get_compile_manager()
        if self._cm_finalizer is not None:
            self._cm_finalizer.detach()
            cm.drop_token(self._cm_token)
        self._cm_token = cm.new_token()
        self._cm_finalizer = weakref.finalize(self, cm.retire, self._cm_token)
        self._step_graphs.token = self._cm_token
        self._infer_pool = None
        self._param_buffers = None
        self._served = None
        self._served_pads = None  # runtime.inference._pads
        self._infer_rnn = {}

    def _fill_param_buffers(self, casts):
        """The served params: the first casts of a generation become its
        fixed buffers (on the f32 path they alias the leaves); later casts
        are copied into them in place, so a captured graph reads the
        current params at its next replay."""
        if self._param_buffers is None:
            self._param_buffers = casts
            return casts
        for buf, new in zip(_inf._leaf_tensors(self._param_buffers), _inf._leaf_tensors(casts)):
            if buf.data_ptr() != new.data_ptr():
                buf.copy_(new)
        return self._param_buffers

    def _served_state(self):
        """The layer state the served forward reads: fixed copies of
        ``state`` (a captured graph holds their addresses), refreshed from
        ``state`` on every call with one multi-tensor copy, since ``fit``
        rebinds the state tensors or writes them in place. In the layout of
        ``state``."""
        src = [t for d in self._state_dicts() for t in d.values()]
        if self._served is None:
            bufs = [{k: v.detach().clone() for k, v in d.items()} for d in self._state_dicts()]
            self._served = (self._state_layout(bufs), [t for d in bufs for t in d.values()])
        layout, flat = self._served
        if flat:
            with torch.no_grad():
                torch._foreach_copy_(flat, src)
        return layout

    def _state_layout(self, dicts: List[dict]):
        """``dicts`` (one per entry of ``_state_dicts()``) in the layout of
        ``state``."""
        raise NotImplementedError

    def swap_params(self, params, state=None) -> None:
        """Write new params (in ``init``'s layout: one dict per layer, or
        vertex name to dict; arrays or tensors) and optionally a new layer
        state (in ``state``'s layout) into this network's tensors in place,
        under the serving lock: the served graphs read them at their next
        replay, with no new capture. Keys and shapes are checked. The
        updater state and the iteration count stay as they are."""
        self.init()
        new = self._swap_leaves(params)
        cur = self._leaves()
        if len(new) != len(cur):
            raise ValueError(f"{len(new)} param dicts, the network has {len(cur)}")
        with self._infer_lock, torch.no_grad():
            staged = []
            for i, (mine, theirs) in enumerate(zip(cur, new)):
                if set(mine) != set(theirs):
                    raise ValueError(f"params {i}: keys {sorted(theirs)}, expected {sorted(mine)}")
                for k, v in mine.items():
                    t = _as_tensor(theirs[k])
                    if tuple(t.shape) != tuple(v.shape):
                        raise ValueError(f"params {i} {k}: shape {tuple(t.shape)}, expected "
                                         f"{tuple(v.shape)}")
                    staged.append((v, t))
            for v, t in staged:
                v.copy_(t)
            self._compute_params = None
            if state is not None:
                for cur_d, new_d in zip(self._state_dicts(), self._swap_leaves(state)):
                    for k, t in cur_d.items():
                        t.copy_(_as_tensor(new_d[k]))

    def _swap_leaves(self, tree) -> List[dict]:
        """A params or state tree in ``init``'s layout as one dict per entry
        of ``_leaves()``."""
        raise NotImplementedError

    def _leaves(self) -> List[dict]:
        raise NotImplementedError

    def _params_from_leaves(self, dicts: List[dict]):
        """``init``'s params from one dict per entry of ``_leaves()``."""
        raise NotImplementedError

    def _state_dicts(self) -> List[dict]:
        raise NotImplementedError

    def _set_state_dicts(self, dicts: List[dict]) -> None:
        raise NotImplementedError

    def _device_state(self, state: dict) -> dict:
        """One layer's or vertex's state as f32 tensors on this network's
        device (copies)."""
        def f32(v):
            t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v, np.float32))
            return t.to(self.device, torch.float32, copy=True)

        return {k: f32(v) for k, v in state.items()}

    def state_leaves(self) -> List[torch.Tensor]:
        """The layer state as the leaves of the JAX package's ``net.state``
        (``jax.tree_util.tree_leaves``): layer by layer, or vertex by
        sorted vertex name, each in sorted key order ("mean" before
        "var")."""
        self.init()
        return [d[k] for d in self._state_dicts() for k in sorted(d)]

    def set_state_leaves(self, leaves) -> None:
        """Set the layer state from leaves in that order (arrays or
        tensors); counts and shapes are checked."""
        self.init()
        dicts = self._state_dicts()
        want = sum(len(d) for d in dicts)
        if len(leaves) != want:
            raise ValueError(f"{len(leaves)} state leaves, the network expects {want}")
        it = iter(leaves)
        new = []
        for d in dicts:
            got = self._device_state({k: next(it) for k in sorted(d)})
            for k, v in got.items():
                if tuple(v.shape) != tuple(d[k].shape):
                    raise ValueError(f"state {k}: shape {tuple(v.shape)}, expected "
                                     f"{tuple(d[k].shape)}")
            new.append({k: got[k] for k in d})
        self._set_state_dicts(new)

    def clone(self):
        """A network of the same configuration, device and options holding
        copies of the params, layer state, updater state, iteration and
        epoch (reference: clone())."""
        other = self._twin()
        if self._initialized:
            other.init(params=self._params_from_leaves(
                [{k: v.detach().clone() for k, v in layer.items()} for layer in self._leaves()]))
            other._set_state_dicts([{k: v.clone() for k, v in d.items()}
                                    for d in self._state_dicts()])
            if self._updater is not None:
                other.set_updater_state_leaves(
                    [t.clone() if isinstance(t, torch.Tensor) else t
                     for t in self.updater_state_leaves()])
            other.iteration, other.epoch = self.iteration, self.epoch
        return other

    def _twin(self):
        raise NotImplementedError

    def num_params(self) -> int:
        self.init()
        return sum(v.numel() for layer in self._leaves() for v in layer.values())

    def _input(self, x) -> torch.Tensor:
        """Host or device input on this net's device, floating input in the
        compute dtype."""
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        if t.is_floating_point():
            return t.to(self.device, self.compute_dtype)
        return t.to(self.device)

    def _mask(self, features_mask) -> Optional[torch.Tensor]:
        if features_mask is None:
            return None
        return self._input(features_mask).to(self.compute_dtype)

    def _labels(self, y) -> torch.Tensor:
        """Labels on this net's device; floating labels in f32, the dtype the
        loss head computes in."""
        t = y if isinstance(y, torch.Tensor) else torch.as_tensor(np.asarray(y))
        if t.is_floating_point():
            return t.to(self.device, torch.float32)
        return t.to(self.device)

    def _labels_mask(self, labels_mask) -> Optional[torch.Tensor]:
        return None if labels_mask is None else self._labels(labels_mask).float()

    def set_listeners(self, *listeners) -> None:
        """Objects whose ``iteration_done(net, iteration, loss)`` is called
        after every update (the JAX package's IterationListener contract);
        ``loss`` is the update's loss as a 0-d device tensor."""
        self.listeners = list(listeners)

    def add_listener(self, listener) -> None:
        self.listeners.append(listener)

    def set_telemetry(self, telemetry):
        """Attach a :class:`telemetry.Telemetry` session to the fit paths
        (None detaches). With a session attached each update also computes
        the device-side metrics vector (loss, grad norm of the unscaled
        gradients, non-finite flag: ``telemetry.device.step_stats``) and
        hands it to ``telemetry.on_step``, which reads the device once per
        ``fetch_every`` steps; a staged window's captured step writes its
        vector into a window buffer that the window's one read brings back
        with the losses (``on_staged``)."""
        self.telemetry = telemetry
        return self

    def _wants_grad_stats(self) -> bool:
        """True when some listener will read the gradients and updates on
        the iteration about to run: a ``needs_gradients`` listener whose
        ``frequency`` divides it."""
        nxt = self.iteration + 1
        return any(getattr(lst, "needs_gradients", False)
                   and nxt % max(1, getattr(lst, "frequency", 1)) == 0
                   for lst in self.listeners)

    def memory_report(self, batch_or_struct=None) -> dict:
        """Per-layer device-memory attribution (param, gradient, optimizer
        and activation bytes) at a batch size or example arrays, from a
        forward on meta tensors: nothing allocates. See
        :func:`deeplearning4j_tpu_torch.telemetry.memory_report`."""
        from ..telemetry.memory import memory_report

        return memory_report(self, batch_or_struct)

    def preflight(self, batch_or_struct=None, **kw) -> dict:
        """Will this net and batch fit in device memory? Raises
        :class:`~deeplearning4j_tpu_torch.telemetry.MemoryPreflightError`
        naming the biggest consumers; returns the annotated memory report
        when it fits. See :func:`deeplearning4j_tpu_torch.telemetry.preflight`."""
        from ..telemetry.memory import preflight

        return preflight(self, batch_or_struct, **kw)

    def _updater_ready(self):
        """The updater of ``conf.updater``, built with a fresh state the
        first time it is needed after ``init``."""
        self.init()
        if self._updater is None:
            self._updater = UpdaterConfig.from_dict(self.conf.updater).build()
            self._opt_state = self._updater.init(self._leaves())
        return self._updater

    def updater_state_leaves(self) -> List[torch.Tensor]:
        """The updater state as the leaves of the JAX package's optax state
        (``jax.tree_util.tree_leaves(net.opt_state)`` there): moments in the
        params' dtype, counts as int32 scalars."""
        self._updater_ready()
        return opt_state_leaves(self._opt_state)

    def set_updater_state_leaves(self, leaves) -> None:
        """Set the updater state from leaves in that order (arrays or
        tensors); the next update continues from it."""
        self._opt_state = opt_state_from_leaves(self._updater_ready(), self._leaves(),
                                                leaves)

    def _grads(self, loss: torch.Tensor, leaves: List[dict]) -> List[dict]:
        """The gradients of ``loss`` for ``leaves`` (zeros for a leaf it does
        not reach), through the loss scale and back."""
        ls = self.conf.loss_scale
        flat = [v for layer in leaves for v in layer.values()]
        flat_grads = iter(torch.autograd.grad(scaled_loss(loss, ls), flat,
                                              allow_unused=True, materialize_grads=True))
        return unscale_grads([{k: next(flat_grads) for k in layer} for layer in leaves], ls)

    def _update(self, loss: torch.Tensor, tbptt: bool = False) -> None:
        """One update from ``loss``: backward, unscale, update the leaves in
        place; then the telemetry session's ``on_step`` (the metrics vector
        of the unscaled gradients; of the loss alone for a TBPTT segment, as
        in the JAX package) and the listeners, which see ``_last_grads`` and
        ``_last_updates`` on a ``needs_gradients`` listener's iterations
        (dropped once they have run)."""
        leaves = self._leaves()
        grads = self._grads(loss, leaves)
        tel = self.telemetry
        mvec = None
        if tel is not None:
            mvec = _tdev.step_stats(loss, None if tbptt else grads)
        keep = not tbptt and self._wants_grad_stats()
        updates, self._opt_state, new_params = optimizer_update(
            self._updater, grads, self._opt_state, leaves)
        with torch.no_grad():
            for layer, new in zip(leaves, new_params):
                for k, v in layer.items():
                    v.copy_(new[k])
        self._compute_params = None
        self._last_loss = loss.detach()
        self.iteration += 1
        if keep:
            self._last_grads, self._last_updates = grads, updates
        if tel is not None:
            tel.on_step(self.iteration, mvec)
        for lst in self.listeners:
            lst.iteration_done(self, self.iteration, self._last_loss)
        # the listeners have read what they need: hold no gradients
        self._last_grads = None
        self._last_updates = None

    # ------------------------------------------------- the staged loop
    # each network's ``_staged_args`` checks a window's stacked arrays and
    # turns them into device tensors, one per static buffer of a step (None
    # for an absent mask); ``_staged_loss`` runs a step's forward on them
    def _staged_loss(self, batch: list):
        """(loss, the new layer state as ``_state_dicts()`` lists it) of one
        training forward on ``batch`` (the step's static buffers)."""
        raise NotImplementedError

    def _pad_examples_ok(self) -> bool:
        """Row padding is exact only for per-example models: batch statistics
        (BatchNormalization) couple the rows, so such models keep their exact
        batch sizes (window padding with dummy slots stays on: those slots
        never run)."""
        raise NotImplementedError

    def _write_state(self, new_state: List[dict]) -> None:
        """Write a step's new layer state into the current state tensors, in
        place (a captured step's graph holds their addresses)."""
        with torch.no_grad():
            for cur, new in zip(self._state_dicts(), new_state):
                for k, t in cur.items():
                    if new[k] is not t:
                        t.copy_(new[k])

    def _graph_step(self, entry: StepGraph):
        """One training step on ``entry``'s static buffers: the loss, the
        gradients, the update with the step's scalars, and the new layer
        state, all written in place. What a capture records; on the CPU the
        staged loop runs it as it is. Returns the loss and, when telemetry
        rides the run, the step's metrics vector (else None)."""
        loss, new_state = self._staged_loss(entry.batch)
        leaves = self._leaves()
        grads = self._grads(loss, leaves)
        mvec = _tdev.step_stats(loss, grads) if self.telemetry is not None else None
        optimizer_update_in_place(self._updater, grads, self._opt_state, leaves, entry.scalars)
        self._write_state(new_state)
        return loss.detach().float(), mvec

    def _bind_statics(self) -> None:
        """Point the updater state and the layer state at the staged loop's
        own tensors, which every captured step of this network holds: made
        once per ``init`` as copies of the current ones; later, wherever the
        per-batch path or a setter has replaced a tensor, its value is
        copied in."""
        cur_opt = _leaves(self._opt_state)
        cur_state = [t for d in self._state_dicts() for t in d.values()]
        if self._statics is None:
            self._statics = ([t.clone() for t in cur_opt], [t.clone() for t in cur_state])
        opt_s, state_s = self._statics
        with torch.no_grad():
            for mine, cur in zip(opt_s + state_s, cur_opt + cur_state):
                if mine is not cur:
                    mine.copy_(cur)
        it = iter(opt_s)
        self._opt_state = _map(lambda t: next(it), self._opt_state)
        it = iter(state_s)
        self._set_state_dicts([{k: next(it) for k in d} for d in self._state_dicts()])

    def _snapshot(self):
        """Copies of everything a training step changes: params, updater and
        layer state, the dropout generator's state."""
        params = [v for layer in self._leaves() for v in layer.values()]
        tensors = params + _leaves(self._opt_state) + [
            t for d in self._state_dicts() for t in d.values()]
        return tensors, [t.detach().clone() for t in tensors], self._generator.get_state()

    def _restore(self, snap) -> None:
        tensors, saved, gen_state = snap
        with torch.no_grad():
            for t, v in zip(tensors, saved):
                t.copy_(v)
        self._generator.set_state(gen_state)

    @staticmethod
    def _load_slot(entry: StepGraph, stacked: list, slot: int) -> None:
        for dst, src in zip(entry.batch, stacked):
            if dst is not None:
                dst.copy_(src[slot])

    def _capture(self, entry: StepGraph, stacked: list) -> None:
        """Capture ``entry``'s step in a CUDA graph: warm-up steps on a side
        stream from a snapshot that is put back, then the capture, with the
        dropout generator registered so that each replay draws anew and
        moves it on as an eager step does. Raises if the capture fails."""
        self._load_slot(entry, stacked, 0)
        entry.scalars.copy_(torch.from_numpy(
            step_scalars(self._updater, self._opt_state, 1)[0]))
        snap = self._snapshot()
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self._graph_step(entry)
        current.wait_stream(side)
        self._restore(snap)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self._generator)
        before = ops.counters()
        with torch.cuda.graph(graph, pool=self._step_graphs.pool):
            entry.loss, entry.mvec = self._graph_step(entry)
        entry.launches = {k: n - before[k] for k, n in ops.counters().items()
                          if n != before[k]}
        entry.graph = graph
        if self._step_graphs.pool is None:
            self._step_graphs.pool = graph.pool()
        entry.pool = self._step_graphs.pool

    def _step_entry(self, stacked: list) -> StepGraph:
        """The captured step (on the CPU: the static buffers) for windows
        shaped as ``stacked``: from the cache, or made now."""
        self._updater_ready()
        self._bind_statics()
        key = signature([None if t is None else t[0] for t in stacked], self.conf.updater,
                        self.conf.loss_scale, str(self.compute_dtype),
                        str(self.params_dtype), self.telemetry is not None)
        def build() -> StepGraph:
            entry = StepGraph(batch=[None if t is None else torch.empty_like(t[0])
                                     for t in stacked],
                              scalars=torch.ones(3, dtype=torch.float32, device=self.device))
            if self.device.type == "cuda":
                self._capture(entry, stacked)
            return entry

        return self._step_graphs.admit(key, build)

    @staticmethod
    def _stats_rows(rows: torch.Tensor) -> list:
        """Where each step of a window writes its metrics vector: row i of
        the window buffer."""
        return list(rows)

    def _start_window(self, stacked: list, steps, real_batches):
        """Queue ``steps`` updates on ``stacked`` (see ``fit_on_device``):
        replay the captured step (on the CPU, run it) once per update after
        the copies of its batch and scalars, each loss (and with telemetry
        on, each metrics vector beside it) into a device buffer; then the
        counts and the caches. Returns what ``_finish_window`` reads."""
        n_steps, n_real = _real_batches(_staged_dim0(stacked[0]), steps, real_batches)
        entry = self._step_entry(stacked)
        table = torch.from_numpy(step_scalars(self._updater, self._opt_state, n_steps)
                                 ).to(self.device)
        tel = self.telemetry is not None
        # one buffer, one read: column 0 the losses, then the metrics vectors
        buf = torch.empty(n_steps, 1 + (_tdev.NUM_SLOTS if tel else 0), dtype=torch.float32,
                          device=self.device)
        rows = self._stats_rows(buf[:, 1:]) if tel else None
        t0 = time.perf_counter()
        for i in range(n_steps):
            self._load_slot(entry, stacked, i % n_real)
            entry.scalars.copy_(table[i])
            if entry.graph is not None:
                entry.graph.replay()
                entry.replays += 1
                self._step_graphs.replays += 1
                loss, mvec = entry.loss, entry.mvec
            else:
                loss, mvec = self._graph_step(entry)
            buf[i, 0].copy_(loss)
            if tel:
                rows[i].copy_(mvec)
        self._opt_state = advance_counts(self._opt_state, n_steps)
        self._compute_params = None
        self.last_batch_size = int(stacked[0].shape[1])
        self.staged_steps_total += n_steps
        return buf, t0, int(stacked[0].shape[0]), int(stacked[0].shape[1])

    def _finish_window(self, queued) -> np.ndarray:
        """Read a queued window's losses, and with telemetry on its metrics
        rows, in the window's one wait for the device; hand the rows to the
        telemetry session (``on_staged``), then run the listeners once per
        step."""
        buf, t0, slots, batch = queued
        host = buf.cpu()
        elapsed = time.perf_counter() - t0
        n = len(host)
        tel = self.telemetry if host.shape[1] > 1 else None  # rows written at the start
        if tel is not None:
            if tel.flight is not None:
                tel.flight.record("staged_dispatch", net=self._flight_name, steps=n,
                                  slots=slots, batch=batch,
                                  seconds=round(elapsed, 6))
            tel.on_staged(self.iteration + 1, host[:, 1:],
                          per_step_time_s=elapsed / max(n, 1))
        losses = host[:, 0].contiguous()
        # the listeners run in a tight loop after the window: publish each
        # step's even share of the window's time for throughput listeners
        self.staged_step_time = elapsed / max(n, 1)
        try:
            for loss in losses:
                self.iteration += 1
                self._last_loss = loss
                for lst in self.listeners:
                    lst.iteration_done(self, self.iteration, loss)
        finally:
            self.staged_step_time = None
        return losses.numpy()

    def _staged_window(self, stacked: list, steps, real_batches) -> np.ndarray:
        return self._finish_window(self._start_window(stacked, steps, real_batches))

    def _fit_staged_epoch(self, it, reader, stage: int, bucketing: bool, normalize,
                          fit_batch, dispatch) -> None:
        """One epoch in windows of ``stage`` batches (``BucketedStager``),
        pipelined on this thread: window i+1 is read, stacked, pinned into
        ``reader``'s ring and its copy started while window i's replays run
        on the card, and only then are window i's losses read. ``dispatch``
        queues a window. Batches that cannot stage train per batch, in
        stream order."""
        stager = BucketedStager(stage, bucketing=bucketing,
                                pad_examples=self._pad_examples_ok())
        queued = None
        for kind, payload in stager.plan(it, normalize):
            if kind == "window":
                copy = reader.start_copy(payload)
                if queued is not None:
                    self._finish_window(queued)
                queued = dispatch(reader.finish_copy(copy))
                continue
            if queued is not None:
                self._finish_window(queued)
                queued = None
            fit_batch(payload)
        if queued is not None:
            self._finish_window(queued)

    def _fit_stage(self, stage_on_device) -> int:
        """The window size ``fit`` stages with: 0 for None (the port has no
        tuning store), and 0 under TBPTT or when a listener lacks
        ``supports_staged`` (its ``iteration_done`` runs after the window,
        where the per-step model state it might read is gone)."""
        stage = int(stage_on_device or 0)
        if stage > 1 and (self.conf.backprop_type == "tbptt" or any(
                not getattr(lst, "supports_staged", False) for lst in self.listeners)):
            return 0
        return stage

    def _epochs(self, data, epochs: int, staged: bool):
        """Each epoch's iterator, reset, between the listeners' epoch hooks,
        and the call's ``DevicePrefetchIterator`` (its side stream and ring
        of pinned buffers made once for all epochs). An iterator whose
        ``prefetch_supported`` is true is read ahead: on the CPU by an
        ``AsyncDataSetIterator``; on the card per batch by that
        ``DevicePrefetchIterator`` (its worker thread is the host's prefetch
        too, as in the JAX package). On the card the staged loop reads the
        iterator itself and copies its windows through the same ring
        (``_fit_staged_epoch``). A single batch (an (x, y) pair, a DataSet,
        a MultiDataSet) has no next batch to read ahead and is not wrapped
        (the JAX package wraps it too; here a thread a call would cost more
        than the copy it could hide)."""
        ahead = not isinstance(data, (DataSet, MultiDataSet, tuple))
        reader = DevicePrefetchIterator(None, self.device)
        for _ in range(epochs):
            for lst in self.listeners:
                if hasattr(lst, "on_epoch_start"):
                    lst.on_epoch_start(self, self.epoch)
            it = as_iterator(data)
            if hasattr(it, "reset"):
                it.reset()
            if ahead and getattr(it, "prefetch_supported", False):
                if self.device.type != "cuda":
                    it = AsyncDataSetIterator(it)
                elif not staged:
                    reader.base = it
                    it = reader
            yield it, reader
            self.epoch += 1
            for lst in self.listeners:
                if hasattr(lst, "on_epoch_end"):
                    lst.on_epoch_end(self, self.epoch)


class MultiLayerNetwork(BaseNetwork):
    """Sequential network over a :class:`MultiLayerConfiguration`."""

    _flight_name = "mln"  # the staged window's flight-recorder event names it

    def __init__(self, conf: MultiLayerConfiguration, device="cuda",
                 lstm_variant: str = "seqfused"):
        super().__init__(conf, device)
        self.lstm_variant = ops.check_lstm_variant(lstm_variant)
        self.layer_params = torch.nn.ModuleList()
        self._rnn_state = None  # streaming state: one dict per layer

    # ------------------------------------------------------------------ init
    def init(self, params: Optional[Sequence[dict]] = None, force: bool = False,
             generator: Optional[torch.Generator] = None) -> "MultiLayerNetwork":
        """Create the params: from ``params`` (one dict of arrays per layer),
        else drawn from ``generator`` (default: seeded by ``conf.seed``).
        Resets the layer state, the updater state and the iteration
        count."""
        if self._initialized and not force and params is None:
            return self
        input_types = self.conf.layer_input_types()
        if params is None:
            gen = generator if generator is not None else torch.Generator().manual_seed(
                self.conf.seed)
            params = [layer.init_params(gen, it)
                      for layer, it in zip(self.conf.layers, input_types)]
        if len(params) != len(self.conf.layers):
            raise ValueError(f"{len(params)} param dicts for "
                             f"{len(self.conf.layers)} layers")
        self.layer_params = torch.nn.ModuleList(self._param_dict(p) for p in params)
        self.state = tuple(self._device_state(layer.init_state(it))
                           for layer, it in zip(self.conf.layers, input_types))
        self._rnn_state = None
        self._reset()
        return self

    def _twin(self) -> "MultiLayerNetwork":
        return MultiLayerNetwork(MultiLayerConfiguration.from_dict(self.conf.to_dict()),
                                 device=self.device, lstm_variant=self.lstm_variant)

    def _leaves(self) -> List[dict]:
        """The trainable params, one dict per layer."""
        return [dict(p.items()) for p in self.layer_params]

    def _params_from_leaves(self, dicts: List[dict]) -> List[dict]:
        return list(dicts)

    def _state_dicts(self) -> List[dict]:
        return list(self.state)

    def _set_state_dicts(self, dicts: List[dict]) -> None:
        self.state = tuple(dicts)

    def _cast_params(self) -> List[dict]:
        """Params in the compute dtype, as casts of the leaves that autograd
        follows (the leaf itself where the dtypes agree)."""
        dt = self.compute_dtype
        return [{k: v.to(dt) for k, v in p.items()} for p in self.layer_params]

    def _params(self) -> List[dict]:
        """Params in the compute dtype for inference: cast once, and again
        after every update, into the same buffers (``_fill_param_buffers``)."""
        if self._compute_params is None:
            with torch.no_grad():
                self._compute_params = self._fill_param_buffers(
                    [{k: v.detach() for k, v in p.items()} for p in self._cast_params()])
        return self._compute_params

    def _state_layout(self, dicts: List[dict]):
        return tuple(dicts)

    def _swap_leaves(self, tree) -> List[dict]:
        return list(tree)

    # ------------------------------------------------------- functional core
    def _forward(self, params, x: torch.Tensor, state, features_mask=None,
                 rnn_state=None, *, upto: Optional[int] = None, train: bool = False,
                 generator: Optional[torch.Generator] = None, acts: Optional[list] = None):
        """Forward through layers [0, upto), each after its input
        preprocessor, if it has one. Returns (out, new_state,
        new_rnn_state); ``state`` is the layer state (one dict per layer),
        ``rnn_state`` (one dict per layer, {} for stateless layers) threads
        LSTM h/c across streaming calls and TBPTT segments. ``train`` has
        the layers train (BatchNormalization on batch stats); dropout acts
        where ``generator`` is given, drawn from it. ``acts`` collects each
        layer's output. LSTM layers take the route ``self.lstm_variant``."""
        layers = self.conf.layers
        n = len(layers) if upto is None else upto
        new_state = list(state)
        new_rnn = list(rnn_state) if rnn_state is not None else None
        for i in range(n):
            pre = self.conf.preprocessors.get(i)
            if pre is not None:
                x = pre.apply(x)
            inner = layers[i].layer if isinstance(layers[i], FrozenLayer) else layers[i]
            kw = {"lstm_variant": self.lstm_variant} if isinstance(inner, GravesLSTM) else {}
            if new_rnn is not None and new_rnn[i]:
                x, new_rnn[i] = layers[i].apply_seq(params[i], x, new_rnn[i],
                                                    mask=features_mask, train=train,
                                                    generator=generator, **kw)
            else:
                x, new_state[i] = layers[i].apply(params[i], x, state[i], mask=features_mask,
                                                  train=train, generator=generator, **kw)
            if acts is not None:
                acts.append(x)
        return x, tuple(new_state), (tuple(new_rnn) if new_rnn is not None else None)

    def _loss(self, x, y, labels_mask=None, features_mask=None, rnn_state=None,
              train: bool = True):
        """Loss + regularization (reference: computeGradientAndScore +
        calcL1/L2), the new layer state and the new streaming state. The
        hidden layers run in the compute dtype on ``self.state``; the output
        layer takes f32 h and f32 params, as the JAX package upcasts bf16
        there."""
        layers = self.conf.layers
        out_idx = len(layers) - 1
        out_layer = layers[out_idx]
        if not out_layer.is_output_layer:
            raise ValueError(
                f"Last layer {type(out_layer).__name__} is not an output layer")
        gen = self._generator if train else None
        h, new_state, new_rnn = self._forward(self._cast_params(), x, self.state,
                                              features_mask, rnn_state, upto=out_idx,
                                              train=train, generator=gen)
        pre = self.conf.preprocessors.get(out_idx)
        if pre is not None:
            h = pre.apply(h)
        h32 = h.float() if h.dtype == torch.bfloat16 else h
        out_p = {k: v.float() if v.dtype == torch.bfloat16 else v
                 for k, v in self.layer_params[out_idx].items()}
        loss = out_layer.compute_loss(out_p, h32, y, labels_mask, train=train,
                                      generator=gen)
        reg = sum(layer.regularization_loss(dict(p.items()))
                  for layer, p in zip(layers, self.layer_params))
        return loss + reg, new_state, new_rnn

    def loss_fn(self, x, y, *, train: bool = False, labels_mask=None,
                features_mask=None) -> torch.Tensor:
        """Scalar loss of the current params on (x, y), differentiable."""
        self.init()
        val, _, _ = self._loss(self._input(x), self._labels(y),
                               self._labels_mask(labels_mask), self._mask(features_mask),
                               train=train)
        return val

    @torch.no_grad()
    def forward(self, x: torch.Tensor, features_mask: Optional[torch.Tensor] = None):
        """Device-side inference: tensor in, tensor out."""
        self.init()
        return self._forward(self._params(), self._input(x), self.state,
                             self._mask(features_mask))[0]

    # -------------------------------------------------------------- inference
    def output(self, x, features_mask=None) -> np.ndarray:
        """Inference output as a host array, through the bucketed path of
        ``runtime.inference`` (rows and time in power-of-two buckets, each
        bucket a CUDA graph replayed on the card); ``DL4JTPU_INFER=legacy``
        runs the layers eagerly at the request's exact shape."""
        if _inf.fast_path_enabled():
            return _inf.mln_output(self, x, features_mask=features_mask)
        return to_host(self.forward(x, features_mask))

    def predict(self, x) -> np.ndarray:
        """Class indices (argmax over the last axis) as int32; on the
        bucketed path the argmax runs inside the graph and only the indices
        come to the host."""
        if _inf.fast_path_enabled():
            return _inf.mln_output(self, x, argmax=True)
        return to_host(torch.argmax(self.forward(x), dim=-1).to(torch.int32))

    def evaluate(self, data, top_n: int = 1) -> Evaluation:
        """Classification evaluation of ``output`` over ``data`` (as ``fit``
        takes it). As in the JAX package, the features mask goes to
        ``output`` and the labels mask is not applied: time-series outputs
        count every step of every row. A batch's ``example_metadata`` goes
        to ``Evaluation.eval`` (its ``predictions``) unless the output is a
        time series, whose B*T rows it no longer matches."""
        ev = Evaluation(top_n=top_n)
        for ds in as_iterator(data):
            ds = ds if isinstance(ds, DataSet) else DataSet(*ds)
            out = self.output(ds.features, features_mask=ds.features_mask)
            meta = ds.example_metadata if out.ndim != 3 else None
            ev.eval(ds.labels, out, record_metadata=meta)
        return ev

    def score(self, dataset=None) -> float:
        """Loss on a dataset (inference mode: no dropout, the stored layer
        state), or the last training loss."""
        if dataset is None:
            return float(self._last_loss) if self._last_loss is not None else float("nan")
        with torch.no_grad():
            return float(self.loss_fn(dataset.features, dataset.labels))

    @torch.no_grad()
    def feed_forward(self, x, train: bool = False) -> List[np.ndarray]:
        """Every layer's activation as a host array (reference:
        feedForward). ``train`` has the layers train (BatchNormalization on
        the batch's stats) without dropout and without storing any state."""
        self.init()
        acts: list = []
        x = self._input(_inf.canonicalize_input(x, self.compute_dtype))
        self._forward(self._params(), x, self.state, train=train, acts=acts)
        return [to_host(a) for a in acts]

    def summary(self) -> str:
        """Layer table: index, type, input and output types, param count
        (reference: MultiLayerNetwork.summary())."""
        self.init()
        rows = [("idx", "layer", "in", "out", "params")]
        total = 0
        for i, (layer, it) in enumerate(zip(self.conf.layers, self.conf.layer_input_types())):
            n = sum(v.numel() for v in self.layer_params[i].values())
            total += n
            rows.append((str(i), type(layer).__name__, str(it),
                         str(layer.get_output_type(it)), f"{n:,}"))
        return _summary_table(rows, total)

    # --------------------------------------------------------------- training
    def fit(self, data, epochs: int = 1, stage_on_device: Optional[int] = None,
            bucketing: bool = True) -> "MultiLayerNetwork":
        """Train (reference: MultiLayerNetwork.fit(DataSetIterator)).

        ``data``: an (x, y) tuple, a DataSet, or an iterable of either (an
        iterator with ``reset()`` is reset before each epoch; one whose
        ``prefetch_supported`` is true is read ahead by a host thread:
        ``AsyncDataSetIterator``, or on the card ``DevicePrefetchIterator``,
        which also copies each batch of 8 MiB or more to the card one batch
        ahead). One
        update per batch, or per time segment under TBPTT. Listeners'
        ``on_epoch_start`` and ``on_epoch_end`` run around each epoch.

        ``stage_on_device=K`` (None and 0: per batch) trains windows of K
        batches as :meth:`fit_on_device` does, pipelined: window i+1 is read,
        stacked, pinned and its copy started (non-blocking, on a side stream)
        while window i's updates run, before window i's losses are read. With
        ``bucketing`` (the default) ragged batches stay staged: a short batch
        pads with masked zero rows (not for models with BatchNormalization),
        sequences pad to power-of-two lengths, a trailing partial window runs
        its real batches only; ``bucketing=False`` stages only full uniform
        groups and trains the rest per batch. TBPTT, and a listener without
        ``supports_staged``, turn staging off."""
        self._updater_ready()
        stage = self._fit_stage(stage_on_device)
        for it, reader in self._epochs(data, epochs, stage > 1):
            if stage > 1:
                self._fit_staged_epoch(
                    it, reader, stage, bucketing, self._normalize,
                    lambda ds: self._fit_batch(ds if isinstance(ds, DataSet) else DataSet(*ds)),
                    self._dispatch)
            else:
                for ds in it:
                    self._fit_batch(ds if isinstance(ds, DataSet) else DataSet(*ds))
        if self.telemetry is not None:
            self.telemetry.flush()  # a partial K-window at the end of fit
        return self

    @staticmethod
    def _normalize(ds):
        """A batch as the stager's per-position lists."""
        ds = ds if isinstance(ds, DataSet) else DataSet(*ds)
        return ([np.asarray(ds.features)], [np.asarray(ds.labels)],
                [ds.features_mask], [ds.labels_mask])

    def _dispatch(self, win):
        """Queue a staged window's updates (``_start_window``)."""
        stacked = self._staged_args(
            win.features[0], win.labels[0],
            None if win.features_masks is None else win.features_masks[0],
            None if win.labels_masks is None else win.labels_masks[0])
        return self._start_window(stacked, win.n_real, win.n_real)

    def _pad_examples_ok(self) -> bool:
        return not any(isinstance(layer, BatchNormalization) for layer in self.conf.layers)

    def _staged_args(self, xs, ys, features_masks, labels_masks) -> list:
        """Checked staged arrays as device tensors: [x, y, features mask,
        labels mask], each [K, ...] (a mask may be None)."""
        if self.conf.backprop_type == "tbptt":
            raise ValueError("fit_on_device does not support TBPTT; use fit()")
        num_slots = _staged_dim0(xs)
        _check_staged_counts(num_slots, (("ys", ys), ("features_masks", features_masks),
                                         ("labels_masks", labels_masks)))
        return [self._input(xs), self._labels(ys), self._mask(features_masks),
                self._labels_mask(labels_masks)]

    def _staged_loss(self, batch: list):
        x, y, fm, lm = batch
        loss, new_state, _ = self._loss(x, y, lm, fm)
        return loss, list(new_state)

    def warmup(self, xs, ys, steps: Optional[int] = None, features_masks=None,
               labels_masks=None, real_batches: Optional[int] = None) -> "MultiLayerNetwork":
        """Capture ahead: on the card, the training step of windows shaped as
        ``xs``/``ys`` (and masks) is captured without training a step, so
        the first ``fit_on_device`` on such windows replays at once. The
        arrays may be real data or meta tensors (shape and dtype only). The
        capture's warm-up steps run from a snapshot of the params, updater
        and layer state, the dropout generator's state and ``iteration``,
        which is put back exactly. TBPTT raises ``ValueError``."""
        self.init()
        self._updater_ready()
        xs, ys, fm, lm = (None if a is None else _materialize(a)
                          for a in (xs, ys, features_masks, labels_masks))
        stacked = self._staged_args(xs, ys, fm, lm)
        _real_batches(_staged_dim0(xs), steps, real_batches)
        self._step_entry(stacked)
        return self

    def fit_on_device(self, xs, ys, steps: Optional[int] = None, features_masks=None,
                      labels_masks=None, real_batches: Optional[int] = None) -> np.ndarray:
        """Train on batches staged on the device: ``xs``/``ys`` (and masks)
        stack K batches ``[K, B, ...]`` (host arrays or tensors); step i
        trains on batch ``i % real_batches``. ``real_batches`` (default K)
        counts the leading slots that hold real data (the stager's trailing
        slots are dummies, never used); ``steps`` defaults to one pass over
        them. On the card one captured step is replayed per update; on the
        CPU the same step runs in a loop. Returns the per-step losses as a
        host array; afterwards ``iteration_done`` runs once per step with
        its loss (a 0-d host tensor). TBPTT raises ``ValueError``; a count
        of staged batches that differs from the features' raises
        ``ValueError`` naming the array."""
        self.init()
        self._updater_ready()
        stacked = self._staged_args(xs, ys, features_masks, labels_masks)
        return self._staged_window(stacked, steps, real_batches)

    def _step(self, x, y, labels_mask, features_mask, rnn_state=None):
        """One update from the loss on (x, y); the layer state the forward
        returned is stored. Returns the new streaming state, detached."""
        loss, new_state, new_rnn = self._loss(x, y, labels_mask, features_mask, rnn_state)
        self.state = new_state
        self._update(loss, tbptt=rnn_state is not None)
        if new_rnn is None:
            return None
        return tuple({k: t.detach() for k, t in st.items()} for st in new_rnn)

    def _fit_batch(self, ds: DataSet) -> None:
        self.last_batch_size = int(ds.features.shape[0])
        # the batch's features, kept only while a listener needs them (a
        # reference, no copy)
        self._last_input = (ds.features if any(getattr(lst, "needs_input", False)
                                               for lst in self.listeners) else None)
        x = self._input(ds.features)
        if self.conf.backprop_type == "tbptt" and x.dim() == 3:
            self._fit_tbptt(x, ds)
            return
        self._step(x, self._labels(ds.labels), self._labels_mask(ds.labels_mask),
                   self._mask(ds.features_mask))

    def _fit_tbptt(self, x: torch.Tensor, ds: DataSet) -> None:
        """Truncated BPTT (reference: doTruncatedBPTT): the sequence is cut
        into ``tbptt_fwd_length`` segments, one update each, a trailing
        partial segment included; LSTM h/c carry from one segment to the next
        with their gradient cut. With ``tbptt_back_length`` below the segment
        length, the first steps of a segment only advance h/c, without
        gradient, and the loss covers the last ``tbptt_back_length`` steps."""
        y = self._labels(ds.labels)
        fmask, lmask = self._mask(ds.features_mask), self._labels_mask(ds.labels_mask)
        T, L = x.shape[1], self.conf.tbptt_fwd_length
        back = int(self.conf.tbptt_back_length or 0)
        rnn = self._init_rnn_states(x.shape[0])
        for t0 in range(0, T, L):
            seg = slice(t0, t0 + min(L, T - t0))
            xs, ys = x[:, seg], y[:, seg]
            fm = None if fmask is None else fmask[:, seg]
            lm = None if lmask is None else lmask[:, seg]
            n = xs.shape[1]
            k = n if back <= 0 else min(back, n)
            if k < n:
                split = n - k
                with torch.no_grad():
                    _, self.state, rnn = self._forward(
                        self._cast_params(), xs[:, :split], self.state,
                        None if fm is None else fm[:, :split], rnn,
                        upto=len(self.conf.layers) - 1, train=True,
                        generator=self._generator)
                xs, ys = xs[:, split:], ys[:, split:]
                fm = None if fm is None else fm[:, split:]
                lm = None if lm is None else lm[:, split:]
            rnn = self._step(xs, ys, lm, fm, rnn)

    # --------------------------------------------------------------- pretrain
    def pretrain(self, data, epochs: int = 1, noise=None) -> "MultiLayerNetwork":
        """Layerwise unsupervised pretraining of the AutoEncoder, RBM and
        VariationalAutoencoder layers, bottom up (reference:
        MultiLayerNetwork.pretrain): each trains on the activations of the
        stack below it. ``noise`` as in :meth:`pretrain_layer`."""
        self.init()
        for i, layer in enumerate(self.conf.layers):
            if layer.is_pretrain_layer:
                self.pretrain_layer(i, data, epochs, noise)
        return self

    def pretrain_layer(self, layer_idx: int, data, epochs: int = 1, noise=None) -> None:
        """Train layer ``layer_idx`` alone on its ``pretrain_loss`` over the
        features of ``data`` (labels unused; reference: pretrainLayer): per
        batch, the inference forward of the layers below it (no gradient),
        then one update of the layer's params with a fresh updater built
        from ``conf.updater`` (Adam through the fused kernel), written in
        place. The noise of each batch comes from ``noise(layer_idx, layer,
        h)`` if given (the keyword arguments of ``pretrain_loss``: the seam
        through which a caller passes uniforms or eps), else from the
        network's generator. The captured step graphs are dropped
        afterwards, as the JAX package retires its compiled steps."""
        self.init()
        layer = self.conf.layers[layer_idx]
        if not layer.is_pretrain_layer:
            raise ValueError(f"layer {layer_idx} ({type(layer).__name__}) is not pretrainable")
        tx = UpdaterConfig.from_dict(self.conf.updater).build()
        leaves = [dict(self.layer_params[layer_idx].items())]
        opt_state = tx.init(leaves)
        flat = list(leaves[0].values())
        for _ in range(epochs):
            it = as_iterator(data)
            if hasattr(it, "reset"):
                it.reset()
            for ds in it:
                ds = ds if isinstance(ds, DataSet) else DataSet(*ds)
                with torch.no_grad():
                    h = self._forward(self._params(), self._input(ds.features), self.state,
                                      upto=layer_idx)[0]
                h = h.reshape(h.shape[0], -1) if h.dim() > 2 else h
                kwargs = (noise(layer_idx, layer, h) if noise is not None
                          else {"generator": self._generator})
                cast = {k: v.to(self.compute_dtype) for k, v in leaves[0].items()}
                loss = layer.pretrain_loss(cast, h, **kwargs)
                grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                            materialize_grads=True)
                _, opt_state, new = optimizer_update(tx, [dict(zip(leaves[0], grads))],
                                                     opt_state, leaves)
                with torch.no_grad():
                    for k, v in leaves[0].items():
                        v.copy_(new[0][k])
                self._compute_params = None
                self._last_loss = loss.detach()
        self._step_graphs.clear()

    # ------------------------------------------------------------- streaming
    def _init_rnn_states(self, batch: int):
        return tuple(
            layer.init_recurrent_state(batch, self.compute_dtype, self.device)
            if layer.is_recurrent and hasattr(layer, "init_recurrent_state")
            else {}
            for layer in self.conf.layers
        )

    @torch.no_grad()
    def rnn_time_step(self, x, features_mask=None) -> np.ndarray:
        """Stateful streaming inference. ``x`` is [batch, features] (one
        step) or [batch, time, features]; LSTM h/c persist across calls
        until :meth:`rnn_clear_previous_state`. With ``features_mask``
        [batch, time], masked steps hold h/c. On the bucketed path the time
        axis pads to a power of two with the mask extended, and h/c live in
        the network's streaming buffers for the batch size, which the
        replayed graph updates in place; ``DL4JTPU_INFER=legacy`` steps
        eagerly at the exact shape."""
        if _inf.fast_path_enabled():
            return _inf.mln_rnn_step(self, x, features_mask=features_mask)
        self.init()
        x = self._input(x)
        single_step = x.dim() == 2
        if single_step:
            x = x[:, None, :]
        state = self._rnn_state
        if state is None or any(st and st["h"].shape[0] != x.shape[0] for st in state):
            state = self._init_rnn_states(x.shape[0])
        out, _, self._rnn_state = self._forward(self._params(), x, self.state,
                                                self._mask(features_mask), state)
        if single_step and out.dim() == 3:
            out = out[:, 0, :]
        return to_host(out)

    def rnn_clear_previous_state(self) -> None:
        self._rnn_state = None

    def rnn_get_previous_state(self, layer_idx: int) -> Optional[dict]:
        """A copy of the layer's streaming state as a dict of device
        tensors (later steps do not change it)."""
        if self._rnn_state is None:
            return None
        st = self._rnn_state[layer_idx]
        return {k: v.clone() for k, v in st.items()} if st else None

    def rnn_set_previous_state(self, layer_idx: int, state_dict: dict) -> None:
        """Set the layer's streaming state; where it lives in the served
        graphs' buffers it is written into them in place."""
        if self._rnn_state is None:
            raise ValueError("No streaming state; call rnn_time_step first")
        new = {k: self._input(v).to(self.compute_dtype).contiguous()
               for k, v in state_dict.items()}
        cur = self._rnn_state[layer_idx]
        if any(self._rnn_state is bufs for bufs in self._infer_rnn.values()) and all(
                k in cur and cur[k].shape == v.shape for k, v in new.items()):
            with self._infer_lock, torch.no_grad():
                for k, v in new.items():
                    cur[k].copy_(v)
            return
        st = list(self._rnn_state)
        st[layer_idx] = new
        self._rnn_state = tuple(st)


__all__ = ["MultiLayerNetwork", "resolve_device", "to_host"]
