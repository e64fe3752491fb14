"""Versioned checkpoint store: durable model versions for the live loop
(counterpart of ``deeplearning4j_tpu/runtime/checkpoint.py``, over the
port's ``utils/serialization.write_model``).

The same on-disk contract as the JAX package's store:

- **Atomic versions.** Every save writes ``.tmp-v<NNNNNNNN>-<pid>`` in the
  store directory and ``os.replace``s it into ``model-v<NNNNNNNN>.zip`` — a
  reader (or a crash mid-write) can never observe a torn checkpoint.
  Version ids are monotonic across process restarts (the scan resumes
  after the largest id on disk).
- **Exact resume.** The container carries params, updater state, layer
  state, the iteration and epoch; the store adds the dropout generator's
  state (``torch.Generator.get_state()``) as an entry of its own,
  ``generator.npz``, listed in the manifest, so :meth:`load_into`/
  :meth:`restore` resume bit for bit, dropout draws included. It is not
  ``rng.npz``, the JAX package's PRNG-key entry: JAX would read the
  generator's bytes as a key. A JAX version restores here and keeps the
  port's generator (as JAX keeps its key for a plain ``write_model`` zip);
  a port version verifies and restores in the JAX package's store.
- **Retention.** ``retain`` bounds the directory: pruning happens after
  every successful save, oldest versions first, never the newest.
- **Non-blocking saves.** :meth:`snapshot` clones every tensor on the
  caller's current stream (an asynchronous copy on the card, no host
  sync) and records an event after the clones. :meth:`save_async` hands it
  to a background writer thread, whose stream waits on that event before
  its host copy, and marks each clone used by that stream
  (``record_stream``), so the allocator does not hand a clone's memory
  back while the writer reads it. The training loop never waits on the
  filesystem.
- **In-place rollback.** :meth:`load_into` copies a version into the LIVE
  network's own tensors — params, the updater state (the tensors the
  captured steps hold, ``_bind_statics``), layer state, ``iteration``/
  ``epoch`` and the generator's state — under the network's serving lock,
  as ``swap_params`` does. Rebinding them instead would leave every
  captured step graph and served graph reading the tensors of before the
  rollback: wrong results, and nothing would raise. Written in place, the
  network keeps its compile-manager token and every graph stays valid, so
  a rollback costs zero new captures.
- **Integrity + quarantine.** Every version carries a sha256-per-entry
  ``manifest.json`` written atomically with the zip. Restore paths
  (:meth:`restore`/:meth:`load_into`) verify the manifest before
  deserializing; a corrupt or torn version is **quarantined** (renamed
  ``*.quarantine``, counted in ``dl4jtpu_checkpoint_corrupt_total``, never
  re-scanned as a version but still counted by the id scan so version
  numbers stay monotonic) and the restore falls back to the newest good
  version. Stale ``.tmp-v*`` files left by a killed writer are swept to
  quarantine at store construction.

CUDA work here follows ``runtime.compile_manager``'s capture rule: the
snapshot, the writer's host copy and a rollback's load hold the capture
lock shared. What waits: the JAX store re-places a network on a
``MeshLayout``'s shardings; the port's networks have no layout until the
parallelism item (ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import re
import threading
import zipfile
from typing import Any, List, Optional

import numpy as np
import torch

from .compile_manager import capture_lock
from .resilience import Deadline, RetryPolicy

__all__ = ["CheckpointCorruptError", "CheckpointStore", "CheckpointInfo"]

_VERSION_RE = re.compile(r"^model-v(\d{8})\.zip$")
_QUARANTINE_RE = re.compile(r"^model-v(\d{8})\.zip\.quarantine$")
_TMP_RE = re.compile(r"^\.tmp-v(\d{8})-(\d+)$")

_MANIFEST_NAME = "manifest.json"
# the dropout generator's state (torch.Generator.get_state()), an entry of
# its own: the JAX package's rng.npz holds a PRNG key
_GENERATOR_NAME = "generator.npz"


class CheckpointCorruptError(RuntimeError):
    """A stored version failed integrity verification."""


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        pass  # e.g. EPERM: someone else's live process
    return True


def _version_filename(version: int) -> str:
    return f"model-v{int(version):08d}.zip"


class CheckpointInfo:
    """One stored version: id, path, and the container's meta."""

    __slots__ = ("version", "path", "iteration", "epoch", "model_class",
                 "bytes")

    def __init__(self, version: int, path: str, meta: dict, size: int):
        self.version = int(version)
        self.path = path
        self.iteration = int(meta.get("iteration", 0))
        self.epoch = int(meta.get("epoch", 0))
        self.model_class = meta.get("model_class")
        self.bytes = int(size)

    def to_dict(self) -> dict:
        return {"version": self.version, "path": self.path,
                "iteration": self.iteration, "epoch": self.epoch,
                "model_class": self.model_class, "bytes": self.bytes}


class _Snapshot:
    """Copies of everything a version holds, taken on the caller's thread.

    Tensors are cloned on the caller's current stream (asynchronous on the
    card: the caller does not wait) and an event is recorded after the
    clones (``ready``). The live tensors may be written by the very next
    replayed step; the clones are not. ``params``/``state`` are in
    ``swap_params``'s layouts, so the same snapshot feeds
    ``InferenceService.hot_swap``. :meth:`to_host` (the writer thread) makes
    its stream wait on ``ready`` before the host copy."""

    def __init__(self, model):
        model.init()
        with torch.no_grad(), capture_lock().shared():
            self._leaf_dicts = [{k: v.detach().clone() for k, v in layer.items()}
                                for layer in model._leaves()]
            self._opt = [t.clone() if isinstance(t, torch.Tensor) else t
                         for t in model.updater_state_leaves()]
            state = [{k: v.detach().clone() for k, v in d.items()}
                     for d in model._state_dicts()]
            self.params = model._params_from_leaves(self._leaf_dicts)
            self.state = model._state_layout(state)
            self._state_leaves = [d[k] for d in state for k in sorted(d)]
            self.generator = model._generator.get_state().clone()
            self.device = model.device
            self.ready = None
            if self.device.type == "cuda":
                self.ready = torch.cuda.Event()
                self.ready.record(torch.cuda.current_stream(self.device))
        self.conf = model.conf
        self.iteration = int(model.iteration)
        self.epoch = int(getattr(model, "epoch", 0))
        self.model_class = type(model).__name__

    def tensors(self) -> list:
        return ([v for d in self._leaf_dicts for v in d.values()]
                + [t for t in self._opt if isinstance(t, torch.Tensor)]
                + self._state_leaves)

    def wait_on(self, stream) -> None:
        """Order ``stream`` after the clones and mark each clone used by it
        (card only)."""
        if self.ready is None:
            return
        stream.wait_event(self.ready)
        for t in self.tensors():
            if t.device.type == "cuda":
                t.record_stream(stream)

    def to_host(self) -> "_Snapshot":
        """This snapshot with every tensor on the host (called on the writer
        thread; waits for the clones first)."""
        if self.ready is None:
            return self
        with torch.no_grad(), capture_lock().shared():
            self.wait_on(torch.cuda.current_stream(self.device))
            host = lambda t: t.cpu() if isinstance(t, torch.Tensor) else t  # noqa: E731
            out = _Snapshot.__new__(_Snapshot)
            out.__dict__.update(self.__dict__)
            out._leaf_dicts = [{k: host(v) for k, v in d.items()} for d in self._leaf_dicts]
            out._opt = [host(t) for t in self._opt]
            out._state_leaves = [host(t) for t in self._state_leaves]
            out.params = out.state = None
            out.ready = None
        return out

    # -- the write_model contract
    def init(self) -> "_Snapshot":
        return self

    def _leaves(self) -> list:
        return self._leaf_dicts

    def updater_state_leaves(self) -> list:
        return self._opt

    def state_leaves(self) -> list:
        return self._state_leaves


class CheckpointStore:
    """Directory of monotonic, atomically-written model versions."""

    def __init__(self, directory: str, *, retain: int = 5, registry=None,
                 chaos=None):
        if int(retain) < 1:
            raise ValueError(f"retain must be >= 1, got {retain}")
        self.directory = str(directory)
        self.retain = int(retain)
        self.chaos = chaos  # optional testing.chaos.FaultPlan hook
        os.makedirs(self.directory, exist_ok=True)
        self._lock = threading.Lock()
        self._next_version = self._scan_max() + 1
        self._writer: Optional[threading.Thread] = None
        self._write_error: Optional[BaseException] = None
        if registry is None:
            from ..telemetry import get_registry  # noqa: PLC0415

            registry = get_registry()
        self._m_saves = registry.counter(
            "dl4jtpu_online_checkpoints_total",
            "checkpoint versions written by the store")
        self._m_restores = registry.counter(
            "dl4jtpu_online_checkpoint_restores_total",
            "checkpoint restore/load_into operations")
        self._m_pruned = registry.counter(
            "dl4jtpu_online_checkpoints_pruned_total",
            "checkpoint versions removed by retention pruning")
        self._m_corrupt = registry.counter(
            "dl4jtpu_checkpoint_corrupt_total",
            "checkpoint versions quarantined after failing verification")
        self._io = RetryPolicy("checkpoint.io", max_attempts=3, base_s=0.05,
                               cap_s=1.0, retry_on=(OSError,),
                               registry=registry)
        self._sweep_stale_tmp()

    # ----------------------------------------------------------- directory
    def _scan_max(self) -> int:
        """Largest version id on disk — INCLUDING quarantined versions, so
        a quarantined id is never reissued to a new (different) save."""
        vmax = 0
        for name in os.listdir(self.directory):
            m = _VERSION_RE.match(name) or _QUARANTINE_RE.match(name)
            if m:
                vmax = max(vmax, int(m.group(1)))
        return vmax

    def _sweep_stale_tmp(self) -> int:
        """Quarantine ``.tmp-v*`` files whose writer pid is gone (a killed
        writer mid-``_write``). A live pid — including our own, which may
        carry an in-flight async writer from another store over this
        directory — is left alone. Returns the count swept."""
        swept = 0
        for name in sorted(os.listdir(self.directory)):
            m = _TMP_RE.match(name)
            if not m:
                continue
            if _pid_alive(int(m.group(2))):
                continue
            path = os.path.join(self.directory, name)
            try:
                os.replace(path, path + ".quarantine")
            except OSError:
                continue
            swept += 1
            self._m_corrupt.inc()
            self._flight("checkpoint_quarantined", file=name,
                         reason="stale temp file from dead writer")
        return swept

    def path(self, version: int) -> str:
        return os.path.join(self.directory, _version_filename(version))

    def _claim_version(self) -> int:
        """Next monotonic id: past both this store's counter AND whatever
        any other writer already put on disk (the rescan keeps concurrent
        stores over one directory from replacing each other's versions)."""
        with self._lock:
            version = max(self._next_version, self._scan_max() + 1)
            self._next_version = version + 1
            return version

    def versions(self) -> List[CheckpointInfo]:
        """All stored versions, oldest first (torn/foreign files ignored)."""
        out: List[CheckpointInfo] = []
        for name in sorted(os.listdir(self.directory)):
            m = _VERSION_RE.match(name)
            if not m:
                continue
            path = os.path.join(self.directory, name)
            try:
                with zipfile.ZipFile(path, "r") as zf:
                    meta = json.loads(zf.read("meta.json"))
                out.append(CheckpointInfo(int(m.group(1)), path, meta,
                                          os.path.getsize(path)))
            except Exception:  # noqa: BLE001 - a bad file is not a version
                continue
        return out

    def latest(self) -> Optional[CheckpointInfo]:
        vs = self.versions()
        return vs[-1] if vs else None

    def latest_version(self) -> int:
        """Newest version number, 0 when the store is empty — the poll
        primitive of the fleet's version-propagation bus (workers and the
        router compare it against what they serve)."""
        info = self.latest()
        return 0 if info is None else int(info.version)

    def artifact_path(self, filename: str) -> str:
        """Path for a sidecar artifact living NEXT TO the checkpoints
        (warm-boot bundles, notes). Sidecars never match _VERSION_RE, so
        version scans, retention pruning and restores ignore them."""
        if _VERSION_RE.match(filename):
            raise ValueError(
                f"{filename!r} would shadow a checkpoint version")
        return os.path.join(self.directory, filename)

    def wait_for_version(self, min_version: int, *,
                         timeout_s: float = 30.0,
                         poll_s: float = 0.25) -> Optional[CheckpointInfo]:
        """Block until the store publishes ``version >= min_version`` (the
        subscriber half of the checkpoint bus). Returns its info, or None
        on timeout. Polling, not inotify: the store is also written from
        other processes/filesystems where watches don't travel."""
        deadline = Deadline(timeout_s)
        while True:
            info = self.latest()
            if info is not None and info.version >= min_version:
                return info
            if not deadline.pace(poll_s):
                return None

    def stats(self) -> dict:
        """JSON-ready store view (the checkpoint listing of the trainer's
        ``stats()``)."""
        vs = self.versions()
        return {
            "directory": self.directory,
            "retain": self.retain,
            "versions": [v.to_dict() for v in vs],
            "latest_version": vs[-1].version if vs else None,
            "total_bytes": sum(v.bytes for v in vs),
        }

    # ---------------------------------------------------------------- save
    def _write(self, snapshot: _Snapshot, version: int) -> str:
        from ..utils.serialization import write_model  # noqa: PLC0415

        final = self.path(version)
        tmp = os.path.join(self.directory,
                           f".tmp-v{version:08d}-{os.getpid()}")

        snapshot = snapshot.to_host()

        def write_once():
            write_model(snapshot, tmp)
            with zipfile.ZipFile(tmp, "a", zipfile.ZIP_DEFLATED) as zf:
                # the generator's state rides as an extra container entry
                # so resume replays the exact dropout draws
                buf = io.BytesIO()
                np.savez(buf, state=snapshot.generator.numpy())
                zf.writestr(_GENERATOR_NAME, buf.getvalue())
                # sha256-per-entry manifest, inside the same atomic zip:
                # either the whole verified container lands or nothing does
                entries = {name: hashlib.sha256(zf.read(name)).hexdigest()
                           for name in zf.namelist()}
                zf.writestr(_MANIFEST_NAME, json.dumps(
                    {"algo": "sha256", "entries": entries}, sort_keys=True))
            os.replace(tmp, final)  # atomic: readers never see a torn file

        try:
            self._io.run(write_once)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        if self.chaos is not None:
            self.chaos.fire("checkpoint.write", path=final,
                            directory=self.directory, version=version)
        self._m_saves.inc()
        self._flight("online_checkpoint", version=version,
                     iteration=snapshot.iteration, path=final)
        self.prune()
        return final

    @staticmethod
    def snapshot(model) -> _Snapshot:
        """Capture a consistent snapshot of ``model`` NOW (clones on the
        caller's stream, no host sync). Hand it to :meth:`save`/
        :meth:`save_async` — and, in the live loop, the SAME snapshot to
        ``InferenceService.hot_swap`` (after ``wait_on`` the swap's stream),
        so the version on disk and the version serving are bit for bit the
        same."""
        return _Snapshot(model)

    def save(self, model) -> CheckpointInfo:
        """Write one version synchronously; returns its info. ``model`` may
        be a live net or a :meth:`snapshot`."""
        snapshot = model if isinstance(model, _Snapshot) else _Snapshot(model)
        version = self._claim_version()
        path = self._write(snapshot, version)
        return CheckpointInfo(version, path,
                              {"iteration": snapshot.iteration,
                               "epoch": snapshot.epoch,
                               "model_class": snapshot.model_class},
                              os.path.getsize(path))

    def save_async(self, model) -> int:
        """Snapshot now (clones on the caller's stream, no host sync), serialize on a
        background thread; returns the version id that WILL exist once the
        writer lands. One writer at a time: a still-running previous write
        is joined first (saves are ordered, never interleaved). ``model``
        may be a live net or a :meth:`snapshot`."""
        self.join()
        snapshot = model if isinstance(model, _Snapshot) else _Snapshot(model)
        version = self._claim_version()

        def work():
            try:
                self._write(snapshot, version)
            except BaseException as e:  # surfaced on the next join()
                self._write_error = e

        self._writer = threading.Thread(
            target=work, daemon=True, name=f"dl4jtpu-ckpt-v{version}")
        self._writer.start()
        return version

    def join(self, timeout: Optional[float] = None) -> None:
        """Wait for an in-flight async save; re-raises its error, if any."""
        w = self._writer
        if w is not None:
            w.join(timeout=timeout)
            self._writer = None
        if self._write_error is not None:
            err, self._write_error = self._write_error, None
            raise err

    def prune(self) -> int:
        """Drop oldest versions beyond ``retain``; returns the count."""
        vs = self.versions()
        extra = vs[:-self.retain] if len(vs) > self.retain else []
        removed = 0
        for info in extra:
            try:
                os.remove(info.path)
                removed += 1
            except OSError:
                continue
        if removed:
            self._m_pruned.inc(removed)
        return removed

    # ----------------------------------------------------------- integrity
    def verify(self, version: int) -> str:
        """Check a stored version against its sha256 manifest.

        Returns ``"ok"`` (manifest verified) or ``"legacy"`` (pre-manifest
        container — accepted, nothing to check against). Raises
        :class:`CheckpointCorruptError` on a torn zip, a digest mismatch,
        or a manifest that disagrees with the zip's entry list.
        """
        path = self.path(int(version))
        try:
            with zipfile.ZipFile(path, "r") as zf:
                names = set(zf.namelist())
                if _MANIFEST_NAME not in names:
                    zf.testzip()
                    return "legacy"
                manifest = json.loads(zf.read(_MANIFEST_NAME))
                entries = dict(manifest.get("entries") or {})
                extra = names - set(entries) - {_MANIFEST_NAME}
                missing = set(entries) - names
                if extra or missing:
                    raise CheckpointCorruptError(
                        f"v{version}: manifest/zip mismatch "
                        f"(extra={sorted(extra)}, missing={sorted(missing)})")
                for name, digest in entries.items():
                    got = hashlib.sha256(zf.read(name)).hexdigest()
                    if got != digest:
                        raise CheckpointCorruptError(
                            f"v{version}: sha256 mismatch in {name!r}")
        except CheckpointCorruptError:
            raise
        except Exception as e:  # BadZipFile, truncated read, bad json...
            raise CheckpointCorruptError(f"v{version}: unreadable ({e!r})") from e
        return "ok"

    def quarantine(self, version: int, reason: str = "") -> str:
        """Rename a version out of the scan set (``*.quarantine``); it is
        never served again but its id stays claimed (see `_scan_max`)."""
        path = self.path(int(version))
        target = path + ".quarantine"
        try:
            os.replace(path, target)
        except FileNotFoundError:
            # Lost a cross-process race: another store over the same
            # directory (a sibling fleet worker) quarantined it first.
            return target
        self._m_corrupt.inc()
        self._flight("checkpoint_quarantined", version=int(version),
                     reason=reason or "verification failed")
        return target

    def _disk_versions(self) -> List[int]:
        """Raw version ids on disk, ascending — unlike :meth:`versions`
        this does NOT silently skip unreadable files, so a fully garbled
        newest version is still seen (and can be quarantined)."""
        out = []
        for name in os.listdir(self.directory):
            m = _VERSION_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def _open_verified(self, version: Optional[int], *,
                       fallback: bool) -> tuple:
        """Resolve (version, path), verifying integrity first. A corrupt
        version is quarantined; with ``fallback`` the walk continues to
        the next-newest good version, without it the corruption raises."""
        if version is not None:
            path = self.path(int(version))
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"checkpoint version {version} not in {self.directory!r} "
                    f"(have {self._disk_versions()})")
            try:
                self.verify(int(version))
                return int(version), path
            except CheckpointCorruptError as e:
                self.quarantine(int(version), reason=str(e))
                if not fallback:
                    raise
        for v in reversed(self._disk_versions()):
            try:
                self.verify(v)
                return v, self.path(v)
            except CheckpointCorruptError as e:
                self.quarantine(v, reason=str(e))
        raise FileNotFoundError(
            f"checkpoint store {self.directory!r} holds no intact versions")

    # ------------------------------------------------------------- restore
    def restore(self, version: Optional[int] = None, *,
                fallback: Optional[bool] = None, device="cuda"):
        """Rebuild a FRESH model on ``device`` from a stored version
        (default: latest) — ``utils.serialization.restore_model`` plus the
        stored generator state. Verifies integrity first; a corrupt version
        is quarantined and, when no explicit version was pinned (or
        ``fallback=True``), the newest remaining good version is restored
        instead."""
        return self.restore_with_info(version, fallback=fallback, device=device)[0]

    def restore_with_info(self, version: Optional[int] = None, *,
                          fallback: Optional[bool] = None, device="cuda"):
        """:meth:`restore`, returning ``(model, CheckpointInfo)``: which
        version survived verification."""
        from ..utils.serialization import restore_model  # noqa: PLC0415

        if fallback is None:
            fallback = version is None
        version, path = self._open_verified(version, fallback=fallback)
        with capture_lock().shared():
            model = restore_model(path, device=device)
        self._load_generator(model, path)
        self._m_restores.inc()
        with zipfile.ZipFile(path, "r") as zf:
            meta = json.loads(zf.read("meta.json"))
        return model, CheckpointInfo(version, path, meta,
                                     os.path.getsize(path))

    def load_into(self, model, version: Optional[int] = None, *,
                  fallback: Optional[bool] = None) -> int:
        """Roll a LIVE model back to a stored version in place.

        Copies params, updater state, layer state, iteration/epoch and the
        generator's state into the model's own tensors (no ``init(force)``,
        no rebinding), under its serving lock: its captured step graphs and
        served graphs read the restored values at their next replay, its
        compile-manager token survives, and the rollback makes zero new
        captures. Verifies integrity first (corrupt → quarantine, and with
        ``fallback`` — the default when no version is pinned — the next good
        version loads instead). Returns the version actually loaded.
        """
        from ..nn.updaters import _leaves, _map, opt_state_from_leaves  # noqa: PLC0415
        from ..utils.serialization import _load_leaves  # noqa: PLC0415

        if fallback is None:
            fallback = version is None
        version, path = self._open_verified(version, fallback=fallback)
        model.init()
        updater = model._updater_ready()
        with zipfile.ZipFile(path, "r") as zf:
            meta = json.loads(zf.read("meta.json"))
            params = _load_leaves(zf, "coefficients.npz")
            opt_leaves = _load_leaves(zf, "updaterState.npz")
            state = _load_leaves(zf, "state.npz")
        gen = self._read_generator(path)
        live = [layer[k] for layer in model._leaves() for k in sorted(layer)]
        live_state = model.state_leaves()
        for what, got, want in (("param", params, live), ("state", state, live_state)):
            if len(got) != len(want):
                raise ValueError(f"v{version}: {len(got)} {what} leaves, the network "
                                 f"has {len(want)}")
            for a, t in zip(got, want):
                if tuple(a.shape) != tuple(t.shape):
                    raise ValueError(f"v{version}: {what} leaf of shape {tuple(a.shape)}, "
                                     f"the network's is {tuple(t.shape)}")
        new_opt = opt_state_from_leaves(updater, model._leaves(), opt_leaves)
        with model._infer_lock, capture_lock().shared(), torch.no_grad():
            for t, a in zip(live + live_state, params + state):
                t.copy_(torch.from_numpy(np.ascontiguousarray(a)))
            cur = _leaves(model._opt_state)
            for t, n in zip(cur, _leaves(new_opt)):
                t.copy_(n)
            it = iter(cur)
            # the counts are host ints: take the stored ones, keep the tensors
            model._opt_state = _map(lambda t: next(it), new_opt)
            model._compute_params = None
            model.iteration = int(meta.get("iteration", 0))
            model.epoch = int(meta.get("epoch", 0))
            if gen is not None:
                model._generator.set_state(gen)
            model._mark_written()
        self._m_restores.inc()
        self._flight("online_rollback_load", version=version,
                     iteration=model.iteration)
        return version

    @staticmethod
    def _read_generator(path: str):
        """The stored generator state, or None (a JAX version or a plain
        ``write_model`` zip)."""
        try:
            with zipfile.ZipFile(path, "r") as zf:
                with zf.open(_GENERATOR_NAME) as f:
                    data = np.load(io.BytesIO(f.read()))
                return torch.from_numpy(np.array(data["state"], np.uint8))
        except KeyError:
            return None

    @classmethod
    def _load_generator(cls, model, path: str) -> None:
        """Restore the dropout generator's state when the container carries
        one (others keep the model's generator)."""
        gen = cls._read_generator(path)
        if gen is not None:
            model._generator.set_state(gen)

    # ---------------------------------------------------------------- misc
    @staticmethod
    def _flight(kind: str, **payload: Any) -> None:
        try:
            from ..telemetry.flight_recorder import get_flight_recorder  # noqa: PLC0415

            get_flight_recorder().record(kind, **payload)
        except Exception:  # observability must never fail a checkpoint
            pass
