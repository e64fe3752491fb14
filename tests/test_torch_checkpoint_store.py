"""The port's versioned ``CheckpointStore`` (``runtime/checkpoint.py``)
against the JAX package's.

- The on-disk contract: ``model-v%08d.zip`` versions, atomic writes (no
  ``.tmp-v*`` left), retention, ids monotonic across stores and past
  quarantine, the stale-tmp sweep, quarantine with fallback, the
  sha256-per-entry manifest (``verify``: ok, legacy, corrupt).
- Versions cross both ways: a port version verifies and restores in JAX's
  store (``restore`` and ``load_into``), a JAX version in the port's.
  Params, updater state, layer state (BatchNormalization) and
  ``iteration`` are held at 1e-6; a JAX version keeps the port's dropout
  generator (its ``rng.npz`` is a PRNG key), a port version keeps JAX's
  key (the port writes ``generator.npz``).
- Port to port is exact, the generator included, with dropout on: a run
  resumed from a version (``restore``, or ``load_into`` on a live network
  that trained on) continues bit for bit like the run that was never
  stopped.
- ``load_into`` writes in place: every live tensor keeps its
  ``data_ptr()``, and the next staged window gives the losses of a
  network freshly restored from the same version.
"""

import os
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import deeplearning4j_tpu as dj  # noqa: E402
from deeplearning4j_tpu.runtime import checkpoint as jckpt  # noqa: E402
from deeplearning4j_tpu.telemetry import MetricsRegistry as JRegistry  # noqa: E402

import deeplearning4j_tpu_torch as pt  # noqa: E402
from deeplearning4j_tpu_torch.runtime import checkpoint as pckpt  # noqa: E402
from deeplearning4j_tpu_torch.telemetry import MetricsRegistry  # noqa: E402
from deeplearning4j_tpu_torch.testing import corrupt_file  # noqa: E402

ATOL = 1e-6


def _conf(pkg, dropout=0.0, bn=True, seed=7):
    layers = [pkg.DenseLayer(n_out=16, activation="tanh", dropout=dropout)]
    if bn:
        layers.append(pkg.BatchNormalization())
    layers.append(pkg.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
    u = pkg.UpdaterConfig(updater="adam", learning_rate=1e-2)
    return pkg.MultiLayerConfiguration(layers=layers, input_type=pkg.InputType.feed_forward(5),
                                       updater=u if pkg is dj else u.to_dict(), seed=seed)


def _windows(seed, k=2, b=8):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(k, b, 5)).astype(np.float32)
    ys = np.eye(3, dtype=np.float32)[rng.integers(0, 3, size=(k, b))]
    return xs, ys


def _port_net(**kw):
    net = pt.MultiLayerNetwork(_conf(pt, **kw), device="cpu").init()
    net.fit_on_device(*_windows(0), steps=3)  # updater and layer state that moved
    return net


def _pstore(path, **kw):
    return pckpt.CheckpointStore(str(path), registry=MetricsRegistry(), **kw)


def _jstore(path, **kw):
    return jckpt.CheckpointStore(str(path), registry=JRegistry(), **kw)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=ATOL, rtol=ATOL, err_msg=what)


def _assert_port_matches_jax(pnet, jnet):
    jp = jax.tree_util.tree_leaves(jnet.params)
    pp = [layer[k] for layer in pnet._leaves() for k in sorted(layer)]
    assert len(jp) == len(pp)
    for i, (j, p) in enumerate(zip(jp, pp)):
        _close(p.detach(), j, f"param {i}")
    js, ps = jax.tree_util.tree_leaves(jnet.state), pnet.state_leaves()
    assert len(js) == len(ps) > 0
    for i, (j, p) in enumerate(zip(js, ps)):
        _close(p, j, f"state {i}")
    jo, po = jax.tree_util.tree_leaves(jnet.opt_state), pnet.updater_state_leaves()
    assert len(jo) == len(po)
    for i, (j, p) in enumerate(zip(jo, po)):
        _close(p, j, f"updater {i}")
    assert pnet.iteration == int(jnet.iteration)


def _assert_same(a, b):
    for x, y in zip([v for l in a._leaves() for v in l.values()],
                    [v for l in b._leaves() for v in l.values()]):
        assert torch.equal(x, y)
    for x, y in zip(a.state_leaves() + a.updater_state_leaves(),
                    b.state_leaves() + b.updater_state_leaves()):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))
    assert a.iteration == b.iteration
    assert torch.equal(a._generator.get_state(), b._generator.get_state())


# ------------------------------------------------------------ the contract
def test_versions_retention_and_atomic_writes(tmp_path):
    store = _pstore(tmp_path, retain=3)
    net = _port_net()
    infos = [store.save(net) for _ in range(5)]
    assert [i.version for i in infos] == [1, 2, 3, 4, 5]
    assert [v.version for v in store.versions()] == [3, 4, 5]
    assert store.latest_version() == 5 and store.latest().iteration == 3
    assert sorted(os.listdir(tmp_path)) == [f"model-v{v:08d}.zip" for v in (3, 4, 5)]
    v = store.save_async(net)
    store.join()
    assert v == 6 and store.wait_for_version(6, timeout_s=1.0).version == 6
    assert store.wait_for_version(7, timeout_s=0.05, poll_s=0.01) is None
    stats = store.stats()
    assert stats["latest_version"] == 6 and stats["retain"] == 3
    assert stats["total_bytes"] == sum(os.path.getsize(i["path"]) for i in stats["versions"])
    with pytest.raises(ValueError, match="retain"):
        _pstore(tmp_path / "x", retain=0)
    with pytest.raises(ValueError, match="shadow"):
        store.artifact_path("model-v00000009.zip")


def test_on_disk_names_and_manifest_match_jax(tmp_path):
    """Both stores name and list their files alike; each version's manifest
    covers every entry (the port's adds generator.npz where JAX has
    rng.npz), and each store verifies the other's versions."""
    jnet = dj.MultiLayerNetwork(_conf(dj)).init()
    pnet = _port_net()
    js, ps = _jstore(tmp_path / "j", retain=2), _pstore(tmp_path / "p", retain=2)
    for _ in range(3):
        js.save(jnet)
        ps.save(pnet)
    assert sorted(os.listdir(tmp_path / "j")) == sorted(os.listdir(tmp_path / "p"))
    with zipfile.ZipFile(ps.path(3)) as zf:
        names = set(zf.namelist())
    with zipfile.ZipFile(js.path(3)) as zf:
        jnames = set(zf.namelist())
    assert names - jnames == {"generator.npz"} and jnames - names == {"rng.npz"}
    cross_j, cross_p = _jstore(tmp_path / "p"), _pstore(tmp_path / "j")
    assert cross_j.verify(3) == ps.verify(3) == cross_p.verify(3) == js.verify(3) == "ok"


def test_ids_monotonic_past_quarantine_and_across_stores(tmp_path):
    a = _pstore(tmp_path)
    net = _port_net()
    a.save(net)
    a.save(net)
    a.quarantine(2, reason="test")
    b = _pstore(tmp_path)
    assert b.save(net).version == 3  # the quarantined id stays claimed
    assert a.save(net).version == 4  # the rescan sees b's version
    assert [v.version for v in a.versions()] == [1, 3, 4]
    assert "model-v00000002.zip.quarantine" in os.listdir(tmp_path)


def test_stale_tmp_from_a_dead_writer_is_swept(tmp_path):
    dead = tmp_path / f".tmp-v00000004-{2**22 + 1}"
    live = tmp_path / f".tmp-v00000005-{os.getpid()}"
    for f in (dead, live):
        f.write_bytes(b"torn")
    for make in (_jstore, _pstore):
        make(tmp_path)
    assert (tmp_path / (dead.name + ".quarantine")).exists() and not dead.exists()
    assert live.exists()


@pytest.mark.parametrize("how", ["corrupt", "truncate"])
def test_corrupt_latest_is_quarantined_and_restore_falls_back(tmp_path, how):
    store = _pstore(tmp_path)
    net = _port_net()
    store.save(net)
    net.fit_on_device(*_windows(1), steps=2)
    store.save(net)
    if how == "corrupt":
        corrupt_file(store.path(2), seed=3, n_bytes=64)
    else:
        with open(store.path(2), "r+b") as fh:
            fh.truncate(os.path.getsize(store.path(2)) // 2)
    with pytest.raises(pckpt.CheckpointCorruptError):
        store.verify(2)
    restored, info = store.restore_with_info(device="cpu")
    assert info.version == 1 and restored.iteration == 3
    assert (tmp_path / "model-v00000002.zip.quarantine").exists()
    assert store.load_into(net) == 1 and net.iteration == 3


def test_pinned_corrupt_version_raises_and_empty_store(tmp_path):
    store = _pstore(tmp_path)
    net = _port_net()
    store.save(net)
    store.save(net)
    corrupt_file(store.path(2), seed=1)
    with pytest.raises(pckpt.CheckpointCorruptError):
        store.load_into(net, 2)
    assert store.latest_version() == 1
    with pytest.raises(FileNotFoundError):
        store.restore(7, device="cpu")
    with pytest.raises(FileNotFoundError, match="no intact"):
        _pstore(tmp_path / "empty").restore(device="cpu")


def test_legacy_container_verifies_as_legacy(tmp_path):
    net = _port_net()
    pt.write_model(net, str(tmp_path / "model-v00000001.zip"))
    store, jstore = _pstore(tmp_path), _jstore(tmp_path)
    assert store.verify(1) == jstore.verify(1) == "legacy"
    before = net._generator.get_state().clone()
    restored = store.restore(device="cpu")
    assert torch.equal(restored._generator.get_state(), before)  # no generator entry
    _assert_same_params(restored, net)


def _assert_same_params(a, b):
    for x, y in zip([v for l in a._leaves() for v in l.values()],
                    [v for l in b._leaves() for v in l.values()]):
        assert torch.equal(x, y)


# ------------------------------------------------------ across the packages
def test_port_version_restores_in_jax(tmp_path):
    pnet = _port_net()
    _pstore(tmp_path).save(pnet)
    jstore = _jstore(tmp_path)
    _assert_port_matches_jax(pnet, jstore.restore())
    live = dj.MultiLayerNetwork(_conf(dj)).init()
    key = np.asarray(live._rng).copy()
    assert jstore.load_into(live) == 1
    _assert_port_matches_jax(pnet, live)
    np.testing.assert_array_equal(np.asarray(live._rng), key)  # no rng.npz: JAX's key stays


def test_jax_version_restores_in_port(tmp_path):
    jnet = dj.MultiLayerNetwork(_conf(dj)).init()
    jnet.fit_on_device(*_windows(2), steps=3)
    _jstore(tmp_path).save(jnet)
    store = _pstore(tmp_path)
    _assert_port_matches_jax(store.restore(device="cpu"), jnet)
    live = _port_net()
    gen = live._generator.get_state().clone()
    ptrs = [t.data_ptr() for t in _live_tensors(live)]
    assert store.load_into(live) == 1
    _assert_port_matches_jax(live, jnet)
    assert [t.data_ptr() for t in _live_tensors(live)] == ptrs
    assert torch.equal(live._generator.get_state(), gen)  # rng.npz is JAX's key: ignored


# ------------------------------------------------------- port to port
def _live_tensors(net):
    from deeplearning4j_tpu_torch.nn.updaters import _leaves

    return ([v for l in net._leaves() for v in l.values()] + _leaves(net._opt_state)
            + [t for d in net._state_dicts() for t in d.values()])


@pytest.mark.parametrize("how", ["restore", "load_into"])
def test_port_resume_is_exact_with_dropout(tmp_path, how):
    """Dropout 0.5: the run resumed from a version continues bit for bit
    like the one that was never stopped (params, state, updater, iteration,
    generator, losses)."""
    xs, ys = _windows(4)
    store = _pstore(tmp_path)
    net = _port_net(dropout=0.5)
    store.save_async(net)
    store.join()
    want = net.fit_on_device(xs, ys, steps=4)
    if how == "restore":
        other = store.restore(device="cpu")
    else:
        other = pt.MultiLayerNetwork(_conf(pt, dropout=0.5), device="cpu").init()
        other.fit_on_device(*_windows(9), steps=5)  # a live net that moved on
        store.load_into(other)
    got = other.fit_on_device(xs, ys, steps=4)
    np.testing.assert_array_equal(got, want)
    _assert_same(other, net)


def test_load_into_writes_in_place_and_matches_a_fresh_restore(tmp_path):
    """The staged loop's captured tensors (``_bind_statics``) are the ones
    written: every live tensor keeps its address, and the next staged
    window's losses equal those of a network restored from the version."""
    xs, ys = _windows(6)
    store = _pstore(tmp_path)
    net = _port_net(dropout=0.3)
    store.save(net)
    net.fit_on_device(*_windows(7), steps=3)
    ptrs = [t.data_ptr() for t in _live_tensors(net)]
    statics = [t.data_ptr() for t in net._statics[0] + net._statics[1]]
    token = net._cm_token
    store.load_into(net)
    assert [t.data_ptr() for t in _live_tensors(net)] == ptrs
    assert [t.data_ptr() for t in net._statics[0] + net._statics[1]] == statics
    assert net._cm_token == token
    fresh = store.restore(device="cpu")
    np.testing.assert_array_equal(net.fit_on_device(xs, ys, steps=3),
                                  fresh.fit_on_device(xs, ys, steps=3))
    _assert_same(net, fresh)


def test_snapshot_is_taken_now(tmp_path):
    """A snapshot holds the values at its making: training after it does
    not reach the version written from it later."""
    store = _pstore(tmp_path)
    net = _port_net()
    snap = store.snapshot(net)
    before = [l[k].detach().clone() for l in net._leaves() for k in sorted(l)]
    net.fit_on_device(*_windows(8), steps=2)
    store.save(snap)
    back = store.restore(device="cpu")
    for a, b in zip([l[k] for l in back._leaves() for k in sorted(l)], before):
        assert torch.equal(a, b)
    assert back.iteration == 3
