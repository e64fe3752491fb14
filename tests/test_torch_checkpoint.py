"""Checkpoints of the PyTorch port in the JAX package's zip layout.

A zip that the JAX package writes mid-training restores in the port, and a
zip that the port writes restores in the JAX package; either way the
restored net takes the next updates as the writer would have: the same
losses and params at 1e-5 (f32), because params, Adam moments and both
counts carried over. Port to port is exact, bf16 included. The nets train
the char-RNN recipe: Adam, TBPTT, padded batches of the bucketing iterator.
Tests marked ``cuda`` save and resume on the card and skip where there is
none.
"""

import json
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deeplearning4j_tpu as dj  # noqa: E402
from deeplearning4j_tpu.datasets.iterators import DataSet as JaxDataSet  # noqa: E402
from deeplearning4j_tpu.ops import kernel_select  # noqa: E402
from deeplearning4j_tpu.utils import serialization as jax_serialization  # noqa: E402

import deeplearning4j_tpu_torch as pt  # noqa: E402

V, H, B, T, TBPTT = 11, 8, 3, 7, 3
ATOL = RTOL = 1e-5
ADAM = {"updater": "adam", "learning_rate": 0.01}


@pytest.fixture(autouse=True)
def jax_fused(monkeypatch, tmp_path):
    """The JAX package on its Pallas kernels (interpret mode) and fused
    Adam."""
    monkeypatch.setenv("DL4JTPU_KERNEL_CALIBRATION", str(tmp_path / "calibration.json"))
    monkeypatch.setenv("DL4J_TPU_PALLAS", "seq")
    monkeypatch.setenv("DL4JTPU_KERNELS", "fused")
    kernel_select.reset()
    yield
    kernel_select.reset()


def _conf(dtype="float32", params_dtype=None):
    conf = pt.char_rnn(V, H, 2, tbptt_length=TBPTT, dtype=dtype)
    conf.updater = dict(ADAM)
    conf.params_dtype = params_dtype
    return conf


def _batches(n, seed):
    """``n`` padded, masked batches of the bucketing iterator."""
    rng = np.random.default_rng(seed)
    seqs = []
    for _ in range(n * B):
        seq = rng.integers(0, V, int(rng.integers(3, T + 2)))
        seqs.append((np.eye(V, dtype=np.float32)[seq[:-1]],
                     np.eye(V, dtype=np.float32)[seq[1:]]))
    return list(pt.BucketingSequenceIterator(seqs, batch=B, boundaries=(T,)))


class Recorder:
    def __init__(self):
        self.losses = []

    def iteration_done(self, model, iteration, loss):
        self.losses.append(float(loss))


def _f32(tree):
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if jnp.issubdtype(a.dtype, jnp.floating) else a,
        tree)


def _jax_net(conf):
    jnet = dj.MultiLayerNetwork(dj.MultiLayerConfiguration.from_json(conf.to_json()))
    jnet.init()
    return jnet.init(params=_f32(jnet.params), force=True)


def _fit(net, batches, jax_side=False):
    for ds in batches:
        net.fit(JaxDataSet(ds.features, ds.labels, ds.features_mask, ds.labels_mask)
                if jax_side else ds)


def _same_next_updates(jnet, pnet, batch):
    """Both nets take the updates of ``batch``: the same losses and params."""
    for net in (jnet, pnet):
        net.set_listeners(Recorder())
    _fit(jnet, [batch], jax_side=True)
    _fit(pnet, [batch])
    jl, pl = jnet.listeners[0].losses, pnet.listeners[0].losses
    assert len(jl) == len(pl) == -(-batch.features.shape[1] // TBPTT)
    np.testing.assert_allclose(pl, jl, atol=ATOL, rtol=RTOL)
    assert pnet.iteration == jnet.iteration
    for jp, pp in zip(jnet.params, pt.params_to_numpy(pnet)):
        for k in jp:
            np.testing.assert_allclose(pp[k], np.asarray(jp[k], np.float32), atol=ATOL,
                                       rtol=RTOL, err_msg=k)


def test_jax_zip_restores_in_the_port_and_trains_on(tmp_path):
    batches = _batches(3, seed=1)
    jnet = _jax_net(_conf())
    _fit(jnet, batches[:2], jax_side=True)
    path = str(tmp_path / "jax.zip")
    jax_serialization.write_model(jnet, path)
    pnet = pt.restore_model(path, device="cpu")
    assert (pnet.iteration, pnet.epoch) == (jnet.iteration, jnet.epoch) != (0, 0)
    for jp, pp in zip(jnet.params, pt.params_to_numpy(pnet)):
        for k in jp:
            np.testing.assert_array_equal(pp[k], np.asarray(jp[k]))
    jleaves = jax.tree_util.tree_leaves(jnet.opt_state)
    for jl, pl in zip(jleaves, pnet.updater_state_leaves()):
        np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    assert int(jleaves[0]) == jnet.iteration  # the Adam count came along
    _same_next_updates(jnet, pnet, batches[2])
    # load_jax_model_zip is the same reader
    again = pt.load_jax_model_zip(path, device="cpu")
    assert again.iteration == int(jleaves[0])


def test_port_zip_restores_in_jax_and_trains_on(tmp_path):
    batches = _batches(3, seed=2)
    pnet = pt.MultiLayerNetwork(_conf(), device="cpu").init()
    _fit(pnet, batches[:2])
    path = str(tmp_path / "port.zip")
    pt.write_model(pnet, path)
    with zipfile.ZipFile(path) as zf:
        assert sorted(zf.namelist()) == ["coefficients.npz", "configuration.json",
                                         "meta.json", "state.npz", "updaterState.npz"]
        assert json.loads(zf.read("meta.json")) == {
            "model_class": "MultiLayerNetwork", "iteration": pnet.iteration, "epoch": 2}
    jnet = jax_serialization.restore_model(path)
    jnet.params, jnet.opt_state = _f32(jnet.params), _f32(jnet.opt_state)
    assert jnet.iteration == pnet.iteration
    for jl, pl in zip(jax.tree_util.tree_leaves(jnet.opt_state), pnet.updater_state_leaves()):
        assert np.asarray(jl).dtype == pl.numpy().dtype
        np.testing.assert_array_equal(np.asarray(jl), pl.numpy())
    _same_next_updates(jnet, pnet, batches[2])


@pytest.mark.parametrize("dtype,params_dtype", [("float32", None), ("bfloat16", None),
                                                ("bfloat16", "bfloat16")])
def test_port_zip_round_trip_is_exact(dtype, params_dtype, tmp_path):
    """Write, restore, and the restored net takes the very updates of the
    one that went on: bf16 leaves widen to f32 in the zip and come back."""
    batches = _batches(3, seed=3)
    net = pt.MultiLayerNetwork(_conf(dtype, params_dtype), device="cpu").init()
    _fit(net, batches[:2])
    path = str(tmp_path / "net.zip")
    pt.write_model(net, path)
    back = pt.restore_model(path, device="cpu")
    assert back.params_dtype == net.params_dtype
    for a, b in zip(net.updater_state_leaves(), back.updater_state_leaves()):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for n in (net, back):
        n.set_listeners(Recorder())
        _fit(n, batches[2:])
    assert net.listeners[0].losses == back.listeners[0].losses
    for a, b in zip(net.layer_params, back.layer_params):
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_restore_refuses_what_it_cannot_load(tmp_path):
    net = pt.MultiLayerNetwork(_conf(), device="cpu").init()
    good = str(tmp_path / "good.zip")
    pt.write_model(net, good)
    with zipfile.ZipFile(good) as zf:
        entries = {n: zf.read(n) for n in zf.namelist()}

    def variant(name, **changes):
        path = str(tmp_path / name)
        with zipfile.ZipFile(path, "w") as zf:
            for n, data in {**entries, **changes}.items():
                zf.writestr(n, data)
        return path

    other = variant("other.zip", **{"meta.json": json.dumps({"model_class": "Word2Vec"})})
    with pytest.raises(ValueError, match="not ported"):
        pt.restore_model(other, device="cpu")
    short = variant("short.zip", **{"updaterState.npz": entries["state.npz"]})
    with pytest.raises(ValueError, match="updater state leaves"):
        pt.restore_model(short, device="cpu")
    (tmp_path / "bad.zip").write_bytes(b"not a zip")
    with pytest.raises(zipfile.BadZipFile):
        pt.restore_model(str(tmp_path / "bad.zip"), device="cpu")


# ------------------------------------------------------------------- card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_resume_is_exact(cuda_device, tmp_path):
    """Saved and restored on the card, the net takes the very updates of the
    one that went on (the kernels use no atomics); restored on the CPU, the
    same params."""
    batches = _batches(3, seed=4)
    net = pt.MultiLayerNetwork(_conf(), device=cuda_device).init()
    _fit(net, batches[:2])
    path = str(tmp_path / "card.zip")
    pt.write_model(net, path)
    back = pt.restore_model(path, device=cuda_device)
    cpu = pt.restore_model(path, device="cpu")
    for a, b in zip(pt.params_to_numpy(net), pt.params_to_numpy(cpu)):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    for n in (net, back):
        _fit(n, batches[2:])
    for a, b in zip(net.layer_params, back.layer_params):
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
