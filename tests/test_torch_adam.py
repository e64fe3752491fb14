"""The PyTorch port's Adam against the JAX package.

Per leaf, the plain version ``ops.adam.adam_update_reference`` is held
against the JAX package's ``fused_adam_update`` (its Pallas kernel in
interpret mode, as tests/test_kernel_select.py runs it) on the same numpy
inputs and scalars. Per update, the port's ``Updater`` for ``adam`` is held
against the JAX package's ``UpdaterConfig(updater="adam").build()`` on its
two paths: the fused one (``DL4JTPU_KERNELS=fused``; a spy proves that
``fused_adam_update`` ran) and plain ``optax.adam`` (``DL4JTPU_KERNELS=
reference``; the spy proves it did not). f32 is held at 1e-6 relative with
JAX in f32 mode (its bias corrections are f32 scalars there), f64 at 1e-12
in x64 mode. The state's leaves must be those of the optax state, in
``jax.tree_util`` order, for every updater the port runs. Tests marked
``cuda`` hold the CUDA kernel against the plain version and skip where there
is no card.
"""

import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import deeplearning4j_tpu as dj  # noqa: E402
import deeplearning4j_tpu.ops as jax_ops  # noqa: E402
from deeplearning4j_tpu.datasets.iterators import DataSet as JaxDataSet  # noqa: E402
from deeplearning4j_tpu.nn import updaters as jax_updaters  # noqa: E402
from deeplearning4j_tpu.ops import kernel_select  # noqa: E402
from deeplearning4j_tpu.ops.pallas_kernels import fused_adam_update as jax_adam  # noqa: E402

import deeplearning4j_tpu_torch as pt  # noqa: E402
from deeplearning4j_tpu_torch import ops  # noqa: E402
from deeplearning4j_tpu_torch.nn import updaters  # noqa: E402
from deeplearning4j_tpu_torch.ops import adam  # noqa: E402

TOL = {np.float32: 1e-6, np.float64: 1e-12}
DTYPES = [np.float32, np.float64]
B1, B2, EPS = 0.9, 0.999, 1e-8
# a scalar, below 128 elements, not a multiple of 128, exactly 128, 2-D
SHAPES = [(), (5,), (37,), (128,), (3, 100)]


def _x64(dtype):
    """JAX's mode for the dtype: f32 scalars for f32, x64 for f64."""
    return jax.enable_x64(dtype is np.float64)


def _close(got, want, dtype, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = TOL[dtype]
    atol = tol * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol, err_msg=name)


def _leaf(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=shape) * 0.1
    m = rng.normal(size=shape) * 0.01
    v = np.abs(rng.normal(size=shape)) * 1e-3
    return [np.asarray(a, dtype) for a in (g, m, v)]


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("count", [1, 3, 7])
def test_reference_matches_jax_kernel(shape, dtype, count):
    g, m, v = _leaf(shape, dtype, seed=count)
    lr = 2e-3
    bc1, bc2 = updaters.bias_corrections(count, B1, B2,
                                         torch.from_numpy(np.zeros(1, dtype)).dtype)
    with _x64(dtype):
        want = jax_adam(jnp.asarray(g), jnp.asarray(m), jnp.asarray(v), lr, bc1, bc2,
                        B1, B2, EPS)
    got = adam.adam_update_reference(*[torch.from_numpy(a) for a in (g, m, v)], lr,
                                     bc1, bc2, B1, B2, EPS)
    for name, gt, w in zip(("u", "m", "v"), got, want):
        assert tuple(gt.shape) == shape
        _close(gt.numpy(), w, dtype, name)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("count", [1, 2, 9])
def test_bias_corrections_match_jax(count, dtype):
    """1 - b**count in f32 for f32 leaves, f64 under x64, as
    _maybe_fused_adam computes them."""
    got = updaters.bias_corrections(count, B1, B2,
                                    torch.from_numpy(np.zeros(1, dtype)).dtype)
    with _x64(dtype):
        c = jnp.asarray(count, jnp.int32)
        want = [float(1.0 - jnp.asarray(b) ** c) for b in (B1, B2)]
    _close(got, want, dtype)


@pytest.fixture
def adam_spy(monkeypatch, tmp_path):
    """Select the JAX package's optimizer path by its own knob and count the
    calls of its fused Adam update."""
    monkeypatch.setenv("DL4JTPU_KERNEL_CALIBRATION", str(tmp_path / "calibration.json"))
    calls = []

    def spy(*args, **kwargs):
        calls.append(1)
        return jax_adam(*args, **kwargs)

    monkeypatch.setattr(jax_ops, "fused_adam_update", spy)

    def select(leg):
        monkeypatch.setenv("DL4JTPU_KERNELS", {"fused": "fused", "optax": "reference"}[leg])
        kernel_select.reset()
        return calls

    yield select
    kernel_select.reset()


def _tree(dtype, seed):
    """Params and grads as the JAX package's tuple of per-layer dicts (an
    empty layer included), in numpy."""
    rng = np.random.default_rng(seed)
    shapes = [{"W": (3, 5), "b": (5,)}, {}, {"RW": (130,), "pF": ()}]
    return tuple({k: np.asarray(rng.normal(size=s) * 0.3, dtype) for k, s in layer.items()}
                 for layer in shapes)


def _torch_tree(tree):
    return [{k: torch.from_numpy(np.array(v)) for k, v in layer.items()} for layer in tree]


@pytest.mark.parametrize("leg", ["fused", "optax"])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
def test_updater_matches_jax_adam(dtype, leg, adam_spy):
    calls = adam_spy(leg)
    cfg = {"updater": "adam", "learning_rate": 0.01, "beta1": 0.8, "beta2": 0.99,
           "epsilon": 1e-7, "lr_policy": "exponential", "lr_policy_decay_rate": 0.9}
    params = _tree(dtype, seed=0)
    ptx = pt.UpdaterConfig.from_dict(cfg).build()
    pparams = _torch_tree(params)
    pstate = ptx.init(pparams)
    with _x64(dtype):
        jtx = jax_updaters.UpdaterConfig.from_dict(cfg).build()
        jparams = jax.tree_util.tree_map(jnp.asarray, params)
        jstate = jtx.init(jparams)
        for step in range(3):
            grads = _tree(dtype, seed=10 + step)
            ju, jstate = jtx.update(jax.tree_util.tree_map(jnp.asarray, grads), jstate,
                                    jparams)
            jparams = optax.apply_updates(jparams, ju)
            pu, pstate = ptx.update(_torch_tree(grads), pstate)
            pparams = [{k: p[k] + u[k] for k in p} for p, u in zip(pparams, pu)]
            for jl, pl in zip(jax.tree_util.tree_leaves(ju), updaters._tree_leaves(pu)):
                _close(pl.numpy(), jl, dtype, f"update {step}")
        for jl, pl in zip(jax.tree_util.tree_leaves(jparams),
                          updaters._tree_leaves(pparams)):
            _close(pl.numpy(), jl, dtype, "params")
        jleaves = jax.tree_util.tree_leaves(jstate)
    pleaves = updaters.opt_state_leaves(pstate)
    assert len(pleaves) == len(jleaves) == 2 + 2 * 4
    for jl, pl in zip(jleaves, pleaves):
        assert pl.shape == jl.shape
        if pl.dtype == torch.int32:
            assert np.asarray(jl).dtype == np.int32 and int(pl) == int(jl) == 3
        else:
            _close(pl.numpy(), jl, dtype, "state")
    assert (len(calls) > 0) == (leg == "fused")
    if leg == "fused":
        assert len(calls) == 3 * 4  # one kernel per leaf and update


V, H, B, T = 11, 8, 3, 7
PORTED = [{"updater": "sgd", "learning_rate": 0.1},
          {"updater": "momentum", "learning_rate": 0.1, "momentum": 0.9},
          {"updater": "nesterovs", "learning_rate": 0.1, "momentum": 0.8},
          {"updater": "none"},
          {"updater": "adam", "learning_rate": 0.01}]


@pytest.mark.parametrize("cfg", PORTED, ids=lambda c: c["updater"])
def test_state_leaves_match_the_jax_net(cfg, adam_spy):
    """After one TBPTT batch in each package (3 updates), the port's state
    leaves are the JAX net's opt_state leaves: same count, order, shapes,
    dtypes and values; setting them back gives the same leaves."""
    adam_spy("fused")
    conf = pt.char_rnn(V, H, 2, tbptt_length=3)
    conf.updater = dict(cfg)
    jnet = dj.MultiLayerNetwork(dj.MultiLayerConfiguration.from_json(conf.to_json()))
    jnet.init()
    jnet.init(params=jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                            jnet.params), force=True)
    pnet = pt.load_jax_params(pt.MultiLayerNetwork(conf, device="cpu"),
                              [{k: np.asarray(v) for k, v in p.items()} for p in jnet.params])
    rng = np.random.default_rng(4)
    seq = rng.integers(0, V, (B, T + 1))
    x, y = np.eye(V, dtype=np.float32)[seq[:, :-1]], np.eye(V, dtype=np.float32)[seq[:, 1:]]
    jnet.fit(JaxDataSet(x, y))
    pnet.fit(pt.DataSet(x, y))
    jleaves = jax.tree_util.tree_leaves(jnet.opt_state)
    pleaves = pnet.updater_state_leaves()
    assert len(pleaves) == len(jleaves)
    for jl, pl in zip(jleaves, pleaves):
        jl = np.asarray(jl)
        assert tuple(pl.shape) == jl.shape
        assert str(pl.dtype).replace("torch.", "") == str(jl.dtype)
        np.testing.assert_allclose(pl.numpy(), jl, rtol=1e-5, atol=1e-6)
    pnet.set_updater_state_leaves(jleaves)
    for jl, pl in zip(jleaves, pnet.updater_state_leaves()):
        np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))


def test_state_leaves_refuse_a_mismatch():
    net = pt.MultiLayerNetwork(pt.char_rnn(V, H, 1), device="cpu").init()
    leaves = net.updater_state_leaves()
    assert len(leaves) == 2 + 2 * 8  # adam count, mu and nu of 8 leaves, schedule count
    with pytest.raises(ValueError, match="leaves"):
        net.set_updater_state_leaves(leaves[:-1])
    bad = list(leaves)
    bad[1] = np.zeros((2, 2), np.float32)
    with pytest.raises(ValueError, match="shape"):
        net.set_updater_state_leaves(bad)


# a scalar, an empty leaf, sizes around the kernel's float4 and 4096-element
# chunks, and 2-D leaves (one of them empty)
LEAF_SHAPES = [(), (0,), (1,), (3,), (5,), (4097,), (7, 9), (2, 0), (64, 33)]


def _leaves(shapes, dtype, seed):
    return [list(torch.from_numpy(a) for a in _leaf(s, dtype, seed + i))
            for i, s in enumerate(shapes)]


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
def test_grouped_update_equals_reference_leaf_by_leaf(dtype):
    """On the CPU the grouped call is the plain version per leaf, bit for
    bit, in the leaves' order and shapes."""
    leaves = _leaves(LEAF_SHAPES, dtype, seed=20)
    gs, ms, vs = (list(x) for x in zip(*leaves))
    before = ops.counters()["adam_update"]
    got = adam.fused_adam_update_leaves(gs, ms, vs, 1e-3, 0.19, 0.00299, B1, B2, EPS)
    assert ops.counters()["adam_update"] == before
    assert all(len(x) == len(LEAF_SHAPES) for x in got)
    for i, (g, m, v) in enumerate(leaves):
        want = adam.adam_update_reference(g, m, v, 1e-3, 0.19, 0.00299, B1, B2, EPS)
        for gt, w in zip((got[0][i], got[1][i], got[2][i]), want):
            assert gt.shape == w.shape and gt.dtype == w.dtype
            assert torch.equal(gt, w)
    assert adam.fused_adam_update_leaves([], [], [], 1e-3, 0.19, 0.00299, B1, B2,
                                         EPS) == ([], [], [])


def test_grouped_update_argument_checks():
    g = torch.zeros(4)
    args = (1e-3, 0.1, 0.001, B1, B2, EPS)
    with pytest.raises(ValueError, match="2 gradients"):
        adam.fused_adam_update_leaves([g, g], [g], [g], *args)
    with pytest.raises(ValueError, match="meta"):
        adam.fused_adam_update_leaves([g, g], [g, torch.zeros(4, device="meta")], [g, g],
                                      *args)
    with pytest.raises(ValueError, match=r"\(2, 2\)"):
        adam.fused_adam_update_leaves([g], [g], [torch.zeros(2, 2)], *args)
    # what the kernel takes, checked before a CUDA launch
    with pytest.raises(TypeError, match="float32"):
        adam._check_leaves([g], [g.double()], [g], kernel=True)
    with pytest.raises(ValueError, match="contiguous"):
        adam._check_leaves([g], [g], [torch.zeros(4, 2)[:, 0]], kernel=True)
    adam._check_leaves([g], [g], [g], kernel=True)
    adam._check_leaves([g], [g.double()], [torch.zeros(4, 2)[:, 0]], kernel=False)


def test_launch_table_as_the_c_entry_reads_it(monkeypatch):
    """The CUDA launch's host side on CPU tensors, with a stand-in for
    ``dl4j_adam_update_multi`` that reads the table of pointers and counts
    as the C entry does and runs the plain version on that memory: one call
    per MAX_LEAVES non-empty leaves, every output a 16-byte-aligned view of
    its leaf's shape, the same values as the plain version."""
    calls = []

    def entry(g, m, v, u, m2, v2, n, k, lr, bc1, bc2, b1, omb1, b2, omb2, eps):
        assert (omb1, omb2) == (1.0 - b1, 1.0 - b2)
        ptrs = [list((ctypes.c_int64 * k).from_address(a)) for a in (g, m, v, u, m2, v2, n)]
        calls.append(k)
        for j in range(k):
            arr = [torch.from_numpy(np.ctypeslib.as_array(
                (ctypes.c_float * ptrs[6][j]).from_address(p[j]))) for p in ptrs[:6]]
            for out, val in zip(arr[3:], adam.adam_update_reference(
                    *arr[:3], lr, bc1, bc2, b1, b2, eps)):
                out.copy_(val)
        return 0

    def launch(counts, name, fn, device, *a):
        assert fn(*a) == 0
        counts[name] += 1

    monkeypatch.setattr(adam._build, "bind", lambda *a: entry)
    monkeypatch.setattr(adam._build, "launch", launch)
    shapes = LEAF_SHAPES + [(11,)] * adam.MAX_LEAVES
    leaves = _leaves(shapes, np.float32, seed=30)
    gs, ms, vs = (list(x) for x in zip(*leaves))
    before = ops.counters()["adam_update"]
    got = adam._launch(gs, ms, vs, 1e-3, 0.19, 0.00299, B1, B2, EPS)
    live = sum(1 for s in shapes if np.prod(s, dtype=int) > 0)
    assert calls == [adam.MAX_LEAVES, live - adam.MAX_LEAVES]
    assert ops.counters()["adam_update"] == before + 2
    for i, (g, m, v) in enumerate(leaves):
        want = adam.adam_update_reference(g, m, v, 1e-3, 0.19, 0.00299, B1, B2, EPS)
        for gt, w in zip((got[0][i], got[1][i], got[2][i]), want):
            assert gt.shape == w.shape and gt.is_contiguous()
            assert gt.numel() == 0 or gt.data_ptr() % 16 == 0
            assert torch.equal(gt, w)


# ------------------------------------------------------------------- card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 5, 128, 1001, 1 << 20])
def test_cuda_adam_kernel_matches_plain(cuda_device, n):
    """Aligned leaves, and views that start one element in (no 16-byte
    loads), against the plain version on the same tensors."""
    g, m, v = (torch.as_tensor(a, device=cuda_device)
               for a in _leaf((n + 1,), np.float32, seed=n))
    for sl in (slice(0, n), slice(1, n + 1)):
        args = (g[sl], m[sl], v[sl], 1e-3, 0.19, 0.00299, B1, B2, EPS)
        before = ops.counters()["adam_update"]
        got = ops.fused_adam_update(*args)
        want = adam.adam_update_reference(*args)
        torch.cuda.synchronize()
        assert ops.counters()["adam_update"] == before + 1
        for gt, w in zip(got, want):
            torch.testing.assert_close(gt, w, rtol=1e-6, atol=1e-9)


@pytest.mark.cuda
def test_cuda_grouped_update_launches_once_per_max_leaves(cuda_device):
    """More than MAX_LEAVES leaves, one of them a view one float into its
    storage (no 16-byte loads) and two empty: two launches, every output
    equal to the plain version's on the same tensors."""
    shapes = LEAF_SHAPES + [(1 << 20,)] + [(11,)] * adam.MAX_LEAVES
    leaves = [[t.to(cuda_device) for t in leaf] for leaf in _leaves(shapes, np.float32, 40)]
    g, m, v = (torch.as_tensor(a, device=cuda_device) for a in _leaf((1024,), np.float32, 7))
    leaves.append([g[1:], m[1:], v[1:]])
    gs, ms, vs = (list(x) for x in zip(*leaves))
    before = ops.counters()["adam_update"]
    got = adam.fused_adam_update_leaves(gs, ms, vs, 1e-3, 0.19, 0.00299, B1, B2, EPS)
    torch.cuda.synchronize()
    assert ops.counters()["adam_update"] == before + 2
    for i, (g, m, v) in enumerate(leaves):
        want = adam.adam_update_reference(g, m, v, 1e-3, 0.19, 0.00299, B1, B2, EPS)
        for gt, w in zip((got[0][i], got[1][i], got[2][i]), want):
            assert gt.shape == w.shape
            torch.testing.assert_close(gt, w, rtol=1e-6, atol=1e-9)


@pytest.mark.cuda
def test_cuda_adam_kernel_refuses_bf16(cuda_device):
    g = torch.zeros(4, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(TypeError, match="float32"):
        ops.fused_adam_update(g, g, g, 1e-3, 0.1, 0.001, B1, B2, EPS)


def test_cpu_tensors_take_the_plain_version():
    g, m, v = (torch.from_numpy(a) for a in _leaf((6,), np.float32, seed=1))
    before = ops.counters()["adam_update"]
    got = ops.fused_adam_update(g, m, v, 1e-3, 0.1, 0.001, B1, B2, EPS)
    want = adam.adam_update_reference(g, m, v, 1e-3, 0.1, 0.001, B1, B2, EPS)
    assert ops.counters()["adam_update"] == before
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

