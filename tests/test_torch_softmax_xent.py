"""The PyTorch port's softmax cross-entropy and loss catalog against the JAX
package.

``SoftmaxXentFunction`` (value and both gradients) is held against the JAX
``fused_softmax_xent`` with its Pallas kernels in interpret mode, and the
plain backward against ``_sxent_bwd`` directly; each loss of the port's
catalog against the JAX loss of the same name. The same numpy inputs go to
both: f64 at 1e-9, f32 at 1e-5. Tests marked ``cuda`` hold the CUDA kernels
against the plain versions and skip where there is no card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.nn import losses as jax_losses  # noqa: E402
from deeplearning4j_tpu.ops.pallas_kernels import (  # noqa: E402
    _sxent_bwd,
    fused_softmax_xent as jax_sxent,
)

from deeplearning4j_tpu_torch import ops  # noqa: E402
from deeplearning4j_tpu_torch.nn import losses  # noqa: E402
from deeplearning4j_tpu_torch.ops import softmax_xent as sx  # noqa: E402

N, C = 13, 11
TOL = {np.float64: 1e-9, np.float32: 1e-5}
DTYPES = [np.float64, np.float32]


def _rows(dtype, labels, seed=0, n=N, c=C):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, c)) * 2.0).astype(dtype)
    if labels == "one_hot":
        lab = np.eye(c)[rng.integers(0, c, n)]
    else:  # soft labels that do not sum to 1, which the gradient must handle
        lab = rng.random((n, c)) * 0.3
    return x, lab.astype(dtype)


def _close(got, want, dtype, name=""):
    tol = TOL[dtype]
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol,
                               err_msg=name)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("labels", ["one_hot", "soft"])
def test_value_and_grads_match_jax(labels, dtype):
    x, lab = _rows(dtype, labels, seed=1)
    w = np.random.default_rng(2).normal(size=N).astype(dtype)
    jfn = lambda a, b: jnp.sum(jax_sxent(a, b) * w)  # noqa: E731
    want_val = jax_sxent(jnp.asarray(x), jnp.asarray(lab))
    want_dx, want_dl = jax.grad(jfn, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(lab))
    tx, tl = torch.from_numpy(x).requires_grad_(), torch.from_numpy(lab).requires_grad_()
    got = ops.fused_softmax_xent(tx, tl)
    assert got.dtype == tx.dtype and got.shape == (N,)
    _close(got.detach().numpy(), want_val, dtype, "loss")
    (got * torch.from_numpy(w)).sum().backward()
    _close(tx.grad.numpy(), want_dx, dtype, "dx")
    _close(tl.grad.numpy(), want_dl, dtype, "dl")


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("labels", ["one_hot", "soft"])
def test_backward_reference_matches_jax_sxent_bwd(labels, dtype):
    x, lab = _rows(dtype, labels, seed=3)
    g = np.random.default_rng(4).normal(size=N).astype(dtype)
    want = _sxent_bwd((jnp.asarray(x), jnp.asarray(lab)), jnp.asarray(g))
    got = sx.softmax_xent_backward_reference(*map(torch.from_numpy, (x, lab, g)))
    for gt, w, name in zip(got, want, ("dx", "dl")):
        _close(gt.numpy(), w, dtype, name)


def test_rows_wrapper_takes_the_jax_argument_order():
    x, lab = _rows(np.float64, "soft", seed=5)
    tx, tl = torch.from_numpy(x), torch.from_numpy(lab)
    torch.testing.assert_close(ops.softmax_xent_rows(tl, tx),
                               sx.softmax_xent_reference(tx, tl))


def test_bf16_logits_compute_and_return_f32():
    """The promoted-dtype contract (``_sxent_compute_dt``): bf16 logits give
    f32 row losses computed in f32, as close to an f64 oracle as the bf16
    inputs allow, not rounded back to bf16."""
    x, lab = _rows(np.float32, "one_hot", seed=6, n=64, c=96)
    x = x * 8.0  # large logits: bf16 math would lose the loss's low bits
    tx = torch.from_numpy(x).to(torch.bfloat16)
    got = ops.fused_softmax_xent(tx, torch.from_numpy(lab))
    assert got.dtype == torch.float32
    oracle = sx.softmax_xent_reference(tx.double(), torch.from_numpy(lab).double())
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=1e-6, atol=1e-5)


# -------------------------------------------------------------- the catalog
# (loss, activation) pairs with the activation each loss pairs with
CATALOG = [
    ("mcxent", "softmax"), ("mcxent", "sigmoid"), ("negativeloglikelihood", "softmax"),
    ("xent", "sigmoid"), ("xent", "tanh"), ("reconstruction_crossentropy", "sigmoid"),
    ("mse", "identity"), ("l2", "tanh"), ("mae", "identity"), ("l1", "identity"),
    ("hinge", "identity"), ("squared_hinge", "identity"),
    ("kl_divergence", "softmax"), ("cosine_proximity", "identity"),
    ("poisson", "relu"), ("mape", "identity"), ("msle", "relu"),
]


def _loss_inputs(loss, seed):
    rng = np.random.default_rng(seed)
    preout = rng.normal(size=(N, C)) * 1.5
    if loss in ("mcxent", "negativeloglikelihood", "kl_divergence"):
        labels = np.eye(C)[rng.integers(0, C, N)]
    elif loss in ("hinge", "squared_hinge", "xent", "reconstruction_crossentropy"):
        labels = (rng.random((N, C)) > 0.5).astype(np.float64)
    else:
        labels = rng.normal(size=(N, C))
    return preout, labels


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("loss,act", CATALOG)
def test_loss_catalog_matches_jax(loss, act, masked):
    preout, labels = _loss_inputs(loss, seed=sum(map(ord, loss)))
    mask = None
    if masked:
        mask = (np.random.default_rng(9).random(N) > 0.4).astype(np.float64)
    want = jax_losses.get_loss(loss)(jnp.asarray(labels), jnp.asarray(preout), act,
                                     None if mask is None else jnp.asarray(mask))
    got = losses.get_loss(loss)(torch.from_numpy(labels), torch.from_numpy(preout), act,
                                None if mask is None else torch.from_numpy(mask))
    _close(got.numpy(), want, np.float64, loss)


def test_mcxent_sequence_input_and_all_masked_rows():
    """3-D logits take the log-softmax path; a mask of all zeros divides by
    max(sum(mask), 1) and gives 0, as in the JAX package."""
    rng = np.random.default_rng(10)
    preout = rng.normal(size=(3, 4, C))
    labels = np.eye(C)[rng.integers(0, C, (3, 4))]
    want = jax_losses.mcxent(jnp.asarray(labels), jnp.asarray(preout))
    got = losses.mcxent(torch.from_numpy(labels), torch.from_numpy(preout))
    _close(got.numpy(), want, np.float64)
    zero = losses.mcxent(torch.from_numpy(labels[0]), torch.from_numpy(preout[0]),
                         mask=torch.zeros(4, dtype=torch.float64))
    assert float(zero) == 0.0


def test_unknown_loss_names_the_catalog():
    with pytest.raises(ValueError, match="mcxent"):
        losses.get_loss("no_such_loss")


# ------------------------------------------------------------------- card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -8)])
@pytest.mark.parametrize("labels", ["one_hot", "soft"])
def test_cuda_kernels_match_plain_versions(cuda_device, dtype, atol, labels):
    x, lab = _rows(np.float32, labels, seed=11, n=1000, c=97)  # rows of 4 warps' width + 1
    tx, tl = (torch.from_numpy(a).to(cuda_device, dtype) for a in (x, lab))
    g = torch.from_numpy(np.random.default_rng(12).normal(size=1000).astype(np.float32))
    g = g.to(cuda_device)
    before = ops.counters()
    loss = ops.fused_softmax_xent(tx, tl)
    dx, dl = sx.softmax_xent_backward(tx, tl, g)
    torch.cuda.synchronize()
    assert loss.dtype == torch.float32
    torch.testing.assert_close(loss, sx.softmax_xent_reference(tx, tl), rtol=0, atol=1e-5)
    for got, want in zip((dx, dl), sx.softmax_xent_backward_reference(tx, tl, g)):
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)
    after = ops.counters()
    assert after["softmax_xent_fwd"] == before["softmax_xent_fwd"] + 1
    assert after["softmax_xent_bwd"] == before["softmax_xent_bwd"] + 1


@pytest.mark.cuda
def test_cuda_kernels_refuse_f64(cuda_device):
    x = torch.zeros((4, 5), dtype=torch.float64, device=cuda_device)
    with pytest.raises(TypeError):
        ops.fused_softmax_xent(x, x)


def _faulty(fault):
    """(preout, labels, g) on the CPU with one thing the kernels refuse."""
    x, lab, g = torch.zeros((4, 6)), torch.zeros((4, 6)), torch.zeros(4)
    if fault == "preout_1d":
        x = torch.zeros(24)
    elif fault == "shapes_differ":
        lab = torch.zeros((4, 7))
    elif fault == "preout_f64":
        x = x.double()
    elif fault == "labels_f16":
        lab = lab.half()
    elif fault == "g_shape":
        g = torch.zeros(5)
    elif fault == "g_bf16":
        g = g.bfloat16()
    elif fault == "labels_elsewhere":
        lab = torch.zeros((4, 6), device="meta")
    elif fault == "g_elsewhere":
        g = torch.zeros(4, device="meta")
    elif fault == "preout_strided":
        x = torch.zeros((6, 4)).t()
    elif fault == "labels_strided":
        lab = torch.zeros((4, 12))[:, ::2]
    elif fault == "g_strided":
        g = torch.zeros(8)[::2]
    return x, lab, g


@pytest.mark.parametrize("fault,error", [
    ("preout_1d", ValueError), ("shapes_differ", ValueError), ("preout_f64", TypeError),
    ("labels_f16", TypeError), ("g_shape", ValueError), ("g_bf16", ValueError),
    ("labels_elsewhere", ValueError), ("g_elsewhere", ValueError),
    ("preout_strided", ValueError), ("labels_strided", ValueError), ("g_strided", ValueError)])
def test_check_raises_on_what_the_kernels_refuse(fault, error):
    """The kernels' one-pass check raises the type it always raised for
    each refused input, on CPU tensors (the CUDA wrappers call it first)."""
    x, lab, g = _faulty(fault)
    with pytest.raises(error):
        sx._check(x, lab, g)
    if not fault.startswith("g_"):
        with pytest.raises(error):
            sx._check(x, lab)
    sx._check(*_faulty("none"))  # and takes what they take


def test_bind_resolves_a_symbol_once(monkeypatch):
    """bind loads the library and declares the entry's arguments on its first
    call only; later calls return the same function without the build
    lock."""
    from deeplearning4j_tpu_torch.ops import _build

    class Entry:
        argtypes = restype = None

    class Lib:
        dl4j_fake = Entry()

    loads = []
    monkeypatch.setattr(_build, "_FNS", {})
    monkeypatch.setattr(_build, "load", lambda name: loads.append(name) or Lib)
    first = _build.bind("fake", "dl4j_fake", 2, 1, 1)
    again = _build.bind("fake", "dl4j_fake", 2, 1, 1)
    assert first is again is Lib.dl4j_fake and loads == ["fake"]
    assert len(first.argtypes) == 2 + 1 + 1 + 1  # pointers, int, float, stream
    assert first.restype is not None


def test_forward_without_grad_builds_no_graph():
    """Without a gradient to take, the forward runs alone (no autograd node)
    and equals the Function's value."""
    x, lab = (torch.from_numpy(a) for a in _rows(np.float32, "soft", seed=5))
    plain = ops.fused_softmax_xent(x, lab)
    assert plain.grad_fn is None
    tracked = ops.fused_softmax_xent(x.clone().requires_grad_(), lab)
    assert type(tracked.grad_fn).__name__ == "SoftmaxXentFunctionBackward"
    torch.testing.assert_close(plain, tracked.detach(), rtol=0, atol=0)
