"""The PyTorch port's LSTM sequence op against the JAX package's Pallas kernel.

On the CPU the port's ``fused_lstm_sequence``/``_masked`` run their plain
versions; the JAX side runs the Pallas kernel in interpret mode, as
tests/test_pallas_ops.py does. The same numpy inputs go to both. Tests marked
``cuda`` hold the CUDA kernel against the plain version and skip where there
is no card.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.ops.pallas_kernels import (  # noqa: E402
    fused_lstm_sequence as jax_seq,
    fused_lstm_sequence_masked as jax_seq_masked,
)
from deeplearning4j_tpu_torch import ops  # noqa: E402
from deeplearning4j_tpu_torch.ops import _build, lstm_sequence as ls  # noqa: E402

ATOL_F32 = 1e-5  # same f32 math, sums in another order
ACT_GATE = [("tanh", "sigmoid"), ("tanh", "hardsigmoid"), ("relu", "sigmoid")]
PORT = Path(__file__).resolve().parents[1] / "deeplearning4j_tpu_torch"


@pytest.fixture(autouse=True, scope="module")
def _one_thread_module():
    """torch's intra-op threads capped at one for this module: its tensors
    are small, and under several test workers the threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed=0, T=7, B=3, H=16, masked=False):
    rng = np.random.default_rng(seed)
    r = lambda *s: (rng.normal(size=s) * 0.4).astype(np.float32)  # noqa: E731
    arrs = [r(T, B, 4 * H), r(B, H), r(B, H), r(H, 4 * H),
            r(H) * 0.2, r(H) * 0.2, r(H) * 0.2]
    if masked:
        lengths = rng.integers(1, T + 1, B)
        mask = (np.arange(T)[:, None] < lengths[None, :]).astype(np.float32)
        mask[rng.integers(0, T), 0] = 0.0  # a hole, not only a ragged tail
        arrs.insert(1, mask[..., None])
    return arrs


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("act,gate", ACT_GATE)
@pytest.mark.parametrize("masked", [False, True])
def test_sequence_matches_jax_pallas(act, gate, masked):
    arrs = _inputs(seed=3, masked=masked)
    tens = [torch.from_numpy(a) for a in arrs]
    jarrs = [jnp.asarray(a) for a in arrs]
    if masked:
        got = ops.fused_lstm_sequence_masked(*tens, act, gate)
        want = jax_seq_masked(*jarrs, act, gate)
    else:
        got = ops.fused_lstm_sequence(*tens, act, gate)
        want = jax_seq(*jarrs, act, gate)
    for g, w, name in zip(got, want, ("ys", "hT", "cT")):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL_F32,
                                   err_msg=name)


def test_masked_with_all_ones_is_unmasked():
    arrs = _inputs(seed=5, masked=True)
    arrs[1] = np.ones_like(arrs[1])
    tens = [torch.from_numpy(a) for a in arrs]
    masked = ops.fused_lstm_sequence_masked(*tens)
    plain = ops.fused_lstm_sequence(tens[0], *tens[2:])
    for a, b in zip(masked, plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_masked_steps_hold_state():
    arrs = _inputs(seed=6, masked=True)
    arrs[1][:] = 1.0
    arrs[1][3:, 1] = 0.0  # row 1 stops after 3 steps
    ys, hT, cT = ops.fused_lstm_sequence_masked(*[torch.from_numpy(a) for a in arrs])
    for t in range(3, ys.shape[0]):
        torch.testing.assert_close(ys[t, 1], ys[2, 1], rtol=0, atol=0)
    torch.testing.assert_close(hT[1], ys[2, 1], rtol=0, atol=0)


def test_bf16_plain_version_tracks_f32():
    """bf16 storage with f32 accumulation of the recurrent product stays
    within bf16 rounding of the f32 result at this depth."""
    tens = [torch.from_numpy(a) for a in _inputs(seed=7)]
    f32 = ops.fused_lstm_sequence(*tens)
    bf16 = ops.fused_lstm_sequence(*[t.to(torch.bfloat16) for t in tens])
    for a, b in zip(f32, bf16):
        assert b.dtype == torch.bfloat16
        np.testing.assert_allclose(b.float().numpy(), a.numpy(), atol=3e-2)


def test_zero_length_sequence():
    tens = [torch.from_numpy(a) for a in _inputs(T=0)]
    ys, hT, cT = ops.fused_lstm_sequence(*tens)
    assert tuple(ys.shape) == (0, 3, 16)
    torch.testing.assert_close(hT, tens[1])
    torch.testing.assert_close(cT, tens[2])


def test_variant_reports_what_runs():
    assert ops.variant(torch.zeros(1)) == "reference"
    assert ops.supported_lstm_activations("tanh", "hardsigmoid")
    assert not ops.supported_lstm_activations("softsign", "sigmoid")


@pytest.mark.parametrize("bad,err", [
    ("act", NotImplementedError), ("dtype", TypeError), ("shape", ValueError),
    ("stride", ValueError), ("mask", ValueError)])
def test_wrapper_checks_refuse_what_the_kernel_does_not_take(bad, err):
    zx, mask, h0, c0, RW, pF, pI, pO = [torch.from_numpy(a)
                                         for a in _inputs(masked=True)]
    act = "tanh"
    if bad == "act":
        act = "softsign"
    elif bad == "dtype":
        zx, h0, c0, RW, pF, pI, pO = [t.double() for t in (zx, h0, c0, RW, pF, pI, pO)]
    elif bad == "shape":
        RW = RW[:, :-4]
    elif bad == "stride":
        h0 = torch.from_numpy(np.asfortranarray(h0.numpy()))
    elif bad == "mask":
        mask = mask[:-1]
    with pytest.raises(err):
        ls._check(zx, mask, h0, c0, RW, pF, pI, pO, act, "sigmoid")


def test_kernel_source_and_build_paths():
    assert "lstm_seq" in _build.sources()
    lib = _build.lib_path("lstm_seq")
    assert lib.parent == _build.BUILD_DIR and lib.suffix == ".so"
    assert _build.BUILD_DIR.parts[-2:] == ("build", "torch_kernels")
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_nvcc_missing_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os, "access", lambda path, mode: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def test_kernel_codes_match_cuda_source():
    src = (PORT / "ops" / "csrc" / "common.cuh").read_text()  # shared enum
    for name, code in ls._ACT_CODES.items():
        k = {"tanh": "kTanh", "sigmoid": "kSigmoid", "hardsigmoid": "kHardSigmoid",
             "relu": "kRelu", "identity": "kIdentity"}[name]
        assert f"{k} = {code}" in src
    assert set(ls._ACT_CODES) == set(ls.ACT)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [
    PORT.parent / "chip_smoke.py", PORT.parent / "scripts" / "torch_chaos_soak.py",
    PORT.parent / "scripts" / "torch_analyze_trace.py",
    PORT.parent / "scripts" / "torch_write_keras_h5.py",
    PORT.parent / "scripts" / "torch_vgg16_lr_check.py",
    PORT.parent / "scripts" / "torch_tf32_probe.py"],
                         ids=lambda p: str(p.relative_to(PORT.parent)))
def test_port_imports_no_jax_and_no_jax_package(path):
    roots = {name.split(".")[0] for name in _imports(path)}
    assert not roots & {"jax", "jaxlib", "deeplearning4j_tpu"}, path


# the training-observability and optimizer modules of slice 20, the
# serving front of slice 21 (runtime/, serving/, tracing, slo, the utils),
# runtime durability and online learning of slice 22 (runtime/,
# streaming/, testing/, telemetry/history.py, utils/netio.py), and the
# training UI and its host tier of slice 23 (runtime/native_loader.py,
# profiler.py, ui/, clustering/, plot/), and the autotuner and the fleet of
# slice 26 (tune/, fleet/, utils/subproc.py, utils/time_source.py), which
# the scan above must cover like every other module of the port
OBSERVABILITY_MODULES = [f"telemetry/{m}.py" for m in (
    "__init__", "registry", "spans", "watchdog", "flight_recorder", "device", "memory",
    "session")] + [f"optimize/{m}.py" for m in ("__init__", "listeners", "solvers")] + [
    f"runtime/{m}.py" for m in ("__init__", "compile_manager", "step_graphs", "inference")] + [
    f"serving/{m}.py" for m in ("__init__", "batcher", "decode", "service")] + [
    "telemetry/tracing.py", "telemetry/slo.py", "utils/mathutil.py", "utils/collections.py"] + [
    f"runtime/{m}.py" for m in ("resilience", "checkpoint", "online")] + [
    f"streaming/{m}.py" for m in ("__init__", "pipeline", "embedded_kafka",
                                  "socket_transport")] + [
    "testing/__init__.py", "testing/chaos.py", "telemetry/history.py", "utils/netio.py"] + [
    "runtime/native_loader.py", "profiler.py"] + [
    f"ui/{m}.py" for m in ("__init__", "i18n", "storage", "stats_listener", "conv_listener",
                           "server")] + [
    f"clustering/{m}.py" for m in ("__init__", "trees", "kmeans")] + [
    f"plot/{m}.py" for m in ("__init__", "tsne")] + [
    "tune/__init__.py", "fleet/__init__.py", "utils/subproc.py", "utils/time_source.py"]


@pytest.mark.parametrize("module", OBSERVABILITY_MODULES)
def test_observability_modules_are_scanned_and_load_without_jax(module):
    """Each of the port's telemetry/ and optimize/ modules is in the
    no-JAX scan's list, and importing it in a fresh interpreter loads
    neither ``jax`` nor the JAX package."""
    path = PORT / module
    assert path in sorted(PORT.rglob("*.py"))
    name = "deeplearning4j_tpu_torch." + module[:-3].replace("/", ".").replace(".__init__", "")
    code = (f"import sys, importlib; importlib.import_module({name!r}); "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'deeplearning4j_tpu')); print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=PORT.parent, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("masked", [False, True])
def test_cuda_kernel_matches_plain_version(cuda_device, dtype, atol, masked):
    tens = [torch.from_numpy(a).to(cuda_device, dtype)
            for a in _inputs(seed=11, T=9, B=37, H=40, masked=masked)]
    before = dict(ls.launches)
    if masked:
        got = ops.fused_lstm_sequence_masked(*tens)
        want = ls.lstm_sequence_masked_reference(*tens)
    else:
        got = ops.fused_lstm_sequence(*tens)
        want = ls.lstm_sequence_reference(*tens)
    torch.cuda.synchronize()
    name = "lstm_seq_lean_masked" if masked else "lstm_seq_lean"
    assert ls.launches[name] == before[name] + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=atol)


@pytest.mark.cuda
def test_cuda_kernel_refuses_unsupported_activation(cuda_device):
    tens = [torch.from_numpy(a).to(cuda_device) for a in _inputs()]
    with pytest.raises(NotImplementedError):
        ops.fused_lstm_sequence(*tens, "softsign", "sigmoid")
