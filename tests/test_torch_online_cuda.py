"""The port's online runtime on the card: a checkpoint round trip, a
rollback that makes no capture, and a swap under concurrent ``output()``
calls, on the full char-RNN recipe's conf at small widths. These tests need
a CUDA device and skip without one; the file imports no JAX, so it runs on
a machine without it: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_online_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import deeplearning4j_tpu_torch as pt  # noqa: E402
from deeplearning4j_tpu_torch.runtime import CheckpointStore  # noqa: E402
from deeplearning4j_tpu_torch.runtime.compile_manager import get_compile_manager  # noqa: E402
from deeplearning4j_tpu_torch.telemetry import MetricsRegistry  # noqa: E402

VOCAB, HIDDEN = 12, 16


def _char_conf(pkg):
    conf = pkg.char_rnn(VOCAB, HIDDEN, 2)
    conf.backprop_type = "standard"
    return conf


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _card_char_rnn():
    return pt.MultiLayerNetwork(_char_conf(pt)).init()


def _card_window(seed=0, k=2, b=4, t=16):
    rng = np.random.default_rng(seed)
    eye = np.eye(VOCAB, dtype=np.float32)
    ids = rng.integers(0, VOCAB, (k, b, t + 1))
    return eye[ids[..., :-1]], eye[ids[..., 1:]]


@pytest.mark.cuda
def test_cuda_checkpoint_round_trip(cuda_device, tmp_path):
    """A version of a card network restores on the card bit for bit, and
    the restored network continues the run exactly."""
    net = _card_char_rnn()
    xs, ys = _card_window()
    net.fit_on_device(xs, ys, steps=2)
    store = CheckpointStore(str(tmp_path), registry=MetricsRegistry())
    store.save_async(net)
    store.join()
    back = store.restore()
    assert back.device.type == "cuda"
    for a, b in zip([v for l in net._leaves() for v in l.values()],
                    [v for l in back._leaves() for v in l.values()]):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(net.fit_on_device(xs, ys, steps=2),
                                  back.fit_on_device(xs, ys, steps=2))


@pytest.mark.cuda
def test_cuda_rollback_makes_no_new_capture(cuda_device, tmp_path):
    net = _card_char_rnn()
    xs, ys = _card_window()
    store = CheckpointStore(str(tmp_path), registry=MetricsRegistry())
    net.fit_on_device(xs, ys, steps=2)
    store.save(net)
    want = net.fit_on_device(xs, ys, steps=2)
    cm = get_compile_manager()
    before = cm.compiles.value
    store.load_into(net)
    np.testing.assert_array_equal(net.fit_on_device(xs, ys, steps=2), want)
    assert cm.compiles.value == before


@pytest.mark.cuda
def test_cuda_swap_under_concurrent_output(cuda_device):
    """Threads call output() on a served clone while another thread swaps
    two versions in turn: every answer is one version's, never a mix."""
    import threading

    net = _card_char_rnn()
    other = _card_char_rnn()
    other.fit_on_device(*_card_window(1), steps=2)
    x = _card_window(2, k=1, b=3)[0][0]
    serve = net._twin().init()
    versions = []
    for src in (net, other):
        serve.swap_params(src._params_from_leaves(
            [{k: v.detach().clone() for k, v in l.items()} for l in src._leaves()]))
        versions.append(serve.output(x))
    assert np.abs(versions[0] - versions[1]).max() > 0
    errors, stop = [], threading.Event()

    def client():
        while not stop.is_set():
            out = serve.output(x)
            if not any(np.array_equal(out, v) for v in versions):
                errors.append("mixed")

    threads = [threading.Thread(target=client) for _ in range(3)]
    for t in threads:
        t.start()
    for i in range(20):
        src = (net, other)[i % 2]
        serve.swap_params(src._params_from_leaves(
            [{k: v.detach().clone() for k, v in l.items()} for l in src._leaves()]))
    stop.set()
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    assert not errors
