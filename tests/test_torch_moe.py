"""The PyTorch port's MixtureOfExpertsLayer against the JAX package (the
single-device cases of ``tests/test_moe.py``), and the transformer block of
``examples/long_context.py`` with it, trained.

The layer is built from the JAX layer's JSON, given the same numpy params
and input, and held to the JAX layer's output and its gradients in x and
every param (JAX's VJP against autograd, one seeded upstream gradient) at
1e-5 (f32 on both sides; sums in another order): top-1, top-2, capacity
overflow (the residual carries the dropped tokens), ties in the gate (the
first largest expert, as ``jnp.argmax``), sequence input with a [B, T] mask
whose pad tokens claim no capacity. bf16 at the AlexNet tests' 3e-2. The
block trains four Adam updates over bucketed padded sequences against the
JAX net (x64 off on the JAX side, as ``test_torch_adam.py`` explains):
losses at 1e-5, and params at 1e-5 of their size but for at most one
element in 10,000, which must stay within a tenth of one Adam step (lr /
10), as ``test_torch_lenet_mlp.py`` explains (Adam's step is g / (|g| +
1e-8): a gradient that cancels to about 1e-8 carries f32 rounding into the
step).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deeplearning4j_tpu as dj  # noqa: E402
from deeplearning4j_tpu.runtime import inference as jax_inference  # noqa: E402
from deeplearning4j_tpu.datasets.iterators import (  # noqa: E402
    BucketingSequenceIterator as JaxBucketingIterator,
)
from deeplearning4j_tpu.ops import kernel_select  # noqa: E402

import deeplearning4j_tpu_torch as pt  # noqa: E402

ATOL = RTOL = 1e-5
BF16_ATOL = 3e-2


@pytest.fixture(autouse=True)
def jax_env(monkeypatch, tmp_path):
    monkeypatch.setattr(jax_inference, "fast_path_enabled", lambda: False)
    monkeypatch.setenv("DL4JTPU_KERNEL_CALIBRATION", str(tmp_path / "calibration.json"))
    kernel_select.reset()
    yield
    kernel_select.reset()


def jlayer_of(**kw):
    """tests/test_moe.py's layer: 8 wide, 4 experts of hidden 16."""
    defaults = dict(n_out=8, n_experts=4, hidden=16, top_k=1, capacity_factor=2.0,
                    residual=False)
    defaults.update(kw)
    return dj.MixtureOfExpertsLayer(**defaults)


def port_layer(jlayer, it):
    conf = dj.MultiLayerConfiguration(layers=[jlayer], input_type=it)
    return pt.MultiLayerConfiguration.from_json(conf.to_json()).layers[0]


def jax_params(jlayer, it, seed=0):
    return {k: np.asarray(v, np.float32)
            for k, v in jlayer.init_params(jax.random.PRNGKey(seed), it).items()}


def vjp_both(jlayer, player, params, x, mask=None, seed=0, dtype="float32"):
    """(out, dx, dparams) of each package for one upstream gradient."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jmask = None if mask is None else jnp.asarray(mask, jdt)

    def jf(xx, pp):
        return jlayer.apply(pp, xx, {}, mask=jmask)[0]

    jp = {k: jnp.asarray(v, jdt) for k, v in params.items()}
    jout, vjp = jax.vjp(jf, jnp.asarray(x, jdt), jp)
    g = np.random.default_rng(seed + 100).normal(size=jout.shape).astype(np.float32)
    jdx, jdp = vjp(jnp.asarray(g, jdt))
    tx = torch.tensor(x).to(tdt).requires_grad_()
    tp = {k: torch.tensor(v).to(tdt).requires_grad_() for k, v in params.items()}
    out, _ = player.apply(tp, tx, {}, mask=None if mask is None else torch.tensor(mask).to(tdt))
    out.backward(torch.from_numpy(g).to(tdt))

    def host(a):
        return np.asarray(jnp.asarray(a, jnp.float32))

    return ((host(jout), host(jdx), {k: host(v) for k, v in jdp.items()}),
            (out.detach().float().numpy(), tx.grad.float().numpy(),
             {k: v.grad.float().numpy() for k, v in tp.items()}))


def assert_same(want, got, atol=ATOL, rtol=RTOL):
    (wo, wdx, wdp), (go, gdx, gdp) = want, got
    assert go.shape == wo.shape
    np.testing.assert_allclose(go, wo, atol=atol, rtol=rtol, err_msg="out")
    np.testing.assert_allclose(gdx, wdx, atol=atol, rtol=rtol, err_msg="dx")
    assert set(gdp) == set(wdp)
    for k in wdp:
        np.testing.assert_allclose(gdp[k], wdp[k], atol=atol, rtol=rtol, err_msg=k)


ROUTING_CASES = {
    # name: (layer kwargs, tokens)
    "top1": (dict(), 16),
    "top2": (dict(top_k=2), 8),
    "capacity_overflow_residual": (dict(capacity_factor=0.25, residual=True), 16),
    "top2_overflow": (dict(top_k=2, capacity_factor=0.5, residual=True), 16),
    "tanh_experts_three": (dict(expert_activation="tanh", top_k=2, n_experts=3), 12),
}


@pytest.mark.parametrize("case", sorted(ROUTING_CASES))
def test_routing_matches_jax(case):
    kw, n = ROUTING_CASES[case]
    it = dj.InputType.feed_forward(8)
    jlayer = jlayer_of(**kw)
    player = port_layer(jlayer, it)
    params = jax_params(jlayer, it, seed=len(case))
    assert {k: tuple(v.shape) for k, v in player.init_params(torch.Generator(), it).items()} == {
        k: v.shape for k, v in params.items()}
    x = np.random.default_rng(len(case)).normal(size=(n, 8)).astype(np.float32)
    want, got = vjp_both(jlayer, player, params, x, seed=len(case))
    assert_same(want, got)
    if case == "capacity_overflow_residual":
        # capacity 0.25 * 16 / 4 = 1 token an expert: the rest equal x
        dropped = np.isclose(got[0], x, atol=1e-6).all(axis=-1)
        assert dropped.sum() >= 16 - 4 * 1 - 1


def test_top1_is_the_argmax_experts_ffn_times_its_gate():
    """tests/test_moe.py's manual check, on the port alone."""
    it = dj.InputType.feed_forward(8)
    jlayer = jlayer_of()
    player = port_layer(jlayer, it)
    params = jax_params(jlayer, it)
    x = np.random.default_rng(0).normal(size=(16, 8)).astype(np.float32)
    out, _ = player.apply({k: torch.tensor(v) for k, v in params.items()}, torch.tensor(x), {})
    logits = x @ params["Wg"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    for i, e in enumerate(probs.argmax(-1)):
        h = np.maximum(x[i] @ params["W1"][e] + params["b1"][e], 0.0)
        np.testing.assert_allclose(out[i].numpy(), (h @ params["W2"][e] + params["b2"][e])
                                   * probs[i, e], rtol=1e-4, atol=1e-5)


def test_gate_ties_take_the_first_expert_as_jax():
    """A zero gate: every probability ties, every token goes to expert 0
    (top-1) or experts 0 and 1 (top-2), capacity filling in token order."""
    it = dj.InputType.feed_forward(8)
    for top_k in (1, 2):
        jlayer = jlayer_of(top_k=top_k, capacity_factor=1.0)
        player = port_layer(jlayer, it)
        params = dict(jax_params(jlayer, it, seed=3), Wg=np.zeros((8, 4), np.float32))
        x = np.random.default_rng(top_k).normal(size=(12, 8)).astype(np.float32)
        want, got = vjp_both(jlayer, player, params, x, seed=top_k)
        assert_same(want, got)
        stats = player.load_balance_stats({k: torch.tensor(v) for k, v in params.items()}, x)
        assert stats["expert_fraction"].tolist() == ([1.0, 0, 0, 0] if top_k == 1
                                                     else [1.0, 1.0, 0, 0])


def test_sequence_input_with_pad_tokens_and_json_round_trip():
    """[B, T, F] with a [B, T] mask: pad tokens claim no capacity and add no
    MoE output (the residual passes them), real tokens match a run on the
    real tokens alone with the same capacity; all against JAX. The layer
    comes from the JAX conf's JSON with its fields."""
    jconf = dj.MultiLayerConfiguration(
        layers=[jlayer_of(capacity_factor=1.0, residual=True),
                dj.OutputLayer(n_out=3, activation="softmax")],
        input_type=dj.InputType.feed_forward(8))
    player = pt.MultiLayerConfiguration.from_json(jconf.to_json()).layers[0]
    assert isinstance(player, pt.MixtureOfExpertsLayer)
    assert (player.n_experts, player.capacity_factor, player.hidden) == (4, 1.0, 16)
    jlayer = jconf.layers[0]
    params = jax_params(jlayer, dj.InputType.feed_forward(8))
    x = np.random.default_rng(4).normal(size=(4, 4, 8)).astype(np.float32)
    mask = np.tile(np.array([1, 1, 0, 0], np.float32), (4, 1))
    mask[1, 2] = 1.0
    want, got = vjp_both(jlayer, player, params, x, mask=mask, seed=5)
    assert_same(want, got)
    out = got[0]
    pad = mask == 0
    np.testing.assert_allclose(out[pad], x[pad], atol=1e-6)
    real = x[mask > 0]
    alone = jlayer_of(capacity_factor=16 / 9, residual=True)
    ref, _ = port_layer(alone, dj.InputType.feed_forward(8)).apply(
        {k: torch.tensor(v) for k, v in params.items()}, torch.tensor(real), {})
    np.testing.assert_allclose(out[mask > 0], ref.numpy(), rtol=1e-4, atol=1e-5)


def test_bf16_forward_and_gradients_close_to_jax():
    """bf16 on both sides (one-hots in x's dtype, the gate product rounded
    in bf16): the AlexNet tests' 3e-2."""
    it = dj.InputType.feed_forward(8)
    jlayer = jlayer_of(top_k=2, residual=True)
    player = port_layer(jlayer, it)
    params = jax_params(jlayer, it, seed=6)
    x = np.random.default_rng(6).normal(size=(2, 6, 8)).astype(np.float32)
    want, got = vjp_both(jlayer, player, params, x, seed=6, dtype="bfloat16")
    assert_same(want, got, atol=BF16_ATOL, rtol=0)


def test_residual_requires_matching_width():
    jlayer = jlayer_of(residual=True, n_out=6)
    player = port_layer(jlayer, dj.InputType.feed_forward(8))
    with pytest.raises(ValueError) as jerr:
        jlayer.init_params(jax.random.PRNGKey(0), dj.InputType.feed_forward(8))
    with pytest.raises(ValueError, match="n_in == n_out") as perr:
        player.init_params(torch.Generator(), pt.InputType.feed_forward(8))
    assert str(perr.value) == str(jerr.value)


@pytest.mark.parametrize("top_k,cf", [(1, 2.0), (2, 0.5)])
def test_load_balance_stats_match_jax(top_k, cf):
    it = dj.InputType.feed_forward(8)
    jlayer = jlayer_of(top_k=top_k, capacity_factor=cf)
    player = port_layer(jlayer, it)
    params = jax_params(jlayer, it)
    x = np.random.default_rng(3).normal(size=(32, 8)).astype(np.float32)
    want = jlayer.load_balance_stats({k: jnp.asarray(v) for k, v in params.items()}, x)
    got = player.load_balance_stats({k: torch.tensor(v) for k, v in params.items()}, x)
    np.testing.assert_allclose(got["expert_fraction"].numpy(),
                               np.asarray(want["expert_fraction"]), rtol=1e-6)
    assert got["expert_fraction"].sum().item() == pytest.approx(top_k)
    assert (got["dropped_tokens"], got["capacity"]) == (want["dropped_tokens"], want["capacity"])
    if top_k == 1:
        assert got["capacity"] == 16


# ------------------------------------------- examples/long_context.py's block
N_BLOCK, HEADS, V = 16, 4, 8
ADAM_LR = 3e-3  # the example's


def long_context_conf():
    """Two blocks of SelfAttention(flash), LayerNorm and the residual MoE,
    then a per-step head; Adam at 3e-3 (the example's)."""
    def block():
        return [dj.SelfAttentionLayer(n_out=N_BLOCK, n_heads=HEADS, causal=True,
                                      attention_impl="flash"),
                dj.LayerNormLayer(),
                dj.MixtureOfExpertsLayer(n_out=N_BLOCK, n_experts=4, hidden=32,
                                         capacity_factor=2.0, residual=True)]

    return dj.MultiLayerConfiguration(
        layers=block() + block() + [dj.RnnOutputLayer(n_out=3, activation="softmax",
                                                      loss="mcxent")],
        input_type=dj.InputType.recurrent(V),
        updater=dj.UpdaterConfig(updater="adam", learning_rate=ADAM_LR), seed=1)


def long_context_sequences():
    """The example's data: lengths 6-40, label = the sign of the features'
    sum, bucketed to 16 and 40 (two batches of 2, each padded)."""
    rng = np.random.default_rng(0)
    seqs = []
    for t in (6, 9, 30, 38):
        f = rng.normal(size=(t, V)).astype(np.float32)
        seqs.append((f, np.eye(3, dtype=np.float32)[(f.sum(-1) > 0).astype(int)]))
    return seqs


class Snapshots:
    def __init__(self):
        self.losses, self.params = [], []

    def iteration_done(self, model, iteration, loss):
        self.losses.append(float(loss))
        self.params.append(pt.params_to_numpy(model) if isinstance(model, torch.nn.Module)
                           else [{k: np.asarray(v, np.float32) for k, v in p.items()}
                                 for p in model.params])


def test_long_context_block_trains_like_jax():
    """Four Adam updates (two epochs of two padded batches): each update's
    loss and the params after it."""
    jconf = long_context_conf()
    jnet = dj.MultiLayerNetwork(jconf).init()
    jnet.init(params=jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), jnet.params),
              force=True)
    pnet = pt.load_jax_params(
        pt.MultiLayerNetwork(pt.MultiLayerConfiguration.from_json(jconf.to_json()),
                             device="cpu"),
        [{k: np.asarray(v) for k, v in p.items()} for p in jnet.params])
    for net in (jnet, pnet):
        net.set_listeners(Snapshots())
    seqs = long_context_sequences()
    with jax.enable_x64(False):
        jnet.fit(JaxBucketingIterator(seqs, batch=2, boundaries=(16, 40)), epochs=2)
    pnet.fit(pt.BucketingSequenceIterator(seqs, batch=2, boundaries=(16, 40)), epochs=2)
    js, ps = jnet.listeners[0], pnet.listeners[0]
    assert len(js.losses) == len(ps.losses) == 4
    np.testing.assert_allclose(ps.losses, js.losses, rtol=RTOL, atol=ATOL)
    for u, (jp, pp) in enumerate(zip(js.params, ps.params)):
        diffs = np.concatenate([np.abs(b[k] - a[k]).ravel() / max(float(np.abs(a[k]).max()), 1.0)
                                for a, b in zip(jp, pp) for k in a])
        off = diffs > ATOL + RTOL
        assert off.sum() <= max(1, diffs.size // 10_000), f"update {u + 1}: {off.sum()} off"
        assert diffs.max() <= ADAM_LR / 10, f"update {u + 1}: {diffs.max()}"
