"""The PyTorch port's CNN layers against the JAX package.

``ConvolutionLayer`` (truncate, strict and same modes, with stride, dilation,
explicit padding and Same's asymmetric pads, AlexNet's conv1 among them) and
``SubsamplingLayer`` (max, avg and sum in truncate, padded truncate and same
mode) are built from the JAX layer's JSON, given the same numpy params and
NHWC input, and held to the JAX layer's output and its gradients in x and
the params (JAX's VJP against autograd, the same upstream gradient) at 1e-5
(f32 on both sides; sums in another order). Also: every ``conv_output_size``
raise, max pooling's gradient where a window holds ties, the dense layer's
flatten order of an NHWC image, the CNN input types' JSON, and the layers of
these modules that wait for a later slice.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deeplearning4j_tpu as dj  # noqa: E402
from deeplearning4j_tpu.nn.layers.convolution import conv_output_size as jax_size  # noqa: E402
from deeplearning4j_tpu.nn.layers.convolution import Convolution1DLayer  # noqa: E402
from deeplearning4j_tpu.nn.layers.convolution import ZeroPaddingLayer  # noqa: E402

import deeplearning4j_tpu_torch as pt  # noqa: E402
from deeplearning4j_tpu_torch.nn.layers.convolution import conv_output_size  # noqa: E402

ATOL = RTOL = 1e-5  # f32 on both sides; sums in another order
B = 2

CONV_CASES = {
    # name: (layer kwargs, input H, W, C)
    "truncate_padded": (dict(n_out=5, kernel=(3, 2), stride=(2, 1), padding=(1, 0)), 9, 8, 3),
    "strict": (dict(n_out=4, kernel=(3, 3), stride=(2, 2), padding=(1, 1),
                    convolution_mode="strict"), 9, 9, 2),
    "same_asymmetric": (dict(n_out=4, kernel=(4, 3), stride=(2, 2), convolution_mode="same"),
                        9, 8, 3),
    "same_dilated": (dict(n_out=3, kernel=(2, 3), dilation=(2, 1), convolution_mode="same"),
                     7, 6, 2),
    "truncate_dilated": (dict(n_out=3, kernel=(3, 3), dilation=(2, 2), stride=(1, 2)), 9, 10, 2),
    "alexnet_conv1": (dict(n_out=6, kernel=(11, 11), stride=(4, 4), convolution_mode="same",
                           activation="relu"), 20, 20, 3),
    "no_bias_tanh": (dict(n_out=4, kernel=(2, 2), has_bias=False, activation="tanh"), 5, 6, 3),
}
POOL_CASES = {
    "truncate": (dict(kernel=(3, 3), stride=(2, 2)), 9, 8),
    "truncate_padded": (dict(kernel=(3, 2), stride=(2, 2), padding=(1, 1)), 7, 8),
    "same": (dict(kernel=(3, 3), stride=(2, 2), convolution_mode="same"), 8, 7),
    "same_stride3": (dict(kernel=(2, 4), stride=(3, 3), convolution_mode="same"), 7, 10),
}


def _port_layer(jlayer, it):
    """The port's layer from the JAX layer's JSON."""
    conf = dj.MultiLayerConfiguration(layers=[jlayer], input_type=it)
    return pt.MultiLayerConfiguration.from_json(conf.to_json()).layers[0]


def _vjp_both(jlayer, player, params, x, seed):
    """(out, dx, dparams) of each package for one upstream gradient g."""
    def jf(xx, pp):
        return jlayer.apply(pp, xx, {})[0]

    jout, vjp = jax.vjp(jf, jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()})
    g = np.random.default_rng(seed).normal(size=jout.shape).astype(np.float32)
    jdx, jdp = vjp(jnp.asarray(g))
    tx = torch.tensor(x, requires_grad=True)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    out, _ = player.apply(tp, tx, {})
    out.backward(torch.from_numpy(g))
    return ((np.asarray(jout), np.asarray(jdx), {k: np.asarray(v) for k, v in jdp.items()}),
            (out.detach().numpy(), tx.grad.numpy(), {k: v.grad.numpy() for k, v in tp.items()}))


def _assert_same(want, got):
    (wo, wdx, wdp), (go, gdx, gdp) = want, got
    assert go.shape == wo.shape
    np.testing.assert_allclose(go, wo, atol=ATOL, rtol=RTOL, err_msg="out")
    np.testing.assert_allclose(gdx, wdx, atol=ATOL, rtol=RTOL, err_msg="dx")
    for k in wdp:
        np.testing.assert_allclose(gdp[k], wdp[k], atol=ATOL, rtol=RTOL, err_msg=k)


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_convolution_layer_matches_jax(case):
    kw, h, w, c = CONV_CASES[case]
    it = dj.InputType.convolutional(h, w, c)
    jlayer = dj.ConvolutionLayer(**kw)
    player = _port_layer(jlayer, it)
    params = {k: np.asarray(v, np.float32) + 0.05
              for k, v in jlayer.init_params(jax.random.PRNGKey(1), it).items()}
    assert {k: v.shape for k, v in player.init_params(torch.Generator(), it).items()} == {
        k: v.shape for k, v in params.items()}
    x = np.random.default_rng(2).normal(size=(B, h, w, c)).astype(np.float32)
    want, got = _vjp_both(jlayer, player, params, x, seed=3)
    want_type = jlayer.get_output_type(it)
    assert got[0].shape == (B, want_type.height, want_type.width, want_type.channels)
    _assert_same(want, got)


def test_alexnet_conv1_pads_asymmetrically():
    conv1 = pt.alexnet_conf().layers[0]
    assert conv1.pads(224, 224) == ((3, 4), (3, 4))
    assert conv1.get_output_type(pt.InputType.convolutional(224, 224, 3)).height == 56


def test_convolution_init_fans_follow_the_reference():
    """fan_in = in*kh*kw, fan_out = out*kh*kw / stride area: xavier's
    std is sqrt(2 / (fan_in + fan_out))."""
    layer = pt.ConvolutionLayer(n_out=64, kernel=(5, 5), stride=(2, 2))
    w = layer.init_params(torch.Generator().manual_seed(0),
                          pt.InputType.convolutional(32, 32, 32))["W"]
    assert tuple(w.shape) == (5, 5, 32, 64)
    want = (2.0 / (32 * 25 + 64 * 25 / 4)) ** 0.5
    assert float(w.std()) == pytest.approx(want, rel=0.02)


@pytest.mark.parametrize("pooling", ["max", "avg", "sum"])
@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_subsampling_layer_matches_jax(case, pooling):
    kw, h, w = POOL_CASES[case]
    it = dj.InputType.convolutional(h, w, 3)
    jlayer = dj.SubsamplingLayer(pooling_type=pooling, **kw)
    player = _port_layer(jlayer, it)
    x = np.random.default_rng(4).normal(size=(B, h, w, 3)).astype(np.float32)
    want, got = _vjp_both(jlayer, player, {}, x, seed=5)
    want_type = jlayer.get_output_type(it)
    assert got[0].shape == (B, want_type.height, want_type.width, 3)
    _assert_same(want, got)


def test_unknown_pooling_type_raises():
    layer = pt.SubsamplingLayer(pooling_type="median")
    with pytest.raises(ValueError, match="median"):
        layer.apply({}, torch.zeros((1, 4, 4, 1)), {})


@pytest.mark.parametrize("kernel,stride", [((2, 2), (2, 2)), ((3, 3), (2, 2)), ((3, 3), (1, 1))])
def test_max_pool_gradient_with_ties(kernel, stride):
    """Windows that hold ties, as ReLU's zeros and bf16's coarse values make
    them: both packages send a window's gradient to its first largest
    element in row-major order (the top-left one of an all-equal window);
    overlapping windows add up where they pick the same element."""
    rng = np.random.default_rng(6)
    x = rng.integers(0, 3, size=(B, 7, 7, 2)).astype(np.float32)  # values 0, 1, 2
    x[0, :4, :4, 0] = 1.0  # an all-equal patch
    jlayer = dj.SubsamplingLayer(pooling_type="max", kernel=kernel, stride=stride)
    player = _port_layer(jlayer, dj.InputType.convolutional(7, 7, 2))
    want, got = _vjp_both(jlayer, player, {}, x, seed=7)
    np.testing.assert_array_equal(got[1], want[1])
    # the all-equal window at the top-left corner sends all to its first element
    one = np.ones((1, kernel[0], kernel[1], 1), np.float32)
    t = torch.tensor(one, requires_grad=True)
    player.apply({}, t, {})[0].sum().backward()
    first = np.zeros_like(one)
    first[0, 0, 0, 0] = 1.0
    np.testing.assert_array_equal(t.grad.numpy(), first)


def test_conv_output_size_raises_as_jax_does():
    cases = [  # (args, match)
        ((2, 3, 1, 0, "truncate"), "output size is 0"),
        ((4, 3, 2, 0, "strict"), "not divisible"),
        ((8, 3, 1, 1, "same"), "explicit padding"),
        ((5, 3, 1, 0, "truncate", 3), "output size is -1"),
    ]
    for args, match in cases:
        for fn in (conv_output_size, jax_size):
            with pytest.raises(ValueError, match=match):
                fn(*args)
    for args in [(9, 3, 2, 1, "strict"), (224, 11, 4, 0, "same"), (9, 3, 2, 0, "truncate", 2)]:
        assert conv_output_size(*args) == jax_size(*args)
    with pytest.raises(ValueError, match="output size"):
        pt.alexnet_conf(height=32, width=32, n_classes=4).layer_input_types()
    with pytest.raises(ValueError, match="CNN input"):
        pt.ConvolutionLayer(n_out=2).get_output_type(pt.InputType.feed_forward(4))


def test_dense_layer_flattens_nhwc_in_h_w_c_order():
    """A DenseLayer after a CNN layer flattens [B, H, W, C] in (h, w, c)
    order, so the JAX W of AlexNet's 9216-wide layer loads as it is."""
    rng = np.random.default_rng(8)
    it = dj.InputType.convolutional(2, 3, 4)
    jlayer = dj.DenseLayer(n_out=5, activation="tanh")
    player = _port_layer(jlayer, it)
    params = {"W": rng.normal(size=(24, 5)).astype(np.float32),
              "b": rng.normal(size=5).astype(np.float32)}
    x = rng.normal(size=(B, 2, 3, 4)).astype(np.float32)
    want, got = _vjp_both(jlayer, player, params, x, seed=9)
    _assert_same(want, got)


def test_cnn_input_types_round_trip_with_jax():
    for it in (dj.InputType.convolutional(5, 6, 7), dj.InputType.convolutional_flat(5, 6, 7)):
        mine = pt.InputType.from_dict(json.loads(json.dumps(it.to_dict())))
        assert mine.to_dict() == it.to_dict()
        assert dj.InputType.from_dict(mine.to_dict()) == it
        assert mine.flat_size() == it.flat_size() == 210
        assert mine.example_shape() == it.example_shape()
        assert mine.batch_shape(3) == it.batch_shape(3)
    with pytest.raises(ValueError, match="kind"):
        pt.InputType.from_dict({"kind": "volume"})


GLOBAL_POOL_CASES = [(kind, shape, masked) for kind in ("max", "avg", "sum", "pnorm")
                     for shape, masked in (((B, 3, 4, 5), False), ((B, 6, 5), False),
                                           ((B, 6, 5), True))]


@pytest.mark.parametrize("kind,shape,masked", GLOBAL_POOL_CASES,
                         ids=[f"{k}_{len(s)}d{'_masked' if m else ''}"
                              for k, s, m in GLOBAL_POOL_CASES])
def test_global_pooling_layer_matches_jax(kind, shape, masked):
    """Images pooled over H and W, sequences over time, with a [B, T] mask
    that leaves steps out (a row with one live step among them): out and dx."""
    it = (dj.InputType.convolutional(*shape[1:]) if len(shape) == 4
          else dj.InputType.recurrent(shape[2], shape[1]))
    jlayer = dj.GlobalPoolingLayer(pooling_type=kind, pnorm=3)
    player = _port_layer(jlayer, it)
    assert player.get_output_type(it).to_dict() == jlayer.get_output_type(it).to_dict()
    rng = np.random.default_rng(len(shape) + len(kind))
    x = rng.normal(size=shape).astype(np.float32)
    mask = np.array([[1, 1, 1, 0, 0, 0], [0, 1, 0, 0, 0, 0]], np.float32) if masked else None
    g = rng.normal(size=(B, shape[-1])).astype(np.float32)
    jout, vjp = jax.vjp(lambda xx: jlayer.apply(
        {}, xx, {}, mask=None if mask is None else jnp.asarray(mask))[0], jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(g))
    tx = torch.tensor(x, requires_grad=True)
    out, _ = player.apply({}, tx, {}, mask=None if mask is None else torch.tensor(mask))
    out.backward(torch.tensor(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("jlayer", [ZeroPaddingLayer(pad_top=1), Convolution1DLayer(n_out=2)],
                         ids=lambda l: type(l).__name__)
def test_layers_of_a_later_slice_raise_naming_the_class(jlayer):
    """Both layers waited for a later slice and raised; they are ported now
    (tests/test_torch_sequence_layers.py holds their math): the JAX conf
    JSON loads into the port's class of the same name and fields."""
    conf = dj.MultiLayerConfiguration(layers=[jlayer],
                                      input_type=dj.InputType.convolutional(4, 4, 2))
    layer = pt.MultiLayerConfiguration.from_json(conf.to_json()).layers[0]
    assert type(layer).__name__ == type(jlayer).__name__
    assert layer.to_dict() == {k: v for k, v in jlayer.to_dict().items()
                               if k in layer.to_dict()}
