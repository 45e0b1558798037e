"""MultiLayerNetwork and the zoo of the PyTorch port against the JAX package.

The networks start from the params the JAX package initialized, carried
across with `convert.params_from_jax`, and must give the same `output()`:
max|diff| <= 1e-5 * max(1, max|ref|) in f32.  LeNet runs at full size,
VGG16 at 32x32x3 with 10 classes (same layers, a smaller first Dense).  A
wrong flatten order (NCHW where the JAX package flattens NHWC) fails here.
"""
import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import zoo as jzoo
from deeplearning4j_tpu_torch import convert
from deeplearning4j_tpu_torch import zoo as tzoo
from deeplearning4j_tpu_torch.nn import MultiLayerConfiguration

CASES = {
    "LeNet": dict(),
    "VGG16": dict(input_shape=(32, 32, 3), n_classes=10),
}


def _pair(name):
    kw = CASES[name]
    jnet = getattr(jzoo, name)(**kw).init_model()
    tnet = getattr(tzoo, name)(**kw).init_model(device="cpu")
    tree = jax.tree_util.tree_map(np.asarray, jnet.params_)
    convert.params_from_jax(tnet, tree)
    return jnet, tnet, tree


@pytest.fixture(scope="module")
def lenet():
    return _pair("LeNet")


@pytest.fixture(scope="module")
def vgg16():
    return _pair("VGG16")


@pytest.mark.parametrize("name,kw", [("LeNet", {}), ("VGG16", {}),
                                     ("VGG19", {}),
                                     ("VGG16", dict(n_classes=10, seed=7))])
def test_config_json_equals_jax(name, kw):
    jd = getattr(jzoo, name)(**kw).conf().to_json()
    assert getattr(tzoo, name)(**kw).conf().to_json() == jd
    assert MultiLayerConfiguration.from_json(jd).to_json() == jd


@pytest.mark.parametrize("fixture", ["lenet", "vgg16"])
def test_output_matches_jax_from_carried_params(fixture, request):
    jnet, tnet, _ = request.getfixturevalue(fixture)
    assert tnet.conf.to_json() == jnet.conf.to_json()   # after init, too
    h, w, c = tnet.conf.input_type.shape
    x = np.random.RandomState(0).randn(5, h, w, c).astype(np.float32)
    want = np.asarray(jnet.output(x))
    got = tnet.output(x)
    assert got.device.type == "cpu" and got.dtype == torch.float32
    got = got.numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol


@pytest.mark.parametrize("fixture", ["lenet", "vgg16"])
def test_flat_params_and_tree_round_trip(fixture, request):
    jnet, tnet, tree = request.getfixturevalue(fixture)
    flat = tnet.params()
    np.testing.assert_array_equal(flat, np.asarray(jnet.params()))
    assert tnet.num_params() == jnet.num_params() == flat.size
    back = convert.params_to_jax(tnet)
    assert set(back) == set(tree)
    for name in tree:
        assert set(back[name]) == set(tree[name])
        for k in tree[name]:
            np.testing.assert_array_equal(back[name][k], tree[name][k])
    # set_params takes the same flat order back
    tnet.set_params(flat[::-1].copy())
    np.testing.assert_array_equal(tnet.params(), flat[::-1])
    tnet.set_params(flat)
    np.testing.assert_array_equal(tnet.params(), flat)


def test_flat_order_is_jax_tree_order(vgg16):
    _, tnet, _ = vgg16
    order = tnet._jax_leaves()
    # dict keys sorted as strings: layer_10 before layer_3, W before b
    assert order.index(("layer_10", "W")) < order.index(("layer_3", "W"))
    assert order.index(("layer_0", "W")) < order.index(("layer_0", "b"))
    keys = {f"{n}.{k}" for n, k in order}
    assert keys == set(tnet.state_dict())
    assert tuple(tnet.state_dict()["layer_0.W"].shape) == (64, 3, 3, 3)   # OIHW


def test_init_distribution_matches_jax(lenet):
    jnet, _, _ = lenet
    fresh = tzoo.LeNet().init_model(device="cpu")
    for name, k in (("layer_4", "W"), ("layer_0", "W")):
        a = fresh.params_[name][k].detach().numpy()
        b = np.asarray(jnet.params_[name][k])
        assert abs(a.mean()) < 0.05 * b.std()
        assert abs(a.std() / b.std() - 1.0) < 0.05
    assert float(fresh.params_["layer_4"]["b"].detach().abs().max()) == 0.0
    again = tzoo.LeNet().init_model(device="cpu")       # seeded: repeatable
    np.testing.assert_array_equal(again.params(), fresh.params())


def test_bf16_compute_dtype(lenet):
    jnet, tnet, tree = lenet
    lo = tzoo.LeNet(compute_dtype="bfloat16").init_model(device="cpu")
    convert.params_from_jax(lo, tree)
    assert lo.conf.compute_dtype == "bfloat16"
    assert lo.params_["layer_0"]["W"].dtype == torch.float32   # master f32
    x = np.random.RandomState(1).randn(3, 28, 28, 1).astype(np.float32)
    got = lo.output(x)
    assert got.dtype == torch.bfloat16
    want = tnet.output(x).numpy()
    assert float(np.abs(got.float().numpy() - want).max()) < 5e-2
