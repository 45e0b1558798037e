"""The ModelSerializer zip crosses between the JAX package and the PyTorch
port, both ways, for a MultiLayerNetwork (full-width LeNet) and a small
ComputationGraph (3x3 conv, BatchNorm, Adam).

The networks run in f64 on the CPU.  A model restored from the other
package's zip must give that package's output within 1e-10 relative, and
two more fit steps must give the writer's next two losses within 1e-10
relative (exact resume: parameters, BatchNorm state, Adam moments and the
iteration counter all come back).  For one net written by both packages
the member names and manifest JSON are equal and the three binary members
are bitwise equal.
"""
import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import nn as jnn
from deeplearning4j_tpu import zoo as jzoo
from deeplearning4j_tpu.train import updaters as jupd
from deeplearning4j_tpu_torch import convert
from deeplearning4j_tpu_torch.nn import (ComputationGraph,
                                         ComputationGraphConfiguration,
                                         MultiLayerConfiguration,
                                         MultiLayerNetwork)
from deeplearning4j_tpu_torch.utils import serialization

RTOL = 1e-10


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-300)
    err = float(np.abs(got - want).max())
    assert err <= RTOL * scale, f"{what}: max|diff| {err} > {RTOL} * {scale}"


def _lenet_conf(dtype="float64"):
    conf = jzoo.LeNet().conf()
    conf.dtype = dtype
    return conf


def _graph_conf(dtype="float64"):
    b = (jnn.GraphBuilder().seed(7).updater(jupd.Adam(1e-2)).dtype(dtype)
         .add_inputs("in").set_input_types(jnn.InputType.convolutional(6, 6, 2)))
    b.add_layer("conv", jnn.ConvolutionLayer(n_out=4, kernel_size=3,
                                             convolution_mode="Same",
                                             activation="identity",
                                             has_bias=False), "in")
    b.add_layer("bn", jnn.BatchNormalizationLayer(activation="relu"), "conv")
    b.add_layer("pool", jnn.GlobalPoolingLayer(pooling_type="AVG"), "bn")
    b.add_layer("out", jnn.OutputLayer(n_out=3, loss="mcxent",
                                       activation="softmax"), "pool")
    return b.set_outputs("out").build()


KINDS = {
    "lenet": (_lenet_conf, jnn.MultiLayerNetwork, MultiLayerConfiguration,
              MultiLayerNetwork, (28, 28, 1), 10),
    "graph": (_graph_conf, jnn.ComputationGraph, ComputationGraphConfiguration,
              ComputationGraph, (6, 6, 2), 3),
}


def _batches(kind, n, seed, batch=4):
    shape, classes = KINDS[kind][4], KINDS[kind][5]
    rs = np.random.RandomState(seed)
    return [(rs.rand(batch, *shape), np.eye(classes)[rs.randint(0, classes, batch)])
            for _ in range(n)]


def _out(net, x):
    y = net.output(x)
    y = y[0] if isinstance(y, list) else y
    return y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


def _nets(kind, dtype="float64"):
    conf_fn, JNet, TConf, TNet = KINDS[kind][:4]
    jnet = JNet(conf_fn(dtype)).init()
    tnet = TNet(TConf.from_json(jnet.conf.to_json()), device="cpu").init()
    convert.params_from_jax(tnet, jax.tree_util.tree_map(np.asarray, jnet.params_))
    return jnet, tnet


@pytest.mark.parametrize("kind", list(KINDS))
def test_jax_zip_loads_in_the_port_and_resumes_exactly(kind, tmp_path):
    jnet, _ = _nets(kind)
    first, more = _batches(kind, 2, 1), _batches(kind, 2, 2)
    for x, y in first:
        jnet.fit(x, y)
    path = str(tmp_path / "jax.zip")
    jnet.save(path)
    tnet = KINDS[kind][3].load(path, device="cpu")
    assert type(tnet) is KINDS[kind][3] and tnet.iteration == 2
    x = _batches(kind, 1, 3)[0][0]
    _close(_out(tnet, x), _out(jnet, x), "output")
    for x, y in more:
        jnet.fit(x, y)
        tnet.fit(x, y)
        _close(tnet.score(), jnet.score(), "resumed loss")


@pytest.mark.parametrize("kind", list(KINDS))
def test_port_zip_loads_in_jax_and_resumes_exactly(kind, tmp_path):
    jnet, tnet = _nets(kind)
    first, more = _batches(kind, 2, 4), _batches(kind, 2, 5)
    for x, y in first:
        tnet.fit(x, y)
    path = str(tmp_path / "port.zip")
    tnet.save(path)
    jback = KINDS[kind][1].load(path)
    assert jback.iteration == 2
    x = _batches(kind, 1, 6)[0][0]
    _close(_out(jback, x), _out(tnet, x), "output")
    for x, y in more:
        tnet.fit(x, y)
        jback.fit(x, y)
        _close(jback.score(), tnet.score(), "resumed loss")


def _carry_everything(jnet, tnet):
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)   # noqa: E731
    convert.params_from_jax(tnet, to_np(jnet.params_))
    convert.state_from_jax(tnet, to_np(jnet.state_))
    convert.opt_state_from_jax(tnet, to_np(jnet.opt_state_))
    tnet.iteration, tnet.epoch = jnet.iteration, jnet.epoch


@pytest.mark.parametrize("kind", list(KINDS))
def test_one_net_gives_the_same_zip_members_in_both_packages(kind, tmp_path):
    jnet, tnet = _nets(kind)
    for x, y in _batches(kind, 2, 7):
        jnet.fit(x, y)
    _carry_everything(jnet, tnet)
    jnet.save(str(tmp_path / "j.zip"))
    tnet.save(str(tmp_path / "t.zip"))
    with zipfile.ZipFile(tmp_path / "j.zip") as zj, zipfile.ZipFile(tmp_path / "t.zip") as zt:
        assert zt.namelist() == zj.namelist()
        assert all(i.compress_type == zipfile.ZIP_DEFLATED for i in zt.infolist())
        for member in ("configuration.json", "manifest.json", "coefficients.bin",
                       "layerState.bin", "updaterState.bin"):
            assert zt.read(member) == zj.read(member), member
        manifest = json.loads(zt.read("manifest.json"))
    assert manifest["format"] == "deeplearning4j_tpu.model.v1"
    assert manifest["iteration"] == 2


def test_save_updater_false_both_ways(tmp_path):
    jnet, tnet = _nets("lenet")
    for x, y in _batches("lenet", 1, 8):
        jnet.fit(x, y)
        tnet.fit(x, y)
    jnet.save(str(tmp_path / "j.zip"), save_updater=False)
    tnet.save(str(tmp_path / "t.zip"), save_updater=False)
    for path in ("j.zip", "t.zip"):
        with zipfile.ZipFile(tmp_path / path) as z:
            assert "updaterState.bin" not in z.namelist()
            assert "updater" not in json.loads(z.read("manifest.json"))
    back = MultiLayerNetwork.load(str(tmp_path / "j.zip"), device="cpu")
    jback = jnn.MultiLayerNetwork.load(str(tmp_path / "t.zip"))
    assert all(float(t.abs().max()) == 0.0 for t in
               jax.tree_util.tree_leaves(back.opt_state_))        # fresh Adam state
    assert all(float(jnp.abs(a).max()) == 0.0 for a in
               jax.tree_util.tree_leaves(jback.opt_state_))
    x = _batches("lenet", 1, 9)[0][0]
    _close(_out(back, x), _out(jnet, x), "output")
    _close(_out(jback, x), _out(tnet, x), "output")


def test_bf16_params_cross_bitwise_both_ways(tmp_path):
    """numpy has no bfloat16: the port writes and reads the JAX package's
    "bfloat16" leaves as raw 16-bit patterns."""
    jnet = jnn.MultiLayerNetwork(_lenet_conf("bfloat16")).init()
    jnet.save(str(tmp_path / "j.zip"))
    with zipfile.ZipFile(tmp_path / "j.zip") as z:
        manifest = json.loads(z.read("manifest.json"))
    assert {e["dtype"] for e in manifest["params"]} == {"bfloat16"}
    tnet = MultiLayerNetwork.load(str(tmp_path / "j.zip"), device="cpu")
    jbits = {n: {k: np.asarray(v).view(np.uint16) for k, v in sub.items()}
             for n, sub in jnet.params_.items()}
    for n, sub in tnet.params_.items():
        for k, v in sub.items():
            assert v.dtype == torch.bfloat16
            layer = tnet.layer_by_name(n)
            bits = convert.jax_view(layer, k, v.detach()).contiguous().view(torch.uint16)
            np.testing.assert_array_equal(bits.numpy(), jbits[n][k], err_msg=f"{n}.{k}")
    with torch.no_grad():                        # move off the JAX values
        for p in tnet.parameters():
            p.mul_(0.5)
    tnet.save(str(tmp_path / "t.zip"))
    jback = jnn.MultiLayerNetwork.load(str(tmp_path / "t.zip"))
    for n, sub in tnet.params_.items():
        for k, v in sub.items():
            bits = convert.jax_view(tnet.layer_by_name(n), k, v.detach()).contiguous()
            np.testing.assert_array_equal(
                np.asarray(jback.params_[n][k]).view(np.uint16),
                bits.view(torch.uint16).numpy(), err_msg=f"{n}.{k}")
    assert serialization.read_normalizer(str(tmp_path / "t.zip"), object) is None
