"""ZeRO-1, the sharded weight update of the PyTorch port
(``parallel/zero.py``), on 2 gloo ranks against the replicated update and
the JAX package's ``optimizer_sharding`` on a 2-device mesh (f64, 1e-10
relative; the rank pool of ``test_torch_parallel.py``).

Sgd under ZeRO-1 equals the replicated update bit for bit (a two-rank
reduce-scatter sums what the all-reduce sums); Adam over 10 steps, a
padded leaf (dim 0 of 9 over 2 ranks), `disable_zero1`, `fit_steps` and
a ComputationGraph hold the JAX package's numbers; each rank keeps the
moments of its rows only, and `opt_state_bytes_per_replica` equals the JAX
value for the same network on the same mesh, a conv network (whose
kernels the port keeps in another layout) included.

A SameDiff graph under ZeRO-1 (the JAX ``test_zero1_samediff_parity``:
MLP 4-16-3, Adam(1e-2), 10 steps of the same 32 rows on every rank):
its variables equal the JAX graph's on a 2-device mesh at rtol 1e-5 and
the replicated port graph's bit for bit; its plans are the JAX plans on
that mesh; ``fit_steps`` equals the ``fit`` loop bitwise; ``save`` writes
the moments whole; at world 1 it is the plain fit bit for bit.
"""
import torch_test_threads  # noqa: F401  (first: one torch thread a worker)
import numpy as np
import pytest

from deeplearning4j_tpu_torch.data import MultiDataSet
from deeplearning4j_tpu_torch.monitor.registry import registry
from deeplearning4j_tpu_torch.parallel import ParallelWrapper, disable_zero1, zero
from test_torch_parallel import (RankPool, bn_conf, cg_conf, cg_data, close, equal_trees,
                                 image_data, jax_snapshot, jax_start, jx, mlp_conf, mlp_data,
                                 port_net, ranks_equal, same_as_jax, snapshot)


@pytest.fixture(scope="module")
def pool():
    p = RankPool()
    yield p
    p.close()


def _task_ab(conf_json, params, state, x, y, steps, graph=False):
    """The same steps replicated and under ZeRO-1: both snapshots (ZeRO's
    moments gathered whole), the ZeRO net's moment shapes and the bytes
    each side keeps."""
    out = {}
    for on in (False, True):
        net = port_net(conf_json, params, state, graph)
        pw = ParallelWrapper.builder(net).optimizer_sharding(on).build()
        for _ in range(steps):
            pw.fit(MultiDataSet(x, y)) if graph else pw.fit(x, y)
        nbytes = zero.opt_state_bytes_per_replica(net.opt_state_)
        shapes = {name: {k: tuple(t.shape) for k, t in sub.get("m", {}).items()}
                  for name, sub in net.opt_state_.items() if isinstance(sub, dict)}
        pad_rows = None
        if on and not graph and net._step_transform.plans["layer_0"]["W"].pad:
            pad_rows = net.opt_state_["layer_0"]["m"]["W"][-1].abs().max().item()
        disable_zero1(net)
        out[on] = (snapshot(net), nbytes, shapes, pad_rows, net.score())
    return out, registry().gauge("training_opt_state_bytes", labels={"sharded": "true"}).value


def _task_disable(conf_json, params, state, x, y):
    net = port_net(conf_json, params, state)
    pw = ParallelWrapper.builder(net).optimizer_sharding(True).build()
    pw.fit(x, y)
    pw.optimizer_sharding(False)
    pw.fit(x, y)
    return (snapshot(net), net._step_transform is None,
            tuple(net.opt_state_["layer_0"]["m"]["W"].shape))


def _task_fit_steps(conf_json, params, state, xs, ys):
    out = []
    for on in (False, True):
        net = port_net(conf_json, params, state)
        losses = ParallelWrapper.builder(net).optimizer_sharding(on).build().fit_steps(xs, ys)
        disable_zero1(net)
        out.append((snapshot(net), losses.tolist()))
    return out


def _jax_zero(J, conf, steps, x, y, graph=False, on=True):
    from deeplearning4j_tpu.data.dataset import MultiDataSet
    jnet, *_ = jax_start(J, conf, graph)
    pw = J.par.ParallelWrapper(jnet, J.mesh2(), optimizer_sharding=on)
    for _ in range(steps):
        pw.fit(MultiDataSet(x, y)) if graph else pw.fit(x, y)
    nbytes = J.par.zero.opt_state_bytes_per_replica(jnet.opt_state_)
    J.par.zero.disable_zero1(jnet)
    return jax_snapshot(J, jnet), nbytes


@pytest.mark.parametrize("updater, steps", [("Sgd", 5), ("Adam", 10)])
def test_zero1_against_replicated_and_jax(pool, updater, steps):
    J = jx()
    upd = J.upd.Sgd(1e-1) if updater == "Sgd" else J.upd.Adam(1e-2)
    conf = mlp_conf(J, upd)
    _, conf_json, params, state = jax_start(J, conf)
    x, y = mlp_data(16)
    got = pool.run(_task_ab, conf_json, params, state, x, y, steps)
    ranks_equal([g[0][True][0] for g in got])
    repl, zero1 = got[0][0][False], got[0][0][True]
    if updater == "Sgd":
        equal_trees(zero1[0], repl[0])
        assert zero1[4] == repl[4]
    else:
        same_as_jax(zero1[0], repl[0])
    want, _ = _jax_zero(J, conf, steps, x, y)
    same_as_jax(zero1[0], want)
    if updater == "Adam":
        # W (8, 16) shards 4 rows a rank; the 3-wide output bias pads to 4
        assert zero1[2]["layer_0"] == {"W": (4, 16), "b": (8,)}
        assert zero1[2]["layer_1"] == {"W": (8, 3), "b": (2,)}


def test_zero1_padded_leaf(pool):
    """n_in = 9 over 2 ranks: W's moments pad to 10 rows, 5 a rank; the
    pad row stays zero and the result holds the JAX package's."""
    J = jx()
    conf = mlp_conf(J, J.upd.Adam(1e-2), n_in=9)
    _, conf_json, params, state = jax_start(J, conf)
    x, y = mlp_data(16, n_in=9)
    got = pool.run(_task_ab, conf_json, params, state, x, y, 6)
    ranks_equal([g[0][True][0] for g in got])
    assert [g[0][True][2]["layer_0"]["W"] for g in got] == [(5, 16), (5, 16)]
    assert got[1][0][True][3] == 0.0
    want, _ = _jax_zero(J, conf, 6, x, y)
    same_as_jax(got[0][0][True][0], want)
    same_as_jax(got[0][0][True][0], got[0][0][False][0])


def test_disable_zero1_gathers_the_moments_and_keeps_training(pool):
    J = jx()
    conf = mlp_conf(J, J.upd.Adam(1e-2), n_in=9)
    _, conf_json, params, state = jax_start(J, conf)
    x, y = mlp_data(16, n_in=9)
    got = pool.run(_task_disable, conf_json, params, state, x, y)
    for snap, off, shape in got:
        assert off and shape == (9, 16)
    ranks_equal([g[0] for g in got])
    want, _ = _jax_zero(J, conf, 2, x, y, on=False)
    same_as_jax(got[0][0], want)


def test_opt_state_bytes_per_replica_equals_jax(pool):
    """Per-rank updater-state bytes, replicated and sharded, equal the JAX
    package's per-device bytes for the same network on 2 devices: an MLP
    and a conv + BatchNorm network (a conv W is HWIO in the JAX layout,
    where ZeRO-1 plans it)."""
    J = jx()
    for conf, (x, y) in ((mlp_conf(J, J.upd.Adam(1e-2), n_in=9), mlp_data(8, n_in=9)),
                         (bn_conf(J, J.upd.Adam(1e-2)), image_data(8))):
        _, conf_json, params, state = jax_start(J, conf)
        got = pool.run(_task_ab, conf_json, params, state, x, y, 1)
        _, repl_bytes = _jax_zero(J, conf, 1, x, y, on=False)
        _, zero_bytes = _jax_zero(J, conf, 1, x, y)
        for out, gauge in got:
            assert out[False][1] == repl_bytes and out[True][1] == zero_bytes
            assert gauge == zero_bytes
        assert zero_bytes < repl_bytes


def test_zero1_fit_steps_and_computation_graph(pool):
    J = jx()
    conf = mlp_conf(J, J.upd.Adam(1e-2))
    jnet, conf_json, params, state = jax_start(J, conf)
    batches = [mlp_data(16, seed=s) for s in (7, 8, 9)]
    xs, ys = np.stack([b[0] for b in batches]), np.stack([b[1] for b in batches])
    jl = np.asarray(J.par.ParallelWrapper(jnet, J.mesh2(), optimizer_sharding=True)
                    .fit_steps(xs, ys))
    J.par.zero.disable_zero1(jnet)
    got = pool.run(_task_fit_steps, conf_json, params, state, xs, ys)
    ranks_equal([g[1][0] for g in got])
    (repl, repl_l), (zero1, zero_l) = got[0]
    same_as_jax(zero1, repl)
    same_as_jax(zero1, jax_snapshot(J, jnet))
    close(zero_l, jl, what="block losses")

    cconf = cg_conf(J, J.upd.Adam(1e-2))
    _, cjson, cparams, cstate = jax_start(J, cconf, graph=True)
    feats, labels = cg_data(12)
    got = pool.run(_task_ab, cjson, cparams, cstate, feats, labels, 4, True)
    ranks_equal([g[0][True][0] for g in got])
    want, _ = _jax_zero(J, cconf, 4, feats, labels, graph=True)
    same_as_jax(got[0][0][True][0], want)
    same_as_jax(got[0][0][True][0], got[0][0][False][0])


# ---------------------------------------------------------------------------
# SameDiff under ZeRO-1
# ---------------------------------------------------------------------------

def _sd_mlp(variables=None, device="cpu"):
    """The JAX test's graph, in the port: `variables` (numpy) in place of
    its initializers where given."""
    from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig
    from deeplearning4j_tpu_torch.train import Adam
    sd = SameDiff.create(device=device)
    x = sd.placeholder("input", shape=(-1, 4))
    y = sd.placeholder("label", shape=(-1, 3))
    v = variables or {}
    w0 = sd.var("w0", v.get("w0", "XAVIER"), 4, 16)
    b0 = sd.var("b0", v.get("b0", np.zeros(16, np.float32)))
    w1 = sd.var("w1", v.get("w1", "XAVIER"), 16, 3)
    b1 = sd.var("b1", v.get("b1", np.zeros(3, np.float32)))
    h = sd.nn.tanh(sd.nn.linear(x, w0, b0))
    logits = sd.nn.linear(h, w1, b1, name="logits")
    sd.loss.softmax_cross_entropy(y, logits, name="loss")
    sd.set_loss_variables("loss")
    sd.set_training_config(TrainingConfig(updater=Adam(1e-2),
                                          data_set_feature_mapping=["input"],
                                          data_set_label_mapping=["label"]))
    return sd


def _sd_vars(sd):
    return {k: v.detach().cpu().numpy() for k, v in sd.variables_.items()}


def _task_sd_zero1(variables, x, y, steps, out_dir):
    """The graph replicated, under ZeRO-1 through `fit`, and under ZeRO-1
    through one `fit_steps` block: variables, losses, plans, moment
    shapes and bytes a rank; the ZeRO-1 graph saved to `out_dir` (every
    rank saves: the moments are gathered)."""
    import os
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.parallel import make_mesh
    out = {}
    for side in ("repl", "zero1", "block"):
        sd = _sd_mlp(variables)
        zt = None
        if side != "repl":
            zt = zero.enable_zero1(sd, make_mesh(device="cpu"))
        if side == "block":
            losses = sd.fit_steps({"input": np.broadcast_to(x, (steps,) + x.shape),
                                   "label": np.broadcast_to(y, (steps,) + y.shape)}).tolist()
        else:
            losses = []
            for _ in range(steps):
                sd.fit(x, y)
                losses.append(sd.score())
        res = {"vars": _sd_vars(sd), "losses": losses,
               "bytes": zero.opt_state_bytes_per_replica(sd.opt_state_)}
        if zt is not None:
            res["kinds"] = {k: pl.kind for k, pl in zt.plans.items()}
            res["m_shapes"] = {k: tuple(t.shape) for k, t in sd.opt_state_["m"].items()}
        if side == "zero1":
            sd.save(os.path.join(out_dir, f"sd_{dist.get_rank()}.zip"))
        out[side] = res
    return out


def test_zero1_samediff_parity(pool, tmp_path):
    import jax
    from deeplearning4j_tpu.autodiff import SameDiff as JSameDiff
    from deeplearning4j_tpu.parallel import make_mesh as jmake_mesh
    from deeplearning4j_tpu.parallel import zero as jzero
    from test_zero1 import _data, _mlp_sd
    x, y = _data(n=32, n_in=4)
    ref, z = _mlp_sd(), _mlp_sd()
    variables = {k: np.asarray(v) for k, v in ref.variables_.items()}
    z.variables_ = {k: jax.numpy.asarray(v) for k, v in variables.items()}
    mesh = jmake_mesh({"data": 2}, jax.devices()[:2])
    jzt = jzero.enable_zero1(z, mesh)
    with mesh:
        for _ in range(10):
            z.fit(x, y)
    got = pool.run(_task_sd_zero1, variables, x, y, 10, str(tmp_path))
    for rank in got:
        for k, v in rank["zero1"]["vars"].items():
            np.testing.assert_allclose(v, np.asarray(z.variables_[k]), rtol=1e-5, atol=1e-6,
                                       err_msg=k)
            np.testing.assert_array_equal(v, rank["repl"]["vars"][k], err_msg=k)
            np.testing.assert_array_equal(v, rank["block"]["vars"][k], err_msg=k)
        assert rank["zero1"]["losses"] == rank["repl"]["losses"] == rank["block"]["losses"]
        jkinds = {k: pl.kind for k, pl in jzt.plans.items()}
        assert rank["zero1"]["kinds"] == jkinds == {"b0": "shard", "b1": "shard",
                                                    "w0": "shard", "w1": "shard"}
        # each rank keeps its rows of the padded moments: b1 (3,) pads to 4
        assert rank["zero1"]["m_shapes"] == {"b0": (8,), "b1": (2,), "w0": (2, 16),
                                             "w1": (8, 3)}
        assert rank["zero1"]["bytes"] < rank["repl"]["bytes"]
    ranks_equal([r["zero1"]["vars"] for r in got])
    # the saved moments are whole: the JAX package loads them next to its own
    loaded = JSameDiff.load(str(tmp_path / "sd_1.zip"))
    jzero.disable_zero1(z)
    for k in ("m", "v"):
        for n, a in loaded.opt_state_[k].items():
            np.testing.assert_allclose(np.asarray(a), np.asarray(z.opt_state_[k][n]),
                                       rtol=1e-5, atol=1e-7, err_msg=f"{k}.{n}")


def test_zero1_samediff_at_world_1_is_the_plain_fit():
    from deeplearning4j_tpu_torch.parallel import make_mesh
    x, y = (a.astype(np.float32) for a in mlp_data(16, n_in=4))
    plain = _sd_mlp()
    z = _sd_mlp(_sd_vars(plain))
    zero.enable_zero1(z, make_mesh(device="cpu"))
    for _ in range(4):
        plain.fit(x, y)
        z.fit(x, y)
        assert z.score() == plain.score()
    equal_trees(_sd_vars(z), _sd_vars(plain))
    disable_zero1(z)
    equal_trees({k: v.numpy() for k, v in z.opt_state_["m"].items()},
                {k: v.numpy() for k, v in plain.opt_state_["m"].items()})
