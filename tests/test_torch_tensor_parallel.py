"""Tensor parallelism and composed dp x tp x pp of the PyTorch port
(``parallel/sharding.py``, the wrapper's ``sharding_rules``,
``parallel/composed.py``) against the JAX package's on a mesh of four.

A module-scoped pool of 4 gloo ranks on the CPU (``RankPool`` of
``test_torch_parallel.py``) runs each task on every rank; the parent runs
the JAX side on 4 of the 8 virtual CPU devices.  Every network starts from
the JAX package's initial parameters and takes the same global batches,
made with numpy from a seed.

Tolerances (max|diff| <= rtol * max|ref| per tensor): the wrapper's
networks in f64 at 1e-10, against the JAX wrapper on the same mesh and
against plain single-device fits; the composed transformer stack in f32
(its ring attention keeps f32 statistics in both packages), at 2e-5 for
its forward against JAX ``composed_apply`` and 1e-4 for two SGD steps
against JAX ``composed_oracle``'s trajectory (the JAX package's own
``tests/test_composed.py`` bounds are 1e-4 and 1e-3).
"""
import torch_test_threads  # noqa: F401  (first: one torch thread a worker)
import copy
import os

import numpy as np
import pytest
import torch

from tests.test_torch_parallel import RankPool, close, close_trees, port_net, snapshot

WORLD = 4
RTOL = 1e-10
COMPOSED_FWD_RTOL, COMPOSED_STEP_RTOL = 2e-5, 1e-4


@pytest.fixture(scope="module")
def pool():
    p = RankPool(WORLD)
    yield p
    p.close()


def _jax():
    import jax
    from deeplearning4j_tpu import nn as jnn
    from deeplearning4j_tpu import parallel as jpar
    from deeplearning4j_tpu.train import updaters as jupd
    return jax, jnn, jpar, jupd


# ---------------------------------------------------------------------------
# ShardingRules
# ---------------------------------------------------------------------------

def _leaves_with_paths(tree, path=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves_with_paths(v, path + (k,))
        else:
            yield path + (k,), v


def test_spec_for_every_leaf_of_lenet_and_vgg_matches_jax():
    """The default and a custom rule set give the JAX package's spec for
    every leaf (JAX path, JAX shape) of the zoo's LeNet and a 32 px VGG16,
    and each split maps to the port's layout (a conv's HWIO dim 3 is its
    OIHW dim 0); ``shard_model_params`` cuts rank 0's block of each split
    leaf there."""
    jax, _, jpar, _ = _jax()
    from jax.sharding import PartitionSpec as JP
    from deeplearning4j_tpu.parallel.sharding import ShardingRules as JRules
    from deeplearning4j_tpu_torch import convert
    from deeplearning4j_tpu_torch.parallel import (PartitionSpec as P, ShardingRules,
                                                   shard_model_params)
    from deeplearning4j_tpu_torch.parallel.mesh import Mesh
    from deeplearning4j_tpu_torch.parallel.sharding import leaf_shard
    from deeplearning4j_tpu_torch.zoo import LeNet, VGG16
    jmesh = jpar.make_mesh({"data": 4, "model": 2}, jax.devices()[:8])
    mesh = Mesh({"data": 4, "model": 2}, range(8), 0, torch.device("cpu"), False)
    rule_sets = [(JRules(), ShardingRules()),
                 (JRules().add(r"layer_0/W", JP(None, None, None, "model"))
                  .add(r".*_1/b", JP("model")),
                  ShardingRules().add(r"layer_0/W", P(None, None, None, "model"))
                  .add(r".*_1/b", P("model")))]
    n = 0
    for model in (LeNet(), VGG16(input_shape=(32, 32, 3), n_classes=10)):
        net = model.init_model(device="cpu")
        layouts = {name: convert._layer_or_layout(net, name).TORCH_LAYOUT or {}
                   for name in net.params_}
        blocks = shard_model_params(net.params_, mesh, ShardingRules(), layouts)
        for name, sub in net.params_.items():
            layout = convert._layer_or_layout(net, name).TORCH_LAYOUT or {}
            for path, leaf in _leaves_with_paths(sub):
                perm = layout.get(path[-1])
                jshape = (tuple(leaf.shape) if perm is None else
                          tuple(leaf.shape[perm.index(i)] for i in range(leaf.ndim)))
                p = "/".join((name,) + path)
                for jr, tr in rule_sets:
                    want = tuple(jr.spec_for(p, jshape, jmesh))
                    got = tr.spec_for(p, jshape, mesh)
                    assert tuple(got) == want, (p, got, want)
                    ls = leaf_shard(got, tuple(leaf.shape), perm, mesh, p)
                    if any(a is not None for a in want):
                        jdim = [a is not None for a in want].index(True)
                        assert ls is not None and leaf.shape[ls.dim] == jshape[jdim], p
                    else:
                        assert ls is None, p
                    n += 1
                blk = blocks[name][path[-1]]
                ls = leaf_shard(rule_sets[0][1].spec_for(p, jshape, mesh), tuple(leaf.shape),
                                perm, mesh, p)
                want_blk = leaf if ls is None else leaf.narrow(ls.dim, 0, leaf.shape[ls.dim] // 2)
                assert torch.equal(blk, want_blk), p
    assert n == 80, n         # (LeNet 8 + VGG16 32 leaves) x 2 rule sets


# ---------------------------------------------------------------------------
# the wrapper with sharding rules
# ---------------------------------------------------------------------------

def _vgg_conf(jnn, jupd):
    """A narrow VGG: two 3x3 Same convs, a max pool, a relu Dense and the
    softmax head, f64, no dropout."""
    return (jnn.NeuralNetConfiguration.builder().seed(3).updater(jupd.Adam(1e-2))
            .dtype("float64")
            .list([jnn.ConvolutionLayer(n_out=4, kernel_size=3, convolution_mode="Same",
                                        activation="relu"),
                   jnn.ConvolutionLayer(n_out=6, kernel_size=3, convolution_mode="Same",
                                        activation="relu"),
                   jnn.SubsamplingLayer(pooling_type="MAX", kernel_size=2, stride=2),
                   jnn.DenseLayer(n_out=8, activation="relu"),
                   jnn.OutputLayer(n_out=4, loss="mcxent", activation="softmax")])
            .set_input_type(jnn.InputType.convolutional(8, 8, 3)).build())


def _mlp_conf(jnn, jupd):
    return (jnn.NeuralNetConfiguration.builder().seed(7).updater(jupd.Adam(1e-2))
            .dtype("float64")
            .list([jnn.DenseLayer(n_out=16, activation="relu"),
                   jnn.OutputLayer(n_out=4, loss="mcxent", activation="softmax")])
            .set_input_type(jnn.InputType.feed_forward(8)).build())


def _cg_conf(jnn, jupd):
    return (jnn.GraphBuilder().seed(5).updater(jupd.Adam(1e-2)).dtype("float64")
            .add_inputs("in").set_input_types(jnn.InputType.feed_forward(8))
            .add_layer("d", jnn.DenseLayer(n_out=16, activation="tanh"), "in")
            .add_layer("out", jnn.OutputLayer(n_out=4, loss="mcxent", activation="softmax"),
                       "d")
            .set_outputs("out").build())


def _conf(model, jnn, jupd):
    return {"vgg": _vgg_conf, "mlp": _mlp_conf, "cg": _cg_conf}[model](jnn, jupd)


def _data(kind, n=16, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.rand(n, 8, 8, 3) if kind == "vgg" else rs.randn(n, 8)
    return x, np.eye(4)[rs.randint(0, 4, n)]


def _rules(kind, P):
    from deeplearning4j_tpu_torch.parallel import ShardingRules as TR
    try:
        from deeplearning4j_tpu.parallel.sharding import ShardingRules as JR
    except ImportError:                                   # the ranks import no JAX
        JR = None
    R = TR if P.__module__.startswith("deeplearning4j_tpu_torch") else JR
    if kind == "default":
        return R()
    if kind == "custom":
        return R().add(r".*layer_0.*W", P(None, "model")).add(r".*layer_0.*b", P("model"))
    return R().add(r"layer_0/W", P(None, "model")).add(r".*", P())


def _task_tp_fit(conf_json, params, x, y, kind, zero1, steps, graph=False, fused=False):
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper, PartitionSpec, make_mesh
    mesh = make_mesh({"data": 2, "model": 2}, device="cpu")
    net = port_net(conf_json, params, graph=graph)
    pw = ParallelWrapper(net, mesh, sharding_rules=_rules(kind, PartitionSpec),
                         optimizer_sharding=zero1)
    losses = []
    if fused:
        losses = pw.fit_steps(np.broadcast_to(x, (steps,) + x.shape),
                              np.broadcast_to(y, (steps,) + y.shape)).tolist()
    for _ in range(0 if fused else steps):
        pw.fit(x, y)
        losses.append(net.score())
    stored = {name: {k: tuple(v.shape) for k, v in sub.items()}
              for name, sub in net.params_.items() if sub}
    moments = {name: {k: tuple(v.shape) for k, v in sub["m"].items()}
               for name, sub in net.opt_state_.items() if sub and sub["m"]}
    flat = net.params()
    return snapshot(net, opt=not zero1), stored, moments, losses, flat


def _jax_tp_fit(conf, x, y, kind, zero1, steps, graph=False, fused=False):
    jax, jnn, jpar, _ = _jax()
    from jax.sharding import PartitionSpec as JP
    make = jnn.ComputationGraph if graph else jnn.MultiLayerNetwork
    start = make(conf).init()
    params = jax.tree_util.tree_map(np.asarray, start.params_)
    tp = make(conf).init()
    mesh = jpar.make_mesh({"data": 2, "model": 2}, jax.devices()[:4])
    pw = jpar.ParallelWrapper(tp, mesh, sharding_rules=_rules(kind, JP),
                              optimizer_sharding=zero1)
    plain = make(conf).init()
    if fused:
        pw.fit_steps(np.broadcast_to(x, (steps,) + x.shape),
                     np.broadcast_to(y, (steps,) + y.shape))
    for i in range(steps):
        if not fused:
            pw.fit(x, y)
        plain.fit(x, y)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)   # noqa: E731
    rules = _rules(kind, JP)
    # (the rules' spec, the spec of the leaf's Adam moment after the steps)
    specs = {name: {k: (tuple(rules.spec_for(f"{name}/{k}", v.shape, mesh)),
                        tuple(tp.opt_state_[name]["m"][k].sharding.spec))
                    for k, v in sub.items()}
             for name, sub in tp.params_.items() if sub}
    want = {name: sub for name, sub in np_tree(tp.params_).items() if sub}
    return (params, np_tree(tp.params_), np_tree(tp.opt_state_), np_tree(plain.params_),
            specs, float(tp.score()), want)


@pytest.mark.parametrize("model,kind,fused", [("vgg", "default", False),
                                              ("mlp", "default", False),
                                              ("mlp", "custom", False),
                                              ("mlp", "custom", True),
                                              ("cg", "default", False)])
def test_tp_wrapper_trains_as_jax_and_as_plain_fits(pool, model, kind, fused):
    """3 steps (``fit``, or one ``fit_steps`` block) at {data: 2, model:
    2}, a MultiLayerNetwork or a ComputationGraph: parameters, Adam
    moments and losses equal the JAX wrapper's with the same rules and
    the plain fits'; each rank stores its blocks; ``params()`` is whole on
    every rank."""
    _, jnn, _, jupd = _jax()
    conf = _conf(model, jnn, jupd)
    graph = model == "cg"
    x, y = _data(model)
    params0, tree, want_opt, plain, specs, loss, want = _jax_tp_fit(conf, x, y, kind, False,
                                                                    3, graph, fused)
    got = pool.run(_task_tp_fit, conf.to_json(), params0, x, y, kind, False, 3, graph, fused)
    for r, (snap, stored, moments, losses, flat) in enumerate(got):
        close_trees(snap["params"], tree, RTOL, f"rank {r} params")
        close_trees(snap["params"], plain, RTOL, f"rank {r} params against plain fits")
        close_trees(snap["opt"], want_opt, RTOL, f"rank {r} updater state")
        close(losses[-1], loss, RTOL, "loss")
        np.testing.assert_array_equal(flat, got[0][4])
        for name, sub in want.items():
            for k, w in sub.items():
                spec = tuple(specs[name][k][0]) + (None,) * (w.ndim - len(specs[name][k][0]))
                split = [d for d, a in enumerate(spec) if a == "model"]
                # the port stores the block: the split dim (mapped to its layout) halved
                assert np.prod(stored[name][k]) * (2 if split else 1) == w.size, (name, k)
                assert moments[name][k] == stored[name][k], (name, k)
    if kind == "custom":
        assert specs["layer_0"]["W"] == ((None, "model"),) * 2
        assert specs["layer_0"]["b"] == (("model",),) * 2
        assert got[0][1]["layer_0"] == {"W": (8, 8), "b": (8,)}
        assert got[0][1]["layer_1"] == {"W": (16, 2), "b": (4,)}   # the default rule


def test_tp_rules_win_over_zero1_per_leaf(pool):
    """test_zero1.py's case: layer_0/W tensor-parallel, everything else
    replicated by the rules and so ZeRO-1's; 10 steps equal the JAX
    wrapper's, layer_0's moments are model blocks and layer_1's data
    shards."""
    _, jnn, _, jupd = _jax()
    conf = _mlp_conf(jnn, jupd)
    x, y = _data("mlp")
    params0, want, _, plain, specs, _, _ = _jax_tp_fit(conf, x, y, "zero", True, 10)
    got = pool.run(_task_tp_fit, conf.to_json(), params0, x, y, "zero", True, 10)
    assert specs["layer_0"]["W"][1] == (None, "model") and specs["layer_1"]["W"][1] == ("data",)
    for r, (snap, stored, moments, _, _) in enumerate(got):
        close_trees(snap["params"], want, RTOL, f"rank {r} params")
        close_trees(snap["params"], plain, RTOL, f"rank {r} params against plain fits")
        assert stored["layer_0"]["W"] == (8, 8) and moments["layer_0"]["W"] == (8, 8)
        assert moments["layer_1"]["W"] == (8, 4) and stored["layer_1"]["W"] == (16, 4)


def _task_tp_listeners(conf_json, params, x, y, save_dir):
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper, ShardingRules, make_mesh
    from deeplearning4j_tpu_torch.train import CheckpointListener, EvaluativeListener
    mesh = make_mesh({"data": 2, "model": 2}, device="cpu")
    net = port_net(conf_json, params)
    heard = []

    class Record:
        def iteration_done(self, model, iteration, epoch):
            heard.append((iteration, model.params(), model.output(x).numpy(),
                          model.num_params()))

    ev = EvaluativeListener(ListDataSetIterator([DataSet(x, y)]), frequency=1)
    if dist.get_rank() == 0:                 # as a user attaches them: on rank 0 alone
        net.set_listeners(CheckpointListener(save_dir, every_n_iterations=2), ev, Record())
    pw = ParallelWrapper(net, mesh, sharding_rules=ShardingRules())
    pw.fit(x, y)
    pw.fit(x, y)
    pw.fit_steps(np.broadcast_to(x, (2,) + x.shape), np.broadcast_to(y, (2,) + y.shape))
    stored = tuple(net.params_["layer_0"]["W"].shape)
    return heard, ev.history, net.params(), stored


def test_tp_wrapper_listeners_hear_whole_leaves(pool, tmp_path):
    """Listeners on rank 0 under sharding rules at {data: 2, model: 2}:
    a checkpoint listener, an evaluative listener and one that calls
    ``params()``, ``output`` and ``num_params`` after two ``fit`` steps and
    a ``fit_steps`` block of two.  What they see, the checkpoints they
    write and the trained parameters equal a plain fit's at each iteration
    (1e-10, f64); the blocks stay stored after each notification."""
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    jax, jnn, _, jupd = _jax()
    conf = _mlp_conf(jnn, jupd)
    x, y = _data("mlp")
    params0 = jax.tree_util.tree_map(np.asarray, jnn.MultiLayerNetwork(conf).init().params_)
    plain = port_net(conf.to_json(), params0)
    want = {}
    for _ in range(4):
        plain.fit(x, y)
        want[plain.iteration] = (plain.params(), plain.output(x).numpy(),
                                  copy.deepcopy(snapshot(plain)))   # off the live tensors
    got = pool.run(_task_tp_listeners, conf.to_json(), params0, x, y, str(tmp_path))
    heard, history, flat, stored = got[0]
    assert [h[0] for h in heard] == [1, 2, 4]          # fit_steps: one notification a block
    for it, flat_i, out, n in heard:
        close(flat_i, want[it][0], RTOL, f"params() at iteration {it}")
        close(out, want[it][1], RTOL, f"output at iteration {it}")
        assert n == plain.num_params()
    assert len(history) == 3 and all(0.0 <= a <= 1.0 for a in history)
    for r, (h, _, flat_r, stored_r) in enumerate(got):
        close(flat_r, want[4][0], RTOL, f"rank {r} trained params")
        assert stored_r == (8, 8) and (r == 0 or h == [])
    for it in (2, 4):
        loaded = MultiLayerNetwork.load(str(tmp_path / f"checkpoint_iter_{it}.zip"),
                                        device="cpu")
        close_trees(snapshot(loaded)["params"], want[it][2]["params"], RTOL,
                    f"checkpoint at iteration {it}")
        close_trees(snapshot(loaded)["opt"], want[it][2]["opt"], RTOL,
                    f"checkpoint's updater state at iteration {it}")


# ---------------------------------------------------------------------------
# composed dp x tp x pp
# ---------------------------------------------------------------------------

S, D, H, FF, B, T = 2, 8, 2, 16, 8, 8
AXES = {"data": 1, "model": 2, "pipe": 2}


def _composed_inputs(seed=0):
    rs = np.random.RandomState(seed)
    return ((rs.randn(B, T, D) * 0.5).astype(np.float32),
            (rs.randn(B, T, D) * 0.5).astype(np.float32))


def _jax_composed():
    jax, _, jpar, _ = _jax()
    import jax.numpy as jnp
    from deeplearning4j_tpu.parallel.composed import (composed_apply, composed_oracle,
                                                      init_stage_params)
    mesh = jpar.make_mesh(AXES, jax.devices()[:4])
    params = init_stage_params(np.random.RandomState(7), S, D, H, FF)
    x, y = _composed_inputs()
    fwd = np.asarray(composed_apply(params, jnp.asarray(x), mesh, H))
    fwd4 = np.asarray(composed_apply(params, jnp.asarray(x), mesh, H, num_microbatches=4))

    @jax.jit
    def oracle_step(p):
        def loss_fn(pp):
            return jnp.mean((composed_oracle(pp, x, H) - y) ** 2)
        loss, g = jax.value_and_grad(loss_fn)(p)
        return jax.tree_util.tree_map(lambda a, b: a - 0.2 * b, p, g), loss

    traj, p = [], params
    for _ in range(3):
        p, loss = oracle_step(p)
        traj.append((jax.tree_util.tree_map(np.asarray, p), float(loss)))
    return fwd, fwd4, traj


def _task_composed():
    from deeplearning4j_tpu_torch.parallel import ComposedParallel, HierarchicalGradientSharing
    from deeplearning4j_tpu_torch.parallel import composed as C
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(AXES, device="cpu")
    full = C.init_stage_params(np.random.RandomState(7), S, D, H, FF, device="cpu")
    x, y = _composed_inputs()
    out = {"fwd": C.composed_apply(full, x, mesh, H).numpy(),
           "fwd4": C.composed_apply(full, x, mesh, H, num_microbatches=4).numpy()}
    local = C.shard_stage_params(full, mesh)
    out["local_shapes"] = {k: tuple(v.shape) for k, v in local.items()}
    step = C.composed_train_step(mesh, H, lr=0.2)
    remat = C.composed_train_step(mesh, H, lr=0.2, remat=True)
    p, traj = local, []
    for i in range(2):
        p_r, l_r = remat(p, x, y)
        p, loss = step(p, x, y)
        if i == 0:
            out["remat"] = (float(l_r), float(loss),
                            max(float((p_r[k] - p[k]).abs().max()) for k in p))
        traj.append(({k: v.numpy() for k, v in C.gather_stage_params(p, mesh).items()},
                     float(loss)))
    out["traj"] = traj
    _, out["loss3"] = step(p, x, y)
    out["loss3"] = float(out["loss3"])
    k = 3
    steps = C.composed_train_steps(mesh, H, lr=0.2)
    xs, ys = np.broadcast_to(x, (k,) + x.shape), np.broadcast_to(y, (k,) + y.shape)
    p_f, losses = steps(local, xs, ys)
    p_s = local
    for _ in range(k):
        p_s, l_s = step(p_s, x, y)
    out["fused"] = (losses.shape, float(losses[-1]), float(l_s),
                    all(torch.equal(p_f[kk], p_s[kk]) for kk in p_s))
    plain = ComposedParallel(mesh, n_heads=H, lr=0.2)
    shared = ComposedParallel(mesh, n_heads=H, lr=0.2, gradient_sharing=
                              HierarchicalGradientSharing(compressed=False, world=1))
    pa, pb = local, local
    for _ in range(2):
        pa, la = plain.fit_batch(pa, x, y)
        pb, lb = shared.fit_batch(pb, x, y)
    out["sharing"] = (float(la), float(lb), max(float((pa[kk] - pb[kk]).abs().max())
                                                for kk in pa),
                      shared.gradient_sharing.exchanges)
    shared.close()
    comp = ComposedParallel(mesh, n_heads=H, lr=0.2, gradient_sharing=
                            HierarchicalGradientSharing(threshold=5e-3, world=1))
    _, lc = comp.fit_batch(local, x, y)
    out["threshold"] = (float(lc), comp.gradient_sharing.stats()["compressed"])
    comp.close()
    return out


def test_composed_apply_steps_and_facade_match_jax(pool):
    """{data: 1, model: 2, pipe: 2}: the forward (M = S and M = 4) equals
    JAX composed_apply; two composed_train_step SGD steps follow JAX
    composed_oracle's trajectory and the loss keeps falling; remat gives
    the same step; composed_train_steps(k=3) equals three single steps bit
    for bit; ComposedParallel with dense sharing at world 1 equals the
    plain facade, and the threshold codec runs through it."""
    from deeplearning4j_tpu_torch import native_ops
    native_ops.build()                  # once, before the ranks load it
    fwd, fwd4, traj = _jax_composed()
    got = pool.run(_task_composed)
    for r, out in enumerate(got):
        close(out["fwd"], fwd, COMPOSED_FWD_RTOL, f"rank {r} forward")
        close(out["fwd4"], fwd4, COMPOSED_FWD_RTOL, f"rank {r} forward, 4 microbatches")
        assert out["local_shapes"]["w1"] == (1, D, FF // 2)
        assert out["local_shapes"]["w2"] == (1, FF // 2, D)
        assert out["local_shapes"]["wqkv"] == (1, D, 3 * D)
        for i, ((p, loss), (wp, wl)) in enumerate(zip(out["traj"], traj)):
            close(loss, wl, COMPOSED_STEP_RTOL, f"rank {r} loss at step {i}")
            close_trees(p, wp, COMPOSED_STEP_RTOL, f"rank {r} params after step {i + 1}")
        assert out["loss3"] < out["traj"][-1][1]
        l_r, l_p, d = out["remat"]
        assert l_r == l_p and d == 0.0
        shape, last, single, same = out["fused"]
        assert tuple(shape) == (3,) and last == single and same
        la, lb, diff, exchanges = out["sharing"]
        assert la == lb and diff == 0.0 and exchanges == 2
        lc, compressed = out["threshold"]
        assert np.isfinite(lc) and compressed


# ---------------------------------------------------------------------------
# inference under sharding rules
# ---------------------------------------------------------------------------

def _task_parallel_inference(conf_json, params, x, tp):
    """ParallelInference over {data: 2, model: 2} of the network (with
    `tp`, first placed tensor-parallel by a wrapper with the default
    rules): the whole output on every rank, and the network's own."""
    from deeplearning4j_tpu_torch.parallel import (ParallelInference, ParallelWrapper,
                                                   ShardingRules, make_mesh)
    net = port_net(conf_json, params)
    plain = net.output(torch.as_tensor(x)).detach().numpy()
    mesh = make_mesh({"data": 2, "model": 2}, device="cpu")
    if tp:
        ParallelWrapper(net, mesh, sharding_rules=ShardingRules())._place_model()
        assert net._tp is not None
    pi = ParallelInference(net, mesh)
    return pi.output(x), pi.output([x[:3], x[3:]]), plain, net._tp is None


@pytest.mark.parametrize("tp", [False, True])
def test_parallel_inference_over_a_model_axis_equals_the_jax_one(pool, tp):
    """The JAX ParallelInference on a {data: 2, model: 2} mesh (parameters
    replicated, the batch split over data) against the port's on 4 gloo
    ranks, f64 at 1e-10, a 7-row batch padded over the data axis; a
    tensor-parallel network is made whole first, as the JAX replicated
    placement does."""
    jax, jnn, jpar, jupd = _jax()
    conf = (jnn.NeuralNetConfiguration.builder().seed(3).updater(jupd.Sgd(0.1))
            .dtype("float64")
            .list([jnn.DenseLayer(n_out=8, activation="tanh"),
                   jnn.OutputLayer(n_out=4, loss="mcxent", activation="softmax")])
            .set_input_type(jnn.InputType.feed_forward(6)).build())
    jnet = jnn.MultiLayerNetwork(conf).init()
    params = jax.tree_util.tree_map(np.asarray, jnet.params_)
    x = np.random.RandomState(4).randn(7, 6)
    want = jpar.ParallelInference(
        jnet, jpar.make_mesh({"data": 2, "model": 2}, jax.devices()[:4])).output(x)
    got = pool.run(_task_parallel_inference, conf.to_json(), params, x, tp)
    for whole, parts, plain, replicated in got:
        close(whole, want, RTOL, "output")
        close(np.concatenate(parts), want, RTOL, "batched output")
        close(plain, want, RTOL, "one-rank output")
        assert replicated


def _task_quantized_tp(conf_json, params, x):
    """The JAX test's quantized MLP in the port: the unsharded output, the
    leaves `shard_model_params` places on {data: 2, model: 2} (rank's q
    and scale blocks) and the sharded forward inside ``with mesh:``."""
    from deeplearning4j_tpu_torch.parallel import ShardingRules, make_mesh, shard_model_params
    from deeplearning4j_tpu_torch.quant import quantize_model
    net = port_net(conf_json, params)
    qm = quantize_model(net)
    whole = qm.output(x).numpy()
    mesh = make_mesh({"data": 2, "model": 2}, device="cpu")
    sharded = shard_model_params(qm.params_, mesh, ShardingRules())
    w0 = sharded["layer_0"]["W"]
    blocks = {name: (sub["W"].q.numpy(), sub["W"].scale.numpy())
              for name, sub in sharded.items()}
    qm.params_ = sharded
    with mesh:
        got = qm.output(x).numpy()
    return whole, got, str(w0.q.dtype), blocks, mesh.coordinate("model")


def test_quantized_inference_under_tp_sharding_rules(pool):
    """The JAX test of that name, in the port: the Megatron default splits
    each Dense W's output dim over ``model``; the int8 ``q`` and its
    per-channel scale split alike (each rank's blocks equal the JAX
    shards on its model coordinate, bitwise), and the column-parallel
    quantized forward matches the unsharded one (rtol 1e-4, atol 1e-5, the
    JAX test's bound) and the JAX quantized output."""
    import jax
    from deeplearning4j_tpu.parallel import ShardingRules as JRules
    from deeplearning4j_tpu.parallel import make_mesh as jmake_mesh
    from deeplearning4j_tpu.parallel import shard_model_params as jshard
    from deeplearning4j_tpu.quant import quantize_model as jquantize
    from test_quant import _fit, _mlp
    jnet = _mlp()
    x = _fit(jnet)
    params = jax.tree_util.tree_map(np.asarray, jnet.params_)
    jqm = jquantize(jnet)
    want = np.asarray(jqm.output(x))
    jmesh = jmake_mesh({"data": 2, "model": 2}, jax.devices()[:4])
    jsharded = jshard(jqm.params_, jmesh, JRules())
    got = pool.run(_task_quantized_tp, jnet.conf.to_json(), params, x)
    for whole, sharded_out, dtype, blocks, coord in got:
        assert dtype == "torch.int8"
        np.testing.assert_allclose(sharded_out, whole, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(sharded_out, want, rtol=1e-4, atol=1e-5)
        for name, (q, scale) in blocks.items():
            jw = jsharded[name]["W"]
            for mine, theirs in ((q, jw.q), (scale, jw.scale)):
                n = mine.shape[-1]
                full = np.asarray(theirs)
                np.testing.assert_array_equal(mine, full[..., coord * n:(coord + 1) * n])
                assert theirs.sharding.spec == jax.sharding.PartitionSpec(None, "model")


def test_two_dim_tuple_of_axes_and_data_specs_place_as_jax_does():
    """``shard_model_params`` under specs JAX's ``NamedSharding`` takes
    and the wrapper's tensor parallelism does not: a W split on both dims
    (data, model), a W split on one dim over the tuple (data, model), a
    bias over data.  On a {data: 4, model: 2} mesh each of the 8 ranks'
    blocks equal the JAX shard on the device at its place, bitwise."""
    jax, jnn, jpar, jupd = _jax()
    from jax.sharding import PartitionSpec as JP
    from deeplearning4j_tpu.parallel.sharding import ShardingRules as JRules
    from deeplearning4j_tpu_torch.parallel import (PartitionSpec as P, ShardingRules,
                                                   shard_model_params)
    from deeplearning4j_tpu_torch.parallel.mesh import Mesh
    rng = np.random.RandomState(0)
    params = {"layer_0": {"W": rng.randn(8, 16), "b": rng.randn(16)},
              "layer_1": {"W": rng.randn(16, 8), "b": rng.randn(8)}}
    jrules = (JRules().add(r"layer_0/W", JP("data", "model"))
              .add(r"layer_1/W", JP(("data", "model"))).add(r"layer_1/b", JP("data")))
    rules = (ShardingRules().add(r"layer_0/W", P("data", "model"))
             .add(r"layer_1/W", P(("data", "model"))).add(r"layer_1/b", P("data")))
    devices = jax.devices()[:8]
    jmesh = jpar.make_mesh({"data": 4, "model": 2}, devices)
    placed = jpar.shard_model_params(params, jmesh, jrules)
    torch_params = {n: {k: torch.as_tensor(v) for k, v in sub.items()}
                    for n, sub in params.items()}
    for r in range(8):
        mesh = Mesh({"data": 4, "model": 2}, range(8), r, torch.device("cpu"), False)
        mine = shard_model_params(torch_params, mesh, rules)
        for name, sub in placed.items():
            for key, arr in sub.items():
                shard = next(s for s in arr.addressable_shards if s.device == devices[r])
                np.testing.assert_array_equal(mine[name][key].numpy(), np.asarray(shard.data),
                                              err_msg=f"rank {r} {name}/{key}")
    with pytest.raises(NotImplementedError, match="one axis on one dim"):
        from deeplearning4j_tpu_torch.parallel.sharding import leaf_shard
        leaf_shard(P("data", "model"), (8, 16), None,
                   Mesh({"data": 4, "model": 2}, range(8), 0, torch.device("cpu"), False),
                   "layer_0/W")


# ---------------------------------------------------------------------------
# sharded checkpoints under sharding rules and on part of the ranks
# ---------------------------------------------------------------------------

def _local(net):
    from deeplearning4j_tpu_torch.parallel.wrapper import _model_tensors
    return [t.detach().clone() for t in _model_tensors(net)]


def _task_tp_zero1_checkpoint(conf_json, params, x, y, directory):
    """A tensor-parallel network under ZeRO-1 on {data: 2, model: 2}: 3
    steps, a sharded save, a twin loaded from it; whether each rank's
    tensors (blocks and shards) are equal, and both after 2 more steps."""
    from deeplearning4j_tpu_torch.parallel import (ParallelWrapper, ShardingRules,
                                                   load_model_sharded, make_mesh,
                                                   save_model_sharded)
    mesh = make_mesh({"data": 2, "model": 2}, device="cpu")
    nets = []
    for _ in range(2):
        net = port_net(conf_json, params)
        pw = ParallelWrapper(net, mesh, sharding_rules=ShardingRules(),
                             optimizer_sharding=True)
        pw._place_model()
        nets.append((net, pw))
    (net, pw), (twin, tpw) = nets
    for _ in range(3):
        pw.fit(x, y)
    save_model_sharded(net, directory)
    load_model_sharded(twin, directory)
    loaded = all(torch.equal(a, b) for a, b in zip(_local(net), _local(twin)))
    for _ in range(2):
        pw.fit(x, y)
        tpw.fit(x, y)
    resumed = all(torch.equal(a, b) for a, b in zip(_local(net), _local(twin)))
    return loaded, resumed, twin.iteration, net._tp is not None


def _task_partial_mesh_checkpoint(conf_json, params, x, y, directory):
    """``workers(2)`` of the 4 ranks under ZeRO-1: the two workers save
    and load sharded by their own group (files numbered by their places
    on the mesh), the other two take no part."""
    from deeplearning4j_tpu_torch.parallel import (ParallelWrapper, load_model_sharded,
                                                   save_model_sharded)
    net = port_net(conf_json, params)
    pw = ParallelWrapper.builder(net).workers(2).optimizer_sharding(True).build()
    twin = port_net(conf_json, params)
    tpw = ParallelWrapper(twin, pw.mesh, optimizer_sharding=True)
    if not pw.mesh.member:
        return None
    pw.fit(x, y)
    tpw._place_model()
    save_model_sharded(net, directory)
    load_model_sharded(twin, directory)
    return all(torch.equal(a, b) for a, b in zip(_local(net), _local(twin)))


def test_sharded_checkpoints_of_a_tp_network_under_zero1_and_of_part_of_the_ranks(
        pool, tmp_path):
    """A tensor-parallel network under ZeRO-1 saves sharded (its split
    leaves' moments gathered whole, ZeRO-1's moments as their rows) and a
    twin loads every rank's blocks and shards bitwise and trains on
    bitwise; a mesh over 2 of the 4 ranks saves and loads by its own
    group (before, its barrier waited on the other two)."""
    jax, jnn, jpar, jupd = _jax()
    conf = (jnn.NeuralNetConfiguration.builder().seed(5).updater(jupd.Adam(1e-2))
            .dtype("float64")
            .list([jnn.DenseLayer(n_out=8, activation="tanh"),
                   jnn.DenseLayer(n_out=6, activation="relu"),
                   jnn.OutputLayer(n_out=4, loss="mcxent", activation="softmax")])
            .set_input_type(jnn.InputType.feed_forward(6)).build())
    params = jax.tree_util.tree_map(np.asarray, jnn.MultiLayerNetwork(conf).init().params_)
    rng = np.random.RandomState(9)
    x = rng.randn(8, 6)
    y = np.eye(4)[rng.randint(0, 4, 8)]
    got = pool.run(_task_tp_zero1_checkpoint, conf.to_json(), params, x, y,
                   str(tmp_path / "tp"))
    assert all(r == (True, True, 5, True) for r in got), got
    got = pool.run(_task_partial_mesh_checkpoint, conf.to_json(), params, x, y,
                   str(tmp_path / "part"))
    assert got == [True, True, None, None]
    assert sorted(os.listdir(tmp_path / "part")) == [
        "index-0.json", "index-1.json", "manifest.json", "shards-0.npz", "shards-1.npz"]
