"""Training math of the PyTorch port against the JAX package: losses,
schedules, updaters, gradient normalization, and the training slice as a
whole (a shallow, narrow ResNet-50 through ComputationGraph.fit).

Inputs are numpy arrays made from a seed and handed to both packages;
parameters and BN running statistics start from the JAX network's and cross
with `convert`.  f32 tolerance: 1e-5 relative (max|diff| <= 1e-5 *
max|ref| per tensor).  The JAX side of the slice runs twice: with its
Pallas conv backward kernels switched on in interpret mode (the
`CONV_BWD_PALLAS` gate, set with monkeypatch.setitem) and with the gate
off (XLA's conv backward).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import conv_kernels as jck
from deeplearning4j_tpu.ops import losses as jlosses
from deeplearning4j_tpu.train import schedules as jsched
from deeplearning4j_tpu.train import updaters as jupd
from deeplearning4j_tpu.zoo.graphs import ResNet50 as JResNet50
from deeplearning4j_tpu_torch import convert
from deeplearning4j_tpu_torch.ops import losses as tlosses
from deeplearning4j_tpu_torch.train import schedules as tsched
from deeplearning4j_tpu_torch.train import updaters as tupd
from deeplearning4j_tpu_torch.zoo.graphs import ResNet50 as TResNet50


def _rel_close(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"max|diff| {err} > {rtol} * {scale}"


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _loss_inputs(name, rs, shape=(6, 5)):
    pre = rs.randn(*shape).astype(np.float32)
    if name == "sparse_mcxent":
        labels = rs.randint(0, shape[-1], shape[:-1]).astype(np.float32)
    elif name in ("mcxent", "negativeloglikelihood", "kl_divergence"):
        labels = np.eye(shape[-1], dtype=np.float32)[rs.randint(0, shape[-1], shape[:-1])]
    elif name in ("xent", "reconstruction_crossentropy", "hinge", "squared_hinge"):
        labels = (rs.rand(*shape) > 0.5).astype(np.float32)
    else:
        labels = rs.rand(*shape).astype(np.float32) + 0.1
    if name in ("negativeloglikelihood", "kl_divergence", "poisson",
                "mean_squared_logarithmic_error"):
        pre = rs.rand(*shape).astype(np.float32) * 0.9 + 0.05
    return pre, labels


@pytest.mark.parametrize("name", sorted(jlosses.LOSSES))
@pytest.mark.parametrize("masked", [False, True])
def test_loss_value_and_gradient_match_jax(name, masked):
    rs = np.random.RandomState(len(name))
    pre, labels = _loss_inputs(name, rs)
    mask = (rs.rand(6) > 0.3).astype(np.float32) if masked else None
    jfn = jlosses.get_loss(name)
    jv, jg = jax.value_and_grad(lambda p: jfn(
        jnp.asarray(labels), p, None if mask is None else jnp.asarray(mask)))(
        jnp.asarray(pre))
    tp = torch.from_numpy(pre).requires_grad_()
    tv = tlosses.get_loss(name)(torch.from_numpy(labels), tp,
                                None if mask is None else torch.from_numpy(mask))
    tv.backward()
    _rel_close(tv.detach().numpy(), jv)
    _rel_close(tp.grad.numpy(), jg)


def test_apply_loss_takes_logits_for_mcxent_and_activations_otherwise():
    rs = np.random.RandomState(0)
    pre, labels = _loss_inputs("mcxent", rs)
    tp, tl = torch.from_numpy(pre), torch.from_numpy(labels)
    got = tlosses.apply_loss("mcxent", torch.sigmoid, tp, tl)
    torch.testing.assert_close(got, tlosses.mcxent(tl, tp))
    got = tlosses.apply_loss("mse", torch.sigmoid, tp, tl)
    torch.testing.assert_close(got, tlosses.mse(tl, torch.sigmoid(tp)))
    assert tlosses.LOGIT_LOSSES == jlosses.LOGIT_LOSSES
    with pytest.raises(ValueError, match="Unknown loss"):
        tlosses.get_loss("nope")


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

SCHEDULES = [
    ("FixedSchedule", dict(value=0.3)),
    ("StepSchedule", dict(initial_value=0.1, decay_rate=0.5, step=3)),
    ("StepSchedule", dict(initial_value=0.1, decay_rate=0.5, step=2,
                          schedule_type="EPOCH")),
    ("ExponentialSchedule", dict(initial_value=0.1, gamma=0.9)),
    ("InverseSchedule", dict(initial_value=0.1, gamma=0.2, power=1.5)),
    ("PolySchedule", dict(initial_value=0.1, power=2.0, max_iter=7)),
    ("SigmoidSchedule", dict(initial_value=0.1, gamma=0.5, step_size=4)),
    ("RampSchedule", dict(initial_value=0.1, num_iter=5)),
    ("CycleSchedule", dict(initial_value=0.01, max_value=0.1, cycle_length=6,
                           annealing_length=3)),
    ("MapSchedule", dict(values={0: 0.1, 3: 0.05, 7: 0.01})),
    ("WarmupLinearDecaySchedule", dict(peak_value=0.1, warmup_iters=3,
                                       total_iters=9)),
]


@pytest.mark.parametrize("cls,kw", SCHEDULES)
def test_schedule_values_and_json_match_jax(cls, kw):
    js = getattr(jsched, cls)(**kw)
    ts = getattr(tsched, cls)(**kw)
    assert ts.to_json() == js.to_json()
    assert tsched.ISchedule.from_json(js.to_json()) == ts
    for it in range(12):
        ep = it // 4
        want = float(js.value_at(it, ep))
        assert abs(ts.value_at(it, ep) - want) <= 1e-6 * max(abs(want), 1e-3)


# ---------------------------------------------------------------------------
# updaters
# ---------------------------------------------------------------------------

def _trees(rs):
    params = {"W": rs.randn(4, 3).astype(np.float32),
              "b": rs.randn(3).astype(np.float32),
              "inner": {"gamma": rs.randn(5).astype(np.float32)}}
    grads = [jax.tree_util.tree_map(
        lambda a: rs.randn(*a.shape).astype(np.float32), params) for _ in range(3)]
    return params, grads


def _torch_tree(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.asarray(a).copy()), tree)


UPDATERS = [
    ("Sgd", dict(learning_rate=0.1)),
    ("NoOp", dict()),
    ("Nesterovs", dict(learning_rate=0.1, momentum=0.9)),
    ("Nesterovs", dict(learning_rate=dict(
        initial_value=0.1, decay_rate=0.5, step=1))),
    ("Adam", dict(learning_rate=1e-2)),
    ("Adam", dict(learning_rate=dict(initial_value=1e-2, gamma=0.8))),
]


@pytest.mark.parametrize("cls,kw", UPDATERS)
def test_updater_steps_match_jax(cls, kw):
    kw = dict(kw)
    lr = kw.get("learning_rate")
    if isinstance(lr, dict):
        name = "StepSchedule" if "step" in lr else "ExponentialSchedule"
        jkw = dict(kw, learning_rate=getattr(jsched, name)(**lr))
        tkw = dict(kw, learning_rate=getattr(tsched, name)(**lr))
    else:
        jkw = tkw = kw
    ju, tu = getattr(jupd, cls)(**jkw), getattr(tupd, cls)(**tkw)
    assert tu.to_json() == ju.to_json()
    assert tupd.IUpdater.from_json(ju.to_json()) == tu
    rs = np.random.RandomState(7)
    params, grads = _trees(rs)
    jstate = ju.init_state(jax.tree_util.tree_map(jnp.asarray, params))
    tstate = tu.init_state(_torch_tree(params))
    jp, tp = params, _torch_tree(params)
    for it, g in enumerate(grads):
        jupd_, jstate = ju.apply(jstate, jax.tree_util.tree_map(jnp.asarray, g), it)
        tupd_, tstate = tu.apply(tstate, _torch_tree(g), it, params=tp)
        jp = jax.tree_util.tree_map(lambda p, u: p - u, jp, jupd_)
        tp = tupd.tree_map(lambda p, u: p - u, tp, tupd_)
        for a, b in zip(jax.tree_util.tree_leaves(jupd_), tupd.tree_leaves(tupd_)):
            _rel_close(b.numpy(), a)
    for a, b in zip(jax.tree_util.tree_leaves(jp), tupd.tree_leaves(tp)):
        _rel_close(b.numpy(), a)
    for a, b in zip(jax.tree_util.tree_leaves(jstate), tupd.tree_leaves(tstate)):
        _rel_close(b.numpy(), a)


@pytest.mark.parametrize("mode", ["RenormalizeL2PerLayer", "RenormalizeL2PerParamType",
                                  "ClipElementWiseAbsoluteValue", "ClipL2PerLayer",
                                  "ClipL2PerParamType", None])
def test_gradient_normalization_matches_jax(mode):
    rs = np.random.RandomState(11)
    _, grads = _trees(rs)
    want = jupd.apply_gradient_normalization(
        jax.tree_util.tree_map(jnp.asarray, grads[0]), mode, 0.7)
    got = tupd.apply_gradient_normalization(_torch_tree(grads[0]), mode, 0.7)
    for a, b in zip(jax.tree_util.tree_leaves(want), tupd.tree_leaves(got)):
        _rel_close(b.numpy(), a)


def test_unported_updaters_and_modes_raise():
    with pytest.raises(ValueError, match="not ported yet"):
        tupd.IUpdater.from_json(jupd.AdamW().to_json())
    with pytest.raises(ValueError, match="Unknown gradient normalization"):
        tupd.apply_gradient_normalization({"W": torch.ones(2)}, "Bogus")


# ---------------------------------------------------------------------------
# the slice: a shallow, narrow ResNet-50 through ComputationGraph.fit
# ---------------------------------------------------------------------------

class _JSmall(JResNet50):
    STAGES = ((1, 8), (1, 16))


class _TSmall(TResNet50):
    STAGES = ((1, 8), (1, 16))


def _data(n=4, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 32, 32, 3).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rs.randint(0, 10, n)]
    return x, y


def _pair(compute_dtype=None):
    from deeplearning4j_tpu.train.updaters import Nesterovs as JN
    from deeplearning4j_tpu_torch.train.updaters import Nesterovs as TN
    kw = dict(n_classes=10, input_shape=(32, 32, 3), compute_dtype=compute_dtype)
    jnet = _JSmall(updater=JN(0.1, 0.9), **kw).init_model()
    # non-trivial running statistics, the same in both packages
    rs = np.random.RandomState(3)
    jnet.state_ = {n: {k: jnp.asarray(
        (rs.rand(*v.shape) * 0.5 + (0.75 if k == "var" else -0.25)).astype(np.float32))
        for k, v in s.items()} for n, s in jnet.state_.items()}
    tnet = _TSmall(updater=TN(0.1, 0.9), **kw).init_model(device="cpu")
    assert tnet.conf.to_json() == jnet.conf.to_json()
    convert.params_from_jax(tnet, jax.tree_util.tree_map(np.asarray, jnet.params_))
    convert.state_from_jax(tnet, jax.tree_util.tree_map(np.asarray, jnet.state_))
    return jnet, tnet


@pytest.fixture(params=["pallas_interpret", "xla"])
def jax_conv_bwd(request, monkeypatch):
    on = request.param == "pallas_interpret"
    monkeypatch.setitem(jck.CONV_BWD_PALLAS, "wgrad", on)
    monkeypatch.setitem(jck.CONV_BWD_PALLAS, "dgrad", on)
    monkeypatch.setitem(jck.CONV_BWD_PALLAS, "interpret", on)
    return request.param


def test_slice_forward_gradients_and_three_nesterovs_steps_match_jax(jax_conv_bwd):
    from deeplearning4j_tpu_torch.ops.kernels import conv3x3
    jnet, tnet = _pair()
    x, y = _data()
    # forward (eval mode)
    _rel_close(tnet.output(x)[0].numpy(), jnet.output(x)[0])
    # gradient_for, per tensor, in the JAX layout
    jg = jnet.gradient_for(x, y)
    tg = tnet.gradient_for(x, y)
    for name in jg:
        assert set(tg[name]) == set(jg[name])
        for k in jg[name]:
            got = convert.to_jax_layout(tnet.layer_by_name(name), k, tg[name][k])
            _rel_close(got, jg[name][k])
    # three fit steps: losses, params, running stats
    launches = conv3x3.WGRAD_LAUNCHES.value
    for step in range(3):
        x, y = _data(seed=10 + step)
        jnet.fit(x, y)
        tnet.fit(x, y)
        _rel_close(tnet.score(), jnet.score())
    assert conv3x3.WGRAD_LAUNCHES.value == launches    # CPU: plain versions
    assert tnet.iteration == jnet.iteration == 3
    jp = jax.tree_util.tree_map(np.asarray, jnet.params_)
    tp = convert.params_to_jax(tnet)
    for name in jp:
        for k in jp[name]:
            _rel_close(tp[name][k], jp[name][k])
    js = jax.tree_util.tree_map(np.asarray, jnet.state_)
    ts = convert.state_to_jax(tnet)
    for name in js:
        for k in js[name]:
            _rel_close(ts[name][k], js[name][k])


def test_slice_runs_the_body_convs_through_conv3x3_same(monkeypatch):
    """Every 3x3 body conv goes through conv3x3_same in fit and
    gradient_for (one per bottleneck), and nothing else does."""
    import deeplearning4j_tpu_torch.nn.layers as layers
    from deeplearning4j_tpu_torch.ops import conv_kernels as ck
    calls = []

    def spy(x, w):
        calls.append(tuple(w.shape))
        return ck.conv3x3_same(x, w)

    monkeypatch.setattr(layers, "conv3x3_same", spy)
    _, tnet = _pair()
    x, y = _data()
    tnet.fit(x, y)
    assert calls == [(8, 8, 3, 3), (16, 16, 3, 3)]
    tnet.gradient_for(x, y)
    assert len(calls) == 4
    tnet.output(x)
    tnet.score_for(x, y)
    assert len(calls) == 4


def test_slice_bf16_compute_trains_f32_master_params():
    jnet, tnet = _pair(compute_dtype="bfloat16")
    assert tnet.conf.to_json() == jnet.conf.to_json()
    x, y = _data()
    before = tnet.params()
    losses = []
    for _ in range(2):
        tnet.fit(x, y)
        losses.append(tnet.score())
    assert all(np.isfinite(losses))
    assert tnet.params_["s0b0_b_conv"]["W"].dtype == torch.float32
    assert tnet.output(x)[0].dtype == torch.bfloat16
    assert np.abs(tnet.params() - before).max() > 0
    jnet.fit(x, y)
    assert abs(losses[0] - jnet.score()) <= 2e-2 * abs(jnet.score())
