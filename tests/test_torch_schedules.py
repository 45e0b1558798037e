"""The tensor forms of the port's learning-rate schedules against the JAX
package's schedules, as a training step computes them: from int32
iteration and epoch counters, under `jax.jit`.

With x64 off (the JAX package's default, every schedule in f32) the port
computes in f32; with x64 on (how the tests run the JAX package beside f64
networks) in the JAX result's own dtype, which is f64 except where the JAX
schedule is f32 whatever the default (an int32 counter divided by an
integer; Cycle and WarmupLinearDecay cast the counter to f32).  At
iterations 0..50 (epoch = iteration // 7) the values are equal bit for bit
for Fixed, Step, Exponential and Map, and within 2 ulps (of the result's
dtype, at the largest value of the run) for Inverse, Sigmoid, Poly, Ramp,
Cycle and WarmupLinearDecay: XLA's CPU code multiplies by the reciprocal
of a constant divisor where the port divides, and its `pow` and `exp` may
round differently; near the end of a decay the difference of two close
numbers (1 - t / max_iter) makes one ulp of an input many ulps of a small
result, hence the scale of the largest value.
"""
import torch_test_threads  # noqa: F401  (first: one torch thread a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.train import schedules as jsched
from deeplearning4j_tpu_torch.train import schedules as tsched

CASES = [
    ("FixedSchedule", dict(value=0.3), 0),
    ("StepSchedule", dict(initial_value=0.1, decay_rate=0.5, step=3), 0),
    ("StepSchedule", dict(initial_value=0.1, decay_rate=0.7, step=2.5), 0),
    ("StepSchedule", dict(initial_value=0.1, decay_rate=0.5, step=2,
                          schedule_type="EPOCH"), 0),
    ("ExponentialSchedule", dict(initial_value=0.1, gamma=0.9), 0),
    ("ExponentialSchedule", dict(initial_value=0.1, gamma=0.9, schedule_type="EPOCH"), 0),
    ("InverseSchedule", dict(initial_value=0.1, gamma=0.2, power=1.5), 2),
    ("PolySchedule", dict(initial_value=0.1, power=2.0, max_iter=37), 2),
    ("SigmoidSchedule", dict(initial_value=0.1, gamma=0.5, step_size=20), 2),
    ("RampSchedule", dict(initial_value=0.1, num_iter=15), 2),
    ("CycleSchedule", dict(initial_value=0.01, max_value=0.1, cycle_length=20,
                           annealing_length=12), 2),
    ("CycleSchedule", dict(initial_value=0.01, max_value=0.1, cycle_length=30), 2),
    ("MapSchedule", dict(values={0: 0.1, 3: 0.05, 17: 0.01}), 0),
    ("MapSchedule", dict(values={0: 0.1, 2: 0.05}, schedule_type="EPOCH"), 0),
    ("WarmupLinearDecaySchedule", dict(peak_value=0.1, warmup_iters=8,
                                       total_iters=45), 2),
]
IDS = [f"{c}-{i}" for i, (c, _, _) in enumerate(CASES)]
ITERS = np.arange(51, dtype=np.int32)


def _within(got, want, max_ulps):
    """Bitwise for max_ulps 0, else |diff| <= max_ulps ulps of max|want|."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype
    if max_ulps == 0:
        return np.array_equal(got.view(np.uint8), want.view(np.uint8))
    ulp = np.spacing(np.abs(want).max().astype(want.dtype))
    return np.abs(got.astype(np.float64) - want.astype(np.float64)).max() <= max_ulps * ulp


def _jax_values(name, kw):
    sched = getattr(jsched, name)(**kw)
    f = jax.jit(jax.vmap(lambda i, e: sched.value_at(i, e)))
    return np.asarray(f(jnp.asarray(ITERS), jnp.asarray(ITERS // 7)))


def _port_values(name, kw, dtype):
    sched = getattr(tsched, name)(**kw)
    out = [sched.value_tensor(torch.tensor(int(i), dtype=torch.int32),
                              torch.tensor(int(i) // 7, dtype=torch.int32), dtype)
           for i in ITERS]
    return torch.stack(out).numpy()


@pytest.mark.parametrize("name,kw,max_ulps", CASES, ids=IDS)
def test_tensor_form_matches_jax_in_f32(name, kw, max_ulps):
    with jax.enable_x64(False):
        want = _jax_values(name, kw)
    assert want.dtype == np.float32
    got = _port_values(name, kw, torch.float32)
    assert _within(got, want, max_ulps)


@pytest.mark.parametrize("name,kw,max_ulps", CASES, ids=IDS)
def test_tensor_form_matches_jax_with_x64(name, kw, max_ulps):
    want = _jax_values(name, kw)
    got = _port_values(name, kw, torch.float64)
    assert got.dtype == want.dtype, "the JAX schedule's own dtype"
    assert _within(got, want, max_ulps)


@pytest.mark.parametrize("name,kw,max_ulps", CASES, ids=IDS)
def test_tensor_form_is_the_host_form_within_f32_rounding(name, kw, max_ulps):
    got = _port_values(name, kw, torch.float32)
    host = np.array([getattr(tsched, name)(**kw).value_at(int(i), int(i) // 7)
                     for i in ITERS])
    np.testing.assert_allclose(got, host, rtol=2e-6, atol=1e-9)
