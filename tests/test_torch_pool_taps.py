"""The taps max-pool backward of the PyTorch port (`max_pool2d_taps`)
against the JAX package's custom VJP, and its `POOL_BWD_TAPS` switch.

Inputs are drawn from a seed with numpy and rounded to a coarse grid, so
windows hold exact ties (ReLU-like zeros among them); tied maxima share a
window's gradient evenly in both packages.  Both backwards compute in f32
in the same tap order, so dx agrees within 1e-6 relative of max|dx| (f32
rounding of the same sums); the forward is exact.  With the switch off
(the default in both packages) `max_pool2d` keeps autograd's backward,
which gives a window's gradient to its first maximum.
"""
import torch_test_threads  # noqa: F401  (first: one torch thread a worker)
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import pool_kernels as jpk
from deeplearning4j_tpu_torch.ops import pool_kernels as tpk

CASES = [
    ((2, 7, 7, 3), (3, 3), (2, 2), "SAME"),
    ((2, 8, 8, 2), (2, 2), (2, 2), "VALID"),
    ((1, 9, 7, 4), (3, 3), (2, 2), "VALID"),        # a cropped tail
    ((2, 6, 5, 3), (3, 2), (1, 2), ((1, 1), (0, 1))),
    ((1, 5, 5, 2), (3, 3), (1, 1), "SAME"),         # overlapping windows
]


def _inputs(shape, dtype, seed):
    rs = np.random.RandomState(seed)
    x = np.maximum(np.round(rs.randn(*shape) * 2) / 2, 0.0).astype(dtype)
    return x


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_taps_backward_matches_jax_on_ties(case, dtype):
    shape, kernel, stride, padding = CASES[case]
    x = _inputs(shape, dtype, seed=case)
    fn = lambda a: jpk.max_pool2d_taps(a, kernel, stride, padding)
    jy, vjp = jax.vjp(fn, jnp.asarray(x))
    rs = np.random.RandomState(100 + case)
    dy = rs.randn(*jy.shape).astype(dtype)
    (jdx,) = vjp(jnp.asarray(dy))
    xt = torch.tensor(x, requires_grad=True)
    y = tpk.max_pool2d_taps(xt, kernel, stride, padding)
    assert np.array_equal(y.detach().numpy(), np.asarray(jy))
    (dx,) = torch.autograd.grad(y, xt, torch.tensor(dy))
    assert dx.dtype == xt.dtype
    jdx = np.asarray(jdx)
    assert np.abs(dx.numpy() - jdx).max() <= 1e-6 * np.abs(jdx).max()
    np.testing.assert_allclose(dx.numpy().sum(), dy.sum(), rtol=1e-5)


def test_ties_share_the_gradient_evenly():
    x = torch.zeros(1, 2, 2, 1, dtype=torch.float64, requires_grad=True)
    y = tpk.max_pool2d_taps(x, (2, 2), (2, 2))
    (dx,) = torch.autograd.grad(y, x, torch.ones_like(y))
    assert torch.equal(dx, torch.full_like(x, 0.25))
    y = tpk._pool_fwd(x, (2, 2), (2, 2), "VALID")
    (first,) = torch.autograd.grad(y, x, torch.ones_like(y))
    assert first.flatten().tolist() == [1.0, 0.0, 0.0, 0.0]


def test_switch_is_off_by_default_and_routes_the_dispatcher(monkeypatch):
    assert tpk.POOL_BWD_TAPS["enabled"] == jpk.POOL_BWD_TAPS["enabled"] is False
    x = torch.zeros(1, 2, 2, 1, dtype=torch.float64, requires_grad=True)

    def grad():
        y = tpk.max_pool2d(x, (2, 2), (2, 2), "VALID")
        return torch.autograd.grad(y, x, torch.ones_like(y))[0].flatten().tolist()

    assert grad() == [1.0, 0.0, 0.0, 0.0]
    monkeypatch.setitem(tpk.POOL_BWD_TAPS, "enabled", True)
    assert grad() == [0.25] * 4


def test_the_env_var_turns_it_on():
    code = ("from deeplearning4j_tpu_torch.ops import pool_kernels as p; "
            "print(p.POOL_BWD_TAPS['enabled'])")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, DL4J_TPU_POOL_BWD_TAPS="1"), cwd=root,
                         timeout=120)
    assert out.stdout.strip() == "True", out.stderr
