"""The port's SameDiff op table against its spec cases and the JAX ops.

Every case of ``tests/opval_specs_{core,nn,misc,configs,bf16}.py`` (the
JAX package's OpValidation corpus, with its gradient augmentation) whose
op is in the port's table runs through the port's ``validate_case`` at the
case's own tolerances: the forward value against the case's golden or
property check, the shape function on meta tensors, and the autograd
gradient against an f64 central difference.  The same inputs then go
through the JAX op once, and the two outputs agree at the case's
tolerance.  The conv, pooling and resize cases whose golden is TensorFlow's
(``TF_GOLDEN``) are held here to the JAX op, and
``tests/test_torch_tf_import.py`` holds them to TF's golden (this file
imports no TF).  Two cases feed a JAX PRNG key; the port feeds a
``torch.Generator`` in their place.  The coverage test checks that every
op of the port has a case, that the port's table is a subset of the JAX
package's, and that every op the port's TF and ONNX mappers and SD
namespaces emit is in the port's table.
"""
import torch_test_threads  # noqa: F401  (first: one torch thread a worker)
import dataclasses
import pathlib
import re

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.autodiff.ops import OP_TABLE as JAX_TABLE
from deeplearning4j_tpu_torch.autodiff.ops import DTYPE_NAMES, OP_TABLE, keep_mask
from deeplearning4j_tpu_torch.autodiff.validation import (OpTestCase, _compare,
                                                          coverage_report, to_numpy,
                                                          torch_args, validate_case)
from tests.test_op_validation import ALL_CASES

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: ops that read their data on the host (numpy index tables), so they do
#: not run on meta tensors
NO_META = {"resize_bilinear", "resize_nearest", "mirror_pad"}


def _dropout_train_custom(fn):
    x = np.random.RandomState(5).uniform(0.1, 2.0, (40, 25)).astype(np.float32)
    y = to_numpy(fn(torch.from_numpy(x), torch.Generator().manual_seed(3), p=0.8))
    kept = y != 0
    np.testing.assert_allclose(y[kept], (x / 0.8)[kept], rtol=1e-5)
    assert 0.55 < kept.mean() < 0.97


def _rng_fold_opt_custom(fn):
    assert fn(None, tag=3) is None
    g = torch.Generator().manual_seed(0)
    assert fn(g, tag=3) is g


#: cases whose custom check feeds a JAX PRNG key, by case id
PORT_CUSTOM = {"dropout-train": _dropout_train_custom,
               "rng_fold_opt": _rng_fold_opt_custom}

CASES = [c for c in ALL_CASES if c.op in OP_TABLE]


def _tf_golden(c) -> bool:
    """The case's golden calls TensorFlow."""
    code = getattr(c.golden, "__code__", None)
    return code is not None and any(n.startswith("_tf") or n == "tf"
                                    for n in code.co_names)


TF_GOLDEN = {c.id for c in CASES if _tf_golden(c)}


def port_case(c, tf_golden: bool = False) -> OpTestCase:
    """The JAX package's case as the port's; a TensorFlow golden is kept
    only with `tf_golden`."""
    fields = {f.name: getattr(c, f.name) for f in dataclasses.fields(c)}
    fields["custom"] = PORT_CUSTOM.get(c.id, c.custom)
    if c.id in TF_GOLDEN and not tf_golden:
        fields["golden"] = None
    return OpTestCase(meta=c.op not in NO_META, **fields)


def _jax_out(case):
    import jax.numpy as jnp
    args = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in case.args]
    return JAX_TABLE[case.op](*args, **case.kwargs)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_op_against_specs_and_the_jax_op(case):
    validate_case(port_case(case))
    if case.custom is not None:
        return
    got = OP_TABLE[case.op](*torch_args(case.args), **case.kwargs)
    want = [np.asarray(w) for w in _leaves(_jax_out(case))]
    _compare(got, want, case.tol, f"{case.id} against the JAX op")
    for g, w in zip(_leaves(got), want):
        got_dt = DTYPE_NAMES[g.dtype] if isinstance(g, torch.Tensor) else np.asarray(g).dtype.name
        assert got_dt == w.dtype.name, (case.id, got_dt, w.dtype)


def _leaves(out):
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in _leaves(o)]
    return [out]


def _emitted_ops():
    """Op names the port's TF and ONNX mappers and SD namespaces pass to
    ``op``."""
    names = set()
    for f in ("deeplearning4j_tpu_torch/modelimport/tf_import.py",
              "deeplearning4j_tpu_torch/modelimport/onnx_import.py",
              "deeplearning4j_tpu_torch/autodiff/samediff.py"):
        names |= set(re.findall(r'(?:sd|scope|_sd)\.op\(\s*"([a-z_0-9]+)"',
                                (ROOT / f).read_text()))
    return names


def test_coverage_subset_and_emitted_names():
    port_cases = [port_case(c, tf_golden=True) for c in CASES]
    missing, stale, unknown, pct = coverage_report(port_cases, {})
    assert not missing and not stale and not unknown, (missing, stale, unknown)
    assert {c.split('-')[0] for c in TF_GOLDEN} <= {
        "conv2d", "depthwise_conv2d", "max_pooling2d", "avg_pooling2d",
        "resize_bilinear", "resize_nearest"}, sorted(TF_GOLDEN)
    assert pct >= 0.9
    assert set(OP_TABLE) <= set(JAX_TABLE), sorted(set(OP_TABLE) - set(JAX_TABLE))
    emitted = _emitted_ops()
    assert len(emitted) > 60
    assert emitted - {"cond", "while_loop", "scan"} <= set(OP_TABLE), \
        sorted(emitted - set(OP_TABLE))


def test_weak_scalars_promote_as_jax():
    """A Python scalar takes the tensor's dtype; two tensors promote by
    dtype whatever their ranks (JAX has no rank-0 exception).  An int
    tensor with a float scalar goes to the default float type: the port's
    is f32, JAX's under x64 (as the tests run it) f64."""
    import jax.numpy as jnp
    f32 = np.ones((2, 3), np.float32)
    i32 = np.ones((2, 3), np.int32)
    s64 = np.float64(2.0)
    for op in ("add", "mul", "sub", "div", "maximum", "pow"):
        assert OP_TABLE[op](torch.as_tensor(i32), 2.5).dtype == torch.float32
        for a, b in ((f32, 2.0), (2.0, f32), (i32, 3), (f32, s64)):
            want = JAX_TABLE[op](*(jnp.asarray(v) if isinstance(v, (np.ndarray, np.generic))
                                   else v for v in (a, b)))
            got = OP_TABLE[op](*(torch.as_tensor(v) if isinstance(v, (np.ndarray, np.generic))
                                 else v for v in (a, b)))
            assert str(got.dtype).replace("torch.", "") == str(want.dtype), (op, a, b)


def test_keep_mask_draws_from_the_generator():
    x = torch.ones(1000)
    a = keep_mask(torch.Generator().manual_seed(1), 0.7, x)
    b = keep_mask(torch.Generator().manual_seed(1), 0.7, x)
    assert torch.equal(a, b) and 0.6 < a.float().mean().item() < 0.8


# ---------------------------------------------------------------------------
# gradients at kinks against jax.grad
# ---------------------------------------------------------------------------

#: ops of the JAX table whose gradient the probe holds at kink inputs even
#: where their spec case checks no gradient (the losses SameDiff's
#: ``sd.loss`` reaches)
KINK_EXTRA = {"abs": (0,), "relu6": (0,), "sigmoid_cross_entropy": (1,),
              "absolute_difference": (1,)}
KINK_RTOL = 1e-10
#: ops whose JAX version has no reverse-mode rule (lax.reduce_window over a
#: generic add); tests/test_torch_onnx_ops.py holds their gradients to
#: jax.jacfwd instead
JAX_NO_VJP = {"avg_pool2d_nchw"}


def _kink_cases():
    seen = set()
    for c in CASES:
        grad = c.grad or KINK_EXTRA.get(c.op, ())
        if not grad or c.custom is not None or c.id in seen or c.op in JAX_NO_VJP:
            continue
        if any(isinstance(c.args[i], np.ndarray) and c.args[i].dtype.name == "bfloat16"
               for i in grad):
            continue
        seen.add(c.id)
        yield c, grad


def _kink_args(args, variant):
    """Float arrays in f64, rounded to integers (ties at max/min/clip
    bounds, abs and relu6 kinks, equal labels and preds) or all zeros."""
    out = []
    for a in args:
        if isinstance(a, np.ndarray) and a.dtype.kind == "f":
            a = a.astype(np.float64)
            a = np.round(a) if variant == "round" else np.zeros_like(a)
        out.append(a)
    return out


def _weights(out, rs):
    return [rs.uniform(0.5, 1.5, np.shape(o)) for o in out]


def _jax_grad(op, args, grad, kwargs, w):
    import jax
    import jax.numpy as jnp

    def total(*diff):
        full = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
        for i, d in zip(grad, diff):
            full[i] = d
        out = [o for o in _leaves(JAX_TABLE[op](*full, **kwargs))
               if jnp.issubdtype(jnp.asarray(o).dtype, jnp.floating)]
        return sum(jnp.sum(o * wi) for o, wi in zip(out, w))
    got = jax.jit(jax.grad(total, argnums=tuple(range(len(grad)))))(
        *[jnp.asarray(args[i]) for i in grad])
    return [np.asarray(g) for g in got]


def test_gradients_at_kinks_match_jax():
    """Every differentiable op case (the spec's gradient arguments, plus
    abs, relu6, sigmoid_cross_entropy and absolute_difference) with its
    float inputs in f64 rounded to integers (and, for those four, set to
    zeros): autograd
    through the port's op against jax.grad of the JAX op, max|diff| <=
    1e-10 * max(max|ref|, 1), on a weighted sum of the outputs.  Where JAX
    gives NaN (an undefined derivative, ROADMAP Queue C's NaN points) the
    element is not compared.  ``avg_pool2d_nchw``, whose JAX op has no
    reverse-mode rule, is held to jax.jacfwd in test_torch_onnx_ops.py.
    Then lax.top_k's order of signed zeros."""
    bad = []
    n = 0
    for c, grad in _kink_cases():
        for variant in ("round", "zeros") if c.op in KINK_EXTRA else ("round",):
            args = _kink_args(c.args, variant)
            targs = torch_args(args)
            with torch.no_grad():
                probe = [o for o in _leaves(OP_TABLE[c.op](*targs, **c.kwargs))
                         if torch.is_tensor(o) and o.is_floating_point()]
            w = _weights(probe, np.random.RandomState(len(c.id)))
            fn = (lambda *a, _c=c: OP_TABLE[_c.op](*a, **_c.kwargs))
            targs = torch_args(args)
            for i in grad:
                targs[i] = targs[i].clone().requires_grad_(True)
            out = [o for o in _leaves(fn(*targs)) if torch.is_tensor(o)
                   and o.is_floating_point()]
            total = sum(torch.sum(o * torch.as_tensor(wi, dtype=o.dtype))
                        for o, wi in zip(out, w))
            got = torch.autograd.grad(total, [targs[i] for i in grad], allow_unused=True)
            got = [np.zeros(np.shape(args[i])) if g is None else g.detach().numpy()
                   for i, g in zip(grad, got)]
            want = _jax_grad(c.op, args, grad, c.kwargs, w)
            n += 1
            for i, g, r in zip(grad, got, want):
                keep = np.isfinite(r)
                scale = max(float(np.abs(r[keep]).max()) if keep.any() else 0.0, 1.0)
                err = float(np.abs(g[keep] - r[keep]).max()) if keep.any() else 0.0
                if g.shape != r.shape or err > KINK_RTOL * scale:
                    bad.append(f"{c.id} [{variant}] arg {i}: max|diff| {err}")
    assert n > 110, n
    assert not bad, "\n".join(bad)
    vals, idx = OP_TABLE["top_k"](torch.tensor([[0.0, -0.0, 1.0, -0.0, 0.0]],
                                                dtype=torch.float64), k=4)
    assert idx.tolist() == [[2, 0, 4, 1]]
    assert torch.signbit(vals).tolist() == [[False, False, False, True]]
