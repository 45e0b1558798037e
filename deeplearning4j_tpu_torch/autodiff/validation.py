"""Per-op validation harness (the port of ``autodiff/validation.py``).

Reference: `nd4j-api/src/main/java/org/nd4j/autodiff/validation/
OpValidation.java` + `TestCase.java`: for every registered op, the forward
value against a golden, the op's shape function against the executed
output, and the analytic gradient against a central finite difference,
with coverage of the whole registry tracked.

On PyTorch:

- *forward value*: the ``OP_TABLE`` entry on tensors made from the case's
  numpy inputs, against an independent golden or a property check;
- *shape function*: the op on ``device="meta"`` tensors (shapes and dtypes,
  no data) gives the shape and dtype of every output leaf of the concrete
  run.  An op that reads its data on the host cannot run on meta tensors;
  its case says so (``meta=False``);
- *gradient*: autograd of a fixed random projection of the outputs
  against a float64 central finite difference, per differentiable tensor
  argument, on ``grad_sample`` seeded coordinates when set;
- *coverage*: :func:`coverage_report` diffs the case list against the
  port's table.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["OpTestCase", "validate_case", "coverage_report"]


@dataclasses.dataclass
class OpTestCase:
    """One validation case for a registry op (reference `TestCase`)."""

    op: str
    args: Tuple[Any, ...] = ()
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    #: numpy value(s) or callable(*np_args, **kwargs) -> value(s)
    golden: Any = None
    #: alternative validator: callable(out_leaves: list[np.ndarray]) that
    #: raises on failure
    check: Optional[Callable] = None
    #: tensor-arg indices to finite-difference gradient-check
    grad: Tuple[int, ...] = ()
    #: if > 0, FD-check only this many seeded random coordinates per arg;
    #: ``OPVAL_FULL=1`` in the env removes the cap
    grad_sample: int = 0
    tol: float = 1e-5
    gtol: float = 5e-3
    #: also check the shape function (the JAX harness's eval_shape + jit)
    jit: bool = True
    #: the op runs on meta tensors (False: it reads its data on the host)
    meta: bool = True
    #: fully custom validation — callable(fn) run instead of the pipeline
    custom: Optional[Callable] = None
    #: distinguishes multiple cases for one op in test ids
    tag: str = ""

    @property
    def id(self) -> str:
        return f"{self.op}{'-' + self.tag if self.tag else ''}"


def _leaves(out):
    """Flatten an op result (tensor / tuple / nested) to leaves."""
    if isinstance(out, (tuple, list)):
        acc = []
        for o in out:
            acc.extend(_leaves(o))
        return acc
    return [out]


def to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


def _is_tensor_arg(a) -> bool:
    return isinstance(a, np.ndarray)


def torch_args(args, dtype_of=None, meta: bool = False):
    """The case's args with each numpy array as a tensor (on the meta
    device with `meta`); the rest as given."""
    out = []
    for a in args:
        if not _is_tensor_arg(a):
            out.append(a)
            continue
        a = np.ascontiguousarray(a)
        if a.dtype.name == "bfloat16":             # ml_dtypes' bfloat16
            t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        if dtype_of is not None:
            t = t.to(dtype_of(t))
        out.append(torch.empty(t.shape, dtype=t.dtype, device="meta") if meta else t)
    return out


def _compare(got, want, tol, what):
    got_l = [to_numpy(g) for g in _leaves(got)]
    want_l = [to_numpy(w) for w in _leaves(want)]
    assert len(got_l) == len(want_l), (
        f"{what}: output arity {len(got_l)} != golden arity {len(want_l)}")
    for i, (g, w) in enumerate(zip(got_l, want_l)):
        assert tuple(g.shape) == tuple(w.shape), (
            f"{what} leaf {i}: shape {g.shape} != golden {w.shape}")
        if g.dtype == bool or np.issubdtype(g.dtype, np.integer):
            np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=f"{what} leaf {i}")
        elif np.issubdtype(g.dtype, np.complexfloating):
            np.testing.assert_allclose(g.astype(np.complex128), w.astype(np.complex128),
                                       rtol=tol, atol=tol, err_msg=f"{what} leaf {i}")
        else:
            np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64),
                                       rtol=tol, atol=tol, err_msg=f"{what} leaf {i}")


def validate_case(case: OpTestCase) -> None:
    """Run the forward / shape function / gradient pipeline for one case."""
    from deeplearning4j_tpu_torch.autodiff.ops import OP_TABLE

    fn = OP_TABLE[case.op]
    if case.custom is not None:
        case.custom(fn)
        return

    tensor_idx = [i for i, a in enumerate(case.args) if _is_tensor_arg(a)]
    out = fn(*torch_args(case.args), **case.kwargs)

    if case.golden is not None:
        want = (case.golden(*case.args, **case.kwargs)
                if callable(case.golden) else case.golden)
        _compare(out, want, case.tol, f"{case.id} forward")
    if case.check is not None:
        case.check([to_numpy(o) for o in _leaves(out)])

    if case.jit and case.meta and tensor_idx:
        abstract = fn(*torch_args(case.args, meta=True), **case.kwargs)
        a_l, o_l = _leaves(abstract), _leaves(out)
        assert len(a_l) == len(o_l), (
            f"{case.id}: meta arity {len(a_l)} != executed {len(o_l)}")
        for i, (a, o) in enumerate(zip(a_l, o_l)):
            assert tuple(a.shape) == tuple(o.shape), (
                f"{case.id} leaf {i}: meta shape {tuple(a.shape)} != executed "
                f"{tuple(o.shape)}")
            assert a.dtype == o.dtype, (
                f"{case.id} leaf {i}: meta dtype {a.dtype} != executed {o.dtype}")

    if case.grad:
        _check_grad(fn, case, tensor_idx)


def _f64(t: torch.Tensor) -> torch.dtype:
    return torch.float64 if t.is_floating_point() else t.dtype


def _check_grad(fn, case: OpTestCase, tensor_idx) -> None:
    """Autograd of sum(out * w) against a central difference, in f64."""
    for gi in case.grad:
        assert gi in tensor_idx, f"{case.id}: grad index {gi} is not a tensor arg"
        assert np.issubdtype(case.args[gi].dtype, np.floating), (
            f"{case.id}: grad arg {gi} is not float")
    base = torch_args(case.args, dtype_of=_f64)
    rs = np.random.RandomState(7)
    probe = fn(*base, **case.kwargs)
    weights = [torch.from_numpy(rs.uniform(0.5, 1.5, tuple(p.shape)))
               if isinstance(p, torch.Tensor) and p.is_floating_point() else None
               for p in _leaves(probe)]

    def loss_at(vals):
        total = torch.zeros((), dtype=torch.float64)
        for p, w in zip(_leaves(fn(*vals, **case.kwargs)), weights):
            if w is not None:
                total = total + torch.sum(p.to(torch.float64) * w)
        return total

    xs = [base[i].clone().requires_grad_(True) for i in case.grad]
    vals = list(base)
    for i, x in zip(case.grad, xs):
        vals[i] = x
    analytic_all = torch.autograd.grad(loss_at(vals), xs, allow_unused=True)

    sample = 0 if os.environ.get("OPVAL_FULL") else case.grad_sample
    eps = 1e-5
    with torch.no_grad():
        for pos, gi in enumerate(case.grad):
            x0 = base[gi]
            g = analytic_all[pos]
            analytic = (torch.zeros_like(x0) if g is None else g).reshape(-1).numpy()
            flat = x0.reshape(-1)
            if sample and flat.numel() > sample:
                coords = np.random.RandomState(0xC0FFEE + gi).choice(
                    flat.numel(), sample, replace=False)
            else:
                coords = np.arange(flat.numel())
            fd = np.empty(len(coords))
            for j, c in enumerate(coords):
                lp, lm = flat.clone(), flat.clone()
                lp[c] += eps
                lm[c] -= eps
                vp, vm = list(base), list(base)
                vp[gi], vm[gi] = lp.reshape(x0.shape), lm.reshape(x0.shape)
                fd[j] = (float(loss_at(vp)) - float(loss_at(vm))) / (2 * eps)
            np.testing.assert_allclose(
                analytic[coords], fd, rtol=case.gtol, atol=case.gtol,
                err_msg=f"{case.id} grad wrt arg {gi}")


def coverage_report(cases: Sequence[OpTestCase], allowlist: Dict[str, str]):
    """Diff the case list against the port's table: (missing, stale
    allowlist entries, unknown ops, value-checked share), as the JAX
    harness reports it."""
    from deeplearning4j_tpu_torch.autodiff.ops import OP_TABLE

    registered = set(OP_TABLE)
    tested = {c.op for c in cases}
    value_checked = {c.op for c in cases
                     if c.golden is not None or c.check is not None
                     or c.custom is not None}
    missing = sorted(registered - tested - set(allowlist))
    stale = sorted(set(allowlist) & tested)
    unknown = sorted((tested | set(allowlist)) - registered)
    pct = len(value_checked & registered) / max(len(registered), 1)
    return missing, stale, unknown, pct
