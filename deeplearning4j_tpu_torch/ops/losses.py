"""Loss function inventory (the port of ``ops/losses.py``).

Each loss is ``loss(labels, preactivations_or_probs, mask) -> scalar mean
score``, with the JAX package's names, formulas and score convention:
per-example losses are summed over the output dimension, then averaged
over the (unmasked) examples.  Gradients come from autograd.  Under a
data-parallel step (``utils/data_parallel.py``) each mean is this rank's
share of the global batch's: an unmasked mean over the group size, a
masked one over the global mask sum.  Losses in
``LOGIT_LOSSES`` take raw pre-activations (the numerically stable fused
path); ``apply_loss`` applies the configured activation for the others.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.utils.data_parallel import global_count, mean_share

LossFn = Callable[..., torch.Tensor]

_EPS = 1e-7


def _reduce(per_example: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """per_example: [batch] (already summed over features).  Mean over the
    batch, honouring an optional per-example (or broadcastable) mask."""
    if mask is not None:
        mask = mask.reshape(per_example.shape).to(per_example.dtype)
        return torch.sum(per_example * mask) / torch.clamp(global_count(torch.sum(mask)),
                                                           min=1.0)
    return mean_share(torch.mean(per_example))


def _masked_reduce(elem: torch.Tensor, mask: Optional[torch.Tensor],
                   mean_over_features: bool = False) -> torch.Tensor:
    """Reduce an elementwise loss [batch, ...] to a scalar.  The mask (if
    any) covers the leading dims of `elem`; masked units leave both the
    numerator and the denominator.  `mean_over_features` divides by the
    feature count (MSE/MAE style); otherwise features are summed."""
    if mask is None:
        per = torch.sum(elem.reshape(elem.shape[0], -1), dim=-1)
        if mean_over_features:
            n = 1
            for s in elem.shape[1:]:
                n *= s
            per = per / max(n, 1)
        return mean_share(torch.mean(per))
    feat = 1
    for s in elem.shape[mask.ndim:]:
        feat *= s
    m = mask.reshape(tuple(mask.shape) + (1,) * (elem.ndim - mask.ndim)).to(elem.dtype)
    total = torch.sum(elem * m)
    denom = torch.clamp(global_count(torch.sum(m)), min=1.0)
    if mean_over_features:
        denom = denom * max(feat, 1)
    return total / denom


def _per_step(per: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Time-series [batch, time] per-step losses: masked mean over steps
    when the mask has their shape, else summed over time per example."""
    if per.ndim > 1:
        if mask is not None and tuple(mask.shape) == tuple(per.shape):
            m = mask.to(per.dtype)
            return torch.sum(per * m) / torch.clamp(global_count(torch.sum(m)), min=1.0)
        per = torch.sum(per, dim=tuple(range(1, per.ndim)))
    return _reduce(per, mask)


def apply_loss(loss, act_fn, pre, labels, mask=None):
    """Single dispatch point for the logits-vs-activations split."""
    name = loss if isinstance(loss, str) else ""
    if str(name).lower() in LOGIT_LOSSES:
        return get_loss(loss)(labels, pre, mask)
    return get_loss(loss)(labels, act_fn(pre), mask)


def _relu(x):
    """max(x, 0) with the JAX package's gradient at x == 0: half of it
    (``jnp.maximum`` and ``jnp.clip`` split a tie; ``torch.clamp`` passes
    all of it, ``torch.maximum`` splits it)."""
    return torch.maximum(x, torch.zeros_like(x))


def _clip(x, lo, hi=None):
    """``jnp.clip(x, lo, hi)`` with its gradient at a bound: half of it
    (``torch.clamp`` passes all of it)."""
    y = torch.maximum(x, torch.full_like(x, lo))
    return y if hi is None else torch.minimum(y, torch.full_like(x, hi))


def _abs(x):
    """|x| with the JAX package's gradient at x == 0: all of it, as
    ``jnp.abs`` gives (``torch.abs`` gives none)."""
    return torch.where(x >= 0, x, -x)


def mcxent(labels, logits, mask=None):
    """Multi-class cross entropy on logits (log-softmax)."""
    per = -torch.sum(labels * F.log_softmax(logits, dim=-1), dim=-1)
    return _per_step(per, mask)


def negativeloglikelihood(labels, probs, mask=None):
    per = -torch.sum(labels * torch.log(_clip(probs, _EPS, 1.0)), dim=-1)
    return _per_step(per, mask)


def xent(labels, logits, mask=None):
    """Binary cross entropy on logits (fused with sigmoid).  ``_relu`` and
    ``_abs`` take the JAX package's gradients at a logit of exactly 0,
    where a sigmoid head on a zero input with a zero bias sits."""
    elem = (_relu(logits) - logits * labels
            + torch.log1p(torch.exp(-_abs(logits))))
    return _masked_reduce(elem, mask)


def mse(labels, preds, mask=None):
    return _masked_reduce((preds - labels) ** 2, mask, mean_over_features=True)


def l2(labels, preds, mask=None):
    return _masked_reduce((preds - labels) ** 2, mask)


def l1(labels, preds, mask=None):
    return _masked_reduce(_abs(preds - labels), mask)


def mae(labels, preds, mask=None):
    return _masked_reduce(_abs(preds - labels), mask, mean_over_features=True)


def _signs(labels):
    return torch.where(labels > 0, 1.0, -1.0).to(labels.dtype)


def hinge(labels, preds, mask=None):
    """labels in {-1, +1} or {0, 1} (converted)."""
    return _masked_reduce(_relu(1.0 - _signs(labels) * preds), mask)


def squared_hinge(labels, preds, mask=None):
    return _masked_reduce(_relu(1.0 - _signs(labels) * preds) ** 2, mask)


def kl_divergence(labels, probs, mask=None):
    elem = labels * (torch.log(_clip(labels, _EPS, 1.0))
                     - torch.log(_clip(probs, _EPS, 1.0)))
    return _masked_reduce(elem, mask)


def poisson(labels, preds, mask=None):
    return _masked_reduce(preds - labels * torch.log(_clip(preds, _EPS)),
                          mask)


def cosine_proximity(labels, preds, mask=None):
    ln = labels / torch.clamp(torch.linalg.norm(labels, dim=-1, keepdim=True), min=_EPS)
    pn = preds / torch.clamp(torch.linalg.norm(preds, dim=-1, keepdim=True), min=_EPS)
    return _per_step(-torch.sum(ln * pn, dim=-1), mask)


def mape(labels, preds, mask=None):
    elem = 100.0 * _abs((labels - preds) / torch.clamp(torch.abs(labels), min=_EPS))
    return _masked_reduce(elem, mask, mean_over_features=True)


def msle(labels, preds, mask=None):
    elem = (torch.log1p(_relu(preds)) - torch.log1p(_relu(labels))) ** 2
    return _masked_reduce(elem, mask, mean_over_features=True)


def sparse_mcxent(labels, logits, mask=None):
    """Integer-label cross entropy."""
    logp = F.log_softmax(logits, dim=-1)
    idx = labels.to(torch.int64).unsqueeze(-1)
    return _per_step(-torch.gather(logp, -1, idx).squeeze(-1), mask)


# Names mirror the JAX package's LOSSES keys.
LOSSES: Dict[str, LossFn] = {
    "mcxent": mcxent,
    "negativeloglikelihood": negativeloglikelihood,
    "xent": xent,
    "mse": mse,
    "squared_loss": mse,
    "l1": l1,
    "l2": l2,
    "mean_absolute_error": mae,
    "mean_squared_logarithmic_error": msle,
    "mean_absolute_percentage_error": mape,
    "hinge": hinge,
    "squared_hinge": squared_hinge,
    "kl_divergence": kl_divergence,
    "reconstruction_crossentropy": xent,
    "poisson": poisson,
    "cosine_proximity": cosine_proximity,
    "sparse_mcxent": sparse_mcxent,
}

# Losses that expect raw logits and fuse the final activation internally.
LOGIT_LOSSES = {"mcxent", "xent", "sparse_mcxent"}


def get_loss(name_or_fn) -> LossFn:
    """The loss function for a name (case-insensitive), or the callable
    itself; raises on an unknown name."""
    if callable(name_or_fn):
        return name_or_fn
    key = str(name_or_fn).lower()
    if key not in LOSSES:
        raise ValueError(f"Unknown loss '{name_or_fn}'. Known: {sorted(LOSSES)}")
    return LOSSES[key]
