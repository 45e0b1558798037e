"""Loss-function names (the registry of ``ops/losses.py``).

``OutputLayer`` validates its ``loss`` against these names, which mirror
the JAX package's ``LOSSES`` keys.  The loss math comes with training.
"""
from __future__ import annotations

LOSS_NAMES = frozenset({
    "mcxent", "negativeloglikelihood", "xent", "mse", "squared_loss", "l1",
    "l2", "mean_absolute_error", "mean_squared_logarithmic_error",
    "mean_absolute_percentage_error", "hinge", "squared_hinge",
    "kl_divergence", "reconstruction_crossentropy", "poisson",
    "cosine_proximity", "sparse_mcxent",
})


def get_loss(name_or_fn):
    """The canonical loss name (or the callable itself); raises on an
    unknown name."""
    if callable(name_or_fn):
        return name_or_fn
    key = str(name_or_fn).lower()
    if key not in LOSS_NAMES:
        raise ValueError(f"Unknown loss '{name_or_fn}'. Known: {sorted(LOSS_NAMES)}")
    return key
