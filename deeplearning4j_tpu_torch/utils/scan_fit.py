"""Multi-step training helpers (the port of ``utils/scan_fit.py``).

``check_steps_axes`` checks that the arrays of a stacked ``[k, batch,
...]`` block share one leading steps axis.  The JAX package's
``make_scan_step`` (k steps in one compiled ``lax.scan``) and
``blocks_of`` (which groups an iterator's batches for it) have no
counterpart: the port's ``fit_steps`` runs its k steps in a Python loop,
with the same math as k ``fit_batch`` calls, so ``fit`` steps batch by
batch.
"""


def check_steps_axes(named_arrays):
    """Validate that every non-None array shares one leading steps axis.

    `named_arrays` is an iterable of (name, array-or-None); returns k.
    Raising here names the offending array before any step runs."""
    k, ref = None, None
    for name, a in named_arrays:
        if a is None:
            continue
        if k is None:
            k, ref = a.shape[0], name
        elif a.shape[0] != k:
            raise ValueError(
                f"steps axis mismatch: '{name}' has {a.shape[0]} steps but "
                f"'{ref}' has {k} — every array needs the same leading "
                f"[k, batch, ...] steps axis")
    if k is None:
        raise ValueError("fit_steps needs at least one array input")
    return k
