"""The port's layer losses against the JAX package's at their ties.

``jnp.maximum`` and ``jnp.clip`` split the gradient of a tie in half;
``torch.clamp`` passes all of it.  Each loss here takes a clip or a
``max(., 0)``; its inputs sit exactly on the bound, in f64, and the
gradient through the port's loss is held to ``jax.grad`` of the JAX
package's at 1e-10 relative (max|diff| <= 1e-10 * max|ref|).
"""
import torch_test_threads  # noqa: F401  (first: one torch thread a worker)
import numpy as np
import pytest
import torch

RTOL = 1e-10


def _tie_inputs(loss):
    """[5, 4] f64 labels and predictions on the loss's bound."""
    rs = np.random.RandomState(7)
    onehot = np.eye(4)[rs.randint(0, 4, 5)]
    if loss == "hinge":                       # y * p == 1: the margin
        return onehot, np.where(onehot > 0, 1.0, -1.0)
    if loss in ("negativeloglikelihood", "kl_divergence"):
        probs = rs.uniform(0.05, 0.3, (5, 4))
        probs[2] = onehot[2]                  # one row's probability exactly 1.0
        labels = rs.uniform(0.1, 0.9, (5, 4)) if loss == "kl_divergence" else onehot
        return labels, probs
    preds = rs.uniform(0.5, 2.0, (5, 4))      # poisson: one pred exactly at 1e-7
    preds[1, 3] = 1e-7
    return rs.uniform(0.5, 2.0, (5, 4)), preds


@pytest.mark.parametrize("loss", ["hinge", "negativeloglikelihood", "kl_divergence",
                                  "poisson"])
def test_loss_gradients_at_ties_match_jax(loss):
    import jax
    import jax.numpy as jnp
    from deeplearning4j_tpu.ops import losses as jl
    from deeplearning4j_tpu_torch.ops import losses as tl
    labels, preds = _tie_inputs(loss)
    want = np.asarray(jax.grad(lambda p: jl.get_loss(loss)(jnp.asarray(labels), p))(
        jnp.asarray(preds)))
    t = torch.tensor(preds, requires_grad=True)
    tl.get_loss(loss)(torch.tensor(labels), t).backward()
    err = float(np.abs(t.grad.numpy() - want).max())
    assert err <= RTOL * float(np.abs(want).max()), (loss, err)
