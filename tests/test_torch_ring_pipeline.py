"""Ring attention and the GPipe pipeline of the PyTorch port
(``parallel/ring_attention.py``, ``parallel/pipeline.py``) against the JAX
package's on a mesh of four.

A module-scoped pool of 4 gloo ranks on the CPU (``RankPool`` of
``test_torch_parallel.py``) runs each task on every rank; the parent runs
the JAX functions under ``shard_map`` on 4 of the 8 virtual CPU devices
(the flash ring's Pallas kernel in interpret mode).  Inputs are made with
numpy from a seed.  Tolerances, as max|diff| <= rtol * max|ref| per
tensor: the pipeline in f64 at 1e-10; the plain ring, whose scores and
statistics are f32 in both packages whatever the inputs, at 1e-6 on f32
inputs (against the f64 full attention of the same f32 inputs too); the
flash ring in f32 at 2e-5 for values and 1e-4 for gradients (the JAX
kernel and the port's plain flash version step their online softmax over
different key blocks).
"""
import torch_test_threads  # noqa: F401  (first: one torch thread a worker)
import functools

import numpy as np
import pytest
import torch

from tests.test_torch_parallel import RankPool, close

WORLD = 4
RTOL = 1e-10
RING_RTOL = 1e-6
FLASH_RTOL, FLASH_GRAD_RTOL = 2e-5, 1e-4
B, H, T, D = 2, 2, 16, 8


@pytest.fixture(scope="module")
def pool():
    p = RankPool(WORLD)
    yield p
    p.close()


def _qkv(dtype, seed=0):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(B, H, T, D).astype(dtype) for _ in range(3))
    mask = (rs.rand(B, T) > 0.3).astype(dtype)
    mask[:, 0] = 1.0                      # every row keeps a key
    w = rs.uniform(0.5, 1.5, (B, H, T, D)).astype(dtype)
    return q, k, v, mask, w


def _jax_ring(flash, causal, masked, dtype):
    """JAX ring attention over {seq: 4}: the output and the gradients of
    sum(out * w) in q, k and v."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from deeplearning4j_tpu.parallel import make_mesh
    from deeplearning4j_tpu.parallel.mesh import shard_map
    from deeplearning4j_tpu.parallel.ring_attention import (ring_attention,
                                                            ring_attention_flash)
    mesh = make_mesh({"seq": WORLD}, jax.devices()[:WORLD])
    q, k, v, mask, w = _qkv(dtype)
    spec = P(None, None, "seq", None)
    if flash:
        fn = functools.partial(ring_attention_flash, axis_name="seq", causal=causal,
                               block_q=4, block_k=4, interpret=True)
        f = shard_map(fn, mesh=mesh, in_specs=(spec,) * 3, out_specs=spec,
                      check_vma=False)
        args = (q, k, v)
    elif masked:
        fn = functools.partial(ring_attention, axis_name="seq", causal=causal)
        f = shard_map(lambda a, b, c, m: fn(a, b, c, mask=m), mesh=mesh,
                      in_specs=(spec,) * 3 + (P(None, "seq"),), out_specs=spec)
        args = (q, k, v, mask)
    else:
        fn = functools.partial(ring_attention, axis_name="seq", causal=causal)
        f = shard_map(fn, mesh=mesh, in_specs=(spec,) * 3, out_specs=spec)
        args = (q, k, v)
    args = tuple(jnp.asarray(a) for a in args)

    @jax.jit
    def both(*a):
        return jax.value_and_grad(lambda x, y, z: jnp.sum(f(x, y, z, *a[3:]) * w),
                                  argnums=(0, 1, 2))(*a[:3])[1], f(*a)
    grads, out = both(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _task_ring(flash, causal, masked, dtype):
    """This rank's chunk of the ring's output and of the gradients of
    sum(out * w), and the plain full attention's."""
    from deeplearning4j_tpu_torch.ops.attention_kernels import mha_reference
    from deeplearning4j_tpu_torch.parallel import make_mesh, ring_attention, ring_attention_flash
    mesh = make_mesh({"seq": WORLD}, device="cpu")
    q, k, v, mask, w = (torch.from_numpy(a) for a in _qkv(dtype))
    r = mesh.coordinate("seq")
    cut = slice(r * (T // WORLD), (r + 1) * (T // WORLD))
    ql, kl, vl = (t[:, :, cut].clone().requires_grad_(True) for t in (q, k, v))
    if flash:
        out = ring_attention_flash(ql, kl, vl, "seq", causal=causal, block_q=4, block_k=4,
                                   mesh=mesh)
    else:
        with mesh:
            out = ring_attention(ql, kl, vl, "seq", causal=causal,
                                 mask=mask[:, cut] if masked else None)
    grads = torch.autograd.grad(torch.sum(out * w[:, :, cut]), (ql, kl, vl))
    qf, kf, vf = (t.double().requires_grad_(True) for t in (q, k, v))
    full = mha_reference(qf, kf, vf, mask=mask.double() if masked else None, causal=causal)
    full_g = torch.autograd.grad(torch.sum(full * w.double()), (qf, kf, vf))
    return (out.detach().numpy(), [g.numpy() for g in grads],
            full.detach()[:, :, cut].numpy(), [g[:, :, cut].numpy() for g in full_g])


def _chunks(results, i):
    return np.concatenate([r[i] for r in results], axis=2)


@pytest.mark.parametrize("causal,masked", [(False, False), (True, False), (False, True),
                                           (True, True)])
def test_ring_attention_values_and_gradients_match_jax(pool, causal, masked):
    want, want_g = _jax_ring(False, causal, masked, np.float32)
    got = pool.run(_task_ring, False, causal, masked, np.float32)
    close(_chunks(got, 0), want, RING_RTOL, "out")
    for j, name in enumerate("qkv"):
        close(np.concatenate([r[1][j] for r in got], axis=2), want_g[j], RING_RTOL,
              f"d{name}")
        close(np.concatenate([r[3][j] for r in got], axis=2), want_g[j], RING_RTOL,
              f"d{name} of the full attention")
    close(_chunks(got, 2), want, RING_RTOL, "the full attention")


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_flash_matches_jax(pool, causal):
    """The port's flash ring (the kernel's plain version on CPU tensors)
    against the JAX flash ring in interpret mode, f32."""
    want, want_g = _jax_ring(True, causal, False, np.float32)
    got = pool.run(_task_ring, True, causal, False, np.float32)
    close(_chunks(got, 0), want, FLASH_RTOL, "out")
    for j, name in enumerate("qkv"):
        close(np.concatenate([r[1][j] for r in got], axis=2), want_g[j], FLASH_GRAD_RTOL,
              f"d{name}")


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

S, DP, BP = WORLD, 8, 16


def _stages_np(seed=2):
    rs = np.random.RandomState(seed)
    return [{"W": rs.randn(DP, DP) * 0.4, "b": rs.randn(DP) * 0.1} for _ in range(S)]


def _pipe_data(seed=3):
    rs = np.random.RandomState(seed)
    return rs.randn(BP, DP), rs.randn(BP, DP)


def _jax_pipeline(M):
    import jax
    import jax.numpy as jnp
    from deeplearning4j_tpu.parallel import make_mesh
    from deeplearning4j_tpu.parallel.pipeline import (pipeline_apply, sequential_apply,
                                                      stack_stage_params)
    mesh = make_mesh({"pipe": S}, jax.devices()[:S])
    params = stack_stage_params([{k: jnp.asarray(v) for k, v in st.items()}
                                 for st in _stages_np()])
    x, y = (jnp.asarray(a) for a in _pipe_data())

    def block(p, h):
        return jnp.tanh(h @ p["W"] + p["b"])
    @jax.jit
    def run(p, xx):
        out = pipeline_apply(block, p, xx, mesh, num_microbatches=M)
        grads = jax.grad(lambda pp, x2: jnp.mean((pipeline_apply(
            block, pp, x2, mesh, num_microbatches=M) - y) ** 2), argnums=(0, 1))(p, xx)
        return out, sequential_apply(block, p, xx), grads
    out, seq, grads = run(params, x)
    return (np.asarray(out), np.asarray(seq),
            {k: np.asarray(v) for k, v in grads[0].items()}, np.asarray(grads[1]))


def _task_pipeline(M, local):
    from deeplearning4j_tpu_torch.parallel import (make_mesh, pipeline_apply,
                                                   sequential_apply, stack_stage_params)
    from deeplearning4j_tpu_torch.parallel.pipeline import stage_slice
    mesh = make_mesh({"pipe": S}, device="cpu")
    stacked = stack_stage_params([{k: torch.tensor(v) for k, v in st.items()}
                                  for st in _stages_np()])
    params = stage_slice(stacked, mesh) if local else stacked
    params = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    x, y = (torch.tensor(a) for a in _pipe_data())
    x.requires_grad_(True)

    def block(p, h):
        return torch.tanh(h @ p["W"] + p["b"])
    out = pipeline_apply(block, params, x, mesh, num_microbatches=M, local=local)
    g = torch.autograd.grad(torch.mean((out - y) ** 2), [params["W"], params["b"], x])
    errors = []
    for bad in (lambda: pipeline_apply(block, params, x[:10], mesh, num_microbatches=4,
                                       local=local),
                lambda: pipeline_apply(block, {k: v[:2] for k, v in stacked.items()}, x,
                                       mesh)):
        try:
            bad()
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    seq = sequential_apply(block, stacked, x.detach())
    return (out.detach().numpy(), seq.numpy(), {"W": g[0].numpy(), "b": g[1].numpy()},
            g[2].numpy(), errors)


@pytest.mark.parametrize("M,local", [(S, False), (2 * S, False), (S, True)])
def test_pipeline_forward_gradients_and_errors_match_jax(pool, M, local):
    want, want_seq, want_g, want_dx = _jax_pipeline(M)
    got = pool.run(_task_pipeline, M, local)
    close(want, want_seq, RTOL, "JAX pipeline against its sequential oracle")
    for r, (out, seq, g, dx, errors) in enumerate(got):
        close(out, want, RTOL, f"rank {r} output")
        close(seq, want_seq, RTOL, "sequential_apply")
        close(dx, want_dx, RTOL, f"rank {r} input gradient")
        for k in ("W", "b"):
            # each rank holds its stage's gradient (its row of the stack)
            row = g[k][0] if local else g[k][r]
            close(row, want_g[k][r], RTOL, f"rank {r} d{k}")
            if not local:
                others = np.delete(g[k], r, axis=0)
                assert not np.any(others), (r, k)
        assert "not divisible by 4 microbatches" in errors[0]
        assert "stage count must equal the pipe-axis size" in errors[1]
