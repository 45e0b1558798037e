"""Model parallelism's kernels on the card at world 1 (``cuda`` marker;
each test skips without a CUDA device, and the file imports no JAX).

``ring_attention_flash`` over a one-rank ``seq`` axis is one call of the
flash kernel: it launches the kernel once a call and equals the plain
ring within the attention bounds (f32: 1e-4 of the max; bf16: 2 ulp of
the max), and its gradients (the plain ring's backward) equal the plain
ring's.  A column-parallel Dense shard (fc6's [25088, 2048] half at M = 32)
runs ``fused_dense`` and equals its plain version within 1e-4 of the max.

Run on a machine with an H100: ``python -m pytest tests/test_torch_mp_card.py -q``.
"""
import torch_test_threads  # noqa: F401  (first: one torch thread a worker)
import math

import pytest
import torch

from deeplearning4j_tpu_torch.parallel import make_mesh, ring_attention, ring_attention_flash


def _bound(dt, ref_max):
    if dt == torch.float32:
        return 1e-4 * ref_max
    return 2.0 * 2.0 ** (math.floor(math.log2(max(ref_max, 2.0 ** -126))) - 7)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the flash and fused_dense kernels run only there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_flash_at_world_one_is_one_flash_call(dev, dt, causal):
    from deeplearning4j_tpu_torch.ops.kernels import attention
    mesh = make_mesh({"seq": 1}, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v, g = (torch.randn(2, 4, 512, 64, generator=gen, device=dev).to(dt)
                  for _ in range(4))
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    before = attention.LAUNCHES.value
    out = ring_attention_flash(q, k, v, "seq", causal=causal, mesh=mesh)
    torch.cuda.synchronize()
    assert attention.LAUNCHES.value == before + 1
    grads = torch.autograd.grad(out, (q, k, v), g)
    qd, kd, vd = (t.detach().requires_grad_(True) for t in (q, k, v))
    plain = ring_attention(qd, kd, vd, "seq", causal=causal, mesh=mesh)
    want = torch.autograd.grad(plain, (qd, kd, vd), g)
    for a, b in zip((out,) + grads, (plain,) + want):
        ref_max = b.float().abs().max().item()
        assert (a.float() - b.float()).abs().max().item() <= _bound(dt, ref_max)


@pytest.mark.cuda
def test_column_parallel_fc6_shard_runs_fused_dense(dev):
    from deeplearning4j_tpu_torch.ops.kernels import matmul
    gen = torch.Generator(device=dev).manual_seed(1)
    M, K, N = 32, 25088, 2048
    x = torch.randn(M, K, generator=gen, device=dev)
    w = torch.randn(K, N, generator=gen, device=dev) / math.sqrt(K)
    b = torch.randn(N, generator=gen, device=dev)
    before = matmul.LAUNCHES.value
    got = matmul.fused_dense(x, w, b, "relu")
    torch.cuda.synchronize()
    assert matmul.LAUNCHES.value == before + 1
    want = matmul.fused_dense_reference(x, w, b, "relu")
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
