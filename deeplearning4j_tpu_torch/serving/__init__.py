"""Model-serving runtime of the port (serving slice: one server on one
device).

    registry        — named, versioned models (direct / zoo / quantized
                      rolls)
    compile_cache   — power-of-two shape buckets, one bucket forward per
                      (model, bucket), warmed up front
    batcher         — continuous batching with deadlines, priority and
                      bounded-queue load shedding
    server          — ModelServer front door (submit/output,
                      graceful draining shutdown)
    metrics         — p50/p95/p99 latency, queue depth, batch occupancy,
                      bucket-cache hit rate
    decode          — autoregressive decode engine: bucketed prefill,
                      token-level continuous batching over a paged (f32 or
                      int8) KV cache on the device
"""
from deeplearning4j_tpu_torch.serving.batcher import (  # noqa: F401
    ContinuousBatcher, DeadlineExceededError, RejectedError)
from deeplearning4j_tpu_torch.serving.decode import (  # noqa: F401
    DecodeEngine, DecodeSequence, DecodeServerAdapter, KVBlockAllocator,
    KVCacheExhausted, PagedKVCache, TinyDecodeModel)
from deeplearning4j_tpu_torch.serving.compile_cache import (  # noqa: F401
    BucketedCompileCache, bucket_for, bucket_sizes)
from deeplearning4j_tpu_torch.serving.metrics import ServingMetrics  # noqa: F401
from deeplearning4j_tpu_torch.serving.registry import (  # noqa: F401
    ModelEntry, ModelRegistry)
from deeplearning4j_tpu_torch.serving.server import ModelServer  # noqa: F401
