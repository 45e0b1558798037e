"""Process telemetry: the metrics registry the serving layer records into."""
from deeplearning4j_tpu_torch.monitor.registry import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, registry)
