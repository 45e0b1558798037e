"""Cached metric handles for the port's hot paths (the port of
``monitor/instrument.py``, in part: the training, quantization and decode
bundles).

Each subsystem grabs its bundle once and records through plain attribute
access; labeled children are created lazily and memoized.  The rest of the
JAX module (pipeline, resilience, fleet and ops bundles) and its
process-wide telemetry switch are not ported yet.  The training bundle has
no compile series: the port's step is eager, so there is no executable
cache to watch (``training_compiles_total`` and
``training_donated_bytes`` come with a compiled step).

  training_step_ms{model=}           host time of one training step
  training_steps_total{model=}       optimizer steps
  training_dispatches_total{model=}  step dispatches (one per step)
  training_epochs_total{model=}      completed epochs
  quant_calibration_batches_total    batches consumed by PTQ calibration
  quant_bytes_saved                  f32 minus quantized resident bytes
  quant_accuracy_delta               latest parity-check disagreement
  quant_models_total{dtype=}         models quantized, by dominant dtype
  decode_tokens_total{model=}        tokens emitted by a decode engine
  decode_inter_token_ms{model=}      time between a sequence's tokens
  decode_kv_blocks_in_use{model=}    KV pages allocated from the pool
  decode_kv_bytes{model=,dtype=}     bytes of KV pages in use
  decode_sequences_active{model=}    sequences holding KV pages
  decode_sequence_restarts_total{model=}  failover restarts (fleet)
"""
from __future__ import annotations

from typing import Optional

from deeplearning4j_tpu_torch.monitor.registry import MetricsRegistry, registry


class TrainingInstruments:
    """Per-model handles over shared series labeled by model kind (two
    networks of one class share series)."""

    def __init__(self, model_kind: str,
                 registry_: Optional[MetricsRegistry] = None):
        reg = registry_ if registry_ is not None else registry()
        lbl = {"model": model_kind}
        self.step_ms = reg.histogram(
            "training_step_ms", help="host wall time per training step (ms; "
            "kernels are queued, not waited for)", labels=lbl)
        self.steps = reg.counter(
            "training_steps_total", help="optimizer steps run", labels=lbl)
        self.dispatches = reg.counter(
            "training_dispatches_total",
            help="training step dispatches (one per step)", labels=lbl)
        self.epochs = reg.counter(
            "training_epochs_total", help="completed epochs", labels=lbl)

    def record_dispatch(self, dt_s: float, steps: int = 1) -> None:
        """One dispatch of `steps` optimizer steps taking `dt_s` host
        seconds."""
        self.steps.inc(steps)
        self.dispatches.inc()
        self.step_ms.observe(dt_s * 1000.0 / max(steps, 1))

    def record_epoch(self) -> None:
        self.epochs.inc()


class QuantInstruments:
    """Quantized-inference handles (``quant.calibrate`` / ``quant.ptq``)."""

    def __init__(self, registry_: Optional[MetricsRegistry] = None):
        reg = registry_ if registry_ is not None else registry()
        self._reg = reg
        self.calibration_batches = reg.counter(
            "quant_calibration_batches_total",
            help="batches consumed by PTQ calibration passes (percentile "
            "observers replay the iterator, so each pass counts)")
        self.bytes_saved = reg.gauge(
            "quant_bytes_saved",
            help="param bytes saved by quantization: f32 resident bytes "
            "minus quantized resident bytes, summed over quantized models")
        self.accuracy_delta = reg.gauge(
            "quant_accuracy_delta",
            help="f32-vs-quantized disagreement of the most recent parity "
            "check (top-1 disagreement fraction, or relative error for "
            "regression heads)")
        self._models: dict = {}

    def record_calibration_batch(self) -> None:
        self.calibration_batches.inc()

    def models(self, dtype: str):
        c = self._models.get(dtype)
        if c is None:
            c = self._reg.counter(
                "quant_models_total",
                help="models quantized, labeled by the dominant produced "
                "dtype (int8, or bf16 when range-hostile fallback won)",
                labels={"dtype": dtype})
            self._models[dtype] = c
        return c

    def record_model(self, dtype: str, bytes_saved: int) -> None:
        self.models(dtype).inc()
        self.bytes_saved.inc(bytes_saved)

    def record_accuracy_delta(self, delta: float) -> None:
        self.accuracy_delta.set(float(delta))


class DecodeInstruments:
    """Decode-engine handles (``serving.decode``), each a labeled child per
    model, so several engines land on one family each."""

    def __init__(self, registry_: Optional[MetricsRegistry] = None):
        self._reg = registry_ if registry_ is not None else registry()
        self._children: dict = {}

    def _child(self, kind: str, name: str, help: str, **labels):
        key = (name, tuple(sorted(labels.items())))
        c = self._children.get(key)
        if c is None:
            c = getattr(self._reg, kind)(name, help=help, labels=labels)
            self._children[key] = c
        return c

    def tokens(self, model: str):
        return self._child(
            "counter", "decode_tokens_total",
            "tokens emitted by the decode engine (prefill last token + "
            "every generated token)", model=model)

    def inter_token(self, model: str):
        return self._child(
            "histogram", "decode_inter_token_ms",
            "wall time between consecutive tokens of one sequence (the "
            "per-token SLO series)", model=model)

    def kv_blocks(self, model: str):
        return self._child(
            "gauge", "decode_kv_blocks_in_use",
            "KV pages currently allocated out of the shared pool",
            model=model)

    def kv_bytes(self, model: str, dtype: str):
        return self._child(
            "gauge", "decode_kv_bytes",
            "bytes of KV-cache pages currently in use, labeled by page "
            "dtype (int8 pages count their f32 scales too)",
            model=model, dtype=dtype)

    def sequences_active(self, model: str):
        return self._child(
            "gauge", "decode_sequences_active",
            "sequences currently holding KV pages (admitted, not retired)",
            model=model)

    def restarts(self, model: str):
        return self._child(
            "counter", "decode_sequence_restarts_total",
            "sequences restarted from token 0 on another replica after a "
            "replica failure", model=model)

    def record_token(self, model: str, inter_token_ms: Optional[float],
                     n: int = 1) -> None:
        self.tokens(model).inc(n)
        if inter_token_ms is not None:
            self.inter_token(model).observe(float(inter_token_ms))

    def record_kv(self, model: str, blocks_in_use: int, bytes_in_use: int,
                  dtype: str) -> None:
        self.kv_blocks(model).set(int(blocks_in_use))
        self.kv_bytes(model, dtype).set(int(bytes_in_use))

    def record_active(self, model: str, n: int) -> None:
        self.sequences_active(model).set(int(n))

    def record_restart(self, model: str) -> None:
        self.restarts(model).inc()


_quant: Optional[QuantInstruments] = None
_decode: Optional[DecodeInstruments] = None


def quant_instruments() -> QuantInstruments:
    """Process-wide quant handle bundle (lazy singleton)."""
    global _quant
    if _quant is None:
        _quant = QuantInstruments()
    return _quant


def decode_instruments() -> DecodeInstruments:
    """Process-wide decode-engine handle bundle (lazy singleton)."""
    global _decode
    if _decode is None:
        _decode = DecodeInstruments()
    return _decode
