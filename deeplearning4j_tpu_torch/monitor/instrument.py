"""Cached metric handles for the port's hot paths (the port of
``monitor/instrument.py``, in part: the training, input-pipeline,
data-parallel, gradient-sharing, quantization, decode, resilience and
gang bundles).

Each subsystem grabs its bundle once and records through plain attribute
access; labeled children are created lazily and memoized.  The rest of the
JAX module (the AOT-cache, arbiter, federation, fleet and ops bundles) is
not ported yet.  A "compile" of the training bundle
is a CUDA-graph capture of a fused k-step block (``utils/scan_fit.py``);
the eager step compiles nothing.

  training_step_ms{model=}           host time of one training step
  training_steps_total{model=}       optimizer steps
  training_dispatches_total{model=}  step dispatches (a fused block is 1)
  training_compiles_total{model=}    CUDA-graph captures of a fused block
  training_donated_bytes{model=}     bytes of the carried tensors (params,
                                     layer and updater state), sampled at
                                     each capture
  training_epochs_total{model=}      completed epochs
  pipeline_prefetch_depth            batches staged ahead of the consumer
  pipeline_producer_wait_ms          consumer wait on the ETL producer
  pipeline_h2d_bytes_total           bytes staged host -> device
  pipeline_batches_total             batches staged
  pipeline_producer_retries_total    producer restarts (retries=)
  parallel_replicas                  data-parallel degree of a wrapper
  parallel_dispatch_ms               host time of a wrapper's dispatch
  parallel_replica_skew_ms           spread of the ranks' device waits
  training_opt_state_bytes{sharded=} updater-state bytes a rank holds
  comms_bytes_on_wire_total{codec=}  gradient-sharing bytes sent and
                                     received (TCP frames with their
                                     length prefixes; codec threshold|dense)
  comms_exchanges_total{codec=}      gang gradient exchanges completed
  comms_compression_ratio            dense / wire bytes of the latest
                                     exchange (1.0 dense)
  comms_exchange_ms                  one exchange: D2H, encode, all-gather,
                                     decode and sum
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
  resilience_checkpoint_save_ms      one checkpoint write (an async save's
                                     background write, not the step stall)
  resilience_checkpoint_bytes        payload bytes of the latest save
  resilience_checkpoints_total       committed saves
  resilience_checkpoint_gc_total     checkpoints removed by keep-last-K
  resilience_restores_total          restores from a committed checkpoint
  resilience_restore_fallbacks_total restores that skipped a damaged one
  resilience_rollbacks_total         divergence-guard rollbacks
  resilience_divergence_events_total steps the divergence guard flagged
  resilience_preemptions_total       preemption signals honored
  gang_generation                    membership generation of the gang
  gang_members                       live ranks in the gang
  gang_detection_ms                  silence on a peer when declared lost
  gang_resume_ms                     reformation caught to training resumed
  gang_stale_frames_total            stale-generation data frames fenced
  gang_reformations_total{cause=}    reformations (crash|partition|
                                     straggler|join|shrink)
"""
from __future__ import annotations

from typing import Optional

from deeplearning4j_tpu_torch.monitor.registry import MetricsRegistry, enabled, registry


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
            help="training step dispatches (a fused k-step block is 1)",
            labels=lbl)
        self.compiles = reg.counter(
            "training_compiles_total",
            help="CUDA-graph captures of a fused k-step block", labels=lbl)
        self.donated_bytes = reg.gauge(
            "training_donated_bytes",
            help="bytes of the carried params/state/opt-state tensors a "
            "captured block writes in place (sampled at captures)", labels=lbl)
        self.epochs = reg.counter(
            "training_epochs_total", help="completed epochs", labels=lbl)
        self._captures: dict = {}

    def record_dispatch(self, dt_s: float, steps: int = 1) -> None:
        """One dispatch of `steps` optimizer steps taking `dt_s` host
        seconds."""
        self.steps.inc(steps)
        self.dispatches.inc()
        self.step_ms.observe(dt_s * 1000.0 / max(steps, 1))

    def check_compile(self, step, model=None) -> None:
        """Count the new CUDA-graph captures of `step` (a
        ``scan_fit.GraphStep``) since the last call; at a capture, set
        ``training_donated_bytes`` to the bytes of `model`'s carried
        tensors.  Only capture events walk the model."""
        n = getattr(step, "captures", None)
        if n is None:
            return
        prev = self._captures.get(id(step), 0)
        if n > prev:
            self.compiles.inc(n - prev)
            if model is not None:
                self.donated_bytes.set(_carried_nbytes(model))
        self._captures[id(step)] = n

    def record_epoch(self) -> None:
        self.epochs.inc()


def _carried_nbytes(model) -> int:
    from deeplearning4j_tpu_torch.train.updaters import tree_leaves
    total = 0
    for tree in (getattr(model, "params_", None), getattr(model, "state_", None),
                 getattr(model, "opt_state_", None)):
        if tree is None:
            continue
        for leaf in tree_leaves(tree):
            if hasattr(leaf, "element_size"):
                total += leaf.numel() * leaf.element_size()
    return total


class PipelineInstruments:
    """Input-pipeline handles (one unlabeled series set per process: the
    prefetch iterators all feed the same trainer)."""

    def __init__(self, registry_: Optional[MetricsRegistry] = None):
        reg = registry_ if registry_ is not None else registry()
        self.prefetch_depth = reg.gauge(
            "pipeline_prefetch_depth",
            help="batches currently staged on device ahead of the consumer")
        self.producer_wait_ms = reg.histogram(
            "pipeline_producer_wait_ms",
            help="time the consumer waited on the ETL producer per batch "
            "(ms); sustained >0 means ETL is the bottleneck")
        self.h2d_bytes = reg.counter(
            "pipeline_h2d_bytes_total",
            help="bytes staged host->device by the input pipeline")
        self.batches = reg.counter(
            "pipeline_batches_total", help="batches staged to device")
        self.producer_retries = reg.counter(
            "pipeline_producer_retries_total",
            help="producer restarts by DevicePrefetchIterator retries=")

    def record_stage(self, wait_s: float, depth: int) -> None:
        self.producer_wait_ms.observe(wait_s * 1000.0)
        self.prefetch_depth.set(depth)
        self.batches.inc()


class ParallelInstruments:
    """Data-parallel wrapper handles (``parallel/wrapper.py``)."""

    def __init__(self, registry_: Optional[MetricsRegistry] = None):
        reg = registry_ if registry_ is not None else registry()
        self.replicas = reg.gauge(
            "parallel_replicas", help="mesh data-parallel degree")
        self.dispatch_ms = reg.histogram(
            "parallel_dispatch_ms",
            help="data-parallel step host dispatch wall time (ms)")
        self.replica_skew_ms = reg.gauge(
            "parallel_replica_skew_ms",
            help="latest measured per-rank completion skew (ms; blocking "
            "diagnostic, see ParallelWrapper.measure_replica_skew)")
        self._opt_state_bytes = {
            flag: reg.gauge(
                "training_opt_state_bytes",
                help="optimizer-state bytes resident per rank (sharded=true: "
                "ZeRO-1 sharded weight update; compare against sharded=false "
                "for the saving)",
                labels={"sharded": "true" if flag else "false"})
            for flag in (True, False)}

    def record_dispatch(self, dt_s: float) -> None:
        self.dispatch_ms.observe(dt_s * 1000.0)

    def record_opt_state_bytes(self, nbytes: int, sharded: bool) -> None:
        """Per-rank optimizer-state footprint sampled at placement."""
        self._opt_state_bytes[bool(sharded)].set(int(nbytes))


class CommsInstruments:
    """Gang gradient-exchange handles (``parallel/hierarchical.py``),
    labeled by codec so the threshold path and the dense A/B baseline stay
    apart in one registry.  ``record_exchange`` consults the registry's
    ``enabled()`` switch."""

    def __init__(self, registry_: Optional[MetricsRegistry] = None):
        reg = registry_ if registry_ is not None else registry()
        self._bytes = {
            codec: reg.counter(
                "comms_bytes_on_wire_total",
                help="gradient payload bytes sent+received over the DCN/host hop "
                "(TCP frames incl. length prefixes)", labels={"codec": codec})
            for codec in ("threshold", "dense")}
        self._exchanges = {
            codec: reg.counter(
                "comms_exchanges_total", help="cross-host gradient exchanges completed",
                labels={"codec": codec})
            for codec in ("threshold", "dense")}
        self.compression_ratio = reg.gauge(
            "comms_compression_ratio",
            help="dense-bytes / wire-bytes of the most recent compressed exchange "
            "(1.0 on the dense path)")
        self.exchange_ms = reg.histogram(
            "comms_exchange_ms",
            help="wall time of one cross-host gradient exchange: D2H + encode + TCP "
            "all-gather + decode + sum (ms)")

    def record_exchange(self, dt_s: float, wire_bytes: int, ratio: float,
                        compressed: bool) -> None:
        if not enabled():
            return
        codec = "threshold" if compressed else "dense"
        self._bytes[codec].inc(int(wire_bytes))
        self._exchanges[codec].inc()
        self.compression_ratio.set(float(ratio))
        self.exchange_ms.observe(dt_s * 1000.0)


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


class ResilienceInstruments:
    """Fault-tolerance handles (``train/resilience.py``,
    ``utils/chaos.py``)."""

    def __init__(self, registry_: Optional[MetricsRegistry] = None):
        reg = registry_ if registry_ is not None else registry()
        self.checkpoint_save_ms = reg.histogram(
            "resilience_checkpoint_save_ms",
            help="wall time of one checkpoint save (ms); for async saves "
            "this is the background write, NOT the step-loop stall")
        self.checkpoint_bytes = reg.gauge(
            "resilience_checkpoint_bytes",
            help="payload bytes of the most recent checkpoint save")
        self.checkpoints = reg.counter(
            "resilience_checkpoints_total",
            help="checkpoint saves committed (manifest written)")
        self.checkpoint_gc = reg.counter(
            "resilience_checkpoint_gc_total",
            help="checkpoints removed by keep-last-K retention GC")
        self.restores = reg.counter(
            "resilience_restores_total",
            help="successful restores from a committed checkpoint")
        self.restore_fallbacks = reg.counter(
            "resilience_restore_fallbacks_total",
            help="restores that skipped a torn or checksum-corrupt newer "
            "checkpoint and fell back to an older intact one")
        self.rollbacks = reg.counter(
            "resilience_rollbacks_total",
            help="divergence-guard rollbacks to the last checkpoint")
        self.divergence_events = reg.counter(
            "resilience_divergence_events_total",
            help="steps the divergence guard flagged (NaN/inf/spike)")
        self.preemptions = reg.counter(
            "resilience_preemptions_total",
            help="preemption signals honored with a checkpoint-and-exit")

    def record_save(self, dt_s: float, nbytes: int) -> None:
        if not enabled():
            return
        self.checkpoint_save_ms.observe(dt_s * 1000.0)
        self.checkpoint_bytes.set(int(nbytes))
        self.checkpoints.inc()


class GangInstruments:
    """Elastic gang-membership handles (``parallel/transport.py``'s
    elastic mesh and ``train/resilience.py``'s ElasticTrainer).  One
    unlabeled series set a process: a process is one gang member."""

    def __init__(self, registry_: Optional[MetricsRegistry] = None):
        reg = registry_ if registry_ is not None else registry()
        self._reg = reg
        self.generation = reg.gauge(
            "gang_generation",
            help="current membership generation of the gradient-mesh gang "
            "(bumped by every reformation; stale-generation traffic is "
            "fenced)")
        self.members = reg.gauge(
            "gang_members", help="live ranks in the gradient-mesh gang")
        self.detection_ms = reg.histogram(
            "gang_detection_ms",
            help="silence observed on a peer at the moment it was declared "
            "lost (ms): the failure-detection latency the heartbeat "
            "deadline bounds")
        self.resume_ms = reg.histogram(
            "gang_resume_ms",
            help="wall time from catching a reformation to training "
            "resumed: sharing rebuild + checkpoint restore + iterator "
            "fast-forward (ms)")
        self.stale_frames = reg.counter(
            "gang_stale_frames_total",
            help="stale-generation data frames fenced and dropped: "
            "traffic from a previous membership generation that must "
            "never be summed into gradients")
        self._reformations: dict = {}

    def reformations(self, cause: str):
        c = self._reformations.get(cause)
        if c is None:
            c = self._reg.counter(
                "gang_reformations_total",
                help="gang membership reformations, by cause "
                "(crash|partition|straggler|join)",
                labels={"cause": cause})
            self._reformations[cause] = c
        return c

    def record_membership(self, generation: int, members: int) -> None:
        if not enabled():
            return
        self.generation.set(int(generation))
        self.members.set(int(members))

    def record_reform(self, cause: str, detection_ms: Optional[float],
                      generation: int, members: int) -> None:
        if not enabled():
            return
        self.reformations(cause).inc()
        if detection_ms is not None:
            self.detection_ms.observe(float(detection_ms))
        self.record_membership(generation, members)


_pipeline: Optional[PipelineInstruments] = None
_resilience: Optional[ResilienceInstruments] = None
_gang: Optional[GangInstruments] = None
_comms: Optional[CommsInstruments] = None
_quant: Optional[QuantInstruments] = None
_decode: Optional[DecodeInstruments] = None


def pipeline_instruments() -> PipelineInstruments:
    """Process-wide input-pipeline handle bundle (lazy singleton)."""
    global _pipeline
    if _pipeline is None:
        _pipeline = PipelineInstruments()
    return _pipeline


def comms_instruments() -> CommsInstruments:
    """Process-wide gradient-sharing handle bundle (lazy singleton)."""
    global _comms
    if _comms is None:
        _comms = CommsInstruments()
    return _comms


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


def resilience_instruments() -> ResilienceInstruments:
    """Process-wide resilience handle bundle (lazy singleton)."""
    global _resilience
    if _resilience is None:
        _resilience = ResilienceInstruments()
    return _resilience


def gang_instruments() -> GangInstruments:
    """Process-wide gang handle bundle (lazy singleton)."""
    global _gang
    if _gang is None:
        _gang = GangInstruments()
    return _gang
