"""Model registry: named, versioned model instances for serving (the port
of ``serving/registry.py``).

The single place a `ModelServer` resolves (name, version) → model:

* `register(name, model)`       — an already-built MultiLayerNetwork (or
                                  anything with `params_`/`state_`/
                                  `_forward` and a `device`)
* `register_zoo(name, "VGG16")` — build from the zoo catalog on `device`
* `register_quantized(name, calibration=, config=)` — quantize a registered
                                  version (`quant.quantize_model`) and
                                  register the int8 model as the next one

Versions are integers; `get(name)` returns the highest version, so a
re-registration under the same name is a zero-downtime model roll.  Each
name has a re-entrant version lock (`name_lock`), held by every
registration of that name.  Keras and ONNX registration are not ported
yet.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Tuple


@dataclasses.dataclass
class ModelEntry:
    """One (name, version) deployment unit."""

    name: str
    version: int
    model: Any
    source: str = "direct"              # direct | zoo | quant
    input_shape: Optional[Tuple[int, ...]] = None   # trailing dims (no batch)
    input_dtype: str = "float32"
    registered_at: float = 0.0
    warmed_buckets: List[int] = dataclasses.field(default_factory=list)

    @property
    def key(self) -> str:
        """Stable cache/grouping key for this deployment unit."""
        return f"{self.name}:v{self.version}"


def infer_input_shape(model) -> Optional[Tuple[int, ...]]:
    """Trailing input dims (without batch) from the model's configured
    InputType, for warmup.  None when unknown (dynamic seq length)."""
    it = getattr(getattr(model, "conf", None), "input_type", None)
    if it is None or any(s is None for s in it.shape):
        return None
    return tuple(int(s) for s in it.shape)


class ModelRegistry:
    """Thread-safe name → {version → ModelEntry} catalog with a per-name
    version lock, so two rolls of one name serialize."""

    def __init__(self):
        self._models: Dict[str, Dict[int, ModelEntry]] = {}
        self._lock = threading.Lock()
        self._name_locks: Dict[str, threading.RLock] = {}

    def name_lock(self, name: str) -> threading.RLock:
        """The per-name version lock.  `register()` takes it internally;
        hold it yourself around a sequence of steps on `name` that must not
        interleave with a roll."""
        with self._lock:
            lock = self._name_locks.get(name)
            if lock is None:
                lock = self._name_locks[name] = threading.RLock()
            return lock

    # ---- registration ----
    def register(self, name: str, model, version: Optional[int] = None,
                 source: str = "direct",
                 input_shape: Optional[Tuple[int, ...]] = None,
                 input_dtype: str = "float32") -> ModelEntry:
        with self.name_lock(name), self._lock:
            versions = self._models.setdefault(name, {})
            if version is None:
                version = max(versions) + 1 if versions else 1
            elif version in versions:
                raise ValueError(
                    f"model '{name}' version {version} already registered; "
                    "omit version to auto-increment")
            entry = ModelEntry(
                name=name, version=int(version), model=model, source=source,
                input_shape=(tuple(input_shape) if input_shape is not None
                             else infer_input_shape(model)),
                input_dtype=input_dtype, registered_at=time.time())
            versions[entry.version] = entry
            return entry

    def register_zoo(self, name: str, zoo_name: Optional[str] = None,
                     version: Optional[int] = None, device=None,
                     **zoo_kwargs) -> ModelEntry:
        """Build a zoo architecture (`zoo.ZOO_REGISTRY`) on `device`
        (``"cuda"`` by default) and register it."""
        from deeplearning4j_tpu_torch.zoo import ZOO_REGISTRY
        zn = zoo_name or name
        if zn not in ZOO_REGISTRY:
            raise KeyError(
                f"unknown zoo model '{zn}'; available: "
                f"{sorted(ZOO_REGISTRY)}")
        z = ZOO_REGISTRY[zn](**zoo_kwargs)
        return self.register(name, z.init_model(device=device), version=version,
                             source="zoo")

    def register_quantized(self, name: str, calibration=None, config=None,
                           base_version: Optional[int] = None,
                           version: Optional[int] = None) -> ModelEntry:
        """Quantized-version roll: quantize a registered version (the
        newest, unless `base_version` is given) with `quant.quantize_model`
        and register the `QuantizedModel` as the next version of the same
        name.  New submits then serve int8 while in-flight requests finish
        on the entry they resolved: the zero-downtime roll, with a dtype
        change instead of a weight change.  Runs under the name's version
        lock."""
        from deeplearning4j_tpu_torch.quant import quantize_model
        with self.name_lock(name):
            base = self.get(name, base_version)
            qm = quantize_model(base.model, calibration=calibration,
                                config=config)
            return self.register(
                name, qm, version=version, source="quant",
                input_shape=base.input_shape, input_dtype=base.input_dtype)

    # ---- resolution ----
    def get(self, name: str, version: Optional[int] = None) -> ModelEntry:
        with self._lock:
            versions = self._models.get(name)
            if not versions:
                raise KeyError(
                    f"no model '{name}' registered; have {sorted(self._models)}")
            if version is None:
                return versions[max(versions)]
            if version not in versions:
                raise KeyError(
                    f"model '{name}' has versions {sorted(versions)}, "
                    f"not {version}")
            return versions[version]

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._models)

    def versions(self, name: str) -> List[int]:
        with self._lock:
            return sorted(self._models.get(name, {}))

    # ---- warmup ----
    def warmup(self, name: str, cache,
               version: Optional[int] = None,
               input_shape: Optional[Tuple[int, ...]] = None) -> List[int]:
        """Drive `cache` (a BucketedCompileCache) through every bucket for
        this model so no request pays a bucket's first run.  Needs the
        trailing input shape — inferred from the model config when
        possible, otherwise pass `input_shape`."""
        import numpy as np
        entry = self.get(name, version)
        shape = tuple(input_shape) if input_shape is not None \
            else entry.input_shape
        if shape is None:
            raise ValueError(
                f"cannot warm '{entry.key}': input shape unknown — pass "
                "input_shape=(trailing, dims)")
        warmed = cache.warmup(entry.key, entry.model, shape,
                              np.dtype(entry.input_dtype))
        entry.warmed_buckets = warmed
        return warmed
