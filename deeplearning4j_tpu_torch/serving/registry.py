"""Model registry: named, versioned model instances for serving (the port
of ``serving/registry.py``).

The single place a `ModelServer` resolves (name, version) → model:

* `register(name, model)`       — an already-built MultiLayerNetwork (or
                                  anything with `params_`/`state_`/
                                  `_forward` and a `device`)
* `register_zoo(name, "VGG16")` — build from the zoo catalog on `device`

Versions are integers; `get(name)` returns the highest version, so a
re-registration under the same name is a zero-downtime model roll.
Keras, ONNX and quantized registration are not ported yet.
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
    source: str = "direct"              # direct | zoo
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
    """Thread-safe name → {version → ModelEntry} catalog.  (The JAX
    package's per-name version lock serializes rolls against fleet
    evictions; it comes with the fleet.)"""

    def __init__(self):
        self._models: Dict[str, Dict[int, ModelEntry]] = {}
        self._lock = threading.Lock()

    # ---- registration ----
    def register(self, name: str, model, version: Optional[int] = None,
                 source: str = "direct",
                 input_shape: Optional[Tuple[int, ...]] = None,
                 input_dtype: str = "float32") -> ModelEntry:
        with self._lock:
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
