"""Multi-process TransformProcess execution (the port of
``data/local_execution.py``).

Reference: `datavec-local/.../LocalTransformExecutor` (single-node
parallel ETL) standing in for `datavec-spark/.../SparkTransformExecutor`
(cluster ETL).  Spark-cluster wire compatibility is a non-goal; what
matters is the role: run a declarative TransformProcess over a record set
partitioned across worker OS processes, preserving record order and drop
semantics.

Workers are spawned by FILE PATH (not ``-m``) and load transform.py /
records.py standalone via importlib, so a worker imports only numpy and
the standard library — never the package ``__init__`` chain, which would pull
in torch (seconds of startup per worker).  The parent pickles each
partition + the TransformProcess JSON to disk and re-concatenates worker
outputs in partition order.  Each worker has `timeout` seconds; one that
runs longer is killed and the call raises.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import tempfile
from typing import List, Optional, Sequence


class LocalTransformExecutor:
    """`execute(records, tp)` == `tp.execute(records)` but partitioned
    over `num_workers` OS processes (reference LocalTransformExecutor's
    parallel mode; num_workers=0 runs inline)."""

    def __init__(self, num_workers: int = 2, timeout: float = 300.0):
        self.num_workers = num_workers
        self.timeout = timeout

    def execute(self, records: Sequence, transform_process) -> List:
        if self.num_workers <= 0 or len(records) < 2:
            return transform_process.execute(records)
        tp_json = transform_process.to_json()   # declarative ops only —
        # callable steps can't cross a process boundary (same constraint
        # as the reference's Spark executor on non-serializable transforms)
        n = min(self.num_workers, len(records))
        per = -(-len(records) // n)
        parts = [records[i * per:(i + 1) * per] for i in range(n)]
        parts = [p for p in parts if p]

        with tempfile.TemporaryDirectory(prefix="dl4j-etl-") as d:
            tp_path = os.path.join(d, "tp.json")
            with open(tp_path, "w") as f:
                f.write(tp_json)
            procs = []
            outs = []
            for i, part in enumerate(parts):
                inp = os.path.join(d, f"in-{i}.pkl")
                out = os.path.join(d, f"out-{i}.pkl")
                with open(inp, "wb") as f:
                    pickle.dump(part, f)
                outs.append(out)
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     inp, out, tp_path],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            result: List = []
            failure: Optional[str] = None
            for i, p in enumerate(procs):
                try:
                    log, _ = p.communicate(timeout=self.timeout)
                except subprocess.TimeoutExpired:
                    p.kill()
                    log, _ = p.communicate()
                    failure = failure or f"worker {i} timed out:\n{log}"
                    continue
                if p.returncode != 0:
                    failure = failure or (
                        f"worker {i} failed (rc={p.returncode}):\n{log}")
            if failure:
                raise RuntimeError(f"LocalTransformExecutor: {failure}")
            for out in outs:
                with open(out, "rb") as f:
                    result.extend(pickle.load(f))
            return result


def _load_transform_module():
    """Load data/transform.py (and its records.py dependency) WITHOUT
    importing the deeplearning4j_tpu_torch package __init__ chain: stub the
    parent packages, then exec the two files under their canonical module
    names so transform.py's package-qualified import resolves."""
    import importlib.util
    import types
    base = os.path.dirname(os.path.abspath(__file__))
    for name in ("deeplearning4j_tpu_torch", "deeplearning4j_tpu_torch.data"):
        if name not in sys.modules:
            stub = types.ModuleType(name)
            stub.__path__ = []
            sys.modules[name] = stub
    for mod_name, fname in (
            ("deeplearning4j_tpu_torch.data.records", "records.py"),
            ("deeplearning4j_tpu_torch.data.transform", "transform.py")):
        if mod_name in sys.modules and hasattr(sys.modules[mod_name],
                                               "__file__"):
            continue
        spec = importlib.util.spec_from_file_location(
            mod_name, os.path.join(base, fname))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        spec.loader.exec_module(mod)
    return sys.modules["deeplearning4j_tpu_torch.data.transform"]


def _worker_main(argv: Sequence[str]) -> int:
    inp, out, tp_path = argv
    transform = _load_transform_module()
    with open(tp_path) as f:
        tp = transform.TransformProcess.from_json(f.read())
    with open(inp, "rb") as f:
        records = pickle.load(f)
    with open(out, "wb") as f:
        pickle.dump(tp.execute(records), f)
    return 0


if __name__ == "__main__":
    raise SystemExit(_worker_main(sys.argv[1:]))
