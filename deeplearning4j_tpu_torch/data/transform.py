"""Schema + TransformProcess, DataVec's ETL DSL (the port of
``data/transform.py``, the whole module: plain Python, no device code; the
JSON form, format tag included, is the JAX package's, so a process moves
between the two packages).

Reference: `datavec-api/.../transform/{schema/Schema,TransformProcess}.java`
and the transform zoo (`transform/transform/**`, `filter/**`,
`condition/**`).  A Schema types the columns; a TransformProcess is an
ordered list of column-wise operations executed over records.  Execution is
host-side numpy/python (the Spark executor role collapses to a plain loop —
device time belongs to training, not ETL).
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Callable, Dict, List, Optional, Sequence

from deeplearning4j_tpu_torch.data.records import Record


@dataclasses.dataclass
class ColumnMeta:
    name: str
    kind: str                      # double | integer | categorical | string | time
    categories: Optional[List[str]] = None


class Schema:
    """Column metadata (reference `Schema.Builder`)."""

    def __init__(self, columns: List[ColumnMeta]):
        self.columns = columns

    class Builder:
        def __init__(self):
            self._cols: List[ColumnMeta] = []

        def add_column_double(self, *names):
            for n in names:
                self._cols.append(ColumnMeta(n, "double"))
            return self

        def add_column_integer(self, *names):
            for n in names:
                self._cols.append(ColumnMeta(n, "integer"))
            return self

        def add_column_categorical(self, name, categories):
            self._cols.append(ColumnMeta(name, "categorical",
                                         list(categories)))
            return self

        def add_column_string(self, *names):
            for n in names:
                self._cols.append(ColumnMeta(n, "string"))
            return self

        def add_column_time(self, *names):
            for n in names:
                self._cols.append(ColumnMeta(n, "time"))
            return self

        def build(self) -> "Schema":
            return Schema(list(self._cols))

    @staticmethod
    def builder() -> "Schema.Builder":
        return Schema.Builder()

    def index_of(self, name: str) -> int:
        for i, c in enumerate(self.columns):
            if c.name == name:
                return i
        raise KeyError(f"No column '{name}' in schema "
                       f"{[c.name for c in self.columns]}")

    def names(self) -> List[str]:
        return [c.name for c in self.columns]

    def to_json(self) -> str:
        return json.dumps([dataclasses.asdict(c) for c in self.columns])

    @staticmethod
    def from_json(s: str) -> "Schema":
        return Schema([ColumnMeta(**d) for d in json.loads(s)])


# ---------------------------------------------------------------------------
# Transform steps — each is (schema -> schema, record -> record-or-None)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Step:
    name: str
    schema_fn: Callable[[Schema], Schema]
    record_fn: Callable[[Schema, Record], Optional[Record]]
    spec: Optional[dict] = None        # declarative form for JSON serde


class TransformProcess:
    """Ordered transforms over records (reference `TransformProcess`).

    Build with the fluent Builder, execute with `execute(records)`; records
    failing a filter are dropped (None), matching DataVec semantics."""

    def __init__(self, initial_schema: Schema, steps: List[_Step]):
        self.initial_schema = initial_schema
        self.steps = steps

    def to_json(self) -> str:
        """Serialize (reference `TransformProcess.toJson`).  Steps built
        from arbitrary Python callables (filter_by_condition,
        transform_column) have no declarative form and refuse to
        serialize — same constraint the reference has for non-registered
        custom transforms."""
        specs = []
        for st in self.steps:
            if st.spec is None:
                raise ValueError(
                    f"step '{st.name}' wraps a Python callable and cannot "
                    "be serialized; rebuild it from declarative builder "
                    "ops or reattach it after from_json")
            specs.append(st.spec)
        return json.dumps({
            "format": "deeplearning4j_tpu.TransformProcess.v1",
            "schema": json.loads(self.initial_schema.to_json()),
            "steps": specs}, indent=2)

    SERIALIZABLE_OPS = frozenset({
        "remove_columns", "keep_columns", "rename_column",
        "categorical_to_integer", "categorical_to_one_hot",
        "string_to_double", "math_op_double"})

    @staticmethod
    def from_json(s: str) -> "TransformProcess":
        d = json.loads(s)
        schema = Schema.from_json(json.dumps(d["schema"]))
        b = TransformProcess.Builder(schema)
        for spec in d["steps"]:
            op = spec.get("op")
            if op not in TransformProcess.SERIALIZABLE_OPS:
                raise ValueError(
                    f"Unknown transform op '{op}' in serialized "
                    f"TransformProcess (known: "
                    f"{sorted(TransformProcess.SERIALIZABLE_OPS)})")
            getattr(b, op)(*spec.get("args", []))
        return b.build()

    def final_schema(self) -> Schema:
        s = self.initial_schema
        for st in self.steps:
            s = st.schema_fn(s)
        return s

    def execute_record(self, rec: Record) -> Optional[Record]:
        s = self.initial_schema
        rec = list(rec)
        for st in self.steps:
            rec = st.record_fn(s, rec)
            if rec is None:
                return None
            s = st.schema_fn(s)
        return rec

    def execute(self, records) -> List[Record]:
        out = []
        for r in records:
            t = self.execute_record(r)
            if t is not None:
                out.append(t)
        return out

    class Builder:
        def __init__(self, schema: Schema):
            self._schema = schema
            self._steps: List[_Step] = []

        def _add(self, name, schema_fn, record_fn, spec=None):
            self._steps.append(_Step(name, schema_fn, record_fn, spec))
            return self

        def remove_columns(self, *names):
            names = set(names)

            def sfn(s: Schema):
                return Schema([c for c in s.columns if c.name not in names])

            def rfn(s: Schema, r: Record):
                return [v for c, v in zip(s.columns, r)
                        if c.name not in names]
            return self._add(f"remove{sorted(names)}", sfn, rfn,
                             {"op": "remove_columns",
                              "args": sorted(names)})

        def keep_columns(self, *names):
            keep = list(names)

            def sfn(s: Schema):
                return Schema([s.columns[s.index_of(n)] for n in keep])

            def rfn(s: Schema, r: Record):
                return [r[s.index_of(n)] for n in keep]
            return self._add(f"keep{keep}", sfn, rfn,
                             {"op": "keep_columns", "args": keep})

        def rename_column(self, old: str, new: str):
            def sfn(s: Schema):
                return Schema([dataclasses.replace(c, name=new)
                               if c.name == old else c for c in s.columns])

            def rfn(s, r):
                return r
            return self._add(f"rename {old}->{new}", sfn, rfn,
                             {"op": "rename_column",
                              "args": [old, new]})

        def categorical_to_integer(self, *names):
            """Category string -> index (reference
            `CategoricalToIntegerTransform`)."""
            names_set = set(names)

            def sfn(s: Schema):
                return Schema([
                    dataclasses.replace(c, kind="integer", categories=None)
                    if c.name in names_set else c for c in s.columns])

            def rfn(s: Schema, r: Record):
                out = list(r)
                for i, c in enumerate(s.columns):
                    if c.name in names_set:
                        if c.categories is None:
                            raise ValueError(f"{c.name} is not categorical")
                        out[i] = c.categories.index(str(r[i]))
                return out
            return self._add(f"cat2int{sorted(names_set)}", sfn, rfn,
                             {"op": "categorical_to_integer",
                              "args": sorted(names_set)})

        def categorical_to_one_hot(self, name: str):
            def sfn(s: Schema):
                i = s.index_of(name)
                c = s.columns[i]
                cols = list(s.columns)
                cols[i:i + 1] = [ColumnMeta(f"{name}[{cat}]", "double")
                                 for cat in c.categories]
                return Schema(cols)

            def rfn(s: Schema, r: Record):
                i = s.index_of(name)
                cats = s.columns[i].categories
                onehot = [1.0 if str(r[i]) == cat else 0.0 for cat in cats]
                return list(r[:i]) + onehot + list(r[i + 1:])
            return self._add(f"onehot {name}", sfn, rfn,
                             {"op": "categorical_to_one_hot",
                              "args": [name]})

        def string_to_double(self, *names):
            names_set = set(names)

            def sfn(s: Schema):
                return Schema([dataclasses.replace(c, kind="double")
                               if c.name in names_set else c
                               for c in s.columns])

            def rfn(s: Schema, r: Record):
                return [float(v) if c.name in names_set else v
                        for c, v in zip(s.columns, r)]
            return self._add(f"str2double{sorted(names_set)}", sfn, rfn,
                             {"op": "string_to_double",
                              "args": sorted(names_set)})

        def math_op_double(self, name: str, op: str, scalar: float):
            """Reference `DoubleMathOpTransform`: Add|Subtract|Multiply|
            Divide|Modulus|ScalarMin|ScalarMax on one column."""
            fns = {"Add": lambda v: v + scalar,
                   "Subtract": lambda v: v - scalar,
                   "Multiply": lambda v: v * scalar,
                   "Divide": lambda v: v / scalar,
                   "Modulus": lambda v: math.fmod(v, scalar),
                   "ScalarMin": lambda v: min(v, scalar),
                   "ScalarMax": lambda v: max(v, scalar)}
            f = fns[op]

            def rfn(s: Schema, r: Record):
                i = s.index_of(name)
                out = list(r)
                out[i] = f(float(r[i]))
                return out
            return self._add(f"{op}({name},{scalar})", lambda s: s, rfn,
                             {"op": "math_op_double",
                              "args": [name, op, scalar]})

        def filter_by_condition(self, pred: Callable[[Schema, Record], bool],
                                name: str = "filter"):
            """Keep records where pred is True (reference `Filter` /
            `ConditionFilter` — note DataVec's filter REMOVES matching
            records; here the predicate states what to KEEP, the less
            error-prone convention; invert at the call site for parity)."""
            def rfn(s: Schema, r: Record):
                return r if pred(s, r) else None
            return self._add(name, lambda s: s, rfn)

        def transform_column(self, name: str,
                             fn: Callable[[Any], Any],
                             label: str = "custom"):
            def rfn(s: Schema, r: Record):
                i = s.index_of(name)
                out = list(r)
                out[i] = fn(r[i])
                return out
            return self._add(f"{label}({name})", lambda s: s, rfn)

        def build(self) -> "TransformProcess":
            return TransformProcess(self._schema, list(self._steps))

    @staticmethod
    def builder(schema: Schema) -> "TransformProcess.Builder":
        return TransformProcess.Builder(schema)
