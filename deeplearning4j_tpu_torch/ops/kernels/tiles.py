"""Tile schedules for the port's hand-written kernels.

A :class:`TileConfig` is one frozen record of the block sizes a kernel is
launched with; matmul-family kernels read ``block_m``/``block_n``/
``block_k``, attention kernels ``block_q``/``block_kv``.  Shape classes
bucket concrete operand shapes into pow2 classes, so one tuned tile serves
nearby shapes.  The record and its JSON form are those of the JAX package,
so a tile table reads the same in both.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """Block sizes for one kernel launch; unused fields ride along."""

    block_q: int = 512
    block_kv: int = 1024
    block_m: int = 256
    block_n: int = 256
    block_k: int = 512

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, obj: Dict[str, Any]) -> "TileConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: int(v) for k, v in obj.items() if k in fields})

    def config_key(self) -> str:
        return (
            f"q{self.block_q}-kv{self.block_kv}-"
            f"m{self.block_m}-n{self.block_n}-k{self.block_k}"
        )

    def replace(self, **kw: int) -> "TileConfig":
        return dataclasses.replace(self, **kw)


#: Hopper tile per kernel: the tile each CUDA source is compiled for
#: (``csrc/fused_dense.cu``, ``csrc/q_matmul.cu`` and ``csrc/int8_matmul.cu``:
#: the skinny-M split-K GEMM of ``csrc/skinny_gemm.cuh``, 16 rows x 128
#: columns a block, K stages of 32, 64 and 128 rows;
#: ``csrc/flash_attn_fwd.cu`` at D <= 64: ``block_q`` query rows a block,
#: ``block_kv``-row K/V tiles, which ``flash_attention_plain`` follows;
#: ``csrc/flash_attn_bwd.cu`` at D <= 64: ``block_q`` query rows a dQ
#: block, ``block_kv`` key rows a dK/dV block and a dQ K/V tile; a dK/dV
#: Q/dO tile is 64 rows).
#: Each wrapper checks the built library against it once; a second compiled
#: tile would bring back a run-time tile table.  ``paged_attention``'s
#: ``block_kv`` is the KV page size the decode engine allocates, as in the
#: JAX package: the kernel walks one page at a time, whatever its size.
DEFAULT_TILES: Dict[str, TileConfig] = {
    "fused_dense": TileConfig(block_m=16, block_n=128, block_k=32),
    "q_matmul": TileConfig(block_m=16, block_n=128, block_k=64),
    "int8_matmul": TileConfig(block_m=16, block_n=128, block_k=128),
    "attention": TileConfig(block_q=128, block_kv=64),
    "attention_bwd": TileConfig(block_q=128, block_kv=64),
    "paged_attention": TileConfig(block_q=1, block_kv=16),
}


def _pow2_bucket(n: int) -> int:
    n = max(1, int(n))
    return 1 << (n - 1).bit_length()


def shape_class(**dims: int) -> str:
    """Bucket concrete dims into a pow2 shape-class key, e.g. ``k512-m128-n1024``.

    Keys are sorted so call sites can pass dims in any order.
    """
    items = sorted(dims.items())
    return "-".join(f"{k}{_pow2_bucket(v)}" for k, v in items)
