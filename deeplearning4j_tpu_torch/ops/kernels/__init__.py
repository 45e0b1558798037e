"""Hand-written Hopper kernel tier of the port.

Every kernel here ships two implementations, a CUDA kernel built from
``csrc/`` for ``sm_90a`` and a plain PyTorch version that is its spec,
selected by ``dispatch``.  Importing this package registers the kernel set
(and builds nothing: a kernel's library is built at its first launch).
"""
from deeplearning4j_tpu_torch.ops.kernels import (  # noqa: F401
    attention, conv3x3, dispatch, layer_norm, matmul, tiles)
from deeplearning4j_tpu_torch.ops.kernels.tiles import (  # noqa: F401
    DEFAULT_TILES,
    TileConfig,
    shape_class,
)

dispatch.register("fused_dense", supports=matmul.dense_supports)
dispatch.register("conv3x3_wgrad", supports=conv3x3.wgrad_supports)
dispatch.register("conv3x3_dgrad", supports=conv3x3.dgrad_supports)
dispatch.register("layer_norm", supports=layer_norm.supports)
dispatch.register("attention", supports=attention.attention_supports)
