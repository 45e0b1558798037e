"""Data-parallel training and inference over ``torch.distributed`` (the
port of ``parallel/``).

One process a rank (NCCL with one card a rank on the card, gloo on the
CPU): `multihost.initialize` joins the group, `make_mesh` names its axes,
`ParallelWrapper` trains a MultiLayerNetwork or ComputationGraph
data-parallel (the single-device step on the global batch), optionally
with the ZeRO-1 sharded weight update (`zero`), `ParallelInference` serves
it, and `checkpoint` saves and restores it sharded in the JAX package's
format.  `hierarchical` (with `compression`, `transport` and the host
codec in `native_ops`) combines a model's gradient across a gang of
hosts over TCP, dense or threshold-compressed: a host is one process, or
`devices_per_process` ranks (`multihost.LocalLauncher(n, d, gang=True)`)
whose leader (`HostLink`) alone joins the gang.  The mesh's other axes:
`sharding` (tensor parallelism over ``model``, through the wrapper's
``sharding_rules``), `ring_attention` (sequence parallelism over
``seq``), `pipeline` (GPipe stages over ``pipe``) and `composed` (dp x tp
x pp in one step), over the collectives of `collectives`.  Elastic
training: `transport.ElasticGradientMesh` under
``HierarchicalGradientSharing(elastic=True)`` re-forms a gang that loses
a member, `multihost.ElasticLocalRunner` relaunches a job or supervises an
elastic gang, `reshard_zero1` / `reshard_to_devices` move ZeRO-1's state
to a new world, and `make_mesh(devices=)` (``workers(n)``) builds a mesh
over part of the ranks.
"""
from deeplearning4j_tpu_torch.parallel.checkpoint import (  # noqa: F401
    ChecksumError, load_model_sharded, load_sharded, read_metadata,
    save_model_sharded, save_sharded, verify_checkpoint)
from deeplearning4j_tpu_torch.parallel.hierarchical import (  # noqa: F401
    HierarchicalAllReduce, HierarchicalGradientSharing, HostLink)
from deeplearning4j_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, MeshSpec, data_sharding, make_mesh, replicated)
from deeplearning4j_tpu_torch.parallel.multihost import (  # noqa: F401
    ElasticLocalRunner, LocalLauncher, MultiHostParallelInference)
from deeplearning4j_tpu_torch.parallel.transport import (  # noqa: F401
    ElasticGradientMesh, GangEvictedError, GangReformed, PeerUnreachableError)
from deeplearning4j_tpu_torch.parallel.wrapper import (  # noqa: F401
    DynamicBatchingInference, ParallelInference, ParallelWrapper)
from deeplearning4j_tpu_torch.parallel.zero import (  # noqa: F401
    LeafPlan, Zero1Transform, build_plans, disable_zero1, enable_zero1,
    opt_state_bytes_per_replica, reshard_to_devices, reshard_zero1)
from deeplearning4j_tpu_torch.parallel.sharding import (  # noqa: F401
    PartitionSpec, ShardingRules, shard_model_params)
from deeplearning4j_tpu_torch.parallel.pipeline import (  # noqa: F401
    pipeline_apply, sequential_apply, stack_stage_params)
from deeplearning4j_tpu_torch.parallel.ring_attention import (  # noqa: F401
    ring_attention, ring_attention_flash)
from deeplearning4j_tpu_torch.parallel.composed import (  # noqa: F401
    ComposedParallel)
