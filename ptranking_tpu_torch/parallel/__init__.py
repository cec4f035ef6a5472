"""The multi-device layer: the mesh, data, tensor, expert, pipeline and
context parallelism.

The port's counterpart of ptranking_tpu/parallel/, in PyTorch's idiom: one
process a device, a torch.distributed process group and a DeviceMesh over
it (mesh.py, with the sharding rules); each rank runs the eager program on
its block of a batch's rows, with the reductions that span the batch made
explicit (collectives.py), on its shards of the scorer's weights or its
experts, with the `model` axis' collectives made explicit (tensor.py), as
one stage of the listsf encoder's GPipe pipeline (pipeline.py), or on its
block of each list's docs, with the `seq` axis' collectives made explicit:
ring and Ulysses attention and the ring losses (ring.py), the doc-sharded
WassRank (ot.py); `DistributedTrainer` (train.py) is the mesh-parallel
AdhocRanker; launch.py starts the ranks of a run. The JAX package's
`_compat.py`, a jax-version shim for `shard_map`, has no counterpart.

`DistributedTrainer` is imported on first use: the scorers and losses
import collectives.py, and train.py imports them.
"""

from ptranking_tpu_torch.parallel.mesh import (
    MeshConfig,
    batch_sharding,
    cp_plan,
    expert_param_sharding,
    make_hybrid_mesh,
    make_mesh,
    mesh_from_dict,
    model_parallel,
    replicated,
    scorer_param_sharding,
    seq_parallel,
)
from ptranking_tpu_torch.parallel.ot import cp_wass_rank
from ptranking_tpu_torch.parallel.pipeline import PPPlan, gpipe, pipeline_encoder_apply
from ptranking_tpu_torch.parallel.ring import (
    CPPlan,
    SeqParallel,
    reference_attention,
    ring_approx_ndcg,
    ring_attention,
    ring_lambda_loss,
    ring_lambdaloss,
    ring_neural_ndcg,
    ring_soft_rank,
    ulysses_attention,
)
from ptranking_tpu_torch.parallel.tensor import ModelParallel, Split

__all__ = [
    "MeshConfig",
    "make_mesh",
    "make_hybrid_mesh",
    "mesh_from_dict",
    "batch_sharding",
    "replicated",
    "scorer_param_sharding",
    "expert_param_sharding",
    "model_parallel",
    "ModelParallel",
    "Split",
    "PPPlan",
    "gpipe",
    "pipeline_encoder_apply",
    "seq_parallel",
    "cp_plan",
    "CPPlan",
    "SeqParallel",
    "ring_attention",
    "ulysses_attention",
    "reference_attention",
    "ring_lambda_loss",
    "ring_lambdaloss",
    "ring_approx_ndcg",
    "ring_soft_rank",
    "ring_neural_ndcg",
    "cp_wass_rank",
    "DistributedTrainer",
]


def __getattr__(name):
    if name == "DistributedTrainer":
        from ptranking_tpu_torch.parallel.train import DistributedTrainer

        return DistributedTrainer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
