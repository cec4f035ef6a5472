"""The multi-device layer: the mesh, data, tensor, expert and pipeline
parallelism.

The port's counterpart of ptranking_tpu/parallel/, in PyTorch's idiom: one
process a device, a torch.distributed process group and a DeviceMesh over
it (mesh.py, with the sharding rules); each rank runs the eager program on
its block of a batch's rows, with the reductions that span the batch made
explicit (collectives.py), on its shards of the scorer's weights or its
experts, with the `model` axis' collectives made explicit (tensor.py), or
as one stage of the listsf encoder's GPipe pipeline (pipeline.py);
`DistributedTrainer` (train.py) is the mesh-parallel AdhocRanker; launch.py
starts the ranks of a run. Context parallelism (ROADMAP queue A item 8c)
is still to come. The JAX package's `_compat.py`, a jax-version shim for
`shard_map`, has no counterpart.

`DistributedTrainer` is imported on first use: the scorers and losses
import collectives.py, and train.py imports them.
"""

from ptranking_tpu_torch.parallel.mesh import (
    MeshConfig,
    batch_sharding,
    expert_param_sharding,
    make_hybrid_mesh,
    make_mesh,
    mesh_from_dict,
    model_parallel,
    replicated,
    scorer_param_sharding,
)
from ptranking_tpu_torch.parallel.pipeline import PPPlan, gpipe, pipeline_encoder_apply
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
    "DistributedTrainer",
]


def __getattr__(name):
    if name == "DistributedTrainer":
        from ptranking_tpu_torch.parallel.train import DistributedTrainer

        return DistributedTrainer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
