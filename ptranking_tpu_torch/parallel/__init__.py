"""The multi-device layer: the mesh and data parallelism.

The port's counterpart of ptranking_tpu/parallel/, in PyTorch's idiom: one
process a device, a torch.distributed process group and a DeviceMesh over
it (mesh.py); each rank runs the eager program on its block of a batch's
rows, with the reductions that span the batch made explicit
(collectives.py); `DistributedTrainer` (train.py) is the data-parallel
AdhocRanker; launch.py starts the ranks of a run. Tensor and pipeline
parallelism (ROADMAP queue A item 8b) and context parallelism (item 8c)
are still to come. The JAX package's `_compat.py`, a jax-version shim for
`shard_map`, has no counterpart.

`DistributedTrainer` is imported on first use: the scorers and losses
import collectives.py, and train.py imports them.
"""

from ptranking_tpu_torch.parallel.mesh import (
    MeshConfig,
    batch_sharding,
    make_hybrid_mesh,
    make_mesh,
    mesh_from_dict,
    replicated,
)

__all__ = [
    "MeshConfig",
    "make_mesh",
    "make_hybrid_mesh",
    "mesh_from_dict",
    "batch_sharding",
    "replicated",
    "DistributedTrainer",
]


def __getattr__(name):
    if name == "DistributedTrainer":
        from ptranking_tpu_torch.parallel.train import DistributedTrainer

        return DistributedTrainer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
