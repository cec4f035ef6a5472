"""The device mesh, built on a torch.distributed process group.

The port's counterpart of ptranking_tpu/parallel/mesh.py. Axes:
  data  — data parallel over query groups (the rows of every batch)
  model — tensor parallel over scorer weights (ROADMAP queue A item 8b)
  seq   — context parallel over the document axis (item 8c)
and, for the hybrid mesh, a leading `dcn` axis over hosts; `dcn x data` is
one data-parallel group, as the JAX package shards a batch over both.

One process drives one device. A mesh is a `DeviceMesh` over the process
group, whose size must equal the world size; the group is made first (by
torchrun, `data/prefetch.py::initialize_distributed` or
`parallel/launch.py`). Where XLA inserts collectives from shardings, the
port makes them explicit (parallel/collectives.py): `replicated` broadcasts
tensors from the mesh's first rank, and `batch_sharding` gives a rank's
block of a batch's rows. The TP and EP rules wait for item 8b.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ptranking_tpu_torch.parallel.collectives import DataParallel
from ptranking_tpu_torch.parallel.collectives import SINGLE as _SINGLE

AXES = ("data", "model", "seq")
HYBRID_AXES = ("dcn",) + AXES


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = 1
    model: int = 1
    seq: int = 1

    @property
    def num_devices(self) -> int:
        return self.data * self.model * self.seq


def _world_size() -> int:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a mesh needs a torch.distributed process group: run under torchrun, call "
            "ptranking_tpu_torch.data.prefetch.initialize_distributed, or let "
            "`python -m ptranking_tpu_torch.ltr -mesh data=W` start the ranks")
    return dist.get_world_size()


def _device_type(device_type: Optional[str]) -> str:
    """The mesh's device type: cuda over NCCL, else cpu (gloo carries CPU
    tensors and, in collectives, CUDA tensors too)."""
    if device_type:
        return device_type
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(cfg: Optional[MeshConfig] = None, device_type: Optional[str] = None) -> DeviceMesh:
    """A (data, model, seq) mesh over the process group's ranks. With no
    config every rank goes to the data axis (pure DP, the default for LTR's
    small dense towers)."""
    world = _world_size()
    if cfg is None:
        cfg = MeshConfig(data=world)
    if cfg.num_devices != world:
        raise ValueError(f"mesh {cfg} needs {cfg.num_devices} ranks; the process group "
                         f"has {world}")
    return init_device_mesh(_device_type(device_type), (cfg.data, cfg.model, cfg.seq),
                            mesh_dim_names=AXES)


def make_hybrid_mesh(ici_cfg: Optional[MeshConfig] = None, dcn: Optional[int] = None,
                     device_type: Optional[str] = None) -> DeviceMesh:
    """A mesh whose leading `dcn` axis spans hosts (data parallelism over the
    data-center network) while (data, model, seq) stay within a host. Under
    torchrun the hosts are world size / LOCAL_WORLD_SIZE; a single host gets
    a dcn axis of size 1, or `dcn=k` splits its ranks over k emulated
    hosts."""
    world = _world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    hosts = world // local
    if hosts > 1:
        if dcn is not None and dcn != hosts:
            raise ValueError(f"dcn={dcn}, but the group spans {hosts} hosts")
        dcn = hosts
        if ici_cfg is None:
            ici_cfg = MeshConfig(data=local)
        if ici_cfg.num_devices != local:
            raise ValueError(f"{ici_cfg} does not cover a host's {local} ranks")
    else:
        dcn = dcn or 1
        if ici_cfg is None:
            ici_cfg = MeshConfig(data=world // dcn)
    if dcn * ici_cfg.num_devices != world:
        raise ValueError(f"dcn={dcn} x {ici_cfg} needs {dcn * ici_cfg.num_devices} ranks; "
                         f"the process group has {world}")
    return init_device_mesh(_device_type(device_type),
                            (dcn, ici_cfg.data, ici_cfg.model, ici_cfg.seq),
                            mesh_dim_names=HYBRID_AXES)


# Config-level construction (the `mesh` eval setting and the -mesh flag):
# every evaluator and trainer asking for the same axis sizes in one process
# group shares one mesh.
_MESH_CACHE: dict = {}


def check_mesh_dict(mesh_dict: dict) -> None:
    """The axes this slice runs: unknown axes fail; `model` or `seq` > 1
    belong to ROADMAP queue A items 8b and 8c."""
    unknown = set(mesh_dict) - set(HYBRID_AXES)
    if unknown:
        raise ValueError(f"unknown mesh axes {unknown}")
    if int(mesh_dict.get("model", 1)) > 1:
        raise NotImplementedError("a mesh axis `model` > 1 is tensor parallelism, not ported "
                                  "yet (ROADMAP queue A item 8b)")
    if int(mesh_dict.get("seq", 1)) > 1:
        raise NotImplementedError("a mesh axis `seq` > 1 is context parallelism, not ported "
                                  "yet (ROADMAP queue A item 8c)")


def mesh_ranks(mesh_dict: dict) -> int:
    """The number of ranks a mesh dict asks for."""
    n = 1
    for ax in HYBRID_AXES:
        n *= int(mesh_dict.get(ax, 1))
    return n


def mesh_from_dict(mesh_dict: dict, device_type: Optional[str] = None) -> DeviceMesh:
    """{"data": 4, "model": 1, "seq": 1, "dcn": k} -> DeviceMesh; a `dcn`
    axis selects the hybrid mesh (make_hybrid_mesh). The axes are checked
    (check_mesh_dict) before the mesh is built."""
    key = (tuple(sorted(mesh_dict.items())), device_type, dist.group.WORLD)
    if key not in _MESH_CACHE:
        check_mesh_dict(mesh_dict)
        cfg = MeshConfig(data=int(mesh_dict.get("data", 1)), model=int(mesh_dict.get("model", 1)),
                         seq=int(mesh_dict.get("seq", 1)))
        _MESH_CACHE[key] = (make_hybrid_mesh(cfg, dcn=int(mesh_dict["dcn"]),
                                             device_type=device_type)
                            if mesh_dict.get("dcn") else make_mesh(cfg, device_type))
    return _MESH_CACHE[key]


def data_parallel(mesh):
    """The DataParallel share of a mesh's batch axes (SINGLE for no mesh); a
    mesh dict is built with mesh_from_dict. Its `model` and `seq` axes must
    be 1 (items 8b and 8c)."""
    if mesh is None:
        return _SINGLE
    if isinstance(mesh, dict):
        mesh = mesh_from_dict(mesh)  # its axes are checked there
    else:
        check_mesh_dict({ax: mesh.size(i) for i, ax in enumerate(mesh.mesh_dim_names)})
    names = mesh.mesh_dim_names
    # model = seq = 1: the batch axes span the whole mesh
    return DataParallel(mesh.get_group("data") if "dcn" not in names else None)


def replicated(mesh: DeviceMesh, leaves):
    """The mesh's first rank's values broadcast into every rank's tensors
    (in place); returns `leaves`."""
    data_parallel(mesh).broadcast(list(leaves))
    return leaves


def batch_sharding(mesh: DeviceMesh, shard_docs: bool = False):
    """This rank's share of a batch over the mesh's batch axes (dcn x data):
    its DataParallel, whose `block(rows)` is the rank's contiguous block of
    the rows padded to a multiple of the degree with all-masked rows (the
    JAX trainer's `_mesh_pad`)."""
    if shard_docs:
        raise NotImplementedError("shard_docs shards the doc axis over `seq`, context "
                                  "parallelism, not ported yet (ROADMAP queue A item 8c)")
    return data_parallel(mesh)
