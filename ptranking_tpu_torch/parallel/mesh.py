"""The device mesh, built on a torch.distributed process group, and its
sharding rules.

The port's counterpart of ptranking_tpu/parallel/mesh.py. Axes:
  data  — data parallel over query groups (the rows of every batch)
  model — tensor parallel over scorer weights, pipeline stages, experts
  seq   — context parallel over the document axis
and, for the hybrid mesh, a leading `dcn` axis over hosts; `dcn x data` is
one data-parallel group, as the JAX package shards a batch over both.

One process drives one device. A mesh is a `DeviceMesh` over the process
group, whose size must equal the world size; the group is made first (by
torchrun, `data/prefetch.py::initialize_distributed` or
`parallel/launch.py`). Where XLA inserts collectives from shardings, the
port makes them explicit: `data_parallel` / `batch_sharding` give a rank's
share of the batch axes (parallel/collectives.py; the ranks that share a
`data` coordinate see the same rows) and, with shard_docs, of the `seq`
axis (its block of each list's docs; parallel/ring.py::SeqParallel, with
`cp_plan`); `replicated` broadcasts tensors from the mesh's first rank,
and `scorer_param_sharding` / `expert_param_sharding` say which dim of
each param leaf is split over `model`, for parallel/tensor.py::ModelParallel
to cut and to run. Three groups of a rank: its `data` line (dcn x data on
the hybrid mesh: counts, loss totals, metric sums), its `seq` line, and its
gradient group, the ranks that share its `model` coordinate (dcn x data x
seq: the gradients' and, under shard_docs, the batch statistics' sums).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ptranking_tpu_torch.parallel.collectives import DataParallel
from ptranking_tpu_torch.parallel.collectives import SINGLE as _SINGLE
from ptranking_tpu_torch.parallel.ring import CPPlan, SeqParallel
from ptranking_tpu_torch.parallel.tensor import ModelParallel, Split

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
    """The axes the port runs: unknown axes fail."""
    unknown = set(mesh_dict) - set(HYBRID_AXES)
    if unknown:
        raise ValueError(f"unknown mesh axes {unknown}")


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


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The size of a mesh's axis; 1 if it has no such axis."""
    names = mesh.mesh_dim_names
    return mesh.size(names.index(axis)) if axis in names else 1


def axis_group(mesh: DeviceMesh, axis: str):
    """The process group of this rank's line along `axis`: the ranks that
    differ from it in that coordinate alone."""
    return mesh.get_group(axis)


# flattened groups of several axes (dcn x data, dcn x data x seq), by the
# axes and the mesh's rank layout: every rank makes them once, in the same
# order
_LINE_GROUPS: dict = {}


def _line_group(mesh: DeviceMesh, axes):
    """The group of this rank's line over `axes`: the ranks that differ from
    it in those coordinates alone."""
    names = mesh.mesh_dim_names
    axes = [ax for ax in axes if ax in names]
    if all(axis_size(mesh, ax) == 1 for ax in names if ax not in axes):
        return dist.group.WORLD  # the line spans the mesh
    wide = [ax for ax in axes if axis_size(mesh, ax) > 1]
    if len(wide) <= 1:
        return mesh.get_group((wide or axes)[0])
    ranks = mesh.mesh
    dims = [names.index(ax) for ax in wide]
    rest = [i for i in range(len(names)) if i not in dims]
    key = (dist.group.WORLD, tuple(wide), tuple(ranks.shape), tuple(ranks.flatten().tolist()))
    if key not in _LINE_GROUPS:
        lines = ranks.permute(*rest, *dims).reshape(-1, math.prod(ranks.shape[d] for d in dims))
        mine = None
        for line in lines.tolist():
            g = dist.new_group(line)
            if dist.get_rank() in line:
                mine = g
        _LINE_GROUPS[key] = mine
    return _LINE_GROUPS[key]


def _batch_group(mesh: DeviceMesh):
    """The data-parallel group of this rank: `data` (with `dcn`, the
    flattened dcn x data line)."""
    if "dcn" not in mesh.mesh_dim_names:
        return mesh.get_group("data")
    return _line_group(mesh, ("dcn", "data"))


def gradient_group(mesh: DeviceMesh):
    """The gradient group of this rank: the ranks that share its `model`
    coordinate (the flattened dcn x data x seq line). Under shard_docs each
    rank's backward reaches the params through its own rows and docs, and
    the gradients sum over this group."""
    return _line_group(mesh, ("dcn", "data", "seq"))


def _checked(mesh):
    if isinstance(mesh, dict):
        return mesh_from_dict(mesh)  # its axes are checked there
    check_mesh_dict({ax: mesh.size(i) for i, ax in enumerate(mesh.mesh_dim_names)})
    return mesh


def data_parallel(mesh, shard_docs: bool = False):
    """The DataParallel share of a mesh's batch axes (SINGLE for no mesh); a
    mesh dict is built with mesh_from_dict. Its group is the rank's `data`
    line (dcn x data on the hybrid mesh): the ranks along `model` share a
    block of rows, and so do the ranks along `seq`, unless shard_docs gives
    each its block of the docs (with the gradient group and the `seq`
    share); files and the initial state span the whole mesh."""
    if mesh is None:
        return _SINGLE
    mesh = _checked(mesh)
    if not shard_docs:
        return DataParallel(_batch_group(mesh))
    return DataParallel(_batch_group(mesh), gradient_group(mesh), seq_parallel(mesh))


def seq_parallel(mesh) -> SeqParallel:
    """This rank's SeqParallel share of the mesh's `seq` axis."""
    if axis_size(mesh, "seq") == 1:
        return SeqParallel(None)
    return SeqParallel(axis_group(mesh, "seq"))


def cp_plan(mesh, impl: str = "ring") -> CPPlan:
    """The CPPlan of a mesh: its `seq` share, the attention exchange, and the
    batch axes' share for the loss sums that span the batch."""
    mesh = _checked(mesh)
    return CPPlan(seq_parallel(mesh), impl, SeqParallel(_batch_group(mesh)))


def model_parallel(mesh, spec=None) -> ModelParallel:
    """This rank's ModelParallel share of the mesh's `model` axis, with the
    params' spec (scorer_param_sharding or expert_param_sharding)."""
    if axis_size(mesh, "model") == 1:
        return ModelParallel(None, spec)
    return ModelParallel(axis_group(mesh, "model"), spec)


def replicated(mesh: DeviceMesh, leaves):
    """The mesh's first rank's values broadcast into every rank's tensors
    (in place); returns `leaves`."""
    data_parallel(mesh).broadcast(list(leaves))
    return leaves


def batch_sharding(mesh: DeviceMesh, shard_docs: bool = False):
    """This rank's share of a batch over the mesh's batch axes (dcn x data):
    its DataParallel, whose `block(rows)` is the rank's contiguous block of
    the rows padded to a multiple of the degree with all-masked rows (the
    JAX trainer's `_mesh_pad`); with shard_docs also its `seq` share, whose
    `block(a, 1)` is the rank's block of the docs, padded to a multiple of
    the `seq` degree with all-masked docs."""
    return data_parallel(mesh, shard_docs)


# --------------------------------------------------------------------- TP


def _whole(tree):
    if isinstance(tree, dict):
        return {k: _whole(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_whole(v) for v in tree]
    return None


def _ffn_layer_split(i: int) -> Split:
    """Alternate the hidden-dim split across a stack's sharded layers: the
    even ones split their output features (column parallel), the odd ones
    their input features (row parallel), so each column-then-row pair sums
    over `model` once."""
    return Split(1) if i % 2 == 0 else Split(0)


def scorer_param_sharding(mesh, params, n_heads: Optional[int] = None):
    """The split of every scorer param leaf over the `model` axis: a Split
    (parallel/tensor.py) or None for a whole leaf, in a tree of the params'
    shape. The JAX package's rules (its PartitionSpecs):

      * FFN stacks (point_sf, head_ffnns, tail_ffnns): sharded layers
        alternate column / row, counting sharded layers only; the last
        layer stays whole, and so does a layer with min(w.shape) < model or
        a single output; a column layer's bias splits with its output, a
        row layer's stays whole; batch norm params stay whole;
      * the encoder: the MHSA's fused qkv is column parallel and its fc row
        parallel; AllRank's position-wise fc.w1 column and fc.w2 row; layer
        norms whole;
      * anything else whole.

    The port's own layout, with the same values: qkv is split by head
    (Split(qkv=True): a rank holds q, k and v of heads [r H/M, (r+1) H/M)),
    where JAX's P(None, "model") cuts the fused 3F columns into contiguous
    blocks and XLA reshards; where n_heads % model != 0 (or n_heads is not
    given) the MHSA stays whole on every model rank and only the FFNs
    shard; a layer whose split dim does not divide by `model` stays whole.
    At model = 1 every leaf is whole."""
    M = axis_size(mesh, "model")
    if M == 1:
        return _whole(params)

    def spec_ffn(ffn):
        layers = ffn["layers"]
        out, sharded_i = [], 0
        for i, layer in enumerate(layers):
            w = layer["linear"]["w"]
            split = _ffn_layer_split(sharded_i)
            if (i == len(layers) - 1 or min(w.shape) < M or w.shape[1] == 1
                    or w.shape[split.dim] % M):
                lin = {"w": None, "b": None}
            else:
                lin = {"w": split, "b": Split(0) if split.dim == 1 else None}
                sharded_i += 1
            spec = {"linear": lin}
            if "bn" in layer:
                spec["bn"] = _whole(layer["bn"])
            out.append(spec)
        return {"layers": out}

    def spec_encoder(enc):
        heads = n_heads is not None and n_heads % M == 0
        out = []
        for layer in enc["layers"]:
            spec = _whole(layer)
            if heads:
                spec["mhsa"] = {"qkv": {"w": Split(1, qkv=True), "b": Split(0, qkv=True)},
                                "fc": {"w": Split(0), "b": None}}
            if "fc" in layer and layer["fc"]["w1"]["w"].shape[1] % M == 0:
                spec["fc"] = {"w1": {"w": Split(1), "b": Split(0)},
                              "w2": {"w": Split(0), "b": None}}
            out.append(spec)
        enc_spec = _whole(enc)
        enc_spec["layers"] = out
        return enc_spec

    spec = {}
    for name, sub in params.items():
        if name == "encoder":
            spec[name] = spec_encoder(sub)
        elif isinstance(sub, dict) and "layers" in sub:
            spec[name] = spec_ffn(sub)
        else:
            spec[name] = _whole(sub)
    return spec


def expert_param_sharding(mesh, cluster_params):
    """EP: the cluster of K MDN scorers (diversification/scorers.py
    init_div_scorer's cluster branch: a leading K axis on every leaf) split
    over `model`, each model rank holding K / model experts."""
    M = axis_size(mesh, "model")

    def leaf(t):
        if t.shape[0] % M:
            raise ValueError(f"a cluster of {t.shape[0]} experts does not split over "
                             f"model={M}")
        return Split(0) if M > 1 else None

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v) for v in tree]
        return leaf(tree)

    return walk(cluster_params)
