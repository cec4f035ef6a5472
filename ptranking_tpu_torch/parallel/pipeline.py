"""Pipeline parallelism (PP): GPipe-style microbatch pipelining over the
listwise encoder's layer stack, at inference.

The port's counterpart of ptranking_tpu/parallel/pipeline.py. The stack of L
encoder layers is cut into P stages, one a rank of the mesh's `model` axis
(stage s holds layers [s L/P, (s+1) L/P)); the batch is cut into
microbatches, which flow through the classic GPipe schedule: at tick t,
stage s runs microbatch t - s. Where the JAX package rotates activations
with `ppermute`, the port hands each stage's output to the other model
ranks with `torch.distributed.broadcast` over the `model` group, a
collective every rank calls in the same order (stage 0's output of the
tick, then stage 1's, ...): stage s + 1 takes stage s's, and the last
stage's outputs reach every model rank, as the JAX package's
`out[num_stages - 1]` does. Bubble ticks compute nothing. Under gloo a
CUDA tensor's broadcast goes through host memory inside gloo itself; NCCL
keeps it on the cards.

As in the JAX package this is the mechanism with its correctness tests,
not a tuned schedule: the encoder stack is shallow. Training stays data
parallel (DistributedTrainer(pp_stages=k) holds whole params on every
model rank).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.distributed as dist

from ptranking_tpu_torch.parallel.mesh import axis_group


@dataclasses.dataclass(frozen=True)
class PPPlan:
    """Routing plan handed to apply_scorer(pp=...): stage the listsf encoder
    as a GPipe pipeline over `axis_name` of `mesh` (a DeviceMesh), in
    `num_microbatches` microbatches. Inference only."""

    mesh: object
    num_microbatches: int = 4
    axis_name: str = "model"


def gpipe(stage_fn: Callable, stage_params, xs: torch.Tensor, mesh, axis_name: str = "model"):
    """Run `stage_fn` as a P-stage pipeline over `axis_name` (P = its size;
    this rank is stage `rank in the axis`).

    stage_fn(local_params, x, m) -> y with y.shape == x.shape and x's dtype:
    the stage's layers on microbatch m (m lets a stage read the microbatch's
    side inputs, such as the mask, which every stage holds).
    stage_params: tree whose leaves have leading axis P; stage s runs on
    their slice s.
    xs: [M, ...] microbatches, the same on every rank of the axis. Returns
    the [M, ...] outputs of the last stage, on every rank of the axis.
    A stage runs each microbatch once: M launches of its layers' kernels a
    call, no bubble tick computed."""
    from ptranking_tpu_torch.models.scorers import map_params

    group = axis_group(mesh, axis_name)
    num_stages = dist.get_world_size(group)
    stage = dist.get_rank(group)
    local = map_params(lambda a: a[stage], stage_params)
    M = xs.shape[0]
    if num_stages == 1:
        return torch.stack([stage_fn(local, xs[m], m) for m in range(M)])
    srcs = [dist.get_global_rank(group, j) for j in range(num_stages)]
    inbox = {}  # microbatch -> the previous stage's output
    outs = [None] * M
    for t in range(M + num_stages - 1):
        m = t - stage
        out = None
        if 0 <= m < M:
            out = stage_fn(local, xs[m] if stage == 0 else inbox.pop(m), m).contiguous()
        for j in range(num_stages):
            mj = t - j
            if not 0 <= mj < M:
                continue  # stage j idles in this tick (fill or drain)
            buf = out if j == stage else torch.empty_like(xs[mj])
            dist.broadcast(buf, src=srcs[j], group=group)
            if j == stage - 1:
                inbox[mj] = buf
            if j == num_stages - 1:
                outs[mj] = buf
    return torch.stack(outs)


def gpipe_reference(stage_fn: Callable, stage_params, xs: torch.Tensor) -> torch.Tensor:
    """Sequential oracle: every microbatch through all stages in order."""
    from ptranking_tpu_torch.models.scorers import map_params, tree_leaves

    num_stages = tree_leaves(stage_params)[0].shape[0]
    outs = []
    for m in range(xs.shape[0]):
        x = xs[m]
        for s in range(num_stages):
            x = stage_fn(map_params(lambda a: a[s], stage_params), x, m)
        outs.append(x)
    return torch.stack(outs)


def stack_encoder_layers(encoder_params):
    """[{layer}, {layer}, ...] -> one tree with leading axis L (the layers
    are alike, as for DASALC, AttnDIN and AllRank; AllRank's final_ln lives
    outside the stack and is applied by the caller)."""
    def zip_trees(trees):
        first = trees[0]
        if isinstance(first, dict):
            return {k: zip_trees([t[k] for t in trees]) for k in first}
        if isinstance(first, (list, tuple)):
            return [zip_trees([t[i] for t in trees]) for i in range(len(first))]
        return torch.stack(trees)

    return zip_trees(encoder_params["layers"])


def microbatches(B: int, requested: int) -> int:
    """The microbatch count: the largest divisor of B at most `requested`
    (eval batches of B = 6, 3 or 1 lists arise; fewer microbatches only
    mean less pipelining)."""
    n = max(min(requested, B), 1)
    while B % n:
        n -= 1
    return n


def pipeline_encoder_apply(encoder_params, x: torch.Tensor, mask: torch.Tensor, n_heads: int,
                           encoder_type: str, mesh, num_microbatches: int = 4,
                           axis_name: str = "model", attn_block_size: Optional[int] = None,
                           flash: bool = False) -> torch.Tensor:
    """The listsf encoder (models/scorers/listsf.py encoder_apply, inference)
    as a GPipe pipeline: the layer stack cut into P = the axis' size stages,
    the batch into `microbatches(B, num_microbatches)` microbatches (one
    where P = 1: a single stage has nothing to overlap). The mask goes to
    every stage directly. With flash=True every layer's attention is the
    flash kernel: a predict launches its forward (L/P) x microbatches times
    on each stage, and no bubble tick runs. AllRank's final LN is applied
    once, after the pipeline."""
    from ptranking_tpu_torch.models.scorers import listsf as _listsf
    from ptranking_tpu_torch.models.scorers import map_params, tree_leaves
    from ptranking_tpu_torch.models.scorers.nn import layer_norm_apply

    stacked = stack_encoder_layers(encoder_params)
    L = tree_leaves(stacked)[0].shape[0]
    num_stages = dist.get_world_size(axis_group(mesh, axis_name))
    if L % num_stages:
        raise ValueError(f"{L} encoder layers do not divide into {num_stages} stages")
    per_stage = L // num_stages
    staged = map_params(lambda a: a.reshape(num_stages, per_stage, *a.shape[1:]), stacked)
    B = x.shape[0]
    n_mb = 1 if num_stages == 1 else microbatches(B, num_microbatches)
    xs = x.reshape(n_mb, B // n_mb, *x.shape[1:])
    masks = mask.reshape(n_mb, B // n_mb, *mask.shape[1:])

    def stage_fn(local, xb, m):
        layers = [map_params(lambda a: a[i], local) for i in range(per_stage)]
        return _listsf.encoder_apply({"layers": layers}, xb, masks[m], n_heads, encoder_type,
                                     attn_block_size, flash, drop_rate=0.0, training=False)

    out = gpipe(stage_fn, staged, xs, mesh, axis_name).reshape(x.shape)
    if encoder_type == "AllRank":
        out = layer_norm_apply(encoder_params["final_ln"], out)
    return out
