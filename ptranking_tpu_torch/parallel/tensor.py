"""Tensor and expert parallelism's explicit collectives over the `model` axis.

The JAX package shards scorer weights over the mesh's `model` axis
(parallel/mesh.py::scorer_param_sharding) and XLA inserts the collectives
that keep the values those of one device. Here each rank holds its shards
(a `Split` names the dim a leaf is cut along) and runs the eager program on
them, with those collectives written out as autograd functions over the
`model` group:

  * `copy(x)`:   identity forward, all-reduce backward: the input of a
    column-parallel layer (each rank's columns feed back a partial dx);
  * `reduce(x)`: all-reduce forward, identity backward: a row-parallel
    layer's partial sums, before its whole bias;
  * `gather(x)`: all-gather forward, the rank's slice backward: a split
    activation where a whole layer follows (and the experts' outputs);
  * `take(t)`:   the rank's slice forward, all-gather backward: a whole
    tensor where a split one is needed (a row layer after a whole one, the
    batch norm's gamma and beta after a column layer).

Every whole tensor is the same on every model rank and so is its gradient,
in full; every split tensor's gradient is the rank's slice. So after the
backward pass each rank holds the full gradient of its whole params and of
its shards, and the data-parallel all-reduce spans the `data` axis only.

`ModelParallel` is a rank's share: its group, degree and index, and the
split of each param leaf (`spec`); `at(key)` narrows it to a subtree,
`shard(tree)` cuts full params into the rank's shards and `join(tree)`
gathers them back into full tensors (a collective: every model rank calls
it). A share of degree 1 leaves every tensor as it is.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Split:
    """A leaf cut over `model` along `dim` into contiguous equal blocks; with
    `qkv`, the dim is the fused q|k|v projection and each third is cut by
    head, so a rank holds q, k and v of its heads."""

    dim: int
    qkv: bool = False


def _walk(fn, tree, spec):
    """fn(leaf, split) over a params tree and its spec tree (same shape)."""
    if isinstance(tree, dict):
        return {k: _walk(fn, v, spec[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_walk(fn, v, s) for v, s in zip(tree, spec)]
    return fn(tree, spec)


def _shard(t: torch.Tensor, split: Optional[Split], degree: int, index: int) -> torch.Tensor:
    """Rank `index`'s block of a full leaf (a copy, contiguous)."""
    if split is None or degree == 1:
        return t
    dim = split.dim % t.dim()
    if split.qkv:  # [..., 3F, ...] -> [..., 3, degree, F / degree, ...]
        n = t.shape[dim] // (3 * degree)
        blocks = t.reshape(*t.shape[:dim], 3, degree, n, *t.shape[dim + 1:])
        return blocks.select(dim + 1, index).reshape(
            *t.shape[:dim], 3 * n, *t.shape[dim + 1:]).contiguous()
    return t.chunk(degree, dim)[index].contiguous()


def _join(parts, split: Split) -> torch.Tensor:
    """The full leaf from every rank's block, in rank order."""
    dim = split.dim % parts[0].dim()
    if split.qkv:
        shape = parts[0].shape
        n = shape[dim] // 3
        thirds = [p.reshape(*shape[:dim], 3, n, *shape[dim + 1:]) for p in parts]
        full = torch.stack(thirds, dim + 1)  # [..., 3, degree, n, ...]
        return full.reshape(*shape[:dim], 3 * n * len(parts), *shape[dim + 1:])
    return torch.cat(parts, dim)


def _all_gather(t: torch.Tensor, group) -> list:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return parts


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, index):
        ctx.dim, ctx.index, ctx.n = dim, index, x.shape[dim]
        return torch.cat(_all_gather(x, group), dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.index * ctx.n, ctx.n), None, None, None


class _Take(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group, degree, index):
        ctx.dim, ctx.group = dim, group
        n = t.shape[dim] // degree
        return t.narrow(dim, index * n, n).clone()

    @staticmethod
    def backward(ctx, grad):
        return torch.cat(_all_gather(grad, ctx.group), ctx.dim), None, None, None, None


class ModelParallel:
    """One rank's share of the `model` axis: `group` (None: one device),
    `spec` the Split (or None, whole) of each leaf of the params it
    applies to."""

    def __init__(self, group=None, spec: Any = None):
        self.group = group
        self.degree = dist.get_world_size(group) if group is not None else 1
        self.index = dist.get_rank(group) if group is not None else 0
        self.spec = spec

    def at(self, *keys) -> "ModelParallel":
        """The share narrowed to the subtree at `keys` of its spec."""
        share = copy.copy(self)
        for k in keys:
            share.spec = share.spec[k]
        return share

    # ------------------------------------------------------- activations

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.degree == 1 else _Copy.apply(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.degree == 1 else _Reduce.apply(x, self.group)

    def gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        if self.degree == 1:
            return x
        return _Gather.apply(x, dim % x.dim(), self.group, self.index)

    def take(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        if self.degree == 1:
            return t
        return _Take.apply(t, dim % t.dim(), self.group, self.degree, self.index)

    def block(self, full: int) -> Tuple[int, int]:
        """(start, size) of this rank's block of `full` entries."""
        n = full // self.degree
        return self.index * n, n

    # ------------------------------------------------------------ params

    def shard_leaf(self, t: torch.Tensor, split: Optional[Split]) -> torch.Tensor:
        """The rank's block of a full leaf cut by `split`."""
        return _shard(t, split, self.degree, self.index)

    @torch.no_grad()
    def join_leaf(self, t: torch.Tensor, split: Optional[Split]) -> torch.Tensor:
        """The full leaf from every model rank's block (a collective)."""
        if split is None or self.degree == 1:
            return t
        return _join(_all_gather(t, self.group), split)

    def shard(self, tree):
        """The rank's shards of a full params tree (whole leaves as given)."""
        return _walk(self.shard_leaf, tree, self.spec)

    def join(self, tree):
        """The full params tree from every model rank's shards: a
        collective that every rank of the group must call."""
        return _walk(self.join_leaf, tree, self.spec)

    def splits_any(self) -> bool:
        """True where some leaf of the spec is cut over `model`."""
        if self.degree == 1:
            return False
        found = []
        _walk(lambda t, s: found.append(s is not None), self.spec, self.spec)
        return any(found)
