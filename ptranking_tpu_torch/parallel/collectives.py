"""Data parallelism's explicit reductions, draws and rank bookkeeping.

The JAX package shards a batch's rows over the mesh's batch axes and XLA
inserts every reduction that spans the batch. Here each rank runs the same
eager program on its contiguous block of a batch's rows, padded to a
multiple of the data-parallel degree with all-masked rows, and the
reductions that span the batch are explicit. Inside `DataParallel.rows(b)`
(b = this rank's rows):

  * `global_sum(t)` is the sum of t over the ranks, with a gradient: its
    backward all-reduces the incoming gradient too. Batch norm's count,
    mean and variance take it, so every rank normalises with the global
    batch's statistics.
  * `global_count(t)` is the same sum without a gradient, for the real-doc
    and real-query counts that a loss divides by (RankMSE, WassRank, the
    adversarial machines' masked means): a rank's loss is its share of the
    global loss, so the ranks' losses and gradients add up to the global
    ones. `global_max` and `global_min` are WassRank's batch-wide label
    maximum and score minimum.
  * `batch_rand(shape, gen, ...)` draws U[0, 1) for the global batch's rows
    from the same generator on every rank and returns this rank's block,
    so dropout and the stochastic losses' noise are the one-rank run's.

Under context parallelism a rank also holds a block of every list's docs
(its `seq` coordinate), and `DataParallel.rows(b, docs=N)` opens the
scorer's scope over the rank's block of N docs: `global_sum` then spans the
gradient group (`data` x `seq`: every real doc of the batch), the per-query
`query_sum` (BN2's statistics) spans the `seq` ranks, and `batch_rand`
draws the global [B, N, ...] and keeps the rank's (rows, docs) block. The
counts of `global_count` (queries, the real docs a loss divides by) span the
batch axes only: summed over `seq` as well, they would count each query S
times.

Outside that scope all of them are the one-device ops. `DataParallel` also
takes a rank's block of a host batch or of an index chunk, sums gradients
and metric sums over the ranks, broadcasts state, and reads files (and
takes decisions on them) on the first rank only; `SINGLE` is its
one-device stand-in, whose methods leave their inputs as they are.
`is_writer()` is False on every rank of a process group but rank 0: only
rank 0 writes run files and checkpoints.
"""

from __future__ import annotations

import contextlib
import io
from typing import Any, Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


class _Rows:
    """This rank's block of a global batch: rows [start, start + local) of
    `total`; `group` sums counts over the batch axes, `sum_group` the
    statistics over every rank of the batch. Under context parallelism
    `docs` is (N, this rank's docs slice of the N padded to a multiple of
    the `seq` degree) and `seq_group` the `seq` line."""

    def __init__(self, total: int, start: int, local: int, group, sum_group=None,
                 docs: Optional[Tuple[int, slice, int]] = None, seq_group=None):
        self.total, self.start, self.local, self.group = total, start, local, group
        self.sum_group = group if sum_group is None else sum_group
        self.docs, self.seq_group = docs, seq_group


# The scope of `DataParallel.rows`, set and restored by it. Module state on
# purpose: batch norm, dropout and the losses are plain functions deep in the
# scorers, and the scope reaches them without a parameter on each.
_ACTIVE: Optional[_Rows] = None


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group's ranks in the forward and, for the gradient, in
    the backward: rank r's input feeds every rank's output."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """t summed over the ranks of the batch (with a gradient) inside
    `DataParallel.rows`: the data-parallel ranks, and under context
    parallelism the `seq` ranks too; t itself outside."""
    if _ACTIVE is None:
        return t
    return _AllReduceSum.apply(t, _ACTIVE.sum_group)


def query_sum(t: torch.Tensor) -> torch.Tensor:
    """A per-query sum over the docs (with a gradient): over the `seq` ranks
    inside a context-parallel scope of `DataParallel.rows`; t itself
    elsewhere."""
    if _ACTIVE is None or _ACTIVE.seq_group is None:
        return t
    return _AllReduceSum.apply(t, _ACTIVE.seq_group)


class _GatherSum(torch.autograd.Function):
    """all_gather along `dim`; the backward sums the gathered gradient over
    the ranks and returns the rank's block: each rank used the whole tensor
    in its own way."""

    @staticmethod
    def forward(ctx, x, dim, group, index):
        ctx.dim, ctx.group, ctx.index, ctx.n = dim, group, index, x.shape[dim]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad.narrow(ctx.dim, ctx.index * ctx.n, ctx.n), None, None, None


def global_max(t: torch.Tensor) -> torch.Tensor:
    """The maximum of t over the data-parallel ranks, without a gradient,
    inside `DataParallel.rows`; t itself outside."""
    if _ACTIVE is None:
        return t
    out = t.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=_ACTIVE.group)
    return out


def global_min(t: torch.Tensor) -> torch.Tensor:
    """The minimum of a scalar t over the data-parallel ranks inside
    `DataParallel.rows`, its gradient reaching the rank that holds it; t
    itself outside."""
    if _ACTIVE is None:
        return t
    return torch.min(_GatherSum.apply(t.reshape(1), 0, _ACTIVE.group,
                                      dist.get_rank(_ACTIVE.group)))


def global_count(t: torch.Tensor) -> torch.Tensor:
    """A count summed over the data-parallel ranks, without a gradient,
    inside `DataParallel.rows`; t itself outside."""
    if _ACTIVE is None:
        return t
    out = t.detach().clone()
    dist.all_reduce(out, group=_ACTIVE.group)
    return out


def batch_rand(shape: Sequence[int], gen: Optional[torch.Generator], device,
               dtype: Optional[torch.dtype] = None,
               split: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """torch.rand(shape) from `gen`. Inside `DataParallel.rows` the leading
    axis must be the batch's rows: the draw is made for the global batch and
    this rank's block returned, so every rank's generator advances alike; in
    a context-parallel scope the second axis must be the rank's block of
    docs, and the draw is made for the global N docs too.
    `split=(dim, full, start)` says `shape[dim]` is this rank's block,
    from `start`, of `full` entries cut over the `model` axis (a column-split
    activation, the rank's heads): the draw is made at `full` and the block
    kept, so the draws are the one-device run's."""
    shape = list(shape)
    if split is not None:
        dim, full_n, start = split
        dim %= len(shape)
        local_n, shape[dim] = shape[dim], full_n
    if _ACTIVE is None:
        out = torch.rand(tuple(shape), generator=gen, device=device, dtype=dtype)
    else:
        if shape[0] != _ACTIVE.local:
            raise ValueError(f"a data-parallel draw must lead with the batch's "
                             f"{_ACTIVE.local} rows, got shape {tuple(shape)}")
        docs = _ACTIVE.docs
        if docs is not None and (len(shape) < 2 or shape[1] != docs[2]):
            raise ValueError(f"a context-parallel draw must have the rank's {docs[2]} docs "
                             f"second, got shape {tuple(shape)}")
        if docs is not None:
            shape[1] = docs[0]
        full = torch.rand((_ACTIVE.total, *shape[1:]), generator=gen, device=device,
                          dtype=dtype)
        out = full[_ACTIVE.start:_ACTIVE.start + _ACTIVE.local]
        if docs is not None:  # the padded docs of the last block draw nothing
            out = _pad_rows(out, max(docs[1].stop, docs[0]), 1, 0.0)[:, docs[1]]
    return out if split is None else out.narrow(dim, start, local_n)


def is_writer() -> bool:
    """True unless this process is a rank other than 0 of a process group."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def _pad_rows(a, rows: int, axis: int, fill):
    """a padded along `axis` to `rows` entries of `fill` (numpy or torch)."""
    pad = rows - a.shape[axis]
    if not pad:
        return a
    shape = list(a.shape)
    shape[axis] = pad
    if isinstance(a, torch.Tensor):
        return torch.cat([a, torch.full(shape, fill, dtype=a.dtype, device=a.device)], axis)
    return np.concatenate([a, np.full(shape, fill, dtype=a.dtype)], axis)


class _Single:
    """The one-device stand-in of DataParallel: one rank, nothing to reduce."""

    degree, index, is_writer = 1, 0, True

    def block(self, rows: int) -> slice:
        return slice(0, rows)

    def shard(self, a, axis: int = 0, fill=0):
        return a

    def shard_index(self, idx_k: np.ndarray, sentinel: int) -> np.ndarray:
        return idx_k

    def rows(self, local: int, docs: Optional[int] = None):
        return contextlib.nullcontext()

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def reduce_grads(self, leaves: Sequence[torch.Tensor]):
        pass

    def broadcast(self, leaves: Sequence[torch.Tensor]):
        pass

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def from_first(self, fn: Callable[..., Any], *args) -> Any:
        return fn(*args)

    def fetch(self, path: str):
        return path

    def barrier(self):
        pass


SINGLE = _Single()


class DataParallel(_Single):
    """One rank's share of data-parallel work over `group` (the ranks that
    split a batch's rows; rank i takes the i-th block). State and files
    span the world: its first rank writes, reads files for every rank and
    broadcasts the initial state, so ranks that share a block of rows (the
    `model` axis) hold the same values and a file is written once.

    Under context parallelism `seq` (parallel/ring.py::SeqParallel) is the
    rank's share of the `seq` axis, which splits each list's docs, and
    `grad_group` the gradient group (`data` x `seq`) over which the
    gradients and the batch's statistics are summed; without it both are
    the batch axes' `group`."""

    def __init__(self, group=None, grad_group=None, seq=None):
        self.group = group if group is not None else dist.group.WORLD
        self.grad_group = self.group if grad_group is None else grad_group
        self.seq = seq
        self.root = dist.group.WORLD
        self.degree = dist.get_world_size(self.group)
        self.index = dist.get_rank(self.group)
        self._root_index = dist.get_rank(self.root)
        self.is_writer = self._root_index == 0
        self._src = dist.get_global_rank(self.root, 0)

    def block(self, rows: int) -> slice:
        """This rank's block of `rows` rows padded to a multiple of the
        degree."""
        n = -(-rows // self.degree)  # rows a rank
        return slice(self.index * n, (self.index + 1) * n)

    def shard(self, a, axis: int = 0, fill=0):
        """This rank's block along `axis` of `a` (numpy or torch), padded to
        a multiple of the degree with `fill` (all-masked rows)."""
        block = self.block(a.shape[axis])
        a = _pad_rows(a, (block.stop - block.start) * self.degree, axis, fill)
        index = [slice(None)] * a.ndim
        index[axis] = block
        return a[tuple(index)]

    def shard_index(self, idx_k: np.ndarray, sentinel: int) -> np.ndarray:
        """This rank's columns of an index chunk [k, B], padded with the
        resident arrays' all-masked sentinel row."""
        return self.shard(np.asarray(idx_k), axis=-1, fill=sentinel)

    @contextlib.contextmanager
    def rows(self, local: int, docs: Optional[int] = None) -> Iterator[None]:
        """Scope of a computation on this rank's `local` rows of the global
        batch: global_sum, global_count and batch_rand span the ranks. With
        `docs` (the lists' N; context parallelism) the computation holds the
        rank's block of them: see the module's docstring."""
        global _ACTIVE
        prev = _ACTIVE
        if docs is None or self.seq is None:
            _ACTIVE = _Rows(local * self.degree, local * self.index, local, self.group)
        else:
            n = -(-docs // self.seq.degree)  # docs a rank
            _ACTIVE = _Rows(local * self.degree, local * self.index, local, self.group,
                            self.grad_group,
                            (docs, slice(self.seq.index * n, (self.seq.index + 1) * n), n),
                            self.seq.group)
        try:
            yield
        finally:
            _ACTIVE = prev

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """t summed over the ranks, in place (no gradient)."""
        dist.all_reduce(t, group=self.group)
        return t

    def _flat(self, tensors: List[torch.Tensor], op: Callable[[torch.Tensor], None]):
        """op on one flat buffer a dtype, copied back into `tensors`."""
        by_dtype = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for group in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            op(flat)
            offset = 0
            for t in group:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()

    def reduce_grads(self, leaves: Sequence[torch.Tensor]):
        """Each leaf's gradient summed over the gradient group: the ranks'
        losses are shares of the global loss, and under context parallelism
        each rank's backward reaches the params through its own docs."""
        grads = [p.grad for p in leaves if p.grad is not None]
        if grads:
            self._flat(grads, lambda f: dist.all_reduce(f, group=self.grad_group))

    @torch.no_grad()
    def broadcast(self, leaves: Sequence[torch.Tensor]):
        """The first rank's values into every rank's tensors."""
        if leaves:
            self._flat(list(leaves), lambda f: dist.broadcast(f, src=self._src, group=self.root))

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's block of rows, in rank order (the padded global batch)."""
        parts = [torch.empty_like(t) for _ in range(self.degree)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts, 0)

    def from_first(self, fn: Callable[..., Any], *args) -> Any:
        """fn(*args) run on the first rank alone (a file read), its result
        (or its exception) handed to every rank."""
        box = [None]
        if self._root_index == 0:
            try:
                box[0] = (True, fn(*args))
            except Exception as exc:  # raised on every rank, not only here
                box[0] = (False, exc)
        dist.broadcast_object_list(box, src=self._src, group=self.root)
        ok, value = box[0]
        if not ok:
            raise value
        return value

    def fetch(self, path: str) -> io.BytesIO:
        """The file at `path` as the first rank reads it, on every rank (its
        bytes in a binary file object)."""
        return io.BytesIO(self.from_first(_read_bytes, path))

    def barrier(self):
        dist.barrier(group=self.root)


def _read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()
