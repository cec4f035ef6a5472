"""Context parallelism over the document axis: ring and Ulysses attention and
the ring losses.

The port's counterpart of ptranking_tpu/parallel/ring.py. Candidate lists
reach about 1,300 docs (MSLR-WEB30K), and the listwise scorer's attention
[B, H, N, N] and the pair losses' [B, N, N] grow with N^2. Under context
parallelism (CP) the doc axis is split over the mesh's `seq` axis: each
rank holds its block of n = N / S docs of every list, and these matrices
only ever exist as blocks of n rows.

The JAX package writes these functions inside `shard_map`, where XLA
transposes every collective for the backward pass. Here each rank runs the
eager program on its block, and the `seq` collectives are autograd
functions, each with its transpose as its backward, all in `SeqParallel`:

  ===========================================  ====================  =====================
  JAX                                          forward               backward
  ===========================================  ====================  =====================
  ppermute around the ring (`shift`)           send to rank + 1      the same shift to rank - 1
  all_to_all(split, concat, tiled)             all_to_all            the inverse all_to_all
  all_gather used differently on each rank     all_gather            sum over the ranks, then
  (`gather_sum`: a sort, NeuralNDCG's rows)                          the rank's block
  all_gather used alike on each rank           all_gather            the rank's block
  (`gather`: a loss or metric on whole rows)
  inner psum (`psum`: softmax denominators)    all_reduce            all_reduce
  the loss's final psum (`loss_sum`)           all_reduce            identity
  pmax of a stop-gradient (`pmax`)             all_reduce(MAX)       none
  ===========================================  ====================  =====================

A loss here returns the rank's share of the global loss: its data line's
loss (the same on every `seq` rank of the line), whose backward from the
rank gives the gradient through its own block; the DistributedTrainer sums
the shares over the batch axes (the loss totals) and the gradients over
the gradient group (`data` x `seq`). Global positions are
`seq_index * n + arange(n)`, as in the JAX package.

Under gloo, a group's send / recv of CUDA tensors goes through host memory
(`SeqParallel.route`), chosen by the group's backend: gloo's p2p takes
host pointers, while its all_to_all, all_gather and all_reduce take CUDA
tensors (tools/gloo_probe.py); NCCL takes the card's memory.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from ptranking_tpu_torch import EPSILON
from ptranking_tpu_torch.ops.attention import online_combine, sdpa_block
from ptranking_tpu_torch.parallel.collectives import _AllReduceSum, _GatherSum, _pad_rows
from ptranking_tpu_torch.parallel.tensor import _Gather, _Reduce, _all_gather


def _host_staged(group, tensors) -> bool:
    """True where gloo carries these CUDA tensors' send / recv: they go
    through host memory (gloo's p2p reads a CUDA pointer as a host one;
    its all_to_all, all_gather and all_reduce take CUDA tensors:
    tools/gloo_probe.py)."""
    return any(t.is_cuda for t in tensors) and dist.get_backend(group) == "gloo"


def _send_recv(tensors, group, step: int):
    """Each tensor sent to the rank `step` ahead on the group's ring, and the
    one of the rank `step` behind received (one batch of p2p ops)."""
    size, me = dist.get_world_size(group), dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + step) % size)
    src = dist.get_global_rank(group, (me - step) % size)
    staged = _host_staged(group, tensors)
    send = [t.detach().contiguous() for t in tensors]
    if staged:
        send = [t.cpu() for t in send]
    recv = [torch.empty_like(t) for t in send]
    ops = []
    for tag, (s, r) in enumerate(zip(send, recv)):
        ops += [dist.P2POp(dist.isend, s, dst, group, tag),
                dist.P2POp(dist.irecv, r, src, group, tag)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [r.to(t.device) for r, t in zip(recv, tensors)] if staged else recv


class _Shift(torch.autograd.Function):
    """The ring's ppermute: every tensor to rank + 1; the gradients back to
    rank - 1. Bool tensors (masks) travel without a gradient."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        ctx.floats = [t.is_floating_point() for t in tensors]
        out = _send_recv(tensors, group, 1)
        ctx.mark_non_differentiable(*[o for o, f in zip(out, ctx.floats) if not f])
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        need = [i for i, f in enumerate(ctx.floats) if f and ctx.needs_input_grad[1 + i]]
        back = _send_recv([grads[i] for i in need], ctx.group, -1) if need else []
        out = [None] * len(grads)
        for i, g in zip(need, back):
            out[i] = g
        return (None, *out)


def _all_to_all(t: torch.Tensor, split_dim: int, concat_dim: int, group) -> torch.Tensor:
    """Tiled all_to_all: t cut into the group's size along split_dim, chunk j
    to rank j, the chunks received joined along concat_dim in rank order."""
    size = dist.get_world_size(group)
    inp = torch.stack(t.chunk(size, split_dim)).contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=group)
    return torch.cat(out.unbind(0), concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return _all_to_all(t, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, grad):
        split_dim, concat_dim = ctx.dims
        return _all_to_all(grad, concat_dim, split_dim, ctx.group), None, None, None


class SeqParallel:
    """One rank's share of a mesh axis (the `seq` axis; for the few loss
    sums that span the batch, the batch axes' group): its group (None: one
    rank), degree and index, and the axis' collectives. At degree 1 each
    collective returns its input."""

    def __init__(self, group=None):
        self.group = group
        self.degree = dist.get_world_size(group) if group is not None else 1
        self.index = dist.get_rank(group) if group is not None else 0

    @property
    def route(self) -> str:
        """How the ring's send / recv of CUDA tensors travels."""
        if self.degree == 1:
            return "none (one rank)"
        if dist.get_backend(self.group) == "gloo":
            return "gloo, send / recv of CUDA tensors staged through host memory"
        return dist.get_backend(self.group)

    def block(self, a, dim: int, fill=0):
        """This rank's block along `dim` of `a` (numpy or torch), padded to a
        multiple of the degree with `fill` (all-masked docs)."""
        if self.degree == 1:
            return a
        dim %= a.ndim
        n = -(-a.shape[dim] // self.degree)
        a = _pad_rows(a, n * self.degree, dim, fill)
        index = [slice(None)] * a.ndim
        index[dim] = slice(self.index * n, (self.index + 1) * n)
        return a[tuple(index)]

    def positions(self, n_local: int, device) -> torch.Tensor:
        """Global positions of this rank's block of n_local docs."""
        return self.index * n_local + torch.arange(n_local, device=device)

    # ------------------------------------------------------- collectives

    def shift(self, *tensors):
        """Every tensor to the next rank of the ring (from the previous)."""
        if self.degree == 1:
            return tensors
        return _Shift.apply(self.group, *tensors)

    def all_to_all(self, t: torch.Tensor, split_dim: int, concat_dim: int) -> torch.Tensor:
        if self.degree == 1:
            return t
        return _AllToAll.apply(t, split_dim % t.dim(), concat_dim % t.dim(), self.group)

    def gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """all_gather; backward the rank's block (every rank uses the result
        alike). Without a gradient, for labels and masks too."""
        if self.degree == 1:
            return t
        if t.dtype == torch.bool:  # masks travel as bytes
            return self.gather(t.to(torch.uint8), dim).bool()
        if not t.requires_grad:
            with torch.no_grad():
                return torch.cat(_all_gather(t, self.group), dim % t.dim())
        return _Gather.apply(t, dim % t.dim(), self.group, self.index)

    def gather_sum(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """all_gather; backward summed over the ranks, then the rank's block
        (every rank uses the result in its own way)."""
        if self.degree == 1:
            return t
        return _GatherSum.apply(t, dim % t.dim(), self.group, self.index)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """An inner sum over the ranks: all_reduce both ways."""
        if self.degree == 1:
            return t
        return _AllReduceSum.apply(t, self.group)

    def loss_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The loss's final sum: all_reduce forward, identity backward (each
        rank's share takes its own cotangent)."""
        if self.degree == 1:
            return t
        return _Reduce.apply(t, self.group)

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        """The maximum over the ranks of a stop-gradient."""
        t = t.detach()
        if self.degree == 1:
            return t
        t = t.clone()
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t

    def sum_nograd(self, t: torch.Tensor) -> torch.Tensor:
        """A sum over the ranks without a gradient (counts, error probes)."""
        t = t.detach()
        if self.degree == 1:
            return t
        t = t.clone()
        dist.all_reduce(t, group=self.group)
        return t


SINGLE_AXIS = SeqParallel()


class CPPlan(NamedTuple):
    """The context-parallel plan threaded through apply_scorer into the MHSA
    blocks and into the trainer's losses: the `seq` share, the attention
    exchange ('ring' | 'ulysses') and the batch axes' share (for the loss
    sums that span the batch: counts, maxima, minima)."""

    seq: SeqParallel
    impl: str = "ring"
    batch: SeqParallel = SINGLE_AXIS


def ring_attention(q, k, v, mask, cp: CPPlan) -> torch.Tensor:
    """Exact doc-axis-sharded attention: q, k, v [B, H, n, d] and mask [B, n]
    are the rank's block; its queries meet every key block as (k, v, mask)
    travel around the ring, folded by a running-max online softmax. Output
    [B, H, n, d] in q's dtype."""
    seq = cp.seq
    scale = 1.0 / math.sqrt(q.shape[-1])
    B, H, n, d = q.shape
    num = torch.zeros((B, H, n, d), dtype=torch.float32, device=q.device)
    den = torch.zeros((B, H, n), dtype=torch.float32, device=q.device)
    mx = torch.full((B, H, n), float("-inf"), dtype=torch.float32, device=q.device)
    k_c, v_c, m_c = k, v, mask
    for step in range(seq.degree):
        num, den, mx = online_combine(num, den, mx, *sdpa_block(q, k_c, v_c, m_c, scale))
        if step < seq.degree - 1:
            k_c, v_c, m_c = seq.shift(k_c, v_c, m_c)
    return (num / torch.clamp(den, min=1e-30)[..., None]).to(q.dtype)


def ulysses_attention(q, k, v, mask, cp: CPPlan) -> torch.Tensor:
    """All-to-all CP: the shard axis swapped from docs to heads, full-length
    attention on the rank's H / S heads, swapped back. Needs H % S == 0."""
    seq = cp.seq
    if q.shape[1] % seq.degree:
        raise ValueError(f"Ulysses attention needs the heads ({q.shape[1]}) to divide over "
                         f"the seq axis ({seq.degree})")
    scale = 1.0 / math.sqrt(q.shape[-1])
    qh, kh, vh = (seq.all_to_all(t, 1, 2) for t in (q, k, v))  # [B, H/S, N, d]
    num, den, _ = sdpa_block(qh, kh, vh, seq.gather(mask, 1), scale)
    out = (num / torch.clamp(den, min=1e-30)[..., None]).to(q.dtype)
    return seq.all_to_all(out, 2, 1)


def reference_attention(q, k, v, mask) -> torch.Tensor:
    """The one-device oracle with the same masking."""
    num, den, _ = sdpa_block(q, k, v, mask, 1.0 / math.sqrt(q.shape[-1]))
    return (num / torch.clamp(den, min=1e-30)[..., None]).to(q.dtype)


def cp_attention(q, k, v, mask, cp: CPPlan) -> torch.Tensor:
    """The plan's attention exchange."""
    return (ring_attention if cp.impl == "ring" else ulysses_attention)(q, k, v, mask, cp)


def _loss_psum(share: torch.Tensor, cp: CPPlan) -> torch.Tensor:
    """The CP loss's final sum (JAX's `_loss_psum_axes`): the rank's share
    summed over `seq` into its data line's loss, identity backward. The
    batch axes' shares are summed by the trainer, as every loss's are."""
    return cp.seq.loss_sum(share)


def _ring_blocks(cp: CPPlan, pair_block, *rows):
    """sum_r pair_block(rows, columns of block src, src) while the column
    blocks travel around the ring (src: the block's home rank)."""
    seq = cp.seq
    cols = rows
    acc = None
    for step in range(seq.degree):
        src = (seq.index - step) % seq.degree
        part = pair_block(*rows, *cols, src)
        acc = part if acc is None else acc + part
        if step < seq.degree - 1:
            cols = seq.shift(*cols)
    return acc


def ring_lambda_loss(sorted_scores, sorted_labels, n_gains, mask, cp: CPPlan,
                     sigma: float = 1.0, weighted: bool = True) -> torch.Tensor:
    """Doc-axis-sharded LambdaRank (weighted) / RankNet (unweighted) pair
    loss over the rank's block [B, n] of rows sorted by score (or, for
    RankNet, of the given order): the masked BCE over pairs of global rank
    i < j, weighted by |dnG| |dD|, accumulated while column blocks travel
    around the ring. Returns the rank's data line's loss."""
    n_loc = sorted_scores.shape[-1]
    local = torch.arange(n_loc, device=sorted_scores.device)
    rank_i = cp.seq.index * n_loc + local
    d_i = 1.0 / torch.log2(rank_i.to(torch.float32) + 2.0)

    def pair_block(si, li, gi, mi, sj, lj, gj, mj, src):
        rank_j = src * n_loc + local
        diffs = sigma * (si[:, :, None] - sj[:, None, :])
        targets = 0.5 * (1.0 + torch.clamp(li[:, :, None] - lj[:, None, :], -1.0, 1.0))
        bce = torch.logaddexp(torch.zeros_like(diffs), diffs) - targets * diffs
        if weighted:
            d_j = 1.0 / torch.log2(rank_j.to(torch.float32) + 2.0)
            bce = bce * (torch.abs(gi[:, :, None] - gj[:, None, :])
                         * torch.abs(d_i[:, None] - d_j[None, :])[None])
        valid = mi[:, :, None] & mj[:, None, :] & (rank_i[:, None] < rank_j[None, :])[None]
        return torch.sum(torch.where(valid, bce, 0.0))

    acc = _ring_blocks(cp, pair_block, sorted_scores, sorted_labels, n_gains, mask)
    return _loss_psum(acc, cp)


def ring_lambdaloss(sorted_scores, sorted_labels, n_gains, mask, cp: CPPlan,
                    loss_type: str = "NDCG_Loss2", k: int = 5, sigma: float = 1.0,
                    mu: float = 5.0, eps: float = EPSILON) -> torch.Tensor:
    """Doc-axis-sharded LambdaLoss (losses/listwise.py::lambda_loss
    blockwise): every weight, clamp and truncation of the dense loss on
    global positions, the column blocks travelling around the ring. `eps`
    must equal the dense loss's clip (EPSILON) or saturated pairs diverge."""
    if loss_type not in ("NDCG_Loss1", "NDCG_Loss2", "NDCG_Loss2++"):
        raise NotImplementedError(loss_type)
    n_loc = sorted_scores.shape[-1]
    local = torch.arange(n_loc, device=sorted_scores.device)
    rank_i = cp.seq.index * n_loc + local
    log2_eps = math.log2(eps)

    def pair_block(si, li, gi, mi, sj, lj, gj, mj, src):
        rank_j = src * n_loc + local
        diffs = torch.clamp(si[:, :, None] - sj[:, None, :], -1e8, 1e8)
        log_probas = torch.log2(torch.clamp(torch.sigmoid(sigma * diffs), min=eps))
        pi = rank_i.to(torch.float32)[:, None]
        pj = rank_j.to(torch.float32)[None, :]
        if loss_type == "NDCG_Loss1":
            w = (gj * torch.log2(rank_j.to(torch.float32) + 2.0))[:, None, :]
        else:
            d = torch.abs(pi - pj)
            delta_ij = torch.abs(torch.log2(d + 2.0) - torch.log2(d + 1.0))
            delta_ij = torch.where(pi == pj, 0.0, delta_ij)
            ng_diffs = torch.abs(gi[:, :, None] - gj[:, None, :])
            if loss_type == "NDCG_Loss2":
                w = delta_ij[None] * ng_diffs
            else:
                rho_ij = torch.abs(torch.log2(pi + 2.0) - torch.log2(pj + 2.0))
                w = (rho_ij[None] + mu * delta_ij[None]) * ng_diffs
        log_weighted = torch.clamp(w * log_probas, min=log2_eps)
        select = (mi[:, :, None] & mj[:, None, :]
                  & ((rank_i[:, None] < k) & (rank_j[None, :] < k))[None])
        if loss_type != "NDCG_Loss1":
            select = select & (li[:, :, None] - lj[:, None, :] > 0)
        return torch.sum(torch.where(select, log_weighted, 0.0))

    acc = _ring_blocks(cp, pair_block, sorted_scores, sorted_labels, n_gains, mask)
    return -_loss_psum(acc, cp)


def _ring_rank_sums(scores, mask, cp: CPPlan, pair_fn):
    """sum_j pair_fn(s_i, s_j) over valid j, the column blocks travelling
    around the ring: a running row sum [B, n]."""

    def pair_block(s_l, m_l, s_c, m_c, src):
        valid = m_l[:, :, None] & m_c[:, None, :]
        return torch.sum(torch.where(valid, pair_fn(s_l[:, :, None], s_c[:, None, :]), 0.0),
                         dim=-1)

    return _ring_blocks(cp, pair_block, scores, mask)


def ring_approx_ndcg(scores, n_gains, mask, cp: CPPlan, alpha: float = 10.0) -> torch.Tensor:
    """Doc-axis-sharded ApproxNDCG: the smooth ranks pi_i = 0.5 + sum_j
    sigmoid(alpha (s_j - s_i)) as running row sums around the ring; no sort
    (labels come in the ideal order). n_gains carries 1/IDCG."""
    rank_sums = _ring_rank_sums(scores, mask, cp,
                                lambda si, sj: torch.sigmoid(alpha * (sj - si)))
    hat_pi = rank_sums + 0.5
    local = torch.sum(torch.where(mask, n_gains / torch.log2(hat_pi + 1.0), 0.0))
    return -_loss_psum(local, cp)


def ring_soft_rank(scores, n_gains, mask, cp: CPPlan, delta: float = 1.0,
                   top_k: Optional[int] = None) -> torch.Tensor:
    """Doc-axis-sharded SoftRank: expected ranks 1 + sum_{j != i}
    Phi0((s_i - s_j) / sqrt(2 * 2 delta^2)) as running row sums around the
    ring (the self pair's Phi0(0) = 0.5 taken off once), top_k on global
    positions."""
    inv_std = 1.0 / math.sqrt(2.0 * 2.0 * delta * delta)
    rank_sums = _ring_rank_sums(scores, mask, cp,
                                lambda si, sj: 0.5 * torch.special.erfc((si - sj) * inv_std))
    expt_ranks = rank_sums - torch.where(mask, 0.5, 0.0) + 1.0
    terms = torch.where(mask, n_gains / torch.log2(expt_ranks + 1.0), 0.0)
    if top_k is not None:
        pos = cp.seq.positions(scores.shape[-1], scores.device)
        terms = torch.where((pos < top_k)[None], terms, 0.0)
    return -_loss_psum(torch.sum(terms), cp)


def ring_neural_ndcg(scores, labels, mask, cp: CPPlan, temperature: float = 1.0,
                     top_k: Optional[int] = None, sinkhorn_iters: int = 10,
                     label_type=None) -> torch.Tensor:
    """Doc-axis-sharded NeuralNDCG: the relaxed permutation P [N, N] split
    over its rank rows, each rank holding [B, n, N]. The scores are
    gathered (their gradient summed back), the |s_j - s_k| row sums made on
    the rank's block and gathered likewise; each scaling round's column
    normalisation takes one stop-gradient max and one sum over `seq`."""
    from ptranking_tpu_torch.ops import gain as label_gain, masked_log_softmax
    from ptranking_tpu_torch.ops.sinkhorn import _NEG, _lse
    from ptranking_tpu_torch.parallel.ot import _plse_sg
    from ptranking_tpu_torch.types import LabelType

    lt = LabelType.MultiLabel if label_type is None else label_type
    seq = cp.seq
    n_l = scores.shape[-1]
    rows0 = seq.positions(n_l, scores.device)
    s_full = seq.gather_sum(scores, 1)
    l_full = seq.gather(labels, 1)
    m_full = seq.gather(mask, 1)
    N = s_full.shape[-1]
    n = torch.sum(m_full, dim=-1, keepdim=True).to(scores.dtype)       # [B, 1]

    s_lm = torch.where(mask, scores, 0.0)
    s_fm = torch.where(m_full, s_full, 0.0)
    # A_j = sum_k |s_j - s_k|: the local j block against every k, then gathered
    blk = torch.abs(s_lm[..., :, None] - s_fm[..., None, :])
    valid_jk = mask[..., :, None] & m_full[..., None, :]
    A_full = seq.gather_sum(torch.sum(torch.where(valid_jk, blk, 0.0), dim=-1), 1)

    ranks_l = (rows0 + 1).to(scores.dtype)                              # global ranks
    c_l = n + 1.0 - 2.0 * ranks_l[None, :]                              # [B, n]
    logits = (c_l[..., :, None] * s_fm[..., None, :] - A_full[..., None, :]) / temperature
    row_ok = ranks_l[None, :] <= n                                      # [B, n]
    cell = row_ok[..., :, None] & m_full[..., None, :]
    log_p = masked_log_softmax(logits, cell)
    log_p = torch.where(cell, log_p, _NEG)
    for _ in range(int(sinkhorn_iters)):
        # columns: a logsumexp over the rank axis, split over `seq`
        log_p = log_p - _plse_sg(log_p, -2, seq)[..., None, :]
        log_p = torch.where(cell, log_p, _NEG)
        log_p = log_p - _lse(log_p, -1)[..., :, None]                  # rows
        log_p = torch.where(cell, log_p, _NEG)
    Pm = torch.where(cell, torch.exp(log_p), 0.0)

    gains_full = label_gain(torch.where(m_full, l_full, 0.0), lt)
    ghat = torch.einsum("bij,bj->bi", Pm, gains_full)                   # [B, n]
    disc_l = 1.0 / torch.log2(ranks_l + 1.0)
    kmask_l = (row_ok if top_k is None
               else row_ok & (ranks_l <= min(int(top_k), N))[None])
    dcg_l = torch.sum(torch.where(kmask_l, ghat * disc_l[None], 0.0), -1)  # [B]

    ranks_f = torch.arange(1, N + 1, dtype=scores.dtype, device=scores.device)
    disc_f = 1.0 / torch.log2(ranks_f + 1.0)
    krow_f = ranks_f[None, :] <= n
    if top_k is not None:
        krow_f = krow_f & (ranks_f <= min(int(top_k), N))[None]
    ideal = torch.where(krow_f & m_full, gains_full * disc_f[None], 0.0)
    idcg = torch.clamp(torch.sum(ideal, dim=-1), min=EPSILON)
    return -_loss_psum(torch.sum(dcg_l / idcg), cp)
