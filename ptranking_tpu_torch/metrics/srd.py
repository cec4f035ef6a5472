"""Diversity (SRD) metrics: alpha-DCG / alpha-nDCG, ERR-IA / nERR-IA,
delta-alpha-DCG and the greedy ideal diversified ranking.

The port's copy of ptranking_tpu/metrics/srd.py. A query's diversity labels
form a subtopic-coverage matrix rele_mat [S, N] (subtopics x docs, 0/1 or
graded); the batched functions take [B, S, N] plus a bool doc mask [B, N]
and a subtopic mask [B, S], so padded docs and subtopics contribute nothing.
`np_greedy_ideal_ranking` is the host-side (numpy) ideal order used in
dataset preparation; `greedy_ideal_ranking` computes the same order on the
tensors' device, one argmax a step (torch's argmax, like JAX's, returns the
first maximum).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

_EPS = 1e-12


def _prior_cover_cnts(rele_mat: torch.Tensor) -> torch.Tensor:
    """Cover counts of each subtopic BEFORE each position: a shifted cumsum
    along the doc axis."""
    shifted = torch.cat([torch.zeros_like(rele_mat[..., :1]), rele_mat[..., :-1]], dim=-1)
    return torch.cumsum(shifted, dim=-1)


def _positions(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=like.dtype, device=like.device)


# The cutoffs are Python ints: the helpers below index and compare with them
# directly, so no index tensor is copied to the device (a blocking copy
# would make the host wait for the device).


def _at_ks(rankwise: torch.Tensor, ks: Sequence[int]) -> torch.Tensor:
    """rankwise[..., min(k, n) - 1] for each k -> [..., len(ks)]."""
    n = rankwise.shape[-1]
    return torch.stack([rankwise[..., min(k, n) - 1] for k in ks], dim=-1)


def _valid_ks(doc_mask: torch.Tensor, ks: Sequence[int]) -> torch.Tensor:
    """k <= the number of real docs, [..., len(ks)]."""
    n_real = torch.sum(doc_mask.to(torch.float32), dim=-1)
    return torch.stack([n_real >= k for k in ks], dim=-1)


def alpha_dcg_rankwise(rele_mat: torch.Tensor, doc_mask: torch.Tensor,
                       alpha: float = 0.5) -> torch.Tensor:
    """Cumulative alpha-DCG per position. rele_mat: [..., S, N] already sorted
    in the ranking order with pads at the tail; doc_mask [..., N]."""
    n = rele_mat.shape[-1]
    rele_mat = rele_mat * doc_mask[..., None, :]
    cover = _prior_cover_cnts(rele_mat)
    denom = torch.log2(_positions(n, rele_mat) + 2.0)
    gains = torch.pow(1.0 - alpha, cover) * rele_mat / denom
    global_gains = torch.sum(gains, dim=-2)  # over subtopics -> [..., N]
    return torch.cumsum(global_gains * doc_mask, dim=-1)


def alpha_ndcg_at_ks(sys_rele_mat, ideal_rele_mat, doc_mask, ks: Sequence[int],
                     alpha: float = 0.5) -> torch.Tensor:
    """alpha-nDCG@ks, 0.0 where k exceeds the real list length or the ideal
    DCG is 0. Returns [..., len(ks)]."""
    sys_at = _at_ks(alpha_dcg_rankwise(sys_rele_mat, doc_mask, alpha), ks)
    ideal_at = _at_ks(alpha_dcg_rankwise(ideal_rele_mat, doc_mask, alpha), ks)
    ndcg = torch.where(ideal_at > 0, sys_at / torch.clamp(ideal_at, min=_EPS), 0.0)
    return torch.where(_valid_ks(doc_mask, ks), ndcg, 0.0)


def rankwise_err_ia(rele_mat: torch.Tensor, doc_mask: torch.Tensor, max_label: float,
                    subtopic_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cumulative ERR-IA per position: the mean over subtopics of the
    per-subtopic cascade ERR. rele_mat: [..., S, N] sorted; returns [..., N]."""
    rele_mat = rele_mat * doc_mask[..., None, :]
    satis = (torch.pow(2.0, rele_mat) - 1.0) / (2.0 ** max_label)
    cum_unsatis = torch.cumprod(1.0 - satis, dim=-1)
    cascade = torch.cat([torch.ones_like(cum_unsatis[..., :1]), cum_unsatis[..., :-1]], dim=-1)
    n = rele_mat.shape[-1]
    recip = 1.0 / (_positions(n, rele_mat) + 1.0)
    expt = satis * cascade * recip  # [..., S, N]
    if subtopic_mask is not None:
        sm = subtopic_mask.to(expt.dtype)
        expt = expt * sm[..., :, None]
        n_sub = torch.clamp(torch.sum(sm, dim=-1), min=1.0)
        return torch.cumsum(torch.sum(expt, dim=-2), dim=-1) / n_sub[..., None]
    return torch.cumsum(torch.sum(expt, dim=-2), dim=-1) / rele_mat.shape[-2]


def err_ia_at_ks(rele_mat, doc_mask, max_label, ks: Sequence[int],
                 subtopic_mask=None) -> torch.Tensor:
    vals = _at_ks(rankwise_err_ia(rele_mat, doc_mask, max_label, subtopic_mask), ks)
    return torch.where(_valid_ks(doc_mask, ks), vals, 0.0)


def nerr_ia_at_ks(sys_rele_mat, ideal_rele_mat, doc_mask, max_label,
                  ks: Sequence[int], subtopic_mask=None) -> torch.Tensor:
    sys_at = _at_ks(rankwise_err_ia(sys_rele_mat, doc_mask, max_label, subtopic_mask), ks)
    ideal_at = _at_ks(rankwise_err_ia(ideal_rele_mat, doc_mask, max_label, subtopic_mask), ks)
    nerr = torch.where(ideal_at > 0, sys_at / torch.clamp(ideal_at, min=_EPS), 0.0)
    return torch.where(_valid_ks(doc_mask, ks), nerr, 0.0)


def delta_alpha_dcg(ideal_rele_mat, sys_rele_mat, doc_mask, alpha: float = 0.5,
                    normalization: bool = True) -> torch.Tensor:
    """|Delta alpha-DCG| of swapping each doc pair of the predicted ranking.
    sys_rele_mat: [..., S, N] in predicted order; returns [..., N, N]."""
    n = sys_rele_mat.shape[-1]
    sys_rele_mat = sys_rele_mat * doc_mask[..., None, :]
    focus = torch.pow(1.0 - alpha, _prior_cover_cnts(sys_rele_mat))  # [..., S, N]
    gains = torch.pow(2.0, sys_rele_mat) - 1.0
    gain_diffs = gains[..., :, None] - gains[..., None, :]  # [..., S, N, N]
    discounts = 1.0 / torch.log2(_positions(n, sys_rele_mat) + 2.0)
    coffs_1st = discounts[:, None] * focus[..., :, None]
    coffs_2nd = discounts[None, :] * focus[..., None, :]
    delta = torch.abs(torch.sum(gain_diffs * coffs_1st, dim=-3)
                      - torch.sum(gain_diffs * coffs_2nd, dim=-3))  # [..., N, N]
    pmask = doc_mask[..., :, None] & doc_mask[..., None, :]
    delta = torch.where(pmask, delta, 0.0)
    if normalization:
        ideal = alpha_dcg_rankwise(ideal_rele_mat, doc_mask, alpha)[..., -1]
        return delta / torch.clamp(ideal[..., None, None], min=_EPS)
    return delta


# --- greedy ideal diversified ranking ---------------------------------------


def np_greedy_ideal_ranking(rele_mat: np.ndarray, alpha: float = 0.5) -> np.ndarray:
    """Greedy max-global-gain ordering of one query's [S, N] coverage matrix;
    returns doc indices. Host-side, used in dataset preparation."""
    S, N = rele_mat.shape
    cover = np.zeros(S)
    remaining = list(range(N))
    order = []
    while remaining:
        ggs = [float(np.sum((1.0 - alpha) ** cover * rele_mat[:, d])) for d in remaining]
        best = remaining[int(np.argmax(ggs))]
        cover += rele_mat[:, best]
        order.append(best)
        remaining.remove(best)
    return np.asarray(order, dtype=np.int64)


def greedy_ideal_ranking(rele_mat: torch.Tensor, doc_mask: torch.Tensor,
                         alpha: float = 0.5) -> torch.Tensor:
    """The greedy ideal order on the tensors' device: each of N steps picks
    the unselected real doc of largest global gain (the first such doc on
    ties); pads come after every real doc, in index order. rele_mat
    [..., S, N] and doc_mask [..., N], leading axes a batch of queries (the
    JAX function's vmap); returns int32 doc indices [..., N]. Nothing goes
    to the host."""
    *lead, S, N = rele_mat.shape
    dev = rele_mat.device
    rele_mat = rele_mat * doc_mask[..., None, :]
    # pads get a finite, strictly ordered sentinel gain so they are picked
    # exactly once each, after every real doc, in index order
    pad_gain = -1e6 - torch.arange(N, dtype=torch.float32, device=dev)
    cover = torch.zeros(*lead, S, dtype=rele_mat.dtype, device=dev)
    selected = torch.zeros(*lead, N, dtype=torch.bool, device=dev)
    order = torch.zeros(*lead, N, dtype=torch.int32, device=dev)
    for i in range(N):
        gg = torch.sum(torch.pow(1.0 - alpha, cover)[..., :, None] * rele_mat, dim=-2)
        gg = torch.where(doc_mask, gg, pad_gain)
        gg = torch.where(selected, -torch.inf, gg)
        best = torch.argmax(gg, dim=-1, keepdim=True)  # [..., 1]
        cover = cover + torch.gather(rele_mat, -1, best[..., None, :].expand(*lead, S, 1))[..., 0]
        selected.scatter_(-1, best, True)
        order[..., i] = best[..., 0]
    return order
