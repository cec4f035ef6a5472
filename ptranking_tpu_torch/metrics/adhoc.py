"""Batched, masked adhoc IR metrics: P@k, AP@k, (n)ERR@k, (n)DCG@k, Kendall
tau, as in ptranking_tpu/metrics/adhoc.py, quirks included:
  * AP's denominator is the cumulative sum of the RAW ideal labels, not the
    binarised ones: graded labels inflate the denominator.
  * ERR's satisfaction probability normalises by 2^max_label where max_label
    defaults to the max over the whole batch of ideal rankings.
  * `*_at_ks` report 0.0 for any cutoff k exceeding the number of REAL
    documents.

All functions take labels already sorted into predicted / ideal order with
pads (label 0) at the tail (ops/sorting.py) plus `n`, the per-query count of
real documents. Everything stays on the tensors' device.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ptranking_tpu_torch.ops.gains import gain
from ptranking_tpu_torch.ops.sorting import ideal_sorted_labels, sort_labels_by_scores
from ptranking_tpu_torch.types import LabelType

_EPS = 1e-12


def _ranks(n_pos: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(1, n_pos + 1, dtype=like.dtype, device=like.device)


def _take_at_ks(rankwise: torch.Tensor, n: torch.Tensor, ks: Sequence[int]) -> torch.Tensor:
    """Gather rankwise[:, k-1] for each k, zeroing entries where k > n."""
    n_pos = rankwise.shape[-1]
    idx = torch.tensor([min(k, n_pos) - 1 for k in ks], device=rankwise.device)
    vals = rankwise[:, idx]  # [B, K]
    valid = torch.tensor(list(ks), device=rankwise.device)[None, :] <= n[:, None]
    return torch.where(valid, vals, 0.0)


def _rankwise_precision(pred_sorted_labels: torch.Tensor) -> torch.Tensor:
    bins = torch.clamp(pred_sorted_labels, 0.0, 1.0)
    cum = torch.cumsum(bins, dim=-1)
    return cum / _ranks(pred_sorted_labels.shape[-1], pred_sorted_labels)


def precision_at_ks(pred_sorted_labels, n, ks) -> torch.Tensor:
    """P@ks."""
    return _take_at_ks(_rankwise_precision(pred_sorted_labels), n, ks)


def ap_at_ks(pred_sorted_labels, ideal_sorted_labels, n, ks) -> torch.Tensor:
    """AP@ks, with the raw-label denominator."""
    bins = torch.clamp(pred_sorted_labels, 0.0, 1.0)
    rank_prec = _rankwise_precision(pred_sorted_labels)
    cum_prec = torch.cumsum(rank_prec * bins, dim=-1)
    denom = torch.cumsum(ideal_sorted_labels, dim=-1)  # RAW labels
    rankwise_ap = cum_prec / torch.clamp(denom, min=_EPS)
    return _take_at_ks(rankwise_ap, n, ks)


def rankwise_err(sorted_labels: torch.Tensor, max_label, point: bool = False) -> torch.Tensor:
    """Cascade-model ERR per rank position. Padded labels (0) have
    satisfaction probability 0 and leave the cascade untouched, so padding at
    the tail is harmless."""
    n_pos = sorted_labels.shape[-1]
    max_label = torch.as_tensor(max_label, dtype=sorted_labels.dtype, device=sorted_labels.device)
    satis = (torch.pow(2.0, sorted_labels) - 1.0) / torch.pow(2.0, max_label)
    unsatis = 1.0 - satis
    cum_unsatis = torch.cumprod(unsatis, dim=-1)
    # probability of reaching position i = prod of unsatis over positions < i
    cascade = torch.cat([torch.ones_like(cum_unsatis[..., :1]), cum_unsatis[..., : n_pos - 1]],
                        dim=-1)
    expt = satis * cascade / _ranks(n_pos, sorted_labels)
    out = torch.cumsum(expt, dim=-1)
    if point:
        return out[..., -1:]
    return out


def nerr_at_ks(pred_sorted_labels, ideal_sorted_labels, n, ks, max_label=None) -> torch.Tensor:
    """nERR@ks; max_label defaults to the batch-global max (a device tensor)."""
    if max_label is None:
        max_label = torch.max(ideal_sorted_labels)
    sys_err = rankwise_err(pred_sorted_labels, max_label)
    ideal_err = rankwise_err(ideal_sorted_labels, max_label)
    rankwise_nerr = sys_err / torch.clamp(ideal_err, min=_EPS)
    return _take_at_ks(rankwise_nerr, n, ks)


def dcg(sorted_labels: torch.Tensor, label_type: LabelType = LabelType.MultiLabel,
        cumulative: bool = True) -> torch.Tensor:
    """(Cumulative) DCG per position with gain / log2 discounts."""
    n_pos = sorted_labels.shape[-1]
    gains = gain(sorted_labels, label_type)
    discounts = torch.log2(torch.arange(n_pos, dtype=sorted_labels.dtype,
                                        device=sorted_labels.device) + 2.0)
    terms = gains / discounts
    if cumulative:
        return torch.cumsum(terms, dim=-1)
    return torch.sum(terms, dim=-1, keepdim=True)


def ndcg_at_ks(pred_sorted_labels, ideal_sorted_labels, n, ks,
               label_type: LabelType = LabelType.MultiLabel) -> torch.Tensor:
    """nDCG@ks."""
    sys_dcg = dcg(pred_sorted_labels, label_type)
    ideal_dcg = dcg(ideal_sorted_labels, label_type)
    rankwise_ndcg = sys_dcg / torch.clamp(ideal_dcg, min=_EPS)
    return _take_at_ks(rankwise_ndcg, n, ks)


def kendall_tau(sys_ranking: torch.Tensor, natural_ascending_as_reference: bool = True):
    """Kendall tau by inversion counting on a 1-D ranking. Ties not handled."""
    if sys_ranking.dim() != 1:
        raise ValueError(f"kendall_tau takes one 1-D ranking; got {tuple(sys_ranking.shape)}")
    n = sys_ranking.shape[0]
    diffs = sys_ranking[:, None] - sys_ranking[None, :]
    upper = torch.triu(torch.ones((n, n), dtype=torch.bool, device=sys_ranking.device), diagonal=1)
    if natural_ascending_as_reference:
        concordant = torch.where(upper, torch.clamp(diffs, 0.0, 1.0), 0.0)
        return 1.0 - 4.0 * torch.sum(concordant) / (n * (n - 1))
    discordant = torch.where(upper, torch.clamp(diffs, -1.0, 0.0), 0.0)
    return 1.0 + 4.0 * torch.sum(discordant) / (n * (n - 1))


def evaluate_all_at_ks(scores: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                       ks: Tuple[int, ...], label_type: LabelType = LabelType.MultiLabel,
                       max_label=None):
    """nDCG, nERR, AP and P @ks from raw scores in one pass: the sort, the
    gathers and all four metric families stay on the device.

    Returns a dict of [B, len(ks)] tensors plus "n" = real-doc counts [B]."""
    _, pred_sorted, _ = sort_labels_by_scores(scores, labels, mask)
    ideal_sorted = ideal_sorted_labels(labels, mask)
    n = torch.sum(mask, dim=-1)
    return {
        "nDCG": ndcg_at_ks(pred_sorted, ideal_sorted, n, ks, label_type),
        "nERR": nerr_at_ks(pred_sorted, ideal_sorted, n, ks, max_label=max_label),
        "AP": ap_at_ks(pred_sorted, ideal_sorted, n, ks),
        "P": precision_at_ks(pred_sorted, n, ks),
        "n": n,
    }
