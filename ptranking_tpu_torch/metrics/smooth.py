"""Differentiable metrics given smooth (expected or approximated) ranks, as in
ptranking_tpu/metrics/smooth.py: P, AP, nERR and nDCG as maximisation
objectives. `smooth_ranks` come from losses/listwise.py::approx_ranks or from
expected ranks under Gaussian uncertainty. Each returns a scalar LOSS (the
negated sum over the batch).

opt_ideal=True scores labels in their given (ideal, presorted) order against
the smooth ranks; opt_ideal=False re-sorts by ascending smooth rank first.
"""

from __future__ import annotations

from typing import Optional

import torch

from ptranking_tpu_torch.metrics.adhoc import rankwise_err
from ptranking_tpu_torch.ops import gain
from ptranking_tpu_torch.types import LabelType

_EPS = 1e-12


def _topk_mask(mask: torch.Tensor, top_k: Optional[int]) -> torch.Tensor:
    if top_k is None:
        return mask
    n = mask.shape[-1]
    return mask & (torch.arange(n, device=mask.device) < min(top_k, n))[None]


def _natural(labels):
    n = labels.shape[-1]
    return torch.arange(1, n + 1, dtype=labels.dtype, device=labels.device)[None]


def _resort(smooth_ranks, labels, mask):
    """Ascending smooth rank with pads last; labels follow."""
    key = torch.where(mask, smooth_ranks, 1e9)
    order = torch.argsort(key, dim=-1, stable=True)
    return (torch.gather(key, -1, order),
            torch.gather(torch.where(mask, labels, 0.0), -1, order),
            torch.gather(mask, -1, order))


def precision_as_objective(smooth_ranks, labels, mask, top_k=None, opt_ideal: bool = True, **_):
    """sum_i natural_rank_i / smooth_rank_i * bin_label_i / k, negated."""
    if not opt_ideal:
        smooth_ranks, labels, mask = _resort(smooth_ranks, labels, mask)
    bins = torch.clamp(labels, 0.0, 1.0)
    sel = _topk_mask(mask, top_k)
    denom = top_k if top_k is not None else torch.clamp(torch.sum(mask, -1), min=1)
    ratio = _natural(labels) / torch.clamp(smooth_ranks, min=_EPS)
    prec = torch.sum(torch.where(sel, ratio * bins, 0.0), -1) / denom
    return -torch.sum(prec)


def ap_as_objective(smooth_ranks, labels, mask, top_k=None, opt_ideal: bool = True, **_):
    """Smooth AP: the mean over relevant docs of (# relevant at-or-above /
    smooth rank)."""
    natural = _natural(labels)
    if opt_ideal:
        # AP = sum_i cumsum_j<=i(natural_j/smooth_j)/natural_i * bin_i / #rele
        bins = torch.where(mask, torch.clamp(labels, 0.0, 1.0), 0.0)
        cum = torch.cumsum(
            torch.where(mask, natural / torch.clamp(smooth_ranks, min=_EPS), 0.0), -1)
        rankwise_pre = cum / natural
        sel = _topk_mask(mask, top_k)
        terms = torch.where(sel, rankwise_pre * bins, 0.0)
        denom = torch.clamp(torch.sum(torch.where(sel, bins, 0.0), -1), min=1.0)
        return -torch.sum(torch.sum(terms, -1) / denom)
    smooth_ranks, labels, mask = _resort(smooth_ranks, labels, mask)
    bins = torch.where(mask, torch.clamp(labels, 0.0, 1.0), 0.0)
    cum_rele = torch.cumsum(bins, dim=-1)
    sel = _topk_mask(mask, top_k)
    terms = torch.where(sel, cum_rele / torch.clamp(smooth_ranks, min=_EPS) * bins, 0.0)
    denom = torch.clamp(torch.sum(torch.where(sel, bins, 0.0), -1), min=1.0)
    return -torch.sum(torch.sum(terms, -1) / denom)


def nerr_as_objective(smooth_ranks, labels, mask, top_k=None, max_label=None,
                      opt_ideal: bool = True, **_):
    """Smooth nERR: cascade ERR with 1/smooth_rank in place of 1/position,
    normalised by the ideal ERR."""
    if max_label is None:
        max_label = torch.max(torch.where(mask, labels, 0.0))
    max_label = torch.as_tensor(max_label, dtype=labels.dtype, device=labels.device)
    # the ideal ERR comes from the PRESORTED labels, before any resort
    k = top_k if top_k is not None else labels.shape[-1]
    ideal = rankwise_err(torch.where(mask, labels, 0.0), max_label)[
        ..., min(k, labels.shape[-1]) - 1]
    if not opt_ideal:
        smooth_ranks, labels, mask = _resort(smooth_ranks, labels, mask)
    labels = torch.where(mask, labels, 0.0)
    satis = (torch.pow(2.0, labels) - 1.0) / torch.pow(2.0, max_label)
    unsatis = torch.where(mask, 1.0 - satis, 1.0)
    cum_unsatis = torch.cumprod(unsatis, dim=-1)
    cascade = torch.cat([torch.ones_like(cum_unsatis[..., :1]), cum_unsatis[..., :-1]], -1)
    sel = _topk_mask(mask, top_k)
    err = torch.sum(
        torch.where(sel, satis * cascade / torch.clamp(smooth_ranks, min=_EPS), 0.0), -1)
    return -torch.sum(err / torch.clamp(ideal, min=_EPS))


def ndcg_as_objective(smooth_ranks, labels, mask, top_k=None,
                      label_type: LabelType = LabelType.MultiLabel, opt_ideal: bool = True, **_):
    """Smooth nDCG: gains / log2(smooth_rank + 1) / IDCG."""
    n = labels.shape[-1]
    idcg_gains = gain(torch.where(mask, labels, 0.0), label_type)
    discounts = torch.log2(torch.arange(n, dtype=labels.dtype, device=labels.device) + 2.0)
    idcg = torch.clamp(torch.sum(torch.where(mask, idcg_gains / discounts, 0.0), -1), min=_EPS)
    if not opt_ideal:
        smooth_ranks, labels, mask = _resort(smooth_ranks, labels, mask)
    gains = gain(torch.where(mask, labels, 0.0), label_type)
    sel = _topk_mask(mask, top_k)
    dcg = torch.sum(
        torch.where(sel, gains / torch.log2(torch.clamp(smooth_ranks, min=_EPS) + 1.0), 0.0), -1)
    return -torch.sum(dcg / idcg)


SMOOTH_OBJECTIVES = {
    "P": precision_as_objective,
    "AP": ap_as_objective,
    "nERR": nerr_as_objective,
    "nDCG": ndcg_as_objective,
}
