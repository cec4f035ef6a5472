"""Listwise losses, as in ptranking_tpu/losses/listwise.py: LambdaRank and
ListNet so far (the rest of the zoo comes with a later slice).

Contract shared by every loss: loss(scores, labels, mask, **hyper) -> scalar,
with scores, labels and mask of shape [B, N]. Training batches arrive
PRESORTED (labels descending, pads at the tail), so losses that need the
ideal ranking use `labels` directly. Every loss is mask-invariant: padded
slots and their contents never change the value.
"""

from __future__ import annotations

import torch

from ptranking_tpu_torch.losses.pairwise import _pair_bce_from_logits
from ptranking_tpu_torch.ops import (
    delta_ndcg,
    gain,
    masked_log_softmax,
    masked_softmax,
    pairwise_diffs,
    sort_labels_by_scores,
    triu_pair_mask,
)
from ptranking_tpu_torch.types import LabelType


def _full_dcg(labels, mask, label_type=LabelType.MultiLabel):
    """Whole-list DCG of already-ideal-ordered labels, pads contributing 0."""
    n = labels.shape[-1]
    gains = gain(torch.where(mask, labels, 0.0), label_type)
    discounts = torch.log2(torch.arange(n, dtype=labels.dtype, device=labels.device) + 2.0)
    return torch.sum(torch.where(mask, gains / discounts, 0.0), dim=-1)  # [B]


def lambda_rank(scores, labels, mask, sigma: float = 1.0,
                label_type: LabelType = LabelType.MultiLabel,
                use_pallas: bool = False, **_):
    """RankNet BCE weighted by |DeltaNDCG| of pairwise swaps on the predicted
    order. use_pallas=True routes through the fused pairwise kernel
    (ops/pairwise_fused.py; the name is the JAX package's): O(N) memory
    instead of materialising [B, N, N]."""
    if use_pallas:
        from ptranking_tpu_torch.ops.pairwise_fused import lambda_rank_fused

        return lambda_rank_fused(scores, labels, mask, sigma=sigma, label_type=label_type)
    sorted_scores, pred_sorted_labels, sorted_mask = sort_labels_by_scores(scores, labels, mask)
    logits = sigma * pairwise_diffs(sorted_scores)
    targets = 0.5 * (1.0 + torch.clamp(pairwise_diffs(pred_sorted_labels), -1.0, 1.0))
    weights = delta_ndcg(labels, pred_sorted_labels, sorted_mask, label_type)
    bce = _pair_bce_from_logits(logits, targets) * weights
    return torch.sum(torch.where(triu_pair_mask(sorted_mask), bce, 0.0))


def listnet(scores, labels, mask, **_):
    """Top-1 cross entropy between the label and score softmaxes."""
    p_std = masked_softmax(labels, mask)
    logp = masked_log_softmax(scores, mask)
    return torch.sum(-torch.sum(p_std * logp, dim=-1))
