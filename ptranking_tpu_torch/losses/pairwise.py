"""Pairwise losses (RankNet family), as in ptranking_tpu/losses/pairwise.py.

BCE terms come from logits through softplus, stable where probabilities
would be clamped."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ptranking_tpu_torch.ops import pairwise_diffs, triu_pair_mask


def _pair_bce_from_logits(logits, targets):
    """BCE(sigmoid(x), t) = softplus(x) - t*x, elementwise."""
    return F.softplus(logits) - targets * logits


def ranknet(scores, labels, mask, sigma: float = 1.0, use_pallas: bool = False, **_):
    """Pairwise logistic loss over valid i<j pairs, summed: p_ij =
    sigmoid(sigma*(s_i - s_j)), target (1 + clamp(l_i - l_j, -1, 1))/2.
    use_pallas routes through the fused pairwise kernel
    (ops/pairwise_fused.py; the name is the JAX package's)."""
    if use_pallas:
        from ptranking_tpu_torch.ops.pairwise_fused import ranknet_fused

        return ranknet_fused(scores, labels, mask, sigma=sigma)
    logits = sigma * pairwise_diffs(scores)
    targets = 0.5 * (1.0 + torch.clamp(pairwise_diffs(labels), -1.0, 1.0))
    bce = _pair_bce_from_logits(logits, targets)
    return torch.sum(torch.where(triu_pair_mask(mask), bce, 0.0))
