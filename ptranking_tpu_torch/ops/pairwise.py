"""Masked pairwise primitives for the pairwise and listwise losses, as in
ptranking_tpu/ops/pairwise.py. They materialise [B, N, N]; the fused kernel
of ops/pairwise_fused.py computes the pairwise lambda loss without it."""

from __future__ import annotations

import torch

from ptranking_tpu_torch.ops.gains import gain
from ptranking_tpu_torch.types import LabelType


def pairwise_diffs(x: torch.Tensor) -> torch.Tensor:
    """[B, N] -> [B, N, N] with out[b, i, j] = x[b, i] - x[b, j]."""
    return x[..., :, None] - x[..., None, :]


def pair_mask(mask: torch.Tensor) -> torch.Tensor:
    """[B, N] bool -> [B, N, N] bool; True where both docs are real."""
    return mask[..., :, None] & mask[..., None, :]


def triu_pair_mask(mask: torch.Tensor) -> torch.Tensor:
    """Valid strictly-upper-triangular pairs (i < j), both docs real."""
    n = mask.shape[-1]
    i = torch.arange(n, device=mask.device)
    return pair_mask(mask) & (i[:, None] < i[None, :])


def pairwise_comp_probs(scores: torch.Tensor, labels: torch.Tensor, sigma: float = 1.0):
    """p_ij = sigmoid(sigma * (s_i - s_j)) and std_p_ij = (1 + clamp(l_i - l_j, -1, 1)) / 2.
    Unmasked: callers apply a pair mask."""
    p_ij = torch.sigmoid(sigma * pairwise_diffs(scores))
    std_p_ij = 0.5 * (1.0 + torch.clamp(pairwise_diffs(labels), -1.0, 1.0))
    return p_ij, std_p_ij


def delta_ndcg(ideal_labels: torch.Tensor, pred_sorted_labels: torch.Tensor,
               mask: torch.Tensor, label_type: LabelType = LabelType.MultiLabel) -> torch.Tensor:
    """|Delta nDCG| of swapping each pair of the predicted ranking:
    delta[b, i, j] = |g_i - g_j| / IDCG * |1/log2(i+2) - 1/log2(j+2)|, 0 on
    pairs with a padded document. Labels of both orders have pads last."""
    n = ideal_labels.shape[-1]
    gains = gain(torch.where(mask, ideal_labels, 0.0), label_type)
    discounts = 1.0 / torch.log2(
        torch.arange(n, dtype=ideal_labels.dtype, device=ideal_labels.device) + 2.0)
    idcg = torch.clamp(torch.sum(gains * discounts * mask, dim=-1, keepdim=True), min=1e-12)
    n_gains = gain(torch.where(mask, pred_sorted_labels, 0.0), label_type) / idcg
    delta = torch.abs(pairwise_diffs(n_gains)) * torch.abs(pairwise_diffs(discounts))[None]
    return torch.where(pair_mask(mask), delta, 0.0)
