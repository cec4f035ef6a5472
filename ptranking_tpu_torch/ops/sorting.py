"""Masked sorting and gathering, as in ptranking_tpu/ops/sorting.py.

All on the tensors' own device: sorts are `torch.sort`/`torch.argsort` and
gathers are `torch.gather`, through which gradients flow to the scores.
"""

from __future__ import annotations

from typing import Optional

import torch

from ptranking_tpu_torch import PAD_SCORE
from ptranking_tpu_torch.parallel.collectives import batch_rand


def mask_scores(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Replace padded entries with a large-negative sentinel (pads sort last)."""
    return torch.where(mask, scores, PAD_SCORE)


def sort_labels_by_scores(scores: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor):
    """Sort each list by predicted score descending (stable); pads go to the tail.

    Returns (sorted_scores, labels_in_predicted_order, sorted_mask)."""
    masked = mask_scores(scores, mask)
    order = torch.argsort(-masked, dim=-1, stable=True)
    sorted_scores = torch.gather(masked, -1, order)
    sorted_labels = torch.gather(torch.where(mask, labels, 0.0), -1, order)
    sorted_mask = torch.gather(mask, -1, order)
    return sorted_scores, sorted_labels, sorted_mask


def ideal_sorted_labels(labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Labels sorted descending with pads forced to the tail (ideal ranking)."""
    key = torch.where(mask, labels, PAD_SCORE)
    out = -torch.sort(-key, dim=-1).values
    return torch.where(out <= PAD_SCORE, 0.0, out)


def shuffle_ties_argsort(gen: Optional[torch.Generator], labels: torch.Tensor,
                         mask: torch.Tensor, descending: bool = True,
                         noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Indices sorting labels (descending by default) with ties broken
    uniformly at random; pads last. The tie-breaking uniform draws come from
    `gen` (a generator on the labels' device), or are `noise` itself (of the
    labels' shape) when given. A lexicographic sort on (label, noise): a sort
    by the noise, then a stable sort by the label."""
    sign = -1.0 if descending else 1.0
    if noise is None:
        noise = batch_rand(labels.shape, gen, labels.device)
    # pads always sort last: the ascending sort needs them at +inf-like keys
    primary = torch.where(mask, sign * labels, -PAD_SCORE)
    by_noise = torch.argsort(noise, dim=-1, stable=True)
    by_label = torch.argsort(torch.gather(primary, -1, by_noise), dim=-1, stable=True)
    return torch.gather(by_noise, -1, by_label)
