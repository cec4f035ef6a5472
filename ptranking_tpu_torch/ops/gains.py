"""Gain conventions and masked softmax helpers, as in ptranking_tpu/ops/gains.py."""

from __future__ import annotations

import torch

from ptranking_tpu_torch import PAD_SCORE
from ptranking_tpu_torch.types import LabelType


def gain(labels: torch.Tensor, label_type: LabelType = LabelType.MultiLabel) -> torch.Tensor:
    """Relevance gain. MultiLabel: 2^label - 1; Permutation: the raw label."""
    if label_type == LabelType.MultiLabel:
        return torch.pow(2.0, labels) - 1.0
    if label_type == LabelType.Permutation:
        return labels
    raise NotImplementedError(label_type)


def masked_softmax(x: torch.Tensor, mask: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Softmax over valid entries only; padded entries get probability 0."""
    out = torch.softmax(torch.where(mask, x, PAD_SCORE), dim=dim)
    return torch.where(mask, out, 0.0)


def masked_log_softmax(x: torch.Tensor, mask: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """log_softmax over valid entries; padded entries are 0 (callers mask products)."""
    out = torch.log_softmax(torch.where(mask, x, PAD_SCORE), dim=dim)
    return torch.where(mask, out, 0.0)
