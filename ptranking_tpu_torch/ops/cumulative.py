"""Cumulative log-sum-exp (the ListMLE workhorse), as in
ptranking_tpu/ops/cumulative.py: a flip-cumsum that autograd differentiates."""

from __future__ import annotations

import torch

from ptranking_tpu_torch import PAD_SCORE


def logcumsumexp_reverse(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """out[b, i] = log(sum_{j >= i, mask_j} exp(x[b, j])), padded entries excluded.

    Padded entries may appear anywhere; they add 0 to every sum. The row's
    max is subtracted before the exp, and the sum is floored at 1e-30."""
    neg = torch.where(mask, x, PAD_SCORE)
    m = torch.amax(neg, dim=-1, keepdim=True)
    y = torch.where(mask, torch.exp(neg - m), 0.0)
    rev_cumsum = torch.flip(torch.cumsum(torch.flip(y, (-1,)), dim=-1), (-1,))
    return torch.log(torch.clamp(rev_cumsum, min=1e-30)) + m
