"""Pointwise losses, as in ptranking_tpu/losses/pointwise.py."""

from __future__ import annotations

import torch

from ptranking_tpu_torch.parallel.collectives import global_count


def rank_mse(scores, labels, mask, **_):
    """Masked MSE: sum over docs, mean over REAL queries (all-padded remainder
    rows of a bucketed batch do not count in the denominator). Under data
    parallelism the count spans every rank's rows, so the ranks' losses add
    up to the global batch's."""
    per_query = torch.sum(torch.where(mask, torch.square(scores - labels), 0.0), dim=-1)
    real = global_count(torch.sum(torch.any(mask, dim=-1).to(per_query.dtype)))
    return torch.sum(per_query) / torch.clamp(real, min=1.0)
