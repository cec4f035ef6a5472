"""Sigma-scaled sigmoids, as in ptranking_tpu/ops/sigmoid.py. `torch.sigmoid`
is overflow-safe and autograd gives sigma * s * (1 - s), so both names are the
same plain sigmoid."""

from __future__ import annotations

import torch


def robust_sigmoid(x: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    """Overflow-safe sigmoid(sigma * x)."""
    return torch.sigmoid(sigma * x)


def vanilla_sigmoid(x: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    """sigmoid(sigma * x)."""
    return torch.sigmoid(sigma * x)
