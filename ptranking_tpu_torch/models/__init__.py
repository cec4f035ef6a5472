"""Scorers (pointwise FFN / listwise MHSA encoder), eval form."""

from ptranking_tpu_torch.models.scorers import ScorerConfig, apply_scorer, init_scorer

__all__ = ["ScorerConfig", "init_scorer", "apply_scorer"]
