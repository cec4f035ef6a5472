"""Ranker lifecycle (training, predict, checkpoints) and the optimizers."""

from ptranking_tpu_torch.train.optimizer import OptimizerConfig
from ptranking_tpu_torch.train.ranker import AdhocRanker

__all__ = ["OptimizerConfig", "AdhocRanker"]
