"""Experiment orchestration: settings, tapes and the k-fold CV evaluator."""

from ptranking_tpu_torch.eval.evaluator import LTR_ADHOC_MODELS, LTREvaluator
from ptranking_tpu_torch.eval.settings import DataSetting, EvalSetting, ModelSetting, SFSetting
from ptranking_tpu_torch.eval.tapes import CVTape, OptLossTape, SummaryTape, ValidationTape

__all__ = [
    "DataSetting", "EvalSetting", "ModelSetting", "SFSetting",
    "CVTape", "OptLossTape", "SummaryTape", "ValidationTape",
    "LTR_ADHOC_MODELS", "LTREvaluator",
]
