"""Adversarial LTR branch (IRGAN / IRFGAN): the port of
ptranking_tpu/adversarial, with the JAX package's __all__."""

from ptranking_tpu_torch.adversarial.base import AdversarialMachine, AdversarialPlayer
from ptranking_tpu_torch.adversarial.util import (
    F_DIVERGENCES,
    get_f_divergence_functions,
    log_ranking_prob_bt,
    log_ranking_prob_pl,
    sample_categorical_masked,
)
from ptranking_tpu_torch.adversarial.irgan import IRGAN_List, IRGAN_Pair, IRGAN_Point
from ptranking_tpu_torch.adversarial.irfgan import IRFGAN_List, IRFGAN_Pair, IRFGAN_Point
from ptranking_tpu_torch.adversarial.settings import (
    AD_DEFAULT_PARAS,
    AD_MODEL_GRIDS,
    AdDataSetting,
    AdEvalSetting,
    AdModelSetting,
    AdSFSetting,
)
from ptranking_tpu_torch.adversarial.evaluator import (
    AD_MACHINES,
    LTR_ADVERSARIAL_MODELS,
    AdLTREvaluator,
)

__all__ = [
    "AdversarialMachine", "AdversarialPlayer", "F_DIVERGENCES",
    "get_f_divergence_functions", "log_ranking_prob_bt", "log_ranking_prob_pl",
    "sample_categorical_masked", "IRGAN_List", "IRGAN_Pair", "IRGAN_Point",
    "IRFGAN_List", "IRFGAN_Pair", "IRFGAN_Point", "AD_DEFAULT_PARAS",
    "AD_MODEL_GRIDS", "AdDataSetting", "AdEvalSetting", "AdModelSetting",
    "AdSFSetting", "AD_MACHINES", "LTR_ADVERSARIAL_MODELS", "AdLTREvaluator",
]
