"""The tree branch: LightGBM LambdaMART when LightGBM is installed, else the
native GBDT (tree/gbdt.py) growing its trees on the card, and the custom
ranking objectives. Counterpart of ptranking_tpu/tree/."""

from ptranking_tpu_torch.tree.evaluator import LTR_TREE_MODELS, TreeLTREvaluator, cal_metric_at_ks
from ptranking_tpu_torch.tree.gbdt import GBDTConfig, GBDTRanker, gbdt_from_jax
from ptranking_tpu_torch.tree.lambdamart import (
    DEFAULT_LIGHTGBM_PARAS,
    HAS_LIGHTGBM,
    LightGBMLambdaMART,
    load_libsvm,
    queries_to_flat,
    save_libsvm,
)
from ptranking_tpu_torch.tree.objectives import (
    CUSTOM_OBJECTIVES,
    custom_obj_lambdarank,
    custom_obj_listnet,
    custom_obj_ranknet,
    per_query_grad_hess_lambda,
    per_query_grad_hess_listnet,
)
from ptranking_tpu_torch.tree.settings import TreeDataSetting, TreeEvalSetting, TreeModelSetting

__all__ = [
    "CUSTOM_OBJECTIVES", "custom_obj_lambdarank", "custom_obj_listnet",
    "custom_obj_ranknet", "per_query_grad_hess_lambda", "per_query_grad_hess_listnet",
    "DEFAULT_LIGHTGBM_PARAS", "HAS_LIGHTGBM", "LightGBMLambdaMART",
    "load_libsvm", "queries_to_flat", "save_libsvm",
    "GBDTConfig", "GBDTRanker", "gbdt_from_jax",
    "TreeDataSetting", "TreeEvalSetting", "TreeModelSetting",
    "LTR_TREE_MODELS", "TreeLTREvaluator", "cal_metric_at_ks",
]
