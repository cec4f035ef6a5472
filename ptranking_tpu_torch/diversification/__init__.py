"""Search-result diversification (SRD) branch: the port of
ptranking_tpu/diversification, with the JAX package's __all__."""

from ptranking_tpu_torch.diversification.data import (
    DivBatch,
    DivBucketedDataset,
    DivQuery,
    get_div_data_meta,
    load_trec_div_fold,
    make_synthetic_div_queries,
    to_matrix,
)
from ptranking_tpu_torch.diversification.scorers import (
    DivScorerConfig,
    div_forward,
    div_predict,
    expected_ranks,
    init_div_scorer,
)
from ptranking_tpu_torch.diversification.losses import DIV_LOSSES
from ptranking_tpu_torch.diversification.ranker import DIV_MODELS, DivRanker
from ptranking_tpu_torch.diversification.settings import (
    DIV_DEFAULT_PARAS,
    DivCVTape,
    DivDataSetting,
    DivEvalSetting,
    DivModelSetting,
    DivSFSetting,
    DivSummaryTape,
)
from ptranking_tpu_torch.diversification.evaluator import (
    DivLTREvaluator,
    build_topic_map,
    write_div_qrels,
    write_trec_run,
)

__all__ = [
    "DivBatch", "DivBucketedDataset", "DivQuery", "get_div_data_meta",
    "load_trec_div_fold", "make_synthetic_div_queries", "to_matrix",
    "DivScorerConfig", "div_forward", "div_predict", "expected_ranks",
    "init_div_scorer", "DIV_LOSSES", "DIV_MODELS", "DivRanker",
    "DIV_DEFAULT_PARAS", "DivCVTape", "DivDataSetting", "DivEvalSetting",
    "DivModelSetting", "DivSFSetting", "DivSummaryTape",
    "DivLTREvaluator", "build_topic_map", "write_div_qrels", "write_trec_run",
]
