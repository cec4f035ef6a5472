"""On-device adhoc IR metrics (masked, batched), as in
ptranking_tpu/metrics/__init__.py."""

from ptranking_tpu_torch.metrics.adhoc import (
    ap_at_ks,
    dcg,
    evaluate_all_at_ks,
    kendall_tau,
    ndcg_at_ks,
    nerr_at_ks,
    precision_at_ks,
    rankwise_err,
)

__all__ = [
    "precision_at_ks",
    "ap_at_ks",
    "nerr_at_ks",
    "ndcg_at_ks",
    "dcg",
    "rankwise_err",
    "kendall_tau",
    "evaluate_all_at_ks",
]
