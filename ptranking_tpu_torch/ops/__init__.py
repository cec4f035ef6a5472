"""Masked ranking primitives, as in ptranking_tpu/ops/__init__.py. The
Sinkhorn iterations (ops/sinkhorn.py) and the kernels' wrappers
(ops/attention.py, ops/pairwise_fused.py, ops/sinkhorn_fused.py) are imported
from their own modules."""

from ptranking_tpu_torch.ops.cumulative import logcumsumexp_reverse
from ptranking_tpu_torch.ops.gains import gain, masked_log_softmax, masked_softmax
from ptranking_tpu_torch.ops.pairwise import (
    delta_ndcg,
    pair_mask,
    pairwise_comp_probs,
    pairwise_diffs,
    triu_pair_mask,
)
from ptranking_tpu_torch.ops.sigmoid import robust_sigmoid, vanilla_sigmoid
from ptranking_tpu_torch.ops.sorting import (
    ideal_sorted_labels,
    mask_scores,
    shuffle_ties_argsort,
    sort_labels_by_scores,
)

__all__ = [
    "pairwise_diffs",
    "pair_mask",
    "triu_pair_mask",
    "pairwise_comp_probs",
    "delta_ndcg",
    "mask_scores",
    "sort_labels_by_scores",
    "ideal_sorted_labels",
    "shuffle_ties_argsort",
    "gain",
    "masked_softmax",
    "masked_log_softmax",
    "robust_sigmoid",
    "vanilla_sigmoid",
    "logcumsumexp_reverse",
]
