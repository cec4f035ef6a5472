"""WassRank: listwise ranking as entropic optimal transport, as in
ptranking_tpu/losses/wassrank.py.

The Sinkhorn iteration lives in ops/sinkhorn.py (on a CUDA device every
half-step is the kernel of ops/sinkhorn_fused.py). Cost matrices and
histograms are masked so padded documents carry zero mass.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ptranking_tpu_torch.ops import masked_softmax
from ptranking_tpu_torch.ops.sinkhorn import entropic_ot, sinkhorn_distance
from ptranking_tpu_torch.parallel.collectives import global_max, global_min


def cost_mat_positions(labels, mask, exponent: float = 1.0):
    """|pos_i - pos_j|^exponent."""
    n = labels.shape[-1]
    pos = torch.arange(1, n + 1, dtype=labels.dtype, device=labels.device)
    c = torch.abs(pos[:, None] - pos[None, :])
    if exponent > 1.0:
        c = torch.pow(c, exponent)
    return c.expand(*labels.shape, n)


def cost_mat_delta_gains(labels, mask, discount: bool = False):
    """|gain_i - gain_j| (optionally x |disc_i - disc_j|)."""
    gains = torch.pow(2.0, torch.where(mask, labels, 0.0)) - 1.0
    g_diffs = torch.abs(gains[..., :, None] - gains[..., None, :])
    if discount:
        n = labels.shape[-1]
        d = 1.0 / torch.log2(torch.arange(n, dtype=labels.dtype, device=labels.device) + 2.0)
        d_diffs = torch.abs(d[:, None] - d[None, :])
        return g_diffs * d_diffs[None]
    return g_diffs


def cost_mat_group(labels, mask, non_rele_gap: float = 100.0, var_penalty: float = math.e,
                   gain_base: float = 4.0):
    """Relevance-group cost: gains with non-relevant docs pushed to -gap,
    |c_i - c_j| with same-group moves charged var_penalty, zero diagonal."""
    g = torch.pow(gain_base, torch.where(mask, labels, 0.0)) - 1.0
    g = torch.where(g < 1.0, -non_rele_gap, g)
    c = torch.abs(g[..., :, None] - g[..., None, :])
    c = torch.where(c < 1.0, var_penalty, c)
    n = labels.shape[-1]
    return torch.where(torch.eye(n, dtype=torch.bool, device=labels.device)[None], 0.0, c)


def get_cost_mat(labels, mask, cost_type: str = "eg", non_rele_gap: float = 100.0,
                 var_penalty: float = math.e, gain_base: float = 4.0):
    if cost_type == "p1":
        return cost_mat_positions(labels, mask, 1.0)
    if cost_type == "p2":
        return cost_mat_positions(labels, mask, 2.0)
    if cost_type == "eg":
        return cost_mat_group(labels, mask, non_rele_gap, var_penalty, gain_base)
    if cost_type == "dg":
        return cost_mat_delta_gains(labels, mask, discount=False)
    if cost_type == "ddg":
        return cost_mat_delta_gains(labels, mask, discount=True)
    raise NotImplementedError(cost_type)


def std_histogram_st(labels, mask):
    """softmax(labels) over valid docs."""
    return masked_softmax(labels, mask)


def std_histogram_gn(labels, mask, gain_base: float = 2.0):
    """gain / sum(gain)."""
    gains = torch.where(mask, torch.pow(gain_base, labels) - 1.0, 0.0)
    return gains / torch.clamp(torch.sum(gains, dim=-1, keepdim=True), min=1e-12)


def pred_histogram(scores, labels, mask, smooth_type: str = "ST", tl_af: str = "S",
                   max_rele_level: Optional[float] = None):
    """Normalise predictions into a histogram. The batch-global max label and
    min score (over the data-parallel ranks too) stay device tensors: no host
    sync in the step."""
    if smooth_type == "ST":
        if tl_af in ("S", "ST"):  # sigmoid outputs in [0,1]: rescale to label range
            if max_rele_level is None:
                max_rele_level = global_max(torch.max(torch.where(mask, labels, 0.0)))
            scores = scores * max_rele_level
        return masked_softmax(scores, mask)
    elif smooth_type == "NG":
        s = torch.where(mask, scores, 0.0)
        mini = global_min(torch.min(torch.where(mask, scores, float("inf"))))
        s = torch.where(mask, torch.where(mini > 0, s, s - mini), 0.0)
        return s / torch.clamp(torch.sum(s, dim=-1, keepdim=True), min=1e-12)
    raise NotImplementedError(smooth_type)


def wass_rank(scores, labels, mask, mode: str = "SinkhornOT", sh_itr: int = 20,
              lam: float = 0.1, smooth_type: str = "ST", norm_type: str = "BothST",
              cost_type: str = "eg", non_rele_gap: float = 100.0,
              var_penalty: float = math.e, gain_base: float = 4.0,
              tl_af: str = "S", use_pallas: Optional[bool] = None, **_):
    """OT distance between prediction and label histograms under a
    relevance-aware ground cost. use_pallas goes to `sinkhorn_log_scalings`
    (SinkhornOT only): None runs every half-step through the CUDA kernel when
    the scores are on a CUDA device."""
    cost = get_cost_mat(labels, mask, cost_type, non_rele_gap, var_penalty, gain_base)
    if smooth_type == "ST":
        std_hists = std_histogram_st(labels, mask)
    else:
        std_hists = std_histogram_gn(labels, mask)
    pred_hists = pred_histogram(scores, labels, mask, smooth_type, tl_af)

    real = torch.any(mask, dim=-1)  # exclude all-padded remainder rows
    if mode == "SinkhornOT":
        return sinkhorn_distance(pred_hists, std_hists, cost, real, lam, sh_itr, use_pallas)
    elif mode == "EntropicOT":
        loss, _ = entropic_ot(pred_hists, std_hists, cost, eps=lam, max_iters=sh_itr,
                              row_mask=real)
        return loss
    raise NotImplementedError(mode)
