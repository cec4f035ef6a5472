"""Diversification losses: DALETOR and the DivProbRanker family.

The port's copy of ptranking_tpu/diversification/losses.py: pure functions
over (mus, vars, cocos | scores, rele_mat, doc_mask), plain torch on the
tensors' device (the JAX package computes them outside any Pallas kernel).
All take the coverage matrix in IDEAL order (presorted). Shapes: scores,
mus, vars [B, N]; rele_mat [B, S, N]; doc_mask [B, N] bool.

Where the JAX package takes `jnp.maximum` or `jnp.clip` of a value that
carries a gradient, this module takes `torch.maximum` / `torch.minimum`,
which, like JAX, split the gradient on a tie (`torch.clamp` passes all of
it). The `opt_ideal=False` re-sorts are stable argsorts with 1e9 on the
pads; the simplex projection sorts ascending and reverses, as JAX does.
"""

from __future__ import annotations

from typing import Optional

import torch

from ptranking_tpu_torch.diversification.scorers import expected_ranks
from ptranking_tpu_torch.metrics.srd import delta_alpha_dcg
from ptranking_tpu_torch.ops import robust_sigmoid

_EPS = 1e-8


def _max(x: torch.Tensor, v: float) -> torch.Tensor:
    # new_full fills on the device: no host->device copy, no stream sync
    return torch.maximum(x, x.new_full((), v))


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return torch.minimum(_max(x, lo), x.new_full((), hi))


def _pair_mask(doc_mask):
    return doc_mask[..., :, None] & doc_mask[..., None, :]


def _triu(n, device):
    i = torch.arange(n, device=device)
    return i[:, None] < i[None, :]


def _topk_mask(n: int, top_k: int, device) -> torch.Tensor:
    return torch.arange(n, device=device) < min(top_k, n)


def _resort_rows(order: torch.Tensor, *mats):
    """Re-order each [B, ..., N] tensor's last axis by order [B, N]."""
    out = []
    for m in mats:
        idx = order.reshape(order.shape[0], *([1] * (m.dim() - 2)), order.shape[-1])
        out.append(torch.gather(m, -1, idx.expand(m.shape)))
    return out


def _resort_square(order: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """m[b, order[b, i], order[b, j]] for m [B, N, N]."""
    B, N = order.shape
    m = torch.gather(m, -1, order[:, None, :].expand(B, N, N))
    return torch.gather(m, -2, order[:, :, None].expand(B, N, N))


def _order_by_ranks(ranks, doc_mask):
    return torch.argsort(torch.where(doc_mask, ranks, 1e9), dim=-1, stable=True)


# --------------------------------------------------------------- DALETOR


def daletor_loss(scores, rele_mat, doc_mask, rt: float = 10.0, top_k: Optional[int] = 10,
                 alpha: float = 0.5, **_):
    """Smooth alpha-DCG via approximated ranks and smooth prior cover counts.
    Maximised (returns -DCG)."""
    B, S, N = rele_mat.shape
    rele_mat = rele_mat * doc_mask[:, None, :]
    diffs = scores[..., :, None] - scores[..., None, :]  # s_i - s_j
    indicators = robust_sigmoid(-diffs, rt)  # sigma(rt (s_j - s_i)) [B, N, N]
    indicators = torch.where(_pair_mask(doc_mask), indicators, 0.0)
    hat_pis = torch.sum(indicators, dim=-1) + 0.5  # [B, N]
    # prior cover counts: sum_j sigma_ij * rele[s, j] - rele[s, i] / 2
    cover = torch.einsum("bij,bsj->bsi", indicators, rele_mat) - rele_mat / 2.0
    per_subtopic = (rele_mat * torch.pow(1.0 - alpha, cover)
                    / torch.log2(1.0 + hat_pis)[:, None, :])
    global_gains = torch.sum(per_subtopic, dim=1)  # [B, N]
    if top_k is not None:
        global_gains = torch.where(_topk_mask(N, top_k, scores.device)[None], global_gains, 0.0)
    return -torch.sum(torch.where(doc_mask, global_gains, 0.0))


# ------------------------------------------------ SuperSoft (expected ranks)


def alpha_dcg_expected_loss(mus, vars_, rele_mat, doc_mask, cocos=None,
                            top_k: Optional[int] = 10, alpha: float = 0.5,
                            opt_ideal: bool = True, **_):
    """alpha-DCG with Gaussian expected ranks and Phi0 prior-cover counts;
    opt_ideal=False re-orders by expected rank first."""
    B, S, N = rele_mat.shape
    rele_mat = rele_mat * doc_mask[:, None, :]
    ranks, phi0, _, _ = expected_ranks(mus, vars_, doc_mask, cocos)
    offdiag = ~torch.eye(N, dtype=torch.bool, device=mus.device)
    indicators = torch.where(_pair_mask(doc_mask) & offdiag, phi0, 0.0)
    if not opt_ideal:
        order = _order_by_ranks(ranks, doc_mask)
        ranks, rele_mat, doc_mask = _resort_rows(order, ranks, rele_mat, doc_mask)
        indicators = _resort_square(order, indicators)
    cover = torch.einsum("bij,bsj->bsi", indicators, rele_mat)
    per_subtopic = rele_mat * torch.pow(1.0 - alpha, cover) / torch.log2(1.0 + ranks)[:, None, :]
    global_gains = torch.sum(per_subtopic, dim=1)
    if top_k is not None:
        global_gains = torch.where(_topk_mask(N, top_k, mus.device)[None], global_gains, 0.0)
    return -torch.sum(torch.where(doc_mask, global_gains, 0.0))


def err_ia_expected_loss(mus, vars_, rele_mat, doc_mask, cocos=None,
                         top_k: Optional[int] = 10, max_label: float = 1.0,
                         opt_ideal: bool = True, **_):
    """ERR-IA with 1/E[rank] reciprocal ranks."""
    B, S, N = rele_mat.shape
    rele_mat = rele_mat * doc_mask[:, None, :]
    ranks = expected_ranks(mus, vars_, doc_mask, cocos)[0]
    if not opt_ideal:
        order = _order_by_ranks(ranks, doc_mask)
        ranks, rele_mat, doc_mask = _resort_rows(order, ranks, rele_mat, doc_mask)
    satis = (torch.pow(2.0, rele_mat) - 1.0) / (2.0 ** max_label)
    unsatis = torch.where(doc_mask[:, None, :], 1.0 - satis, 1.0)
    cum_unsatis = torch.cumprod(unsatis, dim=-1)
    cascade = torch.cat([torch.ones_like(cum_unsatis[..., :1]), cum_unsatis[..., :-1]], dim=-1)
    expt = satis * cascade / _max(ranks, _EPS)[:, None, :]
    if top_k is not None:
        expt = torch.where(_topk_mask(N, top_k, mus.device)[None, None], expt, 0.0)
    expt = torch.where(doc_mask[:, None, :], expt, 0.0)
    return -torch.sum(torch.sum(expt, dim=(-2, -1)) / S)


# ------------------------------------------- probabilistic pairwise losses


def _prob_pairwise_probs(mus, vars_, rele_mat, doc_mask, cocos=None):
    """p_ij = 1 - 0.5 erfc(pairsub_mu / sqrt(2 pairsub_var)); the targets
    average the per-subtopic {0, .5, 1} preferences over subtopics."""
    _, _, pairsub_mus, pairsub_vars = expected_ranks(mus, vars_, doc_mask, cocos)
    p_ij = 1.0 - 0.5 * torch.special.erfc(pairsub_mus / torch.sqrt(2.0 * pairsub_vars))
    sub_diffs = torch.clamp(rele_mat[..., :, None] - rele_mat[..., None, :], -1.0, 1.0)
    std_p_ij = torch.mean(0.5 * (1.0 + sub_diffs), dim=-3)  # mean over subtopics
    return p_ij, std_p_ij


def prob_pair_cls_loss(mus, vars_, rele_mat, doc_mask, cocos=None,
                       opt_id: str = "PairCLS", opt_ideal: bool = True,
                       norm: bool = True, alpha: float = 0.5, **_):
    """PairCLS / LambdaPairCLS: BCE over upper-triangular pairs, LambdaPairCLS
    weighted by |Delta alpha-DCG| of the (ideal or re-sorted) order."""
    B, S, N = rele_mat.shape
    rele_mat = rele_mat * doc_mask[:, None, :]
    if opt_id == "LambdaPairCLS" and not opt_ideal:
        ranks = expected_ranks(mus, vars_, doc_mask, cocos)[0]
        order = _order_by_ranks(ranks, doc_mask)
        mus, vars_, sys_rele, doc_mask = _resort_rows(order, mus, vars_, rele_mat, doc_mask)
        if cocos is not None:
            cocos = _resort_square(order, cocos)
    else:
        sys_rele = rele_mat
    p_ij, std_p_ij = _prob_pairwise_probs(mus, vars_, sys_rele, doc_mask, cocos)
    bce = -(std_p_ij * torch.log(_clip(p_ij, _EPS, 1.0))
            + (1.0 - std_p_ij) * torch.log(_clip(1.0 - p_ij, _EPS, 1.0)))
    sel = _pair_mask(doc_mask) & _triu(N, mus.device)[None]
    if opt_id == "LambdaPairCLS":
        bce = bce * delta_alpha_dcg(rele_mat, sys_rele, doc_mask, alpha, normalization=norm)
    return torch.sum(torch.where(sel, bce, 0.0))


# --------------------------------------------------------------- Portfolio


def _project_simplex(w, doc_mask):
    """Exact Euclidean projection of each row onto the masked probability
    simplex {w >= 0, sum over real docs = 1} (the sort-based algorithm of
    Held, Wolfe and Crowder). Differentiable a.e.; pads come out zero."""
    N = w.shape[-1]
    wm = torch.where(doc_mask > 0, w, -1e9)
    u = torch.sort(wm, dim=-1, stable=True).values.flip(-1)  # descending
    css = torch.cumsum(u, dim=-1) - 1.0
    j = torch.arange(1, N + 1, dtype=w.dtype, device=w.device)
    cond = (u - css / j) > 0  # the active set
    rho = torch.clamp(torch.sum(cond, dim=-1) - 1, min=0)  # [B]
    theta = torch.gather(css, -1, rho[..., None]) / (rho[..., None].to(w.dtype) + 1.0)
    return _max(w - theta, 0.0) * doc_mask


def portfolio_weights(mus, vars_, doc_mask, cocos=None, alpha_reg: float = 0.01,
                      gamma: float = 0.1, n_qp_iters: int = 50,
                      lr: float = 0.1) -> torch.Tensor:
    """The mean-variance QP
        max_w  mus.w - ||gamma Cov w||^2 - alpha ||w||^2
        s.t.   sum w = 1, 0 <= w <= 1
    solved by n_qp_iters steps of projected gradient ascent with the exact
    simplex projection, a plain loop that autograd goes through."""
    B, N = mus.shape
    if cocos is None:
        cov = torch.eye(N, dtype=mus.dtype, device=mus.device)[None] * vars_[..., None]
    else:
        std = torch.sqrt(_max(vars_, _EPS))
        cov = cocos * std[..., :, None] * std[..., None, :]
    covg = gamma * cov
    m = doc_mask.to(mus.dtype)
    w = m / _max(torch.sum(m, dim=-1, keepdim=True), _EPS)
    for _ in range(n_qp_iters):
        cw = torch.einsum("bij,bj->bi", covg, w)
        grad = mus - 2.0 * torch.einsum("bij,bj->bi", covg, cw) - 2.0 * alpha_reg * w
        w = _project_simplex(w + lr * grad * m, m)
    return w


def portfolio_loss(mus, vars_, rele_mat, doc_mask, cocos=None, rt: float = 10.0,
                   top_k: Optional[int] = 10, alpha_reg: float = 0.01,
                   gamma: float = 0.1, n_qp_iters: int = 50, **_):
    """Mean-variance portfolio weights (portfolio_weights), then the DALETOR
    loss on the weights."""
    w = portfolio_weights(mus, vars_, doc_mask, cocos,
                          alpha_reg=alpha_reg, gamma=gamma, n_qp_iters=n_qp_iters)
    return daletor_loss(w, rele_mat, doc_mask, rt=rt, top_k=top_k)


DIV_LOSSES = {
    "DALETOR": daletor_loss,
    # DivProbRanker opt_ids
    "SuperSoft-aNDCG": alpha_dcg_expected_loss,
    "SuperSoft-nERR-IA": err_ia_expected_loss,
    "PairCLS": prob_pair_cls_loss,
    "LambdaPairCLS": prob_pair_cls_loss,
    "Portfolio": portfolio_loss,
}
