"""Listwise losses, as in ptranking_tpu/losses/listwise.py: LambdaRank,
ListNet, STListNet, ListMLE, RankCosine, ApproxNDCG, LambdaLoss, SoftRank,
MDPRank and NeuralNDCG.

Contract shared by every loss: loss(scores, labels, mask, **hyper) -> scalar,
with scores, labels and mask of shape [B, N]. Training batches arrive
PRESORTED (labels descending, pads at the tail), so losses that need the
ideal ranking use `labels` directly. Every loss is mask-invariant: padded
slots and their contents never change the value.

The stochastic losses (STListNet, ListMLE, MDPRank) draw uniform noise of the
scores' shape from `gen`, a torch.Generator on the scores' device, or take
the draws themselves as `noise` (used in place of `gen` when given: the same
noise gives the JAX package's value).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ptranking_tpu_torch import EPSILON, PAD_SCORE
from ptranking_tpu_torch.losses.pairwise import _pair_bce_from_logits
from ptranking_tpu_torch.ops import (
    delta_ndcg,
    gain,
    logcumsumexp_reverse,
    masked_log_softmax,
    masked_softmax,
    pair_mask,
    pairwise_diffs,
    robust_sigmoid,
    shuffle_ties_argsort,
    sort_labels_by_scores,
    triu_pair_mask,
)
from ptranking_tpu_torch.parallel.collectives import batch_rand
from ptranking_tpu_torch.types import LabelType

_GUMBEL_EPS = 1e-20


def _uniform(scores, gen, noise, who):
    """The loss's uniform draws: `noise` if given, else from `gen`."""
    if noise is not None:
        return noise
    if gen is None:
        raise ValueError(f"{who} is stochastic: pass a torch.Generator as gen, or noise")
    return batch_rand(scores.shape, gen, scores.device)


def _gumbel(unif):
    return -torch.log(-torch.log(unif + _GUMBEL_EPS) + _GUMBEL_EPS)


def _full_dcg(labels, mask, label_type=LabelType.MultiLabel):
    """Whole-list DCG of already-ideal-ordered labels, pads contributing 0."""
    n = labels.shape[-1]
    gains = gain(torch.where(mask, labels, 0.0), label_type)
    discounts = torch.log2(torch.arange(n, dtype=labels.dtype, device=labels.device) + 2.0)
    return torch.sum(torch.where(mask, gains / discounts, 0.0), dim=-1)  # [B]


def lambda_rank(scores, labels, mask, sigma: float = 1.0,
                label_type: LabelType = LabelType.MultiLabel,
                use_pallas: bool = False, **_):
    """RankNet BCE weighted by |DeltaNDCG| of pairwise swaps on the predicted
    order. use_pallas=True routes through the fused pairwise kernel
    (ops/pairwise_fused.py; the name is the JAX package's): O(N) memory
    instead of materialising [B, N, N]."""
    if use_pallas:
        from ptranking_tpu_torch.ops.pairwise_fused import lambda_rank_fused

        return lambda_rank_fused(scores, labels, mask, sigma=sigma, label_type=label_type)
    sorted_scores, pred_sorted_labels, sorted_mask = sort_labels_by_scores(scores, labels, mask)
    logits = sigma * pairwise_diffs(sorted_scores)
    targets = 0.5 * (1.0 + torch.clamp(pairwise_diffs(pred_sorted_labels), -1.0, 1.0))
    weights = delta_ndcg(labels, pred_sorted_labels, sorted_mask, label_type)
    bce = _pair_bce_from_logits(logits, targets) * weights
    return torch.sum(torch.where(triu_pair_mask(sorted_mask), bce, 0.0))


def listnet(scores, labels, mask, **_):
    """Top-1 cross entropy between the label and score softmaxes."""
    p_std = masked_softmax(labels, mask)
    logp = masked_log_softmax(scores, mask)
    return torch.sum(-torch.sum(p_std * logp, dim=-1))


def st_listnet(scores, labels, mask, gen: Optional[torch.Generator] = None,
               temperature: float = 1.0, noise: Optional[torch.Tensor] = None, **_):
    """ListNet on Gumbel-perturbed, temperature-scaled scores."""
    gumbel = _gumbel(_uniform(scores, gen, noise, "st_listnet"))
    return listnet((scores + gumbel) / temperature, labels, mask)


def listmle(scores, labels, mask, gen: Optional[torch.Generator] = None,
            noise: Optional[torch.Tensor] = None, **_):
    """Plackett-Luce NLL over the (tie-shuffled) label order."""
    if gen is None and noise is None:
        raise ValueError("listmle shuffles ties: pass a torch.Generator as gen, or noise")
    order = shuffle_ties_argsort(gen, labels, mask, descending=True, noise=noise)
    s = torch.gather(scores, -1, order)
    m = torch.gather(mask, -1, order)
    lcse = logcumsumexp_reverse(s, m)
    return torch.sum(torch.where(m, lcse - s, 0.0))


def rank_cosine(scores, labels, mask, **_):
    """sum_b (1 - cos(scores_b, labels_b)) / 0.5 over valid docs."""
    s = torch.where(mask, scores, 0.0)
    l = torch.where(mask, labels, 0.0)
    dot = torch.sum(s * l, dim=-1)

    def safe_norm(v):  # sqrt with a zero-safe backward (d sqrt(0) = inf)
        sq = torch.sum(v * v, dim=-1)
        pos = sq > 0
        return torch.where(pos, torch.sqrt(torch.where(pos, sq, 1.0)), 0.0)

    denom = safe_norm(s) * safe_norm(l)
    cos = dot / torch.clamp(denom, min=1e-8)
    real = torch.any(mask, dim=-1)  # all-padded rows must contribute 0, not 2.0
    return torch.sum(torch.where(real, (1.0 - cos) / 0.5, 0.0))


def approx_ranks(scores, mask, alpha: float = 10.0):
    """Smooth ranks pi_i = 0.5 + sum_j sigmoid(alpha*(s_j - s_i)) over valid j
    (the j=i term contributes the remaining 0.5). Padded i get arbitrary
    values: callers mask."""
    diffs = pairwise_diffs(scores)  # s_i - s_j
    indicators = robust_sigmoid(-diffs, alpha)  # sigma(alpha*(s_j - s_i))
    return torch.sum(torch.where(pair_mask(mask), indicators, 0.0), dim=-1) + 0.5


def approx_ndcg(scores, labels, mask, alpha: float = 10.0,
                label_type: LabelType = LabelType.MultiLabel, **_):
    """-sum_b approxNDCG_b with smooth log2(pi+1) discounts, per query
    (labels are the ideal ranking thanks to presort)."""
    hat_pi = approx_ranks(scores, mask, alpha)
    gains = gain(torch.where(mask, labels, 0.0), label_type)
    idcg = torch.clamp(_full_dcg(labels, mask, label_type), min=EPSILON)
    dcg_terms = torch.where(mask, gains / torch.log2(hat_pi + 1.0), 0.0)
    return -torch.sum(torch.sum(dcg_terms, dim=-1) / idcg)


def lambda_loss(scores, labels, mask, loss_type: str = "NDCG_Loss2", k: int = 5,
                sigma: float = 1.0, mu: float = 5.0,
                label_type: LabelType = LabelType.MultiLabel, **_):
    """LambdaLoss framework: power-weighted pairwise log-loss with top-k
    truncation. loss_type in {NDCG_Loss1, NDCG_Loss2, NDCG_Loss2++}. For
    Loss1 the weight is column-aligned, w_ij = nG_j / D_j."""
    N = scores.shape[-1]
    sorted_scores, pred_sorted_labels, sorted_mask = sort_labels_by_scores(scores, labels, mask)
    positions = torch.arange(N, dtype=scores.dtype, device=scores.device)
    inv_discounts = torch.log2(positions + 2.0)  # 1/discounts[r] = log2(r+2)

    idcg = torch.clamp(_full_dcg(labels, mask, label_type), min=EPSILON)  # [B]
    gains = gain(torch.where(sorted_mask, pred_sorted_labels, 0.0), label_type)
    n_gains = gains / idcg[:, None]  # [B, N]

    if loss_type == "NDCG_Loss1":
        weights = (n_gains * inv_discounts)[:, None, :].expand(scores.shape[0], N, N)
    else:
        d = torch.abs(positions[:, None] - positions[None, :])  # |i-j|
        delta_ij = torch.abs(torch.log2(d + 2.0) - torch.log2(d + 1.0))
        delta_ij = torch.where(torch.eye(N, dtype=torch.bool, device=scores.device), 0.0, delta_ij)
        ng_diffs = torch.abs(n_gains[:, :, None] - n_gains[:, None, :])
        if loss_type == "NDCG_Loss2":
            weights = delta_ij[None] * ng_diffs
        elif loss_type == "NDCG_Loss2++":
            rho_ij = torch.abs(inv_discounts[:, None] - inv_discounts[None, :])
            weights = (rho_ij[None] + mu * delta_ij[None]) * ng_diffs
        else:
            raise NotImplementedError(loss_type)

    diffs = torch.clamp(pairwise_diffs(sorted_scores), -1e8, 1e8)
    log_probas = torch.log2(torch.clamp(torch.sigmoid(sigma * diffs), min=EPSILON))
    # the clamp of p^w itself to eps: log2(clamp(p^w, eps)) == max(w*log2(p), log2(eps))
    log_weighted = torch.clamp(weights * log_probas, min=math.log2(EPSILON))

    trunc = (positions[:, None] < k) & (positions[None, :] < k)
    select = trunc[None] & pair_mask(sorted_mask)
    if loss_type in ("NDCG_Loss2", "NDCG_Loss2++"):
        select = select & (pairwise_diffs(pred_sorted_labels) > 0)
    return -torch.sum(torch.where(select, log_weighted, 0.0))


def soft_rank(scores, labels, mask, delta: float = 1.0, top_k: Optional[int] = None,
              label_type: LabelType = LabelType.MultiLabel, **_):
    """Expected nDCG under Gaussian score uncertainty: expected ranks from
    pairwise Phi(0) = 0.5*erfc(dmu / sqrt(2*2*delta^2)), discount
    1/log2(E[rank]+1)."""
    pairsub_var = 2.0 * delta * delta
    diffs = pairwise_diffs(scores)
    phi0 = 0.5 * torch.special.erfc(diffs / math.sqrt(2.0 * pairsub_var))
    N = scores.shape[-1]
    offdiag = ~torch.eye(N, dtype=torch.bool, device=scores.device)
    valid = pair_mask(mask) & offdiag[None]
    expt_ranks = torch.sum(torch.where(valid, phi0, 0.0), dim=-1) + 1.0

    gains = gain(torch.where(mask, labels, 0.0), label_type)
    dists = 1.0 / torch.log2(expt_ranks + 1.0)
    idcg = torch.clamp(_full_dcg(labels, mask, label_type), min=EPSILON)
    terms = torch.where(mask, dists * gains, 0.0)
    if top_k is not None:
        kmask = torch.arange(N, device=scores.device) < min(top_k, N)
        terms = torch.where(kmask[None], terms, 0.0)
    return -torch.sum(torch.sum(terms, dim=-1) / idcg)


def mdp_rank(scores, labels, mask, gen: Optional[torch.Generator] = None,
             distribution: str = "PL", temperature: float = 1.0, gamma: float = 1.0,
             top_k: Optional[int] = None, noise: Optional[torch.Tensor] = None, **_):
    """Policy gradient over sampled rankings: reward = DCG terms, return-to-go
    weighting x Plackett-Luce NLL. Rankings are sampled by the Gumbel-argsort
    trick: argsort(logits + Gumbel) ~ PL(softmax(logits)). 'PL' scores the
    original predictions in sample order; 'STPL' scores the noisy
    temperature-scaled logits."""
    gumbel = _gumbel(_uniform(scores, gen, noise, "mdp_rank"))
    if distribution == "PL":
        logits = torch.where(mask, scores / temperature + gumbel, PAD_SCORE)
        order = torch.argsort(-logits, dim=-1, stable=True)
        action_preds = torch.gather(scores, -1, order)
    elif distribution == "STPL":
        noisy = (scores + gumbel) / temperature
        logits = torch.where(mask, noisy, PAD_SCORE)
        order = torch.argsort(-logits, dim=-1, stable=True)
        action_preds = torch.gather(noisy, -1, order)
    else:
        raise NotImplementedError(distribution)

    m = torch.gather(mask, -1, order)  # pads land at the tail
    action_labels = torch.gather(torch.where(mask, labels, 0.0), -1, order)

    N = scores.shape[-1]
    ranks = torch.arange(N, dtype=scores.dtype, device=scores.device)
    rewards = torch.where(m, gain(action_labels) / torch.log2(2.0 + ranks), 0.0)
    kmask = m if top_k is None else (m & (ranks < min(top_k, N))[None])
    rewards = torch.where(kmask, rewards, 0.0)
    g_t = torch.flip(torch.cumsum(torch.flip(rewards, (-1,)), -1), (-1,))
    if gamma != 1.0:
        g_t = g_t * torch.pow(gamma, ranks + 1.0)[None]

    lcse = logcumsumexp_reverse(action_preds, m)
    neg_log_probs = torch.where(kmask, lcse - action_preds, 0.0)
    return torch.sum(neg_log_probs * g_t)


def neural_ndcg(scores, labels, mask, temperature: float = 1.0, top_k: Optional[int] = None,
                sinkhorn_iters: int = 10, label_type: LabelType = LabelType.MultiLabel, **_):
    """NeuralNDCG (arXiv:2102.07831): nDCG through NeuralSort's relaxed
    permutation matrix.

    Deterministic NeuralSort row i (1-indexed rank), valid docs only:
        P[i, j] = softmax_j((n + 1 - 2 i) s_j - sum_k |s_j - s_k|) / tau
    then `sinkhorn_iters` rounds of masked log-domain Sinkhorn scaling toward
    a doubly-stochastic matrix, smooth gains ghat_i = sum_j P[i, j] gain_j, and
        loss = -sum_b DCG(ghat) / maxDCG@k
    with both truncated at `top_k`. maxDCG uses the given (presorted-ideal)
    label order. The scaling rounds are differentiated through the plain
    `_lse`; no kernel is launched. All-padded rows contribute exactly 0.
    """
    from ptranking_tpu_torch.ops.sinkhorn import _NEG, _lse

    N = scores.shape[-1]
    n = torch.sum(mask, dim=-1, keepdim=True).to(scores.dtype)          # [B, 1]
    s = torch.where(mask, scores, 0.0)
    diffs = torch.abs(s[..., :, None] - s[..., None, :])
    A = torch.sum(torch.where(pair_mask(mask), diffs, 0.0), dim=-1)     # [B, N]
    ranks = torch.arange(1, N + 1, dtype=scores.dtype, device=scores.device)
    c = n + 1.0 - 2.0 * ranks[None, :]                                  # [B, N(i)]
    logits = (c[..., :, None] * s[..., None, :] - A[..., None, :]) / temperature
    row_ok = ranks[None, :] <= n                                        # [B, N(i)]
    cell = row_ok[..., :, None] & mask[..., None, :]
    log_p = masked_log_softmax(logits, cell)                            # rows sum to 1
    log_p = torch.where(cell, log_p, _NEG)
    for _ in range(int(sinkhorn_iters)):
        log_p = log_p - _lse(log_p, -2)[..., None, :]                   # columns
        log_p = torch.where(cell, log_p, _NEG)
        log_p = log_p - _lse(log_p, -1)[..., :, None]                   # rows
        log_p = torch.where(cell, log_p, _NEG)
    P = torch.where(cell, torch.exp(log_p), 0.0)

    gains = gain(torch.where(mask, labels, 0.0), label_type)
    ghat = torch.einsum("bij,bj->bi", P, gains)                         # [B, N(i)]
    disc = 1.0 / torch.log2(ranks + 1.0)
    kmask = row_ok if top_k is None else (row_ok & (ranks <= min(top_k, N))[None])
    dcg_b = torch.sum(torch.where(kmask, ghat * disc[None], 0.0), dim=-1)
    # maxDCG@k over the given (presorted-ideal) order; position == rank
    ideal_terms = torch.where(kmask & mask, gains * disc[None], 0.0)
    idcg_b = torch.clamp(torch.sum(ideal_terms, dim=-1), min=EPSILON)
    return -torch.sum(dcg_b / idcg_b)
