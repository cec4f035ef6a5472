"""Doc-axis-sharded WassRank: log-domain Sinkhorn OT split over `seq`.

The port's counterpart of ptranking_tpu/parallel/ot.py, the last loss of
the CP zoo. WassRank's entropic OT iterates over an [N, N] coupling between
the prediction and label histograms (losses/wassrank.py); here each rank
holds:

  * mu (the prediction histogram) and the u-potential on its block of docs,
    [B, n];
  * nu (the label histogram) and the v-potential whole, [B, N]: O(N)
    vectors, from the labels gathered once;
  * the cost matrix only as its row block [B, n, N], built from its labels
    against the gathered ones.

A Sinkhorn iteration takes one stop-gradient max and one sum over `seq`
(the logsumexp over the split row axis for the v-update); the u-update is
the rank's own. SinkhornOT is an autograd Function with the dense loss's
analytic dual gradient lam * log(u) into mu only, double mean-centred over
each query's valid docs, the centring sums taken over `seq`. EntropicOT is
differentiated through its convergence-frozen iterations, its maxima
stop-gradient. Plain torch, as in the JAX package: no kernel launches here
(the dense loss's Sinkhorn half-step kernel, csrc/sinkstep.cu, takes whole
rows).
"""

from __future__ import annotations

import math

import torch

from ptranking_tpu_torch import PAD_SCORE
from ptranking_tpu_torch.ops.sinkhorn import _NEG, _lse, _safe_log
from ptranking_tpu_torch.parallel.ring import CPPlan, SeqParallel


def _plse(x: torch.Tensor, dim: int, seq: SeqParallel) -> torch.Tensor:
    """Logsumexp over `dim` locally and over the `seq` ranks, without a
    gradient; an all-_NEG slice comes back about _NEG, never -inf or NaN."""
    m = seq.pmax(torch.clamp(torch.amax(x, dim=dim, keepdim=True), min=_NEG))
    s = seq.sum_nograd(torch.sum(torch.exp(x - m), dim=dim))
    return m.squeeze(dim) + _safe_log(s)


def _plse_last(x: torch.Tensor, seq: SeqParallel) -> torch.Tensor:
    """The ranks' partial logsumexps (already reduced locally) combined into
    the logsumexp over `seq`, without a gradient."""
    m = seq.pmax(torch.clamp(x, min=_NEG))
    return m + _safe_log(seq.sum_nograd(torch.exp(x - m)))


def _plse_sg(x: torch.Tensor, dim: int, seq: SeqParallel) -> torch.Tensor:
    """_plse with a gradient: the max shift is a stop-gradient (it cancels
    in the logsumexp) and the sum over `seq` an inner psum."""
    m = seq.pmax(torch.clamp(torch.amax(x, dim=dim, keepdim=True), min=_NEG))
    s = seq.psum(torch.sum(torch.exp(x - m), dim=dim))
    return m.squeeze(dim) + _safe_log(s)


# --------------------------------------------------------------- cost blocks


def _cost_block(l_l, m_l, l_full, m_full, rows, N, cost_type, non_rele_gap, var_penalty,
                gain_base):
    """This rank's row block [B, n, N] of losses/wassrank.py's cost matrix,
    built from its labels (rows) against the gathered ones (columns)."""
    cols = torch.arange(N, device=l_l.device)
    if cost_type in ("p1", "p2"):
        c = torch.abs((rows + 1).to(l_l.dtype)[:, None] - (cols + 1).to(l_l.dtype)[None, :])
        if cost_type == "p2":
            c = torch.pow(c, 2.0)
        return c.expand(*l_l.shape, N)
    if cost_type == "eg":
        def grp(lab, msk):
            g = torch.pow(gain_base, torch.where(msk, lab, 0.0)) - 1.0
            return torch.where(g < 1.0, -non_rele_gap, g)

        c = torch.abs(grp(l_l, m_l)[..., :, None] - grp(l_full, m_full)[..., None, :])
        c = torch.where(c < 1.0, var_penalty, c)
        return torch.where((rows[:, None] == cols[None, :])[None], 0.0, c)
    if cost_type in ("dg", "ddg"):
        def gains(lab, msk):
            return torch.pow(2.0, torch.where(msk, lab, 0.0)) - 1.0

        c = torch.abs(gains(l_l, m_l)[..., :, None] - gains(l_full, m_full)[..., None, :])
        if cost_type == "ddg":
            d_r = 1.0 / torch.log2(rows.to(l_l.dtype) + 2.0)
            d_c = 1.0 / torch.log2(cols.to(l_l.dtype) + 2.0)
            c = c * torch.abs(d_r[:, None] - d_c[None, :])[None]
        return c
    raise NotImplementedError(cost_type)


# ------------------------------------------------------- sharded Sinkhorn OT


class _SinkhornShare(torch.autograd.Function):
    """The rank's share of the Sinkhorn transport loss: its data line's loss
    (the rows' mean over the batch's real queries) / S, so the final sum over
    `seq` restores the line's loss. The backward returns the rank's whole
    block [B, n] of d loss / d mu: every block lives on one rank, so the
    joined gradient counts each once."""

    @staticmethod
    def forward(ctx, mu_l, nu_full, cost_blk, real, lam, n_iters, cp):
        seq = cp.seq
        N = nu_full.shape[-1]
        log_mu, log_nu = _safe_log(mu_l), _safe_log(nu_full)
        neg_c = -cost_blk / lam                                   # [B, n, N]
        log_u = torch.where(log_mu > _NEG / 2, -math.log(N), _NEG)
        log_v = torch.where(log_nu > _NEG / 2, -math.log(N), _NEG)
        for _ in range(n_iters):
            # v: a logsumexp over the split row axis; u: over the rank's columns
            log_v = log_nu - _plse(neg_c + log_u[..., :, None], -2, seq)
            log_u = log_mu - _lse(neg_c + log_v[..., None, :], dim=-1)
        # sum_ij u K C v a row in log space: the local double logsumexp, then
        # combined over `seq`
        terms = _safe_log(cost_blk) + neg_c + log_u[..., :, None] + log_v[..., None, :]
        per_row = torch.exp(_plse_last(_lse(_lse(terms, -1), -1), seq))  # [B]
        w = real.to(mu_l.dtype)
        den = cp.batch.sum_nograd(torch.sum(w))
        ctx.save_for_backward(log_u, mu_l, w, den)
        ctx.lam, ctx.seq = lam, seq
        return torch.sum(per_row * w) / torch.clamp(den, min=1.0) / seq.degree

    @staticmethod
    def backward(ctx, g):
        log_u, mu_l, w, den = ctx.saved_tensors
        seq = ctx.seq
        valid = mu_l > 0
        grad = torch.where(valid, log_u * ctx.lam, 0.0)
        n = torch.clamp(seq.sum_nograd(torch.sum(valid, dim=-1)), min=1).to(grad.dtype)
        for _ in range(2):  # double mean-centring, summed over the doc shards
            mean = seq.sum_nograd(torch.sum(grad, dim=-1)) / n
            grad = grad - torch.where(valid, mean[..., None], 0.0)
        grad = grad * (w / torch.clamp(den, min=1.0))[..., None]
        return g * grad, None, None, None, None, None, None


def _cp_entropic_ot(mu_l, nu_full, cost_blk, real, eps, max_iters, thresh, cp):
    """Doc-sharded EntropicOT (ops/sinkhorn.py::entropic_ot blockwise): the
    f-potential on the rank's rows, the g-update and the frozen
    marginal-error probe one reduction over `seq` an iteration. Returns the
    rank's share: its row block's transport cost over the batch's real
    queries."""
    seq = cp.seq
    log_mu, log_nu = _safe_log(mu_l), _safe_log(nu_full)
    valid_mu, valid_nu = mu_l > 0, nu_full > 0

    def m_op(f, g):  # [B, n, N] = (-C + f_i + g_j) / eps
        return (-cost_blk + f[..., :, None] + g[..., None, :]) / eps

    # the error is a mean over ALL the batch's rows, as the dense loss's
    b_total = cp.batch.sum_nograd(torch.tensor(float(mu_l.shape[0]), device=mu_l.device))
    f, g = torch.zeros_like(mu_l), torch.zeros_like(nu_full)
    err = torch.full((), float("inf"), dtype=mu_l.dtype, device=mu_l.device)
    for _ in range(max_iters):
        f1 = torch.where(valid_mu, eps * (log_mu - _lse(m_op(f, g), dim=-1)) + f, _NEG)
        g1 = torch.where(valid_nu, eps * (log_nu - _plse_sg(m_op(f1, g), -2, seq)) + g, _NEG)
        with torch.no_grad():  # the probe only drives the freeze
            marg = torch.exp(_lse(m_op(f1, g1), dim=-1))
            row_err = seq.sum_nograd(torch.sum(torch.abs(marg - mu_l), dim=-1))
            err1 = cp.batch.sum_nograd(torch.sum(row_err)) / b_total
        done = err <= thresh
        f, g, err = torch.where(done, f, f1), torch.where(done, g, g1), torch.where(done, err, err1)
    blk = torch.sum(torch.exp(m_op(f, g)) * cost_blk, dim=(-2, -1))  # [B], the rank's rows
    w = real.to(mu_l.dtype)
    return torch.sum(blk * w) / torch.clamp(cp.batch.sum_nograd(torch.sum(w)), min=1.0)


# ------------------------------------------------------------------- entry


def cp_wass_rank(scores, labels, mask, cp: CPPlan, mode: str = "SinkhornOT", sh_itr: int = 20,
                 lam: float = 0.1, smooth_type: str = "ST", cost_type: str = "eg",
                 non_rele_gap: float = 100.0, var_penalty: float = math.e,
                 gain_base: float = 4.0, tl_af: str = "S", thresh: float = 1e-1) -> torch.Tensor:
    """Doc-axis-sharded wass_rank (both OT modes) on the rank's block [B, n]
    of scores, labels and mask: its data line's loss, equal to
    losses/wassrank.py::wass_rank on the whole rows in value and in the
    scores' gradient. The label max (ST), the score min (NG) and the real
    queries span the whole batch, over `seq` and the plan's batch axes."""
    if mode not in ("SinkhornOT", "EntropicOT"):
        raise NotImplementedError(mode)
    seq, batch = cp.seq, cp.batch
    n_l = scores.shape[-1]
    rows = seq.positions(n_l, scores.device)
    l_full, m_full = seq.gather(labels, 1), seq.gather(mask, 1)
    N = l_full.shape[-1]

    # the label histogram nu: O(N) vectors, whole on every rank
    if smooth_type == "ST":
        x = torch.where(m_full, l_full, PAD_SCORE)
        nu_full = torch.where(m_full, torch.softmax(x, dim=-1), 0.0)
    else:  # "NG": gains over their sum (gain base 2, as the dense loss)
        gains = torch.where(m_full, torch.pow(2.0, l_full) - 1.0, 0.0)
        nu_full = gains / torch.clamp(torch.sum(gains, -1, keepdim=True), min=1e-12)

    # the prediction histogram mu: a masked softmax over the split docs
    if smooth_type == "ST":
        s_in = scores
        if tl_af in ("S", "ST"):
            # the max over the whole batch's valid labels (no gradient)
            max_rele = batch.pmax(seq.pmax(torch.max(torch.where(mask, labels, 0.0))))
            s_in = scores * max_rele
        x = torch.where(mask, s_in, PAD_SCORE)
        e = torch.exp(x - seq.pmax(torch.amax(x, -1, keepdim=True)))
        mu_l = torch.where(mask, e / seq.psum(torch.sum(e, -1, keepdim=True)), 0.0)
    else:  # "NG"
        # the dense loss differentiates its score minimum (at the argmin):
        # gather the ranks' minima, with their gradients summed back
        mini_l = torch.min(torch.where(mask, scores, float("inf")))[None]
        mini = torch.min(batch.gather_sum(torch.min(seq.gather_sum(mini_l, 0))[None], 0))
        s = torch.where(mask, torch.where(mini > 0, scores, scores - mini), 0.0)
        mu_l = s / torch.clamp(seq.psum(torch.sum(s, -1, keepdim=True)), min=1e-12)

    cost_blk = _cost_block(labels, mask, l_full, m_full, rows, N, cost_type, non_rele_gap,
                           var_penalty, gain_base)
    real = torch.any(m_full, dim=-1)
    if mode == "EntropicOT":
        share = _cp_entropic_ot(mu_l, nu_full, cost_blk, real, float(lam), int(sh_itr),
                                float(thresh), cp)
    else:
        share = _SinkhornShare.apply(mu_l, nu_full, cost_blk, real, float(lam), int(sh_itr), cp)
    return seq.loss_sum(share)
