"""Batched log-domain Sinkhorn iterations for entropic optimal transport.

Counterpart of ptranking_tpu/ops/sinkhorn.py:
  * `sinkhorn_distance`: fixed-iteration Sinkhorn with the analytic gradient
    d W / d mu = lam * log(u), mean-centred, as a `torch.autograd.Function`,
    so the backward is O(1) instead of differentiating through the loop;
  * `entropic_ot`: Sinkhorn with a convergence threshold, as a fixed-length
    loop that freezes once converged, differentiated by autograd;
  * `log_sinkstep`: the half-step's plain version. On CUDA tensors
    `sinkhorn_log_scalings` runs every half-step through the hand-written
    kernel of ops/sinkhorn_fused.py instead (csrc/sinkstep.cu).

All functions are batched ([B, N] histograms, [B, N, N] costs) and masked:
padded slots must carry zero mass; they are excluded from every logsumexp.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ptranking_tpu_torch.parallel.collectives import global_count

_NEG = -1e30  # log-domain "minus infinity" that stays NaN-free under arithmetic


def _safe_log(x: torch.Tensor) -> torch.Tensor:
    # double-where: the log must never see a non-positive input, or its
    # backward (grad / x) makes inf or NaN that the outer where cannot erase
    pos = x > 0
    return torch.where(pos, torch.log(torch.where(pos, x, 1.0)), _NEG)


def _lse(x: torch.Tensor, dim: int) -> torch.Tensor:
    """logsumexp that treats _NEG entries as exact zeros (no -inf NaNs)."""
    m = torch.clamp(torch.amax(x, dim=dim, keepdim=True), min=_NEG)  # all-pad rows stay at _NEG
    s = torch.sum(torch.exp(x - m), dim=dim)
    return m.squeeze(dim) + _safe_log(s)


def log_sinkstep(neg_cost_over_lam_T: torch.Tensor, log_marginal: torch.Tensor,
                 log_u: torch.Tensor) -> torch.Tensor:
    """One log-domain Sinkhorn half-step, the plain version:
    log_v = log_marginal - LSE_i(-C_ij/lam + log_u_i).

    neg_cost_over_lam_T: [B, N_from, N_to] = -C/lam (rows = summed-over axis)
    log_marginal, log_u: [B, N_to] / [B, N_from]
    """
    return log_marginal - _lse(neg_cost_over_lam_T + log_u[..., :, None], dim=-2)


def sinkhorn_log_scalings(log_mu: torch.Tensor, log_nu: torch.Tensor, cost: torch.Tensor,
                          lam: float, n_iters: int,
                          use_pallas: Optional[bool] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run n_iters Sinkhorn iterations; returns (log_u, log_v).

    Each iteration is the v-update from u, then the u-update from v, starting
    from log_u = -log(N) with N the padded width. use_pallas (the name is the
    JAX package's) selects the half-step: None takes the CUDA kernel whenever
    the tensors are on a CUDA device, at every N, and the plain `log_sinkstep`
    on the CPU; False forces the plain version; True on CPU tensors raises.
    The kernel reads the one `cost` tensor in both orientations and keeps no
    graph: differentiate through the plain version, or use
    `sinkhorn_distance`, whose gradient is analytic."""
    N = log_mu.shape[-1]
    if use_pallas is None:
        use_pallas = cost.is_cuda
    log_u = torch.where(log_mu > _NEG / 2, -math.log(N), _NEG)
    log_v = torch.where(log_nu > _NEG / 2, -math.log(N), _NEG)

    if use_pallas:
        from ptranking_tpu_torch.ops.sinkhorn_fused import SINKSTEP

        cost, log_mu, log_nu = (t.detach().float().contiguous() for t in (cost, log_mu, log_nu))
        for _ in range(n_iters):
            log_v = SINKSTEP(cost, log_nu, log_u, lam)                   # sum over i (rows)
            log_u = SINKSTEP(cost, log_mu, log_v, lam, transposed=True)  # sum over j (columns)
        return log_u, log_v

    neg_c = -cost / lam  # [B, N, N]
    neg_c_t = neg_c.transpose(-1, -2)
    for _ in range(n_iters):
        log_v = log_sinkstep(neg_c, log_nu, log_u)
        log_u = log_sinkstep(neg_c_t, log_mu, log_v)
    return log_u, log_v


def _transport_cost(log_u, log_v, cost, lam):
    """sum_ij u_i K_ij C_ij v_j in log space (K = exp(-C/lam))."""
    log_kc = _safe_log(cost) - cost / lam  # [B, N, N]
    terms = log_kc + log_u[..., :, None] + log_v[..., None, :]
    return torch.exp(_lse(_lse(terms, dim=-1), dim=-1))  # [B]


def _row_weights(mu, row_mask):
    if row_mask is None:
        return torch.ones(mu.shape[0], dtype=mu.dtype, device=mu.device)
    return row_mask.to(mu.dtype)


class _SinkhornDistance(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mu, nu, cost, row_mask, lam, n_iters, use_pallas):
        log_u, log_v = sinkhorn_log_scalings(_safe_log(mu), _safe_log(nu), cost, lam, n_iters,
                                             use_pallas)
        w = _row_weights(mu, row_mask)
        per_row = _transport_cost(log_u, log_v, cost, lam)
        # the real queries of the whole batch (over the data-parallel ranks)
        den = torch.clamp(global_count(torch.sum(w)), min=1.0)
        ctx.save_for_backward(log_u, mu, w, den)
        ctx.lam = lam
        return torch.sum(per_row * w) / den

    @staticmethod
    def backward(ctx, grad_out):
        log_u, mu, w, den = ctx.saved_tensors
        valid = mu > 0
        grad = torch.where(valid, log_u * ctx.lam, 0.0)
        n = torch.clamp(torch.sum(valid, dim=-1, keepdim=True), min=1)
        # double mean-centring over the valid entries
        grad = grad - torch.where(valid, torch.sum(grad, -1, keepdim=True) / n, 0.0)
        grad = grad - torch.where(valid, torch.sum(grad, -1, keepdim=True) / n, 0.0)
        grad = grad * (w / den)[:, None]
        return grad_out * grad, None, None, None, None, None, None


def sinkhorn_distance(mu: torch.Tensor, nu: torch.Tensor, cost: torch.Tensor,
                      row_mask: Optional[torch.Tensor] = None, lam: float = 0.1,
                      n_iters: int = 20, use_pallas: Optional[bool] = None) -> torch.Tensor:
    """Entropic-OT transport cost per batch row, mean over REAL rows.

    The forward returns mean_b sum_ij u K C v after n_iters iterations (2 *
    n_iters half-steps: kernel launches on CUDA tensors unless
    use_pallas=False); the backward flows only into `mu`, with the analytic
    dual gradient lam * log(u), mean-centred twice over the valid entries,
    and launches nothing.

    mu, nu: [B, N] histograms (padded slots = 0 mass); cost: [B, N, N];
    row_mask: [B] bool, so that all-padded remainder rows of bucketed batches
    do not dilute the mean (means divide by real queries).
    """
    return _SinkhornDistance.apply(mu, nu, cost, row_mask, lam, n_iters, use_pallas)


def entropic_ot(mu: torch.Tensor, nu: torch.Tensor, cost: torch.Tensor, eps: float = 0.1,
                max_iters: int = 100, thresh: float = 1e-1,
                row_mask: Optional[torch.Tensor] = None):
    """Sinkhorn divergence with a convergence freeze, differentiated by
    autograd through a fixed-length loop: once the L1 marginal error drops
    below thresh the potentials stop updating (the result of an early break,
    with no host sync). The u/v potentials are updated in log space, then
    loss = sum(pi * C) per row, mean over REAL rows. Returns (loss, pi)."""
    log_mu, log_nu = _safe_log(mu), _safe_log(nu)
    valid_mu, valid_nu = mu > 0, nu > 0

    def m_op(f, g):  # M_ij = (-C + f_i + g_j) / eps
        return (-cost + f[..., :, None] + g[..., None, :]) / eps

    f, g = torch.zeros_like(mu), torch.zeros_like(nu)
    err = torch.full((), float("inf"), dtype=mu.dtype, device=mu.device)
    n_rows = global_count(torch.tensor(float(mu.shape[0]), dtype=mu.dtype, device=mu.device))
    for _ in range(max_iters):
        f1 = eps * (log_mu - _lse(m_op(f, g), dim=-1)) + f
        f1 = torch.where(valid_mu, f1, _NEG)
        g1 = eps * (log_nu - _lse(m_op(f1, g).transpose(-1, -2), dim=-1)) + g
        g1 = torch.where(valid_nu, g1, _NEG)
        # the marginal-error probe only drives the boolean freeze; it carries
        # no gradient (its exp can overflow, and 0 * inf is NaN backward)
        with torch.no_grad():  # a mean over every row of the batch
            marg = torch.exp(_lse(m_op(f1, g1), dim=-1))
            err1 = global_count(torch.sum(torch.abs(marg - mu))) / n_rows
        done = err <= thresh  # freeze once converged
        f, g, err = torch.where(done, f, f1), torch.where(done, g, g1), torch.where(done, err, err1)
    pi = torch.exp(m_op(f, g))
    per_row = torch.sum(pi * cost, dim=(-2, -1))
    w = _row_weights(mu, row_mask)
    loss = torch.sum(per_row * w) / torch.clamp(global_count(torch.sum(w)), min=1.0)
    return loss, pi
