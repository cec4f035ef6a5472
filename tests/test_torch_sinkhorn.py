"""The port's Sinkhorn machinery (ptranking_tpu_torch/ops/sinkhorn.py, the
plain path that the CPU runs) against the JAX package's: the half-step
against the Pallas kernel in interpret mode and against the lax version, the
20-iteration scalings, `sinkhorn_distance` (value and analytic gradient) and
`entropic_ot` (value, plan and autograd gradient). Inputs come from numpy
with a seed. Tolerances: the half-step at tests/test_pallas.py's rtol 1e-4 /
atol 1e-5; values rtol 1e-5; gradients rtol 1e-4 and atol 1e-6 (fp32, other
summation orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptranking_tpu.ops import sinkhorn as jsk
from ptranking_tpu.ops.pallas.sinkhorn import sinkstep_pallas
from ptranking_tpu_torch.ops import sinkhorn as tsk
from ptranking_tpu_torch.ops.sinkhorn_fused import Sinkstep

torch.set_num_threads(1)

NEG = -1e30


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _step_inputs(B, N, lengths=None, seed=0):
    """cost, log_marginal and log_u; with `lengths`, slots past a row's length
    are pads: zero mass, log_u = log_marginal = -1e30."""
    rng = np.random.RandomState(seed)
    cost = np.abs(rng.randn(B, N, N)).astype(np.float32)
    mu = _softmax(rng.randn(B, N)).astype(np.float32)
    u = _softmax(rng.randn(B, N)).astype(np.float32)
    log_marg, log_u = np.log(mu), np.log(u)
    if lengths is not None:
        mask = np.arange(N)[None, :] < np.asarray(lengths)[:, None]
        log_marg = np.where(mask, log_marg, NEG).astype(np.float32)
        log_u = np.where(mask, log_u, NEG).astype(np.float32)
    else:
        mask = np.ones((B, N), bool)
    return cost, log_marg, log_u, mask


def _port_step(cost, log_marg, log_u, lam):
    return tsk.log_sinkstep(torch.from_numpy(-cost / np.float32(lam)), torch.from_numpy(log_marg),
                            torch.from_numpy(log_u)).numpy()


STEP_CASES = {"N16": (3, 16, 0.2, None, None), "N50-tile16": (2, 50, 0.3, 16, None),
              "N16-pads": (3, 16, 0.2, None, (16, 9, 0)),
              "N50-tile16-pads": (2, 50, 0.3, 16, (37, 0))}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
@pytest.mark.parametrize("against", ["pallas-interpret", "lax"])
def test_log_sinkstep_matches_jax(case, against):
    """The half-step's plain version against the JAX Pallas kernel (interpret
    mode, one slab and several column slabs with a remainder) and against the
    JAX lax version; with pads, real columns agree and every value, the
    all-padded row's included, is finite."""
    B, N, lam, tile, lengths = STEP_CASES[case]
    cost, log_marg, log_u, mask = _step_inputs(B, N, lengths)
    got = _port_step(cost, log_marg, log_u, lam)
    if against == "lax":
        want = jsk.log_sinkstep(-jnp.asarray(cost) / lam, jnp.asarray(log_marg),
                                jnp.asarray(log_u))
    else:
        kw = {"tile": tile} if tile else {}
        want = sinkstep_pallas(jnp.asarray(cost), jnp.asarray(log_marg), jnp.asarray(log_u),
                               lam, interpret=True, **kw)
    want = np.asarray(want)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[mask], want[mask], rtol=1e-4, atol=1e-5)


def _hists(B=3, N=12, lengths=(12, 7, 0), seed=1):
    """mu, nu (zero mass on pads), a cost with a zero diagonal, the row mask."""
    rng = np.random.RandomState(seed)
    mask = np.arange(N)[None, :] < np.asarray(lengths)[:, None]

    def hist():
        h = np.where(mask, np.exp(rng.randn(B, N)), 0.0)
        return (h / np.maximum(h.sum(-1, keepdims=True), 1e-12)).astype(np.float32)

    cost = np.abs(rng.randn(B, N, N)).astype(np.float32) * 3.0
    cost[:, np.arange(N), np.arange(N)] = 0.0
    return hist(), hist(), cost, mask.any(-1)


def test_sinkhorn_log_scalings_match_jax_after_20_iterations():
    mu, nu, cost, real = _hists()
    want = jsk.sinkhorn_log_scalings(jsk._safe_log(jnp.asarray(mu)), jsk._safe_log(jnp.asarray(nu)),
                                     jnp.asarray(cost), 0.1, 20, use_pallas=False)
    got = tsk.sinkhorn_log_scalings(tsk._safe_log(torch.from_numpy(mu)),
                                    tsk._safe_log(torch.from_numpy(nu)),
                                    torch.from_numpy(cost), 0.1, 20)
    for g, w, h in zip(got, want, (mu, nu)):
        valid = h > 0
        np.testing.assert_allclose(g.numpy()[valid], np.asarray(w)[valid], rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(g.numpy()[~valid], np.asarray(w)[~valid])  # pads stay -1e30


@pytest.mark.parametrize("with_row_mask", [True, False], ids=["row_mask", "no_row_mask"])
def test_sinkhorn_distance_value_and_gradient_match_jax(with_row_mask):
    """The value, and the analytic gradient in mu scaled by an upstream 2.5;
    nothing flows to nu or the cost."""
    mu, nu, cost, real = _hists()
    jmask = jnp.asarray(real) if with_row_mask else None
    want_v, want_g = jax.value_and_grad(
        lambda m: 2.5 * jsk.sinkhorn_distance(m, jnp.asarray(nu), jnp.asarray(cost), jmask,
                                              0.1, 20))(jnp.asarray(mu))
    tmu, tnu, tcost = (torch.from_numpy(a).requires_grad_(True) for a in (mu, nu, cost))
    value = 2.5 * tsk.sinkhorn_distance(tmu, tnu, tcost,
                                        torch.from_numpy(real) if with_row_mask else None, 0.1, 20)
    g_mu, g_nu, g_cost = torch.autograd.grad(value, (tmu, tnu, tcost), allow_unused=True)
    assert g_nu is None and g_cost is None
    np.testing.assert_allclose(float(value.detach()), float(want_v), rtol=1e-5)
    np.testing.assert_allclose(g_mu.numpy(), np.asarray(want_g), rtol=1e-4, atol=1e-6)


def test_entropic_ot_value_plan_and_gradient_match_jax():
    mu, nu, cost, real = _hists()

    def jf(m):
        loss, pi = jsk.entropic_ot(m, jnp.asarray(nu), jnp.asarray(cost), eps=0.1, max_iters=30,
                                   row_mask=jnp.asarray(real))
        return loss, pi

    (want_v, want_pi), want_g = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(mu))
    tmu = torch.from_numpy(mu).requires_grad_(True)
    loss, pi = tsk.entropic_ot(tmu, torch.from_numpy(nu), torch.from_numpy(cost), eps=0.1,
                               max_iters=30, row_mask=torch.from_numpy(real))
    (grad,) = torch.autograd.grad(loss, tmu)
    np.testing.assert_allclose(float(loss.detach()), float(want_v), rtol=1e-5)
    np.testing.assert_allclose(pi.detach().numpy(), np.asarray(want_pi), rtol=1e-4, atol=1e-7)
    assert bool(torch.isfinite(grad).all())
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_g), rtol=1e-4, atol=1e-6)


def test_safe_log_has_a_zero_safe_gradient():
    x = torch.tensor([0.0, 0.5, -1.0], requires_grad=True)
    (grad,) = torch.autograd.grad(torch.sum(torch.where(x > 0, tsk._safe_log(x), 0.0)), x)
    np.testing.assert_array_equal(grad.numpy(), [0.0, 2.0, 0.0])


def test_sinkstep_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper raises on CPU tensors before any build or launch and counts
    nothing; use_pallas=True on CPU tensors reaches it and raises too."""
    cost, log_marg, log_u, _ = _step_inputs(2, 8)
    step = Sinkstep()
    with pytest.raises(ValueError, match="CUDA tensors"):
        step(torch.from_numpy(cost), torch.from_numpy(log_marg), torch.from_numpy(log_u), 0.1)
    with pytest.raises(ValueError, match="float32"):
        step(torch.from_numpy(cost).double(), torch.from_numpy(log_marg),
             torch.from_numpy(log_u), 0.1)
    with pytest.raises(ValueError, match=r"\[B, N, N\]"):
        step(torch.from_numpy(cost[:, :4]), torch.from_numpy(log_marg),
             torch.from_numpy(log_u), 0.1)
    assert step.launches == 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        tsk.sinkhorn_log_scalings(torch.from_numpy(log_marg), torch.from_numpy(log_marg),
                                  torch.from_numpy(cost), 0.1, 2, use_pallas=True)
