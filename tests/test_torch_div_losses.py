"""The port's diversification losses against the JAX package's, on the same
seeded numpy inputs: all six DIV_LOSSES keys (DALETOR, SuperSoft-aNDCG,
SuperSoft-nERR-IA, PairCLS, LambdaPairCLS, Portfolio), with and without
cocos, opt_ideal True and False, LambdaPairCLS with and without its
normalisation; the value within 1e-5 and the gradients with respect to
mus, vars and cocos within 1e-4 relative. Pad contents change nothing and
get no gradient (but for Portfolio with cocos, as in JAX)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptranking_tpu.diversification import losses as jlosses
from ptranking_tpu_torch.diversification import losses as tlosses

torch.set_num_threads(1)

B, S, N = 3, 4, 11
VALUE_TOL = 1e-5
GRAD_TOL = 1e-4


def _inputs(seed, with_cocos):
    rng = np.random.RandomState(seed)
    mask = np.arange(N)[None] < np.array([N, 6, 1])[:, None]
    rele = (rng.rand(B, S, N) < 0.4).astype(np.float32) * mask[:, None, :]
    mus = rng.randn(B, N).astype(np.float32)
    vars_ = np.exp(0.5 * rng.randn(B, N)).astype(np.float32)
    mus[~mask], vars_[~mask] = 99.0, 5.0  # pad contents must not matter
    cocos = None
    if with_cocos:
        emb = rng.randn(B, N, 5)
        emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
        cocos = np.einsum("bnd,bmd->bnm", emb, emb).astype(np.float32)
    return mus, vars_, cocos, rele, mask


CASES = [
    ("DALETOR", {}, False),
    ("DALETOR", {"rt": 4.0, "top_k": None, "alpha": 0.3}, False),
    ("SuperSoft-aNDCG", {}, False),
    ("SuperSoft-aNDCG", {"opt_ideal": False}, True),
    ("SuperSoft-aNDCG", {"opt_ideal": False, "top_k": 3}, False),
    ("SuperSoft-nERR-IA", {}, True),
    ("SuperSoft-nERR-IA", {"opt_ideal": False}, False),
    ("PairCLS", {"opt_id": "PairCLS"}, False),
    ("PairCLS", {"opt_id": "PairCLS"}, True),
    ("LambdaPairCLS", {"opt_id": "LambdaPairCLS"}, False),
    ("LambdaPairCLS", {"opt_id": "LambdaPairCLS", "opt_ideal": False}, True),
    ("LambdaPairCLS", {"opt_id": "LambdaPairCLS", "opt_ideal": False, "norm": False}, False),
    # a gamma that keeps the QP's solution off the simplex's vertices, where
    # the weights (and so the gradients) would be constant
    ("Portfolio", {"gamma": 3.0}, False),
    ("Portfolio", {"gamma": 0.5, "n_qp_iters": 20}, True),
]


def _port(key, kw, mus, vars_, cocos, rele, mask):
    """(loss, [d mus, d vars(, d cocos)]) of the port's loss."""
    t = [torch.tensor(a, requires_grad=True) for a in (mus, vars_) + ((cocos,) if cocos is not None
                                                                       else ())]
    c = t[2] if cocos is not None else None
    fn = tlosses.DIV_LOSSES[key]
    if key == "DALETOR":
        loss = fn(t[0] + 0.3 * t[1], torch.from_numpy(rele), torch.from_numpy(mask), **kw)
    else:
        loss = fn(t[0], t[1], torch.from_numpy(rele), torch.from_numpy(mask), cocos=c, **kw)
    loss.backward()
    return float(loss), [a.grad.numpy() for a in t]


def _jax(key, kw, mus, vars_, cocos, rele, mask):
    fn = jlosses.DIV_LOSSES[key]
    args = (mus, vars_) + ((cocos,) if cocos is not None else ())

    def of(*a):
        c = a[2] if cocos is not None else None
        if key == "DALETOR":
            return fn(a[0] + 0.3 * a[1], jnp.asarray(rele), jnp.asarray(mask), **kw)
        return fn(a[0], a[1], jnp.asarray(rele), jnp.asarray(mask), cocos=c, **kw)

    value, grads = jax.jit(jax.value_and_grad(of, argnums=tuple(range(len(args)))))(
        *(jnp.asarray(a) for a in args))
    return float(value), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("key,kw,with_cocos", CASES,
                         ids=[f"{k}-{i}" for i, (k, _, _) in enumerate(CASES)])
def test_div_loss_value_and_gradients_match_jax(key, kw, with_cocos):
    inputs = _inputs(sum(map(ord, key)) + len(kw), with_cocos)
    got, got_g = _port(key, kw, *inputs)
    want, want_g = _jax(key, kw, *inputs)
    assert np.isfinite(got) and abs(got - want) <= VALUE_TOL * max(abs(want), 1.0)
    top = max(float(np.max(np.abs(g))) for g in want_g)
    assert top > 0
    for a, b in zip(got_g, want_g):
        assert np.all(np.isfinite(a))
        assert float(np.max(np.abs(a - b))) <= GRAD_TOL * max(float(np.max(np.abs(b))), 1e-3 * top)
    mask = inputs[-1]
    assert not got_g[0][~mask].any()  # the pads' mus get no gradient
    if not (key == "Portfolio" and with_cocos):
        assert not got_g[1][~mask].any()


@pytest.mark.parametrize("key", sorted(tlosses.DIV_LOSSES))
def test_div_losses_ignore_pad_contents(key):
    """Pad contents change no loss. Not checked: Portfolio with cocos, whose
    covariance reads the pads' variances in JAX too (Cov @ (Cov @ w) sums
    over the pads' rows), a quirk the port keeps."""
    mus, vars_, cocos, rele, mask = _inputs(7, key not in ("DALETOR", "Portfolio"))
    kw = {"opt_id": key} if key in ("PairCLS", "LambdaPairCLS") else {}
    base = _port(key, kw, mus, vars_, cocos, rele, mask)[0]
    mus2, vars2 = mus.copy(), vars_.copy()
    mus2[~mask], vars2[~mask] = -50.0, 0.01
    assert abs(_port(key, kw, mus2, vars2, cocos, rele, mask)[0] - base) <= 1e-5 * max(abs(base), 1)


def test_portfolio_weights_and_projection_match_jax():
    """The unrolled QP's weights and the exact simplex projection, on their
    own: rows on the masked simplex, equal to JAX's within 1e-5."""
    mus, vars_, cocos, _, mask = _inputs(3, True)
    for c in (None, cocos):
        got = tlosses.portfolio_weights(torch.from_numpy(mus), torch.from_numpy(vars_),
                                        torch.from_numpy(mask),
                                        None if c is None else torch.from_numpy(c)).numpy()
        want = np.asarray(jlosses.portfolio_weights(jnp.asarray(mus), jnp.asarray(vars_),
                                                    jnp.asarray(mask),
                                                    None if c is None else jnp.asarray(c)))
        np.testing.assert_allclose(got, want, rtol=VALUE_TOL, atol=1e-6)
        np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
        assert (got >= 0).all() and not got[~mask].any()
    w = np.random.RandomState(1).randn(B, N).astype(np.float32)
    m = mask.astype(np.float32)
    got = tlosses._project_simplex(torch.from_numpy(w), torch.from_numpy(m)).numpy()
    want = np.asarray(jlosses._project_simplex(jnp.asarray(w), jnp.asarray(m)))
    np.testing.assert_allclose(got, want, rtol=VALUE_TOL, atol=1e-7)
