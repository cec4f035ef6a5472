"""The port's diversification scorers against the JAX package's: params
carried over by `div_params_from_jax` for every sf_id (pointsf, listsf and
their co variants), K = 1 and 3, a cluster of 3, limit_delta; mus, vars,
cocos, expected ranks and the three sort modes of `div_predict` within
1e-5, and the gradients of a masked sum of them within 1e-4 relative. The
cluster's members share their dropout masks, as every member gets the same
PRNG key in JAX."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptranking_tpu.diversification import scorers as jsc
from ptranking_tpu_torch.diversification import scorers as tsc
from ptranking_tpu_torch.models.convert import div_params_from_jax
from ptranking_tpu_torch.models.scorers import map_params, tree_leaves

torch.set_num_threads(1)

D = 8
SMALL = dict(num_features=D, h_dim=16, num_layers=2, ff_dims=(16, 8), encoder_layers=1,
             n_heads=2, dropout=0.0)
VALUE_TOL = 1e-5
GRAD_TOL = 1e-4


def _batch(seed=0, B=3, N=9):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, D).astype(np.float32)
    d = rng.randn(B, N, D).astype(np.float32)
    mask = np.arange(N)[None] < np.array([N, 5, 1])[:, None]
    d[~mask] = 7.0  # pad contents must not matter
    return q, d, mask


def _pair(cfg: tsc.DivScorerConfig, seed=0):
    """(port params, JAX params, JAX config) for the same init."""
    jcfg = jsc.DivScorerConfig(**dataclasses.asdict(cfg))
    jparams = jsc.init_div_scorer(jax.random.PRNGKey(seed), jcfg)
    tparams = div_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    return tparams, jparams, jcfg


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.max(np.abs(got - want)) / max(float(np.max(np.abs(want))), 1e-30))


def grads_rel(got, want) -> float:
    """The worst leaf's max |got - want| over its max |want|. A leaf whose
    gradient is zero but for rounding (a bias before a batch norm: below 1e-5
    of the largest gradient in JAX) is held to |got| over the largest
    gradient instead."""
    top = max(float(np.max(np.abs(g))) for g in want)
    return max(float(np.max(np.abs(a))) / top if float(np.max(np.abs(b))) < 1e-5 * top
               else _rel(a, b) for a, b in zip(got, want))


CONFIGS = [
    dict(sf_id="pointsf"),
    dict(sf_id="pointsf", K=3),
    dict(sf_id="pointsf", K=3, cluster=True, limit_delta=2.0),
    dict(sf_id="pointsf_co", limit_delta=0.1),
    dict(sf_id="listsf"),
    dict(sf_id="listsf", K=3, limit_delta=2.0),
    dict(sf_id="listsf", K=3, cluster=True),
    dict(sf_id="listsf_co", K=3, bn_type="BN2", bn_affine=True),
]


@pytest.mark.parametrize("over", CONFIGS, ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()))
def test_div_forward_and_gradients_match_jax(over):
    cfg = tsc.DivScorerConfig(**SMALL, **over)
    tparams, jparams, jcfg = _pair(cfg)
    q, d, mask = _batch()
    tq, td, tm = torch.from_numpy(q), torch.from_numpy(d), torch.from_numpy(mask)
    mus, vars_, cocos = tsc.div_forward(tparams, cfg, tq, td, tm)
    jm, jv, jc = jax.jit(lambda p: jsc.div_forward(p, jcfg, jnp.asarray(q), jnp.asarray(d),
                                                   jnp.asarray(mask)))(jparams)
    # the pointsf has no co-embedding: pointsf_co gives no cocos, as in JAX
    assert (cocos is None) == (jc is None) == (cfg.sf_id != "listsf_co")
    for got, want in ((mus, jm), (vars_, jv)) + (((cocos, jc),) if jc is not None else ()):
        got = torch.where(tm[..., None] if got.dim() == 3 else tm, got, 0.0).numpy()
        want = np.where(mask[..., None] if want.ndim == 3 else mask, np.asarray(want), 0.0)
        assert _rel(got, want) <= VALUE_TOL
    if cfg.limit_delta is not None:
        assert float(vars_.max()) <= cfg.limit_delta

    rng = np.random.RandomState(1)
    w = [rng.randn(*s).astype(np.float32) for s in ((3, 9), (3, 9), (3, 9, 9))]

    pmask = mask[:, :, None] & mask[:, None, :]

    def objective(m, v, c, asarray, xp):
        W = [asarray(a) for a in w]
        out = xp.sum(m * W[0] * asarray(mask)) + xp.sum(v * W[1] * asarray(mask))
        return out + (xp.sum(c * W[2] * asarray(pmask)) if c is not None else 0.0)

    leaves = tree_leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)
    objective(*tsc.div_forward(tparams, cfg, tq, td, tm), torch.from_numpy, torch).backward()
    jg = jax.jit(jax.grad(lambda p: objective(*jsc.div_forward(p, jcfg, jnp.asarray(q), jnp.asarray(d),
                                                       jnp.asarray(mask)), jnp.asarray, jnp)
                          ))(jparams)
    want = [g.numpy() for g in
            tree_leaves(div_params_from_jax(jax.tree_util.tree_map(np.asarray, jg), cfg))]
    got = [t.grad.numpy() if t.grad is not None else np.zeros_like(g)
           for t, g in zip(leaves, want)]
    assert grads_rel(got, want) <= GRAD_TOL


@pytest.mark.parametrize("sort_id", tsc.SORT_ID)
@pytest.mark.parametrize("sf_id", ["pointsf", "listsf_co"])
def test_div_predict_and_expected_ranks_match_jax(sort_id, sf_id):
    cfg = tsc.DivScorerConfig(**SMALL, sf_id=sf_id, sort_id=sort_id)
    tparams, jparams, jcfg = _pair(cfg, seed=2)
    q, d, mask = _batch(seed=3)
    got = tsc.div_predict(tparams, cfg, *(torch.from_numpy(a) for a in (q, d, mask))).numpy()
    want = np.asarray(jsc.div_predict(jparams, jcfg, *(jnp.asarray(a) for a in (q, d, mask))))
    assert _rel(np.where(mask, got, 0.0), np.where(mask, want, 0.0)) <= VALUE_TOL
    mus, vars_, cocos = jsc.div_forward(jparams, jcfg, *(jnp.asarray(a) for a in (q, d, mask)))
    t_out = tsc.expected_ranks(torch.tensor(np.asarray(mus)), torch.tensor(np.asarray(vars_)),
                               torch.from_numpy(mask),
                               None if cocos is None else torch.tensor(np.asarray(cocos)))
    j_out = jsc.expected_ranks(mus, vars_, jnp.asarray(mask), cocos)
    for got, want in zip(t_out, j_out):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=VALUE_TOL, atol=1e-6)


def test_cluster_members_share_dropout_masks():
    """In training, every member of a cluster draws the masks a single member
    would from the generator's starting state; the generator ends where one
    member's forward leaves it."""
    cfg = tsc.DivScorerConfig(**dict(SMALL, dropout=0.3), K=3, cluster=True)
    params = tsc.init_div_scorer(cfg, seed=4)
    member0 = map_params(lambda t: t[0], params)
    same = map_params(lambda t: torch.stack([t[0]] * 3), params)  # three copies of member 0
    q, d, mask = (torch.from_numpy(a) for a in _batch(seed=5))
    g1 = torch.Generator().manual_seed(9)
    mus, vars_, _ = tsc.div_forward(same, cfg, q, d, mask, training=True, gen=g1)
    g2 = torch.Generator().manual_seed(9)
    raw, _ = tsc._single_raw_forward(member0, cfg, q, d, mask, training=True, gen=g2)
    torch.testing.assert_close(mus, raw[..., 1], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(vars_, torch.exp(raw[..., 2]), rtol=1e-6, atol=1e-6)
    assert torch.equal(g1.get_state(), g2.get_state())
    # differing members still draw the same masks: run them one by one
    g3 = torch.Generator().manual_seed(9)
    start = g3.get_state()
    parts = []
    for k in range(3):
        g3.set_state(start)
        parts.append(tsc._single_raw_forward(map_params(lambda t: t[k], params), cfg, q, d, mask,
                                             training=True, gen=g3)[0])
    g4 = torch.Generator().manual_seed(9)
    mus4, _, _ = tsc.div_forward(params, cfg, q, d, mask, training=True, gen=g4)
    comps = torch.stack(parts, dim=-2)
    want = torch.sum(torch.softmax(comps[..., 0], -1) * comps[..., 1], -1)
    torch.testing.assert_close(mus4, want, rtol=0, atol=0)


def test_init_shapes_match_jax_and_refuse_a_bad_cluster():
    for over in CONFIGS:
        cfg = tsc.DivScorerConfig(**SMALL, **over)
        got = tsc.init_div_scorer(cfg, device="meta")
        jp = jsc.init_div_scorer(jax.random.PRNGKey(0),
                                 jsc.DivScorerConfig(**dataclasses.asdict(cfg)))
        # the structural check of div_params_from_jax: same keys and shapes
        div_params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg)
        assert all(t.device.type == "meta" for t in tree_leaves(got))
    with pytest.raises(ValueError, match="cluster"):
        tsc.init_div_scorer(tsc.DivScorerConfig(**SMALL, sf_id="listsf_co", K=3, cluster=True))
    with pytest.raises(ValueError, match="expected shape"):
        jp = jsc.init_div_scorer(jax.random.PRNGKey(0),
                                 jsc.DivScorerConfig(**dict(SMALL, sf_id="pointsf", K=3)))
        div_params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                            tsc.DivScorerConfig(**SMALL, sf_id="pointsf"))
