"""The port's scorers against the JAX package's `apply_scorer`, with the JAX
params carried across by `params_from_jax`, at a small size (F=16, 2 encoder
layers, narrow FFNs), and the listsf at Yahoo! LTR's width (F=700: head dims
350 and 384) in value and gradient."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptranking_tpu.models import scorers as jsc
from ptranking_tpu_torch.models import scorers as tsc
from ptranking_tpu_torch.models.convert import params_from_jax

torch.set_num_threads(1)

F, B, N = 16, 3, 150
LENGTHS = (N, 41, 0)  # a full list, a ragged one, and an all-padded remainder row


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, N, F).astype(np.float32)
    mask = np.arange(N)[None, :] < np.asarray(LENGTHS)[:, None]
    x[~mask] = 0.0
    return x, mask


def _both(jcfg, x, mask, seed=0):
    """(JAX scores, port scores) for one config and batch, as fp32 numpy."""
    jparams = jsc.init_scorer(jax.random.PRNGKey(seed), jcfg)
    np_tree = jax.tree_util.tree_map(np.asarray, jparams)
    tcfg = tsc.ScorerConfig(**dataclasses.asdict(jcfg))
    tparams = params_from_jax(np_tree, tcfg)
    ref = jsc.apply_scorer(jparams, jcfg, jnp.asarray(x), jnp.asarray(mask))
    out = tsc.apply_scorer(tparams, tcfg, torch.from_numpy(x), torch.from_numpy(mask))
    assert out.dtype == torch.float32 and out.shape == (B, N)
    return np.asarray(ref, np.float32), out.numpy()


def _listsf(**kw):
    return jsc.ScorerConfig.default_listsf(F, encoder_layers=2, ff_dims=(16, 32), **kw)


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("encoder_type", ["DASALC", "AllRank", "AttnDIN"])
def test_listsf_matches_jax(encoder_type, flash):
    x, mask = _batch()
    ref, out = _both(_listsf(encoder_type=encoder_type, flash_attn=flash), x, mask)
    np.testing.assert_allclose(out[mask], ref[mask], rtol=0, atol=1e-4)


@pytest.mark.parametrize("flash", [False, True])
def test_listsf_bf16_matches_jax(flash):
    """bf16 compute: both sides round params and activations to bf16 at the
    same points, but a BLAS may sum in another order, which can move a bf16
    value by an ulp. Held at two bf16 ulps (2^-7 relative) of the largest
    score's magnitude, and at least 8e-3."""
    x, mask = _batch()
    ref, out = _both(_listsf(flash_attn=flash, compute_dtype="bfloat16"), x, mask)
    atol = 2.0 ** -7 * max(1.0, float(np.abs(ref[mask]).max()))
    np.testing.assert_allclose(out[mask], ref[mask], rtol=0, atol=atol)


@pytest.mark.parametrize("kw", [
    dict(BN=True, AF="R"),                      # cross-batch BN
    dict(BN=True, bn_type="BN2", AF="GE"),      # per-query BN, tanh GELU
    dict(BN=False, AF="GE"),                    # GELU, no BN
], ids=["BN-relu", "BN2-gelu", "noBN-gelu"])
def test_pointsf_matches_jax(kw):
    x, mask = _batch()
    ref, out = _both(jsc.ScorerConfig.default_pointsf(F, h_dim=32, num_layers=3, **kw), x, mask)
    np.testing.assert_allclose(out[mask], ref[mask], rtol=0, atol=1e-4)


@pytest.mark.parametrize("cfg", [
    tsc.ScorerConfig.default_listsf(F, encoder_layers=2, ff_dims=(16, 32), flash_attn=True),
    tsc.ScorerConfig.default_listsf(F, encoder_layers=2, ff_dims=(16, 32),
                                    compute_dtype="bfloat16"),
    tsc.ScorerConfig.default_pointsf(F, h_dim=32, num_layers=3),
], ids=["listsf-flash", "listsf-bf16", "pointsf-BN"])
def test_pad_contents_leave_real_scores_bit_identical(cfg):
    x, mask = _batch()
    params = tsc.init_scorer(cfg, seed=3)
    m = torch.from_numpy(mask)
    s0 = tsc.apply_scorer(params, cfg, torch.from_numpy(x), m)
    x2 = x.copy()
    x2[~mask] = np.random.RandomState(9).randn(int((~mask).sum()), F) * 50.0
    s1 = tsc.apply_scorer(params, cfg, torch.from_numpy(x2), m)
    assert torch.equal(s0[m], s1[m])


def test_params_from_jax_refuses_another_config():
    jcfg = _listsf()
    np_tree = jax.tree_util.tree_map(np.asarray, jsc.init_scorer(jax.random.PRNGKey(0), jcfg))
    other = tsc.ScorerConfig.default_listsf(F, encoder_layers=3, ff_dims=(16, 32))
    with pytest.raises(ValueError, match="expected a list of 3"):
        params_from_jax(np_tree, other)


# ---------------------------------------------------------------------------
# the Yahoo! LTR listsf (F=700, 2 heads) against the JAX scorer
# ---------------------------------------------------------------------------

YF, SB, SN = 700, 3, 24
S_LENGTHS = (SN, 11, 0)


@pytest.mark.parametrize("lane_align", [False, True], ids=["d350", "d384"])
def test_yahoo_listsf_matches_jax(lane_align):
    """The DASALC listsf at Yahoo's width (1 encoder layer, 2 heads, narrow
    FFNs), flash_attn=True (the CPU path: blockwise attention on both sides),
    fp32, with the JAX params carried over: the scores on real docs within
    atol 1e-4, and the gradients of sum(scores * w) over real docs within
    2e-4 of each tensor's largest entry (summation order over 700 and 768
    wide rows)."""
    jcfg = jsc.ScorerConfig.default_listsf(YF, encoder_layers=1, ff_dims=(8,),
                                           flash_attn=True, lane_align=lane_align)
    tcfg = tsc.ScorerConfig(**dataclasses.asdict(jcfg))
    assert tcfg.width // tcfg.n_heads == (384 if lane_align else 350)
    rng = np.random.RandomState(1)
    x = rng.randn(SB, SN, YF).astype(np.float32)
    mask = np.arange(SN)[None, :] < np.asarray(S_LENGTHS)[:, None]
    x[~mask] = 0.0
    w = np.where(mask, rng.randn(SB, SN), 0.0).astype(np.float32)

    jparams = jsc.init_scorer(jax.random.PRNGKey(0), jcfg)

    def jloss(p):
        scores = jsc.apply_scorer(p, jcfg, jnp.asarray(x), jnp.asarray(mask))
        return jnp.sum(scores * w), scores

    (_, ref), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg)
    leaves = [t.requires_grad_(True) for t in tsc.tree_leaves(tparams)]
    out = tsc.apply_scorer(tparams, tcfg, torch.from_numpy(x), torch.from_numpy(mask))
    got = torch.autograd.grad(torch.sum(out * torch.from_numpy(w)), leaves)
    np.testing.assert_allclose(out.detach().numpy()[mask], np.asarray(ref)[mask], rtol=0,
                               atol=1e-4)
    want = tsc.tree_leaves(params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), tcfg))
    assert len(want) == len(got)
    for i, (g, r) in enumerate(zip(got, want)):
        scale = max(float(r.abs().max()), 1e-6)
        assert float((g - r).abs().max()) <= 2e-4 * scale, i
