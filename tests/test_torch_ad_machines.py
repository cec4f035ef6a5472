"""The port's six minimax machines against the JAX package's, one step each:
both players' JAX params carried across (`params_from_jax`), the JAX step's
draws rebuilt by replaying its key splits through the JAX util functions
and injected into the port's step (`draws=`), then the loss and both
players' params after one Adam step held to 1e-5 relative (each param
leaf in norm), with dropout off and the scorer's batch norm off (on in
test_torch_ad_padding.py). A bias a batch norm follows has a gradient of
rounding alone, which Adam scales to about +-lr: it is held to a move of
at most 1.01 lr instead."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptranking_tpu.adversarial import AD_DEFAULT_PARAS as JAX_PARAS
from ptranking_tpu.adversarial import AD_MACHINES as JAX_MACHINES
from ptranking_tpu.adversarial import AdSFSetting as JaxAdSFSetting
from ptranking_tpu.adversarial import util as ju
from ptranking_tpu.models import apply_scorer as jax_apply_scorer
from ptranking_tpu.ops import masked_softmax as jax_masked_softmax
from ptranking_tpu_torch.adversarial import AD_DEFAULT_PARAS, AD_MACHINES, AdSFSetting
from ptranking_tpu_torch.models.convert import params_from_jax
from ptranking_tpu_torch.models.scorers import tree_leaves

torch.set_num_threads(1)

F, N = 8, 12
TOL = 1e-5
SMALL = dict(num_features=F, num_layers=2, h_dim=16, dropout=0.0)


def _sf(setting, bn):
    sf = setting(sf_id="pointsf").default_setting(F)
    sf["scorer"] = dataclasses.replace(sf["scorer"], BN=bn, **SMALL)
    return sf


def _batch(pad: bool):
    """Four presorted queries of 12, 9, 6 and 3 docs: the second has no
    positive, the last only positives (IRGAN_Pair's empty negative mask);
    `pad` appends an all-masked query (a bucketed remainder row)."""
    rng = np.random.RandomState(5)
    lengths = [12, 9, 6, 3] + ([0] if pad else [])
    B = len(lengths)
    feats = rng.randn(B, N, F).astype(np.float32)
    mask = np.arange(N)[None, :] < np.asarray(lengths)[:, None]
    labels = np.zeros((B, N), np.float32)
    labels[0, :5] = [2, 2, 1, 1, 1]
    labels[2, :2] = [2, 1]
    labels[3, :3] = [2, 1, 1]
    if pad:
        feats[-1] = rng.randn(N, F)  # garbage in the pad row: it must not matter
    return feats, labels, mask


def _jax_draws(jm, model_id, step, key, f, l, m):
    """The draws of the JAX machine's step under `key`, by its own splits."""
    g = jm.generator
    B, N_ = m.shape
    S = jm.samples_per_query
    npos = jnp.sum((l > 0) & m, axis=-1)
    g_pred = g.predict_scaled(g.params, f, m)

    def g_train_scores():
        s = jax_apply_scorer(g.params, g.scorer_cfg, f, m, training=True)
        return s / g.temperature if g.temperature not in (None, 1.0) else s

    if model_id in ("IRGAN_List", "IRFGAN_List"):
        if step == "d":
            k_g, k_t = jax.random.split(key)
            return {"gen_unif": jax.random.uniform(k_g, (B, S, N_)),
                    "std_unif": jax.random.uniform(k_t, (B, S, N_))}
        return {"gen_unif": jax.random.uniform(key, (B, S, N_))}
    if model_id == "IRFGAN_Pair":
        k_true, k_fake, _ = jax.random.split(key, 3)
        true_logits, _ = jm._true_pair_logits(l, m)
        bt = jax.nn.log_sigmoid(g_pred[..., :, None] - g_pred[..., None, :])
        bt = jnp.where(m[..., :, None] & m[..., None, :], bt, -1e30)
        return {name: jax.random.categorical(k, lg.reshape(B, N_ * N_)[:, None, :], axis=-1,
                                             shape=(B, S))
                for name, k, lg in (("true_idx", k_true, true_logits), ("fake_idx", k_fake, bt))}
    if model_id == "IRFGAN_Point" and step == "g":
        return {"neg_unif": jax.random.uniform(key, (B, N_))}
    if step == "d" and model_id == "IRGAN_Pair" and jm.truth_sampling != "uniform":
        k_t, k_n = jax.random.split(key)
        if jm.truth_sampling == "discounted":
            head, tail, _ = ju.generate_true_pairs(k_t, l, m, S)
        elif jm.truth_sampling == "BT":
            head, tail = ju.sample_pairs_bt(k_t, l, m, S)
        else:
            head, tail = ju.sample_pairs_gaussian(k_t, l, m, S)
        neg_mask = m & (jnp.arange(N_)[None] >= npos[:, None])
        return {"truth_idx": head * N_ + tail,
                "neg_idx": ju.sample_categorical_masked(k_n, g_pred, neg_mask, S)}
    k_pos, k_neg = jax.random.split(key)
    if step == "d":  # IRGAN_Point, IRGAN_Pair (uniform), IRFGAN_Point
        neg_mask = m
        if model_id == "IRGAN_Pair":
            neg_mask = m & (jnp.arange(N_)[None] >= npos[:, None])
        return {"pos_unif": jax.random.uniform(k_pos, (B, S)),
                "neg_idx": ju.sample_categorical_masked(k_neg, g_pred, neg_mask, S)}
    if model_id == "IRGAN_Point":
        g_probs = jax_masked_softmax(g_train_scores(), m)
        pos = jnp.arange(N_)[None] < npos[:, None]
        prob_is = g_probs * 0.5 + jnp.where(pos, 0.5 / jnp.maximum(npos[:, None], 1), 0.0)
        prob_is = jnp.where(m, prob_is, 0.0)
        return {"choose_idx": ju.sample_categorical_masked(
            key, jnp.log(jnp.maximum(prob_is, 1e-20)), m, 5 * S)}
    # IRGAN_Pair's G step
    g_probs = jax.nn.sigmoid(g_train_scores())
    return {"pos_unif": jax.random.uniform(k_pos, (B, S)),
            "neg_idx": ju.sample_categorical_masked(
                k_neg, jnp.log(jnp.maximum(jnp.where(m, g_probs, 0.0), 1e-20)), m, S)}


def _np_params(player):
    return jax.tree_util.tree_map(np.asarray, player.params)


def _pair(model_id, paras, bn):
    """(JAX machine, the port's machine on the CPU with the JAX params)."""
    jm = JAX_MACHINES[model_id](sf_para=_sf(JaxAdSFSetting, bn),
                                ad_para_dict=dict(JAX_PARAS[model_id], **paras), seed=3)
    tm = AD_MACHINES[model_id](sf_para=_sf(AdSFSetting, bn),
                               ad_para_dict=dict(AD_DEFAULT_PARAS[model_id], **paras), seed=3,
                               device="cpu")
    for jp, tp in ((jm.generator, tm.generator), (jm.discriminator, tm.discriminator)):
        tp.params = params_from_jax(_np_params(jp), tp.scorer_cfg)
        tp._start_training_state()
    return jm, tm


def _jax_step(jm, step, key, f, l, m):
    """Run the JAX machine's step; returns its loss and updates its players."""
    g, d = jm.generator, jm.discriminator
    if step == "joint":
        (g.params, g.opt_state, d.params, d.opt_state, d_loss, g_loss) = jm._joint_step(
            g.params, g.opt_state, d.params, d.opt_state, key, f, l, m)
        return np.asarray([d_loss, g_loss])
    player, other, fn = (d, g, jm._d_step) if step == "d" else (g, d, jm._g_step)
    player.params, player.opt_state, loss = fn(player.params, player.opt_state, other.params,
                                               key, f, l, m)
    return np.asarray(loss)


def _port_step(tm, step, f, l, m, draws):
    if step == "joint":
        return torch.stack(tm._joint_step(f, l, m, draws)).numpy()
    return (tm._d_step if step == "d" else tm._g_step)(f, l, m, draws).numpy()


def _bn_biases(params) -> set:
    """Positions (in tree_leaves order) of the linear biases a batch norm
    follows: their gradient is rounding alone (the norm subtracts any shift),
    which Adam scales to about +-lr whatever its sign."""
    marks = {id(lp["linear"]["b"]) for lp in params["point_sf"]["layers"] if "bn" in lp}
    return {i for i, t in enumerate(tree_leaves(params)) if id(t) in marks}


def _assert_leaves_close(want_players, tm, before, tol):
    """Each param leaf of both port players within `tol` relative in norm of
    the wanted leaves; a bias a batch norm follows moved by at most 1.01 lr
    on both sides instead."""
    for want, tp, old in zip(want_players, (tm.generator, tm.discriminator), before):
        noise = _bn_biases(tp.params)
        lr = tp.opt_cfg.lr
        for i, (w, t, o) in enumerate(zip(want, tree_leaves(tp.params), old)):
            w, t = w.detach(), t.detach()
            if i in noise:
                assert float((t - o).abs().max()) <= 1.01 * lr
                assert float((w - o).abs().max()) <= 1.01 * lr
                continue
            err = float(torch.linalg.norm(t - w) / torch.linalg.norm(w).clamp_min(1e-30))
            assert err <= tol, (i, tuple(w.shape), err)


def _assert_params_close(jm, tm, before, tol=TOL):
    _assert_leaves_close([tree_leaves(params_from_jax(_np_params(jp), tp.scorer_cfg))
                          for jp, tp in ((jm.generator, tm.generator),
                                         (jm.discriminator, tm.discriminator))],
                         tm, before, tol)


def _leaves_before(tm):
    return [[t.detach().clone() for t in tree_leaves(p.params)]
            for p in (tm.generator, tm.discriminator)]


STEPS = {"IRGAN_Point": ("d", "g"), "IRGAN_Pair": ("d", "g"), "IRGAN_List": ("d", "g"),
         "IRFGAN_Point": ("d", "g"), "IRFGAN_Pair": ("joint",), "IRFGAN_List": ("d", "g")}
# batch norm off here; on in test_torch_ad_padding.py, which runs every
# machine's steps against JAX's
CASES = [(mid, step, {}, False) for mid in AD_MACHINES for step in STEPS[mid]]
# the options each machine's step branches on
CASES += [("IRGAN_Pair", "d", {"truth_sampling": t}, False)
          for t in ("discounted", "BT", "Gaussian")]
CASES += [("IRGAN_Pair", step, {"loss_type": "log"}, False) for step in ("d", "g")]
CASES += [("IRGAN_List", "d", {"PL_D": False, "repTrick_D": False}, False),
          ("IRGAN_List", "g", {"PL_D": False, "repTrick_G": True, "dropLog": True}, False),
          ("IRGAN_List", "g", {"dropLog": True}, False),
          ("IRGAN_List", "g", {"repTrick_G": True}, False),
          ("IRFGAN_Point", "d", {"f_div_id": "JS", "temperature": 0.7}, False),
          ("IRFGAN_Pair", "joint", {"f_div_id": "GAN"}, False),
          ("IRFGAN_List", "g", {"f_div_id": "TVar"}, False)]


@pytest.mark.parametrize("model_id,step,paras,bn", CASES,
                         ids=[f"{c[0]}-{c[1]}-{'-'.join(f'{k}={v}' for k, v in c[2].items())}"
                              f"-{'BN' if c[3] else 'noBN'}" for c in CASES])
def test_step_matches_jax(model_id, step, paras, bn):
    jm, tm = _pair(model_id, paras, bn)
    before = _leaves_before(tm)
    f, l, m = _batch(pad=False)
    key = jax.random.PRNGKey(17)
    jf, jl, jmk = jnp.asarray(f), jnp.asarray(l), jnp.asarray(m)
    draws = {k: np.asarray(v) for k, v in _jax_draws(jm, model_id, step, key, jf, jl, jmk).items()}
    want = _jax_step(jm, step, key, jf, jl, jmk)
    got = _port_step(tm, step, torch.from_numpy(f), torch.from_numpy(l), torch.from_numpy(m),
                     draws)
    assert np.all(np.isfinite(want))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=1e-7)
    _assert_params_close(jm, tm, before)
