"""The port's losses (ptranking_tpu_torch/losses, ops/pairwise_fused.py)
against the JAX package's: value and gradient in the scores for all 14 model
ids, the fused pairwise loss's plain path against the JAX Pallas kernel in
interpret mode, pad invariance and degenerate queries. The stochastic losses
get the JAX draws injected: the JAX loss takes a key, the port takes
`noise = jax.random.uniform(key, shape)`. Tolerances as tests/test_pallas.py:
rtol 1e-5 on values, rtol 1e-4 and atol 1e-6 on gradients (fp32, other
summation orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptranking_tpu.losses import DEFAULT_PARAS as JAX_DEFAULT_PARAS
from ptranking_tpu.losses import get_loss as jax_get_loss
from ptranking_tpu.ops.pallas import lambda_rank_pallas, ranknet_pallas
from ptranking_tpu_torch.losses import DEFAULT_PARAS, LOSSES, STOCHASTIC, get_loss
from ptranking_tpu_torch.ops import pairwise_fused

torch.set_num_threads(1)


def _batch(B=3, N=20, lengths=None, seed=0):
    """Presorted labels (descending, pads last), ragged masks and an all-padded row."""
    rng = np.random.RandomState(seed)
    scores = rng.randn(B, N).astype(np.float32)
    labels = -np.sort(-rng.randint(0, 5, (B, N)).astype(np.float32), axis=1)
    lengths = lengths or (N, N - 5, 0)
    mask = np.arange(N)[None, :] < np.asarray(lengths)[:, None]
    return scores, np.where(mask, labels, 0.0).astype(np.float32), mask


KEY = jax.random.PRNGKey(137)


def _noise(shape):
    """The uniform draws the JAX stochastic losses make from KEY."""
    return np.array(jax.random.uniform(KEY, shape))


def _jax_value_grad(fn, scores, labels, mask):
    value, grad = jax.value_and_grad(lambda s: fn(s, jnp.asarray(labels), jnp.asarray(mask)))(
        jnp.asarray(scores))
    return float(value), np.asarray(grad)


def _torch_value_grad(fn, scores, labels, mask):
    s = torch.from_numpy(scores).requires_grad_(True)
    value = fn(s, torch.from_numpy(labels), torch.from_numpy(mask))
    (grad,) = torch.autograd.grad(value, s)
    return float(value.detach()), grad.numpy()


def _assert_match(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4, atol=1e-6)


def _both(model_id, paras, pre=None):
    """(jax fn, port fn) of one model id: `pre` maps the scores first (both
    sides differentiate through it); a stochastic id gets KEY / the noise of
    KEY. use_pallas is the port's switch only."""
    jparas = {k: v for k, v in paras.items() if k != "use_pallas"}
    jpre, tpre = pre or (lambda s: s, lambda s: s)

    def jfn(s, l, m):
        kw = {"key": KEY} if model_id in STOCHASTIC else {}
        return jax_get_loss(model_id)(jpre(s), l, m, **jparas, **kw)

    def tfn(s, l, m):
        kw = {"noise": torch.from_numpy(_noise(tuple(s.shape)))} if model_id in STOCHASTIC else {}
        return get_loss(model_id)(tpre(s), l, m, **paras, **kw)

    return jfn, tfn


SIGMOID = (jax.nn.sigmoid, torch.sigmoid)
LOSS_CASES = {
    "RankMSE": ("RankMSE", {}),
    "RankNet": ("RankNet", {"sigma": 1.5}),
    "RankNet-fused": ("RankNet", {"sigma": 1.5, "use_pallas": True}),
    "LambdaRank": ("LambdaRank", {"sigma": 1.0}),
    "LambdaRank-fused": ("LambdaRank", {"sigma": 1.0, "use_pallas": True}),
    "ListNet": ("ListNet", {}),
    "DASALC": ("DASALC", {}),
    "STListNet": ("STListNet", {"temperature": 1.3}),
    "ListMLE": ("ListMLE", {}),
    "MDPRank-PL": ("MDPRank", {"distribution": "PL", "top_k": 10}),
    "MDPRank-STPL": ("MDPRank", {"distribution": "STPL", "temperature": 1.5, "gamma": 0.9,
                                 "top_k": None}),
    "RankCosine": ("RankCosine", {}),
    "ApproxNDCG": ("ApproxNDCG", {"alpha": 10.0}),
    "LambdaLoss-Loss1": ("LambdaLoss", {"loss_type": "NDCG_Loss1", "k": 5}),
    "LambdaLoss-Loss2": ("LambdaLoss", {"loss_type": "NDCG_Loss2", "k": 5, "sigma": 1.2}),
    "LambdaLoss-Loss2pp": ("LambdaLoss", {"loss_type": "NDCG_Loss2++", "k": 8, "mu": 5.0}),
    "SoftRank": ("SoftRank", {"delta": 2.0}),
    "SoftRank-top5": ("SoftRank", {"delta": 1.0, "top_k": 5}),
    "NeuralNDCG": ("NeuralNDCG", {"temperature": 1.0, "sinkhorn_iters": 10}),
    "NeuralNDCG-top5": ("NeuralNDCG", {"temperature": 0.7, "sinkhorn_iters": 3, "top_k": 5}),
    **{f"WassRank-{mode}-{cost}": ("WassRank", {"mode": mode, "cost_type": cost})
       for mode in ("SinkhornOT", "EntropicOT") for cost in ("p1", "p2", "eg", "dg", "ddg")},
    "WassRank-NG": ("WassRank", {"smooth_type": "NG"}),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_loss_matches_jax(case):
    """The port's loss (either path) against the JAX package's lax path, with
    the model id's default hyper-parameters under the case's. WassRank sees
    sigmoid scores, as the ranker's scorer gives it."""
    model_id, paras = LOSS_CASES[case]
    scores, labels, mask = _batch()
    wass = model_id == "WassRank"
    jfn, tfn = _both(model_id, {**JAX_DEFAULT_PARAS[model_id], **paras}, SIGMOID if wass else None)
    _assert_match(_torch_value_grad(tfn, scores, labels, mask),
                  _jax_value_grad(jfn, scores, labels, mask))


@pytest.mark.parametrize("N,lengths", [(20, (20, 15, 0)), (300, (300, 257, 40, 0))],
                         ids=["N20", "N300-multitile"])
@pytest.mark.parametrize("loss", ["LambdaRank", "RankNet"])
def test_fused_plain_matches_jax_pallas_interpret(loss, N, lengths):
    """use_pallas=True on the CPU (the kernels' plain versions) against the
    JAX Pallas kernel in interpret mode, one tile and several tiles of 256."""
    scores, labels, mask = _batch(B=len(lengths), N=N, lengths=lengths)
    if loss == "LambdaRank":
        jfn = lambda s, l, m: lambda_rank_pallas(s, l, m, sigma=1.0, interpret=True)
        tfn = lambda s, l, m: get_loss(loss)(s, l, m, sigma=1.0, use_pallas=True)
    else:
        jfn = lambda s, l, m: ranknet_pallas(s, l, m, sigma=1.5, interpret=True)
        tfn = lambda s, l, m: get_loss(loss)(s, l, m, sigma=1.5, use_pallas=True)
    _assert_match(_torch_value_grad(tfn, scores, labels, mask),
                  _jax_value_grad(jfn, scores, labels, mask))


PAD_CASES = {
    **{model_id: (model_id, {}) for model_id in sorted(LOSSES)},
    "RankNet-fused": ("RankNet", {"use_pallas": True}),
    "LambdaRank-fused": ("LambdaRank", {"use_pallas": True}),
    "WassRank-EntropicOT": ("WassRank", {"mode": "EntropicOT"}),
}


def _default_fn(case, cases=PAD_CASES):
    """The port's loss of a case under its default hyper-parameters; a
    stochastic one with noise from a seed, of the scores' shape."""
    model_id, paras = cases[case]

    def fn(s, l, m):
        kw = {}
        if model_id in STOCHASTIC:
            kw["noise"] = torch.rand(s.shape, generator=torch.Generator().manual_seed(5))
        if model_id == "WassRank":
            s = torch.sigmoid(s)
        return get_loss(model_id)(s, l, m, **{**DEFAULT_PARAS[model_id], **paras}, **kw)

    return fn


@pytest.mark.parametrize("case", list(PAD_CASES))
def test_pad_contents_change_nothing(case):
    """Pad scores set to 1e3 and pad labels to 7 leave the value and the
    gradient the same (the pads' gradient is 0 either way)."""
    scores, labels, mask = _batch()
    fn = _default_fn(case)
    v1, g1 = _torch_value_grad(fn, scores, labels, mask)
    v2, g2 = _torch_value_grad(fn, np.where(mask, scores, 1e3).astype(np.float32),
                               np.where(mask, labels, 7.0).astype(np.float32), mask)
    assert np.isfinite(v1)
    np.testing.assert_allclose(v2, v1, rtol=1e-5)
    np.testing.assert_allclose(g2, g1, rtol=1e-4, atol=1e-6)
    assert not g1[~mask].any()


@pytest.mark.parametrize("case", [c for c in PAD_CASES if PAD_CASES[c][0] not in STOCHASTIC])
def test_pad_width_changes_nothing(case):
    """Three more padded slots per list leave a deterministic loss the same
    (a stochastic one draws noise of another shape). atol 2e-4 as
    tests/test_losses.py: WassRank's log_u0 = -log N moves with the width and
    20 iterations do not quite forget it."""
    scores, labels, mask = _batch()
    fn = _default_fn(case)
    v1 = float(fn(*(torch.from_numpy(a) for a in (scores, labels, mask))))
    B = scores.shape[0]
    wide = (np.concatenate([scores, np.full((B, 3), -4.2, np.float32)], 1),
            np.concatenate([labels, np.ones((B, 3), np.float32)], 1),
            np.concatenate([mask, np.zeros((B, 3), bool)], 1))
    v2 = float(fn(*(torch.from_numpy(a) for a in wide)))
    np.testing.assert_allclose(v2, v1, rtol=1e-5, atol=2e-4)


@pytest.mark.parametrize("case", list(PAD_CASES))
def test_grads_finite_with_degenerate_queries(case):
    """An all-padded query, a single-doc query and a query whose labels are
    all zero poison neither the value nor the gradients."""
    scores, labels, mask = _batch(B=3, N=6, lengths=(0, 1, 6))
    labels[2] = 0.0
    v, g = _torch_value_grad(_default_fn(case), scores, labels, mask)
    assert np.isfinite(v) and np.isfinite(g).all()
    assert not g[~mask].any()


def test_wassrank_all_padded_rows_do_not_dilute():
    """All-padded remainder rows do not shrink WassRank's mean over queries."""
    scores, labels, mask = _batch(B=2, N=10, lengths=(10, 6))
    fn = _default_fn("WassRank")
    v1 = float(fn(*(torch.from_numpy(a) for a in (scores, labels, mask))))
    pad = np.zeros((3, 10), np.float32)
    v2 = float(fn(torch.from_numpy(np.concatenate([scores, pad])),
                  torch.from_numpy(np.concatenate([labels, pad])),
                  torch.from_numpy(np.concatenate([mask, pad.astype(bool)]))))
    np.testing.assert_allclose(v2, v1, rtol=1e-5)


def test_get_loss_names_unported_ids():
    """Every model id of the JAX package has a loss in the port (none is
    left unported); an unknown id raises a KeyError that lists the known."""
    assert sorted(LOSSES) == sorted(JAX_DEFAULT_PARAS) and sorted(DEFAULT_PARAS) == sorted(LOSSES)
    assert DEFAULT_PARAS == JAX_DEFAULT_PARAS
    for model_id in LOSSES:
        assert callable(get_loss(model_id))
    with pytest.raises(KeyError, match="unknown model id"):
        get_loss("TwinRank")


def test_stochastic_losses_need_a_generator_or_noise():
    """Without gen or noise a stochastic loss raises; with a generator it is
    repeatable from the generator's seed."""
    scores, labels, mask = (torch.from_numpy(a) for a in _batch())
    for model_id in sorted(STOCHASTIC):
        loss = get_loss(model_id)
        with pytest.raises(ValueError, match="gen"):
            loss(scores, labels, mask)
        a, b, c = (float(loss(scores, labels, mask, gen=torch.Generator().manual_seed(seed)))
                   for seed in (3, 3, 4))
        assert a == b and np.isfinite(a)
        assert a != c or model_id == "ListMLE"  # ListMLE's draws only break ties


def test_pairwise_kernel_wrappers_refuse_cpu_tensors():
    """The kernel wrappers raise on CPU tensors before any build or launch,
    and count nothing; the CPU path goes through the plain versions."""
    s = torch.zeros(2, 8)
    m = torch.ones(2, 8, dtype=torch.bool)
    fwd, bwd = pairwise_fused.PairwiseLambdaFwd(), pairwise_fused.PairwiseLambdaBwd()
    with pytest.raises(ValueError, match="CUDA tensors"):
        fwd(s, s, s, m)
    with pytest.raises(ValueError, match="float32"):
        bwd(s.double(), s, s, m, torch.ones(1))
    assert fwd.launches == 0 and bwd.launches == 0
