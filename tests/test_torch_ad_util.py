"""The port's adversarial utilities against the JAX package's: the
deterministic functions within 1e-6 on the same inputs (made from a seed
with numpy), the samplers with the JAX draws injected (`unif=`), and every
sampler's empirical distribution on a seeded torch.Generator against its
analytic one (total-variation distance within 2 * sqrt(K / n) for K
categories and n draws), all-pad rows included."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptranking_tpu.adversarial import util as ju
from ptranking_tpu.utils.chunking import iter_shape_chunks as jax_iter_shape_chunks
from ptranking_tpu_torch.adversarial import util as tu
from ptranking_tpu_torch.utils.chunking import iter_shape_chunks

torch.set_num_threads(1)

TOL = 1e-6
DRAWS = 1 << 17


def _mask(B, N, lengths):
    return np.arange(N)[None, :] < np.asarray(lengths)[:, None]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=tol, atol=tol)


def _tv(samples, probs):
    """(TV distance of the samples' frequencies from probs, its bound)."""
    probs = np.asarray(probs, np.float64).ravel()
    emp = np.bincount(np.asarray(samples).ravel(), minlength=probs.size) / np.size(samples)
    support = int(np.sum(probs > 0))
    return 0.5 * np.abs(emp - probs).sum(), 2.0 * np.sqrt(support / np.size(samples))


# --- deterministic functions against JAX --------------------------------------


@pytest.mark.parametrize("fn", ["log_ranking_prob_pl", "log_ranking_prob_bt"])
def test_ranking_log_probs_match_jax(fn):
    rng = np.random.RandomState(0)
    preds = (3 * rng.randn(5, 9)).astype(np.float32)
    mask = _mask(5, 9, [9, 4, 1, 0, 7])
    want = getattr(ju, fn)(_j(preds), _j(mask))
    got = getattr(tu, fn)(_t(preds), _t(mask))
    _close(got, want)
    assert float(got[3]) == 0.0  # an all-pad row adds nothing


@pytest.mark.parametrize("f_div", tu.F_DIVERGENCES)
def test_f_divergence_pairs_match_jax(f_div):
    v = np.linspace(-3, 3, 41).astype(np.float32)
    ja, jc = ju.get_f_divergence_functions(f_div)
    ta, tc = tu.get_f_divergence_functions(f_div)
    t_j, t_t = ja(_j(v)), ta(_t(v))
    _close(t_t, t_j)
    _close(tc(t_t), jc(t_j), tol=1e-5)
    # the conjugates' clamps on arguments outside their domain, as in JAX
    wide = np.linspace(-4, 4, 33).astype(np.float32)
    _close(tc(_t(wide)), jc(_j(wide)), tol=1e-5)


def test_unknown_f_divergence_raises():
    with pytest.raises(NotImplementedError):
        tu.get_f_divergence_functions("Hellinger")


def test_subranking_helpers_match_jax():
    rng = np.random.RandomState(1)
    B, N, F, S, k = 3, 7, 4, 2, 5
    feats = rng.randn(B, N, F).astype(np.float32)
    order = np.stack([np.stack([rng.permutation(N)[:k] for _ in range(S)]) for _ in range(B)])
    _close(tu.gather_subrankings(_t(feats), _t(order)),
           ju.gather_subrankings(_j(feats), _j(order)), tol=0.0)
    mask = _mask(B, N, [7, 3, 0])
    sm_t, w_t = tu.subranking_masks(_t(mask), S, k)
    sm_j, w_j = ju.subranking_masks(_j(mask), S, k)
    np.testing.assert_array_equal(sm_t.numpy(), np.asarray(sm_j))
    _close(w_t, w_j, tol=0.0)
    x = rng.randn(B * S).astype(np.float32)
    _close(tu.weighted_mean(_t(x), w_t), ju.weighted_mean(_j(x), w_j))


def test_pair_weights_and_gaussian_integral_match_jax():
    rng = np.random.RandomState(2)
    labels = rng.randint(-1, 4, size=(3, 8)).astype(np.float32)
    mask = _mask(3, 8, [8, 5, 0])
    _close(tu.weighted_clipped_pos_diffs(_t(labels), _t(mask)),
           ju.weighted_clipped_pos_diffs(_j(labels), _j(mask)))
    mu = (4 * rng.randn(50)).astype(np.float32)
    for sigma in (1.0, np.sqrt(2.0), 2.5):
        _close(tu.gaussian_integral_0_inf(_t(mu), sigma), ju.gaussian_integral_0_inf(_j(mu), sigma))


@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_iter_shape_chunks_matches_jax(chunk):
    class B:
        def __init__(self, i, n):
            self.i, self.features = i, np.zeros((2, n, 1))

    shapes = [4] * 7 + [8] * 3 + [16] * 9 + [4] * 2
    batches = [B(i, n) for i, n in enumerate(shapes)]
    got = [([b.i for b in c], fused) for c, fused in iter_shape_chunks(batches, chunk)]
    want = [([b.i for b in c], fused) for c, fused in jax_iter_shape_chunks(batches, chunk)]
    assert got == want


# --- the samplers with the JAX draws injected ---------------------------------


def test_samplers_with_injected_draws_match_jax():
    rng = np.random.RandomState(3)
    B, N, S, k = 4, 9, 3, 5
    scores = rng.randn(B, N).astype(np.float32)
    labels = rng.randint(0, 3, size=(B, N)).astype(np.float32)
    mask = _mask(B, N, [9, 6, 2, 0])
    key = jax.random.PRNGKey(11)
    # sample_uniform_positions
    counts = np.asarray([3, 1, 0, 9], np.int32)
    u = np.asarray(jax.random.uniform(key, (B, S)))
    np.testing.assert_array_equal(
        tu.sample_uniform_positions(_t(counts), S, N, unif=u).numpy(),
        np.asarray(ju.sample_uniform_positions(key, _j(counts), S, N)))
    # Gumbel top-k without replacement (pads tie in index order)
    u = np.asarray(jax.random.uniform(key, (B, N)))
    np.testing.assert_array_equal(
        tu.sample_categorical_masked(_t(scores), _t(mask), S, replacement=False,
                                     unif=u).numpy(),
        np.asarray(ju.sample_categorical_masked(key, _j(scores), _j(mask), S, replacement=False)))
    # PL rankings: order and the noisy top-k probs
    u = np.asarray(jax.random.uniform(key, (B, S, N)))
    o_t, p_t = tu.sample_pl_rankings(_t(scores), _t(mask), S, k, 0.5, unif=u)
    o_j, p_j = ju.sample_pl_rankings(key, _j(scores), _j(mask), S, k, 0.5)
    np.testing.assert_array_equal(o_t.numpy(), np.asarray(o_j))
    _close(p_t, p_j)
    # tie-shuffled truth rankings
    np.testing.assert_array_equal(
        tu.shuffled_truth_rankings(_t(labels), _t(mask), S, k, unif=u).numpy(),
        np.asarray(ju.shuffled_truth_rankings(key, _j(labels), _j(mask), S, k)))
    # an injected categorical draw is returned as the draw
    idx = rng.randint(0, N, size=(B, S))
    np.testing.assert_array_equal(
        tu.sample_categorical_masked(_t(scores), _t(mask), S, idx=idx).numpy(), idx)


# --- distributions on a seeded generator --------------------------------------


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _softmax(x):
    e = np.exp(x - x.max())
    return e / e.sum()


def test_categorical_with_replacement_distribution_and_pads():
    rng = np.random.RandomState(4)
    N = 12
    logits = (1.5 * rng.randn(4, N)).astype(np.float32)
    logits[1, 2] = np.float32(np.log(1e-20))  # a valid entry of vanishing probability
    mask = _mask(4, N, [12, 5, 1, 0])
    draws = tu.sample_categorical_masked(_t(logits), _t(mask), DRAWS, gen=_gen()).numpy()
    for b, n in enumerate([12, 5, 1]):
        probs = np.zeros(N)
        probs[:n] = _softmax(logits[b, :n].astype(np.float64))
        assert draws[b].max() < n  # never a pad
        tv, bound = _tv(draws[b], probs)
        assert tv < bound, (b, tv, bound)
    # an all-pad row draws uniformly and never raises
    tv, bound = _tv(draws[3], np.full(N, 1.0 / N))
    assert tv < bound


def test_categorical_same_seed_same_bits():
    logits = torch.randn(3, 50, generator=_gen(1))
    a = tu.categorical(logits, 1000, _gen(7))
    b = tu.categorical(logits, 1000, _gen(7))
    assert torch.equal(a, b)
    assert not torch.equal(a, tu.categorical(logits, 1000, _gen(8)))


def test_gumbel_top_k_without_replacement_distribution():
    """The first two draws of the Gumbel top-k are sequential draws without
    replacement: P(i, j) = p_i p_j / (1 - p_i); pads come only after every
    valid entry."""
    N, n = 6, 4
    logits = np.asarray([[1.0, 0.2, -0.5, 0.7, 0.0, 0.0]], np.float32)
    mask = _mask(1, N, [n])
    reps = DRAWS // 4
    got = tu.sample_categorical_masked(_t(np.repeat(logits, reps, 0)),
                                       _t(np.repeat(mask, reps, 0)), N, replacement=False,
                                       gen=_gen(2)).numpy()
    assert np.all(got[:, :n] < n) and np.all(got[:, n:] >= n)
    p = _softmax(logits[0, :n].astype(np.float64))
    joint = np.zeros((n, n))
    for i, j in itertools.permutations(range(n), 2):
        joint[i, j] = p[i] * p[j] / (1.0 - p[i])
    tv, bound = _tv(got[:, 0] * n + got[:, 1], joint)
    assert tv < bound, (tv, bound)


def test_uniform_positions_distribution():
    counts = torch.tensor([5, 1, 0])
    got = tu.sample_uniform_positions(counts, DRAWS, 8, gen=_gen(3)).numpy()
    tv, bound = _tv(got[0], np.full(5, 0.2))
    assert tv < bound
    assert np.all(got[1] == 0) and np.all(got[2] == 0)  # count 0 is clipped safe


def test_pl_rankings_distribution():
    """Top-2 of the Gumbel PL draw: P(i, j) = PL(i, j) of softmax(scores)."""
    N, n = 5, 4
    scores = np.asarray([[0.9, -0.3, 0.4, 0.1, 7.0]], np.float32)
    mask = _mask(1, N, [n])
    reps = DRAWS // 4
    order, probs = tu.sample_pl_rankings(_t(scores), _t(mask), reps, 2, 0.5, gen=_gen(4))
    order = order[0].numpy()
    assert order.max() < n
    p = _softmax(scores[0, :n].astype(np.float64))
    joint = np.zeros((n, n))
    for i, j in itertools.permutations(range(n), 2):
        joint[i, j] = p[i] * p[j] / (1.0 - p[i])
    tv, bound = _tv(order[:, 0] * n + order[:, 1], joint)
    assert tv < bound, (tv, bound)
    assert bool(torch.all((probs > 0) & (probs <= 1)))


def test_shuffled_truth_rankings_distribution():
    labels = torch.tensor([[2.0, 1.0, 1.0, 1.0, 0.0, 5.0]])
    mask = _t(_mask(1, 6, [5]))
    got = tu.shuffled_truth_rankings(labels, mask, DRAWS // 4, 5, gen=_gen(5))[0].numpy()
    assert np.all(got[:, 0] == 0) and np.all(got[:, 4] == 4)
    tv, bound = _tv(got[:, 1] - 1, np.full(3, 1 / 3))  # the tied 1s shuffle uniformly
    assert tv < bound


def test_true_pairs_distribution():
    labels = torch.tensor([[2.0, 1.0, 0.0, -1.0, 0.0]])
    mask = _t(_mask(1, 5, [4]))
    head, tail, has = tu.generate_true_pairs(labels, mask, DRAWS, gen=_gen(6))
    assert bool(has[0])
    w = tu.weighted_clipped_pos_diffs(labels, mask)[0].numpy().astype(np.float64)
    tv, bound = _tv((head * 5 + tail)[0].numpy(), w / w.sum())
    assert tv < bound, (tv, bound)
    lab = labels[0].numpy()
    assert np.all(lab[head[0].numpy()] > lab[tail[0].numpy()])


def _two_stage_probs(p: np.ndarray) -> np.ndarray:
    """The exact distribution of sample_points_bernoulli's draw over the
    flattened pairs: every Bernoulli outcome enumerated."""
    p = p.ravel().astype(np.float64)
    live = np.nonzero(p > 0)[0]
    out = np.zeros_like(p)
    for bits in itertools.product((0, 1), repeat=live.size):
        b = np.zeros_like(p)
        b[live] = bits
        pr = np.prod(np.where(b[live] > 0, p[live], 1.0 - p[live]))
        out += pr * (b / b.sum() if b.sum() else p / p.sum())
    return out


@pytest.mark.parametrize("sampler", ["bt", "gaussian"])
def test_bernoulli_pair_samplers_distribution(sampler):
    """One Bernoulli outcome a row, so the marginal is taken over DRAWS rows
    of one draw each."""
    vals = torch.tensor([[1.5, 0.0, -1.0, 9.9]]).expand(DRAWS, 4)
    mask = _t(_mask(1, 4, [3])).expand(DRAWS, 4)
    if sampler == "bt":
        head, tail = tu.sample_pairs_bt(vals, mask, 1, gen=_gen(7))
        probs = torch.sigmoid(vals[0, :, None] - vals[0, None, :])
    else:
        head, tail = tu.sample_pairs_gaussian(vals, mask, 1, sigma=1.0, gen=_gen(7))
        probs = tu.gaussian_integral_0_inf(vals[0, :, None] - vals[0, None, :], np.sqrt(2.0))
    probs = torch.where(mask[0, :, None] & mask[0, None, :], probs, 0.0)
    want = _two_stage_probs(torch.clamp(probs, 0, 1).numpy())
    tv, bound = _tv((head * 4 + tail).numpy(), want)
    assert tv < bound, (tv, bound)
    assert int(head.max()) <= 2 and int(tail.max()) <= 2


def test_all_pad_rows_draw_without_error():
    """Rows with nothing valid (a bucketed batch's all-padded remainder, an
    all-positive list's empty negative mask) draw indices in range, as
    JAX's categorical does, for every sampler."""
    gen = _gen(8)
    N, S = 6, 64
    none = torch.zeros(2, N, dtype=torch.bool)
    scores = torch.randn(2, N, generator=gen)
    for replacement in (True, False):
        idx = tu.sample_categorical_masked(scores, none, S if replacement else N,
                                           replacement=replacement, gen=gen)
        assert int(idx.min()) >= 0 and int(idx.max()) < N
    head, tail = tu.sample_points_bernoulli(torch.zeros(2, N, N), S, gen=gen)
    assert int(head.max()) < N and int(tail.max()) < N
    head, tail, has = tu.generate_true_pairs(torch.zeros(2, N), none, S, gen=gen)
    assert not bool(has.any()) and int(head.max()) < N
    order, probs = tu.sample_pl_rankings(scores, none, 3, 4, 0.5, gen=gen)
    assert order.shape == (2, 3, 4) and bool(torch.isfinite(probs).all())


def test_profiling_aids(tmp_path):
    """utils/profiling.py: StepTimer's report has JAX's keys, force fetches
    every leaf, trace writes a Chrome trace, enable_debug_nans toggles
    autograd's anomaly mode."""
    import os

    from ptranking_tpu.utils.profiling import StepTimer as JaxStepTimer
    from ptranking_tpu_torch.utils import profiling

    timer = profiling.StepTimer()
    for _ in range(3):
        timer.step(torch.ones(2), lists=4)
    rep = timer.report({"a": torch.ones(3)})
    assert set(rep) == set(JaxStepTimer().report())
    assert rep["steps"] == 2 and rep["lists_per_s"] > 0
    assert profiling.force({"a": torch.ones(3), "b": [torch.full((2,), 2.0)]}) == 7.0
    with profiling.trace(str(tmp_path)):
        torch.ones(4) @ torch.ones(4)
    assert [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    try:
        profiling.enable_debug_nans(True)
        assert torch.is_anomaly_enabled()
    finally:
        profiling.enable_debug_nans(False)
    assert not torch.is_anomaly_enabled()
