"""The port's adhoc metrics (ptranking_tpu_torch/metrics/{adhoc,smooth}.py)
against the JAX package's on ragged batches with ties and an all-padded row,
the reference's golden values (those of tests/test_metrics_adhoc.py), and the
four smooth objectives (value and gradient in the smooth ranks). Both sides
run the same fp32 operations: rtol 1e-6 and atol 1e-7 on metric values, rtol
1e-5 on the objectives, rtol 1e-4 and atol 1e-6 on their gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptranking_tpu.metrics import adhoc as jm
from ptranking_tpu.metrics.smooth import SMOOTH_OBJECTIVES as J_SMOOTH
from ptranking_tpu.types import LabelType as JLabelType
from ptranking_tpu_torch.losses.listwise import approx_ranks
from ptranking_tpu_torch.metrics import adhoc as tm
from ptranking_tpu_torch.metrics.smooth import SMOOTH_OBJECTIVES
from ptranking_tpu_torch.types import LabelType

torch.set_num_threads(1)

B, N = 4, 30
LENGTHS = (N, 11, 2, 0)  # a full list, ragged ones, an all-padded row
KS = (1, 3, 5, 10, 20, 50)


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    scores = (rng.randint(0, 40, (B, N)) / 8.0).astype(np.float32)  # some ties
    labels = rng.randint(0, 5, (B, N)).astype(np.float32)
    mask = np.arange(N)[None, :] < np.asarray(LENGTHS)[:, None]
    return scores, np.where(mask, labels, 0.0).astype(np.float32), mask


def _sorted(seed=0):
    """(pred_sorted, ideal_sorted, n) from the JAX package's own sorting."""
    from ptranking_tpu.ops.sorting import ideal_sorted_labels, sort_labels_by_scores

    scores, labels, mask = (jnp.asarray(a) for a in _inputs(seed))
    _, pred, _ = sort_labels_by_scores(scores, labels, mask)
    return np.asarray(pred), np.asarray(ideal_sorted_labels(labels, mask)), mask.sum(-1)


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64),
                               rtol=1e-6, atol=1e-7)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


METRIC_CASES = {
    "precision": (lambda p, i, n: jm.precision_at_ks(p, n, KS),
                  lambda p, i, n: tm.precision_at_ks(p, n, KS)),
    "ap": (lambda p, i, n: jm.ap_at_ks(p, i, n, KS), lambda p, i, n: tm.ap_at_ks(p, i, n, KS)),
    "nerr": (lambda p, i, n: jm.nerr_at_ks(p, i, n, KS),
             lambda p, i, n: tm.nerr_at_ks(p, i, n, KS)),
    "nerr_max_label": (lambda p, i, n: jm.nerr_at_ks(p, i, n, KS, max_label=4.0),
                       lambda p, i, n: tm.nerr_at_ks(p, i, n, KS, max_label=4.0)),
    "ndcg": (lambda p, i, n: jm.ndcg_at_ks(p, i, n, KS), lambda p, i, n: tm.ndcg_at_ks(p, i, n, KS)),
    "ndcg_permutation": (
        lambda p, i, n: jm.ndcg_at_ks(p, i, n, KS, JLabelType.Permutation),
        lambda p, i, n: tm.ndcg_at_ks(p, i, n, KS, LabelType.Permutation)),
    "dcg": (lambda p, i, n: jm.dcg(p), lambda p, i, n: tm.dcg(p)),
    "dcg_point": (lambda p, i, n: jm.dcg(p, cumulative=False),
                  lambda p, i, n: tm.dcg(p, cumulative=False)),
    "rankwise_err": (lambda p, i, n: jm.rankwise_err(p, 4.0), lambda p, i, n: tm.rankwise_err(p, 4.0)),
    "rankwise_err_point": (lambda p, i, n: jm.rankwise_err(p, 4.0, point=True),
                           lambda p, i, n: tm.rankwise_err(p, 4.0, point=True)),
}


@pytest.mark.parametrize("name", sorted(METRIC_CASES))
def test_metric_matches_jax(name):
    jfn, tfn = METRIC_CASES[name]
    pred, ideal, n = _sorted()
    _close(tfn(*_t(pred, ideal, n)), jfn(jnp.asarray(pred), jnp.asarray(ideal), jnp.asarray(n)))


@pytest.mark.parametrize("max_label", [None, 4.0])
def test_evaluate_all_at_ks_matches_jax(max_label):
    """From raw scores with ties: the same stable sort, so the same metrics;
    a k beyond a list's real docs and the all-padded row give 0."""
    scores, labels, mask = _inputs()
    want = jm.evaluate_all_at_ks(jnp.asarray(scores), jnp.asarray(labels), jnp.asarray(mask), KS,
                                 max_label=max_label)
    got = tm.evaluate_all_at_ks(*_t(scores, labels, mask), KS, max_label=max_label)
    assert sorted(got) == sorted(want)
    for key in want:
        _close(got[key], want[key])
    assert not got["nDCG"][3].any() and not got["P"][1, 4:].any()


def _row(vals):
    return torch.tensor([vals], dtype=torch.float32), torch.tensor([len(vals)])


GOLDEN = {  # (fn, sys, ideal, ks, expected, atol): the reference's hand-computed oracles
    "ap_all_relevant": ("ap", [1, 0, 1, 0, 1], [1, 1, 1, 1, 1], (1, 3, 5),
                        [1.0, 0.5556, 0.4533], 1e-4),
    "ap_three_relevant": ("ap", [1, 0, 1, 0, 1], [1, 1, 1, 0, 0], (1, 3, 5),
                          [1.0, 0.5556, 0.7556], 1e-4),
    "ap_seven": ("ap", [1, 1, 0, 1, 0, 0, 1], [1, 1, 1, 1, 0, 0, 0], (1, 2, 3, 5, 7),
                 [1.0, 1.0, 0.6667, 0.6875, 0.8304], 1e-4),
    "ndcg": ("ndcg", [1, 1, 0, 1, 0, 0, 1], [1, 1, 1, 1, 0, 0, 0], (1, 2, 3, 4, 5, 6, 7),
             [1.0, 1.0, 0.7654, 0.8048, 0.8048, 0.8048, 0.9349], 1e-4),
    "nerr": ("nerr", [3, 2, 4], [4, 3, 2], (1, 2, 3), [0.4667, 0.5154, 0.6640], 1e-4),
    "precision_graded_counts_as_binary": ("p", [2, 0, 1, 0], None, (1, 2, 4), [1.0, 0.5, 0.5], 1e-6),
    "ndcg_k_beyond_n_is_zero": ("ndcg", [1, 0, 1], [1, 1, 0], (3, 5, 10),
                                [0.9197207891481876, 0.0, 0.0], 1e-6),
}


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_golden_values(name):
    fn, sys_labels, ideal, ks, expected, atol = GOLDEN[name]
    sys_t, n = _row([float(v) for v in sys_labels])
    if fn == "p":
        got = tm.precision_at_ks(sys_t, n, ks)
    else:
        ideal_t, _ = _row([float(v) for v in ideal])
        got = {"ap": tm.ap_at_ks, "ndcg": tm.ndcg_at_ks, "nerr": tm.nerr_at_ks}[fn](
            sys_t, ideal_t, n, ks)
    np.testing.assert_allclose(got[0].numpy(), expected, atol=atol)


def test_kendall_tau_matches_scipy_and_jax():
    from scipy import stats

    reference = np.arange(1.0, 11.0)
    for sys_ranking in ([2.0, 1.0, 5.0, 3.0, 4.0, 6.0, 7.0, 9.0, 8.0, 10.0],
                        [10.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 9.0, 1.0]):
        expect, _ = stats.kendalltau(reference, np.asarray(sys_ranking))
        for ascending in (True, False):
            got = tm.kendall_tau(torch.tensor(sys_ranking), ascending)
            _close(got, jm.kendall_tau(jnp.asarray(sys_ranking), ascending))
        np.testing.assert_allclose(float(tm.kendall_tau(torch.tensor(sys_ranking))), expect,
                                   atol=1e-6)


def test_padding_changes_no_metric():
    rng = np.random.default_rng(0)
    n, pad_to = 7, 16
    scores = rng.normal(size=n).astype(np.float32)
    labels = rng.integers(0, 3, size=n).astype(np.float32)
    ks = (1, 3, 5, 7)
    r1 = tm.evaluate_all_at_ks(torch.from_numpy(scores)[None], torch.from_numpy(labels)[None],
                               torch.ones(1, n, dtype=torch.bool), ks, max_label=2.0)
    s2, l2, m2 = torch.zeros(1, pad_to), torch.zeros(1, pad_to), torch.zeros(1, pad_to, dtype=torch.bool)
    s2[0, :n], l2[0, :n], m2[0, :n] = torch.from_numpy(scores), torch.from_numpy(labels), True
    r2 = tm.evaluate_all_at_ks(s2, l2, m2, ks, max_label=2.0)
    for key in ("nDCG", "nERR", "AP", "P"):
        np.testing.assert_allclose(r1[key].numpy(), r2[key].numpy(), atol=1e-5, err_msg=key)


@pytest.mark.parametrize("top_k", [None, 5])
@pytest.mark.parametrize("opt_ideal", [True, False])
@pytest.mark.parametrize("metric", sorted(SMOOTH_OBJECTIVES))
def test_smooth_objective_matches_jax(metric, opt_ideal, top_k):
    """Value and gradient in the smooth ranks (the approximated ranks of
    random scores, labels presorted descending, an all-padded row)."""
    scores, labels, mask = _inputs(seed=2)
    scores = np.random.RandomState(5).randn(B, N).astype(np.float32)  # no ties: one resort order
    labels = np.where(mask, -np.sort(-labels, axis=1), 0.0).astype(np.float32)
    ranks = approx_ranks(torch.from_numpy(scores), torch.from_numpy(mask)).numpy()
    jfn = lambda r: J_SMOOTH[metric](r, jnp.asarray(labels), jnp.asarray(mask), top_k=top_k,
                                     opt_ideal=opt_ideal)
    want_v, want_g = jax.value_and_grad(jfn)(jnp.asarray(ranks))
    tr = torch.from_numpy(ranks).requires_grad_(True)
    value = SMOOTH_OBJECTIVES[metric](tr, torch.from_numpy(labels), torch.from_numpy(mask),
                                      top_k=top_k, opt_ideal=opt_ideal)
    (grad,) = torch.autograd.grad(value, tr)
    np.testing.assert_allclose(float(value.detach()), float(want_v), rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_g), rtol=1e-4, atol=1e-6)
