"""The port's ranking primitives
(ptranking_tpu_torch/ops/{gains,sorting,pairwise,sigmoid,cumulative}.py)
against the JAX package's, on lists with ties, ragged masks and an all-padded
row. Outputs are compared exactly where both compute the same operations in
the same order, else at fp32 rounding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptranking_tpu import ops as jops
from ptranking_tpu.types import LabelType as JLabelType
from ptranking_tpu_torch import ops as tops
from ptranking_tpu_torch.types import LabelType

torch.set_num_threads(1)

B, N = 4, 12
LENGTHS = (N, 7, 1, 0)  # a full list, a ragged one, one doc, an all-padded row


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    scores = (rng.randint(0, 5, (B, N)) / 2.0).astype(np.float32)  # many ties
    labels = rng.randint(0, 5, (B, N)).astype(np.float32)
    mask = np.arange(N)[None, :] < np.asarray(LENGTHS)[:, None]
    return scores, labels, mask


def _jt(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


def _close(out, ref, exact=False):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    if exact:
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out.astype(np.float64), ref.astype(np.float64),
                                   rtol=1e-6, atol=1e-7)


CASES = {
    "gain_multilabel": (lambda s, l, m: jops.gain(l, JLabelType.MultiLabel),
                        lambda s, l, m: tops.gain(l, LabelType.MultiLabel), False),
    "gain_permutation": (lambda s, l, m: jops.gain(l, JLabelType.Permutation),
                         lambda s, l, m: tops.gain(l, LabelType.Permutation), True),
    "masked_softmax": (lambda s, l, m: jops.masked_softmax(s, m),
                       lambda s, l, m: tops.masked_softmax(s, m), False),
    "masked_log_softmax": (lambda s, l, m: jops.masked_log_softmax(s, m),
                           lambda s, l, m: tops.masked_log_softmax(s, m), False),
    "mask_scores": (lambda s, l, m: jops.mask_scores(s, m),
                    lambda s, l, m: tops.mask_scores(s, m), True),
    "ideal_sorted_labels": (lambda s, l, m: jops.ideal_sorted_labels(l, m),
                            lambda s, l, m: tops.ideal_sorted_labels(l, m), True),
    "pairwise_diffs": (lambda s, l, m: jops.pairwise_diffs(s),
                       lambda s, l, m: tops.pairwise_diffs(s), True),
    "pair_mask": (lambda s, l, m: jops.pair_mask(m), lambda s, l, m: tops.pair_mask(m), True),
    "triu_pair_mask": (lambda s, l, m: jops.triu_pair_mask(m),
                       lambda s, l, m: tops.triu_pair_mask(m), True),
    "pairwise_comp_probs_p": (lambda s, l, m: jops.pairwise_comp_probs(s, l, sigma=1.5)[0],
                              lambda s, l, m: tops.pairwise_comp_probs(s, l, sigma=1.5)[0], False),
    "pairwise_comp_probs_std": (lambda s, l, m: jops.pairwise_comp_probs(s, l)[1],
                                lambda s, l, m: tops.pairwise_comp_probs(s, l)[1], True),
    "robust_sigmoid": (lambda s, l, m: jops.robust_sigmoid(s - 1.0, 10.0),
                       lambda s, l, m: tops.robust_sigmoid(s - 1.0, 10.0), False),
    "vanilla_sigmoid": (lambda s, l, m: jops.vanilla_sigmoid(s - 1.0, 0.5),
                        lambda s, l, m: tops.vanilla_sigmoid(s - 1.0, 0.5), False),
    "logcumsumexp_reverse": (lambda s, l, m: jops.logcumsumexp_reverse(s, m),
                             lambda s, l, m: tops.logcumsumexp_reverse(s, m), False),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_primitive_matches_jax(name):
    jfn, tfn, exact = CASES[name]
    (js, jl, jm), (ts, tl, tm) = _jt(*_inputs())
    _close(tfn(ts, tl, tm).numpy(), jfn(js, jl, jm), exact)


def test_sort_labels_by_scores_matches_jax_on_ties():
    """Stable descending sort with ties and pads: the same order, so the same
    three outputs bit for bit."""
    (js, jl, jm), (ts, tl, tm) = _jt(*_inputs())
    for out, ref in zip(tops.sort_labels_by_scores(ts, tl, tm),
                        jops.sort_labels_by_scores(js, jl, jm)):
        _close(out.numpy(), ref, exact=True)


@pytest.mark.parametrize("label_type", ["MultiLabel", "Permutation"])
def test_delta_ndcg_matches_jax(label_type):
    (js, jl, jm), (ts, tl, tm) = _jt(*_inputs())
    j_ideal = jops.ideal_sorted_labels(jl, jm)
    _, j_pred, j_smask = jops.sort_labels_by_scores(js, jl, jm)
    t_ideal = tops.ideal_sorted_labels(tl, tm)
    _, t_pred, t_smask = tops.sort_labels_by_scores(ts, tl, tm)
    ref = jops.delta_ndcg(j_ideal, j_pred, j_smask, JLabelType[label_type])
    out = tops.delta_ndcg(t_ideal, t_pred, t_smask, LabelType[label_type])
    _close(out.numpy(), ref)
    assert not out[3].any()  # the all-padded row has no pair


def test_shuffle_ties_argsort_orders_labels_and_shuffles_ties():
    """A permutation per row that sorts real labels descending with pads
    last; different generators break ties differently (the JAX package draws
    its noise from a PRNG key, so the two are compared by these properties)."""
    _, labels, mask = _inputs()
    tl, tm = torch.from_numpy(labels), torch.from_numpy(mask)
    orders = set()
    for seed in range(8):
        order = tops.shuffle_ties_argsort(torch.Generator().manual_seed(seed), tl, tm)
        assert torch.equal(torch.sort(order, dim=-1).values, torch.arange(N).expand(B, N))
        for b, n in enumerate(LENGTHS):
            row = order[b]
            assert set(row[:n].tolist()) == set(np.flatnonzero(mask[b]).tolist())
            real = tl[b][row[:n]]
            assert bool(torch.all(real[:-1] >= real[1:]))
        orders.add(tuple(order[0].tolist()))
    assert len(orders) > 1


def test_logcumsumexp_reverse_with_pads_anywhere_matches_jax():
    """Pads in the middle of a list add nothing; value and gradient."""
    scores, _, _ = _inputs()
    mask = np.random.RandomState(3).rand(B, N) < 0.6
    mask[3] = False
    want_g = jax.grad(lambda x: jnp.sum(jnp.where(
        jnp.asarray(mask), jops.logcumsumexp_reverse(x, jnp.asarray(mask)), 0.0)))(jnp.asarray(scores))
    ts = torch.from_numpy(scores).requires_grad_(True)
    tm = torch.from_numpy(mask)
    out = tops.logcumsumexp_reverse(ts, tm)
    _close(out.detach().numpy(), jops.logcumsumexp_reverse(jnp.asarray(scores), jnp.asarray(mask)))
    (grad,) = torch.autograd.grad(torch.sum(torch.where(tm, out, 0.0)), ts)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("descending", [True, False])
def test_shuffle_ties_argsort_with_injected_noise_gives_the_jax_order(descending):
    """The JAX package sorts on (label, uniform(key)) pairs; given the same
    draws as `noise`, the port's two sorts give the same order, exactly."""
    _, labels, mask = _inputs()
    key = jax.random.PRNGKey(11)
    want = jops.shuffle_ties_argsort(key, jnp.asarray(labels), jnp.asarray(mask), descending)
    noise = torch.from_numpy(np.array(jax.random.uniform(key, labels.shape)))
    got = tops.shuffle_ties_argsort(None, torch.from_numpy(labels), torch.from_numpy(mask),
                                    descending, noise=noise)
    _close(got.numpy(), want, exact=True)
