"""The port's losses (ptranking_tpu_torch/losses, ops/pairwise_fused.py)
against the JAX package's: value and gradient in the scores, the fused
pairwise loss's plain path against the JAX Pallas kernel in interpret mode,
and pad invariance. Tolerances as tests/test_pallas.py: rtol 1e-5 on values,
rtol 1e-4 and atol 1e-6 on gradients (fp32, other summation orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptranking_tpu.losses import get_loss as jax_get_loss
from ptranking_tpu.ops.pallas import lambda_rank_pallas, ranknet_pallas
from ptranking_tpu_torch.losses import get_loss
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


@pytest.mark.parametrize("model_id,paras", [
    ("RankMSE", {}),
    ("RankNet", {"sigma": 1.5}),
    ("RankNet", {"sigma": 1.5, "use_pallas": True}),
    ("LambdaRank", {"sigma": 1.0}),
    ("LambdaRank", {"sigma": 1.0, "use_pallas": True}),
    ("ListNet", {}),
], ids=["RankMSE", "RankNet", "RankNet-fused", "LambdaRank", "LambdaRank-fused", "ListNet"])
def test_loss_matches_jax(model_id, paras):
    """The port's loss (either path) against the JAX package's lax path."""
    scores, labels, mask = _batch()
    jparas = {k: v for k, v in paras.items() if k != "use_pallas"}
    want = _jax_value_grad(lambda s, l, m: jax_get_loss(model_id)(s, l, m, **jparas),
                           scores, labels, mask)
    got = _torch_value_grad(lambda s, l, m: get_loss(model_id)(s, l, m, **paras),
                            scores, labels, mask)
    _assert_match(got, want)


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


@pytest.mark.parametrize("model_id,paras", [
    ("RankMSE", {}), ("RankNet", {}), ("RankNet", {"use_pallas": True}),
    ("LambdaRank", {}), ("LambdaRank", {"use_pallas": True}), ("ListNet", {}),
], ids=["RankMSE", "RankNet", "RankNet-fused", "LambdaRank", "LambdaRank-fused", "ListNet"])
def test_pad_contents_change_nothing(model_id, paras):
    """Pad scores set to 1e3 leave the value and the gradient the same (the
    pads' gradient is 0 either way)."""
    scores, labels, mask = _batch()
    fn = lambda s, l, m: get_loss(model_id)(s, l, m, **paras)
    v1, g1 = _torch_value_grad(fn, scores, labels, mask)
    v2, g2 = _torch_value_grad(fn, np.where(mask, scores, 1e3).astype(np.float32), labels, mask)
    np.testing.assert_allclose(v2, v1, rtol=1e-5)
    np.testing.assert_allclose(g2, g1, rtol=1e-4, atol=1e-6)
    assert not g1[~mask].any()


def test_get_loss_names_unported_ids():
    with pytest.raises(KeyError, match="not ported yet"):
        get_loss("ListMLE")
    with pytest.raises(KeyError, match="unknown model id"):
        get_loss("TwinRank")


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
