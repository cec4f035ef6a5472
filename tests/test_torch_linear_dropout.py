"""The bf16 `linear_apply` and in-block attention dropout.

bf16 `linear_apply`: the CPU plain version (fp32 product of upcast operands)
against the JAX package's `jnp.dot(x, w, preferred_element_type=f32) + b`
in value and gradient, within one bf16 ulp; and the CUDA route, which
cannot run here, shown through a stub of `torch.mm` that records the dtype
overload's calls. In-block dropout: `blockwise_attention` with drop_rate 0
gives the same bits as before, and with dropout equals dense masked-softmax
attention with the same keep-mask; the listsf trains with attn_block_size
and dropout."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptranking_tpu.models.scorers import nn as jnn
from ptranking_tpu_torch.models import ScorerConfig
from ptranking_tpu_torch.models.scorers import nn
from ptranking_tpu_torch.ops.attention import blockwise_attention
from ptranking_tpu_torch.train import AdhocRanker, OptimizerConfig

torch.set_num_threads(1)

BF16_EPS = 2.0 ** -7  # spacing of bf16 values in [1, 2)


def _bf16_ulp(a: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |a| (normal range)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -126)))) * BF16_EPS


def assert_within_one_bf16_ulp(got, want, abs_terms, k):
    """|got - want| <= one bf16 ulp at the larger of the two, plus twice the
    bound on an fp32 sum of k terms (k * 2^-24 * sum |terms|): both sides
    round one fp32 sum to bf16, summed in other orders, so a value near zero
    by cancellation may part by more than its own ulp."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    tol = _bf16_ulp(np.maximum(np.abs(got), np.abs(want))) + 2 * k * 2.0 ** -24 * abs_terms
    assert np.all(np.abs(got - want) <= tol), float(np.max(np.abs(got - want) - tol))


def _inputs(shape=(3, 17, 24), d_out=40, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    w = (rng.randn(shape[-1], d_out) / np.sqrt(shape[-1])).astype(np.float32)
    b = rng.randn(d_out).astype(np.float32)
    dy = rng.randn(*shape[:-1], d_out).astype(np.float32)
    return x, w, b, dy


def _bf16(a):  # numpy fp32 -> bf16-rounded fp32, the same in both packages
    return torch.from_numpy(a).bfloat16().float().numpy()


@pytest.mark.parametrize("shape,d_out", [((3, 17, 24), 40), ((2, 64, 136), 408),
                                         ((1, 9, 700), 350)])
def test_bf16_linear_plain_matches_jax_within_one_ulp(shape, d_out):
    x, w, b, dy = (_bf16(a) for a in _inputs(shape, d_out))

    def jax_fn(x, w, b):
        return jnn.linear_apply({"w": w, "b": b}, x)

    jx, jw, jb = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, b))
    want, vjp = jax.vjp(jax_fn, jx, jw, jb)
    want_grads = vjp(jnp.asarray(dy, jnp.bfloat16))
    tx, tw, tb = (torch.from_numpy(a).bfloat16().requires_grad_(True) for a in (x, w, b))
    got = nn.linear_apply({"w": tw, "b": tb}, tx)
    assert got.dtype == torch.bfloat16
    got.backward(torch.from_numpy(dy).bfloat16())
    np32 = lambda a: np.asarray(a, np.float32)
    assert_within_one_bf16_ulp(got.detach().float().numpy().reshape(-1, d_out),
                               np32(want).reshape(-1, d_out),
                               np.abs(x.reshape(-1, shape[-1])) @ np.abs(w), shape[-1])
    dy2, x2 = dy.reshape(-1, d_out), x.reshape(-1, shape[-1])
    assert_within_one_bf16_ulp(tx.grad.float().numpy().reshape(-1, shape[-1]),
                               np32(want_grads[0]).reshape(-1, shape[-1]),
                               np.abs(dy2) @ np.abs(w).T, d_out)
    assert_within_one_bf16_ulp(tw.grad.float().numpy(), np32(want_grads[1]),
                               np.abs(x2).T @ np.abs(dy2), x2.shape[0])
    assert_within_one_bf16_ulp(tb.grad.float().numpy(), np32(want_grads[2]),
                               np.abs(dy2).sum(0), x2.shape[0])


def test_bf16_linear_on_cuda_takes_the_dtype_overload(monkeypatch):
    """On CUDA in bf16, linear_apply goes through `_Bf16Linear`: forward and
    both gradient products are `torch.mm(..., out_dtype=torch.float32)` on
    bf16 operands (a stub records them here and computes them in fp32, so
    the result equals the plain version's); CPU tensors and fp32 take the
    plain version."""
    x, w, b, dy = (_bf16(a) for a in _inputs())
    calls = []
    real_mm = torch.mm

    def mm_stub(a, m, *, out_dtype=None):
        calls.append((a.dtype, m.dtype, out_dtype))
        return real_mm(a.float(), m.float())

    def run(route):
        tx, tw, tb = (torch.from_numpy(a).bfloat16().requires_grad_(True) for a in (x, w, b))
        with monkeypatch.context() as m:
            if route:
                m.setattr(nn, "_takes_bf16_gemm", lambda x, p: True)
                m.setattr(torch, "mm", mm_stub)
            y = nn.linear_apply({"w": tw, "b": tb}, tx)
            y.backward(torch.from_numpy(dy).bfloat16())
        return [t.detach().float().numpy() for t in (y, tx.grad, tw.grad, tb.grad)]

    plain = run(False)
    assert calls == []
    routed = run(True)
    assert calls == [(torch.bfloat16, torch.bfloat16, torch.float32)] * 3
    for got, want in zip(routed, plain):
        assert_within_one_bf16_ulp(got, want, np.zeros_like(want), 0)
    cpu = torch.zeros(2, 3, dtype=torch.bfloat16)
    p16 = {"w": torch.zeros(3, 4, dtype=torch.bfloat16), "b": torch.zeros(4, dtype=torch.bfloat16)}
    assert not nn._takes_bf16_gemm(cpu, p16)


def _attn_inputs(B=2, H=2, N=37, d=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, H, N, d, generator=g) for _ in range(3))
    mask = torch.arange(N)[None, :] < torch.tensor([N, 20])[:, None]
    return q, k, v, mask


def test_blockwise_attention_without_dropout_keeps_its_bits():
    q, k, v, mask = _attn_inputs()
    base = blockwise_attention(q, k, v, mask, block_size=16)
    for kw in ({"drop_rate": 0.0}, {"drop_rate": 0.0, "gen": torch.Generator().manual_seed(1)},
               {"drop_rate": 0.3, "gen": None}):
        assert torch.equal(blockwise_attention(q, k, v, mask, block_size=16, **kw), base)


@pytest.mark.parametrize("block,N", [(16, 37), (8, 32), (64, 20)])
def test_blockwise_dropout_equals_dense_dropout_with_the_same_keep_mask(block, N):
    """Each block draws its keep-mask [B, H, N, block] from the generator in
    turn; the dense form drops the softmax probabilities with those masks
    laid side by side: the same output to 1e-6 (fp32)."""
    q, k, v, mask = _attn_inputs(N=N)
    rate = 0.3
    got = blockwise_attention(q, k, v, mask, block_size=block, drop_rate=rate,
                              gen=torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    B, H, _, d = q.shape
    width = min(block, N)
    n_blocks = -(-N // width)
    keep = torch.cat([torch.rand((B, H, N, width), generator=gen) < 1.0 - rate
                      for _ in range(n_blocks)], dim=-1)[..., :N]
    logits = torch.where(mask[:, None, None, :], q @ k.transpose(-1, -2) / np.sqrt(d), -1e9)
    attn = torch.softmax(logits, dim=-1)
    want = torch.where(keep, attn / (1.0 - rate), 0.0) @ v
    real = mask[:, None, :, None].expand_as(want)
    torch.testing.assert_close(got[real], want[real], rtol=1e-6, atol=1e-6)
    assert not torch.allclose(got, blockwise_attention(q, k, v, mask, block_size=block))


def test_listsf_trains_with_attn_block_size_and_dropout():
    """The scorer's attn_block_size path takes attention dropout in training
    (it raised before): a LambdaRank step runs and its loss is finite; out
    of training the blockwise path's scores equal the dense path's."""
    cfg = ScorerConfig.default_listsf(8, encoder_layers=1, ff_dims=(8, 8), attn_block_size=16,
                                      dropout=0.2)
    ranker = AdhocRanker("LambdaRank", cfg, opt_cfg=OptimizerConfig(opt="Adam", lr=1e-3),
                         device="cpu").init()
    rng = np.random.RandomState(0)
    from ptranking_tpu_torch.types import RankingBatch
    mask = np.arange(40)[None, :] < np.array([40, 25])[:, None]
    batch = RankingBatch(rng.randn(2, 40, 8).astype(np.float32),
                         np.where(mask, rng.randint(0, 3, (2, 40)), 0).astype(np.float32), mask)
    loss, stop = ranker.train_epoch([batch], epoch_k=1)
    assert np.isfinite(loss) and not stop
    dense = AdhocRanker("LambdaRank", dataclasses.replace(cfg, attn_block_size=None),
                        device="cpu")
    dense.params = ranker.params
    torch.testing.assert_close(ranker.predict(batch)[torch.from_numpy(mask)],
                               dense.predict(batch)[torch.from_numpy(mask)],
                               rtol=1e-5, atol=1e-5)
