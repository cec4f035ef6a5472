"""The port's masked attention (ptranking_tpu_torch/ops/attention.py) against
the JAX package's: the flash path (forward, and dq, dk, dv) against the Pallas
flash kernel run in interpret mode, and the blockwise plain version against
JAX's blockwise. The CUDA kernels themselves run only on the card:
chip_smoke.py holds them against the plain version there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptranking_tpu.ops import attention as jattn
from ptranking_tpu_torch.ops import attention as tattn

torch.set_num_threads(1)

# d=68 is the flagship head dim (F=136 over 2 heads); N=200 is ragged against
# both the 128-key block and the 64-key kernel tile
B, H, N, D = 2, 2, 200, 68


def _inputs(B=B, N=N, lengths=(N, 137), seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, H, N, D).astype(np.float32) for _ in range(3))
    mask = np.arange(N)[None, :] < np.asarray(lengths)[:, None]
    return q, k, v, mask


def _torch(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) if a.dtype != bool else torch.from_numpy(a)
            for a in arrays]


def _real_rows(out, mask):
    return np.asarray(out, np.float32)[np.broadcast_to(mask[:, None, :, None], out.shape)]


def test_flash_attention_matches_jax_pallas_interpret():
    """CPU flash path == the JAX Pallas TPU flash kernel in interpret mode on
    real query rows (fp32; fully padded rows are garbage by contract)."""
    from jax.experimental.pallas import tpu as pltpu

    q, k, v, mask = _inputs()
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jattn.flash_attention(*(jnp.asarray(a) for a in (q, k, v, mask))))
    out = tattn.flash_attention(*_torch(q, k, v, mask)).numpy()
    np.testing.assert_allclose(_real_rows(out, mask), _real_rows(ref, mask), rtol=0, atol=1e-5)


@pytest.mark.parametrize("block", [64, 128, 150])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blockwise_matches_jax(block, dtype):
    """Same blocks, same key padding: every row agrees, padded rows included.
    fp32 atol 1e-5 (summation order only); bf16 atol 4e-3, one bf16 ulp at
    the outputs' magnitude (< 1), since the two packages round the block's p
    and the output at the same points but sum in another order."""
    q, k, v, mask = _inputs()
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    ref = jattn.blockwise_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                    jnp.asarray(mask), block_size=block)
    out = tattn.blockwise_attention(*_torch(q, k, v, dtype=tdt), torch.from_numpy(mask),
                                    block_size=block)
    assert out.dtype == tdt
    atol = 1e-5 if dtype == "float32" else 4e-3
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), rtol=0, atol=atol)


def test_flash_attention_grads_match_jax_pallas_interpret():
    """dq, dk, dv of the CPU flash path (autograd through blockwise) against
    jax.grad through the Pallas flash kernel in interpret mode, for a random
    output gradient on real query rows (what the scorer gives: padded rows'
    outputs reach no loss). fp32; rtol 1e-4, atol 1e-5 (summation order)."""
    from jax.experimental.pallas import tpu as pltpu

    q, k, v, mask = _inputs()
    cot = np.random.RandomState(5).randn(B, H, N, D).astype(np.float32)
    cot = np.where(mask[:, None, :, None], cot, 0.0).astype(np.float32)

    def jloss(q, k, v):
        return jnp.sum(jattn.flash_attention(q, k, v, jnp.asarray(mask)) * cot)

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv, tm = _torch(q, k, v, mask)
    leaves = [t.requires_grad_(True) for t in (tq, tk, tv)]
    out = tattn.flash_attention(*leaves, tm)
    got = torch.autograd.grad(torch.sum(out * torch.from_numpy(cot)), leaves)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-5, err_msg=name)


def test_padded_rows_stay_finite():
    """A batch row with no real document (a bucket's remainder row) and the
    padded doc rows of a real query give finite outputs."""
    q, k, v, mask = _inputs(B=3, lengths=(N, 37, 0))
    out = tattn.flash_attention(*_torch(q, k, v, mask))
    assert torch.isfinite(out).all()


def test_kernel_wrapper_refuses_what_it_cannot_run():
    """The wrapper raises on CPU tensors and out-of-range shapes before any
    build or launch, and counts nothing."""
    q, k, v, mask = _torch(*_inputs())
    kern = tattn.FlashAttnFwd()
    with pytest.raises(ValueError, match="CUDA tensors"):
        kern(q, k, v, mask)
    wide = torch.zeros(1, 1, 8, 130)
    with pytest.raises(ValueError, match="head dim"):
        kern(wide, wide, wide, torch.ones(1, 8, dtype=torch.bool))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kern(q.double(), k.double(), v.double(), mask)
    assert kern.launches == 0
    stats = torch.zeros(B, H, N)
    for bwd in (tattn.FlashAttnBwdDkdv(), tattn.FlashAttnBwdDq()):
        with pytest.raises(ValueError, match="CUDA tensors"):
            bwd(q, k, v, q, stats, stats, stats, mask)
        assert bwd.launches == 0
