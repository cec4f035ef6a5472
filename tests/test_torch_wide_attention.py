"""Head dims above 128 and grids past 65535 blocks a dimension.

The wide attention kernels (d > 128) of csrc/flash_attn_{fwd,bwd}.cu compute
the same formulas at the same rounding points as the narrow ones, so their
plain versions are attention_forward_plain and attention_backward_plain:
here those are held against the JAX package's blockwise attention and its
gradients at the head dims of the Yahoo! LTR listsf (F=700 over 2 heads:
d = 350, or 384 under lane_align) and of a one-head F=136 listsf (d = 136);
tests/test_torch_scorers.py holds the port's F=700 listsf against the JAX
scorer. The kernels themselves run only on the card (chip_smoke.py). Then the shape
contracts of the attention and pairwise wrappers, which take B*H (attention)
and B (pairwise) past 65535: the attention kernels of d <= 128 in launches
of whole lists, the wide ones and the pairwise kernels with the batch folded
into grid.x."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptranking_tpu.ops import attention as jattn
from ptranking_tpu_torch.ops import attention as tattn
from ptranking_tpu_torch.ops import pairwise_fused

torch.set_num_threads(1)

# three lists: a full one, a ragged one, an all-padded remainder row; N is
# ragged against the kernels' 64-row tiles
B, H, N = 3, 2, 70
LENGTHS = (N, 41, 0)
WIDE_DS = [136, 350, 384]


def _case(d, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v, cot = (rng.randn(B, H, N, d).astype(np.float32) for _ in range(4))
    mask = np.arange(N)[None, :] < np.asarray(LENGTHS)[:, None]
    cot = np.where(mask[:, None, :, None], cot, 0.0).astype(np.float32)
    return q, k, v, cot, mask


@pytest.mark.parametrize("d", WIDE_DS)
def test_wide_forward_plain_matches_jax_blockwise(d):
    """fp32: attention_forward_plain == JAX blockwise_attention on real query
    rows, atol 1e-5 (summation order and tile boundaries only); every row,
    the all-padded list's included, finite, and that list's statistics are
    m = -1e9, l = N."""
    q, k, v, _, mask = _case(d)
    ref = np.asarray(jattn.blockwise_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                               jnp.asarray(mask), block_size=64))
    out, m, l = tattn.attention_forward_plain(*(torch.from_numpy(a) for a in (q, k, v, mask)))
    assert torch.isfinite(out).all()
    real = np.broadcast_to(mask[:, None, :, None], out.shape)
    np.testing.assert_allclose(out.numpy()[real], ref[real], rtol=0, atol=1e-5)
    assert bool((m[2] == -1e9).all()) and bool((l[2] == N).all())


@pytest.mark.parametrize("d", WIDE_DS)
def test_wide_backward_plain_matches_jax_grad(d):
    """fp32: attention_backward_plain, from attention_forward_plain's output
    and row statistics (what the wide forward gives the wide backward),
    against jax.grad through JAX blockwise_attention for an output gradient
    on real rows, over the lists with a real document: rtol 1e-4, atol 1e-5
    (summation order). The all-padded list's gradients are finite."""
    q, k, v, cot, mask = _case(d)

    def jloss(q, k, v):
        return jnp.sum(jattn.blockwise_attention(q, k, v, jnp.asarray(mask), block_size=64) * cot)

    ref = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv, tcot, tm = (torch.from_numpy(a) for a in (q, k, v, cot, mask))
    out, m, l = tattn.attention_forward_plain(tq, tk, tv, tm)
    got = tattn.attention_backward_plain(tq, tk, tv, tcot, out, m, l, tm)
    real = mask.any(axis=1)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy()[real], np.asarray(r)[real], rtol=1e-4, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("d", WIDE_DS)
def test_wide_bf16_forward_plain_matches_blockwise(d):
    """bf16: attention_forward_plain against the port's blockwise_attention
    on real query rows within chip_smoke.py's ATTN_TOL (2e-2): both round p
    and the output to bf16, relative to another running max."""
    q, k, v, _, mask = _case(d)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    tm = torch.from_numpy(mask)
    out, _, _ = tattn.attention_forward_plain(tq, tk, tv, tm)
    ref = tattn.blockwise_attention(tq, tk, tv, tm, block_size=64)
    real = tm[:, None, :, None].expand_as(out)
    assert torch.isfinite(out.float()).all()
    assert float((out.float() - ref.float()).abs()[real].max()) <= 2e-2


# ---------------------------------------------------------------------------
# shape contracts: batches past grid.y's 65535
# ---------------------------------------------------------------------------


def test_attention_shape_check_takes_any_head_dim_and_a_large_batch():
    """check_grid takes every head dim and B*H past 65535 (B = 32769, H = 2);
    it raises only where a launch would pass the grid: the kernels of
    d <= 128 take b*h from grid.y and run a larger batch in launches of
    whole lists (kernel_launches); the wide kernels fold everything, their
    output chunks (64 columns at the finest) included, into grid.x."""
    tattn.check_grid(32769, 2, 16, 8)
    for d in (129, 136, 350, 384, 520, 4096):
        tattn.check_grid(4, 2, 128, d)
    assert tattn.kernel_launches(32769, 2, 16, 8) == 2
    assert tattn.kernel_launches(32767, 2, 16, 8) == 1
    assert tattn.kernel_launches(32769, 2, 16, 350) == 1
    assert tattn.kernel_launches(256, 2, 128, 68) == 1
    tattn.check_grid(1, 65535, 16, 128)
    for shape in ((1, 65536, 16, 128), (2 ** 20, 2 ** 5, 2 ** 13, 136)):
        with pytest.raises(ValueError, match="blocks"):
            tattn.check_grid(*shape)
    with pytest.raises(ValueError, match="unsupported"):
        tattn.check_grid(1, 1, 8, 0)


def test_attention_shape_check_fp32_wide_grid_at_d700_past_65535_lists():
    """fp32 at d > 128 runs the 3xTF32 wide kernels, whose block owns all of
    its 64 rows' output columns: check_grid counts 64-row tiles x B*H blocks
    on grid.x (no output chunks), so B*H past 65535 at d = 700 is one launch,
    and only the tiles past 2^31 - 1 raise; bf16 keeps its wide kernels'
    output chunks. The C entries' grid_fits follows the same grid: the fp32
    width is d (one chunk), bf16's the narrowest chunk."""
    tattn.check_grid(32769, 2, 1536, 700, dtype=torch.float32)
    assert tattn.kernel_launches(32769, 2, 1536, 700) == 1
    tattn.check_grid(2 ** 20, 2 ** 4, 2 ** 12, 700, dtype=torch.float32)  # 2^30 blocks
    with pytest.raises(ValueError, match="blocks"):
        tattn.check_grid(2 ** 20, 2 ** 4, 2 ** 12, 700, dtype=torch.bfloat16)  # x 11 chunks
    with pytest.raises(ValueError, match="blocks"):
        tattn.check_grid(2 ** 20, 2 ** 5, 2 ** 12, 700, dtype=torch.float32)  # 2^31
    csrc = tattn.cuda_build.CSRC
    fwd, bwd, hdr = ((csrc / n).read_text() for n in ("flash_attn_fwd.cu", "flash_attn_bwd.cu",
                                                       "mma_common.cuh"))
    assert "    if (!grid_fits(B, H, N, d, dtype == 1 ? 16 * WIDE_CW : d))" in fwd
    assert "    return grid_fits(a.B, a.H, a.N, a.d, dtype == 1 ? 16 * WIDE_CW_DKDV : a.d);" in bwd
    assert ("    return (long long)((N + 63) / 64) * ((d + width - 1) / width) * B * H;" in hdr
            and "return d > 128 ? wide_blocks(B, H, N, d, width) < (1LL << 31) : H <= 65535;"
            in hdr)


def test_attention_wrappers_pass_wide_and_large_shapes_to_the_device_check():
    """The wrappers' own checks accept d > 128 and B*H > 65535: CPU tensors
    of such shapes get as far as the device check, with nothing launched."""
    kern = tattn.FlashAttnFwd()
    for shape in ((32769, 2, 1, 1), (1, 2, 8, 350)):
        t = torch.zeros(shape)
        with pytest.raises(ValueError, match="CUDA tensors"):
            kern(t, t, t, torch.ones(shape[0], shape[2], dtype=torch.bool))
    assert kern.launches == 0


def test_pairwise_shape_check_takes_a_large_batch():
    """check_row_shape takes B past 65535 (B = 70000) and raises only past
    the grid; the wrapper gets a B = 70000 batch as far as the device check.
    The Python tile size is the kernel's."""
    pairwise_fused.check_row_shape(70000, 16)
    pairwise_fused.check_row_shape(32, 1408)
    assert pairwise_fused.tile_pairs(1408) == 66 and pairwise_fused.tile_pairs(128) == 1
    with pytest.raises(ValueError, match="blocks"):
        pairwise_fused.check_row_shape(2 ** 31, 1)
    s = torch.zeros(70000, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pairwise_fused.PairwiseLambdaFwd()(s, s, s, torch.ones(70000, 2, dtype=torch.bool))
    source = (pairwise_fused.cuda_build.CSRC / "pairwise_lambda.cu").read_text()
    assert f"constexpr int TI = {pairwise_fused.TILE};" in source
