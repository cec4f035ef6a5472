"""The fp32 attention forward at head dims up to 128: csrc/flash_attn_fwd.cu's
flash_fwd_tf32_kernel (3xTF32 tensor-core products, the head dim padded to a
multiple of 8), behind the forward entry with dtype 0.

The kernel runs only on the card (chip_smoke.py holds it against
blockwise_attention and attention_forward_plain there). Here: its contract
with the package (the entry's dispatch, an instantiation for every d of
1..128, shared memory within a block's, the route, the launch count), and
attention_forward_plain, the formulas it computes, against the JAX
package's Pallas flash kernel in interpret mode at the flagship's head dim
with more than two of the kernel's 64-key tiles, and the definition of the
row statistics the backward reads."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptranking_tpu.ops import attention as jattn
from ptranking_tpu_torch.ops import attention as tattn

torch.set_num_threads(1)

SMEM_PER_BLOCK = 232448  # the H100's shared memory a block may have


def _source() -> str:
    return (tattn.cuda_build.CSRC / "flash_attn_fwd.cu").read_text()


def _constant(source: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", source).group(1))


def _narrow_dispatch(source: str) -> str:
    body = source[source.index("int launch_narrow(const void* q"):]
    return body[:body.index("\n}\n")]


def _cases(switch: str, launch: str) -> list:
    return [int(a) for a, b in re.findall(rf"case (\d+): return int\({launch}<(\d+)> ARGS\);",
                                          switch) if a == b]


def test_f32_narrow_forward_dispatch():
    """launch_narrow sends fp32 (dtype 0) to flash_fwd_tf32_kernel through a
    (d + 7) / 8 switch with cases 1..16, so every d of 1..128 has an
    instantiation with fewer than 8 pad columns; bf16 keeps its (d + 15) / 16
    switch over the tensor-core kernel."""
    src = _source()
    body = _narrow_dispatch(src)
    bf16, fp32 = body.split("} else {")
    assert "if (dtype == 1) {" in bf16 and "switch ((d + 15) / 16) {" in bf16
    assert _cases(bf16, "launch_mma") == list(range(1, 9))
    assert "switch ((d + 7) / 8) {" in fp32
    cases = _cases(fp32, "launch_tf32")
    assert cases == list(range(1, 17))
    for d in range(1, tattn._NARROW_D + 1):
        nc = (d + 7) // 8
        assert nc in cases and 0 <= 8 * nc - d < 8
    assert "const auto kernel = flash_fwd_tf32_kernel<NC>;" in src
    assert "kernel<<<grid, F32N_NT, bytes, stream>>>" in src
    assert "for (int b0 = 0; b0 < B; b0 += narrow_lists(H)) {" in src
    assert "const int err = launch_narrow(advance(q, l * list), advance(k, l * list)," in src


def test_f32_narrow_forward_shared_memory_fits():
    """Every instantiation's shared memory (the resident Q tile, two stages of
    K and V tiles of rows of 8 * NC + 4 floats, two stages of key flags)
    fits a block's on the H100, and the launcher asks for that much."""
    src = _source()
    warps, tile = _constant(src, "F32N_WARPS"), _constant(src, "F32N_TILE")
    assert "constexpr int F32N_OWN = 16 * F32N_WARPS;" in src and tile % 8 == 0
    assert ("return (size_t(F32N_OWN) + size_t(4) * F32N_TILE) * (8 * nc + 4) * sizeof(float)\n"
            "           + size_t(2) * F32N_TILE * sizeof(int);") in src
    assert "const size_t bytes = narrow_tf32_smem_bytes(NC);" in src
    for nc in range(1, 17):
        assert (16 * warps + 4 * tile) * (8 * nc + 4) * 4 + 2 * tile * 4 <= SMEM_PER_BLOCK


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fwd_route_stays_flash_at_narrow_head_dims(dtype):
    """At d <= 128 the forward takes the flash wrapper (the d <= 128 kernels)
    at every N, in either dtype: no list length routes it elsewhere."""
    for N in (1, 16, 64, 65, 128, 129, 256, 257, 1408, 1536):
        for d in (1, 8, 68, 72, 127, 128):
            assert tattn.fwd_route(dtype, N, d) == "flash"


def test_f32_narrow_forward_launches_and_the_cuda_core_kernel_is_gone():
    """The kernel takes b*h from grid.y, so a batch past 65535 // H lists runs
    in launches of whole lists, as kernel_launches counts them; the CUDA-core
    forward and its helpers are gone from the source."""
    src = _source()
    assert tattn.kernel_launches(65536, 2, 1408, 68) == 3
    assert tattn.kernel_launches(32, 2, 1408, 68) == 1
    assert "const dim3 grid((N + F32N_OWN - 1) / F32N_OWN, B * H);" in src
    assert "flash_fwd_kernel" not in src
    assert "to_f32(" not in src and "from_f32<" not in src


def test_forward_plain_matches_jax_pallas_interpret_over_tiles():
    """attention_forward_plain (the kernel's formulas) against the Pallas
    flash kernel in interpret mode at (2, 2, 200, 68) fp32: 200 docs are four
    of the kernel's 64-key tiles (the last ragged), the second list ragged
    (137 real docs); real query rows at atol 1e-5 (summation order)."""
    from jax.experimental.pallas import tpu as pltpu

    B, H, N, d = 2, 2, 200, 68
    rng = np.random.RandomState(7)
    q, k, v = (rng.randn(B, H, N, d).astype(np.float32) for _ in range(3))
    mask = np.arange(N)[None, :] < np.asarray((N, 137))[:, None]
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jattn.flash_attention(*(jnp.asarray(a) for a in (q, k, v, mask))))
    out, _, _ = tattn.attention_forward_plain(*(torch.from_numpy(a) for a in (q, k, v, mask)))
    assert out.dtype == torch.float32
    real = np.broadcast_to(mask[:, None, :, None], out.shape)
    np.testing.assert_allclose(out.numpy()[real], ref[real], rtol=0, atol=1e-5)


def test_forward_plain_statistics_normalise_every_real_row():
    """row_max m and row_sum l, as the kernel writes them for the backward,
    are the softmax's own: exp(x - m) / l over a row's keys (a masked key at
    -1e9) sums to 1 on every real row, m is the row's largest logit, and a
    list with no real document gets m = -1e9 and l = N. The logits here are
    one product over all keys, the plain version's a product a 64-key tile:
    m agrees to rtol 1e-6 (summation order)."""
    B, H, N, d = 3, 2, 200, 68
    rng = np.random.RandomState(8)
    q, k, v = (torch.from_numpy(rng.randn(B, H, N, d).astype(np.float32)) for _ in range(3))
    mask = torch.arange(N)[None, :] < torch.tensor([N, 137, 0])[:, None]
    _, m, l = tattn.attention_forward_plain(q, k, v, mask)
    x = torch.where(mask[:, None, None, :], q @ k.transpose(-1, -2) / d ** 0.5, -1e9)
    p = torch.exp(x - m[..., None]) / l[..., None]
    real = mask[:, None, :].expand(B, H, N)
    torch.testing.assert_close(p.sum(dim=-1)[real], torch.ones(int(real.sum())), rtol=0,
                               atol=1e-5)
    torch.testing.assert_close(m[:2], x[:2].amax(dim=-1), rtol=1e-6, atol=1e-6)
    assert bool((m[2] == -1e9).all()) and bool((l[2] == N).all())
