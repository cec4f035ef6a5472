"""The fp32 attention backward at head dims up to 128: csrc/flash_attn_bwd.cu's
flash_bwd_dkdv_tf32_kernel and flash_bwd_dq_tf32_kernel (3xTF32 tensor-core
products, the head dim padded to a multiple of 8), behind the dk/dv and dq
entries with dtype 0.

The kernels run only on the card (chip_smoke.py holds them against
attention_backward_plain and autograd through blockwise_attention there).
Here: their contract with the package (the entries' dispatch, an
instantiation for every d of 1..128, shared memory within a block's, the
route), and attention_backward_plain, the formulas they compute, against
jax.grad through the JAX package's Pallas flash kernel in interpret mode at
the flagship's head dim with more than two of the kernels' 64-row tiles."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ptranking_tpu.ops import attention as jattn
from ptranking_tpu_torch.ops import attention as tattn

torch.set_num_threads(1)

SMEM_PER_BLOCK = 232448  # the H100's shared memory a block may have


def _source() -> str:
    return (tattn.cuda_build.CSRC / "flash_attn_bwd.cu").read_text()


def _constant(source: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", source).group(1))


def test_f32_narrow_backward_contract():
    """The dk/dv and dq entries send fp32 (dtype 0) at d <= 128 to the 3xTF32
    kernels, in launches of whole lists on grid.y (by_lists, as
    kernel_launches counts them); the fp32 dispatch has one instantiation for
    each head dim padded to a multiple of 8, which covers every d of 1..128
    with fewer than 8 pad columns; every instantiation's shared memory fits
    a block's; bwd_route keeps the dk/dv and dq wrappers at d <= 128 for
    every N, in either dtype; the CUDA-core pair is gone."""
    src = _source()
    for entry, launch, kernel in (("dkdv", "launch_dkdv_tf32", "flash_bwd_dkdv_tf32_kernel"),
                                  ("dq", "launch_dq_tf32", "flash_bwd_dq_tf32_kernel")):
        body = src[src.index(f"int narrow_{entry}(const Args& a, int dtype"):]
        body = body[:body.index("\n}\n")]
        assert re.search(r"if \(dtype == 1\) \{\s*FLASH_BWD_BF16_DISPATCH\(launch_"
                         + entry + r"_mma\)\s*\} else \{\s*FLASH_BWD_F32_DISPATCH\("
                         + launch + r"\)", body), entry
        assert f"{kernel}<NC><<<grid, F32N_NT, bytes, a.stream>>>" in src
        assert f"return narrow_{entry}(part, dtype, " in src
    macro = src[src.index("#define FLASH_BWD_F32_DISPATCH(LAUNCH)"):]
    macro = macro[:macro.index("\n\n")]
    assert "switch ((a.d + 7) / 8) {" in macro
    cases = [int(a) for a, b in re.findall(r"case (\d+): return int\(LAUNCH<(\d+)> ARGS\);", macro)
             if a == b]
    assert cases == list(range(1, 17))
    for d in range(1, tattn._NARROW_D + 1):
        nc = (d + 7) // 8
        assert nc in cases and 0 <= 8 * nc - d < 8
    warps, tile = _constant(src, "F32N_WARPS"), _constant(src, "F32N_TILE")
    assert "constexpr int F32N_OWN = 16 * F32N_WARPS;" in src and tile % 8 == 0
    assert ("return (size_t(2) * F32N_OWN + size_t(4) * F32N_TILE) * (8 * nc + 4) * sizeof(float)\n"
            "           + size_t(6) * F32N_TILE * 4;") in src
    for nc in cases:  # two resident tiles, two stages of two loop tiles, the statistics
        assert (2 * 16 * warps + 4 * tile) * (8 * nc + 4) * 4 + 6 * tile * 4 <= SMEM_PER_BLOCK
    for dtype in (torch.float32, torch.bfloat16):
        for N in (1, 64, 65, 256, 257, 1408):
            assert tattn.bwd_route(dtype, N, 68) == tattn.bwd_route(dtype, N, 128) == "pair"
    assert tattn.kernel_launches(65536, 2, 1408, 68) == 3
    assert "flash_bwd_dkdv_kernel" not in src and "flash_bwd_dq_kernel" not in src
    assert "load_transposed" not in src


def test_backward_plain_matches_jax_pallas_interpret_over_tiles():
    """attention_backward_plain (the kernels' formulas) against jax.grad
    through the Pallas flash kernel in interpret mode at (2, 2, 200, 68)
    fp32: 200 docs are four of the kernels' 64-row tiles (the last ragged),
    the second list ragged (137 real docs), the output gradient on real
    query rows; rtol 1e-4, atol 1e-5 (summation order), as
    test_backward_plain_matches_jax_pallas_interpret."""
    from jax.experimental.pallas import tpu as pltpu

    B, H, N, d = 2, 2, 200, 68
    rng = np.random.RandomState(5)
    q, k, v, cot = (rng.randn(B, H, N, d).astype(np.float32) for _ in range(4))
    mask = np.arange(N)[None, :] < np.asarray((N, 137))[:, None]
    cot = np.where(mask[:, None, :, None], cot, 0.0).astype(np.float32)

    def jloss(q, k, v):
        return jnp.sum(jattn.flash_attention(q, k, v, jnp.asarray(mask)) * cot)

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv, tcot = (torch.from_numpy(a) for a in (q, k, v, cot))
    tm = torch.from_numpy(mask)
    out, row_max, row_sum = tattn.attention_forward_plain(tq, tk, tv, tm)
    got = tattn.attention_backward_plain(tq, tk, tv, tcot, out, row_max, row_sum, tm)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-5, err_msg=name)
