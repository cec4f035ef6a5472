"""fp32 attention past 256 docs at head dims above 128: the 3xTF32 wide
kernels of csrc/flash_attn_{fwd,bwd}.cu (flash_fwd_wide_tf32_kernel,
flash_bwd_{dkdv,dq}_wide_tf32_kernel), behind the forward, dk/dv and dq
entries with dtype 0 at d > 128.

The kernels run only on the card (chip_smoke.py's check_wide_tf32 holds them
against attention_forward_plain and attention_backward_plain there). Here:
those plain versions against the JAX package's blockwise attention and its
gradients past 256 docs, beside a one-doc and an all-padded list; the
one-head F=136 listsf (MSLR-WEB30K's width, d = 136) in fp32 on a ragged
300-doc batch against the JAX scorer; and the kernels' contract with the
package: the entries' dispatch of fp32 at d > 128, each output group's shared
memory, the route, the launches, and that the CUDA-core wide kernels are
gone."""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptranking_tpu.models import scorers as jsc
from ptranking_tpu.ops import attention as jattn
from ptranking_tpu_torch.models import scorers as tsc
from ptranking_tpu_torch.models.convert import params_from_jax
from ptranking_tpu_torch.ops import attention as tattn

torch.set_num_threads(1)

SMEM_PER_BLOCK = 232448  # the H100's shared memory a block may have


def _lists(N):
    """Four lists: a full one, one real doc, a ragged one, an all-padded one."""
    return (N, 1, 2 * N // 3, 0)


def _case(N, d, seed=0):
    rng = np.random.RandomState(seed)
    B = len(_lists(N))
    q, k, v, cot = (rng.randn(B, 1, N, d).astype(np.float32) for _ in range(4))
    mask = np.arange(N)[None, :] < np.asarray(_lists(N))[:, None]
    cot = np.where(mask[:, None, :, None], cot, 0.0).astype(np.float32)
    return q, k, v, cot, mask


@pytest.mark.parametrize("d", [136, 700])
@pytest.mark.parametrize("N", [70, 300])
def test_f32_wide_forward_plain_matches_jax_blockwise(N, d):
    """attention_forward_plain (the kernel's formulas: 64-key tiles, a running
    max) against JAX blockwise_attention on real query rows, atol 1e-5
    (summation order and tile boundaries); the one-doc list's rows are that
    doc's v exactly (what the kernel's fourth P V product keeps, and the
    fp32 backward's gate needs); the all-padded list gets m = -1e9, l = N."""
    q, k, v, _, mask = _case(N, d)
    ref = np.asarray(jattn.blockwise_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                               jnp.asarray(mask), block_size=64))
    out, m, l = tattn.attention_forward_plain(*(torch.from_numpy(a) for a in (q, k, v, mask)))
    assert torch.isfinite(out).all()
    real = np.broadcast_to(mask[:, None, :, None], out.shape)
    np.testing.assert_allclose(out.numpy()[real], ref[real], rtol=0, atol=1e-5)
    assert torch.equal(out[1, 0], torch.from_numpy(v[1, 0, :1]).expand(N, d))
    assert bool((m[3] == -1e9).all()) and bool((l[3] == N).all())


@pytest.mark.parametrize("d", [136, 700])
@pytest.mark.parametrize("N", [70, 300])
def test_f32_wide_backward_plain_matches_jax_grad(N, d):
    """attention_backward_plain, from attention_forward_plain's output and
    statistics (what the wide forward gives the wide backward), against
    jax.grad through JAX blockwise_attention over the lists with a real
    document: rtol 1e-4, atol 1e-5 (summation order; the one-doc list's dq
    and dk are zero up to rounding on both sides). The all-padded list's
    gradients are finite."""
    q, k, v, cot, mask = _case(N, d)

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


def test_one_head_listsf_fp32_matches_jax_past_256_docs():
    """The DASALC listsf at MSLR-WEB30K's width with one head (F = d = 136,
    1 encoder layer, narrow FFNs), flash_attn=True (the CPU path: blockwise
    attention on both sides), fp32, on 300-doc lists (full, ragged, one doc,
    all padded) with the JAX params carried over: the scores on real docs
    within atol 1e-4, and the gradients of sum(scores * w) over real docs
    within 2e-4 of each tensor's largest entry (summation order over
    136-wide rows and 300 keys)."""
    F, N = 136, 300
    lengths = (N, 173, 1, 0)
    jcfg = jsc.ScorerConfig.default_listsf(F, encoder_layers=1, ff_dims=(8,), n_heads=1,
                                           flash_attn=True)
    tcfg = tsc.ScorerConfig(**dataclasses.asdict(jcfg))
    assert tcfg.width // tcfg.n_heads == 136
    rng = np.random.RandomState(2)
    x = rng.randn(len(lengths), N, F).astype(np.float32)
    mask = np.arange(N)[None, :] < np.asarray(lengths)[:, None]
    x[~mask] = 0.0
    w = np.where(mask, rng.randn(len(lengths), N), 0.0).astype(np.float32)

    jparams = jsc.init_scorer(jax.random.PRNGKey(0), jcfg)

    def jloss(p):
        scores = jsc.apply_scorer(p, jcfg, jnp.asarray(x), jnp.asarray(mask))
        return jnp.sum(scores * w), scores

    (_, ref), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg)
    leaves = [t.requires_grad_(True) for t in tsc.tree_leaves(tparams)]
    out = tsc.apply_scorer(tparams, tcfg, torch.from_numpy(x), torch.from_numpy(mask))
    got = torch.autograd.grad(torch.sum(out * torch.from_numpy(w)), leaves)
    np.testing.assert_allclose(out.detach().numpy()[mask], np.asarray(ref)[mask], rtol=0,
                               atol=1e-4)
    want = tsc.tree_leaves(params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), tcfg))
    assert len(want) == len(got)
    for i, (g, r) in enumerate(zip(got, want)):
        scale = max(float(r.abs().max()), 1e-6)
        assert float((g - r).abs().max()) <= 2e-4 * scale, i


# ---------------------------------------------------------------------------
# the kernels' contract with the package
# ---------------------------------------------------------------------------


def _source(name: str) -> str:
    return (tattn.cuda_build.CSRC / name).read_text()


def _constant(source: str, name: str) -> int:
    return int(re.search(rf"constexpr (?:int|size_t) {name} = (\d+)", source).group(1))


def test_f32_wide_entries_dispatch_to_the_3xtf32_kernels():
    """fp32 (dtype 0) at d > 128 reaches flash_fwd_wide_tf32_kernel through
    flash_attn_fwd and flash_bwd_{dkdv,dq}_wide_tf32_kernel through
    flash_attn_bwd_{dkdv,dq}; bf16 keeps the wide mma kernels; each launcher
    sizes its shared memory by its output group and launches one grid of
    64-row tiles x B*H."""
    fwd, bwd = _source("flash_attn_fwd.cu"), _source("flash_attn_bwd.cu")
    assert ("        return int(dtype == 1 ? launch_wide_mma(q, k, v, mask, o, rm, rs, B, H, N, d, st)\n"
            "                              : launch_wide_tf32(q, k, v, mask, o, rm, rs, B, H, N, d, st));"
            in fwd)
    assert ("        return int(dtype == 1 ? launch_dkdv_wide(a, dk, dv) : launch_dkdv_wide_tf32(a, dk, dv));"
            in bwd)
    assert "    if (d > 128) return int(dtype == 1 ? launch_dq_wide(a, dq) : launch_dq_wide_tf32(a, dq));" in bwd
    assert "const auto kernel = flash_fwd_wide_tf32_kernel<F32W_CW>;" in fwd
    assert "const int cg = wide_tf32_group(d, 1, F32W_CW);  // one accumulator: O" in fwd
    assert "const auto kernel = flash_bwd_dkdv_wide_tf32_kernel<F32W_CW>;" in bwd
    assert "const int cg = wide_tf32_group(a.d, 2, F32W_CW);  // two accumulators: dk, dv" in bwd
    assert "const auto kernel = flash_bwd_dq_wide_tf32_kernel<F32W_CW>;" in bwd
    assert "const int cg = wide_tf32_group(a.d, 1, F32W_CW);  // one accumulator: dq" in bwd
    assert "const dim3 grid(unsigned(wide_blocks(B, H, N, d, d)));" in fwd
    assert bwd.count("kernel<<<unsigned(wide_blocks(a.B, a.H, a.N, a.d, a.d)), F32W_NT, bytes, "
                     "a.stream>>>(") == 2
    # one chunk width at every d: each kernel has one instantiation
    for src in (fwd, bwd):
        assert "constexpr int F32W_CW = 32;" in src
        assert "F32W_CW_NARROW" not in src and "wide_tf32_width" not in src


def test_f32_wide_cuda_core_kernels_are_gone():
    """No fp32 attention call reaches a CUDA-core product: the CUDA-core wide
    forward and dk/dv and dq kernels, their register blocks and helpers are
    gone from the sources, and every fp32 kernel that remains is a 3xTF32
    one (mma.sync...tf32)."""
    fwd, bwd = _source("flash_attn_fwd.cu"), _source("flash_attn_bwd.cu")
    for src in (fwd, bwd):
        for gone in ("flash_fwd_wide_kernel", "flash_bwd_dkdv_wide_kernel",
                     "flash_bwd_dq_wide_kernel", "product_4x8", "warp_max8", "warp_sum8",
                     "WIDE_NC", "wide_smem_floats", "constexpr int LDT"):
            assert gone not in src, gone
    kernels = set(re.findall(r"\n(flash_\w+_kernel)\(", fwd + bwd))
    fp32 = {k for k in kernels if "tf32" in k}
    assert {"flash_fwd_wide_tf32_kernel", "flash_bwd_dkdv_wide_tf32_kernel",
            "flash_bwd_dq_wide_tf32_kernel"} <= fp32
    # every other kernel reads bf16 (the mma kernels) or is a 3xTF32 one
    assert all("mma" in k or "tf32" in k or k == "flash_bwd_long_dq_sum_kernel" for k in kernels)


def _wide_smem(cg: int, accs: int, w: int, own: int, tile: int) -> int:
    # mma_common.cuh's wide_tf32_smem_bytes
    return (accs * own * cg + 2 * (own + tile) * (w + 4) + 6 * tile) * 4


def _wide_group(d: int, accs: int, w: int, own: int, tile: int, most_bytes: int) -> int:
    # mma_common.cuh's wide_tf32_group
    most = (most_bytes - _wide_smem(0, accs, w, own, tile)) // (accs * own * 4) // 8 * 8
    d8 = -(-d // 8) * 8
    groups = -(-d8 // most)
    return -(-(-(-d8 // groups)) // 8) * 8


@pytest.mark.parametrize("d", [129, 136, 350, 384, 700, 1024])
def test_f32_wide_shared_memory_fits(d):
    """Each fp32 wide kernel's block (the output group's accumulators, two
    stages of two chunk tiles of 32 columns, two tiles' flags or
    statistics) fits the H100's 232,448 bytes at every d, and its groups
    cover d's columns: one group of the forward and dq up to d = 752, of
    dk/dv up to 376 (d = 384 and 700 take two, S and dP computed again for
    the second)."""
    hdr = _source("mma_common.cuh")
    assert ("    return (size_t(accs) * F32W_OWN * cg + size_t(2) * (F32W_OWN + F32W_TILE) * (w + 4)\n"
            "            + size_t(6) * F32W_TILE) * 4;") in hdr
    assert "constexpr int F32W_OWN = 16 * F32W_WARPS;" in hdr
    own, tile = 16 * _constant(hdr, "F32W_WARPS"), _constant(hdr, "F32W_TILE")
    most = _constant(hdr, "F32W_SMEM_MAX")
    assert most == SMEM_PER_BLOCK
    for name, accs, one_group_up_to in (("flash_attn_fwd.cu", 1, 752), ("flash_attn_bwd.cu", 2, 376),
                                        ("flash_attn_bwd.cu", 1, 752)):
        w = _constant(_source(name), "F32W_CW")
        cg = _wide_group(d, accs, w, own, tile, most)
        groups = -(-d // cg)
        assert _wide_smem(cg, accs, w, own, tile) <= SMEM_PER_BLOCK, (name, accs, w, cg)
        assert cg % 8 == 0 and groups * cg >= d and (groups - 1) * cg < d
        assert (groups == 1) == (d <= one_group_up_to), (name, accs, d, cg)


def test_f32_wide_forward_register_cut_fits_the_shared_memory():
    """The forward's registers are cut for three blocks an SM
    (__launch_bounds__(F32W_NT, F32W_BLOCKS), F32W_BLOCKS = 3) and the
    backward's for two: at the one-head model's d = 136 three forward blocks
    and two dq blocks fit an SM's 233,472 bytes of shared memory (1,024 of
    them reserved a block), so the cut is not wasted there."""
    fwd, bwd = _source("flash_attn_fwd.cu"), _source("flash_attn_bwd.cu")
    assert _constant(fwd, "F32W_BLOCKS") == 3 and _constant(bwd, "F32W_BLOCKS") == 2
    for src, kernel in ((fwd, "flash_fwd_wide_tf32_kernel"), (bwd, "flash_bwd_dkdv_wide_tf32_kernel"),
                        (bwd, "flash_bwd_dq_wide_tf32_kernel")):
        assert f"__launch_bounds__(F32W_NT, F32W_BLOCKS)\n{kernel}(" in src
    cg = _wide_group(136, 1, 32, 64, 64, SMEM_PER_BLOCK)  # the forward's and dq's block
    assert 233472 // (_wide_smem(cg, 1, 32, 64, 64) + 1024) >= 3


@pytest.mark.parametrize("d", [129, 136, 350, 384, 700])
def test_f32_wide_route_and_launches_past_256_docs(d):
    """fp32 at d > 128 past F32_LONG_MAX_N docs takes the flash forward and
    the dk/dv + dq pair (the fp32 wide kernels), one launch each at any
    batch (grid.x holds 64-row tiles x B*H); up to 256 docs the packed, list
    and long kernels keep their routes."""
    for N in (257, 300, 512, 1408, 1536):
        assert tattn.fwd_route(torch.float32, N, d) == "flash"
        assert tattn.bwd_route(torch.float32, N, d) == "pair"
        assert tattn.kernel_launches(32769, 2, N, d) == 1
    assert tattn.fwd_route(torch.float32, 256, d) == "long"
    assert tattn.bwd_route(torch.float32, 256, d) == "long"
