"""The port's masked attention (ptranking_tpu_torch/ops/attention.py) against
the JAX package's: the flash path (forward, and dq, dk, dv) against the Pallas
flash kernel run in interpret mode, the blockwise plain version against JAX's
blockwise, and the kernels' formulas in plain torch (attention_forward_plain,
attention_backward_plain) against both. The CUDA kernels themselves run only
on the card: chip_smoke.py holds them against the plain versions there."""

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
    empty = torch.zeros(1, 1, 8, 0)  # every d >= 1 is taken; d = 0 is not a shape
    with pytest.raises(ValueError, match="unsupported shape"):
        kern(empty, empty, empty, torch.ones(1, 8, dtype=torch.bool))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kern(q.double(), k.double(), v.double(), mask)
    assert kern.launches == 0
    stats = torch.zeros(B, H, N)
    for bwd in (tattn.FlashAttnBwdDkdv(), tattn.FlashAttnBwdDq()):
        with pytest.raises(ValueError, match="CUDA tensors"):
            bwd(q, k, v, q, stats, stats, stats, mask)
        assert bwd.launches == 0


# ---------------------------------------------------------------------------
# attention_backward_plain: the backward kernels' formulas in plain torch
# ---------------------------------------------------------------------------

# (B, H, N, d): three lists, the second ragged, the third all padding; N is
# ragged against the kernels' 64-row tiles; d = 68 is the flagship head dim
_BWD_SHAPES = [(3, 2, 150, 68), (3, 2, 50, 8), (3, 1, 97, 68)]


def _bwd_case(B, H, N, d, dtype=torch.float32, seed=0):
    """Inputs from a seed (numpy), the forward's output and its row
    statistics as the forward kernel defines them: m = max_j x_ij and
    l = sum_j exp(x_ij - m) over all N keys, a masked key's x being -1e9."""
    rng = np.random.RandomState(seed)
    q, k, v, dout = (rng.randn(B, H, N, d).astype(np.float32) for _ in range(4))
    lengths = np.array([N, max(1, (3 * N) // 5), 0])[:B]
    mask = np.arange(N)[None, :] < lengths[:, None]
    tq, tk, tv, tdo = (torch.from_numpy(a).to(dtype) for a in (q, k, v, dout))
    tm = torch.from_numpy(mask)
    x = torch.matmul(tq.float(), tk.float().transpose(-1, -2)) / float(d) ** 0.5
    x = torch.where(tm[:, None, None, :], x, -1e9)
    row_max = x.amax(dim=-1)
    row_sum = torch.exp(x - row_max[..., None]).sum(dim=-1)
    out = tattn.blockwise_attention(tq, tk, tv, tm, block_size=min(128, N))
    return (q, k, v, dout, mask), (tq, tk, tv, tdo, tm), (out, row_max, row_sum)


def _rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) / float(b.abs().max())


@pytest.mark.parametrize("shape", _BWD_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_plain_matches_autograd(shape, dtype):
    """The explicit backward == autograd through blockwise_attention on the
    lists with a real document, max |a - b| / max |b| per gradient: fp32
    1e-5 (summation order), bf16 2e-2 (both round P and dS to bf16, at other
    points: blockwise rounds the block's unnormalised p). Masked keys get
    dk = 0 exactly and a finite dv; the all-padded list stays finite."""
    tdt = getattr(torch, dtype)
    _, (q, k, v, dout, mask), (out, row_max, row_sum) = _bwd_case(*shape, dtype=tdt)
    got = tattn.attention_backward_plain(q, k, v, dout, out, row_max, row_sum, mask)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    tattn.blockwise_attention(*leaves, mask, block_size=min(128, shape[2])).backward(dout)
    real = mask.any(dim=1)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for name, g, leaf in zip(("dq", "dk", "dv"), got, leaves):
        assert g.dtype == tdt and g.shape == leaf.shape
        assert torch.isfinite(g.float()).all(), name
        assert _rel(g[real], leaf.grad[real]) <= tol, name
    masked_keys = ~mask[:, None, :, None].expand_as(got[1])
    assert float(got[1][masked_keys].float().abs().max()) == 0.0


@pytest.mark.parametrize("shape", _BWD_SHAPES[:2], ids=lambda s: "x".join(map(str, s)))
def test_backward_plain_matches_jax_pallas_interpret(shape):
    """The explicit backward against jax.grad through the Pallas flash kernel
    in interpret mode, for an output gradient on real query rows, over the
    lists with a real document. fp32; rtol 1e-4, atol 1e-5 (summation order)."""
    from jax.experimental.pallas import tpu as pltpu

    (q, k, v, cot, mask), (tq, tk, tv, _, tm), (out, row_max, row_sum) = _bwd_case(*shape)
    cot = np.where(mask[:, None, :, None], cot, 0.0).astype(np.float32)

    def jloss(q, k, v):
        return jnp.sum(jattn.flash_attention(q, k, v, jnp.asarray(mask)) * cot)

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    got = tattn.attention_backward_plain(tq, tk, tv, torch.from_numpy(cot), out, row_max,
                                         row_sum, tm)
    real = mask.any(axis=1)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(g.numpy()[real], np.asarray(r)[real], rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_variant_tool_substitutions_match_the_kernel_source():
    """Every text substitution of tools/kernel_variants.py for the backward (a
    knob turned, a phase cut out) still finds its target in
    csrc/flash_attn_bwd.cu, and the experiments it builds (the warpgroup
    products, the long kernel's query-row ownership) are there and build on
    that source: an edit of the kernel source that orphans the tool fails
    here, not on the card."""
    from pathlib import Path

    from ptranking_tpu_torch.tools import kernel_variants as tool

    source = tool.source_path("flash_attn_bwd").read_text()
    variants = tool.VARIANTS["flash_attn_bwd"]
    assert variants["shipped"] == []
    for name, subs in variants.items():
        if isinstance(subs, Path):
            continue
        for old, new in subs:
            assert old in source, (name, old)
            assert old != new
    assert variants["wgmma_experiment"] == tool.EXPERIMENT
    assert variants["long_rows_experiment"] == tool.LONG_ROWS_EXPERIMENT
    for experiment in (tool.EXPERIMENT, tool.LONG_ROWS_EXPERIMENT):
        assert experiment.exists()
        assert '#include "../flash_attn_bwd.cu"' in experiment.read_text()


# ---------------------------------------------------------------------------
# attention_forward_plain: the forward kernels' formulas in plain torch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", _BWD_SHAPES[:2], ids=lambda s: "x".join(map(str, s)))
def test_forward_plain_matches_jax_pallas_interpret(shape):
    """fp32: the plain forward == the JAX Pallas flash kernel in interpret mode
    on real query rows, atol 1e-5 (summation order and tile boundaries only;
    the all-padded list has no real row: garbage by contract)."""
    from jax.experimental.pallas import tpu as pltpu

    (q, k, v, _, mask), (tq, tk, tv, _, tm), _ = _bwd_case(*shape)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jattn.flash_attention(*(jnp.asarray(a) for a in (q, k, v, mask))))
    out, _, _ = tattn.attention_forward_plain(tq, tk, tv, tm)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(_real_rows(out.numpy(), mask), _real_rows(ref, mask), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("shape", _BWD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_forward_plain_bf16_matches_blockwise(shape):
    """bf16: the plain forward against blockwise_attention on real query rows,
    atol 2e-2 (the card's ATTN_TOL). Both keep fp32 logits and sums and round
    p and the output to bf16, but p relative to another max (a 64-key tile's
    running max, a 128-key block's own max), so they part by output-rounding
    flips: one or two bf16 ulps (2^-7 for |out| in [1, 2))."""
    _, (q, k, v, _, mask), _ = _bwd_case(*shape, dtype=torch.bfloat16)
    out, _, _ = tattn.attention_forward_plain(q, k, v, mask)
    ref = tattn.blockwise_attention(q, k, v, mask, block_size=min(128, shape[2]))
    assert out.dtype == torch.bfloat16
    real = mask[:, None, :, None].expand_as(out)
    assert float((out.float() - ref.float()).abs()[real].max()) <= 2e-2


@pytest.mark.parametrize("shape", _BWD_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_plain_statistics_match_definition(shape, dtype):
    """row_max and row_sum are m = max_j x_ij and l = sum_j exp(x_ij - m) over
    all N keys, a masked key's x being -1e9 (the definition _bwd_case uses,
    and what the backward kernels read): rtol 1e-5 (fp32 on both sides, tiled
    against whole-row sums). The all-padded list gets m = -1e9 exactly."""
    _, (q, k, v, _, mask), (_, row_max, row_sum) = _bwd_case(*shape, dtype=getattr(torch, dtype))
    _, m, l = tattn.attention_forward_plain(q, k, v, mask)
    assert m.dtype == l.dtype == torch.float32 and m.shape == l.shape == shape[:3]
    torch.testing.assert_close(m, row_max, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, row_sum, rtol=1e-5, atol=0)
    assert bool((m[2] == -1e9).all()) and bool((l[2] == shape[2]).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_plain_all_padded_list_stays_finite(dtype):
    """A list with no real document averages v over its N keys (every masked
    logit is the same -1e9): finite, as the kernels' contract says."""
    _, (q, k, v, _, mask), _ = _bwd_case(3, 2, 50, 8, dtype=getattr(torch, dtype))
    out, _, _ = tattn.attention_forward_plain(q, k, v, mask)
    assert torch.isfinite(out.float()).all()
    mean_v = v[2].float().mean(dim=1, keepdim=True).expand_as(out[2])
    tol = 1e-6 if dtype == "float32" else 1e-2  # bf16: p = 1 exact; the output's one rounding
    assert float((out[2].float() - mean_v).abs().max()) <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_plain_ignores_appended_padded_keys(dtype):
    """Appending masked documents (a longer bucket) leaves the real lists'
    rows unchanged: a masked key's p is exp(-1e9 - m) = 0 exactly. atol 1e-6
    in fp32 (a tile's product sums over more zero terms), bf16 one ulp at
    |out| < 1 (the same, after the output's rounding)."""
    tdt = getattr(torch, dtype)
    B, H, N, d, extra = 2, 2, 100, 68, 37
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(B, H, N + extra, d).astype(np.float32)).to(tdt)
               for _ in range(3))
    lengths = torch.tensor([N, 61])
    long_mask = torch.arange(N + extra)[None, :] < lengths[:, None]
    short = tattn.attention_forward_plain(q[:, :, :N], k[:, :, :N], v[:, :, :N], long_mask[:, :N])
    long = tattn.attention_forward_plain(q, k, v, long_mask)
    real = long_mask[:, None, :N, None].expand_as(short[0])
    tol = 1e-6 if dtype == "float32" else 2 ** -8
    assert float((short[0].float() - long[0][:, :, :N].float()).abs()[real].max()) <= tol
    torch.testing.assert_close(long[1][:, :, :N], short[1], rtol=0, atol=0)
    torch.testing.assert_close(long[2][:, :, :N], short[2], rtol=1e-6, atol=0)


@pytest.mark.parametrize("lib", ["flash_attn_fwd", "sinkstep", "pairwise_lambda"])
def test_fwd_sink_variant_substitutions_match_the_kernel_sources(lib):
    """Every text substitution of tools/kernel_variants.py for the forward,
    the half-step and the pairwise loss still finds its target in
    csrc/<lib>.cu (sources() raises otherwise) and changes it: an edit of a
    kernel source that orphans the tool fails here, not on the card."""
    from ptranking_tpu_torch.tools import kernel_variants as tool

    text = tool.source_path(lib).read_text()
    built = tool.sources([lib])
    assert built[(lib, "shipped")] == text
    for name in tool.VARIANTS[lib]:
        assert name == "shipped" or built[(lib, name)] != text, name
    if lib == "flash_attn_fwd":  # the fp32 forward's switches at d <= 128, one constant each
        for name, constant in (("f32n_qsmem", "F32N_QREG_NC"), ("f32n_tile64", "F32N_TILE"),
                               ("f32n_group8", "F32N_GROUP"), ("f32n_blocks3", "F32N_BLOCKS")):
            changed = [line for line in built[(lib, name)].splitlines()
                       if line not in text.splitlines()]
            assert changed == [line for line in changed if f"constexpr int {constant} = " in line]
            assert len(changed) == 1, name
