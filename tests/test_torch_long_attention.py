"""The long attention kernels: lists of 129 .. 256 docs at head dims above 128
in bf16, and the fp32 list kernels' contracts (3xTF32).

csrc/flash_attn_fwd.cu's flash_fwd_long_mma_kernel and csrc/flash_attn_bwd.cu's
flash_bwd_long_mma_kernel take one list of 129 .. 256 docs a 256-row tile and
its keys in two halves of 128: the forward computes S once and rounds each
half's p against the running max of the halves so far (an online rescale
between them), the backward writes dk and dv whole and sums dq over the two
halves in fp32. Their plain versions are attention_forward_packed_plain and
attention_backward_packed_plain on that tile. Here those plain versions are
held against attention_forward_plain and attention_backward_plain (the
unpacked kernels' formulas, list by list) and against the JAX package's
blockwise attention and its gradients, at list lengths around the halves and
the tile (129: one key in the second half; 200; 256) and the head dims of a
one-head F=136 listsf (136), the Yahoo! LTR listsf (350) and the same under
lane_align (384). B*H = 10 lists hold a full list, a ragged one, a fully
padded one, a full one and a one-doc one. The kernels themselves run only on
the card (chip_smoke.py)."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptranking_tpu.ops import attention as jattn
from ptranking_tpu_torch.ops import attention as tattn

torch.set_num_threads(1)

B, H = 5, 2
NS = [129, 200, 256]
DS = [136, 350, 384]


def _case(N, d, dtype, seed=0):
    """numpy inputs (q, k, v, output gradient, mask: a full list, a ragged
    one, a fully padded one, a full one, a one-doc one) and the port's
    tensors in `dtype`."""
    rng = np.random.RandomState(seed)
    q, k, v, cot = (rng.randn(B, H, N, d).astype(np.float32) for _ in range(4))
    mask = np.arange(N)[None, :] < np.asarray((N, N // 2, 0, N, 1))[:, None]
    tensors = tuple(torch.from_numpy(a).to(dtype) for a in (q, k, v, cot))
    return (q, k, v, cot, mask), tensors + (torch.from_numpy(mask),)


def _rel(got, ref, floor=0.0):
    """max |got - ref| / max(max |ref|, floor)."""
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max()) / max(float(ref.abs().max()), floor)


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("N", NS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_long_forward_plain_matches_plain_forward(dtype, N, d):
    """attention_forward_packed_plain on the long tile == attention_forward_plain
    on EVERY query row, the fully padded list's included: the output within
    1e-5 of its largest value in fp32 (summation order) and 2e-2 absolute in
    bf16 (chip_smoke.py's ATTN_TOL: the long tile rounds p against each
    128-key half's running max, attention_forward_plain against each 64-key
    tile's), row_max and row_sum within 1e-5 relative (STATS_TOL); the fully
    padded list gets m = -1e9, l = N and the mean of its v."""
    tdt = getattr(torch, dtype)
    _, (q, k, v, _, mask) = _case(N, d, tdt)
    out, m, l = tattn.attention_forward_packed_plain(q, k, v, mask)
    ref, ref_m, ref_l = tattn.attention_forward_plain(q, k, v, mask)
    assert out.dtype == tdt and out.shape == ref.shape
    assert m.shape == l.shape == (B, H, N) and m.dtype == l.dtype == torch.float32
    assert all(bool(torch.isfinite(t.float()).all()) for t in (out, m, l))
    err = float((out.float() - ref.float()).abs().max())
    assert err <= (1e-5 * float(ref.abs().max()) if dtype == "float32" else 2e-2)
    assert float(((m - ref_m).abs() / (1.0 + ref_m.abs())).max()) <= 1e-5
    assert float(((l - ref_l).abs() / ref_l).max()) <= 1e-5
    assert bool((m[2] == -1e9).all()) and bool((l[2] == N).all())
    mean_v = v[2].float().mean(dim=1, keepdim=True).expand(H, N, d)
    assert _rel(out[2], mean_v) <= (1e-6 if dtype == "float32" else 2 ** -7)


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("N", NS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_long_forward_plain_matches_jax_blockwise(dtype, N, d):
    """attention_forward_packed_plain on the long tile against JAX
    blockwise_attention in the same dtype on real query rows: fp32 atol
    1e-5 (summation order), bf16 atol 2e-2 (both round p to bf16 before
    p v, against other running maxima)."""
    tdt = getattr(torch, dtype)
    (q, k, v, _, mask), (tq, tk, tv, _, tm) = _case(N, d, tdt)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ref = jattn.blockwise_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                    jnp.asarray(mask), block_size=128)
    ref = np.asarray(ref.astype(jnp.float32))
    out = tattn.attention_forward_packed_plain(tq, tk, tv, tm)[0].float().numpy()
    real = np.broadcast_to(mask[:, None, :, None], out.shape)
    np.testing.assert_allclose(out[real], ref[real], rtol=0,
                               atol=1e-5 if dtype == "float32" else 2e-2)


def test_long_forward_plain_rescales_between_halves():
    """The long tile's p is rounded to bf16 against each half's running max:
    where the row's largest logit lies in the second half, the first half's
    p rounded against the first half's own max and then rescaled differs
    from p rounded against the row's max, and the plain version gives the
    former. A one-pass softmax over the tile (as the 128-key tile takes
    its keys) is the reference it must not equal, and both stay within one
    bf16 rounding of each other."""
    N, d = 256, 136
    _, (q, k, v, _, mask) = _case(N, d, torch.bfloat16)
    mask = torch.ones_like(mask)
    k = k.clone()
    k[:, :, 200] = q[:, :, 0] * 3  # row 0's dominant key, in the second half
    out = tattn.attention_forward_packed_plain(q, k, v, mask)[0]
    scale = 1.0 / d ** 0.5
    x = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    m = x.amax(dim=-1, keepdim=True)
    p = torch.exp(x - m)
    one_pass = (torch.matmul(p.to(torch.bfloat16).float(), v.float()) / p.sum(-1, keepdim=True))
    assert not torch.equal(out, one_pass.to(torch.bfloat16))
    assert float((out.float() - one_pass).abs().max()) <= 2e-2


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("N", NS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_long_backward_plain_matches_plain_backward(dtype, N, d):
    """attention_backward_packed_plain on the long tile ==
    attention_backward_plain on EVERY list, the fully padded one included,
    from attention_forward_plain's output and row statistics: relative
    error per gradient 1e-5 in fp32 (summation order) and 1e-2 in bf16 (the
    same roundings at the same points), dq and dk held at a tenth of dv's
    scale where they cancel (the one-doc list)."""
    tdt = getattr(torch, dtype)
    _, (q, k, v, cot, mask) = _case(N, d, tdt)
    out, m, l = tattn.attention_forward_plain(q, k, v, mask)
    got = tattn.attention_backward_packed_plain(q, k, v, cot, out, m, l, mask)
    ref = tattn.attention_backward_plain(q, k, v, cot, out, m, l, mask)
    floor = 0.1 * float(ref[2].float().abs().max())
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == tdt and g.shape == r.shape, name
        assert torch.isfinite(g.float()).all(), name
        assert _rel(g, r, floor) <= (1e-5 if dtype == "float32" else 1e-2), name


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("N", NS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_long_backward_plain_matches_jax_grad(dtype, N, d):
    """attention_backward_packed_plain on the long tile, from the long plain
    forward's output and row statistics (what the long forward kernel gives
    the long backward), against jax.grad through JAX blockwise_attention in
    the same dtype, for an output gradient on real rows, over the lists with
    a real document: fp32 rtol 1e-4, atol 1e-5 (summation order); bf16
    relative error per gradient 2e-2 (chip_smoke.py's BWD_TOL) with a floor
    of a tenth of dv's scale: both round P and dS to bf16, JAX at other
    points."""
    tdt = getattr(torch, dtype)
    (q, k, v, cot, mask), (tq, tk, tv, _, tm) = _case(N, d, tdt)
    cot = np.where(mask[:, None, :, None], cot, 0.0).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16

    def jloss(q, k, v):
        o = jattn.blockwise_attention(q, k, v, jnp.asarray(mask), block_size=128)
        return jnp.sum(o.astype(jnp.float32) * cot)

    ref = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a, jdt) for a in (q, k, v)))
    ref = [np.asarray(r.astype(jnp.float32)) for r in ref]
    out, m, l = tattn.attention_forward_packed_plain(tq, tk, tv, tm)
    got = tattn.attention_backward_packed_plain(tq, tk, tv, torch.from_numpy(cot).to(tdt), out,
                                                m, l, tm)
    real = mask.any(axis=1)
    floor = 0.1 * float(np.abs(ref[2][real]).max())
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert torch.isfinite(g.float()).all(), name
        g = g.float().numpy()[real]
        if dtype == "float32":
            np.testing.assert_allclose(g, r[real], rtol=1e-4, atol=1e-5, err_msg=name)
        else:
            assert _rel(torch.from_numpy(g), torch.from_numpy(r[real]), floor) <= 2e-2, name


def test_long_grid_contract():
    """The long kernels' grids: the backward one block per list of 129 ..
    256 docs (per 256 // N lists below), the forward four (64 query rows
    each), on grid.x in one launch; N above 256 and B*H past 2^31 - 1
    lists are refused. The kernels' tiles are the package's."""
    assert tattn.packed_blocks(128, 2, 256, rows=256) == 256
    assert tattn.packed_blocks(5, 2, 129, rows=256) == 10
    assert tattn.fwd_packed_blocks(128, 2, 256) == 1024
    assert tattn.fwd_packed_blocks(5, 2, 129) == 40
    assert tattn.kernel_launches(32769, 2, 129, 136, packed=True) == 1
    for name in ("flash_attn_fwd_long", "flash_attn_bwd_long"):
        tattn.check_grid(32769, 2, 129, 136, packed=name)
        tattn.check_grid(1, 1, 256, 520, packed=name)
        with pytest.raises(ValueError, match="at most 256 docs"):
            tattn.check_grid(2, 2, 257, 350, packed=name)
        with pytest.raises(ValueError, match="at most 2147483647 of them"):
            tattn.check_grid(2 ** 30, 4, 256, 350, packed=name)
    with pytest.raises(ValueError, match="blocks of flash_attn_fwd_long on grid.x"):
        tattn.check_grid(2 ** 29, 2, 200, 350, packed="flash_attn_fwd_long")
    bwd = (tattn.cuda_build.CSRC / "flash_attn_bwd.cu").read_text()
    fwd = (tattn.cuda_build.CSRC / "flash_attn_fwd.cu").read_text()
    assert f"constexpr int LONG_ROWS = {tattn._LONG_ROWS};" in bwd
    assert "constexpr int LONG_HALF = LONG_ROWS / 2;" in bwd and tattn._LONG_HALF * 2 == 256
    assert "constexpr int LONG_KEYS = 4 * OWN;" in fwd and "constexpr int LONG_HALF = 2 * OWN;" in fwd


def test_f32_list_long_contract():
    """The fp32 list and long backward: the routes' limits lie within the
    tiles of the kernel the list and long entries launch on fp32 (dtype 0),
    and the wrappers take fp32 lists up to those tiles; the kernel's slices
    and passes are the warps' 16 rows by 64 keys, and its shared memory at
    its widest tile fits the H100's 232,448 bytes a block."""
    assert tattn.F32_PACK_MAX_N <= tattn._ROWS < tattn.F32_LIST_MAX_N <= tattn._LIST_ROWS
    assert tattn._LIST_ROWS < tattn.F32_LONG_MAX_N <= tattn._LONG_ROWS
    assert tattn._PACKED_MAX_N["flash_attn_bwd_list"] == tattn._LIST_ROWS
    assert tattn._PACKED_MAX_N["flash_attn_bwd_long"] == tattn._LONG_ROWS
    bwd = (tattn.cuda_build.CSRC / "flash_attn_bwd.cu").read_text()
    assert "if (dtype == 0) return int(launch_bwd_list_tf32<LIST_ROWS>(a, dq, dk, dv));" in bwd
    assert "if (dtype == 0) return int(launch_bwd_list_tf32<LONG_ROWS>(a, dq, dk, dv));" in bwd
    assert "constexpr int TF32_KEYS = 64;" in bwd and "constexpr int F32_SLICE = TF32_KEYS;" in bwd
    assert "constexpr int F32_PASS = 128;" in bwd
    w = int(re.search(r"constexpr int F32_W = (\d+);", bwd).group(1))
    # the P and dS tiles, the two stages (Q, dO of a pass, K, V of a slice), the key info
    smem = (2 * 128 * (64 + 4) + 2 * (2 * 128 + 2 * 64) * (w + 4)) * 4 + tattn._LONG_ROWS * 4
    assert smem <= 232448


@pytest.mark.parametrize("entry, rows, own", [("flash_attn_fwd_packed", 128, "F32_LIST_OWN"),
                                              ("flash_attn_fwd_long", 256, "F32_LONG_OWN")])
def test_f32_fwd_list_long_contract(entry, rows, own):
    """The fp32 list forward (flash_fwd_list_tf32_kernel) behind the packed
    entry above 64 docs (a 128-row tile) and the long entry (a 256-row
    tile): the fp32 routes' limits lie within its tiles; a block owns 64
    query rows of the 128-row tile and 128 of the 256-row one, two blocks a
    list of 65 .. 256 docs, so fwd_packed_blocks in fp32 gives the C
    launcher's grid and check_grid takes B*H up to 2^31 - 1 lists while
    those blocks fit grid.x; its slices are the warps' 16 rows by 64 keys,
    and its shared memory at each tile fits the H100's 232,448 bytes a
    block."""
    f32 = torch.float32
    assert tattn.F32_PACK_MAX_N <= tattn._ROWS < tattn.F32_FWD_LIST_MAX_N <= tattn._LIST_ROWS
    assert tattn._LIST_ROWS < tattn.F32_FWD_LONG_MAX_N <= tattn._LONG_ROWS
    assert tattn._PACKED_MAX_N[entry] == rows
    fwd = (tattn.cuda_build.CSRC / "flash_attn_fwd.cu").read_text()
    rows_a_block = int(re.search(rf"constexpr int {own} = (\d+);", fwd).group(1))
    assert rows_a_block == (tattn._F32_LONG_OWN if rows == tattn._LONG_ROWS else tattn._ROWS)
    per_list = rows // rows_a_block
    assert per_list == 2
    N = rows // 2 + 1  # one list a tile
    assert tattn.fwd_packed_blocks(256, 2, N, f32) == 512 * per_list
    assert tattn.fwd_packed_blocks(5, 2, rows, f32) == 10 * per_list
    assert tattn.fwd_packed_blocks(2048, 2, 16, f32) == 1024  # the fp32 packed kernel's tile
    lists = (2 ** 31 - 1) // per_list
    tattn.check_grid(lists, 1, N, 350, packed=entry, dtype=f32)
    with pytest.raises(ValueError, match=f"blocks of {entry} on grid.x"):
        tattn.check_grid(lists + 1, 1, N, 350, packed=entry, dtype=f32)
    keys = {128: "LIST_KEYS", 256: "LONG_KEYS"}[rows]
    assert f"return int(launch_list_tf32<{keys}>(q, k, v, mask, o, rm, rs, B, H, N, d, st));" in fwd
    assert "return rows > LIST_KEYS ? F32_LONG_OWN : F32_LIST_OWN;" in fwd
    assert "constexpr int F32_SLICE = 64;" in fwd
    assert "return (lists + rows / N - 1) / (rows / N) * (rows / f32_own(rows));" in fwd
    w = int(re.search(r"constexpr int F32_W = (\d+);", fwd).group(1))
    slice_ = 64
    # the threads' logits and p, two stages (Q and a slice of K, or V of every key), the key info
    smem = (rows_a_block * rows + 2 * max((rows_a_block + slice_) * (w + 4), rows * (w + 4))) * 4
    assert smem + rows * 4 <= 232448


@pytest.mark.parametrize("kern", [tattn.FlashAttnFwdLong, tattn.FlashAttnBwdLong])
def test_long_wrappers_refuse_what_they_cannot_run(kern):
    """Each long wrapper refuses lists above 256 docs and CPU tensors, each
    before anything is launched, and fp32 lists above 256 docs (fp32 lists
    of at most 256 pass to the device check: the fp32 list kernels)."""
    kern = kern()
    f32 = (((2, 2, 257, 136), torch.float32, "at most 256 docs"),
           ((2, 2, 200, 136), torch.float32, "CUDA tensors"))
    for shape, dtype, match in (*f32,
                                ((2, 2, 257, 136), torch.bfloat16, "at most 256 docs"),
                                ((2, 2, 200, 350), torch.bfloat16, "CUDA tensors")):
        t = torch.zeros(shape, dtype=dtype)
        mask = torch.ones(shape[0], shape[2], dtype=torch.bool)
        s = torch.zeros(shape[0], 2, shape[2])
        with pytest.raises(ValueError, match=match):
            if isinstance(kern, tattn.FlashAttnFwdLong):
                kern(t, t, t, mask, stats=True)
            else:
                kern(t, t, t, t, s, s, s, mask)
    assert kern.launches == 0
