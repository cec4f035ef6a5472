"""The packed attention forward: short lists (N <= 128 docs) at head dims
above 128 in bf16, and in fp32 (3xTF32; above 64 docs the fp32 list kernel).

csrc/flash_attn_fwd.cu's flash_fwd_packed_mma_kernel puts 64 // N
consecutive (b, h) lists in one 64-key tile (N <= 64), or one list of 65 ..
128 docs in a 128-key tile, and computes S once a tile; its plain version is
attention_forward_packed_plain, the same formulas in the same tiles. Here
that plain version is held against attention_forward_plain (output and row
statistics, which the backward kernels read) and against the JAX package's
blockwise attention, at the list lengths around the tiles (N = 1, 5, 16, 20,
33, 64, and the 128-key tile's 65, 100, 128) and the head dims of a one-head
F=136 listsf (136) and the Yahoo! LTR listsf (350). B*H = 10 lists leave a
partial last tile wherever 64 // N > 1 does not divide 10, and the lists
hold a fully padded one beside real ones of every length. Then the route by
shape (`fwd_route`, and which wrapper the autograd forward and the no-grad
path call), the packed forward's grid contract and the wrapper's refusals.
The kernel itself runs only on the card (chip_smoke.py)."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptranking_tpu.ops import attention as jattn
from ptranking_tpu_torch.ops import attention as tattn

torch.set_num_threads(1)

B, H = 5, 2
NS = [1, 5, 16, 20, 33, 64, 65, 100, 128]
DS = [136, 350]


def _case(N, d, dtype, seed=0):
    """numpy inputs (q, k, v, mask: a full list, a ragged one, a fully padded
    one, a full one, a one-doc one) and the port's tensors in `dtype`."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, H, N, d).astype(np.float32) for _ in range(3))
    mask = np.arange(N)[None, :] < np.asarray((N, max(1, N // 2), 0, N, 1))[:, None]
    return (q, k, v, mask), tuple(torch.from_numpy(a).to(dtype) for a in (q, k, v)) + (
        torch.from_numpy(mask),)


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("N", NS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_forward_plain_matches_plain_forward(dtype, N, d):
    """attention_forward_packed_plain == attention_forward_plain on EVERY
    query row, the fully padded list's included: the output within 1e-5 of
    its largest value in fp32 (summation order of the tile's products) and
    2e-2 absolute in bf16 (above 64 docs the packed tile rounds p against
    the row's final max, attention_forward_plain against each 64-key tile's),
    row_max and row_sum within 1e-5 relative (chip_smoke.py's STATS_TOL)."""
    tdt = getattr(torch, dtype)
    _, (q, k, v, mask) = _case(N, d, tdt)
    out, m, l = tattn.attention_forward_packed_plain(q, k, v, mask)
    ref, ref_m, ref_l = tattn.attention_forward_plain(q, k, v, mask)
    assert out.dtype == tdt and out.shape == ref.shape
    assert m.shape == l.shape == (B, H, N) and m.dtype == l.dtype == torch.float32
    assert all(bool(torch.isfinite(t.float()).all()) for t in (out, m, l))
    err = float((out.float() - ref.float()).abs().max())
    if dtype == "float32":
        assert err <= 1e-5 * float(ref.abs().max())
    else:
        assert err <= 2e-2
    assert float(((m - ref_m).abs() / (1.0 + ref_m.abs())).max()) <= 1e-5
    assert float(((l - ref_l).abs() / ref_l).max()) <= 1e-5
    # the fully padded list: m = -1e9 exactly, l = N and the mean of its v
    assert bool((m[2] == -1e9).all()) and bool((l[2] == N).all())


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("N", NS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_forward_plain_matches_jax_blockwise(dtype, N, d):
    """attention_forward_packed_plain against JAX blockwise_attention in the
    same dtype on real query rows: fp32 atol 1e-5 (summation order), bf16
    atol 2e-2 (both round p to bf16 before p v, JAX each block's
    unnormalised p against its running max)."""
    tdt = getattr(torch, dtype)
    (q, k, v, mask), tensors = _case(N, d, tdt)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ref = jattn.blockwise_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                    jnp.asarray(mask), block_size=64)
    ref = np.asarray(ref.astype(jnp.float32))
    out = tattn.attention_forward_packed_plain(*tensors)[0].float().numpy()
    real = np.broadcast_to(mask[:, None, :, None], out.shape)
    np.testing.assert_allclose(out[real], ref[real], rtol=0,
                               atol=1e-5 if dtype == "float32" else 2e-2)


def test_packed_forward_plain_leaves_other_lists_keys_out():
    """A tile of four 16-doc lists (two b, two heads each) whose first b is
    fully padded gives that b's rows m = -1e9, l = 16 and the mean of their
    own list's v, and the other b's rows the same bits as when the first b
    is full: another list's keys are left out, not masked."""
    N, d = 16, 136
    _, (q, k, v, _) = _case(N, d, torch.float32)
    q, k, v = (t[:2] for t in (q, k, v))  # 4 lists: one tile
    outs = []
    for first in (0, N):
        mask = torch.ones(2, N, dtype=torch.bool)
        mask[0, first:] = False
        outs.append(tattn.attention_forward_packed_plain(q, k, v, mask))
    out, m, l = outs[0]
    assert bool((m[0] == -1e9).all()) and bool((l[0] == N).all())
    torch.testing.assert_close(out[0], v[0].mean(dim=1, keepdim=True).expand(2, N, d),
                               rtol=1e-6, atol=1e-6)
    for got, full in zip(outs[0], outs[1]):
        assert torch.equal(got[1], full[1])


def test_packed_forward_plain_refuses_long_lists():
    """Above 256 docs a list fits no packed tile (the long kernel's 256-key
    tile is the largest)."""
    _, (q, k, v, mask) = _case(257, 8, torch.float32)
    with pytest.raises(ValueError, match="at most 256 docs"):
        tattn.attention_forward_packed_plain(q, k, v, mask)


@pytest.mark.parametrize("dtype, N, d, route", [
    (torch.bfloat16, 1, 350, "packed"), (torch.bfloat16, 16, 129, "packed"),
    (torch.bfloat16, 64, 384, "packed"), (torch.bfloat16, 128, 350, "packed"),
    (torch.bfloat16, 65, 136, "packed"), (torch.bfloat16, 129, 350, "long"),
    (torch.bfloat16, 256, 384, "long"), (torch.bfloat16, 200, 136, "long"),
    (torch.bfloat16, 257, 350, "flash"), (torch.bfloat16, 16, 128, "flash"),
    (torch.bfloat16, 32, 68, "flash"), (torch.float32, 16, 350, "packed"),
    (torch.float32, 1, 129, "packed"), (torch.float32, tattn.F32_PACK_MAX_N, 384, "packed"),
    (torch.float32, 65, 350, "packed"), (torch.float32, 16, 128, "flash"),
    (torch.float32, 128, 136, "packed"),
    *((torch.float32, N, d, route) for N, route in ((65, "packed"), (128, "packed"),
                                                    (129, "long"), (256, "long"))
      for d in (136, 350, 384)),
    (torch.float32, 257, 350, "flash"), (torch.float32, 257, 384, "flash"),
    (torch.float32, 200, 128, "flash"), (torch.float32, 65, 68, "flash")])
def test_fwd_route_by_shape(dtype, N, d, route):
    """The packed forward takes bf16, d > 128 and N <= FWD_PACK_MAX_N (128),
    and fp32, d > 128 and N <= F32_FWD_LIST_MAX_N (128: the fp32 packed
    kernel up to 64 docs, the fp32 list kernel above); the long forward bf16
    at FWD_PACK_MAX_N < N <= LONG_MAX_N (256) and fp32 at F32_FWD_LIST_MAX_N
    < N <= F32_FWD_LONG_MAX_N (256: the fp32 list kernel's 256-row tile);
    everything else keeps FlashAttnFwd (the wide kernel at d > 128)."""
    assert 64 <= tattn.FWD_PACK_MAX_N <= 128 and tattn.FWD_PACK_MAX_N <= tattn.LONG_MAX_N <= 256
    assert 1 <= tattn.F32_PACK_MAX_N <= 64
    assert tattn.F32_PACK_MAX_N < tattn.F32_FWD_LIST_MAX_N <= 128
    assert tattn.F32_FWD_LIST_MAX_N <= tattn.F32_FWD_LONG_MAX_N <= 256
    assert tattn.fwd_route(dtype, N, d) == route


class _OnCuda(torch.Tensor):
    """A CPU tensor that says it lies on the card, so that flash_attention
    takes its kernel path to the (stubbed) wrappers."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("dtype, shape, route", [
    (torch.bfloat16, (2, 2, 16, 350), "packed"), (torch.bfloat16, (2, 2, 128, 136), "packed"),
    (torch.bfloat16, (2, 2, 129, 136), "long"), (torch.bfloat16, (2, 2, 257, 136), "flash"),
    (torch.bfloat16, (2, 2, 16, 128), "flash"), (torch.float32, (2, 2, 16, 350), "packed"),
    (torch.float32, (2, 2, 65, 350), "packed"), (torch.float32, (2, 2, 128, 384), "packed"),
    (torch.float32, (2, 2, 129, 136), "long"), (torch.float32, (2, 2, 256, 350), "long"),
    (torch.float32, (2, 2, 257, 136), "flash")])
def test_flash_forward_calls_the_routed_kernel(monkeypatch, dtype, shape, route):
    """_FlashAttention.forward (with row statistics, which it saves for the
    backward) and flash_attention's no-grad path (without) call the packed
    wrapper, the long one or FlashAttnFwd as fwd_route says (the wrappers
    stubbed: the kernels run only on the card)."""
    calls = []

    def stub(name):
        def run(q, k, v, mask, stats=False):
            calls.append((name, stats))
            out = torch.full_like(q, {"packed": 1.0, "flash": 2.0, "long": 3.0}[name])
            B, H, N, _ = q.shape
            return (out, torch.zeros(B, H, N), torch.ones(B, H, N)) if stats else out
        return run

    monkeypatch.setattr(tattn, "FLASH_ATTN_FWD_PACKED", stub("packed"))
    monkeypatch.setattr(tattn, "FLASH_ATTN_FWD", stub("flash"))
    monkeypatch.setattr(tattn, "FLASH_ATTN_FWD_LONG", stub("long"))
    q, k, v = (torch.randn(shape).to(dtype) for _ in range(3))
    mask = torch.ones(shape[0], shape[2], dtype=torch.bool)
    saved = []
    ctx = types.SimpleNamespace(save_for_backward=lambda *t: saved.extend(t))
    out = tattn._FlashAttention.forward(ctx, q, k, v, mask)
    assert len(saved) == 7 and saved[4] is out
    with torch.no_grad():
        served = tattn.flash_attention(*(torch.Tensor._make_subclass(_OnCuda, t)
                                         for t in (q, k, v, mask)))
    assert calls == [(route, True), (route, False)]
    assert float(out.float().mean()) == float(served.float().mean()) == {
        "packed": 1.0, "flash": 2.0, "long": 3.0}[route]


def test_packed_forward_grid_contract():
    """The packed forward's grid: one block per tile of 64 // N lists up to
    64 docs, two per list (64 query rows each) of 65 .. 128 docs, on grid.x
    in one launch; N above 128, B*H past 2^31 - 1 lists and grids past
    2^31 - 1 blocks are refused. The kernel's key tiles are the package's."""
    assert tattn.fwd_packed_blocks(2048, 2, 16) == 1024
    assert tattn.fwd_packed_blocks(512, 2, 64) == 1024
    assert tattn.fwd_packed_blocks(5, 2, 20) == 4  # 3 lists a tile, the last tile holds one
    assert tattn.fwd_packed_blocks(256, 2, 128) == 1024
    assert tattn.fwd_packed_blocks(5, 2, 65) == 20
    assert tattn.kernel_launches(32769, 2, 100, 350, packed=True) == 1
    name = "flash_attn_fwd_packed"
    tattn.check_grid(32769, 2, 5, 136, packed=name)
    tattn.check_grid(1, 1, 128, 520, packed=name)
    with pytest.raises(ValueError, match="at most 128 docs"):
        tattn.check_grid(2, 2, 129, 350, packed=name)
    with pytest.raises(ValueError, match="at most 2147483647 of them"):
        tattn.check_grid(2 ** 30, 4, 16, 350, packed=name)
    with pytest.raises(ValueError, match="blocks of flash_attn_fwd_packed on grid.x"):
        tattn.check_grid(2 ** 29, 2, 100, 350, packed=name)
    source = (tattn.cuda_build.CSRC / "flash_attn_fwd.cu").read_text()
    assert "constexpr int PACK_KEYS = OWN;" in source and "constexpr int OWN = 16 * MMA_WARPS;" in source
    assert "constexpr int MMA_WARPS = 4;" in source and "constexpr int LIST_KEYS = 2 * OWN;" in source


def test_packed_forward_wrapper_refuses_what_it_cannot_run():
    """The wrapper refuses bf16 lists above 128 docs, fp32 lists above 128
    and CPU tensors, each before anything is launched; fp32 lists of at most
    128 docs (the fp32 list kernel above 64) pass to the device check."""
    kern = tattn.FlashAttnFwdPacked()
    for shape, dtype, match in (((2, 2, 16, 136), torch.float32, "CUDA tensors"),
                                ((2, 2, 65, 136), torch.float32, "CUDA tensors"),
                                ((2, 2, 129, 136), torch.float32, "at most 128 docs"),
                                ((2, 2, 129, 136), torch.bfloat16, "at most 128 docs"),
                                ((2, 2, 16, 350), torch.bfloat16, "CUDA tensors")):
        t = torch.zeros(shape, dtype=dtype)
        mask = torch.ones(shape[0], shape[2], dtype=torch.bool)
        with pytest.raises(ValueError, match=match):
            kern(t, t, t, mask, stats=True)
    assert kern.launches == 0
