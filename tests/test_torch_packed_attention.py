"""The packed attention backward: short lists (N <= 128 docs) at head dims
above 128 in bf16.

csrc/flash_attn_bwd.cu's flash_bwd_packed_mma_kernel puts 64 // N
consecutive (b, h) lists in one 64-row tile (the packed kernel, N <= 64), or
one list of 65 .. 128 docs in a 128-row tile (the list kernel), and computes
dq, dk and dv of the tile in one block; its plain version is
attention_backward_packed_plain, the same formulas in the same tiles. Here
that plain version is held against attention_backward_plain (one list at a
time) and against the JAX package's blockwise attention and its gradients,
at the list lengths around the tiles (N = 1, 5, 16, 20, 33, 64: one list a
tile up to 64 a tile, N dividing 64 or not; 65, 100, 128: the list kernel's
one list a tile, 128 dividing N or not) and the head dims of a one-head
F=136 listsf (136) and the Yahoo! LTR listsf (350). B*H = 10 lists leave a
partial last tile wherever 64 // N > 1 does not divide 10, and the lists
hold a fully padded one beside real ones of every length. Then the route by
shape (`bwd_route`, and which wrappers `_FlashAttention.backward` calls),
the packed grids' shape contract and the wrappers' refusals. The kernels
themselves run only on the card (chip_smoke.py)."""

import types

import jax
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


def _lengths(N):
    """A full list, a ragged one, a fully padded one, a full one, a one-doc one."""
    return (N, max(1, N // 2), 0, N, 1)


def _case(N, d, dtype, seed=0):
    """numpy inputs (q, k, v, output gradient, mask) and the port's tensors in
    `dtype` with attention_forward_plain's output and row statistics."""
    rng = np.random.RandomState(seed)
    q, k, v, cot = (rng.randn(B, H, N, d).astype(np.float32) for _ in range(4))
    mask = np.arange(N)[None, :] < np.asarray(_lengths(N))[:, None]
    tq, tk, tv, tcot = (torch.from_numpy(a).to(dtype) for a in (q, k, v, cot))
    tm = torch.from_numpy(mask)
    out, m, l = tattn.attention_forward_plain(tq, tk, tv, tm)
    return (q, k, v, cot, mask), (tq, tk, tv, tcot, tm, out, m, l)


def _rel(got, ref, floor):
    """max |got - ref| / max(max |ref|, floor)."""
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max()) / max(float(ref.abs().max()), floor)


def _floor(dv):
    """The scale below which a gradient is compared absolutely: dq and dk of
    a one-doc list are sums of P (dP - D) that cancel to rounding noise (at
    N = 1 every list is one: about 1e-7 of dv), so a gradient whose largest
    value is below a tenth of the largest dv (P^T dO, which does not cancel;
    of the order of dq and dk where they do not cancel either) is held at
    that tenth."""
    return 0.1 * float(dv.float().abs().max())


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("N", NS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_plain_matches_plain_backward(dtype, N, d):
    """attention_backward_packed_plain == attention_backward_plain on EVERY
    list, the fully padded one included (its P = 1/l falls on its own keys
    only, so no other list's dv moves), for an output gradient on every row.
    Relative error per gradient (the floor of `_floor`): fp32 1e-5
    (summation order of the tile's products); bf16 1e-2 (the same roundings
    at the same points; a P or dS on the other side of a bf16 rounding now
    and then)."""
    tdt = getattr(torch, dtype)
    _, (q, k, v, cot, mask, out, m, l) = _case(N, d, tdt)
    got = tattn.attention_backward_packed_plain(q, k, v, cot, out, m, l, mask)
    ref = tattn.attention_backward_plain(q, k, v, cot, out, m, l, mask)
    tol = 1e-5 if dtype == "float32" else 1e-2
    floor = _floor(ref[2])
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == tdt and g.shape == r.shape, name
        assert torch.isfinite(g.float()).all(), name
        assert _rel(g, r, floor) <= tol, name


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("N", NS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_plain_matches_jax_grad(dtype, N, d):
    """attention_backward_packed_plain, from attention_forward_plain's output
    and row statistics (what the forward kernel gives the backward), against
    jax.grad through JAX blockwise_attention in the same dtype, for an output
    gradient on real rows, over the lists with a real document. fp32: rtol
    1e-4, atol 1e-5 (summation order). bf16: relative error per gradient
    2e-2 (chip_smoke.py's BWD_TOL), with `_floor`'s floor: both round P and
    dS to bf16, JAX at other points (each block's unnormalised p)."""
    tdt = getattr(torch, dtype)
    (q, k, v, cot, mask), (tq, tk, tv, _, tm, out, m, l) = _case(N, d, tdt)
    cot = np.where(mask[:, None, :, None], cot, 0.0).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16

    def jloss(q, k, v):
        o = jattn.blockwise_attention(q, k, v, jnp.asarray(mask), block_size=64)
        return jnp.sum(o.astype(jnp.float32) * cot)

    ref = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a, jdt) for a in (q, k, v)))
    ref = [np.asarray(r.astype(jnp.float32)) for r in ref]
    got = tattn.attention_backward_packed_plain(tq, tk, tv, torch.from_numpy(cot).to(tdt), out,
                                                m, l, tm)
    real = mask.any(axis=1)
    floor = _floor(torch.from_numpy(ref[2][real]))
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert torch.isfinite(g.float()).all(), name
        g = g.float().numpy()[real]
        if dtype == "float32":
            np.testing.assert_allclose(g, r[real], rtol=1e-4, atol=1e-5, err_msg=name)
        else:
            assert _rel(torch.from_numpy(g), torch.from_numpy(r[real]), floor) <= 2e-2, name


def test_packed_plain_leaves_other_lists_keys_out():
    """The trap of packing: a fully padded list has m = -1e9 and P = 1/l on
    its keys. Were another list's keys of its tile only masked (logit -1e9)
    and not left out, the same 1/l would land on them and move their dv. A
    tile of four 16-doc lists (two b, two heads each) whose first b is fully
    padded gives the other b's lists the same dv, to the bit, as when that b
    is full."""
    N, d = 16, 136
    _, (q, k, v, cot, mask, out, m, l) = _case(N, d, torch.float32)
    q, k, v, cot = (t[:2] for t in (q, k, v, cot))  # 4 lists: one tile
    for first in (0, N):
        tm = torch.ones(2, N, dtype=torch.bool)
        tm[0, first:] = False
        o, m, l = tattn.attention_forward_plain(q, k, v, tm)
        dv = tattn.attention_backward_packed_plain(q, k, v, cot, o, m, l, tm)[2]
        if first == 0:
            assert bool((m[0] == -1e9).all())
            padded = dv
    assert torch.equal(padded[1], dv[1])


@pytest.mark.parametrize("dtype, N, d, route", [
    (torch.bfloat16, 1, 350, "packed"), (torch.bfloat16, 64, 129, "packed"),
    (torch.bfloat16, tattn.PACK_MAX_N, 384, "packed"),
    (torch.bfloat16, tattn.PACK_MAX_N + 1, 350, "list"), (torch.bfloat16, 128, 350, "list"),
    (torch.bfloat16, 100, 136, "list"), (torch.bfloat16, 129, 350, "long"),
    (torch.bfloat16, 256, 384, "long"), (torch.bfloat16, 200, 136, "long"),
    (torch.bfloat16, 257, 350, "pair"),
    (torch.bfloat16, 16, 128, "pair"), (torch.bfloat16, 16, 68, "pair"),
    (torch.bfloat16, 128, 128, "pair"),
    (torch.float32, 16, 350, "packed"), (torch.float32, 64, 136, "packed"),
    (torch.float32, tattn.F32_PACK_MAX_N, 384, "packed"), (torch.float32, 65, 350, "list"),
    (torch.float32, 16, 128, "pair"), (torch.float32, 128, 350, "list"),
    (torch.float32, 129, 350, "long"), (torch.float32, 256, 384, "long"),
    (torch.float32, 257, 350, "pair")])
def test_bwd_route_by_shape(dtype, N, d, route):
    """At bf16 and d > 128 the packed kernel takes N <= PACK_MAX_N (64), the
    list kernel PACK_MAX_N < N <= LIST_MAX_N (128), the long kernel
    LIST_MAX_N < N <= LONG_MAX_N (256); at fp32 and d > 128 the packed
    kernel (3xTF32) takes N <= F32_PACK_MAX_N (64), the list kernel's fp32
    instantiation F32_PACK_MAX_N < N <= F32_LIST_MAX_N (128), the long
    one's F32_LIST_MAX_N < N <= F32_LONG_MAX_N (256); everything else keeps
    the dk/dv and dq pair."""
    assert 1 <= tattn.PACK_MAX_N <= 64 and tattn.PACK_MAX_N <= tattn.LIST_MAX_N <= 128
    assert tattn.LIST_MAX_N <= tattn.LONG_MAX_N <= 256 and 1 <= tattn.F32_PACK_MAX_N <= 64
    assert tattn.F32_PACK_MAX_N <= tattn.F32_LIST_MAX_N <= 128
    assert tattn.F32_LIST_MAX_N <= tattn.F32_LONG_MAX_N <= 256
    assert tattn.bwd_route(dtype, N, d) == route


@pytest.mark.parametrize("dtype, shape, route", [
    (torch.bfloat16, (2, 2, 16, 136), "packed"), (torch.bfloat16, (2, 2, 65, 136), "list"),
    (torch.bfloat16, (2, 2, 129, 136), "long"), (torch.bfloat16, (2, 2, 257, 136), "pair"),
    (torch.bfloat16, (2, 2, 16, 128), "pair"), (torch.float32, (2, 2, 16, 136), "packed"),
    (torch.float32, (2, 2, 65, 350), "list"), (torch.float32, (2, 2, 129, 350), "long"),
    (torch.float32, (2, 2, 257, 350), "pair")])
def test_flash_backward_calls_the_routed_kernels(monkeypatch, dtype, shape, route):
    """_FlashAttention.backward calls the packed, the list or the long
    wrapper alone, or the dk/dv and dq wrappers, as bwd_route says (the wrappers stubbed:
    the kernels run only on the card), and returns their gradients in the
    order (dq, dk, dv)."""
    calls = []

    def stub(name, outputs):
        def run(q, k, v, dout, row_max, row_sum, dsum, mask):
            calls.append(name)
            grads = tuple(torch.full_like(q, float(i)) for i in range(1, outputs + 1))
            return grads if outputs > 1 else grads[0]
        return run

    monkeypatch.setattr(tattn, "FLASH_ATTN_BWD_PACKED", stub("packed", 3))
    monkeypatch.setattr(tattn, "FLASH_ATTN_BWD_LIST", stub("list", 3))
    monkeypatch.setattr(tattn, "FLASH_ATTN_BWD_LONG", stub("long", 3))
    monkeypatch.setattr(tattn, "FLASH_ATTN_BWD_DKDV", stub("dkdv", 2))
    monkeypatch.setattr(tattn, "FLASH_ATTN_BWD_DQ", stub("dq", 1))
    q, k, v, dout = (torch.randn(shape).to(dtype) for _ in range(4))
    mask = torch.ones(shape[0], shape[2], dtype=torch.bool)
    out, m, l = tattn.attention_forward_plain(q, k, v, mask)
    ctx = types.SimpleNamespace(saved_tensors=(q, k, v, mask, out, m, l))
    dq, dk, dv, none = tattn._FlashAttention.backward(ctx, dout)
    assert none is None
    if route in ("packed", "list", "long"):
        assert calls == [route]
        assert [float(t.float().mean()) for t in (dq, dk, dv)] == [1.0, 2.0, 3.0]
    else:
        assert calls == ["dkdv", "dq"]
        assert [float(t.float().mean()) for t in (dq, dk, dv)] == [1.0, 1.0, 2.0]


def test_packed_grid_contract():
    """The packed grid: one block per tile of 64 // N lists on grid.x, one
    launch whatever the batch (B*H past 65535 included); N above 64 and
    B*H past 2^31 - 1 lists (which the C entry refuses) are refused. The
    list kernel's: one block per list of 65 .. 128 docs (per 128 // N lists
    below), N above 128 refused."""
    assert tattn.packed_blocks(2048, 2, 16) == 1024
    assert tattn.packed_blocks(1024, 2, 32) == 1024
    assert tattn.packed_blocks(512, 2, 64) == 1024
    assert tattn.packed_blocks(5, 2, 20) == 4  # 3 lists a tile, the last tile holds one
    assert tattn.packed_blocks(5, 2, 33) == 10  # one list a tile, rows 33 .. 63 empty
    assert tattn.packed_blocks(32769, 2, 5) == 5462
    assert tattn.kernel_launches(32769, 2, 5, 8, packed=True) == 1
    assert tattn.kernel_launches(2048, 2, 16, 350, packed=True) == 1
    packed, listk = "flash_attn_bwd_packed", "flash_attn_bwd_list"
    tattn.check_grid(32769, 2, 5, 136, packed=packed)
    tattn.check_grid(1, 1, 64, 520, packed=packed)
    with pytest.raises(ValueError, match="at most 64 docs"):
        tattn.check_grid(2, 2, 65, 350, packed=packed)
    with pytest.raises(ValueError, match="at most 2147483647 of them"):
        tattn.check_grid(2 ** 30, 4, 64, 350, packed=packed)
    assert tattn.packed_blocks(256, 2, 128, rows=128) == 512
    assert tattn.packed_blocks(5, 2, 65, rows=128) == 10
    assert tattn.packed_blocks(5, 2, 64, rows=128) == 5  # two lists a tile below 65 docs
    tattn.check_grid(256, 2, 128, 350, packed=listk)
    tattn.check_grid(32769, 2, 100, 136, packed=listk)
    with pytest.raises(ValueError, match="at most 128 docs"):
        tattn.check_grid(2, 2, 129, 350, packed=listk)
    with pytest.raises(ValueError, match="at most 2147483647 of them"):
        tattn.check_grid(2 ** 30, 4, 128, 350, packed=listk)
    source = (tattn.cuda_build.CSRC / "flash_attn_bwd.cu").read_text()
    assert f"constexpr int PACK_ROWS = {tattn._ROWS};" in source
    assert f"constexpr int LIST_ROWS = {tattn._LIST_ROWS};" in source


def _refuses(kern, longest):
    """kern refuses lists above `longest` docs in either dtype and CPU
    tensors, each before anything is launched."""
    stats = lambda B, N: torch.zeros(B, 2, N)
    for shape, dtype, match in (((2, 2, 16, 136), torch.float32, "CUDA tensors"),
                                ((2, 2, longest + 1, 136), torch.float32,
                                 f"at most {longest} docs"),
                                ((2, 2, longest + 1, 136), torch.bfloat16,
                                 f"at most {longest} docs"),
                                ((2, 2, 16, 350), torch.bfloat16, "CUDA tensors")):
        t = torch.zeros(shape, dtype=dtype)
        mask = torch.ones(shape[0], shape[2], dtype=torch.bool)
        s = stats(shape[0], shape[2])
        with pytest.raises(ValueError, match=match):
            kern(t, t, t, t, s, s, s, mask)
    assert kern.launches == 0


def test_packed_wrapper_refuses_what_it_cannot_run():
    """The wrapper refuses lists above 64 docs (bf16 or fp32) and CPU
    tensors, each before anything is launched; fp32 lists of at most 64 docs
    pass to the device check."""
    _refuses(tattn.FlashAttnBwdPacked(), 64)


def test_list_wrapper_refuses_what_it_cannot_run():
    """The list kernel's wrapper likewise, with lists above 128 docs in
    either dtype; fp32 lists of at most 128 docs pass to the device check."""
    _refuses(tattn.FlashAttnBwdList(), 128)
