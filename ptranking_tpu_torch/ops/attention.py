"""Masked attention for the listwise scorer's MHSA: flash kernels and their plain version.

Counterpart of ptranking_tpu/ops/attention.py. Attention-probability dropout
is applied only in `blockwise_attention` (the scorer's attn_block_size path),
as in the JAX package, whose flash path applies none either:

  * `blockwise_attention` — the online-softmax loop over key blocks, in plain
    torch. It is the plain version of the kernels: what `flash_attention` runs
    on the CPU (forward, and backward through autograd), and what the kernels
    are held against on the card.
  * `flash_attention` — the same function through the hand-written CUDA
    kernels for CUDA tensors: `csrc/flash_attn_fwd.cu` forward, and when a
    gradient is needed, `csrc/flash_attn_bwd.cu` backward (dq, and dk with dv)
    from the forward's row statistics, as a `torch.autograd.Function`: bf16
    inputs on the tensor cores; fp32 inputs on the tensor cores too, each
    product as three TF32 products (3xTF32, about fp32's accuracy), at every
    head dim and list length. CPU
    tensors go through `blockwise_attention(block_size=min(128, N))`, which is
    exactly what the JAX package lowers off-TPU (models/scorers/listsf.py).
  * `sdpa_block` and `online_combine` — one (query block, key block)
    partial softmax and the fold of a partial into running accumulators,
    the block math of parallel/ring.py's context-parallel attention (which
    the JAX package's blockwise path shares; here `blockwise_attention`
    keeps its own loop, with its dropout draws).
  * `attention_forward_plain` and `attention_backward_plain` — the forward
    and backward kernels' formulas in plain torch, with the kernels' tiles,
    row statistics and rounding points, and `attention_forward_packed_plain`
    and `attention_backward_packed_plain`, the same forward and backward in
    the tiles of the kernels that take whole lists of at most 256 docs into
    a block.
    Tests and the card check hold the kernels against them; no training or
    serving path calls them.

At head dims above 128 the bf16 forward takes, for lists of at most
FWD_PACK_MAX_N docs, the packed forward kernel (S once a tile of 64 // N
lists, or of one list of up to 128 docs), for lists of at most LONG_MAX_N
docs the long forward kernel (S once a 256-key tile of one list, in two
halves), and the wide kernel otherwise (`fwd_route`). The bf16 backward
takes, for lists of at most PACK_MAX_N docs, the packed kernel (dq, dk and
dv of 64 // N lists a block, one launch), for lists of at most LIST_MAX_N
docs the list kernel (the same on a 128-row tile, one list a block), for
lists of at most LONG_MAX_N docs the long kernel (one list of up to 256
docs a block, in two halves of its keys), and the wide dk/dv and dq kernels
otherwise (`bwd_route`). In fp32 at head dims above 128 the forward takes,
for lists of at most F32_FWD_LIST_MAX_N docs, the packed forward's wrapper
(its fp32 packed kernel on 3xTF32 tensor-core products up to 64 docs, the
fp32 list kernel, one list a 128-row tile, above) and for lists of at most
F32_FWD_LONG_MAX_N docs the long forward's (the fp32 list kernel on a
256-row tile; S once in slices of 64 keys, 3xTF32), and the fp32 wide
forward above (3xTF32: a block for each 64 query rows and all of their
output columns, S once a 64-key tile); the backward takes, for lists of at
most F32_PACK_MAX_N docs, the packed backward on 3xTF32, for lists of at
most F32_LIST_MAX_N docs the list kernel's fp32 instantiation and for lists
of at most F32_LONG_MAX_N docs the long kernel's (one list a block of 8
warps, its keys in slices of 64, 3xTF32), and the fp32 wide dk/dv and dq
kernels above (3xTF32, a block's rows and all of their output columns).

Layouts are the JAX package's: q, k, v `[B, H, N, d]`, mask `[B, N]` (True =
real document). Masked keys get logit -1e9; rows whose keys are all masked
(padded remainder rows) are finite garbage by contract — every consumer
applies the mask.
"""

from __future__ import annotations

import ctypes

import torch

from ptranking_tpu_torch.ops import cuda_build
from ptranking_tpu_torch.parallel.collectives import batch_rand

_NEG = -1e9
# keys a tile of the forward kernels (TILE and BN in csrc/flash_attn_fwd.cu; the
# fp32 kernel of d <= 128 takes 32, F32N_TILE, which moves only the rescales'
# rounding)
_FWD_TILE = 64


def sdpa_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kmask: torch.Tensor,
               scale: float):
    """One (query block, key block) partial attention: (num, denom, m) with

        num   = sum_j exp(logit_j - m) v_j   [B, H, nq, d]
        denom = sum_j exp(logit_j - m)       [B, H, nq]
        m     = max_j logit_j                [B, H, nq]

    q [B, H, nq, d], k and v [B, H, nk, d], kmask [B, nk]. The logits and
    accumulators are fp32 and a masked key gets logit -1e9; the block's
    probabilities are rounded to v's dtype before the p v product, as in
    the JAX package."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    logits = torch.where(kmask[:, None, None, :], logits, _NEG)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    num = torch.matmul(p.to(v.dtype).float(), v.float())
    return num, p.sum(dim=-1), m


def online_combine(num: torch.Tensor, den: torch.Tensor, mx: torch.Tensor,
                   part_num: torch.Tensor, part_den: torch.Tensor, part_m: torch.Tensor):
    """Fold one block's partial softmax (sdpa_block) into the running
    (num, den, mx); mx may start at -inf (no block folded yet)."""
    new_mx = torch.maximum(mx, part_m)
    alpha = torch.exp(mx - new_mx)
    beta = torch.exp(part_m - new_mx)
    return (num * alpha[..., None] + part_num * beta[..., None], den * alpha + part_den * beta,
            new_mx)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: torch.Tensor, block_size: int = 512, drop_rate: float = 0.0,
                        gen: "torch.Generator | None" = None,
                        heads: "tuple | None" = None) -> torch.Tensor:
    """Online-softmax attention over key blocks of `block_size`: fp32 logits
    and accumulators, the block's probabilities rounded to v's dtype before
    the p.v product (as the JAX package does), output in q's dtype.

    With drop_rate > 0 and a generator `gen` (on q's device), attention
    dropout as the JAX package applies it inside the blocks: each block
    draws its keep-mask [B, H, N, block] from `gen` in turn and drops the
    numerator's terms only (kept ones scaled by 1/(1 - drop_rate)); the
    denominator sums the undropped terms, so the result is dense dropout of
    the softmax probabilities followed by p.v. `heads=(H_full, start)` says
    q, k, v hold heads [start, start + H) of H_full (a tensor-parallel
    rank's heads): each block draws for all H_full heads and keeps these."""
    B, H, N, d = q.shape
    block = min(block_size, N)
    rem = (-N) % block
    if rem:  # pad the KEY axis; padded keys are masked out
        k = torch.nn.functional.pad(k, (0, 0, 0, rem))
        v = torch.nn.functional.pad(v, (0, 0, 0, rem))
        mask = torch.nn.functional.pad(mask, (0, rem), value=False)
    scale = 1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32, device=q.device))
    qf = q.float()
    num = torch.zeros((B, H, N, d), dtype=torch.float32, device=q.device)
    den = torch.zeros((B, H, N), dtype=torch.float32, device=q.device)
    mx = torch.full((B, H, N), float("-inf"), dtype=torch.float32, device=q.device)
    for s in range(0, k.shape[2], block):
        kb, vb, mb = k[:, :, s:s + block], v[:, :, s:s + block], mask[:, s:s + block]
        logits = torch.matmul(qf, kb.float().transpose(-1, -2)) * scale
        logits = torch.where(mb[:, None, None, :], logits, _NEG)
        m = logits.amax(dim=-1)
        p = torch.exp(logits - m[..., None])
        p_num = p
        if drop_rate > 0.0 and gen is not None:
            keep = 1.0 - drop_rate
            keep_mask = batch_rand(p.shape, gen, p.device,
                                   split=None if heads is None else (1, *heads)) < keep
            p_num = torch.where(keep_mask, p / keep, 0.0)
        part_num = torch.matmul(p_num.to(v.dtype).float(), vb.float())
        new_mx = torch.maximum(mx, m)
        alpha = torch.exp(mx - new_mx)
        beta = torch.exp(m - new_mx)
        num = num * alpha[..., None] + part_num * beta[..., None]
        den = den * alpha + p.sum(dim=-1) * beta
        mx = new_mx
    out = num / torch.clamp(den, min=1e-30)[..., None]
    return out.to(q.dtype)


def attention_forward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            mask: torch.Tensor):
    """(out, row_max, row_sum) of masked attention as the forward kernels
    compute them: a loop over 64-key tiles with a running max m (from -1e30)
    and sum l,

        x = q k^T * scale (a masked key: the constant -1e9), m' = max(m, max x),
        p = exp(x - m'),  l' = l exp(m - m') + sum p,  O' = O exp(m - m') + p v,

    with fp32 logits, p and l (l summed from the fp32 p), p rounded to the
    inputs' dtype before p v (a no-op in fp32), fp32 accumulation, and one
    rounding at the output O / l. row_max and row_sum ([B, H, N] fp32) are the
    final m and l, so that p = exp(x - m) / l; a list with no real key gets
    m = -1e9, l = N and the mean of v."""
    B, H, N, d = q.shape
    scale = 1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32, device=q.device))
    qf = q.float()
    m = torch.full((B, H, N), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, N), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, N, d), dtype=torch.float32, device=q.device)
    for s in range(0, N, _FWD_TILE):
        kb, vb = k[:, :, s:s + _FWD_TILE].float(), v[:, :, s:s + _FWD_TILE].float()
        x = torch.where(mask[:, None, None, s:s + _FWD_TILE],
                        torch.matmul(qf, kb.transpose(-1, -2)) * scale, _NEG)
        m_new = torch.maximum(m, x.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(x - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(p.to(v.dtype).float(), vb)
        m = m_new
    return (acc * (1.0 / l)[..., None]).to(q.dtype), m, l


def attention_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             dout: torch.Tensor, out: torch.Tensor, row_max: torch.Tensor,
                             row_sum: torch.Tensor, mask: torch.Tensor):
    """(dq, dk, dv) of masked attention for the output gradient `dout`, as
    the backward kernels compute them: from the forward's output and each
    query row's softmax max `row_max` and sum `row_sum` ([B, H, N] fp32, a
    masked key's logit being the constant -1e9),

        P = exp(x - m) / l,  dP = dO v^T,  dS = P * (dP - rowsum(dO * O))

    for a real key and dS = 0 for a masked one, then dv = P^T dO,
    dk = scale * dS^T q, dq = scale * dS k. Logits, P and dS are fp32; P and
    dS are rounded to the inputs' dtype before the last three products (a
    no-op in fp32), which accumulate in fp32; outputs in the inputs' dtype.
    Materialises [B, H, N, N]."""
    scale = 1.0 / float(q.shape[-1]) ** 0.5
    qf, kf, vf, dof = (t.float() for t in (q, k, v, dout))
    real = mask[:, None, None, :]
    x = torch.where(real, torch.matmul(qf, kf.transpose(-1, -2)) * scale, _NEG)
    p = torch.exp(x - row_max[..., None]) / row_sum[..., None]
    dsum = torch.sum(dof * out.float(), dim=-1)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = torch.where(real, p * (dp - dsum[..., None]), 0.0)
    p, ds = (t.to(q.dtype).float() for t in (p, ds))
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dq = torch.matmul(ds, kf) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _tile_rows(N: int) -> int:
    """Rows of the packing kernels' tile for lists of N docs: 64 (64 // N
    lists a tile) up to 64 docs, 128 (one list) up to 128, 256 (one list,
    the long kernels) up to 256; raises beyond."""
    if not 1 <= N <= _LONG_ROWS:
        raise ValueError(f"packed tiles take lists of at most {_LONG_ROWS} docs; got N = {N}")
    return _ROWS if N <= _ROWS else _LIST_ROWS if N <= _LIST_ROWS else _LONG_ROWS


def _packing(mask: torch.Tensor, H: int, N: int, rows: int):
    """The [B*H*N] rows of B*H lists of N docs cut into tiles of `rows` rows:
    p = rows // N consecutive (b, h) lists a tile (the last one padded with
    empty lists), each tile's rows both query rows and keys, rows p*N .. up
    empty. Returns (pack, unpack, same, real): pack(t, fill) turns a [B, H,
    N, ...] tensor into [tiles, rows, ...] fp32 (empty rows `fill`),
    unpack(t, dtype) a [tiles, rows, d] one back into [B, H, N, d] of
    `dtype`; same [tiles, rows, rows] says a query row and a key belong to
    one list of the tile, real that the key is also a real document."""
    B = mask.shape[0]
    lists, per_tile = B * H, rows // N
    tiles = -(-lists // per_tile)

    def pack(t, fill=0.0):
        flat = t.float().reshape(lists * N, -1)
        flat = torch.nn.functional.pad(flat, (0, 0, 0, (tiles * per_tile - lists) * N), value=fill)
        flat = flat.reshape(tiles, per_tile * N, -1)
        return torch.nn.functional.pad(flat, (0, 0, 0, rows - per_tile * N), value=fill)

    def unpack(t, dtype):
        d = t.shape[-1]
        return t[:, :per_tile * N].reshape(-1, d)[:lists * N].reshape(B, H, N, d).to(dtype)

    seg = torch.arange(rows, device=mask.device) // N         # a tile row's list in the tile
    lst = torch.arange(tiles, device=mask.device)[:, None] * per_tile + seg  # its (b, h) list
    valid = (seg < per_tile) & (lst < lists)                 # [tiles, rows]
    key_real = valid & mask[torch.clamp(lst, max=lists - 1) // H,
                            torch.arange(rows, device=mask.device) % N]
    same = (seg[:, None] == seg[None, :]) & valid[:, :, None] & valid[:, None, :]
    return pack, unpack, same, same & key_real[:, None, :]


def attention_forward_packed_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   mask: torch.Tensor):
    """attention_forward_plain's (out, row_max, row_sum) for lists of N <= 256
    docs, in the tiles of the packed forward kernels (64 // N lists a 64-row
    tile up to 64 docs, one list a 128-row tile up to 128) and of the long
    forward kernels (one list a 256-row tile above): `_packing`. All of a
    row's keys lie in its tile; in bf16 the softmax takes them in halves of
    at most 128 keys (one up to 128 docs, two above), in fp32 all at once
    (the fp32 kernels take one max over the row's keys), online from
    m = -1e30, l = 0, O = 0:

        x = q k^T * scale (a masked key of the row's list: the constant -1e9;
        a key of another list: left out, p = 0), m' = max(m, max x over the
        half), p = exp(x - m'), l' = l exp(m - m') + sum p,
        O' = O exp(m - m') + (p rounded to the inputs' dtype) v,

    with fp32 logits, p, l and accumulation and one rounding at the output
    O / l. Up to 64 docs that is attention_forward_plain's one 64-key tile;
    above, attention_forward_plain rescales between 64-key tiles, so its p
    is rounded against each tile's running max, the kernels' against each
    half's (up to 128 docs, and in fp32: the row's). A list with no real key
    gets m = -1e9, l = N and the mean of v."""
    B, H, N, d = q.shape
    rows = _tile_rows(N)
    pack, unpack, same, real = _packing(mask, H, N, rows)
    scale = 1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32, device=q.device))
    qf, kf, vf = pack(q), pack(k), pack(v)
    x = torch.where(real, torch.matmul(qf, kf.transpose(-1, -2)) * scale,
                    torch.where(same, _NEG, float("-inf")))
    m = torch.full(x.shape[:-1], -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    out = torch.zeros_like(qf)
    part = rows if q.dtype == torch.float32 else _LONG_HALF
    for s in range(0, rows, part):
        xs = x[..., s:s + part]
        m_new = torch.maximum(m, xs.amax(dim=-1))  # -1e30 on an empty row: every p is 0
        alpha = torch.exp(m - m_new)
        p = torch.exp(xs - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        out = out * alpha[..., None] + torch.matmul(p.to(v.dtype).float(), vf[:, s:s + part])
        m = m_new
    out = out * (1.0 / l)[..., None]
    stats = (unpack(t[..., None], torch.float32)[..., 0] for t in (m, l))
    return (unpack(out, q.dtype), *stats)


def attention_backward_packed_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                    dout: torch.Tensor, out: torch.Tensor,
                                    row_max: torch.Tensor, row_sum: torch.Tensor,
                                    mask: torch.Tensor):
    """attention_backward_plain's (dq, dk, dv) for lists of N <= 256 docs, in
    the tiles of the packed kernel (64 // N lists a 64-row tile, N <= 64), of
    the list kernel (one list a 128-row tile, 64 < N <= 128) and of the long
    kernel (one list a 256-row tile, 128 < N <= 256): `_packing`. Within a
    tile, a key of another list is left out (P = dS = 0), a masked key of
    the row's own list gets the logit -1e9 and dS = 0; then
    attention_backward_plain's formulas and rounding points on the tile, and
    the empty rows dropped. (The long kernel sums dq over its two halves of
    keys in fp32 before the one rounding: a summation order, not a rounding
    point.)"""
    B, H, N, d = q.shape
    pack, unpack, same, real = _packing(mask, H, N, _tile_rows(N))
    scale = 1.0 / float(d) ** 0.5
    qf, kf, vf, dof = (pack(t) for t in (q, k, v, dout))
    m, l = pack(row_max)[..., 0], pack(row_sum, fill=1.0)[..., 0]
    dsum = pack(torch.sum(dout.float() * out.float(), dim=-1))[..., 0]
    x = torch.where(real, torch.matmul(qf, kf.transpose(-1, -2)) * scale, _NEG)
    p = torch.where(same, torch.exp(x - m[..., None]) / l[..., None], 0.0)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = torch.where(real, p * (dp - dsum[..., None]), 0.0)
    p, ds = (t.to(q.dtype).float() for t in (p, ds))
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dq = torch.matmul(ds, kf) * scale
    return unpack(dq, q.dtype), unpack(dk, q.dtype), unpack(dv, q.dtype)


_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_LIB = cuda_build.KernelLib("flash_attn_fwd",
                                {"flash_attn_fwd": [_P] * 7 + [_I] * 5 + [_P],
                                 "flash_attn_fwd_packed": [_P] * 7 + [_I] * 5 + [_P],
                                 "flash_attn_fwd_long": [_P] * 7 + [_I] * 5 + [_P]})
_BWD_LIB = cuda_build.KernelLib("flash_attn_bwd",
                                {"flash_attn_bwd_dkdv": [_P] * 10 + [_I] * 5 + [_P],
                                 "flash_attn_bwd_dq": [_P] * 9 + [_I] * 5 + [_P],
                                 "flash_attn_bwd_packed": [_P] * 11 + [_I] * 5 + [_P],
                                 "flash_attn_bwd_list": [_P] * 11 + [_I] * 5 + [_P],
                                 "flash_attn_bwd_long": [_P] * 12 + [_I] * 5 + [_P]})
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# the kernels' row tile (query rows or keys a block owns), the widest head dim
# of the kernels that keep a whole row per block, and the narrowest output
# chunk of the bf16 wide kernels above it (csrc/flash_attn_{fwd,bwd}.cu: 64
# columns for dk/dv, 128 for the forward and dq; the fp32 wide kernels' block
# owns every output column)
_ROWS, _NARROW_D, _WIDE_COLUMNS = 64, 128, 64
# the tile of one list of up to 128 docs: the packed forward's keys
# (LIST_KEYS) and the list backward's rows (LIST_ROWS); of one list of up to
# 256 docs, the long kernels' (LONG_KEYS, LONG_ROWS), whose keys go in two
# halves (LONG_HALF)
_LIST_ROWS = 128
_LONG_ROWS, _LONG_HALF = 256, 128
# query rows a block of the fp32 list forward owns on the 256-row tile
# (F32_LONG_OWN in csrc/flash_attn_fwd.cu; on the 128-row tile 64, as the
# bf16 forward's blocks)
_F32_LONG_OWN = 128
_MAX_X, _MAX_Y = 2 ** 31 - 1, 65535  # blocks on grid.x and on grid.y

# Routes of the bf16 kernels at d > 128, each the widest bucket at which the
# kernel beat the wide kernels it replaces at both d = 350 and d = 384 on an
# NVIDIA H100 (PERF.md): the packed forward (S once a tile of 64 // N lists,
# or of one list of up to 128 docs) up to FWD_PACK_MAX_N docs; the packed
# backward (one launch for dq, dk and dv, 64 // N lists a 64-row tile) up to
# PACK_MAX_N docs, and the list backward (the same on a 128-row tile of one
# list) up to LIST_MAX_N, in place of the wide dk/dv and dq pair; the long
# forward and backward (one list of up to 256 docs a block, its keys in two
# halves of 128) up to LONG_MAX_N.
FWD_PACK_MAX_N = 128
PACK_MAX_N = 64
LIST_MAX_N = 128
LONG_MAX_N = 256
# The fp32 routes at d > 128, set the same way: the packed forward and the
# packed backward on 3xTF32 tensor-core products (csrc/flash_attn_{fwd,bwd}.cu:
# flash_{fwd,bwd}_packed_tf32_kernel, 64 // N lists a 64-row tile) up to
# F32_PACK_MAX_N docs, in place of the fp32 wide forward and wide pair; the
# fp32 list and long backward (flash_bwd_list_tf32_kernel on a 128-row and a
# 256-row tile of one list, its keys in slices of 64) up to F32_LIST_MAX_N
# and F32_LONG_MAX_N docs, in place of the wide pair; the fp32 list forward
# (flash_fwd_list_tf32_kernel on a 128-row and a 256-row tile of one list,
# through the packed and the long forward's wrappers) up to
# F32_FWD_LIST_MAX_N and F32_FWD_LONG_MAX_N docs, in place of the wide
# forward: at 128 and 256 docs and d = 350 / 384, 0.32 / 0.32 and 0.69 /
# 0.64 ms against the CUDA-core wide forward's 2.02 / 2.04 and 3.89 / 3.90
# on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py's check_packed_fwd,
# PERF.md). Above these limits the fp32 wide kernels (3xTF32, a block's 64
# rows and all of their columns) take every list: 0.944 ms forward and
# 1.96 + 1.48 ms backward at (32, 1, 1408, 136), the one-head MSLR-WEB30K
# listsf, against the CUDA-core wide kernels' 4.46 and 14.36 + 7.24 and
# SDPA's fp32 1.31 and 3.91 on the same card (tools/kernel_variants.py).
F32_PACK_MAX_N = 64
F32_LIST_MAX_N = 128
F32_LONG_MAX_N = 256
F32_FWD_LIST_MAX_N = 128
F32_FWD_LONG_MAX_N = 256
# The fp32 backward at d <= 128 needs no limit: the dk/dv and dq wrappers
# launch the 3xTF32 kernels (csrc/flash_attn_bwd.cu's
# flash_bwd_{dkdv,dq}_tf32_kernel) at every N, in place of a CUDA-core pair
# they beat at every timed shape: 2.60 against 9.17 ms at (32, 2, 1408, 68),
# 0.37 against 0.86 at (1, 2, 1536, 68) and 0.18 against 0.70 at
# (1024, 2, 32, 68) on an NVIDIA H100 80GB HBM3 at 700 W
# (tools/kernel_variants.py --parent, PERF.md). Nor does the fp32 forward
# there (csrc/flash_attn_fwd.cu's flash_fwd_tf32_kernel, 3xTF32): 0.89
# against the CUDA-core kernel's 1.54 ms, 0.115 against 0.25 and 0.051
# against 0.12 at the same shapes.


def fwd_route(dtype: torch.dtype, N: int, d: int) -> str:
    """The forward's kernel for inputs of `dtype` with N docs a list and head
    dim d: for bf16 and d > 128, "packed" (FlashAttnFwdPacked) at
    N <= FWD_PACK_MAX_N and "long" (FlashAttnFwdLong) at N <= LONG_MAX_N;
    for fp32 and d > 128, "packed" at N <= F32_FWD_LIST_MAX_N (the fp32
    packed kernel up to 64 docs, the fp32 list kernel above) and "long" at
    N <= F32_FWD_LONG_MAX_N; else "flash" (FlashAttnFwd)."""
    limits = {torch.bfloat16: (FWD_PACK_MAX_N, LONG_MAX_N),
              torch.float32: (F32_FWD_LIST_MAX_N, F32_FWD_LONG_MAX_N)}
    if dtype in limits and d > _NARROW_D:
        for route, max_n in zip(("packed", "long"), limits[dtype]):
            if N <= max_n:
                return route
    return "flash"


def bwd_route(dtype: torch.dtype, N: int, d: int) -> str:
    """The backward's kernels for inputs of `dtype` with N docs a list and
    head dim d: for bf16 and d > 128, "packed" (FlashAttnBwdPacked) at
    N <= PACK_MAX_N, "list" (FlashAttnBwdList) at N <= LIST_MAX_N and "long"
    (FlashAttnBwdLong) at N <= LONG_MAX_N; for fp32 and d > 128, "packed" at
    N <= F32_PACK_MAX_N, "list" at N <= F32_LIST_MAX_N and "long" at
    N <= F32_LONG_MAX_N; else "pair" (FlashAttnBwdDkdv and FlashAttnBwdDq)."""
    limits = {torch.bfloat16: (PACK_MAX_N, LIST_MAX_N, LONG_MAX_N),
              torch.float32: (F32_PACK_MAX_N, F32_LIST_MAX_N, F32_LONG_MAX_N)}
    if dtype in limits and d > _NARROW_D:
        for route, max_n in zip(("packed", "list", "long"), limits[dtype]):
            if N <= max_n:
                return route
    return "pair"


def packed_blocks(B: int, H: int, N: int, rows: int = _ROWS) -> int:
    """Blocks of a packed backward's grid (grid.x): one per tile of rows // N
    lists (the packed kernel: 64 rows; the list kernel: 128; the long
    kernel: 256)."""
    return -(-B * H // (rows // N))


def fwd_packed_blocks(B: int, H: int, N: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Blocks of the packed or long forward's grid (grid.x): its key tile
    holds 64 // N lists up to 64 docs, one list of up to 128 up to 128 docs,
    one of up to 256 (the long kernel) above, and a block owns 64 of the
    tile's query rows; in fp32 on the 256-row tile (the fp32 list kernel)
    128."""
    rows = _tile_rows(N)
    own = _F32_LONG_OWN if dtype == torch.float32 and rows == _LONG_ROWS else _ROWS
    return packed_blocks(B, H, N, rows) * (rows // own)


def kernel_launches(B: int, H: int, N: int, d: int, packed: bool = False) -> int:
    """Kernel launches of one wrapper call. The kernels of d <= 128 take b*h
    from grid.y (at most 65535 blocks), so a batch of more than 65535 // H
    lists runs in launches of whole lists; the wide kernels (d > 128, either
    dtype) fold every axis into grid.x, and the kernels that pack whole
    lists into a block (`packed`) put their tiles there: one launch."""
    return 1 if packed or d > _NARROW_D else -(-B // (_MAX_Y // H))


# the kernels that take whole lists into a block, by wrapper: the longest
# list each takes, in either dtype (fp32 on 3xTF32: above 64 docs the
# packed forward's wrapper launches the fp32 list kernel)
_PACKED_MAX_N = {"flash_attn_fwd_packed": _LIST_ROWS, "flash_attn_bwd_packed": _ROWS,
                 "flash_attn_bwd_list": _LIST_ROWS, "flash_attn_fwd_long": _LONG_ROWS,
                 "flash_attn_bwd_long": _LONG_ROWS}


def check_grid(B: int, H: int, N: int, d: int, packed: str = "",
               dtype: torch.dtype = torch.bfloat16) -> None:
    """The shapes the kernels take: any positive B, H, N and d whose launches
    fit the grid. For d <= 128, H up to 65535 (grid.y); for d > 128, the
    64-row tiles x B*H up to 2^31 - 1 blocks (grid.x), times the output
    chunks in bf16 (64 columns at the finest; the fp32 wide kernels' block
    owns every output column). A kernel that takes whole lists into a block
    (`packed`, its wrapper's name: "flash_attn_fwd_packed",
    "flash_attn_bwd_packed", "flash_attn_bwd_list", "flash_attn_fwd_long",
    "flash_attn_bwd_long"): N up to 64 (the packed backward), 128 or 256
    (the long kernels), B*H up to 2^31 - 1 lists, and its tiles on grid.x
    (the forward's blocks for inputs of `dtype`: fwd_packed_blocks).
    Raises otherwise."""
    if min(B, H, N, d) < 1:
        raise ValueError(f"unsupported shape {(B, H, N, d)}")
    if packed:
        max_n = _PACKED_MAX_N[packed]
        if N > max_n or B * H > _MAX_X:
            raise ValueError(f"shape {(B, H, N, d)}: {packed} takes lists of at most "
                             f"{max_n} docs, at most {_MAX_X} of them")
        blocks = fwd_packed_blocks(B, H, N, dtype) if packed.startswith("flash_attn_fwd") else 0
        if blocks > _MAX_X:
            raise ValueError(f"shape {(B, H, N, d)} needs {blocks} blocks of {packed} on "
                             f"grid.x, past the card's {_MAX_X}")
        return
    if d <= _NARROW_D and H > _MAX_Y:
        raise ValueError(f"shape {(B, H, N, d)} needs {H} blocks on grid.y, past the "
                         f"card's {_MAX_Y}")
    chunks = -(-d // _WIDE_COLUMNS) if dtype == torch.bfloat16 else 1
    blocks = -(-N // _ROWS) * B * H * chunks
    if d > _NARROW_D and blocks > _MAX_X:
        raise ValueError(f"shape {(B, H, N, d)} needs {blocks} blocks on grid.x, past the "
                         f"card's {_MAX_X}")


def _check_qkv(q, k, v, mask, *more, packed=""):
    """Shapes, dtypes, device and contiguity the kernels take (`packed`: the
    name of a packing kernel's wrapper, as check_grid takes it); raises
    otherwise. `more` are further [B, H, N, d] tensors of q's dtype (the
    output gradient)."""
    if q.dim() != 4 or any(t.shape != q.shape for t in (k, v, *more)):
        raise ValueError(f"q, k, v must share one [B, H, N, d] shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, N, d = q.shape
    if mask.shape != (B, N) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be bool [B, N] = {(B, N)}; got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in (k, v, *more)):
        raise ValueError(f"q, k, v must all be float32 or bfloat16; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    check_grid(B, H, N, d, packed, q.dtype)
    tensors = (q, k, v, mask, *more)
    if any(not t.is_cuda or t.device != q.device for t in tensors):
        raise ValueError("q, k, v and mask must be CUDA tensors on one device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("q, k, v and mask must be contiguous")
    return B, H, N, d


def _check_stats(q, *stats):
    B, H, N, _ = q.shape
    for t in stats:
        if (t.shape != (B, H, N) or t.dtype != torch.float32 or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"row statistics must be contiguous float32 [B, H, N] = "
                             f"{(B, H, N)} on q's device; got {t.dtype} {tuple(t.shape)}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


class FlashAttnFwd:
    """ctypes wrapper of `csrc/flash_attn_fwd.cu` with its launch count.

    `launches` grows by one at each kernel launch and nowhere else (one a
    call, or kernel_launches(...) for a batch past grid.y), so a run can show
    that its attention went through the kernel. With `stats=True`
    it also returns each query row's softmax max m and sum l ([B, H, N]
    fp32), which the backward kernels read."""

    name = "flash_attn_fwd"
    packed = ""  # the packing kernel's name, as check_grid takes it

    def __init__(self):
        self.launches = 0

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: torch.Tensor, stats: bool = False):
        B, H, N, d = _check_qkv(q, k, v, mask, packed=self.packed)
        out = torch.empty_like(q)
        row_max = row_sum = None
        if stats:
            row_max = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
            row_sum = torch.empty_like(row_max)
        with torch.cuda.device(q.device):
            _FWD_LIB.call(
                self.name, q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                out.data_ptr(), None if row_max is None else row_max.data_ptr(),
                None if row_sum is None else row_sum.data_ptr(),
                B, H, N, d, _DTYPES[q.dtype], _stream(q.device))
        self.launches += kernel_launches(B, H, N, d, packed=bool(self.packed))
        return (out, row_max, row_sum) if stats else out


class FlashAttnFwdPacked(FlashAttnFwd):
    """ctypes wrapper of `csrc/flash_attn_fwd.cu`'s packed kernels (lists of
    at most 128 docs, any d; bf16: S once a tile of 64 // N lists, or of one
    list above 64 docs; fp32: the same on 3xTF32 tensor-core products up to
    64 docs, the fp32 list kernel, one list a 128-row tile, S once in slices
    of 64 keys, above), FlashAttnFwd's call and statistics, with its own
    launch count (one a call, either dtype)."""

    name = packed = "flash_attn_fwd_packed"


class FlashAttnFwdLong(FlashAttnFwd):
    """ctypes wrapper of `csrc/flash_attn_fwd.cu`'s long kernels (lists of at
    most 256 docs, any d, S once a 256-key tile of one list of 129 .. 256
    docs; bf16: in two halves of 128 keys; fp32: the fp32 list kernel on a
    256-row tile, in slices of 64 keys, 3xTF32), FlashAttnFwd's call and
    statistics, with its own launch count (one a call, either dtype)."""

    name = packed = "flash_attn_fwd_long"


class FlashAttnBwdDkdv:
    """ctypes wrapper of the dk, dv kernels of `csrc/flash_attn_bwd.cu` (bf16:
    tensor cores; fp32: 3xTF32 on the tensor cores at every head dim, above
    128 the wide kernel, a block's keys and all of their columns), with its
    launch count. `dsum` is D = rowsum(dO * O), [B, H, N] fp32."""

    name = "flash_attn_bwd_dkdv"

    def __init__(self):
        self.launches = 0

    def __call__(self, q, k, v, dout, row_max, row_sum, dsum, mask):
        B, H, N, d = _check_qkv(q, k, v, mask, dout)
        _check_stats(q, row_max, row_sum, dsum)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        with torch.cuda.device(q.device):
            _BWD_LIB.call(
                self.name, q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                row_max.data_ptr(), row_sum.data_ptr(), dsum.data_ptr(), mask.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), B, H, N, d, _DTYPES[q.dtype], _stream(q.device))
        self.launches += kernel_launches(B, H, N, d)
        return dk, dv


class FlashAttnBwdDq:
    """ctypes wrapper of the dq kernels of `csrc/flash_attn_bwd.cu` (bf16:
    tensor cores; fp32: 3xTF32 on the tensor cores at every head dim, above
    128 the wide kernel), with its launch count."""

    name = "flash_attn_bwd_dq"

    def __init__(self):
        self.launches = 0

    def __call__(self, q, k, v, dout, row_max, row_sum, dsum, mask):
        B, H, N, d = _check_qkv(q, k, v, mask, dout)
        _check_stats(q, row_max, row_sum, dsum)
        dq = torch.empty_like(q)
        with torch.cuda.device(q.device):
            _BWD_LIB.call(
                self.name, q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                row_max.data_ptr(), row_sum.data_ptr(), dsum.data_ptr(), mask.data_ptr(),
                dq.data_ptr(), B, H, N, d, _DTYPES[q.dtype], _stream(q.device))
        self.launches += kernel_launches(B, H, N, d)
        return dq


class FlashAttnBwdPacked:
    """ctypes wrapper of `csrc/flash_attn_bwd.cu`'s packed kernels (bf16 or
    fp32 on 3xTF32 tensor-core products, lists of at most 64 docs, any d):
    dq, dk and dv in one launch, with its launch count (either dtype).
    `dsum` is D = rowsum(dO * O), [B, H, N] fp32."""

    name = "flash_attn_bwd_packed"

    def __init__(self):
        self.launches = 0

    def __call__(self, q, k, v, dout, row_max, row_sum, dsum, mask):
        B, H, N, d = _check_qkv(q, k, v, mask, dout, packed=self.name)
        _check_stats(q, row_max, row_sum, dsum)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        scratch = self._scratch(q)
        with torch.cuda.device(q.device):
            _BWD_LIB.call(
                self.name, q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                row_max.data_ptr(), row_sum.data_ptr(), dsum.data_ptr(), mask.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                *(None if t is None else t.data_ptr() for t in scratch),
                B, H, N, d, _DTYPES[q.dtype], _stream(q.device))
        self.launches += kernel_launches(B, H, N, d, packed=True)
        return dq, dk, dv

    def _scratch(self, q) -> tuple:
        """Device scratch the kernel takes after its outputs (None: a null
        pointer in its place): none."""
        return ()


class FlashAttnBwdList(FlashAttnBwdPacked):
    """ctypes wrapper of `csrc/flash_attn_bwd.cu`'s list kernels (lists of at
    most 128 docs, any d, one list of 65 .. 128 docs a block; bf16: the
    packed kernel on a 128-row tile; fp32: flash_bwd_list_tf32_kernel on
    3xTF32 tensor-core products, its keys in slices of 64):
    FlashAttnBwdPacked's call, with its own launch count (one a call, either
    dtype)."""

    name = "flash_attn_bwd_list"


class FlashAttnBwdLong(FlashAttnBwdPacked):
    """ctypes wrapper of `csrc/flash_attn_bwd.cu`'s long kernels (lists of at
    most 256 docs, any d, one list of 129 .. 256 docs a block; bf16: its keys
    in two halves of 128; fp32: flash_bwd_list_tf32_kernel on a 256-row tile,
    its keys in slices of 64, 3xTF32): FlashAttnBwdPacked's call, with its
    own launch count (one a call, either dtype), and in bf16 the fp32
    [B*H*N, d] scratch in which the kernel keeps the first half's share of dq
    until the second half adds its own (fp32 sums dq in dq itself: no
    scratch)."""

    name = "flash_attn_bwd_long"

    def _scratch(self, q) -> tuple:
        if q.dtype == torch.float32:
            return (None,)
        B, H, N, d = q.shape
        return (torch.empty((B * H * N, d), dtype=torch.float32, device=q.device),)


FLASH_ATTN_FWD = FlashAttnFwd()
FLASH_ATTN_FWD_PACKED = FlashAttnFwdPacked()
FLASH_ATTN_FWD_LONG = FlashAttnFwdLong()
FLASH_ATTN_BWD_DKDV = FlashAttnBwdDkdv()
FLASH_ATTN_BWD_DQ = FlashAttnBwdDq()
FLASH_ATTN_BWD_PACKED = FlashAttnBwdPacked()
FLASH_ATTN_BWD_LIST = FlashAttnBwdList()
FLASH_ATTN_BWD_LONG = FlashAttnBwdLong()


def _forward_kernel(q: torch.Tensor) -> FlashAttnFwd:
    """The forward's wrapper for q's dtype and shape, by fwd_route."""
    route = fwd_route(q.dtype, q.shape[2], q.shape[3])
    return {"packed": FLASH_ATTN_FWD_PACKED, "long": FLASH_ATTN_FWD_LONG}.get(route,
                                                                             FLASH_ATTN_FWD)


class _FlashAttention(torch.autograd.Function):
    """The kernels' forward and backward on CUDA tensors; the forward's
    kernel by fwd_route, the backward's by bwd_route. D = rowsum(dO * O) is
    plain torch, as the JAX library computes it outside its kernels."""

    @staticmethod
    def forward(ctx, q, k, v, mask):
        q, k, v, mask = (t.contiguous() for t in (q, k, v, mask))
        out, row_max, row_sum = _forward_kernel(q)(q, k, v, mask, stats=True)
        ctx.save_for_backward(q, k, v, mask, out, row_max, row_sum)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mask, out, row_max, row_sum = ctx.saved_tensors
        dout = dout.contiguous()
        dsum = torch.sum(dout.float() * out.float(), dim=-1)
        args = (q, k, v, dout, row_max, row_sum, dsum, mask)
        route = bwd_route(q.dtype, q.shape[2], q.shape[3])
        if route == "packed":
            dq, dk, dv = FLASH_ATTN_BWD_PACKED(*args)
        elif route == "list":
            dq, dk, dv = FLASH_ATTN_BWD_LIST(*args)
        elif route == "long":
            dq, dk, dv = FLASH_ATTN_BWD_LONG(*args)
        else:
            dk, dv = FLASH_ATTN_BWD_DKDV(*args)
            dq = FLASH_ATTN_BWD_DQ(*args)
        return dq, dk, dv, None


@torch.library.custom_op("ptranking_tpu_torch::flash_attn_fwd", mutates_args=())
def flash_attn_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """The no-grad forward on CUDA tensors as a registered op, so that
    `torch.export` can trace it (it cannot trace a ctypes call on
    `data_ptr()`) and an exported scorer replays it (export.py). Its body is
    the forward's wrapper by fwd_route, which counts its launches; on other
    tensors the wrapper raises."""
    return _forward_kernel(q)(q.contiguous(), k.contiguous(), v.contiguous(),
                              mask.contiguous())


@flash_attn_fwd_op.register_fake
def _flash_attn_fwd_fake(q, k, v, mask):
    return torch.empty_like(q)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Masked non-causal attention, `sm_scale = 1/sqrt(d)`, no dropout.

    CUDA tensors go through the hand-written kernels (a failed build or
    launch raises; there is no fallback): the forward alone (by fwd_route)
    when no gradient is needed (under `inference_mode` or `no_grad`, or for
    inputs that do not require one), else forward and backward. CPU tensors
    go through `blockwise_attention(block_size=min(128, N))`, and autograd
    through it."""
    if q.is_cuda:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            return _FlashAttention.apply(q, k, v, mask)
        return flash_attn_fwd_op(q, k, v, mask)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on CUDA or the CPU, not {q.device}")
    return blockwise_attention(q, k, v, mask, block_size=min(128, max(q.shape[2], 1)))
