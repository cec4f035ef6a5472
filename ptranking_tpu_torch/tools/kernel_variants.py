"""Time design variants of the hand-written kernels on one CUDA card.

    python3 -m ptranking_tpu_torch.tools.kernel_variants [--parent DIR] [--cases REGEX]
        [library[:variant,...] ...]

For each library named (by default all of those in VARIANTS: the bf16
flash-attention backward and forward, the Sinkhorn half-step and the pairwise
lambda loss; `library:a,b` takes the shipped source and variants a and b
only), builds the
shipped `ops/csrc/<library>.cu` and copies of it with one knob turned or one
phase cut out (text substitutions, each asserted to match), and for the
backward the warpgroup experiment `ops/csrc/experiments/flash_attn_bwd_wgmma.cu`,
all with nvcc started together. Then it times each variant's kernels, once in
the listed order and once in reverse: the backward's dk/dv and dq at the
training shape (32, 2, 1408, 68) bf16 and at the Yahoo! LTR listsf's
WIDE_SHAPES (the wide kernels: d = 350 and 384 in the buckets of 16 to 256
docs), and in fp32 (3xTF32) at F32_PAIR_SHAPES (for "parent": the parent's
fp32 dk/dv and dq kernels there), the packed backward (dq, dk, dv in one launch) at the WIDE_SHAPES of
at most 64 docs and at PACK_COPY_SHAPES, the list backward (the same on a
128-row tile of one list) at the WIDE_SHAPES of 128 docs and at
LIST_COPY_SHAPES, and the long backward (one list of 129..256 docs a block,
its keys in two halves) at the WIDE_SHAPES of 256 docs and at
LONG_COPY_SHAPES; the forward with row statistics at those shapes and at the
one-list serving shape (1, 2, 1536, 68), and in fp32 (3xTF32) at
F32_FWD_SHAPES (for "parent": the parent's fp32 forward there), the packed forward at the
WIDE_SHAPES of at most 128 docs (at 128 docs its tile of one list and all of
its 128 keys) and at PACK_COPY_SHAPES, and the long forward at the
WIDE_SHAPES of 256 docs and at LONG_COPY_SHAPES; the fp32 packed forward
and backward (3xTF32) at the WIDE_SHAPES of at most 64 docs in fp32, the
fp32 list and long backward (3xTF32) at those of 128 and 256 docs in fp32
(for "parent", the parent's route there: its fp32 wide dk/dv and dq pair),
the fp32 list forward (3xTF32, through the packed and the long entries) at
those of 128 and 256 docs and at LIST_COPY_SHAPES and LONG_COPY_SHAPES in
fp32 (for "parent", the parent's route there: its fp32 wide forward); the
fp32 wide forward and dk/dv and dq kernels (3xTF32, every fp32 list past 256
docs at d > 128) at F32_WIDE_SHAPES, through the same entries as the
parent's CUDA-core wide kernels, which "parent" times there; the
half-step over rows and over columns at 32 x 1408 x
1408 fp32; the pairwise loss forward (with the partials' sum) and backward
at 32 x 1408. It prints one JSON line per
variant: registers and spill bytes of the kernels in question, the two times
of each case in ms (CUDA events, the median of three blocks of calls), and
whether the outputs equal the shipped kernels' bit for bit, with the largest
difference (a design variant may round otherwise; a variant with a phase cut
out cannot agree, it shows what the phase costs).

`--cases REGEX` keeps the cases whose names match (for example
`--cases "wide fp32"`: the fp32 wide kernels alone, which a run under a
time limit may need). Where "parent" is timed, a line "torch_sdpa" times
SDPA in fp32 (TF32 off, the masked keys' bias -1e9) at F32_WIDE_SHAPES: its
forward and its backward alone from a kept graph, the yardstick of one
PyTorch call.

`--parent DIR` adds, for the two attention libraries, the variant "parent"
(named among the variants where `library:v1,...` names them):
the sources of the checkout at DIR (for example a parent commit unpacked by
`git archive`), run on the same cases (the backward's fp32 list and long
cases through its wide pair, the forward's through its wide forward; the
forward's fp32 packed cases not: a checkout from before the fp32 packed
kernels refuses them), so that
"max_abs_diff_vs_shipped" says, case by case, whether this tree's kernels
give the parent's bits, and the fp32 list and long cases time the parent's
route beside the new kernels.
"""

from __future__ import annotations

import ctypes
import functools
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from ptranking_tpu_torch.ops import attention, cuda_build

ITERS = 20
ATTN_SHAPE = (32, 2, 1408, 68)
# the Yahoo! LTR listsf's attention through the wide kernels: 2 heads of 350
# (or 384 under lane_align), 32,768 docs in the buckets of 16 to 256 docs
# (chip_smoke.py's phase 7 says why these buckets)
WIDE_SHAPES = [(2048, 2, 16, 350), (1024, 2, 32, 350), (512, 2, 64, 350), (256, 2, 128, 350),
               (128, 2, 256, 350),
               (2048, 2, 16, 384), (1024, 2, 32, 384), (512, 2, 64, 384), (256, 2, 128, 384),
               (128, 2, 256, 384)]
# The packed backward's copy width: d = 352 does d = 350's work (the same six
# 64-column d-chunks and output chunks) with 16-byte copies of its 704-byte
# rows where d = 350's 700-byte rows take 4-byte ones, so the difference is
# the most that any wider staging of d = 350's contiguous tiles could gain.
PACK_COPY_SHAPES = [(2048, 2, 16, 352), (1024, 2, 32, 352)]
LIST_COPY_SHAPES = [(256, 2, 128, 352)]
LONG_COPY_SHAPES = [(128, 2, 256, 352)]
FWD_SHAPES = [ATTN_SHAPE, (1, 2, 1536, 68), *WIDE_SHAPES]
BWD_SHAPES = [ATTN_SHAPE, *WIDE_SHAPES]
# the fp32 dk/dv and dq kernels at d <= 128: the flagship's training batch
# and one list of the serving path's top bucket
F32_PAIR_SHAPES = [ATTN_SHAPE, (1, 2, 1536, 68)]
# the fp32 forward at d <= 128: those and short lists (1024 of 32 docs)
F32_FWD_SHAPES = [*F32_PAIR_SHAPES, (1024, 2, 32, 68)]
# the fp32 wide kernels (d > 128, lists past 256 docs): the one-head
# MSLR-WEB30K listsf (d = 136) in its buckets of 512 and 1024 docs, at the
# long-list point (32 x 1408) and one served list of the top bucket; the
# Yahoo! widths (350, 384 under lane_align) at 512 docs
F32_WIDE_SHAPES = [(64, 1, 512, 136), (32, 1, 1024, 136), (32, 1, 1408, 136), (1, 1, 1536, 136),
                   (16, 2, 512, 350), (16, 2, 512, 384)]
SINK_SHAPE = (32, 1408)
PAIR_SHAPE = (32, 1408)
EXPERIMENT = cuda_build.CSRC / "experiments" / "flash_attn_bwd_wgmma.cu"
# the long backward with the other ownership (query rows in two passes, dk
# and dv summed from two partials): a source of its own, timed on the long
# shapes alone
LONG_ROWS_EXPERIMENT = cuda_build.CSRC / "experiments" / "flash_attn_bwd_long_rows.cu"

_BLOCKS = "return kc <= 5 ? 3 : 2;"
_MORE = "const bool more = t + 1 < tiles;"
_WARPS = "constexpr int MMA_WARPS = 4;"
_CUT_COPIES = [(_MORE, _MORE.replace(";", " && N < 0;"))]

# The wide kernels' chunk copies (mma_common.cuh's load_chunk_async) not
# unrolled or fully unrolled instead of by 4: the variant's source carries the
# header's text in place of its #include.
_HEADER_INCLUDE = '#include "mma_common.cuh"'
_COPY_LOOP = "#pragma unroll 4\n    for (int i = 0; i < COPIES; ++i) {"


def _header_with(pragma: str) -> str:
    text = (cuda_build.CSRC / "mma_common.cuh").read_text()
    if _COPY_LOOP not in text:
        raise RuntimeError(f"{_COPY_LOOP!r} is not in mma_common.cuh")
    return text.replace(_COPY_LOOP, _COPY_LOOP.replace("#pragma unroll 4", pragma))


_UNROLL_COPIES = {"copies_not_unrolled": [(_HEADER_INCLUDE, _header_with("#pragma unroll 1"))],
                  "copies_unrolled": [(_HEADER_INCLUDE, _header_with("#pragma unroll"))]}

# The backward: warps a block (rows a block owns = 16 x warps) with the blocks
# an SM the register budget is cut for, and the columns of S / dP held at a
# time; then no copies of the next tile (both kernels), half of them, all of
# them from one cache-hot tile; in the dk/dv kernel no softmax arithmetic, no
# second products; and the warpgroup experiment, a source of its own.
_BWD_SUB = "constexpr int SUB = 32;"
_PACK_KEEP = "constexpr bool PACK_KEEP = true;"
_PACK_STAGED = "constexpr bool PACK_STAGED = false;"
_PACK_CW = "constexpr int PACK_CW = 4;"
_LIST_HALVES = "constexpr bool LIST_HALVES = false;"
_LONG_SUM = "constexpr int LONG_SUM = 0;"
# the fp32 packed kernels (both libraries): 64-column d-chunks and output
# chunks instead of 32 (the backward: one block an SM instead of two)
_TF32_W = "constexpr int TF32_W = 32;"
_TF32_VARIANTS = {"tf32_w64": [(_TF32_W, _TF32_W.replace("= 32", "= 64"))]}
# the fp32 list and long backward: 16-column d-chunks and output chunks
# instead of 32; the hi/lo split rounded by cvt.rna.tf32.f32 instead of
# integer arithmetic; then, to show what they cost, every slice and pass
# reading the list's first rows (the same instructions, cache-hot data), and
# no partial sums of dq, dk and dv loaded back (each slice's and pass's own
# sum stored alone)
_F32_W = "constexpr int F32_W = 32;"
_F32_INT_ROUND = "constexpr bool F32_INT_ROUND = true;"
_F32_FWD_BOUNDS = "__launch_bounds__(2 * f32_own(ROWS), 1)\nflash_fwd_list_tf32_kernel"
_F32N_WARPS = "constexpr int F32N_WARPS = 4;"
_F32N_TILE = "constexpr int F32N_TILE = 32;"
_F32N_SPLIT = "constexpr int F32N_SPLIT = SPLIT_INT_CUT;"
_F32N_GROUP = "constexpr int F32N_GROUP = 4;"
_F32N_BLOCKS = "constexpr int F32N_BLOCKS = 8 / F32N_WARPS;"
_F32N_QREG = "constexpr int F32N_QREG_NC = 9;"
_F32N_FWD_TILE = "constexpr int F32N_TILE = 32;              // keys a tile"
_F32W_CW = "constexpr int F32W_CW = 32;"
_F32W_DQ_BOUNDS = "__launch_bounds__(F32W_NT, F32W_BLOCKS)\nflash_bwd_dq_wide_tf32_kernel"
_F32W_BLOCKS_FWD = "constexpr int F32W_BLOCKS = 3;"
_F32N_FWD_BLOCKS = "constexpr int F32N_BLOCKS = 2;\n// how the operands are split"
_BWD_NO_SOFTMAX = [
    ("const float x0 = real ? s[j][2 * h] * scale : MASKED_LOGIT;", "const float x0 = s[j][2 * h];"),
    ("const float x1 = real ? s[j][2 * h + 1] * scale : MASKED_LOGIT;",
     "const float x1 = s[j][2 * h + 1];"),
    ("const float p0 = in ? __expf(x0 - m2.x) * inv2.x : 0.f;", "const float p0 = x0;"),
    ("const float p1 = in ? __expf(x1 - m2.y) * inv2.y : 0.f;", "const float p1 = x1;"),
    ("const float ds0 = real ? p0 * (dp[j][2 * h] - D2.x) : 0.f;", "const float ds0 = dp[j][2 * h];"),
    ("const float ds1 = real ? p1 * (dp[j][2 * h + 1] - D2.y) : 0.f;",
     "const float ds1 = dp[j][2 * h + 1];"),
]
BWD_VARIANTS = {
    "shipped": [],
    "warps6_blocks2": [(_WARPS, _WARPS.replace("4", "6")), (_BLOCKS, "return kc <= 5 ? 2 : 1;")],
    "warps8_blocks1": [(_WARPS, _WARPS.replace("4", "8")), (_BLOCKS, "return 1;")],
    "warps12_blocks1": [(_WARPS, _WARPS.replace("4", "12")), (_BLOCKS, "return 1;")],
    "sub16": [(_BWD_SUB, _BWD_SUB.replace("32", "16"))],
    "sub64_blocks2": [(_BWD_SUB, _BWD_SUB.replace("32", "64")), (_BLOCKS, "return 2;")],
    "blocks2": [(_BLOCKS, "return 2;")],
    "cut_copies": _CUT_COPIES,
    # only q (dk/dv kernel) and k (dq kernel) are copied in the loop
    "half_copies": [
        ("            load_tile<MMA_NT, KC, TILE>(dOs + (buf ^ 1) * TILE_ELEMS, dout + base + "
         "size_t(q1) * d,\n                                        nrows, d, copy_8b, magic);\n", ""),
        ("            load_tile<MMA_NT, KC, TILE>(Vs + (buf ^ 1) * TILE_ELEMS, v + base + "
         "size_t(k1) * d,\n                                        nrows, d, copy_8b, magic);\n", "")],
    "hot_copies": [("q + base + size_t(q1) * d", "q + base"),
                   ("dout + base + size_t(q1) * d", "dout + base"),
                   ("k + base + size_t(k1) * d", "k + base"), ("v + base + size_t(k1) * d", "v + base")],
    "cut_softmax": _BWD_NO_SOFTMAX,
    "cut_second_products": [
        ("product_kn<KC, SUB / 16>(acc_v, pa, dOt, sub, lane);",
         "acc_v[0][0] += __uint_as_float(pa[0][0] ^ pa[1][3]);"),
        ("product_kn<KC, SUB / 16>(acc_k, dsa, Qt, sub, lane);",
         "acc_k[0][0] += __uint_as_float(dsa[0][0] ^ dsa[1][3]);")],
    "cut_copies_and_softmax": [*_CUT_COPIES, *_BWD_NO_SOFTMAX],
    "wgmma_experiment": EXPERIMENT,
    # the wide kernels (d > 128): dk/dv in 128-column output chunks instead
    # of 64, dq in 64 instead of 128
    "wide_dkdv_cw8": [("WIDE_CW_DKDV = 4;", "WIDE_CW_DKDV = 8;")],
    "wide_dq_cw4": [("constexpr int WIDE_CW_DQ = 8,", "constexpr int WIDE_CW_DQ = 4,")],
    **_UNROLL_COPIES,
    # the packed kernel: step 3's inputs re-read (two blocks an SM) instead
    # of kept in shared memory from step 1 (one block an SM at d = 350 and
    # 384); the kept Q, K and dO staged by 16-byte copies of the tile's
    # contiguous 16-row spans instead of the d-chunks' own copies (4 bytes
    # wide at d = 350); 128-column output chunks (re-read: kept chunks are
    # 64 columns) instead of 64
    "packed_reread": [(_PACK_KEEP, _PACK_KEEP.replace("true", "false"))],
    "packed_staged": [(_PACK_STAGED, _PACK_STAGED.replace("false", "true"))],
    "packed_cw8": [(_PACK_CW, _PACK_CW.replace("4", "8"))],
    # the list kernel: S and dP in two 64-key halves, each over the whole d
    # (Q and dO read twice), instead of one pass over the 128 keys
    "list_halves": [(_LIST_HALVES, _LIST_HALVES.replace("false", "true"))],
    # the long kernel: how the two halves' dq partials are summed. Shipped:
    # one block a list runs both halves and keeps the first half's partial
    # in fp32 scratch that its own threads read back. Instead, a block for
    # each half (twice the blocks, each half the work): each writes its
    # partial to its own fp32 buffer and a second kernel adds the two in a
    # fixed order (`long_sum_split`), or each adds its partial into a zeroed
    # buffer by atomicAdd and the second kernel rounds it
    # (`long_sum_atomic`); both give the same bits on every run
    "long_sum_split": [(_LONG_SUM, _LONG_SUM.replace("0", "1"))],
    "long_sum_atomic": [(_LONG_SUM, _LONG_SUM.replace("0", "2"))],
    "long_rows_experiment": LONG_ROWS_EXPERIMENT,
    **_TF32_VARIANTS,
    "f32_w16": [(_F32_W, _F32_W.replace("= 32", "= 16"))],
    "f32_hot_copies": [("const size_t qb = base + size_t(pass) * F32_PASS * d;",
                        "const size_t qb = base;"),
                       ("const size_t kb = base + size_t(slice) * F32_SLICE * d;",
                        "const size_t kb = base;")],
    "f32_cvt_round": [(_F32_INT_ROUND, _F32_INT_ROUND.replace("true", "false"))],
    "f32_cut_partials": [("const float2 p = more_q && r < nrows", "const float2 p = false"),
                         ("const float2 p = more_kv && key < nrows", "const float2 p = false")],
    # the fp32 dk/dv and dq kernels at d <= 128: 8 warps a block (128 keys or
    # query rows, one block an SM at d = 68) instead of 4 (two blocks an SM);
    # query-row and key tiles of 64 rows (one block of 4 warps an SM at
    # d = 68) or of 16 instead of 32; the operands' lo rounded to TF32 too
    # (five instructions a value instead of three); each k-step's products
    # summed in a fresh fragment (mma_3xtf32) instead of four k-steps', or
    # eight k-steps'; the registers cut for one block an SM instead of two
    "f32n_warps8": [(_F32N_WARPS, _F32N_WARPS.replace("= 4", "= 8"))],
    "f32n_tile64": [(_F32N_TILE, _F32N_TILE.replace("= 32", "= 64"))],
    "f32n_tile16": [(_F32N_TILE, _F32N_TILE.replace("= 32", "= 16"))],
    "f32n_split_int": [(_F32N_SPLIT, _F32N_SPLIT.replace("SPLIT_INT_CUT", "SPLIT_INT"))],
    "f32n_group1": [(_F32N_GROUP, _F32N_GROUP.replace("= 4", "= 1"))],
    "f32n_group8": [(_F32N_GROUP, _F32N_GROUP.replace("= 4", "= 8"))],
    "f32n_blocks1": [(_F32N_BLOCKS, _F32N_BLOCKS.replace("8 / F32N_WARPS", "1"))],
    # the fp32 wide dk/dv and dq kernels (d > 128, lists past 256 docs):
    # 16-column d-chunks and output chunks instead of 32; the dq kernel's
    # registers cut for three blocks an SM instead of two
    "f32w_w16": [(_F32W_CW, _F32W_CW.replace("= 32", "= 16"))],
    "f32w_dq_blocks3": [(_F32W_DQ_BOUNDS, _F32W_DQ_BOUNDS.replace("F32W_BLOCKS)", "3)"))],
}

# The forward: keys of S a warp holds at a time, blocks an SM the registers
# are cut for, 8 warps owning 128 query rows; then without the next tile's
# copies, with every copy from the first tile (the same instructions,
# cache-hot data), without its exponentials (p = x - m), without the P V
# product.
_FWD_SUB = "constexpr int SUB = 64;"
FWD_VARIANTS = {
    "shipped": [],
    "sub32": [(_FWD_SUB, _FWD_SUB.replace("64", "32"))],
    "blocks2": [(_BLOCKS, "return 2;")],
    "blocks4": [(_BLOCKS, "return kc <= 5 ? 4 : 2;")],
    "warps8_blocks1": [(_WARPS, _WARPS.replace("4", "8")), (_BLOCKS, "return 1;")],
    "cut_copies": _CUT_COPIES,
    "hot_copies": [("k + base + size_t(k1) * d", "k + base"),
                   ("v + base + size_t(k1) * d", "v + base")],
    "cut_exp": [("const float p0 = ex2(s[j][2 * h] - m[h]);", "const float p0 = s[j][2 * h] - m[h];"),
                ("const float p1 = ex2(s[j][2 * h + 1] - m[h]);",
                 "const float p1 = s[j][2 * h + 1] - m[h];")],
    "cut_pv": [("product_kn<KC, SUB / 16>(acc, pa, Vt, sub, lane);",
                "acc[0][0] += __uint_as_float(pa[0][0] ^ pa[SUB / 16 - 1][3]);")],
    # the wide kernel (d > 128): 64-column output chunks instead of 128
    "wide_cw4": [("constexpr int WIDE_CW = 8;", "constexpr int WIDE_CW = 4;")],
    **_UNROLL_COPIES,
    # the packed kernel: 128-column output chunks (step 3's V chunks) instead of 64
    "packed_cw8": [("constexpr int PACK_CW = 4;", "constexpr int PACK_CW = 8;")],
    # the long kernel: S computed twice, a first pass over both halves for
    # the row's max and a second that rounds every p against it, instead of
    # one pass with an online rescale between the halves
    "long_two_pass": [("constexpr bool LONG_TWO_PASS = false;",
                       "constexpr bool LONG_TWO_PASS = true;")],
    **_TF32_VARIANTS,
    # the fp32 packed kernel's registers cut for three blocks an SM instead
    # of two (168 a thread: it spills)
    "tf32_blocks3": [("__launch_bounds__(MMA_NT, 2)\nflash_fwd_packed_tf32_kernel",
                      "__launch_bounds__(MMA_NT, 3)\nflash_fwd_packed_tf32_kernel")],
    # the fp32 list forward: 16-column d-chunks and output chunks instead of
    # 32; on the 128-row tile the registers cut for three blocks of 4 warps
    # an SM instead of two (their shared memory fits three); 128 query rows
    # a block of 8 warps on the 128-row tile instead of 64 of 4, and 64 of 4
    # on the 256-row tile instead of 128 of 8; the hi/lo split rounded by
    # cvt.rna.tf32.f32 instead of integer arithmetic; the chunk copies of
    # load_chunk_f32, which computes each copy's row and column from its
    # index, instead of load_rows_f32's constant strides; step 3's products
    # over the keys unrolled by 4 instead of 2
    "f32_w16": [(_F32_W, _F32_W.replace("= 32", "= 16"))],
    "f32_list_blocks3": [(_F32_FWD_BOUNDS,
                          _F32_FWD_BOUNDS.replace("), 1)", "), ROWS > LIST_KEYS ? 1 : 3)"))],
    "f32_list_own128": [("constexpr int F32_LIST_OWN = 64;", "constexpr int F32_LIST_OWN = 128;")],
    "f32_long_own64": [("constexpr int F32_LONG_OWN = 128;", "constexpr int F32_LONG_OWN = 64;")],
    "f32_cvt_round": [(_F32_INT_ROUND, _F32_INT_ROUND.replace("true", "false"))],
    "f32_index_copies": [("load_rows_f32<NT", "load_chunk_f32<NT")],
    "f32_pv_unroll4": [("#pragma unroll 2\n        for (int j = 0; j < ktiles; ++j) {",
                        "#pragma unroll 4\n        for (int j = 0; j < ktiles; ++j) {")],
    # the fp32 forward at d <= 128: Q re-split from shared memory each key
    # tile instead of split once into registers (NC <= 9); 64-key tiles
    # instead of 32; eight k-steps' products summed in a fresh fragment
    # instead of four; the registers cut for three blocks an SM instead of
    # two; then, to show what they cost, P V without its fourth product (V in
    # two parts), no exponentials (p = x - m) and no P V product
    "f32n_qsmem": [(_F32N_QREG, _F32N_QREG.replace("= 9", "= 0"))],
    "f32n_tile64": [(_F32N_FWD_TILE, _F32N_FWD_TILE.replace("= 32", "= 64"))],
    "f32n_group8": [(_F32N_GROUP, _F32N_GROUP.replace("= 4", "= 8"))],
    "f32n_blocks3": [(_F32N_FWD_BLOCKS, _F32N_FWD_BLOCKS.replace("= 2", "= 3"))],
    "f32n_cut_lo2": [("                mma_1688_tf32(tc, ahi[j], blo2[0], blo2[1]);\n", "")],
    "f32n_cut_exp": [("const float p = expf(s[j][e] - m[e >> 1]);  // 0 past N",
                      "const float p = s[j][e] - m[e >> 1];")],
    "f32n_cut_pv": [("product_pv_tf32<LD, NJ, NC>(acc, s, Vt, lane);  // O += P V",
                     "acc[0][0] += s[0][0] * s[NJ - 1][3];")],
    # the fp32 wide forward (d > 128, lists past 256 docs): 16-column
    # d-chunks and output chunks instead of 32; the registers cut for two
    # blocks an SM instead of three
    "f32w_w16": [(_F32W_CW, _F32W_CW.replace("= 32", "= 16"))],
    "f32w_blocks2": [(_F32W_BLOCKS_FWD, _F32W_BLOCKS_FWD.replace("= 3", "= 2"))],
}

# The half-step: lanes across a row of the column kernel, float4 loads in
# flight a thread, the compiler's division everywhere instead of the FMA one;
# then a multiplication by 1/lam for the division, no per-element exp, and
# every load from one cache-hot row (the instructions stay, the device-memory
# traffic goes).
_LANES = "constexpr int VEC_LANES = 32;"
_CHUNK = "constexpr int CHUNK = 4;"
SINK_VARIANTS = {
    "shipped": [],
    "lanes16": [(_LANES, _LANES.replace("32", "16"))],
    "chunk2": [(_CHUNK, _CHUNK.replace("4", "2"))],
    "true_div": [("bool ok = lam_ordinary;", "bool ok = false;")],
    "cut_div": [("if (!FAST) return -c / lam;", "if (true) return -c * y;")],
    "cut_exp": [("for (int u = 0; u < U; ++u) s += expf(x[u] - mc);",
                 "for (int u = 0; u < U; ++u) s += x[u] - mc;")],
    "hot_loads": [("*reinterpret_cast<const float4*>(cb + size_t(i + r * VEC_SLOTS) * N)",
                   "*reinterpret_cast<const float4*>(cb + size_t(r * VEC_SLOTS) * N)"),
                  ("*reinterpret_cast<const float4*>(row + j + 128 * r)",
                   "*reinterpret_cast<const float4*>(row + 128 * r)")],
}

# The pairwise loss: the exact transcendentals (expf, log1pf, a true
# division) for the fast ones; 64 x 64 tiles of pairs (a thread owns 4 x 4)
# instead of 128 x 128.
PAIR_VARIANTS = {
    "shipped": [],
    "exact": [("return __expf(-fabsf(x));", "return expf(-fabsf(x));"),
              ("fmaxf(x, 0.0f) + __logf(1.0f + e);", "fmaxf(x, 0.0f) + log1pf(e);"),
              ("const float r = __frcp_rn(1.0f + e);", "const float r = 1.0f / (1.0f + e);")],
    "tile64": [("constexpr int TI = 128;", "constexpr int TI = 64;")],
}

# library -> {variant: substitutions in the shipped source, or a source of its own}
VARIANTS = {"flash_attn_bwd": BWD_VARIANTS, "flash_attn_fwd": FWD_VARIANTS,
            "sinkstep": SINK_VARIANTS, "pairwise_lambda": PAIR_VARIANTS}
# the kernels whose registers and spills each library's lines report
_REPORTED = {"flash_attn_bwd": [r"flash_bwd_dkdv_mma_kernelILi5E", r"flash_bwd_dq_mma_kernelILi5E",
                                r"flash_bwd_dkdv_wgmma_kernel", r"flash_bwd_dq_wgmma_kernel",
                                r"flash_bwd_dkdv_wide_mma_kernel", r"flash_bwd_dq_wide_mma_kernel",
                                r"flash_bwd_packed_mma_kernel", r"flash_bwd_long_mma_kernel",
                                r"flash_bwd_long_rows_mma_kernel",
                                r"flash_bwd_packed_tf32_kernel", r"flash_bwd_list_tf32_kernel",
                                r"flash_bwd_dkdv_tf32_kernelILi9E", r"flash_bwd_dq_tf32_kernelILi9E",
                                r"flash_bwd_dkdv_wide_tf32_kernel",
                                r"flash_bwd_dq_wide_tf32_kernel"],
             "flash_attn_fwd": [r"flash_fwd_mma_kernelILi5E", r"flash_fwd_tf32_kernelILi9E",
                                r"flash_fwd_wide_mma_kernel",
                                r"flash_fwd_packed_mma_kernel", r"flash_fwd_long_mma_kernel",
                                r"flash_fwd_packed_tf32_kernel", r"flash_fwd_list_tf32_kernel",
                                r"flash_fwd_wide_tf32_kernel"],
             "sinkstep": [r"sinkstep_cols_vec_kernel", r"sinkstep_rows_vec_kernel"],
             "pairwise_lambda": [r"pair_fwd_kernelILb1E", r"pair_bwd_kernelILb1E"]}
_P, _I = ctypes.c_void_p, ctypes.c_int


def source_path(lib: str) -> Path:
    return cuda_build.CSRC / f"{lib}.cu"


def sources(libs=tuple(VARIANTS), only=None):
    """{(library, variant): source text, or the Path of a source of its own}
    (`only`: {library: variant names}, the shipped source always among
    them); raises if a substitution misses."""
    out = {}
    for lib in libs:
        text = source_path(lib).read_text()
        for name, subs in VARIANTS[lib].items():
            if only and only.get(lib) and name != "shipped" and name not in only[lib]:
                continue
            if isinstance(subs, Path):
                out[(lib, name)] = subs
                continue
            s = text
            for old, new in subs:
                if old not in s:
                    raise RuntimeError(f"variant {lib}/{name}: {old!r} is not in {lib}.cu")
                s = s.replace(old, new)
            out[(lib, name)] = s
    return out


def build_all(libs, only=None):
    """{(library, variant): (CDLL, ptxas log)}; every nvcc started together."""
    out_dir = cuda_build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for (lib, name), text in sources(libs, only).items():
        so = out_dir / f"{lib}_{name}.so"
        if isinstance(text, Path):
            src = text
        else:
            src = so.with_suffix(".cu")
            src.write_text(text)
        procs[(lib, name)] = (cuda_build.nvcc(src, so), so)
    built = {}
    for key, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {key[0]}/{key[1]}: nvcc exited {proc.returncode}\n{log}")
        built[key] = (ctypes.CDLL(str(so)), log)
    return built


def registers(lib: str, log: str) -> dict:
    """{kernel<template arguments>: [registers, spill bytes]} of the
    library's reported kernels, one entry for each instantiation."""
    out = {}
    for part in log.split("Compiling entry function '")[1:]:
        entry = part.split("'", 1)[0]
        for pattern in _REPORTED[lib]:
            if re.search(pattern, entry):
                spills = re.findall(r"(\d+) bytes spill (?:stores|loads)", part)
                args = ",".join(re.findall(r"L[ib](\d+)E", entry.split(pattern.split("I")[0])[-1]))
                out[f"{pattern}<{args}>"] = [int(re.search(r"Used (\d+) registers", part).group(1)),
                                             sum(int(x) for x in spills)]
    return out


def time_ms(fn) -> float:
    """ms per call: the median of three blocks of ITERS calls, CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(3)]
    for start, end in events:
        start.record()
        for _ in range(ITERS):
            fn()
        end.record()
    torch.cuda.synchronize()
    return sorted(s.elapsed_time(e) for s, e in events)[1] / ITERS


def _entry(dll, name, argtypes):
    fn = getattr(dll, name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _attention_inputs(B, H, N, d, count, dtype=torch.bfloat16):
    """`count` [B, H, N, d] tensors of `dtype` and a ragged mask (list 0
    full), from seed 0: one set a shape, which every variant's cases read."""
    g = torch.Generator().manual_seed(0)
    tensors = [torch.randn(B, H, N, d, generator=g).to("cuda", dtype) for _ in range(count)]
    lengths = torch.randint(N // 4, N + 1, (B,), generator=g)
    lengths[0] = N
    return tensors, (torch.arange(N)[None, :] < lengths[:, None]).cuda()


@functools.lru_cache(maxsize=None)
def _bwd_inputs(B, H, N, d, dtype=torch.bfloat16):
    """The backward's inputs at one shape: q, k, v, dout, the mask, and the
    shipped forward's output, row statistics and row sums of dout * out."""
    (q, k, v, dout), mask = _attention_inputs(B, H, N, d, 4, dtype)
    out, row_max, row_sum = attention.FLASH_ATTN_FWD(q, k, v, mask, stats=True)
    dsum = torch.sum(dout.float() * out.float(), dim=-1)
    return q, k, v, dout, mask, out, row_max, row_sum, dsum


def long_cases(dll, entry):
    """[(case, launch, outputs, inputs)] of a long backward's C entry at the
    BWD_SHAPES of 129..256 docs and at LONG_COPY_SHAPES, with fp32 scratch
    of 2*B*H*N*d values (as much as any variant takes)."""
    stream = torch.cuda.current_stream().cuda_stream
    fn = _entry(dll, entry, [_P] * 12 + [_I] * 5 + [_P])
    cases = []
    for B, H, N, d in [s for s in BWD_SHAPES if 128 < s[2] <= 256] + LONG_COPY_SHAPES:
        keep = _bwd_inputs(B, H, N, d)
        q, k, v, dout, mask, out, row_max, row_sum, dsum = keep
        outs = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
        scratch = torch.empty(2 * B * H * N * d, device="cuda")
        args = ([t.data_ptr() for t in (q, k, v, dout, row_max, row_sum, dsum, mask, *outs,
                                        scratch)] + [B, H, N, d, 1, stream])
        cases.append((f"long {[B, H, N, d]}", lambda a=args: fn(*a), outs, keep + (scratch,)))
    return cases


def bwd_cases(dll, variant):
    """[(case, launch, outputs, inputs)] of the backward's two kernels at
    BWD_SHAPES and in fp32 at F32_PAIR_SHAPES (the warpgroup experiment:
    ATTN_SHAPE in bf16 only), of the packed
    kernel at the BWD_SHAPES of at most 64 docs and at PACK_COPY_SHAPES, of
    the list kernel at those of 128 docs and LIST_COPY_SHAPES, and of the
    long kernel at those of 256 docs and LONG_COPY_SHAPES (the ownership
    experiment: those alone), on the shipped forward's output and row
    statistics, and in fp32 at F32_WIDE_SHAPES (the fp32 wide kernels; for
    "parent", its CUDA-core wide pair); then the fp32 list and long kernels
    (for "parent": its wide pair) at the BWD_SHAPES of 128 and 256 docs in
    fp32."""
    if variant == "long_rows_experiment":
        return long_cases(dll, "flash_attn_bwd_long_rows")
    stream = torch.cuda.current_stream().cuda_stream
    wgmma = variant == "wgmma_experiment"
    dkdv = _entry(dll, "flash_attn_bwd_dkdv" + ("_wgmma" if wgmma else ""),
                  [_P] * 10 + [_I] * (4 if wgmma else 5) + [_P])
    dq_fn = _entry(dll, "flash_attn_bwd_dq" + ("_wgmma" if wgmma else ""),
                   [_P] * 9 + [_I] * (4 if wgmma else 5) + [_P])
    cases = []
    f32 = [] if wgmma else [(s, torch.float32) for s in F32_PAIR_SHAPES + F32_WIDE_SHAPES]
    for (B, H, N, d), dtype in [(s, torch.bfloat16) for s in
                                ([ATTN_SHAPE] if wgmma else BWD_SHAPES)] + f32:
        keep = _bwd_inputs(B, H, N, d, dtype)
        q, k, v, dout, mask, out, row_max, row_sum, dsum = keep
        common = [t.data_ptr() for t in (q, k, v, dout, row_max, row_sum, dsum, mask)]
        code = 0 if dtype == torch.float32 else 1
        tail = [B, H, N, d, stream] if wgmma else [B, H, N, d, code, stream]
        dk, dv, dq = torch.empty_like(k), torch.empty_like(v), torch.empty_like(q)
        tag = (" wide fp32" if d > 128 else " fp32") if code == 0 else ""
        cases += [
            (f"dkdv{tag} {[B, H, N, d]}",
             lambda c=common, t=tail, o=(dk, dv): dkdv(*c, o[0].data_ptr(), o[1].data_ptr(), *t),
             (dk, dv), keep),
            (f"dq{tag} {[B, H, N, d]}", lambda c=common, t=tail, o=dq: dq_fn(*c, o.data_ptr(), *t),
             (dq,), keep)]
    if wgmma:
        return cases
    packed = _entry(dll, "flash_attn_bwd_packed", [_P] * 11 + [_I] * 5 + [_P])
    for B, H, N, d in [s for s in BWD_SHAPES if s[2] <= 64] + PACK_COPY_SHAPES:
        keep = _bwd_inputs(B, H, N, d)
        q, k, v, dout, mask, out, row_max, row_sum, dsum = keep
        outs = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
        args = ([t.data_ptr() for t in (q, k, v, dout, row_max, row_sum, dsum, mask, *outs)]
                + [B, H, N, d, 1, stream])
        cases.append((f"packed {[B, H, N, d]}", lambda a=args: packed(*a), outs, keep))
    for B, H, N, d in [s for s in BWD_SHAPES if s[2] <= 64]:  # the fp32 packed kernel (3xTF32)
        keep = _bwd_inputs(B, H, N, d, torch.float32)
        q, k, v, dout, mask, out, row_max, row_sum, dsum = keep
        outs = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
        args = ([t.data_ptr() for t in (q, k, v, dout, row_max, row_sum, dsum, mask, *outs)]
                + [B, H, N, d, 0, stream])
        cases.append((f"packed fp32 {[B, H, N, d]}", lambda a=args: packed(*a), outs, keep))
    listk = _entry(dll, "flash_attn_bwd_list", [_P] * 11 + [_I] * 5 + [_P])
    for B, H, N, d in [s for s in BWD_SHAPES if 64 < s[2] <= 128] + LIST_COPY_SHAPES:
        keep = _bwd_inputs(B, H, N, d)
        q, k, v, dout, mask, out, row_max, row_sum, dsum = keep
        outs = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
        args = ([t.data_ptr() for t in (q, k, v, dout, row_max, row_sum, dsum, mask, *outs)]
                + [B, H, N, d, 1, stream])
        cases.append((f"list {[B, H, N, d]}", lambda a=args: listk(*a), outs, keep))
    cases += long_cases(dll, "flash_attn_bwd_long")
    longk = _entry(dll, "flash_attn_bwd_long", [_P] * 12 + [_I] * 5 + [_P])
    for B, H, N, d in [s for s in BWD_SHAPES if 64 < s[2] <= 256]:
        keep = _bwd_inputs(B, H, N, d, torch.float32)
        q, k, v, dout, mask, out, row_max, row_sum, dsum = keep
        outs = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
        common = [t.data_ptr() for t in (q, k, v, dout, row_max, row_sum, dsum, mask)]
        dq, dk, dv = (t.data_ptr() for t in outs)
        tail = [B, H, N, d, 0, stream]
        tag = "list" if N <= 128 else "long"
        if variant == "parent":  # the parent's fp32 route at these lengths: the wide pair
            run = lambda c=common, o=(dq, dk, dv), t=tail: dkdv(*c, o[1], o[2], *t) or dq_fn(
                *c, o[0], *t)
        elif tag == "list":
            run = lambda c=common, o=(dq, dk, dv), t=tail: listk(*c, *o, *t)
        else:
            run = lambda c=common, o=(dq, dk, dv), t=tail: longk(*c, *o, None, *t)
        cases.append((f"{tag} fp32 {[B, H, N, d]}", run, outs, keep))
    return cases


def fwd_cases(dll, variant):
    """[(case, launch, outputs, inputs)] of the forward with row statistics at
    FWD_SHAPES and in fp32 at F32_FWD_SHAPES and F32_WIDE_SHAPES (for
    "parent": the parent's fp32 forward there), of the packed forward at the WIDE_SHAPES (of at most 128
    docs) and PACK_COPY_SHAPES, of the long forward at the WIDE_SHAPES of
    256 docs and LONG_COPY_SHAPES, (but for "parent") of the fp32 packed
    forward at the WIDE_SHAPES of at most 64 docs, and of the fp32 list
    forward at the WIDE_SHAPES of 128 and 256 docs and LIST_COPY_SHAPES and
    LONG_COPY_SHAPES (for "parent": its wide forward, the parent's route
    there)."""
    stream = torch.cuda.current_stream().cuda_stream
    cases = []
    parent = variant == "parent"
    f32 = torch.float32
    fp32 = [] if parent else [
        ("packed fp32 ", "flash_attn_fwd_packed", f32, [s for s in WIDE_SHAPES if s[2] <= 64])]
    fp32 += [("list fp32 ", "flash_attn_fwd" if parent else "flash_attn_fwd_packed", f32,
              [s for s in WIDE_SHAPES if 64 < s[2] <= 128] + LIST_COPY_SHAPES),
             ("list fp32 ", "flash_attn_fwd" if parent else "flash_attn_fwd_long", f32,
              [s for s in WIDE_SHAPES if 128 < s[2] <= 256] + LONG_COPY_SHAPES)]
    for tag, entry, dtype, shapes in (
            ("", "flash_attn_fwd", torch.bfloat16, FWD_SHAPES),
            ("fp32 ", "flash_attn_fwd", f32, F32_FWD_SHAPES),
            ("wide fp32 ", "flash_attn_fwd", f32, F32_WIDE_SHAPES),
            ("packed ", "flash_attn_fwd_packed", torch.bfloat16,
             [s for s in WIDE_SHAPES if s[2] <= 128] + PACK_COPY_SHAPES),
            ("long ", "flash_attn_fwd_long", torch.bfloat16,
             [s for s in WIDE_SHAPES if 128 < s[2] <= 256] + LONG_COPY_SHAPES), *fp32):
        fn = _entry(dll, entry, [_P] * 7 + [_I] * 5 + [_P])
        for B, H, N, d in shapes:
            (q, k, v), mask = _attention_inputs(B, H, N, d, 3, dtype)
            outs = (torch.empty_like(q), torch.empty(B, H, N, device="cuda"),
                    torch.empty(B, H, N, device="cuda"))
            args = ([t.data_ptr() for t in (q, k, v, mask, *outs)]
                    + [B, H, N, d, 1 if dtype == torch.bfloat16 else 0, stream])
            cases.append((tag + str([B, H, N, d]), lambda fn=fn, args=args: fn(*args), outs,
                          (q, k, v, mask)))
    return cases


def sink_cases(dll, variant):
    """[(case, launch, outputs, inputs)] of the half-step at SINK_SHAPE, both orientations."""
    fn = _entry(dll, "sinkstep", [_P] * 4 + [_I, _I, ctypes.c_float, _I, _P])
    B, N = SINK_SHAPE
    g = torch.Generator().manual_seed(0)
    cost = torch.randn(B, N, N, generator=g).abs().cuda()
    log_marg = torch.log_softmax(torch.randn(B, N, generator=g), dim=-1).cuda()
    log_u = torch.log_softmax(torch.randn(B, N, generator=g), dim=-1).cuda()
    stream = torch.cuda.current_stream().cuda_stream
    cases = []
    for name, transposed in (("cols", 0), ("rows", 1)):
        out = torch.empty_like(log_marg)
        args = [t.data_ptr() for t in (cost, log_marg, log_u, out)] + [B, N, 0.3, transposed,
                                                                       stream]
        cases.append((name, lambda args=args: fn(*args), (out,), (cost, log_marg, log_u)))
    return cases


def pair_cases(dll, variant):
    """[(case, launch, outputs, inputs)] of the pairwise loss, LambdaRank, at
    PAIR_SHAPE: the forward (its output the partials' sum, since the tile
    size sets their number) and the backward, each with its own partials or
    scratch sized by the variant's tile."""
    text = sources(["pairwise_lambda"])[("pairwise_lambda", variant)]
    tile = int(re.search(r"constexpr int TI = (\d+);", text).group(1))
    row_args = [_I, _I, ctypes.c_float, _I, _P]
    fwd = _entry(dll, "pairwise_lambda_fwd", [_P] * 5 + row_args)
    bwd = _entry(dll, "pairwise_lambda_bwd", [_P] * 7 + row_args)
    B, N = PAIR_SHAPE
    g = torch.Generator().manual_seed(0)
    s = torch.randn(B, N, generator=g).sort(dim=1, descending=True).values.cuda()
    l = torch.randint(0, 5, (B, N), generator=g).float().cuda()
    gains = (torch.rand(B, N, generator=g) / N).cuda()
    mask = torch.ones(B, N, dtype=torch.bool, device="cuda")
    tiles = -(-N // tile)
    partials = torch.empty(B, tiles * (tiles + 1) // 2, device="cuda")
    total = torch.empty((), device="cuda")
    scale = torch.ones(1, device="cuda")
    grad = torch.empty(B, N, device="cuda")
    scratch = torch.empty(2 * B * tiles * N, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rows = [t.data_ptr() for t in (s, l, gains, mask)]

    def forward():
        err = fwd(*rows, partials.data_ptr(), B, N, 1.0, 1, stream)
        torch.sum(partials, dim=(0, 1), out=total)
        return err

    keep = (s, l, gains, mask, partials, scale, scratch)
    return [("fwd", forward, (total,), keep),
            ("bwd", lambda: bwd(*rows, scale.data_ptr(), grad.data_ptr(), scratch.data_ptr(), B, N,
                                1.0, 1, stream), (grad,), keep)]


def sdpa_line(card: str) -> dict:
    """SDPA in fp32 (TF32 off, a masked key's bias -1e9) at F32_WIDE_SHAPES:
    ms of its forward and of its backward alone (from a kept graph), on the
    inputs of the kernels' cases."""
    import torch.nn.functional as Fn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ms = {}
    for B, H, N, d in F32_WIDE_SHAPES:
        q, k, v, dout, mask = _bwd_inputs(B, H, N, d, torch.float32)[:5]
        bias = torch.where(mask, 0.0, -1e9)[:, None, None, :].expand(B, H, N, N)
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        out = Fn.scaled_dot_product_attention(*leaves, attn_mask=bias)

        def backward():
            for t in leaves:
                t.grad = None
            out.backward(dout, retain_graph=True)

        ms[str([B, H, N, d])] = {
            "fwd": time_ms(lambda: Fn.scaled_dot_product_attention(q, k, v, attn_mask=bias)),
            "bwd": time_ms(backward)}
    return {"library": "torch_sdpa", "variant": "fp32", "ms": ms, "card": card}


# library -> its cases: [(case, launch, outputs, inputs)] from (CDLL, variant);
# a case keeps its inputs, which own the launch's pointers
CASES = {"flash_attn_bwd": bwd_cases, "flash_attn_fwd": fwd_cases, "sinkstep": sink_cases,
         "pairwise_lambda": pair_cases}


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if args[:1] == ["--parent"]:
        if len(args) < 2:
            print("kernel_variants: --parent needs a directory", file=sys.stderr)
            return 2
        parent = Path(args[1]).resolve() / "ptranking_tpu_torch" / "ops" / "csrc"
        for lib in ("flash_attn_fwd", "flash_attn_bwd"):
            VARIANTS[lib]["parent"] = parent / f"{lib}.cu"
        args = args[2:]
    keep = None
    if args[:1] == ["--cases"]:
        if len(args) < 2:
            print("kernel_variants: --cases needs a pattern", file=sys.stderr)
            return 2
        keep, args = re.compile(args[1]), args[2:]
    args = args or list(VARIANTS)
    libs = [a.split(":", 1)[0] for a in args]
    only = {a.split(":", 1)[0]: a.split(":", 1)[1].split(",") for a in args if ":" in a}
    unknown = [lib for lib in libs if lib not in VARIANTS]
    unknown += [f"{lib}:{v}" for lib, names in only.items() for v in names
                if lib in VARIANTS and v not in VARIANTS[lib]]
    if unknown:
        print(f"kernel_variants: unknown libraries {unknown}; known: {list(VARIANTS)}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    built = build_all(libs, only)
    cases = {key: [c for c in CASES[key[0]](built[key][0], key[1])
                   if keep is None or keep.search(c[0])] for key in built}
    results = {key: {"ms": {}} for key in built}
    shipped = {}
    for order in (list(built), list(built)[::-1]):
        for key in order:
            lib, name = key
            diffs = {}
            for case, run, outs, _ in cases[key]:
                if run() != 0:
                    raise RuntimeError(f"{lib}/{name} {case}: CUDA error")
                torch.cuda.synchronize()
                if name == "shipped" and (lib, case) not in shipped:
                    shipped[(lib, case)] = [t.clone() for t in outs]
                diffs[case] = [float((a.float() - b.float()).abs().max())
                               for a, b in zip(outs, shipped[(lib, case)])]
                results[key]["ms"].setdefault(case, []).append(time_ms(run))
            # the pass run last decides; the outputs' max |variant - shipped|
            results[key]["same_bits_as_shipped"] = all(x == 0.0 for d in diffs.values() for x in d)
            results[key]["max_abs_diff_vs_shipped"] = diffs
    for (lib, name), rec in results.items():
        print(json.dumps({"library": lib, "variant": name,
                          "registers_spill_bytes": registers(lib, built[(lib, name)][1]), **rec,
                          "card": card}), flush=True)
    if any(name == "parent" for _, name in built):
        print(json.dumps(sdpa_line(card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
