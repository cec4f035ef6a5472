// Tensor-core building blocks of the bf16 flash-attention kernels
// (flash_attn_fwd.cu, flash_attn_bwd.cu): mma.sync.m16n8k16 products on
// fragments read by ldmatrix, bf16 tiles in shared memory with rows padded
// to LDS = 16*KC + 8 elements (KC = ceil(d/16) 16-deep steps: every row
// starts 16-byte aligned, as ldmatrix needs, and 8 consecutive rows fall into
// 8 different 16-byte bank groups), and the 8-byte cp.async tile copies;
// then the fp32 kernels' 3xTF32 products on mma.sync.m16n8k8, their
// fragments and their fp32 tile and chunk copies (the section at the end).
// cuda_build.library_path hashes this header into each including library's
// name, so an edit rebuilds them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float MASKED_LOGIT = -1e9f;  // a masked key's logit: finite, so an all-masked row stays finite

enum : int { KEY_REAL = 0, KEY_MASKED = 1, KEY_OUT = 2 };
// launch options of the tensor-core kernels: 8-byte tile copies, 4-byte stores of two bf16
enum : int { COPY_8B = 1, STORE_PAIRS = 2 };

__device__ __forceinline__ int key_flag(const uint8_t* __restrict__ mask_row, int key, int N) {
    return key >= N ? KEY_OUT : (mask_row[key] ? KEY_REAL : KEY_MASKED);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row-major) * b (16 x 8, bf16, column-major).
// With g = lane / 4, t = lane % 4 a thread holds c[0..1] = (row g, columns 2t,
// 2t+1), c[2..3] = (row g+8, the same columns); a[0] = (row g, k 2t, 2t+1),
// a[1] = (row g+8, the same k), a[2], a[3] = the same rows at k + 8;
// b0 = (k 2t, 2t+1; column g), b1 = the same at k + 8.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 8 bytes from src to dst, of which the first src_bytes (8 or 0) are read
// and the rest are zero-filled
__device__ __forceinline__ void cp_async_8(uint32_t dst, const void* src, int src_bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :
                 : "r"(dst), "l"(__cvta_generic_to_global(src)), "r"(src_bytes)
                 : "memory");
}
// 16 bytes likewise (src_bytes 16 or 0), bypassing L1
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :
                 : "r"(dst), "l"(__cvta_generic_to_global(src)), "r"(src_bytes)
                 : "memory");
}
// 4 bytes likewise (src_bytes 4 or 0)
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, int src_bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :
                 : "r"(dst), "l"(__cvta_generic_to_global(src)), "r"(src_bytes)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// every group but the one committed last has landed
__device__ __forceinline__ void cp_async_wait_prior() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo, the low half
    return *reinterpret_cast<const uint32_t*>(&v);
}

// load_tile's magic number: ceil(2^31 / (d/4))
__device__ __forceinline__ uint32_t copy_magic(int d) {
    return ((1u << 31) + uint32_t(d >> 2) - 1u) / uint32_t(max(d >> 2, 1));
}

// Rows r < nrows of the contiguous [nrows, d] tile at src into the shared
// [ROWS][16*KC + 8] tile at dst (columns < d), zeros in the rows past nrows,
// by the block's NT threads. With copy_8b (d % 4 == 0) the copies are 8-byte
// cp.async (the caller commits and waits): the tile's 4-element chunk
// L = tid + NT * i lies in row L / (d/4) = (2L * magic) >> 32 with
// magic = copy_magic(d) (exact for these L), so a thread's copies are a
// fixed, unrolled number of independent instructions with no loop-carried
// state, each from the thread's first chunk plus a constant; a row past
// nrows reads nothing and is zero-filled. Otherwise the copy is scalar and
// synchronous.
template <int NT, int KC, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src, int nrows,
                                          int d, bool copy_8b, uint32_t magic) {
    constexpr int LDS = 16 * KC + 8;
    constexpr int COPIES = (ROWS * 4 * KC + NT - 1) / NT;  // a thread's, at most
    if (copy_8b) {
        const int total = ROWS * (d >> 2);
        const uint32_t at = smem_addr(dst) + 8 * threadIdx.x;  // before the row padding
        const uint32_t pad = 2 * (LDS - d);                    // bytes of padding a row
        const bf16* from = src + 4 * threadIdx.x;
#pragma unroll
        for (int i = 0; i < COPIES; ++i) {
            const uint32_t chunk = threadIdx.x + NT * i;
            const int r = __umulhi(2u * chunk, magic);
            const bool in = r < nrows;
            if (chunk < uint32_t(total))
                cp_async_8(at + 8 * NT * i + r * pad, in ? from + 4 * NT * i : src, in ? 8 : 0);
        }
    } else {
        const bf16 zero = __float2bfloat16(0.f);
        for (int i = threadIdx.x; i < ROWS * d; i += NT) {
            const int r = i / d, c = i - r * d;
            dst[r * LDS + c] = r < nrows ? src[size_t(r) * d + c] : zero;
        }
    }
}

// The wide kernels (head dims above 128) of flash_attn_{fwd,bwd}.cu: a block
// owns 64 rows and one chunk of `width` output columns. grid.x folds (b*h,
// output chunk, 64-row tile), the row tile fastest, so the blocks that read
// one (b, h)'s rows run close together: the block's first row, its chunk oc
// and its b*h.
__device__ __forceinline__ int fold_wide(int N, int d, int width, int& oc, int& bh) {
    const int row_tiles = (N + 63) / 64, chunks = (d + width - 1) / width;
    const int x = blockIdx.x / row_tiles;
    oc = x % chunks;
    bh = x / chunks;
    return (blockIdx.x - x * row_tiles) * 64;
}

// blocks of a wide kernel's grid
inline long long wide_blocks(int B, int H, int N, int d, int width) {
    return (long long)((N + 63) / 64) * ((d + width - 1) / width) * B * H;
}

// The kernels of d <= 128 take b*h from grid.y, which holds at most 65535
// blocks, and their row tiles from grid.x: a batch of more lists than
// narrow_lists(H) runs in several launches of whole lists, each on tensors
// advanced to its first list. The wide kernels fold every axis into grid.x.
inline int narrow_lists(int H) { return 65535 / H; }

// Whether a shape's launches fit the card's grid limits (`width`: the
// narrowest output chunk of the wide kernels).
inline bool grid_fits(int B, int H, int N, int d, int width) {
    return d > 128 ? wide_blocks(B, H, N, d, width) < (1LL << 31) : H <= 65535;
}

// p advanced by `bytes`; a null pointer stays null
template <typename T>
T* advance(T* p, size_t bytes) {
    return p == nullptr ? p : reinterpret_cast<T*>(reinterpret_cast<uintptr_t>(p) + bytes);
}

// Copy widths of load_chunk: elements a copy instruction moves
enum : int { CHUNK_SYNC = 1, CHUNK_4B = 2, CHUNK_8B = 4, CHUNK_16B = 8 };

// The widest copy a [*, d] bf16 tensor's rows allow, given the largest
// power-of-two alignment (bytes, up to 16) that all its tensors share:
// 16-byte cp.async when d is a multiple of 8, 8-byte when of 4, 4-byte when d
// is even, else a synchronous element copy.
inline int chunk_copy(int d, int align) {
    if (d % 8 == 0 && align >= 16) return CHUNK_16B;
    if (d % 4 == 0 && align >= 8) return CHUNK_8B;
    if (d % 2 == 0 && align >= 4) return CHUNK_4B;
    return CHUNK_SYNC;
}

// the largest power of two (up to 16) that divides the address
inline int alignment(const void* p) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    return a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : a % 4 == 0 ? 4 : a % 2 == 0 ? 2 : 1;
}

// load_chunk's asynchronous copies of E elements (8: 16 bytes, 4: 8, 2: 4)
template <int NT, int CW, int ROWS, int E>
__device__ __forceinline__ void load_chunk_async(bf16* dst, const bf16* __restrict__ src,
                                                 int nrows, int d, int c0) {
    constexpr int LDS = 16 * CW + 8;
    constexpr int UNITS = 16 * CW / E;  // copies a row
    constexpr int COPIES = (ROWS * UNITS + NT - 1) / NT;
    const uint32_t base = smem_addr(dst);
    // unrolled by 4, not fully: fully unrolled, the compiler keeps every
    // copy's address across the caller's loop and the wide kernels spill;
    // not unrolled, the copies' index arithmetic costs a fifth of their time
    // (tools/kernel_variants.py, PERF.md)
#pragma unroll 4
    for (int i = 0; i < COPIES; ++i) {
        const int u = threadIdx.x + NT * i;
        const int r = u / UNITS, cu = u % UNITS;
        const int col = c0 + E * cu;
        const bool in = r < nrows && col < d;
        const bf16* from = in ? src + size_t(r) * d + col : src;
        const uint32_t at = base + 2 * (r * LDS + E * cu);
        if (u < ROWS * UNITS) {
            if (E == 8)
                cp_async_16(at, from, in ? 16 : 0);
            else if (E == 4)
                cp_async_8(at, from, in ? 8 : 0);
            else
                cp_async_4(at, from, in ? 4 : 0);
        }
    }
}

// Columns c0 .. c0 + 16*CW - 1 of rows r < nrows of the row-major [*, d]
// tile at src into the shared [ROWS][16*CW + 8] tile at dst, zero where the
// row is >= nrows or the column >= d (so a ragged d-chunk adds nothing to a
// product), by the block's NT threads. `copy` (chunk_copy) is the elements a
// copy moves: CHUNK_16B, CHUNK_8B and CHUNK_4B start cp.async copies (the caller commits and
// waits; zeros come from the copy's own zero-fill), CHUNK_SYNC stores
// element by element. The wide kernels stream d through these chunks, so
// nothing of theirs grows with d.
template <int NT, int CW, int ROWS>
__device__ __forceinline__ void load_chunk(bf16* dst, const bf16* __restrict__ src, int nrows,
                                           int d, int c0, int copy) {
    constexpr int LDS = 16 * CW + 8;
    constexpr int W = 16 * CW;
    if (copy == CHUNK_16B) {
        load_chunk_async<NT, CW, ROWS, 8>(dst, src, nrows, d, c0);
    } else if (copy == CHUNK_8B) {
        load_chunk_async<NT, CW, ROWS, 4>(dst, src, nrows, d, c0);
    } else if (copy == CHUNK_4B) {
        load_chunk_async<NT, CW, ROWS, 2>(dst, src, nrows, d, c0);
    } else {
        const bf16 zero = __float2bfloat16(0.f);
        for (int i = threadIdx.x; i < ROWS * W; i += NT) {
            const int r = i / W, c = i - r * W;
            dst[r * LDS + c] = r < nrows && c0 + c < d ? src[size_t(r) * d + c0 + c] : zero;
        }
    }
}

// columns d .. LDS-1 of `rows` shared rows: written once, no copy touches them
template <int NT, int LDS>
__device__ __forceinline__ void zero_pad_columns(bf16* tiles, int rows, int d) {
    const bf16 zero = __float2bfloat16(0.f);
    for (int r = threadIdx.x; r < rows; r += NT)
        for (int c = d; c < LDS; ++c) tiles[r * LDS + c] = zero;
}

// The A fragments (16 rows from row0, all KC 16-deep steps) of a [rows][LDS] tile.
template <int KC>
__device__ __forceinline__ void load_a(uint32_t (&a)[KC][4], const bf16* tile, int row0, int lane) {
    constexpr int LDS = 16 * KC + 8;
    // matrices: (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15), (rows 8-15, k 8-15)
    const uint32_t addr = smem_addr(tile + (row0 + (lane & 15)) * LDS + ((lane >> 4) << 3));
#pragma unroll
    for (int ks = 0; ks < KC; ++ks) ldmatrix_x4(a[ks], addr + ks * 32);
}

// acc[j] (16 x 8) += A (16 x 16*KC, fragments) * B_j^T, where B_j = rows
// n0 + 8j .. n0 + 8j + 7 of the [rows][LDS] tile at btile: the tile holds B
// as [column][k], which is mma's column-major B, so ldmatrix reads it as is.
template <int KC, int NTILES>
__device__ __forceinline__ void product_nk(float (&acc)[NTILES][4], const uint32_t (&a)[KC][4],
                                           const bf16* btile, int n0, int lane) {
    constexpr int LDS = 16 * KC + 8;
    // matrices: (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15)
    const uint32_t addr = smem_addr(btile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * LDS
                                    + (((lane >> 3) & 1) << 3));
#pragma unroll
    for (int ks = 0; ks < KC; ++ks)
#pragma unroll
        for (int np = 0; np < NTILES / 2; ++np) {
            uint32_t b[4];
            ldmatrix_x4(b, addr + (np * 16 * LDS + ks * 16) * 2);
            mma_16816(acc[2 * np], a[ks], b[0], b[1]);
            mma_16816(acc[2 * np + 1], a[ks], b[2], b[3]);
        }
}

// acc[j] (16 x 8: tile columns 8j .. 8j+7, j < 2*KC) += A (16 x 16*NCH,
// fragments in registers) * B, where B = rows k0 .. k0 + 16*NCH - 1 of the
// [rows][LDS] tile at btile: the tile holds B as [k][column], so ldmatrix
// transposes each 8 x 8 block on the way.
template <int KC, int NCH>
__device__ __forceinline__ void product_kn(float (&acc)[2 * KC][4], const uint32_t (&a)[NCH][4],
                                           const bf16* btile, int k0, int lane) {
    constexpr int LDS = 16 * KC + 8;
    // matrices: (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
    const uint32_t addr = smem_addr(btile + (k0 + (lane & 15)) * LDS + ((lane >> 4) << 3));
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
        for (int np = 0; np < KC; ++np) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, addr + (ch * 16 * LDS + np * 16) * 2);
            mma_16816(acc[2 * np], a[ch], b[0], b[1]);
            mma_16816(acc[2 * np + 1], a[ch], b[2], b[3]);
        }
}

// (x, y) at columns col, col + 1 of an output row of d columns
__device__ __forceinline__ void store_pair(bf16* row, int col, float x, float y, int d,
                                           bool pairs) {
    if (pairs) {  // d even and the row 4-byte aligned: col + 1 < d whenever col < d
        if (col < d) *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(x, y);
    } else {
        if (col < d) row[col] = __float2bfloat16(x);
        if (col + 1 < d) row[col + 1] = __float2bfloat16(y);
    }
}

inline bool aligned(const void* p, uintptr_t bytes) {
    return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// ---------------------------------------------------------------------------
// fp32 on the tensor cores: 3xTF32 (the fp32 kernels)
// ---------------------------------------------------------------------------
//
// TF32 keeps 10 mantissa bits, about 3 decimal digits. Split x = hi + lo with
// hi = x rounded to TF32 and lo = (x - hi) rounded to TF32 (x - hi is exact in
// fp32): hi + lo is x to about 2^-22 |x|. A product a b is then taken as
// a_lo b_hi + a_hi b_lo + a_hi b_hi, three mma.sync.m16n8k8 accumulating in
// fp32; the a_lo b_lo term (about 2^-22 of it) is left out. fp32 tiles in
// shared memory have rows of W + 4 floats (W a multiple of 32): 4 mod 32
// banks, so a fragment read as [row g][column t] (rows of A or of B stored
// as [n][k]) or as [k 2t, 2t + 1][column g] (B stored as [k][n]) meets 32
// distinct banks. The split (a kernel's SPLIT template argument) rounds by
// cvt.rna.tf32.f32 (SPLIT_CVT), or by integer arithmetic on the bits
// (SPLIT_INT, to_tf32_int: the same bits), or rounds hi so and leaves lo as
// x - hi for the tensor cores to cut (SPLIT_INT_CUT, split_tf32).

__device__ __forceinline__ uint32_t to_tf32(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
    return r;
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away from
// zero): half the weight of the 13 dropped bits added to the bit pattern,
// then the 13 bits cleared; the same bits as the cvt for every finite x whose
// rounding does not overflow. Two integer instructions: in the fp32 list and
// long backward 15..21% less time than the cvt, which also made them spill
// (PERF.md).
__device__ __forceinline__ uint32_t to_tf32_int(float x) {
    return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

enum : int { SPLIT_CVT = 0, SPLIT_INT = 1, SPLIT_INT_CUT = 2 };

// x = hi + lo as SPLIT says. SPLIT_INT_CUT is the split of CUTLASS's fast
// fp32 products (OpMultiplyAddFastF32): an mma's TF32 operand is read from
// the top 19 bits of its register and the rest is cut, so hi is x's bits
// plus half a TF32 ulp (x rounded to nearest once cut), lo = x - hi rounded,
// exact in fp32, and the tensor cores cut lo to TF32: three instructions
// where SPLIT_INT takes five, and hi + lo is x to about 2^-21 |x| instead
// of 2^-22.
template <int SPLIT = SPLIT_CVT>
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
    if (SPLIT == SPLIT_INT) {
        hi = to_tf32_int(x);
        lo = to_tf32_int(x - __uint_as_float(hi));
    } else if (SPLIT == SPLIT_INT_CUT) {
        hi = __float_as_uint(x) + 0x1000u;
        lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));
    } else {
        hi = to_tf32(x);
        lo = to_tf32(x - __uint_as_float(hi));
    }
}

// c (16 x 8, fp32) += a (16 x 8, tf32, row-major) * b (8 x 8, tf32,
// column-major). With g = lane / 4, t = lane % 4: c as in mma_16816; a[0] =
// (row g, k t), a[1] = (row g+8, k t), a[2] = (row g, k t+4), a[3] = (row g+8,
// k t+4); b0 = (k t, column g), b1 = (k t+4, column g). The C and A layouts
// differ (C holds columns 2t, 2t+1), so a product whose A is a C fragment
// (P, dS) numbers its k slots t -> 2t and t+4 -> 2t+1: its A takes the C
// fragment as {c[0], c[2], c[1], c[3]} and its B reads the rows 2t, 2t+1.
__device__ __forceinline__ void mma_1688_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// t += a b in 3xTF32 by the three products accumulated in t itself: for a
// fresh t that sums a few k-steps before its owner adds it to a longer sum
// in fp32 (mma_3xtf32 takes one k-step a fresh fragment)
__device__ __forceinline__ void mma_3xtf32_into(float (&t)[4], const uint32_t (&ahi)[4],
                                                const uint32_t (&alo)[4], const uint32_t (&bhi)[2],
                                                const uint32_t (&blo)[2]) {
    mma_1688_tf32(t, alo, bhi[0], bhi[1]);
    mma_1688_tf32(t, ahi, blo[0], blo[1]);
    mma_1688_tf32(t, ahi, bhi[0], bhi[1]);
}

// c += a b in 3xTF32, from split fragments. The three products go into a
// fresh fragment, which is then added to c in fp32 (round to nearest): the
// tensor cores align an mma's addends to the largest and cut the bits below,
// so accumulating a long contraction in c itself drifts by about 2^-23 |c|
// an mma, toward zero (on an NVIDIA H100 that missed chip_smoke.py's 1e-5
// fp32 gates by up to 1.5x, PERF.md); this way each cut is relative to one
// 8-deep step's sum.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4], const uint32_t (&bhi)[2],
                                           const uint32_t (&blo)[2]) {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    mma_3xtf32_into(t, ahi, alo, bhi, blo);
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] += t[e];
}

// A (16 rows from row0, k = k0 .. k0 + 7) of a row-major fp32 [rows][LD] tile
template <int LD, int SPLIT = SPLIT_CVT>
__device__ __forceinline__ void frag_a_tf32(uint32_t (&hi)[4], uint32_t (&lo)[4], const float* tile,
                                            int row0, int k0, int lane) {
    const float* p = tile + (row0 + (lane >> 2)) * LD + k0 + (lane & 3);
    split_tf32<SPLIT>(p[0], hi[0], lo[0]);
    split_tf32<SPLIT>(p[8 * LD], hi[1], lo[1]);
    split_tf32<SPLIT>(p[4], hi[2], lo[2]);
    split_tf32<SPLIT>(p[8 * LD + 4], hi[3], lo[3]);
}

// A of T^T (16 rows = columns row0 .. row0 + 15 of T; k = T's rows k0 + 2t
// and k0 + 2t + 1 in slots t and t+4) of an fp32 [*][LD] tile T
template <int LD, int SPLIT = SPLIT_CVT>
__device__ __forceinline__ void frag_a_trans_tf32(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                                  const float* tile, int row0, int k0, int lane) {
    const float* p = tile + (k0 + 2 * (lane & 3)) * LD + row0 + (lane >> 2);
    split_tf32<SPLIT>(p[0], hi[0], lo[0]);
    split_tf32<SPLIT>(p[8], hi[1], lo[1]);
    split_tf32<SPLIT>(p[LD], hi[2], lo[2]);
    split_tf32<SPLIT>(p[LD + 8], hi[3], lo[3]);
}

// B (8 columns n0 .. n0 + 7, k = k0 .. k0 + 7) of a tile holding B as [n][k]
template <int LD, int SPLIT = SPLIT_CVT>
__device__ __forceinline__ void frag_b_nk_tf32(uint32_t (&hi)[2], uint32_t (&lo)[2],
                                               const float* tile, int n0, int k0, int lane) {
    const float* p = tile + (n0 + (lane >> 2)) * LD + k0 + (lane & 3);
    split_tf32<SPLIT>(p[0], hi[0], lo[0]);
    split_tf32<SPLIT>(p[4], hi[1], lo[1]);
}

// B (columns n0 .. n0 + 7; k = rows k0 + 2t and k0 + 2t + 1 in slots t and
// t+4) of a tile holding B as [k][n]
template <int LD, int SPLIT = SPLIT_CVT>
__device__ __forceinline__ void frag_b_kn_tf32(uint32_t (&hi)[2], uint32_t (&lo)[2],
                                               const float* tile, int k0, int n0, int lane) {
    const float* p = tile + (k0 + 2 * (lane & 3)) * LD + n0 + (lane >> 2);
    split_tf32<SPLIT>(p[0], hi[0], lo[0]);
    split_tf32<SPLIT>(p[LD], hi[1], lo[1]);
}

// The C fragment of P or dS (rows g, g+8; columns 2t, 2t+1 of an 8-column
// tile) as the A fragment of a product over those columns, k slots t -> 2t
// and t+4 -> 2t+1 (mma_1688_tf32), split
template <int SPLIT = SPLIT_CVT>
__device__ __forceinline__ void c_as_a_tf32(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                            const float (&c)[4]) {
    const float a[4] = {c[0], c[2], c[1], c[3]};
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32<SPLIT>(a[i], hi[i], lo[i]);
}

// The widest copy (floats a cp.async moves: 4, 2 or 1) of a [*, d] fp32
// tensor's rows, given the alignment (bytes, up to 16) that all its tensors
// share: 16 bytes when d is a multiple of 4, 8 when d is even, else 4.
inline int chunk_copy_f32(int d, int align) {
    if (d % 4 == 0 && align >= 16) return 4;
    if (d % 2 == 0 && align >= 8) return 2;
    return 1;
}

// load_chunk_f32's copies of E floats
template <int NT, int W, int ROWS, int E>
__device__ __forceinline__ void load_chunk_f32_async(float* dst, const float* __restrict__ src,
                                                     int nrows, int d, int c0) {
    constexpr int LD = W + 4;
    constexpr int UNITS = W / E;  // copies a row
    constexpr int COPIES = (ROWS * UNITS + NT - 1) / NT;
    const uint32_t base = smem_addr(dst);
#pragma unroll 4
    for (int i = 0; i < COPIES; ++i) {
        const int u = threadIdx.x + NT * i;
        const int r = u / UNITS, cu = u % UNITS;
        const int col = c0 + E * cu;
        const bool in = r < nrows && col < d;
        const float* from = in ? src + size_t(r) * d + col : src;
        const uint32_t at = base + 4 * (r * LD + E * cu);
        if (u < ROWS * UNITS) {
            if (E == 4)
                cp_async_16(at, from, in ? 16 : 0);
            else if (E == 2)
                cp_async_8(at, from, in ? 8 : 0);
            else
                cp_async_4(at, from, in ? 4 : 0);
        }
    }
}

// Columns c0 .. c0 + W - 1 of rows r < nrows of the row-major [*, d] fp32
// tensor at src into the shared [ROWS][W + 4] tile at dst, zero where the row
// is >= nrows or the column >= d, by cp.async of `copy` floats
// (chunk_copy_f32); the caller commits and waits.
template <int NT, int W, int ROWS>
__device__ __forceinline__ void load_chunk_f32(float* dst, const float* __restrict__ src,
                                               int nrows, int d, int c0, int copy) {
    if (copy == 4)
        load_chunk_f32_async<NT, W, ROWS, 4>(dst, src, nrows, d, c0);
    else if (copy == 2)
        load_chunk_f32_async<NT, W, ROWS, 2>(dst, src, nrows, d, c0);
    else
        load_chunk_f32_async<NT, W, ROWS, 1>(dst, src, nrows, d, c0);
}

// load_chunk_f32's copies of E floats for a block whose NT threads cover
// whole rows of copies (NT a multiple of W / E): a thread copies one fixed
// E-float unit of every (NT / (W / E))-th row, so its source and shared
// addresses advance by constants, where load_chunk_f32 recomputes each copy's
// row, column and address from its index (at d = 350, 4-byte copies, that
// was about half of the fp32 list forward's instructions: PERF.md)
template <int NT, int W, int ROWS, int E>
__device__ __forceinline__ void load_rows_f32_async(float* dst, const float* __restrict__ src,
                                                    int nrows, int d, int c0) {
    constexpr int LD = W + 4;
    constexpr int UNITS = W / E;         // copies a row
    static_assert(NT % UNITS == 0, "the threads cover whole rows");
    constexpr int STEP = NT / UNITS;     // rows between a thread's copies
    constexpr int COPIES = (ROWS + STEP - 1) / STEP;
    const int r0 = threadIdx.x / UNITS, cu = threadIdx.x % UNITS;
    const int col = c0 + E * cu;
    const float* from = src + size_t(r0) * d + col;
    const size_t step = size_t(STEP) * d;
    const uint32_t at = smem_addr(dst) + 4 * (r0 * LD + E * cu);
#pragma unroll 4
    for (int i = 0; i < COPIES; ++i, from += step) {
        const int r = r0 + STEP * i;
        if (ROWS % STEP != 0 && r >= ROWS) break;
        const bool in = r < nrows && col < d;
        const float* p = in ? from : src;
        const uint32_t a = at + 4 * STEP * LD * i;
        if (E == 4)
            cp_async_16(a, p, in ? 16 : 0);
        else if (E == 2)
            cp_async_8(a, p, in ? 8 : 0);
        else
            cp_async_4(a, p, in ? 4 : 0);
    }
}

// load_chunk_f32 by load_rows_f32_async: the same tile, the same zeros
template <int NT, int W, int ROWS>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* __restrict__ src,
                                              int nrows, int d, int c0, int copy) {
    if (copy == 4)
        load_rows_f32_async<NT, W, ROWS, 4>(dst, src, nrows, d, c0);
    else if (copy == 2)
        load_rows_f32_async<NT, W, ROWS, 2>(dst, src, nrows, d, c0);
    else
        load_rows_f32_async<NT, W, ROWS, 1>(dst, src, nrows, d, c0);
}

// Rows r < nrows of the contiguous [nrows, d] fp32 tile at src into the
// shared [ROWS][LD] tile at dst, zeros in the rows past nrows, by the block's
// NT threads (the caller commits and waits). With copy == 4 (chunk_copy_f32:
// d % 4 == 0 on 16-byte-aligned tensors) 16-byte cp.async of the tile's
// 4-float chunks as load_tile takes its 8-byte ones: chunk L = tid + NT * i
// lies in row L / (d/4) = (2L * magic) >> 32 with magic = copy_magic(d), so
// a thread's source addresses advance by a constant and its copies issue
// back to back; the columns d .. LD - 1 are not written (the caller zeroes
// them once: zero_pad_columns). Otherwise load_chunk_f32's copies of `copy`
// floats over the columns 0 .. LD - 5, zeros past d.
template <int NT, int LD, int ROWS>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* __restrict__ src,
                                              int nrows, int d, int copy, uint32_t magic) {
    if (copy == 4) {
        constexpr int COPIES = (ROWS * ((LD - 4) / 4) + NT - 1) / NT;  // a thread's, at most
        const int total = ROWS * (d >> 2);
        const uint32_t at = smem_addr(dst) + 16 * threadIdx.x;  // before the row padding
        const uint32_t pad = 4 * (LD - d);                      // bytes of padding a row
        const float* from = src + 4 * threadIdx.x;
#pragma unroll
        for (int i = 0; i < COPIES; ++i) {
            const uint32_t chunk = threadIdx.x + NT * i;
            const int r = __umulhi(2u * chunk, magic);
            const bool in = r < nrows;
            if (chunk < uint32_t(total))
                cp_async_16(at + 16 * NT * i + r * pad, in ? from + 4 * NT * i : src, in ? 16 : 0);
        }
    } else {
        load_chunk_f32<NT, LD - 4, ROWS>(dst, src, nrows, d, 0, copy);
    }
}

// columns d .. LD-1 of `rows` shared fp32 rows: written once, no copy of
// load_tile_f32's 16-byte path touches them
template <int NT, int LD>
__device__ __forceinline__ void zero_pad_columns(float* tiles, int rows, int d) {
    for (int r = threadIdx.x; r < rows; r += NT)
        for (int c = d; c < LD; ++c) tiles[r * LD + c] = 0.f;
}

// (x, y) at columns col, col + 1 of an fp32 output row of d columns
__device__ __forceinline__ void store_pair_f32(float* row, int col, float x, float y, int d,
                                               bool pairs) {
    if (pairs) {  // d even and the row 8-byte aligned: col + 1 < d whenever col < d
        if (col < d) *reinterpret_cast<float2*>(row + col) = make_float2(x, y);
    } else {
        if (col < d) row[col] = x;
        if (col + 1 < d) row[col + 1] = y;
    }
}

}  // namespace
