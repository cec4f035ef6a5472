// Masked, non-causal flash attention, backward (dq, dk, dv), for Hopper (sm_90a).
//
// Replaces: the backward of the library Pallas TPU kernel that
// ptranking_tpu/ops/attention.py::flash_attention calls,
// jax.experimental.pallas.ops.tpu.flash_attention: _flash_attention_bwd_dkv
// (dk, dv) and _flash_attention_bwd_dq (dq), which recompute P from the
// forward's row statistics (l, m) and take di = rowsum(dO * O) from outside.
//
// For every (b, h), with q, k, v, dO: [B, H, N, d] contiguous (fp32 or bf16),
// row_max m, row_sum l and D = rowsum(dO * O): [B, H, N] fp32, and mask [B, N]
// one byte per key (nonzero = real):
//     x_ij  = q_i.k_j * scale for a real key j, the constant -1e9 for a masked one
//     P_ij  = exp(x_ij - m_i) / l_i
//     dP_ij = dO_i . v_j
//     dS_ij = P_ij * (dP_ij - D_i) for a real key, 0 for a masked one (its
//             logit does not depend on q or k)
//     dv_j  = sum_i P_ij dO_i,  dk_j = scale * sum_i dS_ij q_i,  dq_i = scale * sum_j dS_ij k_j
// with fp32 accumulation; dq, dk, dv are written in the input dtype.
//
// The forward's padding rules hold here too (flash_attn_fwd.cu): a key past N
// is left out (P = dS = 0) and a query row past N adds nothing and writes
// nothing. A query row whose keys are all masked has P = 1/N on every key
// (finite, as in the forward) and dS = 0, so its dq is 0 and it adds only
// finite P*dO terms to dv.
//
// Layout, FA2-style, no atomics (the same inputs give the same bits):
//   * the dk/dv kernels: one block per (b*h, 64-key tile); it loops over the
//     64-query tiles and accumulates its keys' dk and dv in registers;
//   * the dq kernels: one block per (b*h, 64-query tile); it loops over the
//     64-key tiles and accumulates its rows' dq in registers.
// The head dim is padded inside the kernels to a multiple of 16 (bf16) or of
// 8 (fp32; the pad columns are zero in shared memory).
//
// What bounds it: 8*B*H*N^2*d operations (dkdv: P recomputed, dP, dv, dk)
// plus 6*B*H*N^2*d (dq: P, dP, dq) over about 7*B*H*N*d values moved, far
// above the H100's bf16 ridge: arithmetic is the bound, so the products have
// to run on the tensor cores and nothing else may stand in their way. What
// stands in their way in this design is the shared-memory pipe: the ldmatrix
// reads (a warp owns only 16 rows, so every B fragment feeds one product) and
// the 8-byte tile copies (ptranking_tpu_torch/tools/kernel_variants.py
// times the kernels with each phase cut out: on an NVIDIA H100 80GB HBM3 at
// 700 W, at (32, 2, 1408, 68), dk/dv takes 0.391..0.397 ms and dq
// 0.265..0.267, and without the next tiles' copies 0.326..0.328 and
// 0.184..0.186; PERF.md keeps the runs).
//
// bf16 inputs: flash_bwd_dkdv_mma_kernel, flash_bwd_dq_mma_kernel.
//   * All four products are mma.sync.m16n8k16 (bf16 x bf16 -> fp32) with
//     operands read from shared memory by ldmatrix. 4 warps a block; a warp
//     owns 16 of the block's 64 keys (dk/dv) or 64 query rows (dq). (The
//     same kernels with wgmma products, experiments/flash_attn_bwd_wgmma.cu,
//     give the same bits and were not faster.)
//   * The dk/dv kernel computes the TRANSPOSED tiles S^T = K Q^T and
//     dP^T = V dO^T (rows = the warp's keys, columns = queries). The fp32
//     accumulator fragment of two adjacent 8-column tiles is, element for
//     element, the A-operand fragment of a 16-deep product: after the softmax
//     arithmetic on the fragment (fp32, with the key's flag of the thread's
//     two rows and m, 1/l, D of its columns), P^T and dS^T are rounded to
//     bf16 in registers and feed dv += P^T dO and dk += dS^T Q directly, with
//     B read from the same Q / dO tiles by ldmatrix.trans. The dq kernel does
//     the same untransposed: S = Q K^T, dP = dO V^T, dq += dS K. P and dS
//     never touch shared or device memory.
//   * Tiles stay bf16 in shared memory, rows padded to DP + 8 elements
//     (DP = 16*ceil(d/16)): every row starts 16-byte aligned, as ldmatrix
//     needs, and 8 consecutive rows fall into 8 different 16-byte bank groups
//     (the stride is an odd number of 16-byte units).
//   * The tiles a block loops over are double-buffered: tile t+1 is copied by
//     cp.async while tile t is multiplied, one __syncthreads a tile. A row of
//     d = 68 bf16 is 136 bytes, a multiple of 8 but not of 16, so the copies
//     are 8 bytes wide (d % 4 == 0 and 8-byte-aligned tensors; other shapes
//     take a scalar, synchronous copy into the same buffers). A thread's
//     copies of a tile are independent of each other (a chunk's row by a
//     multiply, a row past N zero-filled by the copy itself), so they issue
//     back to back. The next tile's row statistics (dk/dv) or key flags (dq)
//     are prefetched into registers and stored to the other buffer after the
//     arithmetic.
//   * The fragments, products and copies are those of the forward's
//     tensor-core kernel, from mma_common.cuh.
//   * Rounding: P and dS are rounded to bf16 before the second products, as
//     autograd through the plain blockwise attention rounds them; all sums
//     are fp32 and the outputs are rounded once at the store.
//
// Head dims above 128: flash_bwd_{dkdv,dq}_wide_mma_kernel (bf16), which
// split the outputs' head dim over the grid and stream the contractions over
// d (the section "d > 128: the bf16 wide kernels" below), and
// flash_bwd_{dkdv,dq}_wide_tf32_kernel (fp32, 3xTF32), a block for each 64
// rows and all of their output columns, S and dP once a loop tile (the
// section "fp32, d > 128"). Any d and any batch is taken: the kernels here
// take b*h from grid.y, so a batch past 65535 (b, h) pairs runs in several
// launches of whole lists; the wide kernels fold every axis into grid.x.
//
// Short lists: flash_bwd_packed_mma_kernel (bf16, any d), templated on its
// tile's rows. With 64 (entry flash_attn_bwd_packed, N <= 64) it puts 64 / N
// lists in one 64-row tile and writes dq, dk and dv of the tile in one
// launch (the section "the packed kernel" below); with 128 (the list kernel,
// entry flash_attn_bwd_list, N <= 128) one list of 65 .. 128 docs a block of
// 8 warps (the section "the list kernel"). Lists of 129 .. 256 docs:
// flash_bwd_long_mma_kernel (entry flash_attn_bwd_long), one list a block of
// 8 warps in two halves of 128 keys (the section "the long kernel"). The
// package routes the bf16 backward at d > 128 to the first at
// N <= PACK_MAX_N, to the second at N <= LIST_MAX_N and to the third at
// N <= LONG_MAX_N, in place of the wide pair (ops/attention.py's
// bwd_route); the kernels of d <= 128, the fp32 ones and the wide pair at
// longer lists keep their route.
//
// fp32 inputs: flash_bwd_dkdv_tf32_kernel, flash_bwd_dq_tf32_kernel, the
// bf16 pair's layout with every product in 3xTF32 on the tensor cores (each
// operand split into two TF32 halves, three TF32 products a product, summed
// in fp32: about fp32's accuracy, which the gradient checks and the
// checkpoint-resume checks rest on), the head dim padded to a multiple of 8
// (the section "fp32, head dims up to 128" below). At d > 128 the fp32 wide
// kernels (3xTF32, the section "fp32, d > 128") take lists of more than 256
// docs; fp32 lists of at most 64 docs
// take flash_bwd_packed_tf32_kernel (entry flash_attn_bwd_packed, dtype 0;
// the route at N <= F32_PACK_MAX_N), the packed kernel's three steps with
// every product in 3xTF32 on the tensor cores, which keeps about fp32's
// accuracy (the section "fp32, lists of at most 64 docs" below); fp32 lists
// of 65 .. 256 docs take flash_bwd_list_tf32_kernel, the same steps for one
// list a block of 8 warps in slices of 64 keys (entries flash_attn_bwd_list
// and flash_attn_bwd_long, dtype 0; the routes at N <= F32_LIST_MAX_N and
// N <= F32_LONG_MAX_N: the section "fp32, lists of 65 .. 256 docs").

#include <cuda_runtime.h>
#include <algorithm>
#include <math.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int MMA_WARPS = 4;            // warps a block
constexpr int MMA_NT = 32 * MMA_WARPS;  // threads a block
constexpr int OWN = 16 * MMA_WARPS;     // rows a block owns: keys (dk/dv) or query rows (dq)
constexpr int TILE = 64;                // rows of a tile it loops over: queries or keys
constexpr int SUB = 32;                 // columns of S / dP a warp holds in registers at a time

// The dk/dv kernels' arithmetic on a fragment of S^T and dP^T (rows = the
// thread's two keys with their flags, 8-column tiles j = queries): P^T and
// dS^T packed as the A operand of the next products, two adjacent tiles to
// one 16-deep step. st points at the statistics [m, 1/l, D][TILE] of the
// thread's first column (2 * (lane % 4) past the fragment's first query).
template <int NTILES>
__device__ __forceinline__ void p_ds_transposed(uint32_t (&pa)[NTILES / 2][4],
                                                uint32_t (&dsa)[NTILES / 2][4],
                                                const float (&s)[NTILES][4],
                                                const float (&dp)[NTILES][4], const float* st,
                                                const int (&flag)[2], float scale) {
#pragma unroll
    for (int j = 0; j < NTILES; ++j) {
        const float2 m2 = *reinterpret_cast<const float2*>(st + 8 * j);
        const float2 inv2 = *reinterpret_cast<const float2*>(st + TILE + 8 * j);
        const float2 D2 = *reinterpret_cast<const float2*>(st + 2 * TILE + 8 * j);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const bool real = flag[h] == KEY_REAL, in = flag[h] != KEY_OUT;
            const float x0 = real ? s[j][2 * h] * scale : MASKED_LOGIT;
            const float x1 = real ? s[j][2 * h + 1] * scale : MASKED_LOGIT;
            // a query row past N has 1/l = 0 here and zero q, dO rows: P = dS = 0
            const float p0 = in ? __expf(x0 - m2.x) * inv2.x : 0.f;
            const float p1 = in ? __expf(x1 - m2.y) * inv2.y : 0.f;
            const float ds0 = real ? p0 * (dp[j][2 * h] - D2.x) : 0.f;
            const float ds1 = real ? p1 * (dp[j][2 * h + 1] - D2.y) : 0.f;
            pa[j >> 1][(j & 1) * 2 + h] = pack_bf16(p0, p1);
            dsa[j >> 1][(j & 1) * 2 + h] = pack_bf16(ds0, ds1);
        }
    }
}

// The dq kernels' arithmetic on a fragment of S and dP (rows = the thread's
// two query rows with m, 1/l, D; 8-column tiles j = keys): dS packed as the
// next product's A operand. kf points at the flag of the thread's first key.
// Masked and out-of-range keys: dS = 0.
template <int NTILES>
__device__ __forceinline__ void ds_fragment(uint32_t (&dsa)[NTILES / 2][4],
                                            const float (&s)[NTILES][4],
                                            const float (&dp)[NTILES][4], const int* kf,
                                            const float (&m)[2], const float (&inv)[2],
                                            const float (&D)[2], float scale) {
#pragma unroll
    for (int j = 0; j < NTILES; ++j) {
        const int2 f2 = *reinterpret_cast<const int2*>(kf + 8 * j);
        const bool real0 = f2.x == KEY_REAL, real1 = f2.y == KEY_REAL;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const float p0 = __expf(s[j][2 * h] * scale - m[h]) * inv[h];
            const float p1 = __expf(s[j][2 * h + 1] * scale - m[h]) * inv[h];
            const float ds0 = real0 ? p0 * (dp[j][2 * h] - D[h]) : 0.f;
            const float ds1 = real1 ? p1 * (dp[j][2 * h + 1] - D[h]) : 0.f;
            dsa[j >> 1][(j & 1) * 2 + h] = pack_bf16(ds0, ds1);
        }
    }
}

// two [OWN][LDS] and four [TILE][LDS] bf16 tiles, and 6*TILE 4-byte values
// (row statistics or key flags)
__host__ __device__ constexpr size_t mma_smem_bytes(int kc) {
    return size_t(2 * OWN + 4 * TILE) * (16 * kc + 8) * sizeof(bf16) + size_t(6) * TILE * 4;
}

// blocks an SM that the register budget is cut for: the accumulators grow with KC
__host__ __device__ constexpr int mma_min_blocks(int kc) { return kc <= 5 ? 3 : 2; }

template <int KC>
__global__ void __launch_bounds__(MMA_NT, mma_min_blocks(KC))
flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ row_max, const float* __restrict__ row_sum,
                          const float* __restrict__ dsum, const uint8_t* __restrict__ mask,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int N, int d,
                          float scale, int how) {
    constexpr int LDS = 16 * KC + 8;
    constexpr int TILE_ELEMS = TILE * LDS;
    extern __shared__ uint4 smem_mma[];
    bf16* Ks = reinterpret_cast<bf16*>(smem_mma);  // the block's keys, resident
    bf16* Vs = Ks + OWN * LDS;
    bf16* Qs = Vs + OWN * LDS;                     // two buffers each
    bf16* dOs = Qs + 2 * TILE_ELEMS;
    float* stats = reinterpret_cast<float*>(dOs + 2 * TILE_ELEMS);  // [2][m, 1/l, D][TILE]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    const int bh = blockIdx.y;
    const int b = bh / H;
    const int k0 = blockIdx.x * OWN;
    const size_t base = size_t(bh) * N * d;
    const size_t stat = size_t(bh) * N;
    const int krows = min(OWN, N - k0);
    const bool copy_8b = how & COPY_8B;
    const uint32_t magic = copy_magic(d);

    zero_pad_columns<MMA_NT, LDS>(Ks, 2 * OWN + 4 * TILE, d);
    load_tile<MMA_NT, KC, OWN>(Ks, k + base + size_t(k0) * d, krows, d, copy_8b, magic);
    load_tile<MMA_NT, KC, OWN>(Vs, v + base + size_t(k0) * d, krows, d, copy_8b, magic);
    load_tile<MMA_NT, KC, TILE>(Qs, q + base, min(TILE, N), d, copy_8b, magic);
    load_tile<MMA_NT, KC, TILE>(dOs, dout + base, min(TILE, N), d, copy_8b, magic);
    cp_async_commit();
    if (tid < TILE) {
        const bool in = tid < N;
        stats[tid] = in ? row_max[stat + tid] : 0.f;
        stats[TILE + tid] = in ? 1.f / row_sum[stat + tid] : 0.f;  // l >= 1
        stats[2 * TILE + tid] = in ? dsum[stat + tid] : 0.f;
    }
    int flag[2];  // of the thread's two keys: rows g and g + 8 of the warp's 16
#pragma unroll
    for (int h = 0; h < 2; ++h)
        flag[h] = key_flag(mask + size_t(b) * N, k0 + warp * 16 + g + 8 * h, N);

    float acc_k[2 * KC][4], acc_v[2 * KC][4];
#pragma unroll
    for (int j = 0; j < 2 * KC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;

    cp_async_wait_all();
    __syncthreads();

    const int tiles = (N + TILE - 1) / TILE;
    for (int t = 0; t < tiles; ++t) {
        const int buf = t & 1;
        const bool more = t + 1 < tiles;
        // the next query tile: copies in flight, its statistics in registers
        float next_m = 0.f, next_l = 1.f, next_D = 0.f;
        bool next_in = false;
        if (more) {
            const int q1 = (t + 1) * TILE;
            const int nrows = min(TILE, N - q1);
            load_tile<MMA_NT, KC, TILE>(Qs + (buf ^ 1) * TILE_ELEMS, q + base + size_t(q1) * d,
                                        nrows, d, copy_8b, magic);
            load_tile<MMA_NT, KC, TILE>(dOs + (buf ^ 1) * TILE_ELEMS, dout + base + size_t(q1) * d,
                                        nrows, d, copy_8b, magic);
            cp_async_commit();
            next_in = tid < TILE && q1 + tid < N;
            if (next_in) {
                next_m = row_max[stat + q1 + tid];
                next_l = row_sum[stat + q1 + tid];
                next_D = dsum[stat + q1 + tid];
            }
        }

        const bf16* Qt = Qs + buf * TILE_ELEMS;
        const bf16* dOt = dOs + buf * TILE_ELEMS;
        const float* st = stats + buf * 3 * TILE;
#pragma unroll 1
        for (int sub = 0; sub < TILE; sub += SUB) {
            // S^T and dP^T: the warp's 16 keys x SUB queries
            float s[SUB / 8][4], dp[SUB / 8][4];
#pragma unroll
            for (int j = 0; j < SUB / 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
            uint32_t a[KC][4];
            load_a<KC>(a, Ks, warp * 16, lane);
            product_nk<KC, SUB / 8>(s, a, Qt, sub, lane);
            load_a<KC>(a, Vs, warp * 16, lane);
            product_nk<KC, SUB / 8>(dp, a, dOt, sub, lane);

            uint32_t pa[SUB / 16][4], dsa[SUB / 16][4];
            p_ds_transposed<SUB / 8>(pa, dsa, s, dp, st + sub + 2 * t4, flag, scale);
            product_kn<KC, SUB / 16>(acc_v, pa, dOt, sub, lane);   // dv += P^T dO
            product_kn<KC, SUB / 16>(acc_k, dsa, Qt, sub, lane);   // dk += dS^T Q
        }

        if (more && tid < TILE) {
            float* nx = stats + (buf ^ 1) * 3 * TILE;
            nx[tid] = next_m;
            nx[TILE + tid] = next_in ? 1.f / next_l : 0.f;
            nx[2 * TILE + tid] = next_D;
        }
        cp_async_wait_all();
        __syncthreads();  // tile t+1 has landed, and no warp reads tile t any more
    }

    const bool pairs = how & STORE_PAIRS;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + g + 8 * h;
        if (r >= krows) continue;
        bf16* dkrow = dk + base + size_t(k0 + r) * d;
        bf16* dvrow = dv + base + size_t(k0 + r) * d;
#pragma unroll
        for (int j = 0; j < 2 * KC; ++j) {
            const int col = 8 * j + 2 * t4;
            store_pair(dkrow, col, acc_k[j][2 * h] * scale, acc_k[j][2 * h + 1] * scale, d, pairs);
            store_pair(dvrow, col, acc_v[j][2 * h], acc_v[j][2 * h + 1], d, pairs);
        }
    }
}

template <int KC>
__global__ void __launch_bounds__(MMA_NT, mma_min_blocks(KC))
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ row_max, const float* __restrict__ row_sum,
                        const float* __restrict__ dsum, const uint8_t* __restrict__ mask,
                        bf16* __restrict__ dq, int H, int N, int d, float scale, int how) {
    constexpr int LDS = 16 * KC + 8;
    constexpr int TILE_ELEMS = TILE * LDS;
    extern __shared__ uint4 smem_mma[];
    bf16* Qs = reinterpret_cast<bf16*>(smem_mma);  // the block's query rows, read once
    bf16* dOs = Qs + OWN * LDS;
    bf16* Ks = dOs + OWN * LDS;                    // two buffers each
    bf16* Vs = Ks + 2 * TILE_ELEMS;
    int* kflag = reinterpret_cast<int*>(Vs + 2 * TILE_ELEMS);  // [2][TILE]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    const int bh = blockIdx.y;
    const int b = bh / H;
    const int q0 = blockIdx.x * OWN;
    const size_t base = size_t(bh) * N * d;
    const size_t stat = size_t(bh) * N;
    const int qrows = min(OWN, N - q0);
    const uint8_t* mask_row = mask + size_t(b) * N;
    const bool copy_8b = how & COPY_8B;
    const uint32_t magic = copy_magic(d);

    zero_pad_columns<MMA_NT, LDS>(Qs, 2 * OWN + 4 * TILE, d);
    load_tile<MMA_NT, KC, OWN>(Qs, q + base + size_t(q0) * d, qrows, d, copy_8b, magic);
    load_tile<MMA_NT, KC, OWN>(dOs, dout + base + size_t(q0) * d, qrows, d, copy_8b, magic);
    load_tile<MMA_NT, KC, TILE>(Ks, k + base, min(TILE, N), d, copy_8b, magic);
    load_tile<MMA_NT, KC, TILE>(Vs, v + base, min(TILE, N), d, copy_8b, magic);
    cp_async_commit();
    if (tid < TILE) kflag[tid] = key_flag(mask_row, tid, N);
    float m[2], inv[2], D[2];  // of the thread's two query rows: g and g + 8 of the warp's 16
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + g + 8 * h;
        const bool in = r < qrows;  // a row past N: zero q and dO rows, 1/l = 0, so dS = 0
        m[h] = in ? row_max[stat + q0 + r] : 0.f;
        inv[h] = in ? 1.f / row_sum[stat + q0 + r] : 0.f;  // l >= 1
        D[h] = in ? dsum[stat + q0 + r] : 0.f;
    }

    float acc[2 * KC][4];
#pragma unroll
    for (int j = 0; j < 2 * KC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

    cp_async_wait_all();
    __syncthreads();
    uint32_t aq[KC][4], ado[KC][4];  // the warp's Q and dO rows stay in registers
    load_a<KC>(aq, Qs, warp * 16, lane);
    load_a<KC>(ado, dOs, warp * 16, lane);

    const int tiles = (N + TILE - 1) / TILE;
    for (int t = 0; t < tiles; ++t) {
        const int buf = t & 1;
        const bool more = t + 1 < tiles;
        int next_flag = KEY_OUT;
        if (more) {  // the next key tile: copies in flight, its flags in a register
            const int k1 = (t + 1) * TILE;
            const int nrows = min(TILE, N - k1);
            load_tile<MMA_NT, KC, TILE>(Ks + (buf ^ 1) * TILE_ELEMS, k + base + size_t(k1) * d,
                                        nrows, d, copy_8b, magic);
            load_tile<MMA_NT, KC, TILE>(Vs + (buf ^ 1) * TILE_ELEMS, v + base + size_t(k1) * d,
                                        nrows, d, copy_8b, magic);
            cp_async_commit();
            if (tid < TILE) next_flag = key_flag(mask_row, k1 + tid, N);
        }

        const bf16* Kt = Ks + buf * TILE_ELEMS;
        const bf16* Vt = Vs + buf * TILE_ELEMS;
        const int* kf = kflag + buf * TILE;
#pragma unroll 1
        for (int sub = 0; sub < TILE; sub += SUB) {
            // S and dP: the warp's 16 query rows x SUB keys
            float s[SUB / 8][4], dp[SUB / 8][4];
#pragma unroll
            for (int j = 0; j < SUB / 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
            product_nk<KC, SUB / 8>(s, aq, Kt, sub, lane);
            product_nk<KC, SUB / 8>(dp, ado, Vt, sub, lane);

            uint32_t dsa[SUB / 16][4];
            ds_fragment<SUB / 8>(dsa, s, dp, kf + sub + 2 * t4, m, inv, D, scale);
            product_kn<KC, SUB / 16>(acc, dsa, Kt, sub, lane);  // dq += dS K
        }

        if (more && tid < TILE) kflag[(buf ^ 1) * TILE + tid] = next_flag;
        cp_async_wait_all();
        __syncthreads();  // tile t+1 has landed, and no warp reads tile t any more
    }

    const bool pairs = how & STORE_PAIRS;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + g + 8 * h;
        if (r >= qrows) continue;
        bf16* dqrow = dq + base + size_t(q0 + r) * d;
#pragma unroll
        for (int j = 0; j < 2 * KC; ++j)
            store_pair(dqrow, 8 * j + 2 * t4, acc[j][2 * h] * scale, acc[j][2 * h + 1] * scale, d,
                       pairs);
    }
}

// ---------------------------------------------------------------------------
// d > 128: the bf16 wide kernels
// ---------------------------------------------------------------------------
//
// As in flash_attn_fwd.cu: the kernels above keep d-wide tiles (and, in
// bf16, d-wide accumulators) per block, which at d = 384 exceeds the SM's
// registers and shared memory. The bf16 wide kernels split the OUTPUT's head
// dim over the grid: a block owns 64 rows (keys for dk/dv, query rows for dq)
// and one chunk of output columns, and streams the contractions of S and dP
// over d in 64-column chunks staged in shared memory. Every chunk-block of a
// row tile computes S, P, dP and dS with the same instructions in the same
// order, so the blocks agree bit for bit on them; each writes only its own
// columns. No atomics. Q, K, V and dO are read once per output chunk. grid.x
// folds (b*h, output chunk, 64-row tile) (mma_common.cuh's fold_wide). fp32
// at d > 128 takes the 3xTF32 wide kernels of the section "fp32, d > 128",
// whose blocks own every output column.
//
// What holds them (ptranking_tpu_torch/tools/kernel_variants.py on an NVIDIA
// H100 80GB HBM3 at 700 W; PERF.md): the chunk copies and the re-reads they
// stand for. At (256, 2, 128, 350) bf16 dk/dv takes 1.84 ms and dq 1.47 ms
// against byte bounds of 0.082 and 0.069 ms; at d = 384 (16-byte copies)
// 0.75 and 0.56 ms. The copies unrolled by 4 rather than not at all save a
// quarter (2.51 / 2.09 ms at d = 350); fully unrolled, both kernels spill.
// dk/dv keeps 64-column chunks: its two accumulators with S and dP in
// registers spill at 128 (and gain nothing); dq takes 128 (1.70 ms at 64).
// At lists of 16 to 64 docs a block fills N of its 64 rows and each of the 9
// output-chunk blocks of d = 350 re-reads the inputs: 5.53 ms for the pair
// at 16 docs against SDPA's 0.89..1.06. The bf16 backward there runs the
// packed kernel below instead, at 65 .. 128 docs the list kernel and at
// 129 .. 256 the long kernel; the pair stays the route above LONG_MAX_N docs.

constexpr int DCH = 64;     // columns of a d-chunk of the S and dP products
// 16-column steps of the bf16 kernels' output chunks: 128 columns for dq; 64
// for dk and dv, whose two accumulators and two products (S, dP) would
// otherwise spill
constexpr int WIDE_CW_DQ = 8, WIDE_CW_DKDV = 4;

// bf16: two stages of four d-chunk tiles ([64][72]: the block's rows twice,
// the loop's tile twice), two stages of the two output-chunk tiles of the
// loop's tile ([TILE][16*CW + 8]), and 6*TILE 4-byte values (row statistics or
// key flags)
__host__ __device__ constexpr size_t wide_mma_smem_bytes(int cw) {
    return (size_t(2) * 4 * 64 * (DCH + 8) + size_t(2) * 2 * TILE * (16 * cw + 8)) * sizeof(bf16)
           + size_t(6) * TILE * 4;
}

// dk, dv of a block's 64 keys and output chunk: for each 64-query tile t, the
// stages (t, d-chunk c) accumulate S^T = K Q^T and dP^T = V dO^T over d, the
// first stage of a tile also brings its Q and dO columns of the output chunk
// and its row statistics; after the last, flash_bwd_dkdv_mma_kernel's
// arithmetic on the fragments and its two products into the chunk's dk, dv.
template <int CW>
__global__ void __launch_bounds__(MMA_NT, 2)
flash_bwd_dkdv_wide_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, const bf16* __restrict__ dout,
                               const float* __restrict__ row_max,
                               const float* __restrict__ row_sum, const float* __restrict__ dsum,
                               const uint8_t* __restrict__ mask, bf16* __restrict__ dk,
                               bf16* __restrict__ dv, int H, int N, int d, float scale, int copy,
                               int how) {
    constexpr int KS = DCH / 16;
    constexpr int LDC = DCH + 8;
    constexpr int LDO = 16 * CW + 8;
    constexpr int CHUNK = 64 * LDC;
    constexpr int STAGE = 4 * CHUNK;      // K, V (the block's keys), Q, dO (the query tile)
    constexpr int OUT = 2 * TILE * LDO;   // Q, dO of the tile, the output chunk's columns
    extern __shared__ uint4 smem_mma[];
    bf16* Cs = reinterpret_cast<bf16*>(smem_mma);  // [2][STAGE]
    bf16* Os = Cs + 2 * STAGE;                     // [2][OUT]
    float* stats = reinterpret_cast<float*>(Os + 2 * OUT);  // [2][m, 1/l, D][TILE]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    int oc, bh;
    const int k0 = fold_wide(N, d, 16 * CW, oc, bh);
    const int c0 = oc * 16 * CW;
    const int b = bh / H;
    const size_t base = size_t(bh) * N * d;
    const size_t stat = size_t(bh) * N;
    const int krows = min(OWN, N - k0);
    const int chunks = (d + DCH - 1) / DCH;
    const int stages = ((N + TILE - 1) / TILE) * chunks;

    auto prefetch = [&](int st) {
        const int t = st / chunks, c = st - t * chunks;
        const int q1 = t * TILE, nrows = min(TILE, N - q1);
        bf16* cs = Cs + (st & 1) * STAGE;
        load_chunk<MMA_NT, KS, OWN>(cs, k + base + size_t(k0) * d, krows, d, c * DCH, copy);
        load_chunk<MMA_NT, KS, OWN>(cs + CHUNK, v + base + size_t(k0) * d, krows, d, c * DCH, copy);
        load_chunk<MMA_NT, KS, TILE>(cs + 2 * CHUNK, q + base + size_t(q1) * d, nrows, d, c * DCH,
                                     copy);
        load_chunk<MMA_NT, KS, TILE>(cs + 3 * CHUNK, dout + base + size_t(q1) * d, nrows, d,
                                     c * DCH, copy);
        if (c == 0) {
            bf16* os = Os + (t & 1) * OUT;
            load_chunk<MMA_NT, CW, TILE>(os, q + base + size_t(q1) * d, nrows, d, c0, copy);
            load_chunk<MMA_NT, CW, TILE>(os + TILE * LDO, dout + base + size_t(q1) * d, nrows, d,
                                         c0, copy);
            if (tid < TILE) {
                float* nx = stats + (t & 1) * 3 * TILE;
                const bool in = tid < nrows;
                nx[tid] = in ? row_max[stat + q1 + tid] : 0.f;
                nx[TILE + tid] = in ? 1.f / row_sum[stat + q1 + tid] : 0.f;  // l >= 1
                nx[2 * TILE + tid] = in ? dsum[stat + q1 + tid] : 0.f;
            }
        }
        cp_async_commit();
    };

    int flag[2];  // of the thread's two keys: rows g and g + 8 of the warp's 16
#pragma unroll
    for (int h = 0; h < 2; ++h)
        flag[h] = key_flag(mask + size_t(b) * N, k0 + warp * 16 + g + 8 * h, N);
    float acc_k[2 * CW][4], acc_v[2 * CW][4];
#pragma unroll
    for (int j = 0; j < 2 * CW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;
    float s[TILE / 8][4], dp[TILE / 8][4];

    prefetch(0);
    for (int st = 0; st < stages; ++st) {
        const int t = st / chunks, c = st - t * chunks;
        if (st + 1 < stages) {
            prefetch(st + 1);
            cp_async_wait_prior();
        } else {
            cp_async_wait_all();
        }
        __syncthreads();  // stage st has landed
        if (c == 0) {
#pragma unroll
            for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
        }
        const bf16* cs = Cs + (st & 1) * STAGE;
        uint32_t a[KS][4];
        load_a<KS>(a, cs, warp * 16, lane);
        product_nk<KS, TILE / 8>(s, a, cs + 2 * CHUNK, 0, lane);
        load_a<KS>(a, cs + CHUNK, warp * 16, lane);
        product_nk<KS, TILE / 8>(dp, a, cs + 3 * CHUNK, 0, lane);
        if (c == chunks - 1) {
            const bf16* os = Os + (t & 1) * OUT;
            uint32_t pa[TILE / 16][4], dsa[TILE / 16][4];
            p_ds_transposed<TILE / 8>(pa, dsa, s, dp, stats + (t & 1) * 3 * TILE + 2 * t4, flag,
                                      scale);
            product_kn<CW, TILE / 16>(acc_v, pa, os + TILE * LDO, 0, lane);  // dv += P^T dO
            product_kn<CW, TILE / 16>(acc_k, dsa, os, 0, lane);             // dk += dS^T Q
        }
        __syncthreads();  // no warp reads stage st's buffers any more
    }

    const bool pairs = how & STORE_PAIRS;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + g + 8 * h;
        if (r >= krows) continue;
        bf16* dkrow = dk + base + size_t(k0 + r) * d;
        bf16* dvrow = dv + base + size_t(k0 + r) * d;
#pragma unroll
        for (int j = 0; j < 2 * CW; ++j) {
            const int col = c0 + 8 * j + 2 * t4;
            store_pair(dkrow, col, acc_k[j][2 * h] * scale, acc_k[j][2 * h + 1] * scale, d, pairs);
            store_pair(dvrow, col, acc_v[j][2 * h], acc_v[j][2 * h + 1], d, pairs);
        }
    }
}

// dq of a block's 64 query rows and output chunk: for each 64-key tile, the
// stages accumulate S = Q K^T and dP = dO V^T over d; the first stage of a
// tile also brings its K columns of the output chunk and its key flags; after
// the last, flash_bwd_dq_mma_kernel's arithmetic and dq += dS K.
template <int CW>
__global__ void __launch_bounds__(MMA_NT, 2)
flash_bwd_dq_wide_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const bf16* __restrict__ dout,
                             const float* __restrict__ row_max, const float* __restrict__ row_sum,
                             const float* __restrict__ dsum, const uint8_t* __restrict__ mask,
                             bf16* __restrict__ dq, int H, int N, int d, float scale, int copy,
                             int how) {
    constexpr int KS = DCH / 16;
    constexpr int LDC = DCH + 8;
    constexpr int LDO = 16 * CW + 8;
    constexpr int CHUNK = 64 * LDC;
    constexpr int STAGE = 4 * CHUNK;  // Q, dO (the block's rows), K, V (the key tile)
    constexpr int OUT = TILE * LDO;   // K of the tile, the output chunk's columns
    extern __shared__ uint4 smem_mma[];
    bf16* Cs = reinterpret_cast<bf16*>(smem_mma);  // [2][STAGE]
    bf16* Os = Cs + 2 * STAGE;                     // [2][OUT]
    int* kflag = reinterpret_cast<int*>(Os + 2 * OUT);  // [2][TILE]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    int oc, bh;
    const int q0 = fold_wide(N, d, 16 * CW, oc, bh);
    const int c0 = oc * 16 * CW;
    const int b = bh / H;
    const size_t base = size_t(bh) * N * d;
    const size_t stat = size_t(bh) * N;
    const int qrows = min(OWN, N - q0);
    const uint8_t* mask_row = mask + size_t(b) * N;
    const int chunks = (d + DCH - 1) / DCH;
    const int stages = ((N + TILE - 1) / TILE) * chunks;

    auto prefetch = [&](int st) {
        const int t = st / chunks, c = st - t * chunks;
        const int k1 = t * TILE, nrows = min(TILE, N - k1);
        bf16* cs = Cs + (st & 1) * STAGE;
        load_chunk<MMA_NT, KS, OWN>(cs, q + base + size_t(q0) * d, qrows, d, c * DCH, copy);
        load_chunk<MMA_NT, KS, OWN>(cs + CHUNK, dout + base + size_t(q0) * d, qrows, d, c * DCH,
                                    copy);
        load_chunk<MMA_NT, KS, TILE>(cs + 2 * CHUNK, k + base + size_t(k1) * d, nrows, d, c * DCH,
                                     copy);
        load_chunk<MMA_NT, KS, TILE>(cs + 3 * CHUNK, v + base + size_t(k1) * d, nrows, d, c * DCH,
                                     copy);
        if (c == 0) {
            load_chunk<MMA_NT, CW, TILE>(Os + (t & 1) * OUT, k + base + size_t(k1) * d, nrows, d,
                                         c0, copy);
            if (tid < TILE) kflag[(t & 1) * TILE + tid] = key_flag(mask_row, k1 + tid, N);
        }
        cp_async_commit();
    };

    float m[2], inv[2], D[2];  // of the thread's two query rows: g and g + 8 of the warp's 16
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + g + 8 * h;
        const bool in = r < qrows;  // a row past N: zero q and dO rows, 1/l = 0, so dS = 0
        m[h] = in ? row_max[stat + q0 + r] : 0.f;
        inv[h] = in ? 1.f / row_sum[stat + q0 + r] : 0.f;
        D[h] = in ? dsum[stat + q0 + r] : 0.f;
    }
    float acc[2 * CW][4];
#pragma unroll
    for (int j = 0; j < 2 * CW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    float s[TILE / 8][4], dp[TILE / 8][4];

    prefetch(0);
    for (int st = 0; st < stages; ++st) {
        const int t = st / chunks, c = st - t * chunks;
        if (st + 1 < stages) {
            prefetch(st + 1);
            cp_async_wait_prior();
        } else {
            cp_async_wait_all();
        }
        __syncthreads();  // stage st has landed
        if (c == 0) {
#pragma unroll
            for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
        }
        const bf16* cs = Cs + (st & 1) * STAGE;
        uint32_t a[KS][4];
        load_a<KS>(a, cs, warp * 16, lane);
        product_nk<KS, TILE / 8>(s, a, cs + 2 * CHUNK, 0, lane);
        load_a<KS>(a, cs + CHUNK, warp * 16, lane);
        product_nk<KS, TILE / 8>(dp, a, cs + 3 * CHUNK, 0, lane);
        if (c == chunks - 1) {
            uint32_t dsa[TILE / 16][4];
            ds_fragment<TILE / 8>(dsa, s, dp, kflag + (t & 1) * TILE + 2 * t4, m, inv, D, scale);
            product_kn<CW, TILE / 16>(acc, dsa, Os + (t & 1) * OUT, 0, lane);  // dq += dS K
        }
        __syncthreads();  // no warp reads stage st's buffers any more
    }

    const bool pairs = how & STORE_PAIRS;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + g + 8 * h;
        if (r >= qrows) continue;
        bf16* dqrow = dq + base + size_t(q0 + r) * d;
#pragma unroll
        for (int j = 0; j < 2 * CW; ++j)
            store_pair(dqrow, c0 + 8 * j + 2 * t4, acc[j][2 * h] * scale,
                       acc[j][2 * h + 1] * scale, d, pairs);
    }
}

// ---------------------------------------------------------------------------
// bf16, lists of at most 64 docs: the packed kernel
// ---------------------------------------------------------------------------
//
// At N <= 64 a wide block fills N of its 64 rows and N of its 64 keys, and
// each of its output chunks recomputes S and dP over the whole d. Here
// p = 64 / N consecutive (b, h) lists share one 64-row tile: q, k, v and dO
// are [B*H*N, d] row-major, so tile t is the contiguous span of rows
// t*p*N .. t*p*N + p*N - 1 (fewer in the last tile when B*H % p != 0; rows
// p*N .. 63 stay empty when N does not divide 64). A list attends only to
// itself, so the tile is closed under attention, and one block computes dq,
// dk and dv of all its rows in one launch, with no atomics:
//   1. S = Q K^T and dP = dO V^T (64 x 64, fp32; a warp's 16 query rows by all
//      64 keys) accumulated over d in 64-column chunks, double-buffered
//      through shared memory like the wide kernels;
//   2. P and dS on the fragments, with flash_bwd_dq_mma_kernel's arithmetic
//      and one more rule: a key of ANOTHER list of the tile is left out
//      (P = dS = 0), not masked to -1e9. (The row statistics come from the
//      unpacked forward, whose l sums over the list's own N keys: a list with
//      no real key has m = -1e9 and P = 1/l on its own masked keys, and would
//      put the same 1/l on every other list's keys if they were only masked.)
//      P and dS are rounded to bf16 and stored as [64][72] tiles: dk and dv
//      contract over the query rows, which span the warps;
//   3. for each 64-column output chunk: dv = P^T dO, dk = scale * dS^T Q
//      (ldmatrix.trans of the P and dS tiles gives the A fragments of P^T
//      and dS^T for the warp's 16 keys) and dq = scale * dS K (dS of the
//      warp's own rows, still in registers), from the chunk's columns of
//      Q, dO and K: with KEEP, step 1's chunks kept in shared memory (d up
//      to 448, one block an SM); past that, re-read into the same double
//      buffer (mostly L2 hits: the block read the same rows in step 1).
// A row of d = 350 is 700 bytes, so the chunk copies are 4 bytes wide; at
// d = 352 (16-byte copies, the same work) the kernel takes half the time.
// STAGED (off: PACK_STAGED) brings the kept Q, K and dO by a staging copy
// instead: the tile is contiguous, so each 16-row quarter, a span of 32*d
// bytes, lands by 16-byte cp.async in a buffer (the P and dS tiles, then the
// V stage buffers, in turn) and is moved 4 bytes at a time into the chunk
// tiles. Its twelve rounds run before step 1, and it was slower
// (tools/kernel_variants.py, PERF.md).
// What bounds it: bytes. It reads Q, K, V, dO once from device memory and
// writes dq, dk, dv once (7 values a row and column, plus 3 statistics a
// row); the products, those on the zeros of other lists included, are
// 14 * 64 * 64 * d operations a tile, an order below the tensor cores' ridge.
// On an NVIDIA H100 80GB HBM3 at 700 W (PERF.md): 0.41 ms at (2048, 2, 16,
// 350) against a byte bound of 0.096 ms and the wide pair's 5.46 ms; 0.23 ms
// at d = 384 against 0.105.

constexpr int PACK_ROWS = 64;  // rows of a packed tile: query rows and keys alike
constexpr int PACK_NT = 2 * PACK_ROWS;  // threads: a warp for each 16 rows
constexpr int LIST_ROWS = 128;  // rows of the list kernel's tile (the section below)
// the packed kernel's output chunk (16-column steps); whether step 3's
// inputs are kept from step 1 where they fit (else re-read), and whether the
// kept Q, K and dO are staged where the tiles allow it (launch_bwd_packed);
// the list kernel's output chunk, and whether it computes S and dP in two
// 64-key halves (each over the whole d) instead of one pass over its 128
// keys: tools/kernel_variants.py times each turned the other way
constexpr int PACK_CW = 4;
constexpr bool PACK_KEEP = true;
constexpr bool PACK_STAGED = false;
constexpr int LIST_CW = 4;
constexpr bool LIST_HALVES = false;
constexpr int PACK_LAND_ROWS = 16;  // rows of a staged span

// The packed kernel's arithmetic on a fragment of S and dP (rows = the
// thread's two query rows with their list in the tile, m, 1/l, D; 8-column
// tiles j = keys): P and dS packed as A operands, two adjacent tiles to one
// 16-deep step. ki points at the key info of the thread's first key: its list
// in the tile << 2 | its flag (key_flag), or -1 past the tile's rows; a row
// past them has list -2. A key of another list: P = dS = 0; a masked key of
// the row's own list: logit -1e9, dS = 0.
template <int NTILES>
__device__ __forceinline__ void p_ds_packed(uint32_t (&pa)[NTILES / 2][4],
                                            uint32_t (&dsa)[NTILES / 2][4],
                                            const float (&s)[NTILES][4],
                                            const float (&dp)[NTILES][4], const int* ki,
                                            const int (&seg)[2], const float (&m)[2],
                                            const float (&inv)[2], const float (&D)[2],
                                            float scale) {
#pragma unroll
    for (int j = 0; j < NTILES; ++j) {
        const int2 f = *reinterpret_cast<const int2*>(ki + 8 * j);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const bool same0 = (f.x >> 2) == seg[h], same1 = (f.y >> 2) == seg[h];
            const bool real0 = same0 && (f.x & 3) == KEY_REAL;
            const bool real1 = same1 && (f.y & 3) == KEY_REAL;
            const float x0 = real0 ? s[j][2 * h] * scale : MASKED_LOGIT;
            const float x1 = real1 ? s[j][2 * h + 1] * scale : MASKED_LOGIT;
            const float p0 = same0 ? __expf(x0 - m[h]) * inv[h] : 0.f;
            const float p1 = same1 ? __expf(x1 - m[h]) * inv[h] : 0.f;
            const float ds0 = real0 ? p0 * (dp[j][2 * h] - D[h]) : 0.f;
            const float ds1 = real1 ? p1 * (dp[j][2 * h + 1] - D[h]) : 0.f;
            pa[j >> 1][(j & 1) * 2 + h] = pack_bf16(p0, p1);
            dsa[j >> 1][(j & 1) * 2 + h] = pack_bf16(ds0, ds1);
        }
    }
}

// The A fragments of T^T for its 16 rows from col0 (columns col0 .. col0 + 15
// of T) and all KC 16-deep steps over T's rows, T a [16*KC][LDS] bf16 tile:
// ldmatrix.trans of T's 8 x 8 blocks.
template <int KC, int LDS>
__device__ __forceinline__ void load_a_trans(uint32_t (&a)[KC][4], const bf16* tile, int col0,
                                             int lane) {
    // matrices: (T rows 0-7, columns 0-7), (rows 0-7, columns 8-15), (rows 8-15,
    // columns 0-7), (rows 8-15, columns 8-15): transposed, a[0] .. a[3]
    const uint32_t addr = smem_addr(tile + ((lane & 7) + ((lane >> 4) << 3)) * LDS + col0
                                    + (((lane >> 3) & 1) << 3));
#pragma unroll
    for (int ks = 0; ks < KC; ++ks) ldmatrix_x4_trans(a[ks], addr + ks * 16 * LDS * 2);
}

// STAGED: rows < nrows of the contiguous [*, d] tiles at q, k, dout (16-byte
// aligned, d even) into the kept chunk tiles at Rs ([Q, K, dO][chunks][64]
// [LDC]), zeros in their rows past nrows and columns past d. The twelve
// 16-row spans (4 a tensor) land by 16-byte cp.async in the buffers at
// land0 and land1 in turn (each at least 16 * d elements), the next span's
// copies in flight while the last one is moved on, 4 bytes a thread.
template <int CHUNK, int LDC>
__device__ __forceinline__ void stage_kept(bf16* Rs, bf16* land0, bf16* land1,
                                           const bf16* __restrict__ q, const bf16* __restrict__ k,
                                           const bf16* __restrict__ dout, int nrows, int d,
                                           int chunks) {
    const int tid = threadIdx.x, half_d = d >> 1;
    constexpr int SPANS = PACK_ROWS / PACK_LAND_ROWS;
    auto land = [&](int i) {  // span i % SPANS of tensor i / SPANS
        const bf16* t = i < SPANS ? q : i < 2 * SPANS ? k : dout;
        const int r0 = (i % SPANS) * PACK_LAND_ROWS;
        const int bytes = 2 * d * max(min(PACK_LAND_ROWS, nrows - r0), 0);
        const char* src = reinterpret_cast<const char*>(t + size_t(r0) * d);
        const uint32_t dst = smem_addr(i & 1 ? land1 : land0);
        for (int u = 16 * tid; u < bytes; u += 16 * PACK_NT)
            cp_async_16(dst + u, src + u, min(16, bytes - u));
        cp_async_commit();
    };
    land(0);
    // zeros where no span writes: the last chunk (its columns past d), and
    // every chunk's rows past nrows
    for (int t = 0; t < 3; ++t)
        for (int c = 0; c < chunks; ++c) {
            uint32_t* tile = reinterpret_cast<uint32_t*>(Rs + (t * chunks + c) * CHUNK);
            for (int i = (c == chunks - 1 ? 0 : nrows * LDC / 2) + tid; i < CHUNK / 2;
                 i += PACK_NT)
                tile[i] = 0u;
        }
    for (int i = 0; i < 3 * SPANS; ++i) {
        if (i + 1 < 3 * SPANS) {
            land(i + 1);
            cp_async_wait_prior();
        } else {
            cp_async_wait_all();
        }
        __syncthreads();  // span i has landed; the zeros are written
        const uint32_t* from = reinterpret_cast<const uint32_t*>(i & 1 ? land1 : land0);
        bf16* to = Rs + (i / SPANS) * chunks * CHUNK;
        const int r0 = (i % SPANS) * PACK_LAND_ROWS;
        const int rows = min(PACK_LAND_ROWS, nrows - r0);
        for (int r = 0; r < rows; ++r)
            for (int p = tid; p < half_d; p += PACK_NT) {
                const int col = 2 * p;
                *reinterpret_cast<uint32_t*>(to + (col >> 6) * CHUNK + (r0 + r) * LDC
                                             + (col & 63)) = from[r * half_d + p];
            }
        __syncthreads();  // no thread reads span i's buffer any more
    }
}

// P and dS tiles ([rows][rows + 8]), the stage buffers (two; a stage holds
// step 1's four d-chunk tiles or step 3's three output-chunk tiles; with KEEP
// only V's chunk), with KEEP the Q, K and dO chunks of the whole d, and the
// key info of `rows` keys
constexpr size_t packed_smem_bytes(int rows, int cw, bool keep, int chunks) {
    const size_t chunk = size_t(rows) * (DCH + 8), out = size_t(rows) * (16 * cw + 8);
    const size_t stage = keep ? chunk : (4 * chunk > 3 * out ? 4 * chunk : 3 * out);
    return (2 * size_t(rows) * (rows + 8) + 2 * stage + (keep ? 3 * size_t(chunks) * chunk : 0))
               * sizeof(bf16) + rows * sizeof(int);
}

// ---------------------------------------------------------------------------
// bf16, lists of 65 .. 128 docs: the list kernel
// ---------------------------------------------------------------------------
//
// At 65 .. 128 docs the wide pair takes two launches: dk/dv in 64-column
// output chunks (6 at d = 350), each block recomputing S^T and dP^T over the
// whole d, and dq in 128-column chunks (3), recomputing S and dP again: per
// list, S and dP are computed about 9 times and Q, K, V, dO read as often.
// The list kernel is the packed kernel's three steps on a 128-row tile, one
// list a block (128 / N lists at N <= 64), 8 warps of 16 rows:
//   1. S and dP (the warp's 16 query rows by all 128 keys, 128 fp32 values a
//      thread) once a list over d in double-buffered 64-column chunks of Q,
//      K, V and dO; with LIST_HALVES in two passes of 64 keys, each over d
//      again (half the registers, Q and dO read twice);
//   2. P and dS on the fragments (p_ds_packed), rounded to bf16 and stored as
//      [128][136] tiles;
//   3. for each 64-column output chunk, its Q, dO and K columns re-read
//      (mostly L2 hits: the block read them in step 1; keeping step 1's
//      chunks of all of d would need 3 * 6 * 18,432 bytes at d = 350 beside
//      the P and dS tiles, past the 232,448 a block may have), then
//      dv = P^T dO, dk = scale * dS^T Q (ldmatrix.trans of the P and dS
//      tiles gives the A fragments of P^T and dS^T for the warp's 16 keys)
//      and dq = scale * dS K (the warp's rows of the dS tile), one product at
//      a time, each from fragments read anew from the tiles.
// Shared memory: the P and dS tiles (69,632 bytes) and two stages of four
// [128][72] chunk tiles (147,456), 217,600 bytes with the key info: one
// block an SM. What bounds it: bytes, as the packed kernel. On an NVIDIA
// H100 80GB HBM3 at 700 W (PERF.md): 0.47 ms at (256, 2, 128, 350) against
// a byte bound of 0.096 ms and the wide pair's 3.30; 0.27 ms at d = 384.
//
// ROWS = PACK_ROWS: the packed kernel; ROWS = LIST_ROWS: the list kernel.
template <int ROWS, int CW, bool KEEP, bool STAGED>
__global__ void __launch_bounds__(2 * ROWS, ROWS == PACK_ROWS ? 2 : 1)
flash_bwd_packed_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const bf16* __restrict__ dout,
                            const float* __restrict__ row_max, const float* __restrict__ row_sum,
                            const float* __restrict__ dsum, const uint8_t* __restrict__ mask,
                            bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                            int lists, int H, int N, int d, float scale, int copy, int how) {
    static_assert(!KEEP || CW == DCH / 16, "kept chunks serve as the output chunks");
    static_assert(!KEEP || ROWS == PACK_ROWS, "the list kernel re-reads step 3's inputs");
    static_assert(!STAGED || KEEP, "Q, K and dO are staged into the kept chunks");
    constexpr int NTH = 2 * ROWS;  // threads: a warp for each 16 rows
    constexpr int PASSES = ROWS == LIST_ROWS && LIST_HALVES ? 2 : 1;
    constexpr int KEYS = ROWS / PASSES;  // keys of S and dP a pass of step 1
    constexpr int KS = DCH / 16;
    constexpr int LDC = DCH + 8;
    constexpr int LDO = 16 * CW + 8;
    constexpr int LDP = ROWS + 8;  // row stride of the P and dS tiles
    constexpr int CHUNK = ROWS * LDC;
    constexpr int OUT = ROWS * LDO;
    constexpr int STAGE = KEEP ? CHUNK : (4 * CHUNK > 3 * OUT ? 4 * CHUNK : 3 * OUT);
    extern __shared__ uint4 smem_mma[];
    bf16* Ps = reinterpret_cast<bf16*>(smem_mma);  // [ROWS query rows][LDP]
    bf16* dSs = Ps + ROWS * LDP;
    bf16* Cs = dSs + ROWS * LDP;                   // [2][STAGE]
    bf16* Rs = Cs + 2 * STAGE;                     // KEEP: [Q, K, dO][chunks][CHUNK]
    const int chunks = (d + DCH - 1) / DCH;
    const int out_chunks = (d + 16 * CW - 1) / (16 * CW);
    int* kinfo = reinterpret_cast<int*>(Rs + (KEEP ? 3 * chunks * CHUNK : 0));

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    const int per_tile = ROWS / N;
    const int l0 = blockIdx.x * per_tile;  // the tile's first (b, h) list
    const int nrows = min(per_tile, lists - l0) * N;
    const size_t row0 = size_t(l0) * N;
    const size_t base = row0 * d;

    // stage st < PASSES * chunks: step 1's d-chunk of Q, dO (every row) and
    // of K, V (the pass's keys); st >= PASSES * chunks: step 3's output chunk
    // of Q, dO, K (nothing with KEEP)
    auto prefetch = [&](int st) {
        bf16* cs = Cs + (st & 1) * STAGE;
        if (st < PASSES * chunks) {
            const int pass = PASSES == 1 ? 0 : st / chunks;
            const int c0 = (st - pass * chunks) * DCH;
            const size_t kbase = base + size_t(pass) * KEYS * d;
            const int krows = PASSES == 1 ? nrows : min(max(nrows - pass * KEYS, 0), KEYS);
            if (!STAGED) {
                load_chunk<NTH, KS, ROWS>(KEEP ? Rs + st * CHUNK : cs, q + base, nrows, d, c0,
                                          copy);
                load_chunk<NTH, KS, KEYS>(KEEP ? Rs + (chunks + st) * CHUNK : cs + CHUNK,
                                          k + kbase, krows, d, c0, copy);
                load_chunk<NTH, KS, ROWS>(KEEP ? Rs + (2 * chunks + st) * CHUNK : cs + 2 * CHUNK,
                                          dout + base, nrows, d, c0, copy);
            }
            load_chunk<NTH, KS, KEYS>(KEEP ? cs : cs + 3 * CHUNK, v + kbase, krows, d, c0, copy);
        } else if (!KEEP) {
            const int c0 = (st - PASSES * chunks) * 16 * CW;
            load_chunk<NTH, CW, ROWS>(cs, q + base, nrows, d, c0, copy);
            load_chunk<NTH, CW, ROWS>(cs + OUT, dout + base, nrows, d, c0, copy);
            load_chunk<NTH, CW, ROWS>(cs + 2 * OUT, k + base, nrows, d, c0, copy);
        }
        cp_async_commit();
    };
    const int stages = PASSES * chunks + out_chunks;
    auto next = [&](int st) {  // start stage st + 1's copies; wait for stage st's
        if (st + 1 < stages) {
            prefetch(st + 1);
            cp_async_wait_prior();
        } else {
            cp_async_wait_all();
        }
        __syncthreads();
    };

    if (!STAGED) prefetch(0);
    if (tid < ROWS) {
        int info = -1;
        if (tid < nrows) {
            const int list = tid / N, key = tid - list * N;
            info = list << 2 | key_flag(mask + size_t((l0 + list) / H) * N, key, N);
        }
        kinfo[tid] = info;
    }
    int seg[2];  // of the thread's two query rows: g and g + 8 of the warp's 16
    float m[2], inv[2], D[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + g + 8 * h;
        const bool in = r < nrows;  // a row past them: zero q and dO rows, P = dS = 0
        seg[h] = in ? r / N : -2;
        m[h] = in ? row_max[row0 + r] : 0.f;
        inv[h] = in ? 1.f / row_sum[row0 + r] : 0.f;  // l >= 1
        D[h] = in ? dsum[row0 + r] : 0.f;
    }
    if (STAGED) {
        stage_kept<CHUNK, LDC>(Rs, Ps, Cs, q + base, k + base, dout + base, nrows, d, chunks);
        prefetch(0);
    }

    // steps 1 and 2, for each pass's keys
    uint32_t dsa[KEYS / 16][4];  // dS of the warp's rows: A of dq += dS K (ROWS = PACK_ROWS)
    for (int pass = 0; pass < PASSES; ++pass) {
        float s[KEYS / 8][4], dp[KEYS / 8][4];
#pragma unroll
        for (int j = 0; j < KEYS / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
        for (int c = 0; c < chunks; ++c) {
            const int st = pass * chunks + c;
            next(st);
            const bf16* cs = Cs + (st & 1) * STAGE;
            uint32_t a[KS][4];
            load_a<KS>(a, KEEP ? Rs + c * CHUNK : cs, warp * 16, lane);
            product_nk<KS, KEYS / 8>(s, a, KEEP ? Rs + (chunks + c) * CHUNK : cs + CHUNK, 0,
                                     lane);
            load_a<KS>(a, KEEP ? Rs + (2 * chunks + c) * CHUNK : cs + 2 * CHUNK, warp * 16, lane);
            product_nk<KS, KEYS / 8>(dp, a, KEEP ? cs : cs + 3 * CHUNK, 0, lane);
            __syncthreads();  // no warp reads stage st's buffers any more
        }

        // step 2 (the next stage is in flight)
        uint32_t pa[KEYS / 16][4];
        p_ds_packed<KEYS / 8>(pa, dsa, s, dp, kinfo + pass * KEYS + 2 * t4, seg, m, inv, D,
                              scale);
#pragma unroll
        for (int j = 0; j < KEYS / 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int at = (warp * 16 + g + 8 * h) * LDP + pass * KEYS + 8 * j + 2 * t4;
                *reinterpret_cast<uint32_t*>(Ps + at) = pa[j >> 1][(j & 1) * 2 + h];
                *reinterpret_cast<uint32_t*>(dSs + at) = dsa[j >> 1][(j & 1) * 2 + h];
            }
    }
    __syncthreads();

    // step 3
    const bool pairs = how & STORE_PAIRS;
    if constexpr (ROWS == PACK_ROWS) {
        uint32_t pta[ROWS / 16][4], dsta[ROWS / 16][4];  // P^T, dS^T of the warp's keys
        load_a_trans<ROWS / 16, LDP>(pta, Ps, warp * 16, lane);
        load_a_trans<ROWS / 16, LDP>(dsta, dSs, warp * 16, lane);
        for (int oc = 0; oc < out_chunks; ++oc) {
            const int st = chunks + oc;
            next(st);
            const bf16* cs = Cs + (st & 1) * STAGE;
            const bf16* Qo = KEEP ? Rs + oc * CHUNK : cs;
            const bf16* dOo = KEEP ? Rs + (2 * chunks + oc) * CHUNK : cs + OUT;
            const bf16* Ko = KEEP ? Rs + (chunks + oc) * CHUNK : cs + 2 * OUT;
            float acc_q[2 * CW][4], acc_k[2 * CW][4], acc_v[2 * CW][4];
#pragma unroll
            for (int j = 0; j < 2 * CW; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc_q[j][e] = acc_k[j][e] = acc_v[j][e] = 0.f;
            product_kn<CW, ROWS / 16>(acc_v, pta, dOo, 0, lane);   // dv += P^T dO
            product_kn<CW, ROWS / 16>(acc_k, dsta, Qo, 0, lane);   // dk += dS^T Q
            product_kn<CW, ROWS / 16>(acc_q, dsa, Ko, 0, lane);    // dq += dS K
            const int c0 = oc * 16 * CW;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = warp * 16 + g + 8 * h;  // a query row and a key
                if (r >= nrows) continue;
                const size_t at = base + size_t(r) * d;
#pragma unroll
                for (int j = 0; j < 2 * CW; ++j) {
                    const int col = c0 + 8 * j + 2 * t4;
                    store_pair(dq + at, col, acc_q[j][2 * h] * scale, acc_q[j][2 * h + 1] * scale,
                               d, pairs);
                    store_pair(dk + at, col, acc_k[j][2 * h] * scale, acc_k[j][2 * h + 1] * scale,
                               d, pairs);
                    store_pair(dv + at, col, acc_v[j][2 * h], acc_v[j][2 * h + 1], d, pairs);
                }
            }
            __syncthreads();  // no warp reads stage st's buffers any more
        }
    } else {
        // One product at a time, its A fragments read from the P and dS tiles
        // for each output chunk: 128-deep fragments of all three products
        // (96 registers) would not fit beside their three accumulators.
        auto store = [&](bf16* out, const float (&acc)[2 * CW][4], float mul, int c0) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = warp * 16 + g + 8 * h;  // a query row and a key
                if (r >= nrows) continue;
                bf16* row = out + base + size_t(r) * d;
#pragma unroll
                for (int j = 0; j < 2 * CW; ++j)
                    store_pair(row, c0 + 8 * j + 2 * t4, acc[j][2 * h] * mul,
                               acc[j][2 * h + 1] * mul, d, pairs);
            }
        };
        for (int oc = 0; oc < out_chunks; ++oc) {
            const int st = PASSES * chunks + oc;
            next(st);
            const bf16* cs = Cs + (st & 1) * STAGE;
            const int c0 = oc * 16 * CW;
            uint32_t fa[ROWS / 16][4];
            float acc[2 * CW][4];
            auto product = [&](const bf16* btile) {
#pragma unroll
                for (int j = 0; j < 2 * CW; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
                product_kn<CW, ROWS / 16>(acc, fa, btile, 0, lane);
            };
            load_a_trans<ROWS / 16, LDP>(fa, Ps, warp * 16, lane);
            product(cs + OUT);  // dv = P^T dO
            store(dv, acc, 1.f, c0);
            load_a_trans<ROWS / 16, LDP>(fa, dSs, warp * 16, lane);
            product(cs);  // dk = scale * dS^T Q
            store(dk, acc, scale, c0);
            load_a<ROWS / 16>(fa, dSs, warp * 16, lane);
            product(cs + 2 * OUT);  // dq = scale * dS K
            store(dq, acc, scale, c0);
            __syncthreads();  // no warp reads stage st's buffers any more
        }
    }
}

// ---------------------------------------------------------------------------
// bf16, lists of 129 .. 256 docs: the long kernel
// ---------------------------------------------------------------------------
//
// At 129 .. 256 docs the wide pair computes S and dP about 9 times a list
// (6 dk/dv chunks and 3 dq chunks at d = 350, each over the whole d), as it
// did at 65 .. 128 docs before the list kernel. The list kernel's tile does
// not stretch to 256 rows: a warp's 16 rows by 256 keys are 256 fp32 values
// of S and dP a thread (the limit is 255 registers), and P and dS of 256 x
// 256 as bf16 tiles are 270,336 bytes (a block may have 232,448). Here one
// block of 8 warps owns one list (256 / N lists at N <= 128) and takes its
// keys in two halves of 128, each half the list kernel's steps with the
// roles of rows and keys arranged so that only dq is split:
//   1. for each pass of 128 query rows: S and dP of the pass's rows by the
//      half's 128 keys (a warp's 16 rows, 128 fp32 values a thread: the list
//      kernel's registers) over d in double-buffered 32-column chunks of Q,
//      dO (the pass's rows) and K, V (the half's keys);
//   2. P and dS on the fragments (p_ds_packed, the list kernel's rules),
//      rounded to bf16 and stored as [256 query rows][136] tiles: the half's
//      keys against every query row of the list;
//   3. for each 32-column output chunk of Q and dO (all 256 rows): dv =
//      P^T dO and dk = scale * dS^T Q of the warp's 16 keys of the half,
//      whole (they contract over every query row), written once;
//   4. for each 64-column output chunk of the half's K: dq of the warp's
//      rows of each pass over the half's keys: the first half writes this
//      partial to dq_part (fp32, [B*H*N, d]) and the second reads it back,
//      adds its own and writes dq = scale * (first + second), rounded once.
//      Each thread reads back exactly the values it wrote (the same
//      fragment of the same rows and columns), so no barrier or atomic is
//      needed, and fp32 addition of two terms gives the same bits whichever
//      comes first.
// Shared memory: the P and dS tiles (139,264 bytes) and two stages of four
// [128][40] chunk tiles (81,920; steps 3 and 4 use the same buffers), with
// the key info 222,208 bytes: one block an SM. Two stages of 64-column
// chunks would need 147,456 beside the tiles. LONG_SUM picks how the two
// halves' dq partials are summed: 0 (shipped) one block a tile runs both
// halves as above; 1: a block for each half, each writing its partial to
// its own half of a [2][B*H*N][d] buffer, then a second kernel adds the
// two in a fixed order; 2: a block for each half adding its partial into
// a zeroed buffer by atomicAdd (two addends onto zero: order-free), then
// the same kernel rounds it (tools/kernel_variants.py times all three).
// What bounds it: bytes, as the list kernel (the products are 10 * N^2 * d
// operations a list, far below the tensor cores' ridge).

constexpr int LONG_ROWS = 256;            // rows of the long kernel's tile: one list of 129 .. 256 docs
constexpr int LONG_HALF = LONG_ROWS / 2;  // keys of a half; query rows of a pass
constexpr int LONG_NT = 2 * LONG_HALF;    // threads: a warp for each 16 rows of a half
constexpr int LONG_CW = 2;     // 16-column steps of step 1's d-chunks and step 3's output chunks
constexpr int LONG_DQ_CW = 4;  // of step 4's output chunks: 64 columns
constexpr int LONG_SUM = 0;

// a stage: step 1's four [128][16*cw + 8] chunk tiles, step 3's Q and dO of
// every row, or step 4's K chunk of a half
__host__ __device__ constexpr size_t long_stage_elems(int cw, int dq_cw) {
    return size_t(4) * LONG_HALF * (16 * cw + 8) > size_t(LONG_HALF) * (16 * dq_cw + 8)
               ? size_t(4) * LONG_HALF * (16 * cw + 8)  // = 2 * LONG_ROWS * (16 * cw + 8)
               : size_t(LONG_HALF) * (16 * dq_cw + 8);
}
// the P and dS tiles, two stages, the key info
__host__ __device__ constexpr size_t long_smem_bytes(int cw, int dq_cw) {
    return (2 * size_t(LONG_ROWS) * (LONG_HALF + 8) + 2 * long_stage_elems(cw, dq_cw))
               * sizeof(bf16) + LONG_ROWS * sizeof(int);
}

template <int CW, int DQ_CW, int SUM>
__global__ void __launch_bounds__(LONG_NT, 1)
flash_bwd_long_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ row_max, const float* __restrict__ row_sum,
                          const float* __restrict__ dsum, const uint8_t* __restrict__ mask,
                          bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                          float* dq_part, int lists, int H, int N, int d, float scale, int copy,
                          int how) {
    static_assert(LONG_NT == LONG_ROWS, "a thread writes the key info of one tile row");
    constexpr int KS = CW;                      // 16-deep steps of a step-1 d-chunk
    constexpr int LDC = 16 * CW + 8;            // row stride of the chunk tiles of steps 1 and 3
    constexpr int LDP = LONG_HALF + 8;          // of the P and dS tiles
    constexpr int HALF_CHUNK = LONG_HALF * LDC;  // a chunk tile of 128 rows
    constexpr int STAGE = int(long_stage_elems(CW, DQ_CW));
    extern __shared__ uint4 smem_mma[];
    bf16* Ps = reinterpret_cast<bf16*>(smem_mma);  // [LONG_ROWS query rows][LDP]: the half's keys
    bf16* dSs = Ps + LONG_ROWS * LDP;
    bf16* Cs = dSs + LONG_ROWS * LDP;              // [2][STAGE]
    int* kinfo = reinterpret_cast<int*>(Cs + 2 * STAGE);  // [LONG_ROWS]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    const int per_tile = LONG_ROWS / N;
    const int tile = SUM == 0 ? blockIdx.x : blockIdx.x >> 1;
    const int l0 = tile * per_tile;  // the tile's first (b, h) list
    const int nrows = min(per_tile, lists - l0) * N;
    const size_t row0 = size_t(l0) * N;
    const size_t base = row0 * d;
    const int chunks = (d + 16 * CW - 1) / (16 * CW);  // step 1's d-chunks, step 3's output chunks
    const int dq_chunks = (d + 16 * DQ_CW - 1) / (16 * DQ_CW);
    const int per_half = 3 * chunks + dq_chunks;       // stages of a half
    const int first = SUM == 0 ? 0 : blockIdx.x & 1;   // the block's first half
    const int halves = SUM == 0 ? 2 : 1;
    const int stages = halves * per_half;
    auto rows_from = [&](int r0) { return max(min(nrows - r0, LONG_HALF), 0); };

    // stage st: of half first + st / per_half, at u = st % per_half: u < 2 *
    // chunks step 1's d-chunk u % chunks of pass u / chunks (Q, dO of the
    // pass's rows; K, V of the half's keys), u < 3 * chunks step 3's output
    // chunk (Q, dO of every row), else step 4's (K of the half)
    auto prefetch = [&](int st) {
        bf16* cs = Cs + (st & 1) * STAGE;
        const int half = first + st / per_half, u = st % per_half;
        const size_t kb = base + size_t(half) * LONG_HALF * d;
        const int krows = rows_from(half * LONG_HALF);
        if (u < 2 * chunks) {
            const int pass = u / chunks, c0 = (u - pass * chunks) * 16 * CW;
            const size_t qb = base + size_t(pass) * LONG_HALF * d;
            const int qrows = rows_from(pass * LONG_HALF);
            load_chunk<LONG_NT, CW, LONG_HALF>(cs, q + qb, qrows, d, c0, copy);
            load_chunk<LONG_NT, CW, LONG_HALF>(cs + HALF_CHUNK, dout + qb, qrows, d, c0, copy);
            load_chunk<LONG_NT, CW, LONG_HALF>(cs + 2 * HALF_CHUNK, k + kb, krows, d, c0, copy);
            load_chunk<LONG_NT, CW, LONG_HALF>(cs + 3 * HALF_CHUNK, v + kb, krows, d, c0, copy);
        } else if (u < 3 * chunks) {
            const int c0 = (u - 2 * chunks) * 16 * CW;
            load_chunk<LONG_NT, CW, LONG_ROWS>(cs, q + base, nrows, d, c0, copy);
            load_chunk<LONG_NT, CW, LONG_ROWS>(cs + 2 * HALF_CHUNK, dout + base, nrows, d, c0,
                                               copy);
        } else {
            load_chunk<LONG_NT, DQ_CW, LONG_HALF>(cs, k + kb, krows, d,
                                                  (u - 3 * chunks) * 16 * DQ_CW, copy);
        }
        cp_async_commit();
    };
    auto next = [&](int st) {  // start stage st + 1's copies; wait for stage st's
        if (st + 1 < stages) {
            prefetch(st + 1);
            cp_async_wait_prior();
        } else {
            cp_async_wait_all();
        }
        __syncthreads();
    };

    prefetch(0);
    {
        int info = -1;
        if (tid < nrows) {
            const int list = tid / N, key = tid - list * N;
            info = list << 2 | key_flag(mask + size_t((l0 + list) / H) * N, key, N);
        }
        kinfo[tid] = info;
    }
    const bool pairs = how & STORE_PAIRS;
    // rows r0 + g and r0 + g + 8 of a fragment's product into `out`, times mul
    auto store = [&](bf16* out, const float (&acc)[2 * CW][4], float mul, int r0, int c0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = r0 + g + 8 * h;
            if (r >= nrows) continue;
            bf16* row = out + base + size_t(r) * d;
#pragma unroll
            for (int j = 0; j < 2 * CW; ++j)
                store_pair(row, c0 + 8 * j + 2 * t4, acc[j][2 * h] * mul, acc[j][2 * h + 1] * mul,
                           d, pairs);
        }
    };

    int st = 0;
    for (int half = first; half < first + halves; ++half) {
        // steps 1 and 2, for each pass's query rows against the half's keys
        for (int pass = 0; pass < 2; ++pass) {
            int seg[2];  // of the thread's two query rows: g and g + 8 of the warp's 16
            float m[2], inv[2], D[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = pass * LONG_HALF + warp * 16 + g + 8 * h;
                const bool in = r < nrows;  // a row past them: zero q and dO rows, P = dS = 0
                seg[h] = in ? r / N : -2;
                m[h] = in ? row_max[row0 + r] : 0.f;
                inv[h] = in ? 1.f / row_sum[row0 + r] : 0.f;  // l >= 1
                D[h] = in ? dsum[row0 + r] : 0.f;
            }
            float s[LONG_HALF / 8][4], dp[LONG_HALF / 8][4];
#pragma unroll
            for (int j = 0; j < LONG_HALF / 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
            for (int c = 0; c < chunks; ++c, ++st) {
                next(st);
                const bf16* cs = Cs + (st & 1) * STAGE;
                uint32_t a[KS][4];
                load_a<KS>(a, cs, warp * 16, lane);
                product_nk<KS, LONG_HALF / 8>(s, a, cs + 2 * HALF_CHUNK, 0, lane);
                load_a<KS>(a, cs + HALF_CHUNK, warp * 16, lane);
                product_nk<KS, LONG_HALF / 8>(dp, a, cs + 3 * HALF_CHUNK, 0, lane);
                __syncthreads();  // no warp reads stage st's buffers any more
            }
            // step 2 (the next stage is in flight)
            uint32_t pa[LONG_HALF / 16][4], dsa[LONG_HALF / 16][4];
            p_ds_packed<LONG_HALF / 8>(pa, dsa, s, dp, kinfo + half * LONG_HALF + 2 * t4, seg, m,
                                       inv, D, scale);
#pragma unroll
            for (int j = 0; j < LONG_HALF / 8; ++j)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int at = (pass * LONG_HALF + warp * 16 + g + 8 * h) * LDP + 8 * j + 2 * t4;
                    *reinterpret_cast<uint32_t*>(Ps + at) = pa[j >> 1][(j & 1) * 2 + h];
                    *reinterpret_cast<uint32_t*>(dSs + at) = dsa[j >> 1][(j & 1) * 2 + h];
                }
        }

        // step 3: dv and dk of the warp's 16 keys of the half, from the
        // fragments of P^T and dS^T over all LONG_ROWS query rows, read anew
        // from the tiles for each output chunk
        for (int oc = 0; oc < chunks; ++oc, ++st) {
            next(st);  // its barrier also orders step 2's tile stores before these reads
            const bf16* cs = Cs + (st & 1) * STAGE;
            const int c0 = oc * 16 * CW;
            uint32_t fa[LONG_ROWS / 16][4];
            float acc[2 * CW][4];
            auto product = [&](const bf16* btile) {
#pragma unroll
                for (int j = 0; j < 2 * CW; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
                product_kn<CW, LONG_ROWS / 16>(acc, fa, btile, 0, lane);
            };
            load_a_trans<LONG_ROWS / 16, LDP>(fa, Ps, warp * 16, lane);
            product(cs + 2 * HALF_CHUNK);  // dv = P^T dO
            store(dv, acc, 1.f, half * LONG_HALF + warp * 16, c0);
            load_a_trans<LONG_ROWS / 16, LDP>(fa, dSs, warp * 16, lane);
            product(cs);  // dk = scale * dS^T Q
            store(dk, acc, scale, half * LONG_HALF + warp * 16, c0);
            __syncthreads();  // no warp reads stage st's buffers any more
        }

        // step 4: dq of the warp's rows of each pass over the half's keys
        for (int oc = 0; oc < dq_chunks; ++oc, ++st) {
            next(st);
            const bf16* ks = Cs + (st & 1) * STAGE;
            const int c0 = oc * 16 * DQ_CW;
#pragma unroll 1
            for (int pass = 0; pass < 2; ++pass) {
                uint32_t fa[LONG_HALF / 16][4];
                float acc[2 * DQ_CW][4];
#pragma unroll
                for (int j = 0; j < 2 * DQ_CW; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
                load_a<LONG_HALF / 16>(fa, dSs, pass * LONG_HALF + warp * 16, lane);
                product_kn<DQ_CW, LONG_HALF / 16>(acc, fa, ks, 0, lane);  // dS K
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int r = pass * LONG_HALF + warp * 16 + g + 8 * h;
                    if (r >= nrows) continue;
                    float* part = dq_part + (SUM == 1 ? size_t(half) * lists * N * d : 0)
                                  + (row0 + r) * d;
                    bf16* row = dq + base + size_t(r) * d;
#pragma unroll
                    for (int j = 0; j < 2 * DQ_CW; ++j) {
                        const int col = c0 + 8 * j + 2 * t4;
                        float x = acc[j][2 * h], y = acc[j][2 * h + 1];
                        if (SUM == 2) {
                            if (col < d) atomicAdd(part + col, x);
                            if (col + 1 < d) atomicAdd(part + col + 1, y);
                        } else if (SUM == 1 || half == 0) {
                            if (pairs) {
                                if (col < d) *reinterpret_cast<float2*>(part + col) = make_float2(x, y);
                            } else {
                                if (col < d) part[col] = x;
                                if (col + 1 < d) part[col + 1] = y;
                            }
                        } else {
                            if (pairs) {
                                if (col < d) {
                                    const float2 p = *reinterpret_cast<const float2*>(part + col);
                                    x += p.x;
                                    y += p.y;
                                }
                            } else {
                                if (col < d) x += part[col];
                                if (col + 1 < d) y += part[col + 1];
                            }
                            store_pair(row, col, x * scale, y * scale, d, pairs);
                        }
                    }
                }
            }
            __syncthreads();  // no warp reads stage st's buffers any more
        }
    }
}

// LONG_SUM 1 and 2: dq = scale * the sum of the PARTS [n] fp32 partials at part
template <int PARTS>
__global__ void __launch_bounds__(256)
flash_bwd_long_dq_sum_kernel(const float* __restrict__ part, bf16* __restrict__ dq, size_t n,
                             float scale) {
    for (size_t i = blockIdx.x * size_t(256) + threadIdx.x; i < n; i += size_t(gridDim.x) * 256) {
        float x = part[i];
        if (PARTS == 2) x += part[n + i];
        dq[i] = __float2bfloat16(x * scale);
    }
}

// ---------------------------------------------------------------------------
// fp32, lists of at most 64 docs: the packed kernel on 3xTF32
// ---------------------------------------------------------------------------
//
// The CUDA-core fp32 wide pair it replaced computed S and dP once for each
// 64-column output chunk of dk/dv and again for each of dq (12 times at
// d = 350), on 64-row tiles that hold one list of N docs: 10.56 + 6.10 ms at
// (2048, 2, 16, 350) on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md). Here
// the bf16 packed kernel's three steps in fp32, 64 / N lists a 64-row tile,
// dq, dk and dv of the tile in one block of 4 warps, every product on the
// tensor cores in 3xTF32 (mma_common.cuh: about fp32's accuracy):
//   1. S = Q K^T and dP = dO V^T (a warp's 16 query rows by the 64 keys,
//      fp32) once a tile, over d in TF32_W-column chunks of Q, K, dO and V
//      double-buffered through shared memory;
//   2. P and dS on the fragments with p_ds_packed's rules (a key of another
//      list: P = dS = 0; a masked key of the row's own list: logit -1e9,
//      dS = 0) and the fp32 kernels' expf; P and dS stored as fp32 [64][68]
//      tiles, since dk and dv contract over the query rows, which span the
//      warps; dS of the warp's own rows also stays in registers;
//   3. for each TF32_W-column output chunk, its Q, dO and K columns re-read
//      into the same double buffer (mostly L2 hits: the block read them in
//      step 1; keeping all of d would need 3 * 64 * d * 4 bytes, 269 KB at
//      d = 350), then dv = P^T dO and dk = scale * dS^T Q (A fragments of P^T
//      and dS^T read from the tiles) and dq = scale * dS K (dS's C fragment as
//      the A fragment, mma_1688_tf32's renumbered k slots).
// Five products a tile, as attention_backward_packed_plain takes them, each
// three TF32 products, each operand split into hi and lo at its fragment load
// (PERF.md has the times of a split staged once in shared memory and of
// 64-column chunks, one block an SM where 32 give two: both lost).
// What bounds it: bytes. Q, K, V and dO are read once from device memory
// (step 3's re-reads mostly from L2) and dq, dk, dv written once. On an
// NVIDIA H100 80GB HBM3 at 700 W (PERF.md): 0.92 ms at (2048, 2, 16, 350),
// and at 32 and 64 docs, against a byte bound of 0.19 ms, the wide pair's
// 16.6 and SDPA's fp32 backward 0.70; 0.68 ms at d = 384 (16-byte copies)
// against SDPA's 2.40. Its worst error at chip_smoke.py's fp32 gates: 8.0e-6
// relative (the gate: 1e-5), where the two plain versions differ by 3e-6.

constexpr int TF32_W = 32;  // columns of the fp32 packed kernel's d-chunks and output chunks
constexpr int TF32_KEYS = 64;  // keys of S and dP the fp32 kernels' warps hold: 16 rows by 64

// the P and dS tiles ([64][68]), two stages of four chunk tiles ([64][w + 4])
// and the key info
__host__ __device__ constexpr size_t packed_tf32_smem_bytes(int w) {
    return (size_t(2) * PACK_ROWS * (PACK_ROWS + 4) + size_t(2) * 4 * PACK_ROWS * (w + 4))
               * sizeof(float)
           + PACK_ROWS * sizeof(int);
}

// The fp32 kernels' step 1 on one W-column chunk: s += Q K^T and dp += dO V^T
// of the warp's 16 query rows (from row0 of the [*][W + 4] Q and dO tiles) by
// the TF32_KEYS keys of the K and V tiles, in 3xTF32, the operands split as
// INT_ROUND says (mma_common.cuh)
template <int W, bool INT_ROUND>
__device__ __forceinline__ void s_dp_tf32(float (&s)[TF32_KEYS / 8][4],
                                          float (&dp)[TF32_KEYS / 8][4], const float* Qt,
                                          const float* Kt, const float* dOt, const float* Vt,
                                          int row0, int lane) {
    constexpr int LD = W + 4;
#pragma unroll
    for (int kk = 0; kk < W; kk += 8) {
        uint32_t ahi[4], alo[4], bhi[2], blo[2];
        frag_a_tf32<LD, INT_ROUND>(ahi, alo, Qt, row0, kk, lane);
#pragma unroll
        for (int j = 0; j < TF32_KEYS / 8; ++j) {
            frag_b_nk_tf32<LD, INT_ROUND>(bhi, blo, Kt, 8 * j, kk, lane);
            mma_3xtf32(s[j], ahi, alo, bhi, blo);
        }
        frag_a_tf32<LD, INT_ROUND>(ahi, alo, dOt, row0, kk, lane);
#pragma unroll
        for (int j = 0; j < TF32_KEYS / 8; ++j) {
            frag_b_nk_tf32<LD, INT_ROUND>(bhi, blo, Vt, 8 * j, kk, lane);
            mma_3xtf32(dp[j], ahi, alo, bhi, blo);
        }
    }
}

// The fp32 kernels' step 2: P in place of S and dS in place of dP on the
// warp's fragments (p_ds_packed's rules, with expf), both also into the
// [*][LDP] P and dS tiles at the warp's rows (from row0). ki points at the key
// info of the thread's first key; seg, m, inv, D are those of its two rows.
template <int LDP>
__device__ __forceinline__ void p_ds_tf32(float (&s)[TF32_KEYS / 8][4],
                                          float (&dp)[TF32_KEYS / 8][4], const int* ki,
                                          const int (&seg)[2], const float (&m)[2],
                                          const float (&inv)[2], const float (&D)[2], float scale,
                                          float* Ps, float* dSs, int row0, int lane) {
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int j = 0; j < TF32_KEYS / 8; ++j) {
        const int2 f = *reinterpret_cast<const int2*>(ki + 8 * j);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int info = (e & 1) ? f.y : f.x, h = e >> 1;
            const bool same = (info >> 2) == seg[h];
            const bool real = same && (info & 3) == KEY_REAL;
            const float x = real ? s[j][e] * scale : MASKED_LOGIT;
            const float p = same ? expf(x - m[h]) * inv[h] : 0.f;
            dp[j][e] = real ? p * (dp[j][e] - D[h]) : 0.f;
            s[j][e] = p;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int at = (row0 + g + 8 * h) * LDP + 8 * j + 2 * t4;
            *reinterpret_cast<float2*>(Ps + at) = make_float2(s[j][2 * h], s[j][2 * h + 1]);
            *reinterpret_cast<float2*>(dSs + at) = make_float2(dp[j][2 * h], dp[j][2 * h + 1]);
        }
    }
}

template <int W>
__global__ void __launch_bounds__(PACK_NT, 2)
flash_bwd_packed_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ dout,
                             const float* __restrict__ row_max, const float* __restrict__ row_sum,
                             const float* __restrict__ dsum, const uint8_t* __restrict__ mask,
                             float* __restrict__ dq, float* __restrict__ dk,
                             float* __restrict__ dv, int lists, int H, int N, int d, float scale,
                             int copy, int how) {
    static_assert(PACK_ROWS == TF32_KEYS, "a warp holds S and dP of all the tile's keys");
    constexpr int LD = W + 4;              // row stride of the chunk tiles (floats)
    constexpr int LDP = PACK_ROWS + 4;     // of the P and dS tiles
    constexpr int TS = PACK_ROWS * LD;     // a chunk tile: a tensor's share of a stage
    constexpr int PT = PACK_ROWS * LDP;    // the P tile
    constexpr int STAGE = 4 * TS;
    extern __shared__ uint4 smem_mma[];
    float* Ps = reinterpret_cast<float*>(smem_mma);  // [64 query rows][LDP]
    float* dSs = Ps + PT;
    float* Cs = dSs + PT;                            // [2][STAGE]: Q, K, dO, V chunk tiles
    int* kinfo = reinterpret_cast<int*>(Cs + 2 * STAGE);

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    const int per_tile = PACK_ROWS / N;
    const int l0 = blockIdx.x * per_tile;  // the tile's first (b, h) list
    const int nrows = min(per_tile, lists - l0) * N;
    const size_t row0 = size_t(l0) * N;
    const size_t base = row0 * d;
    const int chunks = (d + W - 1) / W;
    const int stages = 2 * chunks;

    // stage st < chunks: step 1's d-chunk st of Q, K, dO and V; st >= chunks:
    // step 3's output chunk st - chunks of Q, K and dO, in the same places
    auto prefetch = [&](int st) {
        float* cs = Cs + (st & 1) * STAGE;
        const int c0 = (st < chunks ? st : st - chunks) * W;
        load_chunk_f32<PACK_NT, W, PACK_ROWS>(cs, q + base, nrows, d, c0, copy);
        load_chunk_f32<PACK_NT, W, PACK_ROWS>(cs + TS, k + base, nrows, d, c0, copy);
        load_chunk_f32<PACK_NT, W, PACK_ROWS>(cs + 2 * TS, dout + base, nrows, d, c0, copy);
        if (st < chunks)
            load_chunk_f32<PACK_NT, W, PACK_ROWS>(cs + 3 * TS, v + base, nrows, d, c0, copy);
        cp_async_commit();
    };
    auto next = [&](int st) {  // start stage st + 1's copies; wait for stage st's
        if (st + 1 < stages) {
            prefetch(st + 1);
            cp_async_wait_prior();
        } else {
            cp_async_wait_all();
        }
        __syncthreads();
    };

    prefetch(0);
    if (tid < PACK_ROWS) {
        int info = -1;
        if (tid < nrows) {
            const int list = tid / N, key = tid - list * N;
            info = list << 2 | key_flag(mask + size_t((l0 + list) / H) * N, key, N);
        }
        kinfo[tid] = info;
    }
    int seg[2];  // of the thread's two query rows: g and g + 8 of the warp's 16
    float m[2], inv[2], D[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + g + 8 * h;
        const bool in = r < nrows;  // a row past them: zero q and dO rows, P = dS = 0
        seg[h] = in ? r / N : -2;
        m[h] = in ? row_max[row0 + r] : 0.f;
        inv[h] = in ? 1.f / row_sum[row0 + r] : 0.f;  // l >= 1
        D[h] = in ? dsum[row0 + r] : 0.f;
    }

    // step 1
    float s[PACK_ROWS / 8][4], dp[PACK_ROWS / 8][4];
#pragma unroll
    for (int j = 0; j < PACK_ROWS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    for (int c = 0; c < chunks; ++c) {
        next(c);
        const float* cs = Cs + (c & 1) * STAGE;
        s_dp_tf32<W, false>(s, dp, cs, cs + TS, cs + 2 * TS, cs + 3 * TS, warp * 16, lane);
        __syncthreads();  // no warp reads stage c's buffers any more
    }

    // step 2 (stage `chunks`, step 3's first, is in flight)
    p_ds_tf32<LDP>(s, dp, kinfo + 2 * t4, seg, m, inv, D, scale, Ps, dSs, warp * 16, lane);
    __syncthreads();

    // step 3
    const bool pairs = how & STORE_PAIRS;
    for (int oc = 0; oc < chunks; ++oc) {
        const int st = chunks + oc;
        next(st);
        const float* cs = Cs + (st & 1) * STAGE;
        float acc_q[W / 8][4], acc_k[W / 8][4], acc_v[W / 8][4];
#pragma unroll
        for (int n = 0; n < W / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc_q[n][e] = acc_k[n][e] = acc_v[n][e] = 0.f;
        // over the query rows (dk, dv) or the keys (dq) 8j .. 8j + 7
#pragma unroll
        for (int j = 0; j < PACK_ROWS / 8; ++j) {
            uint32_t ahi[4], alo[4], bhi[2], blo[2];
            frag_a_trans_tf32<LDP>(ahi, alo, Ps, warp * 16, 8 * j, lane);
#pragma unroll
            for (int n = 0; n < W / 8; ++n) {  // dv += P^T dO
                frag_b_kn_tf32<LD>(bhi, blo, cs + 2 * TS, 8 * j, 8 * n, lane);
                mma_3xtf32(acc_v[n], ahi, alo, bhi, blo);
            }
            frag_a_trans_tf32<LDP>(ahi, alo, dSs, warp * 16, 8 * j, lane);
#pragma unroll
            for (int n = 0; n < W / 8; ++n) {  // dk += dS^T Q
                frag_b_kn_tf32<LD>(bhi, blo, cs, 8 * j, 8 * n, lane);
                mma_3xtf32(acc_k[n], ahi, alo, bhi, blo);
            }
            c_as_a_tf32(ahi, alo, dp[j]);
#pragma unroll
            for (int n = 0; n < W / 8; ++n) {  // dq += dS K
                frag_b_kn_tf32<LD>(bhi, blo, cs + TS, 8 * j, 8 * n, lane);
                mma_3xtf32(acc_q[n], ahi, alo, bhi, blo);
            }
        }
        const int c0 = oc * W;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = warp * 16 + g + 8 * h;  // a query row and a key
            if (r >= nrows) continue;
            const size_t at = base + size_t(r) * d;
#pragma unroll
            for (int n = 0; n < W / 8; ++n) {
                const int col = c0 + 8 * n + 2 * t4;
                store_pair_f32(dq + at, col, acc_q[n][2 * h] * scale, acc_q[n][2 * h + 1] * scale,
                               d, pairs);
                store_pair_f32(dk + at, col, acc_k[n][2 * h] * scale, acc_k[n][2 * h + 1] * scale,
                               d, pairs);
                store_pair_f32(dv + at, col, acc_v[n][2 * h], acc_v[n][2 * h + 1], d, pairs);
            }
        }
        __syncthreads();  // no warp reads stage st's buffers any more
    }
}

// ---------------------------------------------------------------------------
// fp32, lists of 65 .. 256 docs: the list and long kernels on 3xTF32
// ---------------------------------------------------------------------------
//
// At 65 .. 256 docs the CUDA-core fp32 wide pair it replaced computed S and
// dP once for each 64-column output chunk of dk/dv (6 at d = 350) and again for
// each of dq, in two launches: 8.51 + 3.88 ms at (256, 2, 128, 350) and
// 16.21 + 7.70 at (128, 2, 256, 350) on an NVIDIA H100 80GB HBM3 at 700 W
// (PERF.md), where SDPA's fp32 backward takes 1.06 and 1.58. The fp32
// packed kernel's tile does not stretch to these lists: S and dP of a warp's
// 16 rows by 256 keys would be 256 fp32 registers a thread, and P and dS of
// 256 x 256 as fp32 tiles 270,336 bytes (a block may have 232,448). Here one
// block of 8 warps owns one list of up to ROWS docs (ROWS / N lists at
// N <= ROWS / 2; ROWS = LIST_ROWS for the list entry, LONG_ROWS for the long
// one) and takes its keys in slices of 64 and its query rows in passes of
// 128; for each slice, for each pass, the fp32 packed kernel's three steps,
// every product in 3xTF32, each operand split into hi and lo at its fragment
// load by integer rounding of its bits (F32_INT_ROUND: the same bits as the
// packed kernel's cvt.rna.tf32.f32, in less time and fewer registers):
//   1. S = Q K^T and dP = dO V^T of the pass's rows by the slice's keys (a
//      warp's 16 rows by 64 keys, 32 + 32 fp32 registers a thread: s_dp_tf32)
//      over d in F32_W-column chunks of Q, dO (the pass's rows) and K, V (the
//      slice's keys), double-buffered by cp.async;
//   2. P and dS on the fragments (p_ds_tf32), stored as fp32 [128][68] tiles,
//      since dk and dv contract over the query rows, which span the warps;
//   3. for each F32_W-column output chunk, its Q, dO and K columns re-read
//      into the same buffers right after step 1 read them (mostly L2 hits),
//      then dv = P^T dO and dk = scale * dS^T Q of the slice's keys over the
//      pass's rows and dq = scale * dS K of the pass's rows over the slice's
//      keys (dS's C fragment, read back from the tile as step 2 stored it,
//      as the A fragment). dq: a warp its own 16 rows. dk, dv: warps 0-3
//      dv, 4-7 dk, each 16 keys by every column of the chunk, so that one A
//      fragment of P^T or dS^T feeds F32_W / 8 products (each warp both on
//      half the columns took 1..5% longer, one stage 5..10.5%: PERF.md).
// dq sums over the slices and dk, dv over the passes in the outputs
// themselves: the first slice (pass) writes its partial sum, each later one
// loads it back as the start of its own sums and stores it again, the last
// one times the scale. Each thread reads back exactly the values it
// wrote, in a fixed order, so no scratch, barrier or atomic is needed, the
// same inputs give the same bits, and fp32 leaves no rounding of its own.
// Shared memory: the P and dS tiles (69,632 bytes), two stages of Q and dO
// of 128 rows and K and V of 64 keys (55,296 bytes a stage at F32_W = 32)
// and the key info: 181,248 bytes at ROWS = 256, one block an SM.
// What bounds it: the products (10 * N^2 * d operations a list, each three
// TF32 products, and each operand's split) with 8 warps an SM to hide their
// latency, and the re-reads of Q and dO for each slice, twice (step 1 and
// step 3), and of the partial sums, which the 7-tensor byte bound leaves
// out. On an NVIDIA H100 80GB HBM3 at 700 W (PERF.md): 1.20 ms at (256, 2,
// 128, 350) and 2.45 at (128, 2, 256, 350), against the pair's 12.32 and
// 23.86 and SDPA's 1.06 and 1.58; at d = 384 1.05 and 2.19 against SDPA's
// 1.33 and 2.39.

constexpr int F32_SLICE = TF32_KEYS;  // keys of a slice
constexpr int F32_PASS = 128;         // query rows of a pass: a warp for each 16
constexpr int F32_NT = 2 * F32_PASS;  // threads
// columns of the d-chunks and output chunks (tools/kernel_variants.py times 16)
constexpr int F32_W = 32;
// whether the operands' hi/lo split rounds by integer arithmetic (the same
// bits as cvt.rna.tf32.f32: mma_common.cuh's to_tf32_int; the fp32 packed
// kernels keep the cvt: with the integer rounding the packed backward
// spilled, PERF.md)
constexpr bool F32_INT_ROUND = true;

// the P and dS tiles ([128][68]), the two stages (Q, dO chunk tiles of 128
// rows, K, V of 64, rows of w + 4 floats) and the key info of `rows` keys
__host__ __device__ constexpr size_t list_tf32_smem_bytes(int rows, int w) {
    return (size_t(2) * F32_PASS * (F32_SLICE + 4)
            + size_t(2) * (2 * F32_PASS + 2 * F32_SLICE) * (w + 4))
               * sizeof(float)
           + rows * sizeof(int);
}

// (x, y) at columns col, col + 1 of an fp32 row of d columns (zeros past d)
__device__ __forceinline__ float2 load_pair_f32(const float* row, int col, int d, bool pairs) {
    if (pairs) return col < d ? *reinterpret_cast<const float2*>(row + col) : make_float2(0.f, 0.f);
    return make_float2(col < d ? row[col] : 0.f, col + 1 < d ? row[col + 1] : 0.f);
}

template <int ROWS, int W>
__global__ void __launch_bounds__(F32_NT, 1)
flash_bwd_list_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ dout,
                           const float* __restrict__ row_max, const float* __restrict__ row_sum,
                           const float* __restrict__ dsum, const uint8_t* __restrict__ mask,
                           float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
                           int lists, int H, int N, int d, float scale, int copy, int how) {
    static_assert(W % 16 == 0, "chunks of 16-column steps");
    constexpr int LD = W + 4;                // row stride of the chunk tiles (floats)
    constexpr int LDP = F32_SLICE + 4;       // of the P and dS tiles
    constexpr int QT = F32_PASS * LD;        // a Q or dO chunk tile
    constexpr int KT = F32_SLICE * LD;       // a K or V chunk tile
    constexpr int STAGE = 2 * QT + 2 * KT;
    extern __shared__ uint4 smem_mma[];
    float* Ps = reinterpret_cast<float*>(smem_mma);  // [F32_PASS query rows][LDP]: the slice's keys
    float* dSs = Ps + F32_PASS * LDP;
    float* Cs = dSs + F32_PASS * LDP;                // [2][STAGE]: Q, dO, K, V chunk tiles
    int* kinfo = reinterpret_cast<int*>(Cs + 2 * STAGE);  // [ROWS]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    const int per_tile = ROWS / N;
    const int l0 = blockIdx.x * per_tile;  // the tile's first (b, h) list
    const int nrows = min(per_tile, lists - l0) * N;
    const size_t row0 = size_t(l0) * N;
    const size_t base = row0 * d;
    const int chunks = (d + W - 1) / W;
    const int slices = (nrows + F32_SLICE - 1) / F32_SLICE;
    const int passes = (nrows + F32_PASS - 1) / F32_PASS;
    const int per_sp = 2 * chunks;  // stages of a slice's pass: step 1's d-chunks, step 3's
    const int stages = slices * passes * per_sp;

    // stage st: of pass sp % passes of slice sp / passes (sp = st / per_sp),
    // at u = st % per_sp: u < chunks step 1's d-chunk u of Q, dO, K and V,
    // else step 3's output chunk u - chunks of Q, dO and K
    auto prefetch = [&](int st) {
        float* cs = Cs + (st & 1) * STAGE;
        const int sp = st / per_sp, u = st - sp * per_sp;
        const int slice = sp / passes, pass = sp - slice * passes;
        const int c0 = (u < chunks ? u : u - chunks) * W;
        const size_t qb = base + size_t(pass) * F32_PASS * d;
        const size_t kb = base + size_t(slice) * F32_SLICE * d;
        const int qrows = min(nrows - pass * F32_PASS, F32_PASS);
        const int krows = min(nrows - slice * F32_SLICE, F32_SLICE);
        load_chunk_f32<F32_NT, W, F32_PASS>(cs, q + qb, qrows, d, c0, copy);
        load_chunk_f32<F32_NT, W, F32_PASS>(cs + QT, dout + qb, qrows, d, c0, copy);
        load_chunk_f32<F32_NT, W, F32_SLICE>(cs + 2 * QT, k + kb, krows, d, c0, copy);
        if (u < chunks)
            load_chunk_f32<F32_NT, W, F32_SLICE>(cs + 2 * QT + KT, v + kb, krows, d, c0, copy);
        cp_async_commit();
    };
    // stage st's buffers, landed, with stage st + 1's copies in flight
    auto next = [&](int st) -> const float* {
        if (st + 1 < stages) {
            prefetch(st + 1);
            cp_async_wait_prior();
        } else {
            cp_async_wait_all();
        }
        __syncthreads();
        return Cs + (st & 1) * STAGE;
    };

    prefetch(0);
    for (int i = tid; i < ROWS; i += F32_NT) {
        int info = -1;
        if (i < nrows) {
            const int list = i / N, key = i - list * N;
            info = list << 2 | key_flag(mask + size_t((l0 + list) / H) * N, key, N);
        }
        kinfo[i] = info;
    }
    const bool pairs = how & STORE_PAIRS;
    // step 3's dk and dv: whether the warp's output is dk (A: dS^T, B: Q) or
    // dv (A: P^T, B: dO), and its keys in a slice
    const bool is_dk = warp >= 4;
    float* const kv = is_dk ? dk : dv;
    const int key_off = (warp & 3) * 16;

    int st = 0;
    for (int slice = 0; slice < slices; ++slice) {
        for (int pass = 0; pass < passes; ++pass) {
            int seg[2];  // of the thread's two query rows: g and g + 8 of the warp's 16
            float m[2], inv[2], D[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = pass * F32_PASS + warp * 16 + g + 8 * h;
                const bool in = r < nrows;  // a row past them: zero q and dO rows, P = dS = 0
                seg[h] = in ? r / N : -2;
                m[h] = in ? row_max[row0 + r] : 0.f;
                inv[h] = in ? 1.f / row_sum[row0 + r] : 0.f;  // l >= 1
                D[h] = in ? dsum[row0 + r] : 0.f;
            }

            // step 1
            float s[F32_SLICE / 8][4], dp[F32_SLICE / 8][4];
#pragma unroll
            for (int j = 0; j < F32_SLICE / 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
            for (int c = 0; c < chunks; ++c, ++st) {
                const float* cs = next(st);
                s_dp_tf32<W, F32_INT_ROUND>(s, dp, cs, cs + 2 * QT, cs + QT, cs + 2 * QT + KT,
                                            warp * 16, lane);
                __syncthreads();  // no warp reads stage st's buffers any more
            }

            // step 2 (step 3's first stage is in flight; its barrier orders
            // these tile stores before step 3's reads)
            p_ds_tf32<LDP>(s, dp, kinfo + slice * F32_SLICE + 2 * t4, seg, m, inv, D, scale, Ps,
                           dSs, warp * 16, lane);

            // step 3
            const bool more_q = slice > 0, last_q = slice + 1 == slices;
            const bool more_kv = pass > 0, last_kv = pass + 1 == passes;
            const int qr = pass * F32_PASS + warp * 16;  // the warp's query rows
            const int kr = slice * F32_SLICE + key_off;  // its keys
            for (int oc = 0; oc < chunks; ++oc, ++st) {
                const float* cs = next(st);
                const int c0 = oc * W;
                // the sums start from the partial sums this thread stored
                // before (zero in the first slice or pass): loaded after the
                // products instead, their latency showed (PERF.md)
                float acc_q[W / 8][4], acc_kv[W / 8][4];
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int r = qr + g + 8 * h, key = kr + g + 8 * h;
#pragma unroll
                    for (int n = 0; n < W / 8; ++n) {
                        const float2 p = more_q && r < nrows
                                             ? load_pair_f32(dq + base + size_t(r) * d,
                                                             c0 + 8 * n + 2 * t4, d, pairs)
                                             : make_float2(0.f, 0.f);
                        acc_q[n][2 * h] = p.x;
                        acc_q[n][2 * h + 1] = p.y;
                    }
#pragma unroll
                    for (int n = 0; n < W / 8; ++n) {
                        const float2 p = more_kv && key < nrows
                                             ? load_pair_f32(kv + base + size_t(key) * d,
                                                             c0 + 8 * n + 2 * t4, d, pairs)
                                             : make_float2(0.f, 0.f);
                        acc_kv[n][2 * h] = p.x;
                        acc_kv[n][2 * h + 1] = p.y;
                    }
                }
                // dv += P^T dO, dk += dS^T Q over the pass's rows 8j .. 8j + 7
#pragma unroll 4
                for (int j = 0; j < F32_PASS / 8; ++j) {
                    uint32_t ahi[4], alo[4], bhi[2], blo[2];
                    frag_a_trans_tf32<LDP, F32_INT_ROUND>(ahi, alo, is_dk ? dSs : Ps, key_off,
                                                          8 * j, lane);
                    const float* bt = is_dk ? cs : cs + QT;
#pragma unroll
                    for (int n = 0; n < W / 8; ++n) {
                        frag_b_kn_tf32<LD, F32_INT_ROUND>(bhi, blo, bt, 8 * j, 8 * n, lane);
                        mma_3xtf32(acc_kv[n], ahi, alo, bhi, blo);
                    }
                }
                // dq += dS K over the slice's keys 8j .. 8j + 7: dS's C
                // fragment read back from the tile as step 2 stored it
#pragma unroll
                for (int j = 0; j < F32_SLICE / 8; ++j) {
                    uint32_t ahi[4], alo[4], bhi[2], blo[2];
                    const float* at = dSs + (warp * 16 + g) * LDP + 8 * j + 2 * t4;
                    const float2 row_g = *reinterpret_cast<const float2*>(at);
                    const float2 row_g8 = *reinterpret_cast<const float2*>(at + 8 * LDP);
                    const float ds[4] = {row_g.x, row_g.y, row_g8.x, row_g8.y};
                    c_as_a_tf32<F32_INT_ROUND>(ahi, alo, ds);
#pragma unroll
                    for (int n = 0; n < W / 8; ++n) {
                        frag_b_kn_tf32<LD, F32_INT_ROUND>(bhi, blo, cs + 2 * QT, 8 * j, 8 * n,
                                                          lane);
                        mma_3xtf32(acc_q[n], ahi, alo, bhi, blo);
                    }
                }
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int r = qr + g + 8 * h, key = kr + g + 8 * h;
                    if (r < nrows) {
                        float* row = dq + base + size_t(r) * d;
                        const float mul = last_q ? scale : 1.f;
#pragma unroll
                        for (int n = 0; n < W / 8; ++n)
                            store_pair_f32(row, c0 + 8 * n + 2 * t4, acc_q[n][2 * h] * mul,
                                           acc_q[n][2 * h + 1] * mul, d, pairs);
                    }
                    if (key < nrows) {
                        float* row = kv + base + size_t(key) * d;
                        const float mul = last_kv && is_dk ? scale : 1.f;
#pragma unroll
                        for (int n = 0; n < W / 8; ++n)
                            store_pair_f32(row, c0 + 8 * n + 2 * t4, acc_kv[n][2 * h] * mul,
                                           acc_kv[n][2 * h + 1] * mul, d, pairs);
                    }
                }
                __syncthreads();  // no warp reads stage st's buffers any more
            }
        }
    }
}

// ---------------------------------------------------------------------------
// fp32, head dims up to 128: the dk/dv and dq kernels on 3xTF32
// ---------------------------------------------------------------------------
//
// The bf16 pair's layout (flash_bwd_{dkdv,dq}_mma_kernel) in fp32, every
// product in 3xTF32 on the tensor cores (mma_common.cuh: about fp32's
// accuracy). Each operand is split into hi and lo at its fragment load as
// CUTLASS's fast fp32 products split it (F32N_SPLIT: hi rounded by its bits,
// lo = x - hi cut to TF32 by the tensor cores), and the three TF32 products
// of F32N_GROUP k-steps are summed in a fresh fragment before it is added to
// S, dP or the outputs in fp32. They replace a CUDA-core pair (4x8 register
// blocks on transposed tiles copied synchronously, P and dS through shared
// memory, dk, dv and dq summed one row at a time): 6.46 + 2.68 ms at
// (32, 2, 1408, 68) on an NVIDIA H100 80GB HBM3 at 700 W, 2.1x SDPA's fp32
// backward (PERF.md).
//   * flash_bwd_dkdv_tf32_kernel: a block of F32N_WARPS warps owns
//     F32N_OWN keys, K and V resident in shared memory, and loops over the
//     query rows in tiles of F32N_TILE, Q and dO double-buffered by cp.async
//     and the next tile's row statistics prefetched into registers. A warp
//     computes S^T = K Q^T and dP^T = V dO^T of its 16 keys by the tile's
//     rows (s_dp_narrow), P^T and dS^T on those fragments (p_ds_keys_tf32:
//     a key's flag per fragment row; m, 1/l and D per column), and takes
//     them as the A fragments (c_as_a_tf32: m16n8k8.tf32's C fragment is its
//     own A fragment) of dv += P^T dO and dk += dS^T Q, B read from the same
//     Q and dO tiles (product_c_tf32).
//   * flash_bwd_dq_tf32_kernel: the same untransposed. A warp owns 16 query
//     rows (Q and dO resident; m, 1/l, D in registers) and the block loops
//     over the keys in tiles of F32N_TILE (K, V and the keys' flags
//     double-buffered): S = Q K^T, dP = dO V^T, dS (ds_rows_tf32), dq += dS K.
// P and dS never touch shared memory. The head dim is padded to a multiple
// of 8, TF32's k-step (NC = 1 .. 16 steps; 68 -> 72): tiles of rows of
// 8 * NC + 4 floats, 4 times an odd number, so a fragment's reads meet 32
// distinct banks, with zero pad columns. The tiles are copied whole by
// 16-byte cp.async where d % 4 == 0 (load_tile_f32: at d = 68 a row is 272
// bytes), else by narrower copies (chunk_copy_f32). All sums are fp32 and
// there are no atomics: the same inputs give the same bits.
// What bounds it: the products, 8 * B*H*N^2*d operations (dk/dv) and
// 6 * B*H*N^2*d (dq), each taken as three TF32 products (bounds of 0.418
// and 0.314 ms at (32, 2, 1408, 68)), and the instructions that feed them:
// each operand's loads and split, for every warp that reads it, and the
// fp32 additions of the partial sums; the bytes, about 7 * B*H*N*d * 4, are
// far below. On an NVIDIA H100 80GB HBM3 at 700 W (PERF.md): 1.43 + 1.17 ms
// at (32, 2, 1408, 68), against SDPA's fp32 backward 4.40; summing each
// k-step's products in a fresh fragment took 2.19 + 1.69, lo rounded to
// TF32 1.52 + 1.31, 8 warps a block 1.57 + 1.16, 64-row tiles (spilling)
// 2.29 + 1.40 (tools/kernel_variants.py's f32n_* variants).

// F32N: the fp32 kernels of d <= 128 (narrow)
constexpr int F32N_WARPS = 4;              // warps a block
constexpr int F32N_NT = 32 * F32N_WARPS;   // threads a block
constexpr int F32N_OWN = 16 * F32N_WARPS;  // rows a block owns: keys (dk/dv) or query rows (dq)
constexpr int F32N_TILE = 32;              // rows of the tiles it loops over: queries or keys
// blocks an SM the registers are cut for: two blocks of 4 warps fit the
// shared memory at d = 68 (left to itself, ptxas cut some instantiations to
// three blocks' 168 registers and spilled)
constexpr int F32N_BLOCKS = 8 / F32N_WARPS;
// how the operands are split (mma_common.cuh: hi rounded to TF32, lo = x - hi
// cut to TF32 by the tensor cores, three instructions a value)
constexpr int F32N_SPLIT = SPLIT_INT_CUT;
// k-steps (8-deep) whose 3xTF32 products a fresh fragment sums before it is
// added to S, dP or the outputs in fp32 (1: every k-step, as mma_3xtf32)
constexpr int F32N_GROUP = 4;

// rows of the loop's tile whose S and dP (S^T and dP^T) a warp holds at a
// time: the whole tile, or half of it where the accumulators (dk and dv:
// 8 * nc registers a thread; dq: 4 * nc) leave no room for more (the whole
// tile spilled at 255 registers: dk/dv at nc = 11 and 13, dq at 15 and 16)
__host__ __device__ constexpr int dkdv_sub(int nc) { return nc > 10 ? F32N_TILE / 2 : F32N_TILE; }
__host__ __device__ constexpr int dq_sub(int nc) { return nc > 14 ? F32N_TILE / 2 : F32N_TILE; }

// two resident [F32N_OWN][8 * nc + 4] fp32 tiles, two stages of two
// [F32N_TILE][8 * nc + 4] tiles, and two stages of 3 * F32N_TILE 4-byte
// values (row statistics or key flags)
__host__ __device__ constexpr size_t narrow_tf32_smem_bytes(int nc) {
    return (size_t(2) * F32N_OWN + size_t(4) * F32N_TILE) * (8 * nc + 4) * sizeof(float)
           + size_t(6) * F32N_TILE * 4;
}

// The dk/dv kernel's arithmetic on S^T and dP^T (fragment rows: the thread's
// two keys, with their flags; 8-column tiles j: query rows): P^T in place of
// S^T and dS^T in place of dP^T. A masked key's logit is -1e9 and its
// dS = 0; a key past N has P = dS = 0. st points at the statistics
// [m, 1/l, D][TS] of the thread's first column (2 * (lane % 4) past the
// tile's first query row), TS the rows of the query tile.
template <int NJ, int TS = F32N_TILE>
__device__ __forceinline__ void p_ds_keys_tf32(float (&s)[NJ][4], float (&dp)[NJ][4],
                                               const float* st, const int (&flag)[2],
                                               float scale) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
        const float2 m2 = *reinterpret_cast<const float2*>(st + 8 * j);
        const float2 inv2 = *reinterpret_cast<const float2*>(st + TS + 8 * j);
        const float2 D2 = *reinterpret_cast<const float2*>(st + 2 * TS + 8 * j);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const bool real = flag[h] == KEY_REAL, in = flag[h] != KEY_OUT;
            const float x0 = real ? s[j][2 * h] * scale : MASKED_LOGIT;
            const float x1 = real ? s[j][2 * h + 1] * scale : MASKED_LOGIT;
            // a query row past N has 1/l = 0 here and zero q, dO rows: P = dS = 0
            const float p0 = in ? expf(x0 - m2.x) * inv2.x : 0.f;
            const float p1 = in ? expf(x1 - m2.y) * inv2.y : 0.f;
            dp[j][2 * h] = real ? p0 * (dp[j][2 * h] - D2.x) : 0.f;
            dp[j][2 * h + 1] = real ? p1 * (dp[j][2 * h + 1] - D2.y) : 0.f;
            s[j][2 * h] = p0;
            s[j][2 * h + 1] = p1;
        }
    }
}

// The dq kernel's arithmetic on S and dP (fragment rows: the thread's two
// query rows, with m, 1/l, D; 8-column tiles j: keys): dS in place of dP.
// kf points at the flag of the thread's first key. A masked key and a key
// past N have dS = 0; a query row past N has 1/l = 0, so dS = 0.
template <int NJ>
__device__ __forceinline__ void ds_rows_tf32(const float (&s)[NJ][4], float (&dp)[NJ][4],
                                             const int* kf, const float (&m)[2],
                                             const float (&inv)[2], const float (&D)[2],
                                             float scale) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
        const int2 f2 = *reinterpret_cast<const int2*>(kf + 8 * j);
        const bool real0 = f2.x == KEY_REAL, real1 = f2.y == KEY_REAL;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const float p0 = expf(s[j][2 * h] * scale - m[h]) * inv[h];
            const float p1 = expf(s[j][2 * h + 1] * scale - m[h]) * inv[h];
            dp[j][2 * h] = real0 ? p0 * (dp[j][2 * h] - D[h]) : 0.f;
            dp[j][2 * h + 1] = real1 ? p1 * (dp[j][2 * h + 1] - D[h]) : 0.f;
        }
    }
}

// s += A B^T and dp += A2 B2^T in 3xTF32 over the DP columns: A and A2 the
// warp's 16 rows (from row0) of the [*][DP + 4] tiles At and A2t, B and B2
// the rows 0 .. 8*NJ - 1 of Bt and B2t; each F32N_GROUP k-steps summed in
// fresh fragments, then added
template <int DP, int NJ>
__device__ __forceinline__ void s_dp_narrow(float (&s)[NJ][4], float (&dp)[NJ][4],
                                            const float* At, const float* Bt, const float* A2t,
                                            const float* B2t, int row0, int lane) {
    constexpr int LD = DP + 4, KS = DP / 8;
#pragma unroll
    for (int g = 0; g < KS; g += F32N_GROUP) {
        float ts[NJ][4], tdp[NJ][4];
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) ts[j][e] = tdp[j][e] = 0.f;
#pragma unroll
        for (int ks = g; ks < (g + F32N_GROUP < KS ? g + F32N_GROUP : KS); ++ks) {
            uint32_t ahi[4], alo[4], bhi[2], blo[2];
            frag_a_tf32<LD, F32N_SPLIT>(ahi, alo, At, row0, 8 * ks, lane);
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                frag_b_nk_tf32<LD, F32N_SPLIT>(bhi, blo, Bt, 8 * j, 8 * ks, lane);
                mma_3xtf32_into(ts[j], ahi, alo, bhi, blo);
            }
            frag_a_tf32<LD, F32N_SPLIT>(ahi, alo, A2t, row0, 8 * ks, lane);
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                frag_b_nk_tf32<LD, F32N_SPLIT>(bhi, blo, B2t, 8 * j, 8 * ks, lane);
                mma_3xtf32_into(tdp[j], ahi, alo, bhi, blo);
            }
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                s[j][e] += ts[j][e];
                dp[j][e] += tdp[j][e];
            }
    }
}

// acc[n] (16 x 8: output columns 8n .. 8n + 7) += A B in 3xTF32, where A is
// the 16 x 8*NJ matrix whose C fragments are c[j] (its k = the tile's rows
// 8j .. 8j + 7: c_as_a_tf32, all split first) and B the rows 0 .. 8*NJ - 1
// of the [*][LD] tile, which holds B as [k][n] (frag_b_kn_tf32); each
// F32N_GROUP k-steps summed in a fresh fragment, then added
template <int LD, int NJ, int NN>
__device__ __forceinline__ void product_c_tf32(float (&acc)[NN][4], const float (&c)[NJ][4],
                                               const float* tile, int lane) {
    uint32_t ahi[NJ][4], alo[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) c_as_a_tf32<F32N_SPLIT>(ahi[j], alo[j], c[j]);
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int g = 0; g < NJ; g += F32N_GROUP) {
            float tc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int j = g; j < (g + F32N_GROUP < NJ ? g + F32N_GROUP : NJ); ++j) {
                uint32_t bhi[2], blo[2];
                frag_b_kn_tf32<LD, F32N_SPLIT>(bhi, blo, tile, 8 * j, 8 * n, lane);
                mma_3xtf32_into(tc, ahi[j], alo[j], bhi, blo);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[n][e] += tc[e];
        }
}

template <int NC>
__global__ void __launch_bounds__(F32N_NT, F32N_BLOCKS)
flash_bwd_dkdv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ dout,
                           const float* __restrict__ row_max, const float* __restrict__ row_sum,
                           const float* __restrict__ dsum, const uint8_t* __restrict__ mask,
                           float* __restrict__ dk, float* __restrict__ dv, int H, int N, int d,
                           float scale, int copy, int how) {
    constexpr int LD = 8 * NC + 4;
    constexpr int TS = F32N_TILE * LD;  // a Q or dO tile
    constexpr int SUB = dkdv_sub(NC);   // query rows of S^T and dP^T held at a time
    constexpr int NJ = SUB / 8;         // their 8-column tiles
    extern __shared__ uint4 smem_mma[];
    float* Ks = reinterpret_cast<float*>(smem_mma);  // the block's keys, resident
    float* Vs = Ks + F32N_OWN * LD;
    float* Qs = Vs + F32N_OWN * LD;                  // two buffers each
    float* dOs = Qs + 2 * TS;
    float* stats = dOs + 2 * TS;                     // [2][m, 1/l, D][F32N_TILE]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    const int bh = blockIdx.y;
    const int b = bh / H;
    const int k0 = blockIdx.x * F32N_OWN;
    const size_t base = size_t(bh) * N * d;
    const size_t stat = size_t(bh) * N;
    const int krows = min(F32N_OWN, N - k0);
    const uint32_t magic = copy_magic(d);

    zero_pad_columns<F32N_NT, LD>(Ks, 2 * F32N_OWN + 4 * F32N_TILE, d);
    load_tile_f32<F32N_NT, LD, F32N_OWN>(Ks, k + base + size_t(k0) * d, krows, d, copy, magic);
    load_tile_f32<F32N_NT, LD, F32N_OWN>(Vs, v + base + size_t(k0) * d, krows, d, copy, magic);
    load_tile_f32<F32N_NT, LD, F32N_TILE>(Qs, q + base, min(F32N_TILE, N), d, copy, magic);
    load_tile_f32<F32N_NT, LD, F32N_TILE>(dOs, dout + base, min(F32N_TILE, N), d, copy, magic);
    cp_async_commit();
    if (tid < F32N_TILE) {
        const bool in = tid < N;
        stats[tid] = in ? row_max[stat + tid] : 0.f;
        stats[F32N_TILE + tid] = in ? 1.f / row_sum[stat + tid] : 0.f;  // l >= 1
        stats[2 * F32N_TILE + tid] = in ? dsum[stat + tid] : 0.f;
    }
    int flag[2];  // of the thread's two keys: rows g and g + 8 of the warp's 16
#pragma unroll
    for (int h = 0; h < 2; ++h)
        flag[h] = key_flag(mask + size_t(b) * N, k0 + warp * 16 + g + 8 * h, N);

    float acc_k[NC][4], acc_v[NC][4];
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

    cp_async_wait_all();
    __syncthreads();

    const int tiles = (N + F32N_TILE - 1) / F32N_TILE;
    for (int t = 0; t < tiles; ++t) {
        const int buf = t & 1;
        const bool more = t + 1 < tiles;
        // the next query tile: copies in flight, its statistics in registers
        float next_m = 0.f, next_l = 1.f, next_D = 0.f;
        bool next_in = false;
        if (more) {
            const int q1 = (t + 1) * F32N_TILE;
            const int nrows = min(F32N_TILE, N - q1);
            load_tile_f32<F32N_NT, LD, F32N_TILE>(Qs + (buf ^ 1) * TS, q + base + size_t(q1) * d,
                                                  nrows, d, copy, magic);
            load_tile_f32<F32N_NT, LD, F32N_TILE>(dOs + (buf ^ 1) * TS,
                                                  dout + base + size_t(q1) * d, nrows, d, copy,
                                                  magic);
            cp_async_commit();
            next_in = tid < F32N_TILE && q1 + tid < N;
            if (next_in) {
                next_m = row_max[stat + q1 + tid];
                next_l = row_sum[stat + q1 + tid];
                next_D = dsum[stat + q1 + tid];
            }
        }

#pragma unroll 1
        for (int sub = 0; sub < F32N_TILE; sub += SUB) {
            const float* Qt = Qs + buf * TS + sub * LD;
            const float* dOt = dOs + buf * TS + sub * LD;
            // S^T and dP^T: the warp's 16 keys by SUB query rows of the tile
            float s[NJ][4], dp[NJ][4];
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
            s_dp_narrow<8 * NC, NJ>(s, dp, Ks, Qt, Vs, dOt, warp * 16, lane);
            p_ds_keys_tf32<NJ>(s, dp, stats + buf * 3 * F32N_TILE + sub + 2 * t4, flag, scale);
            product_c_tf32<LD, NJ, NC>(acc_v, s, dOt, lane);  // dv += P^T dO
            product_c_tf32<LD, NJ, NC>(acc_k, dp, Qt, lane);  // dk += dS^T Q
        }

        if (more && tid < F32N_TILE) {
            float* nx = stats + (buf ^ 1) * 3 * F32N_TILE;
            nx[tid] = next_m;
            nx[F32N_TILE + tid] = next_in ? 1.f / next_l : 0.f;
            nx[2 * F32N_TILE + tid] = next_D;
        }
        cp_async_wait_all();
        __syncthreads();  // tile t+1 has landed, and no warp reads tile t any more
    }

    const bool pairs = how & STORE_PAIRS;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + g + 8 * h;
        if (r >= krows) continue;
        float* dkrow = dk + base + size_t(k0 + r) * d;
        float* dvrow = dv + base + size_t(k0 + r) * d;
#pragma unroll
        for (int n = 0; n < NC; ++n) {
            const int col = 8 * n + 2 * t4;
            store_pair_f32(dkrow, col, acc_k[n][2 * h] * scale, acc_k[n][2 * h + 1] * scale, d,
                           pairs);
            store_pair_f32(dvrow, col, acc_v[n][2 * h], acc_v[n][2 * h + 1], d, pairs);
        }
    }
}

template <int NC>
__global__ void __launch_bounds__(F32N_NT, F32N_BLOCKS)
flash_bwd_dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ row_max, const float* __restrict__ row_sum,
                         const float* __restrict__ dsum, const uint8_t* __restrict__ mask,
                         float* __restrict__ dq, int H, int N, int d, float scale, int copy,
                         int how) {
    constexpr int LD = 8 * NC + 4;
    constexpr int TS = F32N_TILE * LD;  // a K or V tile
    constexpr int SUB = dq_sub(NC);     // keys of S and dP held at a time
    constexpr int NJ = SUB / 8;         // their 8-column tiles
    extern __shared__ uint4 smem_mma[];
    float* Qs = reinterpret_cast<float*>(smem_mma);  // the block's query rows, resident
    float* dOs = Qs + F32N_OWN * LD;
    float* Ks = dOs + F32N_OWN * LD;                 // two buffers each
    float* Vs = Ks + 2 * TS;
    int* kflag = reinterpret_cast<int*>(Vs + 2 * TS);  // [2][F32N_TILE]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    const int bh = blockIdx.y;
    const int b = bh / H;
    const int q0 = blockIdx.x * F32N_OWN;
    const size_t base = size_t(bh) * N * d;
    const size_t stat = size_t(bh) * N;
    const int qrows = min(F32N_OWN, N - q0);
    const uint8_t* mask_row = mask + size_t(b) * N;
    const uint32_t magic = copy_magic(d);

    zero_pad_columns<F32N_NT, LD>(Qs, 2 * F32N_OWN + 4 * F32N_TILE, d);
    load_tile_f32<F32N_NT, LD, F32N_OWN>(Qs, q + base + size_t(q0) * d, qrows, d, copy, magic);
    load_tile_f32<F32N_NT, LD, F32N_OWN>(dOs, dout + base + size_t(q0) * d, qrows, d, copy,
                                         magic);
    load_tile_f32<F32N_NT, LD, F32N_TILE>(Ks, k + base, min(F32N_TILE, N), d, copy, magic);
    load_tile_f32<F32N_NT, LD, F32N_TILE>(Vs, v + base, min(F32N_TILE, N), d, copy, magic);
    cp_async_commit();
    if (tid < F32N_TILE) kflag[tid] = key_flag(mask_row, tid, N);
    float m[2], inv[2], D[2];  // of the thread's two query rows: g and g + 8 of the warp's 16
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + g + 8 * h;
        const bool in = r < qrows;  // a row past N: zero q and dO rows, 1/l = 0, so dS = 0
        m[h] = in ? row_max[stat + q0 + r] : 0.f;
        inv[h] = in ? 1.f / row_sum[stat + q0 + r] : 0.f;  // l >= 1
        D[h] = in ? dsum[stat + q0 + r] : 0.f;
    }

    float acc[NC][4];
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

    cp_async_wait_all();
    __syncthreads();

    const int tiles = (N + F32N_TILE - 1) / F32N_TILE;
    for (int t = 0; t < tiles; ++t) {
        const int buf = t & 1;
        const bool more = t + 1 < tiles;
        int next_flag = KEY_OUT;
        if (more) {  // the next key tile: copies in flight, its flags in a register
            const int k1 = (t + 1) * F32N_TILE;
            const int nrows = min(F32N_TILE, N - k1);
            load_tile_f32<F32N_NT, LD, F32N_TILE>(Ks + (buf ^ 1) * TS, k + base + size_t(k1) * d,
                                                  nrows, d, copy, magic);
            load_tile_f32<F32N_NT, LD, F32N_TILE>(Vs + (buf ^ 1) * TS, v + base + size_t(k1) * d,
                                                  nrows, d, copy, magic);
            cp_async_commit();
            if (tid < F32N_TILE) next_flag = key_flag(mask_row, k1 + tid, N);
        }

#pragma unroll 1
        for (int sub = 0; sub < F32N_TILE; sub += SUB) {
            const float* Kt = Ks + buf * TS + sub * LD;
            const float* Vt = Vs + buf * TS + sub * LD;
            // S and dP: the warp's 16 query rows by SUB keys of the tile
            float s[NJ][4], dp[NJ][4];
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
            s_dp_narrow<8 * NC, NJ>(s, dp, Qs, Kt, dOs, Vt, warp * 16, lane);
            ds_rows_tf32<NJ>(s, dp, kflag + buf * F32N_TILE + sub + 2 * t4, m, inv, D, scale);
            product_c_tf32<LD, NJ, NC>(acc, dp, Kt, lane);  // dq += dS K
        }

        if (more && tid < F32N_TILE) kflag[(buf ^ 1) * F32N_TILE + tid] = next_flag;
        cp_async_wait_all();
        __syncthreads();  // tile t+1 has landed, and no warp reads tile t any more
    }

    const bool pairs = how & STORE_PAIRS;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + g + 8 * h;
        if (r >= qrows) continue;
        float* dqrow = dq + base + size_t(q0 + r) * d;
#pragma unroll
        for (int n = 0; n < NC; ++n)
            store_pair_f32(dqrow, 8 * n + 2 * t4, acc[n][2 * h] * scale,
                           acc[n][2 * h + 1] * scale, d, pairs);
    }
}

// ---------------------------------------------------------------------------
// fp32, d > 128: the dk/dv and dq wide kernels on 3xTF32
// ---------------------------------------------------------------------------
//
// flash_bwd_dkdv_wide_tf32_kernel and flash_bwd_dq_wide_tf32_kernel take
// every fp32 backward at d > 128 that the packed, list and long kernels do
// not (lists of more than 256 docs; any N through these entries). They
// replace a CUDA-core pair that split the outputs into 64-column chunks over
// the grid and computed S, P, dP and dS once per chunk: 14.36 + 7.24 ms at
// (32, 1, 1408, 136) on an NVIDIA H100 80GB HBM3 at 700 W, against SDPA's
// fp32 backward at 3.91 (PERF.md). They are the pair of d <= 128
// (flash_bwd_{dkdv,dq}_tf32_kernel) with the fp32 wide forward's layout
// (flash_attn_fwd.cu's flash_fwd_wide_tf32_kernel): a block of F32W_WARPS
// warps owns F32W_OWN rows of one (b, h), 16 a warp, and ALL of their output
// columns, and loops over tiles of F32W_TILE rows:
//   * dk/dv: the block's keys, and the query rows in tiles (their m, 1/l
//     and D staged in shared memory with the tile's first copies). A warp
//     computes S^T = K Q^T and dP^T = V dO^T of its 16 keys by the tile's
//     64 query rows over d in W-column chunks (cp.async, double-buffered),
//     P^T and dS^T on those fragments (p_ds_keys_tf32), split once into
//     TF32 parts, and for each W-column output chunk of the tile's dO and Q,
//     dv += P^T dO and dk += dS^T Q;
//   * dq: the same untransposed: the block's query rows (m, 1/l, D in
//     registers), the keys in tiles (their flags staged), S = Q K^T and
//     dP = dO V^T, dS (ds_rows_tf32), and dq += dS K for each output chunk
//     of the tile's K.
// Every product is 3xTF32 with the d <= 128 kernels' split (F32N_SPLIT), a
// chunk's four k-steps summed in a fresh fragment, then added in fp32. S,
// P, dP and dS are computed once per (row tile, loop tile) for every output
// column; the outputs' C fragments stay in shared memory, each thread's own
// float4 slots. Past d = 376 (dk/dv: two accumulators) and d = 752 (dq) the
// block runs its output groups in turn (wide_tf32_group), S and dP computed
// again for each. grid.x folds (b*h, 64-row tile), so any batch is one
// launch. All sums are fp32 and there are no atomics: the same inputs give
// the same bits.
// What bounds them: the products, 8 * B*H*N^2*d operations (dk/dv) and
// 6 * B*H*N^2*d (dq), three TF32 products each: 0.418 and 0.314 ms at
// (32, 1, 1408, 136) at 495 TFLOP/s; the bytes (the loop tile's rows re-read
// for each row tile, mostly from L2) far below; before either, the
// instructions that feed the tensor cores, as in the forward. On an NVIDIA
// H100 80GB HBM3 at 700 W (tools/kernel_variants.py, PERF.md): 1.96 + 1.48
// ms at (32, 1, 1408, 136), 4.7x their bounds, against SDPA's fp32 backward
// at 3.91; at d = 350 and 384 (512 docs) they lose to it, 0.93 + 0.67 and
// 1.36 + 0.67 against 0.78 and 1.11: dk/dv's two accumulators of 64 x 352
// floats leave one block of 4 warps an SM (at 384, two output groups).

// columns of the fp32 wide kernels' d-chunks and output chunks (PERF.md);
// blocks an SM the registers are cut for
constexpr int F32W_CW = 32;
constexpr int F32W_BLOCKS = 2;

// The accumulator's output tile nt (its C fragment in the thread's slot of
// acc) += A B in 3xTF32: A the 16 x 8*NJ matrix split in registers (hi, lo:
// C fragments as A fragments, k = the loop tile's rows), B columns 8n ..
// 8n + 7 of the [*][LD] tile held as [k][n]; F32N_GROUP k-steps a fresh
// fragment, then added
template <int LD, int NJ>
__device__ __forceinline__ void acc_product_tf32(float4* acc, const uint32_t (&hi)[NJ][4],
                                                 const uint32_t (&lo)[NJ][4], const float* tile,
                                                 int n, int lane) {
    float4 a = *acc;
#pragma unroll
    for (int j0 = 0; j0 < NJ; j0 += F32N_GROUP) {
        float tc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = j0; j < j0 + F32N_GROUP; ++j) {
            uint32_t bhi[2], blo[2];
            frag_b_kn_tf32<LD, F32N_SPLIT>(bhi, blo, tile, 8 * j, 8 * n, lane);
            mma_3xtf32_into(tc, hi[j], lo[j], bhi, blo);
        }
        a.x += tc[0];
        a.y += tc[1];
        a.z += tc[2];
        a.w += tc[3];
    }
    *acc = a;
}

template <int W>
__global__ void __launch_bounds__(F32W_NT, F32W_BLOCKS)
flash_bwd_dkdv_wide_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const float* __restrict__ dout,
                                const float* __restrict__ row_max,
                                const float* __restrict__ row_sum, const float* __restrict__ dsum,
                                const uint8_t* __restrict__ mask, float* __restrict__ dk,
                                float* __restrict__ dv, int H, int N, int d, float scale, int copy,
                                int how, int cg) {
    constexpr int NT = F32W_NT, LD = W + 4, TS = F32W_TILE;
    constexpr int STAGE = (F32W_OWN + TS) * LD;  // two chunk tiles
    constexpr int NJ = TS / 8;                   // 8-column tiles of S^T and dP^T: query rows
    constexpr int CT = W / 8;                    // 8-column tiles of an output chunk
    extern __shared__ uint4 smem_mma[];
    float4* acc_k = reinterpret_cast<float4*>(smem_mma);  // [cg / 8][NT] each
    float4* acc_v = acc_k + (cg / 8) * NT;
    float* Cs = reinterpret_cast<float*>(acc_v + (cg / 8) * NT);  // [2][STAGE]
    float* stats = Cs + 2 * STAGE;                               // [2][m, 1/l, D][TS]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    int oc_unused, bh;
    const int k0 = fold_wide(N, d, d, oc_unused, bh);
    const int b = bh / H;
    const size_t base = size_t(bh) * N * d;
    const size_t stat = size_t(bh) * N;
    const int krows = min(F32W_OWN, N - k0);
    const float* kb = k + base + size_t(k0) * d;
    const float* vb = v + base + size_t(k0) * d;
    const WideStages sg{2, (d + W - 1) / W, (N + TS - 1) / TS, d, cg, W};
    const int stages = sg.total();
    int flag[2];  // of the thread's two keys: rows g and g + 8 of the warp's 16
#pragma unroll
    for (int h = 0; h < 2; ++h)
        flag[h] = key_flag(mask + size_t(b) * N, k0 + warp * 16 + g + 8 * h, N);

    // S stages: the block's K chunk and the query tile's Q chunk (the first
    // also brings the tile's statistics); dP stages: V and dO; output
    // stages: the tile's dO and Q chunks of the output columns
    auto prefetch = [&](int st) {
        int gi, t, c;
        sg.decode(st, gi, t, c);
        const int q1 = t * TS, nq = min(TS, N - q1);
        const size_t qoff = base + size_t(q1) * d;
        float* cs = Cs + (st & 1) * STAGE;
        if (c < sg.products * sg.chunks) {
            const bool s_stage = c < sg.chunks;
            const int c0 = (s_stage ? c : c - sg.chunks) * W;
            load_rows_f32<NT, W, F32W_OWN>(cs, s_stage ? kb : vb, krows, d, c0, copy);
            load_rows_f32<NT, W, TS>(cs + F32W_OWN * LD, (s_stage ? q : dout) + qoff, nq, d, c0,
                                     copy);
            if (c == 0 && tid < TS) {  // the buffer of the tile's parity over all groups
                float* sb = stats + ((gi * sg.tiles + t) & 1) * 3 * TS;
                const bool in = tid < nq;  // a row past N: 1/l = 0, so P = dS = 0
                sb[tid] = in ? row_max[stat + q1 + tid] : 0.f;
                sb[TS + tid] = in ? 1.f / row_sum[stat + q1 + tid] : 0.f;  // l >= 1
                sb[2 * TS + tid] = in ? dsum[stat + q1 + tid] : 0.f;
            }
        } else {
            const int c0 = gi * cg + (c - sg.products * sg.chunks) * W;
            load_rows_f32<NT, W, TS>(cs, dout + qoff, nq, d, c0, copy);
            load_rows_f32<NT, W, TS>(cs + TS * LD, q + qoff, nq, d, c0, copy);
        }
        cp_async_commit();
    };
    int st = 0;
    auto next = [&]() -> const float* {  // stage st, landed; stage st + 1 in flight
        if (st + 1 < stages) {
            prefetch(st + 1);
            cp_async_wait_prior();
        } else {
            cp_async_wait_all();
        }
        __syncthreads();
        return Cs + (st & 1) * STAGE;
    };

    prefetch(0);
    const bool pairs = how & STORE_PAIRS;
    int tt = 0;  // query tiles so far over all groups: their statistics' buffer by parity
    for (int gi = 0; gi * cg < d; ++gi) {
        const int c0 = gi * cg, ntiles = (min(cg, d - c0) + 7) / 8;
        const int och = sg.out_chunks(gi);
        for (int n = 0; n < ntiles; ++n) {
            acc_k[n * NT + tid] = make_float4(0.f, 0.f, 0.f, 0.f);
            acc_v[n * NT + tid] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
        for (int t = 0; t < sg.tiles; ++t, ++tt) {
            // S^T and dP^T: the warp's 16 keys by the tile's query rows
            float s[NJ][4], dp[NJ][4];
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
            for (int c = 0; c < sg.chunks; ++c, ++st) {
                const float* cs = next();
                chunk_product_tf32<W, NJ, F32N_SPLIT>(s, cs, cs + F32W_OWN * LD, warp * 16,
                                                      c * W, d, lane);
                __syncthreads();  // no warp reads stage st's buffers any more
            }
            for (int c = 0; c < sg.chunks; ++c, ++st) {
                const float* cs = next();
                chunk_product_tf32<W, NJ, F32N_SPLIT>(dp, cs, cs + F32W_OWN * LD, warp * 16,
                                                      c * W, d, lane);
                __syncthreads();
            }
            p_ds_keys_tf32<NJ, TS>(s, dp, stats + (tt & 1) * 3 * TS + 2 * t4, flag, scale);
            uint32_t phi[NJ][4], plo[NJ][4], dhi[NJ][4], dlo[NJ][4];
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                c_as_a_tf32<F32N_SPLIT>(phi[j], plo[j], s[j]);
                c_as_a_tf32<F32N_SPLIT>(dhi[j], dlo[j], dp[j]);
            }
            for (int oc = 0; oc < och; ++oc, ++st) {
                const float* cs = next();
#pragma unroll
                for (int n = 0; n < CT; ++n) {
                    const int nt = oc * CT + n;
                    if (nt < ntiles) {
                        acc_product_tf32<LD, NJ>(acc_v + nt * NT + tid, phi, plo, cs, n, lane);
                        acc_product_tf32<LD, NJ>(acc_k + nt * NT + tid, dhi, dlo, cs + TS * LD, n,
                                                 lane);
                    }
                }
                __syncthreads();
            }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = warp * 16 + g + 8 * h;
            if (r >= krows) continue;
            float* dkrow = dk + base + size_t(k0 + r) * d;
            float* dvrow = dv + base + size_t(k0 + r) * d;
            for (int n = 0; n < ntiles; ++n) {
                const float4 ak = acc_k[n * NT + tid], av = acc_v[n * NT + tid];
                const int col = c0 + 8 * n + 2 * t4;
                store_pair_f32(dkrow, col, (h ? ak.z : ak.x) * scale, (h ? ak.w : ak.y) * scale,
                               d, pairs);
                store_pair_f32(dvrow, col, h ? av.z : av.x, h ? av.w : av.y, d, pairs);
            }
        }
    }
}

template <int W>
__global__ void __launch_bounds__(F32W_NT, F32W_BLOCKS)
flash_bwd_dq_wide_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ dout,
                              const float* __restrict__ row_max, const float* __restrict__ row_sum,
                              const float* __restrict__ dsum, const uint8_t* __restrict__ mask,
                              float* __restrict__ dq, int H, int N, int d, float scale, int copy,
                              int how, int cg) {
    constexpr int NT = F32W_NT, LD = W + 4, TS = F32W_TILE;
    constexpr int STAGE = (F32W_OWN + TS) * LD;
    constexpr int NJ = TS / 8;  // 8-column tiles of S and dP: keys
    constexpr int CT = W / 8;
    extern __shared__ uint4 smem_mma[];
    float4* acc = reinterpret_cast<float4*>(smem_mma);          // [cg / 8][NT]
    float* Cs = reinterpret_cast<float*>(acc + (cg / 8) * NT);  // [2][STAGE]
    int* kflag = reinterpret_cast<int*>(Cs + 2 * STAGE);        // [2][TS]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    int oc_unused, bh;
    const int q0 = fold_wide(N, d, d, oc_unused, bh);
    const int b = bh / H;
    const size_t base = size_t(bh) * N * d;
    const size_t stat = size_t(bh) * N;
    const int qrows = min(F32W_OWN, N - q0);
    const uint8_t* mask_row = mask + size_t(b) * N;
    const float* qb = q + base + size_t(q0) * d;
    const float* dob = dout + base + size_t(q0) * d;
    const WideStages sg{2, (d + W - 1) / W, (N + TS - 1) / TS, d, cg, W};
    const int stages = sg.total();
    float m[2], inv[2], D[2];  // of the thread's two query rows: g and g + 8 of the warp's 16
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + g + 8 * h;
        const bool in = r < qrows;  // a row past N: zero q and dO rows, 1/l = 0, so dS = 0
        m[h] = in ? row_max[stat + q0 + r] : 0.f;
        inv[h] = in ? 1.f / row_sum[stat + q0 + r] : 0.f;  // l >= 1
        D[h] = in ? dsum[stat + q0 + r] : 0.f;
    }

    // S stages: the block's Q chunk and the key tile's K chunk (the first
    // also brings the tile's key flags); dP stages: dO and V; output stages:
    // the tile's K chunk of the output columns
    auto prefetch = [&](int st) {
        int gi, t, c;
        sg.decode(st, gi, t, c);
        const int k1 = t * TS, nk = min(TS, N - k1);
        const size_t koff = base + size_t(k1) * d;
        float* cs = Cs + (st & 1) * STAGE;
        if (c < sg.products * sg.chunks) {
            const bool s_stage = c < sg.chunks;
            const int c0 = (s_stage ? c : c - sg.chunks) * W;
            load_rows_f32<NT, W, F32W_OWN>(cs, s_stage ? qb : dob, qrows, d, c0, copy);
            load_rows_f32<NT, W, TS>(cs + F32W_OWN * LD, (s_stage ? k : v) + koff, nk, d, c0,
                                     copy);
            if (c == 0 && tid < TS)  // the buffer of the tile's parity over all groups
                kflag[((gi * sg.tiles + t) & 1) * TS + tid] = key_flag(mask_row, k1 + tid, N);
        } else {
            load_rows_f32<NT, W, TS>(cs, k + koff, nk, d, gi * cg + (c - sg.products * sg.chunks) * W,
                                     copy);
        }
        cp_async_commit();
    };
    int st = 0;
    auto next = [&]() -> const float* {  // stage st, landed; stage st + 1 in flight
        if (st + 1 < stages) {
            prefetch(st + 1);
            cp_async_wait_prior();
        } else {
            cp_async_wait_all();
        }
        __syncthreads();
        return Cs + (st & 1) * STAGE;
    };

    prefetch(0);
    const bool pairs = how & STORE_PAIRS;
    int tt = 0;  // key tiles so far over all groups: their flags' buffer by parity
    for (int gi = 0; gi * cg < d; ++gi) {
        const int c0 = gi * cg, ntiles = (min(cg, d - c0) + 7) / 8;
        const int och = sg.out_chunks(gi);
        for (int n = 0; n < ntiles; ++n) acc[n * NT + tid] = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int t = 0; t < sg.tiles; ++t, ++tt) {
            // S and dP: the warp's 16 query rows by the tile's keys
            float s[NJ][4], dp[NJ][4];
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
            for (int c = 0; c < sg.chunks; ++c, ++st) {
                const float* cs = next();
                chunk_product_tf32<W, NJ, F32N_SPLIT>(s, cs, cs + F32W_OWN * LD, warp * 16,
                                                      c * W, d, lane);
                __syncthreads();  // no warp reads stage st's buffers any more
            }
            for (int c = 0; c < sg.chunks; ++c, ++st) {
                const float* cs = next();
                chunk_product_tf32<W, NJ, F32N_SPLIT>(dp, cs, cs + F32W_OWN * LD, warp * 16,
                                                      c * W, d, lane);
                __syncthreads();
            }
            ds_rows_tf32<NJ>(s, dp, kflag + (tt & 1) * TS + 2 * t4, m, inv, D, scale);
            uint32_t dhi[NJ][4], dlo[NJ][4];
#pragma unroll
            for (int j = 0; j < NJ; ++j) c_as_a_tf32<F32N_SPLIT>(dhi[j], dlo[j], dp[j]);
            for (int oc = 0; oc < och; ++oc, ++st) {
                const float* cs = next();
#pragma unroll
                for (int n = 0; n < CT; ++n) {
                    const int nt = oc * CT + n;
                    if (nt < ntiles)  // dq += dS K
                        acc_product_tf32<LD, NJ>(acc + nt * NT + tid, dhi, dlo, cs, n, lane);
                }
                __syncthreads();
            }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = warp * 16 + g + 8 * h;
            if (r >= qrows) continue;
            float* dqrow = dq + base + size_t(q0 + r) * d;
            for (int n = 0; n < ntiles; ++n) {
                const float4 a = acc[n * NT + tid];
                store_pair_f32(dqrow, c0 + 8 * n + 2 * t4, (h ? a.z : a.x) * scale,
                               (h ? a.w : a.y) * scale, d, pairs);
            }
        }
    }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

struct Args {
    const void *q, *k, *v, *dout, *row_max, *row_sum, *dsum, *mask;
    int B, H, N, d;
    cudaStream_t stream;
};

// 8-byte tile copies need rows of a multiple of 8 bytes on 8-byte-aligned tensors
int copy_mode(const Args& a) {
    const bool ok = a.d % 4 == 0 && aligned(a.q, 8) && aligned(a.k, 8) && aligned(a.v, 8)
                    && aligned(a.dout, 8);
    return ok ? COPY_8B : 0;
}

// 4-byte stores of two bf16 need even rows on a 4-byte-aligned tensor
int store_mode(const Args& a, const void* out) {
    return (a.d % 2 == 0 && aligned(out, 4)) ? STORE_PAIRS : 0;
}

template <int KC>
cudaError_t launch_dkdv_mma(const Args& a, void* dk, void* dv) {
    const size_t bytes = mma_smem_bytes(KC);
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_mma_kernel<KC>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
    if (err != cudaSuccess) return err;
    const dim3 grid((a.N + OWN - 1) / OWN, a.B * a.H);
    flash_bwd_dkdv_mma_kernel<KC><<<grid, MMA_NT, bytes, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
        static_cast<const float*>(a.row_max), static_cast<const float*>(a.row_sum),
        static_cast<const float*>(a.dsum), static_cast<const uint8_t*>(a.mask),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), a.H, a.N, a.d, 1.0f / sqrtf(float(a.d)),
        copy_mode(a) | (store_mode(a, dk) & store_mode(a, dv)));
    return cudaGetLastError();
}

template <int KC>
cudaError_t launch_dq_mma(const Args& a, void* dq) {
    const size_t bytes = mma_smem_bytes(KC);
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_mma_kernel<KC>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
    if (err != cudaSuccess) return err;
    const dim3 grid((a.N + OWN - 1) / OWN, a.B * a.H);
    flash_bwd_dq_mma_kernel<KC><<<grid, MMA_NT, bytes, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
        static_cast<const float*>(a.row_max), static_cast<const float*>(a.row_sum),
        static_cast<const float*>(a.dsum), static_cast<const uint8_t*>(a.mask),
        static_cast<bf16*>(dq), a.H, a.N, a.d, 1.0f / sqrtf(float(a.d)),
        copy_mode(a) | store_mode(a, dq));
    return cudaGetLastError();
}

// the widest copy of the fp32 inputs' rows (chunk_copy_f32: 4, 2 or 1 floats)
int f32_copy(const Args& a) {
    return chunk_copy_f32(a.d, std::min(std::min(alignment(a.q), alignment(a.k)),
                                        std::min(alignment(a.v), alignment(a.dout))));
}

// 8-byte stores of two floats need even rows on an 8-byte-aligned tensor
int store_mode_f32(const Args& a, const void* out) {
    return (a.d % 2 == 0 && aligned(out, 8)) ? STORE_PAIRS : 0;
}

template <int NC>
cudaError_t launch_dkdv_tf32(const Args& a, void* dk, void* dv) {
    const size_t bytes = narrow_tf32_smem_bytes(NC);
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_tf32_kernel<NC>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
    if (err != cudaSuccess) return err;
    const dim3 grid((a.N + F32N_OWN - 1) / F32N_OWN, a.B * a.H);
    flash_bwd_dkdv_tf32_kernel<NC><<<grid, F32N_NT, bytes, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        static_cast<const float*>(a.row_max), static_cast<const float*>(a.row_sum),
        static_cast<const float*>(a.dsum), static_cast<const uint8_t*>(a.mask),
        static_cast<float*>(dk), static_cast<float*>(dv), a.H, a.N, a.d,
        1.0f / sqrtf(float(a.d)), f32_copy(a), store_mode_f32(a, dk) & store_mode_f32(a, dv));
    return cudaGetLastError();
}

template <int NC>
cudaError_t launch_dq_tf32(const Args& a, void* dq) {
    const size_t bytes = narrow_tf32_smem_bytes(NC);
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_tf32_kernel<NC>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
    if (err != cudaSuccess) return err;
    const dim3 grid((a.N + F32N_OWN - 1) / F32N_OWN, a.B * a.H);
    flash_bwd_dq_tf32_kernel<NC><<<grid, F32N_NT, bytes, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        static_cast<const float*>(a.row_max), static_cast<const float*>(a.row_sum),
        static_cast<const float*>(a.dsum), static_cast<const uint8_t*>(a.mask),
        static_cast<float*>(dq), a.H, a.N, a.d, 1.0f / sqrtf(float(a.d)), f32_copy(a),
        store_mode_f32(a, dq));
    return cudaGetLastError();
}

// the widest copy of the bf16 wide kernels' chunks (mma_common.cuh)
int wide_copy(const Args& a) {
    return chunk_copy(a.d, std::min(std::min(alignment(a.q), alignment(a.k)),
                                    std::min(alignment(a.v), alignment(a.dout))));
}

cudaError_t launch_dkdv_wide(const Args& a, void* dk, void* dv) {
    const size_t bytes = wide_mma_smem_bytes(WIDE_CW_DKDV);
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_wide_mma_kernel<WIDE_CW_DKDV>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
    if (err != cudaSuccess) return err;
    const unsigned blocks = unsigned(wide_blocks(a.B, a.H, a.N, a.d, 16 * WIDE_CW_DKDV));
    flash_bwd_dkdv_wide_mma_kernel<WIDE_CW_DKDV><<<blocks, MMA_NT, bytes, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
        static_cast<const float*>(a.row_max), static_cast<const float*>(a.row_sum),
        static_cast<const float*>(a.dsum), static_cast<const uint8_t*>(a.mask),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), a.H, a.N, a.d, 1.0f / sqrtf(float(a.d)),
        wide_copy(a), store_mode(a, dk) & store_mode(a, dv));
    return cudaGetLastError();
}

cudaError_t launch_dq_wide(const Args& a, void* dq) {
    const size_t bytes = wide_mma_smem_bytes(WIDE_CW_DQ);
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_wide_mma_kernel<WIDE_CW_DQ>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
    if (err != cudaSuccess) return err;
    const unsigned blocks = unsigned(wide_blocks(a.B, a.H, a.N, a.d, 16 * WIDE_CW_DQ));
    flash_bwd_dq_wide_mma_kernel<WIDE_CW_DQ><<<blocks, MMA_NT, bytes, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
        static_cast<const float*>(a.row_max), static_cast<const float*>(a.row_sum),
        static_cast<const float*>(a.dsum), static_cast<const uint8_t*>(a.mask),
        static_cast<bf16*>(dq), a.H, a.N, a.d, 1.0f / sqrtf(float(a.d)), wide_copy(a),
        store_mode(a, dq));
    return cudaGetLastError();
}

// The fp32 wide kernels (3xTF32): one block per (b, h) and 64 rows on
// grid.x, the accumulators of an output group (wide_tf32_group) in shared
// memory, F32W_CW-column chunks
cudaError_t launch_dkdv_wide_tf32(const Args& a, void* dk, void* dv) {
    const auto kernel = flash_bwd_dkdv_wide_tf32_kernel<F32W_CW>;
    const int cg = wide_tf32_group(a.d, 2, F32W_CW);  // two accumulators: dk, dv
    const size_t bytes = wide_tf32_smem_bytes(cg, 2, F32W_CW);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           int(bytes));
    if (err != cudaSuccess) return err;
    kernel<<<unsigned(wide_blocks(a.B, a.H, a.N, a.d, a.d)), F32W_NT, bytes, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        static_cast<const float*>(a.row_max), static_cast<const float*>(a.row_sum),
        static_cast<const float*>(a.dsum), static_cast<const uint8_t*>(a.mask),
        static_cast<float*>(dk), static_cast<float*>(dv), a.H, a.N, a.d,
        1.0f / sqrtf(float(a.d)), f32_copy(a), store_mode_f32(a, dk) & store_mode_f32(a, dv),
        cg);
    return cudaGetLastError();
}

cudaError_t launch_dq_wide_tf32(const Args& a, void* dq) {
    const auto kernel = flash_bwd_dq_wide_tf32_kernel<F32W_CW>;
    const int cg = wide_tf32_group(a.d, 1, F32W_CW);  // one accumulator: dq
    const size_t bytes = wide_tf32_smem_bytes(cg, 1, F32W_CW);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           int(bytes));
    if (err != cudaSuccess) return err;
    kernel<<<unsigned(wide_blocks(a.B, a.H, a.N, a.d, a.d)), F32W_NT, bytes, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        static_cast<const float*>(a.row_max), static_cast<const float*>(a.row_sum),
        static_cast<const float*>(a.dsum), static_cast<const uint8_t*>(a.mask),
        static_cast<float*>(dq), a.H, a.N, a.d, 1.0f / sqrtf(float(a.d)), f32_copy(a),
        store_mode_f32(a, dq), cg);
    return cudaGetLastError();
}

// one block per tile of ROWS / N lists
template <int ROWS, int CW, bool KEEP, bool STAGED>
cudaError_t launch_packed_as(const Args& a, void* dq, void* dk, void* dv) {
    const auto kernel = flash_bwd_packed_mma_kernel<ROWS, CW, KEEP, STAGED>;
    const size_t bytes = packed_smem_bytes(ROWS, CW, KEEP, (a.d + DCH - 1) / DCH);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           int(bytes));
    if (err != cudaSuccess) return err;
    const int lists = a.B * a.H, per_tile = ROWS / a.N;
    kernel<<<unsigned((lists + per_tile - 1) / per_tile), 2 * ROWS, bytes, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
        static_cast<const float*>(a.row_max), static_cast<const float*>(a.row_sum),
        static_cast<const float*>(a.dsum), static_cast<const uint8_t*>(a.mask),
        static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv), lists, a.H, a.N,
        a.d, 1.0f / sqrtf(float(a.d)), wide_copy(a),
        store_mode(a, dq) & store_mode(a, dk) & store_mode(a, dv));
    return cudaGetLastError();
}

// Step 3's inputs kept where they fit the block's shared memory (d <= 448 on
// an H100), else re-read; with PACK_STAGED, kept Q, K, dO staged by 16-byte
// copies where the chunks' own copies are narrower and every tile's span
// (64 / N * N rows of d) starts 16-byte aligned. (Kept chunks are the output
// chunks: CW = 4 only.)
template <int CW>
cudaError_t launch_bwd_packed(const Args& a, void* dq, void* dk, void* dv) {
    if constexpr (PACK_KEEP && CW == DCH / 16) {
        int device = 0, most = 0;
        cudaError_t err = cudaGetDevice(&device);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
        if (err != cudaSuccess) return err;
        if (packed_smem_bytes(PACK_ROWS, CW, true, (a.d + DCH - 1) / DCH) <= size_t(most)) {
            if constexpr (PACK_STAGED) {
                if (wide_copy(a) != CHUNK_16B && a.d % 2 == 0
                    && (long long)(PACK_ROWS / a.N) * a.N * a.d % 8 == 0
                    && aligned(a.q, 16) && aligned(a.k, 16) && aligned(a.dout, 16))
                    return launch_packed_as<PACK_ROWS, CW, true, true>(a, dq, dk, dv);
            }
            return launch_packed_as<PACK_ROWS, CW, true, false>(a, dq, dk, dv);
        }
    }
    return launch_packed_as<PACK_ROWS, CW, false, false>(a, dq, dk, dv);
}

// The fp32 kernels of whole lists (3xTF32): one block of `threads` per tile
// of `rows` / N lists, the chunks' copies as wide as every input allows
template <typename Kernel>
cudaError_t launch_tf32(Kernel kernel, size_t bytes, int rows, int threads, const Args& a,
                        void* dq, void* dk, void* dv) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           int(bytes));
    if (err != cudaSuccess) return err;
    const int lists = a.B * a.H, per_tile = rows / a.N;
    kernel<<<unsigned((lists + per_tile - 1) / per_tile), threads, bytes, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        static_cast<const float*>(a.row_max), static_cast<const float*>(a.row_sum),
        static_cast<const float*>(a.dsum), static_cast<const uint8_t*>(a.mask),
        static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv), lists, a.H,
        a.N, a.d, 1.0f / sqrtf(float(a.d)), f32_copy(a),
        store_mode_f32(a, dq) & store_mode_f32(a, dk) & store_mode_f32(a, dv));
    return cudaGetLastError();
}

// the fp32 packed kernel: tiles of 64 / N lists
cudaError_t launch_bwd_packed_tf32(const Args& a, void* dq, void* dk, void* dv) {
    return launch_tf32(flash_bwd_packed_tf32_kernel<TF32_W>, packed_tf32_smem_bytes(TF32_W),
                       PACK_ROWS, PACK_NT, a, dq, dk, dv);
}

// the fp32 list (ROWS = LIST_ROWS) and long (LONG_ROWS) kernels: tiles of
// ROWS / N lists
template <int ROWS>
cudaError_t launch_bwd_list_tf32(const Args& a, void* dq, void* dk, void* dv) {
    return launch_tf32(flash_bwd_list_tf32_kernel<ROWS, F32_W>, list_tf32_smem_bytes(ROWS, F32_W),
                       ROWS, F32_NT, a, dq, dk, dv);
}

// One block per tile of LONG_ROWS / N lists (LONG_SUM 1, 2: two, one a half,
// then the partials' sum: two launches)
template <int SUM>
cudaError_t launch_bwd_long(const Args& a, void* dq, void* dk, void* dv, float* dq_part) {
    const auto kernel = flash_bwd_long_mma_kernel<LONG_CW, LONG_DQ_CW, SUM>;
    const size_t bytes = long_smem_bytes(LONG_CW, LONG_DQ_CW);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           int(bytes));
    if (err != cudaSuccess) return err;
    const int lists = a.B * a.H, per_tile = LONG_ROWS / a.N;
    const long long tiles = (lists + per_tile - 1) / per_tile;
    const size_t n = size_t(lists) * a.N * a.d;
    const float scale = 1.0f / sqrtf(float(a.d));
    if (SUM == 2) {
        err = cudaMemsetAsync(dq_part, 0, n * sizeof(float), a.stream);
        if (err != cudaSuccess) return err;
    }
    kernel<<<unsigned(SUM == 0 ? tiles : 2 * tiles), LONG_NT, bytes, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
        static_cast<const float*>(a.row_max), static_cast<const float*>(a.row_sum),
        static_cast<const float*>(a.dsum), static_cast<const uint8_t*>(a.mask),
        static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv), dq_part, lists,
        a.H, a.N, a.d, scale, wide_copy(a),
        store_mode(a, dq) & store_mode(a, dk) & store_mode(a, dv));
    err = cudaGetLastError();
    if constexpr (SUM != 0) {
        if (err != cudaSuccess) return err;
        const unsigned blocks = unsigned(std::min<size_t>((n + 255) / 256, 132 * 16));
        flash_bwd_long_dq_sum_kernel<SUM == 1 ? 2 : 1><<<blocks, 256, 0, a.stream>>>(
            dq_part, static_cast<bf16*>(dq), n, scale);
        err = cudaGetLastError();
    }
    return err;
}

// Any d: d <= 128 runs the kernels above (in launches of at most
// narrow_lists(H) lists), d > 128 the wide ones (fp32: a block owns every
// output column); the grids must fit (mma_common.cuh's grid_fits).
bool valid(const Args& a, int dtype) {
    if (a.B < 1 || a.H < 1 || a.N < 1 || a.d < 1 || (dtype != 0 && dtype != 1)) return false;
    return grid_fits(a.B, a.H, a.N, a.d, dtype == 1 ? 16 * WIDE_CW_DKDV : a.d);
}

}  // namespace

// Dispatch for d <= 128: bf16 on the head dim padded to a multiple of 16
// (KC = 1 .. 8 steps of 16), fp32 on the head dim padded to a multiple of 8
// (NC = 1 .. 16 steps of 8, TF32's k-step).
#define FLASH_BWD_BF16_DISPATCH(LAUNCH)      \
    switch ((a.d + 15) / 16) {               \
        case 1: return int(LAUNCH<1> ARGS);  \
        case 2: return int(LAUNCH<2> ARGS);  \
        case 3: return int(LAUNCH<3> ARGS);  \
        case 4: return int(LAUNCH<4> ARGS);  \
        case 5: return int(LAUNCH<5> ARGS);  \
        case 6: return int(LAUNCH<6> ARGS);  \
        case 7: return int(LAUNCH<7> ARGS);  \
        case 8: return int(LAUNCH<8> ARGS);  \
    }
#define FLASH_BWD_F32_DISPATCH(LAUNCH)         \
    switch ((a.d + 7) / 8) {                   \
        case 1: return int(LAUNCH<1> ARGS);    \
        case 2: return int(LAUNCH<2> ARGS);    \
        case 3: return int(LAUNCH<3> ARGS);    \
        case 4: return int(LAUNCH<4> ARGS);    \
        case 5: return int(LAUNCH<5> ARGS);    \
        case 6: return int(LAUNCH<6> ARGS);    \
        case 7: return int(LAUNCH<7> ARGS);    \
        case 8: return int(LAUNCH<8> ARGS);    \
        case 9: return int(LAUNCH<9> ARGS);    \
        case 10: return int(LAUNCH<10> ARGS);  \
        case 11: return int(LAUNCH<11> ARGS);  \
        case 12: return int(LAUNCH<12> ARGS);  \
        case 13: return int(LAUNCH<13> ARGS);  \
        case 14: return int(LAUNCH<14> ARGS);  \
        case 15: return int(LAUNCH<15> ARGS);  \
        case 16: return int(LAUNCH<16> ARGS);  \
    }

namespace {

int narrow_dkdv(const Args& a, int dtype, void* dk, void* dv) {
#define ARGS (a, dk, dv)
    if (dtype == 1) {
        FLASH_BWD_BF16_DISPATCH(launch_dkdv_mma)
    } else {
        FLASH_BWD_F32_DISPATCH(launch_dkdv_tf32)
    }
#undef ARGS
    return int(cudaErrorInvalidValue);
}

int narrow_dq(const Args& a, int dtype, void* dq) {
#define ARGS (a, dq)
    if (dtype == 1) {
        FLASH_BWD_BF16_DISPATCH(launch_dq_mma)
    } else {
        FLASH_BWD_F32_DISPATCH(launch_dq_tf32)
    }
#undef ARGS
    return int(cudaErrorInvalidValue);
}

// d <= 128 in launches of at most narrow_lists(H) lists (mma_common.cuh):
// `run` is called with the arguments of lists b0 .. b0 + n - 1 and the byte
// offset of list b0 in a [B, H, N, d] tensor, for each launch in turn.
template <typename Run>
int by_lists(const Args& a, int dtype, Run run) {
    const size_t list = size_t(a.H) * a.N * a.d * (dtype == 1 ? 2 : 4);
    const size_t stat = size_t(a.H) * a.N * 4;
    for (int b0 = 0; b0 < a.B; b0 += narrow_lists(a.H)) {
        const size_t l = b0;
        const Args part{advance(a.q, l * list), advance(a.k, l * list), advance(a.v, l * list),
                        advance(a.dout, l * list), advance(a.row_max, l * stat),
                        advance(a.row_sum, l * stat), advance(a.dsum, l * stat),
                        advance(a.mask, l * a.N), std::min(narrow_lists(a.H), a.B - b0), a.H,
                        a.N, a.d, a.stream};
        const int err = run(part, l * list);
        if (err != 0) return err;
    }
    return 0;
}

}  // namespace

extern "C" {

// Each returns a cudaError_t (0 on success). dtype: 0 = fp32, 1 = bf16 (q, k,
// v, dout and the outputs); row_max, row_sum and dsum are [B, H, N] fp32.
int flash_attn_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                        const void* row_max, const void* row_sum, const void* dsum,
                        const void* mask, void* dk, void* dv, int B, int H, int N, int d,
                        int dtype, void* stream) {
    const Args a{q, k, v, dout, row_max, row_sum, dsum, mask, B, H, N, d,
                 static_cast<cudaStream_t>(stream)};
    if (!valid(a, dtype)) return int(cudaErrorInvalidValue);
    if (d > 128)
        return int(dtype == 1 ? launch_dkdv_wide(a, dk, dv) : launch_dkdv_wide_tf32(a, dk, dv));
    return by_lists(a, dtype, [&](const Args& part, size_t at) {
        return narrow_dkdv(part, dtype, advance(dk, at), advance(dv, at));
    });
}

int flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* row_max, const void* row_sum, const void* dsum,
                      const void* mask, void* dq, int B, int H, int N, int d, int dtype,
                      void* stream) {
    const Args a{q, k, v, dout, row_max, row_sum, dsum, mask, B, H, N, d,
                 static_cast<cudaStream_t>(stream)};
    if (!valid(a, dtype)) return int(cudaErrorInvalidValue);
    if (d > 128) return int(dtype == 1 ? launch_dq_wide(a, dq) : launch_dq_wide_tf32(a, dq));
    return by_lists(a, dtype, [&](const Args& part, size_t at) {
        return narrow_dq(part, dtype, advance(dq, at));
    });
}

// dq, dk and dv of bf16 or fp32 (3xTF32) lists of at most 64 docs (any d)
// in one launch of the packed kernel; B*H lists below 2^31.
int flash_attn_bwd_packed(const void* q, const void* k, const void* v, const void* dout,
                          const void* row_max, const void* row_sum, const void* dsum,
                          const void* mask, void* dq, void* dk, void* dv, int B, int H, int N,
                          int d, int dtype, void* stream) {
    const Args a{q, k, v, dout, row_max, row_sum, dsum, mask, B, H, N, d,
                 static_cast<cudaStream_t>(stream)};
    if (B < 1 || H < 1 || N < 1 || N > PACK_ROWS || d < 1 || (dtype != 0 && dtype != 1)
        || (long long)B * H >= (1LL << 31))
        return int(cudaErrorInvalidValue);
    if (dtype == 0) return int(launch_bwd_packed_tf32(a, dq, dk, dv));
    return int(launch_bwd_packed<PACK_CW>(a, dq, dk, dv));
}

// dq, dk and dv of bf16 or fp32 (3xTF32) lists of at most 128 docs (any d;
// the route takes it at 65 .. 128) in one launch of the list kernel, 128 / N
// lists a block; B*H lists below 2^31.
int flash_attn_bwd_list(const void* q, const void* k, const void* v, const void* dout,
                        const void* row_max, const void* row_sum, const void* dsum,
                        const void* mask, void* dq, void* dk, void* dv, int B, int H, int N,
                        int d, int dtype, void* stream) {
    const Args a{q, k, v, dout, row_max, row_sum, dsum, mask, B, H, N, d,
                 static_cast<cudaStream_t>(stream)};
    if (B < 1 || H < 1 || N < 1 || N > LIST_ROWS || d < 1 || (dtype != 0 && dtype != 1)
        || (long long)B * H >= (1LL << 31))
        return int(cudaErrorInvalidValue);
    if (dtype == 0) return int(launch_bwd_list_tf32<LIST_ROWS>(a, dq, dk, dv));
    return int(launch_packed_as<LIST_ROWS, LIST_CW, false, false>(a, dq, dk, dv));
}

// dq, dk and dv of bf16 or fp32 (3xTF32) lists of at most 256 docs (any d;
// the route takes it at 129 .. 256) in one launch of the long kernel, 256 / N
// lists a block; bf16: dq_part is fp32 scratch of B*H*N*d values (2*B*H*N*d
// with LONG_SUM = 1), written and read by the kernel alone; fp32 reads none
// (its kernel sums dq in dq itself) and may pass null; B*H lists below 2^31.
int flash_attn_bwd_long(const void* q, const void* k, const void* v, const void* dout,
                        const void* row_max, const void* row_sum, const void* dsum,
                        const void* mask, void* dq, void* dk, void* dv, void* dq_part, int B,
                        int H, int N, int d, int dtype, void* stream) {
    const Args a{q, k, v, dout, row_max, row_sum, dsum, mask, B, H, N, d,
                 static_cast<cudaStream_t>(stream)};
    if (B < 1 || H < 1 || N < 1 || N > LONG_ROWS || d < 1 || (dtype != 0 && dtype != 1)
        || (long long)B * H * (LONG_SUM == 0 ? 1 : 2) >= (1LL << 31))
        return int(cudaErrorInvalidValue);
    if (dtype == 0) return int(launch_bwd_list_tf32<LONG_ROWS>(a, dq, dk, dv));
    return int(launch_bwd_long<LONG_SUM>(a, dq, dk, dv, static_cast<float*>(dq_part)));
}

const char* flash_attn_bwd_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
