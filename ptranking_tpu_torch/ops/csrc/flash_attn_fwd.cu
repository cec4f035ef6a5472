// Masked, non-causal flash attention, forward only, for Hopper (sm_90a).
//
// Replaces: ptranking_tpu/ops/attention.py::flash_attention, which calls the
// library Pallas TPU kernel jax.experimental.pallas.ops.tpu.flash_attention
// (key-padding mask passed as segment ids, head dim padded to 128, doc axis
// padded to a 128 block, sm_scale = 1/sqrt(d), no attention dropout).
//
// Computes, for every (b, h):
//     o = softmax(q k^T * d^-1/2, masked keys set to -1e9) v
// with q, k, v, o: [B, H, N, d] contiguous, fp32 or bf16, and mask: [B, N]
// one byte per key (nonzero = real document). Logits, the running max and the
// running sum are fp32; o is written in the input dtype.
//
// Row statistics for the backward (flash_attn_bwd.cu): when the pointers are
// not null, row_max and row_sum ([B, H, N] fp32) get each query row's final
// running max m and sum l, so that p = exp(logit - m) / l, m in natural-log
// units. They are kept as two values, not as m + log(l): on a row whose keys
// are all masked, m = -1e9 and fp32 rounds -1e9 + log(N) back to -1e9, which
// would lose the 1/N. The serving path passes null pointers and writes
// nothing more.
//
// Padding rules that keep every row finite:
//   * a masked key gets the finite logit -1e9, never -inf, so a query row
//     whose keys are all masked (the all-padded remainder rows of a bucket)
//     averages v uniformly over the N keys instead of dividing 0 by 0;
//   * a key past N (the ragged tile edge) is left out: p = 0 and its v row is
//     zero in shared memory, so no uninitialised value reaches 0 * x;
//   * the running max starts at -1e30, below every logit, -1e9 included, and
//     finite, so m_old - m_new is never NaN.
//
// What bounds it: 4*B*H*N^2*d operations over 4*B*H*N*d values. At the
// flagship training shape (B=32, H=2, N=1408, d=68, bf16) that is about 700
// operations per byte moved, far above the H100's ~295 bf16 ops/byte ridge:
// the arithmetic is the bound, so both products have to run on the tensor
// cores. At d = 68 the softmax's exponentials weigh as much as the products:
// the SFUs give 16 results a clock per SM, the tensor cores 4096 bf16
// operations, and each logit costs 2 * 2 * 80 of those (d padded to 80) and
// one exponential.
//
// bf16 inputs: flash_fwd_mma_kernel, on the tensor cores. One block of 4
// warps per (b*h, 64 query rows); a warp owns 16 rows. It is the dq kernel of
// flash_attn_bwd.cu with the dP product dropped and an online softmax and
// O += P V added, and shares its fragments, products and copies
// (mma_common.cuh):
//   * the warp's Q rows are read once by ldmatrix into A fragments that stay
//     in registers (KC = ceil(d/16) 16-deep steps: 5 at d = 68);
//   * a loop over 64-key tiles of K and V, bf16 in shared memory with rows
//     padded to 16*KC + 8 elements (16-byte aligned for ldmatrix, no bank
//     conflicts), double-buffered: tile t+1 is copied by 8-byte cp.async
//     while tile t is multiplied (a row of d = 68 bf16 is 136 bytes, a
//     multiple of 8 but not of 16; d % 4 != 0 or tensors not 8-byte aligned
//     take a scalar, synchronous copy into the same buffers), and the next
//     tile's key flags are prefetched into a register. A thread's copies of
//     a tile are independent of each other (a chunk's row by a multiply, a
//     row past N zero-filled by the copy itself), so they issue back to back;
//   * S = Q K^T by mma.sync.m16n8k16 (bf16 x bf16 -> fp32), B = K rows by
//     ldmatrix;
//   * the online softmax on the accumulator fragment: a thread holds rows g
//     and g+8 of the warp's 16 and two columns of every 8-key tile, so each
//     row's tile max takes two __shfl_xor in its quad of 4 threads; logits
//     are scaled by log2(e)/sqrt(d) and exponentiated by ex2.approx (the
//     masked logit is the same constant in log2 units, so a row of masked
//     keys still gets exp(0) = 1 each); the O accumulators are rescaled by
//     2^(m_old - m_new); each thread sums its own p in fp32 and the quad's
//     four shares are added at the end;
//   * O += P V: the fp32 fragment of two adjacent 8-key tiles is, element
//     for element, the A fragment of a 16-deep product, so P is rounded to
//     bf16 in registers and handed straight over; V is read by
//     ldmatrix.trans. P never reaches shared memory;
//   * O / l is rounded to bf16 once at the store; row_max goes back to
//     natural-log units (the masked constant to exactly -1e9).
// 168 registers at d = 68 (KC = 5), no spill, 56,832 bytes of shared memory
// a block, three blocks an SM.
//
// What still holds it (ptranking_tpu_torch/tools/kernel_variants.py on an
// NVIDIA H100 80GB HBM3 at 700 W, (32, 2, 1408, 68) with statistics:
// 0.208..0.212 ms, 6.0x its bound; PERF.md keeps the runs): the tile copies.
// Without them it takes 0.134..0.139 ms; with every copy from one cache-hot
// tile 0.191..0.199, so it is their instructions (2,176 8-byte copies a block
// and tile; a 16-byte-aligned row would halve them) and not the L2's bytes.
// Without P V it takes 0.203..0.206, without the exponentials 0.201..0.208.
// Two blocks an SM change nothing; 32 keys of S at a time (0.224..0.229) or
// 8 warps owning 128 query rows (0.236..0.245) are slower.
//
// fp32 inputs: flash_fwd_kernel, on the fp32 CUDA cores by design, as the
// backward's fp32 kernels (TF32 keeps about 3 digits, and the fp32 path is
// the exact one that gradient and resume checks rest on): register-blocked
// 4x8 tiles per thread over transposed fp32 tiles in shared memory, 128
// threads as 16 row groups of 4 rows x 8 lanes, the same padding rules.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

constexpr int BM = 64;       // fp32 kernel: query rows per block
constexpr int BN = 64;       // fp32 kernel: keys per tile
constexpr int NT = 128;      // fp32 kernel: 16 row groups (4 rows each) x 8 column lanes
constexpr int LDT = BM + 4;  // row stride of the transposed tiles; keeps float4 alignment
constexpr float M_INIT = -1e30f;  // below any logit, -1e9 included; finite, so m_old - m_new never is NaN

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

__device__ __forceinline__ float warp_max8(float x) {  // over the 8 column lanes of a row group
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
    return x;
}

__device__ __forceinline__ float warp_sum8(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    x += __shfl_xor_sync(0xffffffffu, x, 4);
    return x;
}

// Shared memory, in floats: Qt and Kt [d][LDT] (transposed tiles), Vs [BN][DP],
// Pt [BN][LDT] (probabilities, transposed), then BN int key flags.
__host__ __device__ constexpr size_t smem_floats(int d, int dp) {
    return size_t(2) * d * LDT + size_t(BN) * dp + size_t(BN) * LDT + BN;
}

// NC: output columns per thread; the padded head dim is DP = 8 * NC.
template <typename T, int NC>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const uint8_t* __restrict__ mask, T* __restrict__ o,
                 float* __restrict__ row_max, float* __restrict__ row_sum, int H, int N, int d,
                 float scale) {
    constexpr int DP = 8 * NC;
    extern __shared__ float4 smem4[];
    float* Qt = reinterpret_cast<float*>(smem4);
    float* Kt = Qt + d * LDT;
    float* Vs = Kt + d * LDT;
    float* Pt = Vs + BN * DP;
    int* kflag = reinterpret_cast<int*>(Pt + BN * LDT);

    const int tid = threadIdx.x;
    const int ty = tid >> 3;  // rows ty*4 .. ty*4+3 of the query tile
    const int tx = tid & 7;   // logit columns tx*4+j and 32+tx*4+j; output columns tx+8*c
    const int bh = blockIdx.y;
    const int b = bh / H;
    const int q0 = blockIdx.x * BM;
    const size_t base = size_t(bh) * N * d;
    const T* qb = q + base;
    const T* kb = k + base;
    const T* vb = v + base;
    const uint8_t* mb = mask + size_t(b) * N;

    // The q tile is BM contiguous rows of d values: a linear, coalesced read.
    const int qrows = min(BM, N - q0);
    for (int i = tid; i < BM * d; i += NT) {
        const int r = i / d, c = i - r * d;
        Qt[c * LDT + r] = (r < qrows) ? to_f32(qb[size_t(q0 + r) * d + c]) : 0.f;
    }
    // Columns d..DP-1 of Vs are read by the p.v product but never loaded.
    for (int i = tid; i < BN * (DP - d); i += NT) {
        const int r = i / (DP - d), c = d + (i - r * (DP - d));
        Vs[r * DP + c] = 0.f;
    }

    float acc[4][NC];
    float m_run[4], l_run[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m_run[i] = M_INIT;
        l_run[i] = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
    }

    for (int k0 = 0; k0 < N; k0 += BN) {
        const int krows = min(BN, N - k0);
        __syncthreads();  // the previous tile's Kt, Vs and Pt are no longer read
        for (int i = tid; i < BN * d; i += NT) {
            const int r = i / d, c = i - r * d;
            const bool in = r < krows;
            const size_t off = size_t(k0 + r) * d + c;
            Kt[c * LDT + r] = in ? to_f32(kb[off]) : 0.f;
            Vs[r * DP + c] = in ? to_f32(vb[off]) : 0.f;
        }
        if (tid < BN) kflag[tid] = tid >= krows ? KEY_OUT : (mb[k0 + tid] ? KEY_REAL : KEY_MASKED);
        __syncthreads();

        float s[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int c = 0; c < d; ++c) {
            const float4 a = *reinterpret_cast<const float4*>(&Qt[c * LDT + ty * 4]);
            const float4 b0 = *reinterpret_cast<const float4*>(&Kt[c * LDT + tx * 4]);
            const float4 b1 = *reinterpret_cast<const float4*>(&Kt[c * LDT + 32 + tx * 4]);
            const float av[4] = {a.x, a.y, a.z, a.w};
            const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
        }

        // Scale and mask, then the online softmax update for each of the 4 rows.
        float tmax[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int col = (j < 4) ? tx * 4 + j : 32 + tx * 4 + (j - 4);
            const int flag = kflag[col];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float x = flag == KEY_REAL ? s[i][j] * scale
                                : (flag == KEY_MASKED ? MASKED_LOGIT : -INFINITY);
                s[i][j] = x;
                tmax[i] = fmaxf(tmax[i], x);
            }
        }
        float m_new[4], rsum[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            // column 0 of every tile is a key < N, so the row max is finite
            m_new[i] = fmaxf(m_run[i], warp_max8(tmax[i]));
            rsum[i] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float p = expf(s[i][j] - m_new[i]);  // exp(-inf) = 0 past N
                s[i][j] = p;
                rsum[i] += p;
            }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float alpha = expf(m_run[i] - m_new[i]);
            l_run[i] = l_run[i] * alpha + warp_sum8(rsum[i]);
            m_run[i] = m_new[i];
#pragma unroll
            for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int col = (j < 4) ? tx * 4 + j : 32 + tx * 4 + (j - 4);
            *reinterpret_cast<float4*>(&Pt[col * LDT + ty * 4]) =
                make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
        }
        __syncthreads();

        for (int c = 0; c < krows; ++c) {
            const float4 p = *reinterpret_cast<const float4*>(&Pt[c * LDT + ty * 4]);
            const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
            for (int cc = 0; cc < NC; ++cc) {
                const float vv = Vs[c * DP + tx + 8 * cc];
#pragma unroll
                for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(pv[i], vv, acc[i][cc]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        if (r >= qrows) continue;
        const float inv = 1.f / l_run[i];  // l_run >= 1: the row max contributes exp(0)
        if (row_max != nullptr && tx == 0) {  // the 8 lanes of a row group hold the same m, l
            row_max[size_t(bh) * N + q0 + r] = m_run[i];
            row_sum[size_t(bh) * N + q0 + r] = l_run[i];
        }
        T* orow = o + base + size_t(q0 + r) * d;
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
            const int col = tx + 8 * cc;
            if (col < d) orow[col] = from_f32<T>(acc[i][cc] * inv);
        }
    }
}

template <typename T, int NC>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* o,
                   float* row_max, float* row_sum, int B, int H, int N, int d,
                   cudaStream_t stream) {
    const size_t bytes = smem_floats(d, 8 * NC) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, NC>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
    if (err != cudaSuccess) return err;
    const dim3 grid((N + BM - 1) / BM, B * H);
    const float scale = 1.0f / sqrtf(float(d));
    flash_fwd_kernel<T, NC><<<grid, NT, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const uint8_t*>(mask), static_cast<T*>(o), row_max, row_sum, H, N, d, scale);
    return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int MMA_WARPS = 4;            // warps a block
constexpr int MMA_NT = 32 * MMA_WARPS;  // threads a block
constexpr int OWN = 16 * MMA_WARPS;     // query rows a block owns, 16 a warp
constexpr int TILE = 64;                // keys a tile
constexpr int SUB = 64;                 // keys of S a warp holds in registers at a time
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float MASKED_LOGIT2 = MASKED_LOGIT * LOG2E;  // the masked logit in log2 units

// 2^x on the SFU; 2^0 = 1 and 2^-inf = 0 exactly
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// The online softmax on a fragment of S (rows = the thread's two query rows,
// 8-column tiles j = keys; kf points at the flag of the thread's first key):
// the logits in log2 units (a masked key: the constant; a key past N: -inf),
// the running max m[h] and this thread's share l[h] of the running sum, the
// O accumulators rescaled, and P = 2^(x - m) packed as the A operand of the
// next product. The quad's four threads hold the row's columns between them,
// so two shuffles give its max; the tile's first key is < N, so m is finite.
template <int NTILES, int NACC>
__device__ __forceinline__ void online_softmax(uint32_t (&pa)[NTILES / 2][4], float (&s)[NTILES][4],
                                               const int* kf, float (&m)[2], float (&l)[2],
                                               float (&acc)[NACC][4], float scale2) {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NTILES; ++j) {
        const int2 f2 = *reinterpret_cast<const int2*>(kf + 8 * j);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int f = (e & 1) ? f2.y : f2.x;
            const float x = f == KEY_REAL ? s[j][e] * scale2
                            : (f == KEY_MASKED ? MASKED_LOGIT2 : -INFINITY);
            s[j][e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        alpha[h] = ex2(m[h] - m_new);
        m[h] = m_new;
        l[h] *= alpha[h];
    }
#pragma unroll
    for (int j = 0; j < NACC; ++j) {
        acc[j][0] *= alpha[0];
        acc[j][1] *= alpha[0];
        acc[j][2] *= alpha[1];
        acc[j][3] *= alpha[1];
    }
#pragma unroll
    for (int j = 0; j < NTILES; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const float p0 = ex2(s[j][2 * h] - m[h]);  // 0 past N
            const float p1 = ex2(s[j][2 * h + 1] - m[h]);
            l[h] += p0 + p1;  // fp32 p, before rounding
            pa[j >> 1][(j & 1) * 2 + h] = pack_bf16(p0, p1);
        }
}

// the Q tile, two K and two V tiles ([rows][16*kc + 8] bf16), two tiles' key flags
__host__ __device__ constexpr size_t mma_smem_bytes(int kc) {
    return size_t(OWN + 4 * TILE) * (16 * kc + 8) * sizeof(bf16) + size_t(2) * TILE * 4;
}

// blocks an SM that the register budget is cut for: the accumulators grow with KC
__host__ __device__ constexpr int mma_min_blocks(int kc) { return kc <= 5 ? 3 : 2; }

template <int KC>
__global__ void __launch_bounds__(MMA_NT, mma_min_blocks(KC))
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                     bf16* __restrict__ o, float* __restrict__ row_max,
                     float* __restrict__ row_sum, int H, int N, int d, float scale2, int how) {
    constexpr int LDS = 16 * KC + 8;
    constexpr int TILE_ELEMS = TILE * LDS;
    extern __shared__ uint4 smem_mma[];
    bf16* Qs = reinterpret_cast<bf16*>(smem_mma);  // the block's query rows, read once
    bf16* Ks = Qs + OWN * LDS;                     // two buffers each
    bf16* Vs = Ks + 2 * TILE_ELEMS;
    int* kflag = reinterpret_cast<int*>(Vs + 2 * TILE_ELEMS);  // [2][TILE]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    const int bh = blockIdx.y;
    const int b = bh / H;
    const int q0 = blockIdx.x * OWN;
    const size_t base = size_t(bh) * N * d;
    const int qrows = min(OWN, N - q0);
    const uint8_t* mask_row = mask + size_t(b) * N;
    const bool copy_8b = how & COPY_8B;
    const uint32_t magic = copy_magic(d);

    zero_pad_columns<MMA_NT, LDS>(Qs, OWN + 4 * TILE, d);
    load_tile<MMA_NT, KC, OWN>(Qs, q + base + size_t(q0) * d, qrows, d, copy_8b, magic);
    load_tile<MMA_NT, KC, TILE>(Ks, k + base, min(TILE, N), d, copy_8b, magic);
    load_tile<MMA_NT, KC, TILE>(Vs, v + base, min(TILE, N), d, copy_8b, magic);
    cp_async_commit();
    if (tid < TILE) kflag[tid] = key_flag(mask_row, tid, N);

    float acc[2 * KC][4];
#pragma unroll
    for (int j = 0; j < 2 * KC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    // of the thread's two query rows (g and g + 8 of the warp's 16): the
    // running max in log2 units and the thread's share of the running sum
    float m[2] = {M_INIT, M_INIT}, l[2] = {0.f, 0.f};

    cp_async_wait_all();
    __syncthreads();
    uint32_t aq[KC][4];  // the warp's Q rows stay in registers
    load_a<KC>(aq, Qs, warp * 16, lane);

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
            float s[SUB / 8][4];  // S: the warp's 16 query rows x SUB keys
#pragma unroll
            for (int j = 0; j < SUB / 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
            product_nk<KC, SUB / 8>(s, aq, Kt, sub, lane);

            uint32_t pa[SUB / 16][4];
            online_softmax<SUB / 8>(pa, s, kf + sub + 2 * t4, m, l, acc, scale2);
            product_kn<KC, SUB / 16>(acc, pa, Vt, sub, lane);  // O += P V
        }

        if (more && tid < TILE) kflag[(buf ^ 1) * TILE + tid] = next_flag;
        cp_async_wait_all();
        __syncthreads();  // tile t+1 has landed, and no warp reads tile t any more
    }

    const bool pairs = how & STORE_PAIRS;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        float sum = l[h];  // the quad's four shares
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const int r = warp * 16 + g + 8 * h;
        if (r >= qrows) continue;
        const float inv = 1.f / sum;  // sum >= 1: the row max contributes 2^0
        bf16* orow = o + base + size_t(q0 + r) * d;
#pragma unroll
        for (int j = 0; j < 2 * KC; ++j)
            store_pair(orow, 8 * j + 2 * t4, acc[j][2 * h] * inv, acc[j][2 * h + 1] * inv, d,
                       pairs);
        if (row_max != nullptr && t4 == 0) {  // the quad holds the same m and sum
            const size_t at = size_t(bh) * N + q0 + r;
            row_max[at] = m[h] == MASKED_LOGIT2 ? MASKED_LOGIT : m[h] * LN2;
            row_sum[at] = sum;
        }
    }
}

template <int KC>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* mask, void* o,
                       float* row_max, float* row_sum, int B, int H, int N, int d,
                       cudaStream_t stream) {
    const size_t bytes = mma_smem_bytes(KC);
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_mma_kernel<KC>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
    if (err != cudaSuccess) return err;
    // 8-byte tile copies need rows of a multiple of 8 bytes on 8-byte-aligned
    // tensors; 4-byte stores of two bf16 need even rows on a 4-byte-aligned one
    const int how = (d % 4 == 0 && aligned(q, 8) && aligned(k, 8) && aligned(v, 8) ? COPY_8B : 0)
                    | (d % 2 == 0 && aligned(o, 4) ? STORE_PAIRS : 0);
    const dim3 grid((N + OWN - 1) / OWN, B * H);
    flash_fwd_mma_kernel<KC><<<grid, MMA_NT, bytes, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const uint8_t*>(mask), static_cast<bf16*>(o), row_max, row_sum, H, N, d,
        LOG2E / sqrtf(float(d)), how);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success). dtype: 0 = fp32 (CUDA cores), 1 = bf16
// (tensor cores). row_max and row_sum are both null (no statistics) or both
// [B, H, N] fp32.
int flash_attn_fwd(const void* q, const void* k, const void* v, const void* mask, void* o,
                   void* row_max, void* row_sum, int B, int H, int N, int d, int dtype,
                   void* stream) {
    if (B < 1 || H < 1 || N < 1 || d < 1 || d > 128 || B * H > 65535 || (dtype != 0 && dtype != 1)
        || ((row_max == nullptr) != (row_sum == nullptr)))
        return int(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    float* rm = static_cast<float*>(row_max);
    float* rs = static_cast<float*>(row_sum);
    // the head dim padded to a multiple of 16: KC steps of 16 (the fp32
    // kernel counts 8-column blocks, NC = 2 * KC)
#define FLASH_CASE(KC)                                                                     \
    case KC:                                                                               \
        return int(dtype == 1 ? launch_mma<KC>(q, k, v, mask, o, rm, rs, B, H, N, d, st)   \
                              : launch<float, 2 * KC>(q, k, v, mask, o, rm, rs, B, H, N, d, st));
    switch ((d + 15) / 16) {
        FLASH_CASE(1)
        FLASH_CASE(2)
        FLASH_CASE(3)
        FLASH_CASE(4)
        FLASH_CASE(5)
        FLASH_CASE(6)
        FLASH_CASE(7)
        FLASH_CASE(8)
    }
#undef FLASH_CASE
    return int(cudaErrorInvalidValue);
}

const char* flash_attn_fwd_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
