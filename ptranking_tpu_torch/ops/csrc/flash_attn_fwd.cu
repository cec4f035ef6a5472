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
// running max m and sum l, so that p = exp(logit - m) / l. They are kept as
// two values, not as m + log(l): on a row whose keys are all masked, m = -1e9
// and fp32 rounds -1e9 + log(N) back to -1e9, which would lose the 1/N. The
// serving path passes null pointers and writes nothing more.
//
// What bounds it: 4*B*H*N^2*d operations over 4*B*H*N*d values. At the
// flagship serving shape (B=32, H=2, N=1408, d=68, bf16) that is about 700
// operations per byte moved, far above the H100's ~295 bf16 ops/byte ridge, so
// the arithmetic is the bound, not memory. This first version does that
// arithmetic on the fp32 CUDA cores (register-blocked 4x8 tiles per thread,
// operands from shared memory), not on the tensor cores: it is simple and
// exact in fp32, and it runs well below the bf16 tensor-core bound. Moving the
// two products onto wgmma with TMA-fed tiles is the way to that bound.
//
// Design: one block of 128 threads per (b, h, 64-query tile), looping over
// 64-key tiles staged in shared memory with an online (running-max) softmax,
// so no N x N buffer exists in any memory. The head dim is padded inside the
// kernel to a multiple of 16 (d <= 128); the scale uses the real d. N is
// ragged: the kernel masks the last tile's edge itself.
//
// Padding rules that keep every row finite:
//   * a masked key gets the finite logit -1e9, never -inf, so a query row
//     whose keys are all masked (the all-padded remainder rows of a bucket)
//     averages v uniformly instead of dividing 0 by 0;
//   * a key past N (the ragged tile edge) is left out: p = 0 and its v row is
//     zero in shared memory, so no uninitialised value reaches 0 * x.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;       // query rows per block
constexpr int BN = 64;       // keys per tile
constexpr int NT = 128;      // threads: 16 row groups (4 rows each) x 8 column lanes
constexpr int LDT = BM + 4;  // row stride of the transposed tiles; keeps float4 alignment
constexpr float MASKED_LOGIT = -1e9f;
constexpr float M_INIT = -1e30f;  // below any logit, -1e9 included; finite, so m_old - m_new never is NaN

enum : int { KEY_REAL = 0, KEY_MASKED = 1, KEY_OUT = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

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

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success). dtype: 0 = fp32, 1 = bf16. row_max and
// row_sum are both null (no statistics) or both [B, H, N] fp32.
int flash_attn_fwd(const void* q, const void* k, const void* v, const void* mask, void* o,
                   void* row_max, void* row_sum, int B, int H, int N, int d, int dtype,
                   void* stream) {
    if (B < 1 || H < 1 || N < 1 || d < 1 || d > 128 || B * H > 65535 || (dtype != 0 && dtype != 1)
        || ((row_max == nullptr) != (row_sum == nullptr)))
        return int(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    float* rm = static_cast<float*>(row_max);
    float* rs = static_cast<float*>(row_sum);
#define FLASH_CASE(NC)                                                                        \
    case NC:                                                                                  \
        return int(dtype == 1 ? launch<__nv_bfloat16, NC>(q, k, v, mask, o, rm, rs, B, H, N, d, st) \
                              : launch<float, NC>(q, k, v, mask, o, rm, rs, B, H, N, d, st));
    switch ((d + 15) / 16 * 2) {  // head dim padded to a multiple of 16
        FLASH_CASE(2)
        FLASH_CASE(4)
        FLASH_CASE(6)
        FLASH_CASE(8)
        FLASH_CASE(10)
        FLASH_CASE(12)
        FLASH_CASE(14)
        FLASH_CASE(16)
    }
#undef FLASH_CASE
    return int(cudaErrorInvalidValue);
}

const char* flash_attn_fwd_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
