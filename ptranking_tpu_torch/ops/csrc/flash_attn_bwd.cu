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
//   * flash_bwd_dkdv_kernel: one block per (b*h, 64-key tile); it loops over
//     the 64-query tiles and accumulates its keys' dk and dv in registers;
//   * flash_bwd_dq_kernel: one block per (b*h, 64-query tile); it loops over
//     the 64-key tiles and accumulates its rows' dq in registers.
// 128 threads per block: 16 row groups of 4 rows x 8 lanes, as the forward.
// The head dim is padded inside the kernels to a multiple of 16 (DP = 8*NC
// accumulator columns per row; the pad columns are zero in shared memory).
//
// What bounds it: 8*B*H*N^2*d operations (dkdv: P recomputed, dP, dv, dk)
// plus 6*B*H*N^2*d (dq: P, dP, dq) over about 7*B*H*N*d values moved, far
// above the H100's bf16 ridge: arithmetic is the bound. Like the forward, this
// first version does the products on the fp32 CUDA cores, from transposed
// tiles in shared memory with 4x8 register blocks; the tensor cores (mma.sync,
// then wgmma) are the way toward the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;       // query rows per tile
constexpr int BN = 64;       // keys per tile
constexpr int NT = 128;      // threads
constexpr int LDT = BM + 4;  // row stride of the transposed tiles; keeps float4 alignment
constexpr float MASKED_LOGIT = -1e9f;

enum : int { KEY_REAL = 0, KEY_MASKED = 1, KEY_OUT = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

// rows r < nrows of a [rows, d] tile at src into dst[c * LDT + r] (c < d), zeros past nrows
template <typename T>
__device__ __forceinline__ void load_transposed(float* dst, const T* src, int nrows, int d) {
    for (int i = threadIdx.x; i < BM * d; i += NT) {
        const int r = i / d, c = i - r * d;
        dst[c * LDT + r] = (r < nrows) ? to_f32(src[size_t(r) * d + c]) : 0.f;
    }
}

// the 4 x 8 block a[c][ty*4 + i] * b[c][col_j] summed over c < d, added to acc
__device__ __forceinline__ void product_4x8(float (&acc)[4][8], const float* a, const float* b,
                                            int d, int ty, int tx) {
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
        const float4 x = *reinterpret_cast<const float4*>(&a[c * LDT + ty * 4]);
        const float4 y0 = *reinterpret_cast<const float4*>(&b[c * LDT + tx * 4]);
        const float4 y1 = *reinterpret_cast<const float4*>(&b[c * LDT + 32 + tx * 4]);
        const float av[4] = {x.x, x.y, x.z, x.w};
        const float bv[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
}

__device__ __forceinline__ int column(int tx, int j) { return j < 4 ? tx * 4 + j : 32 + tx * 4 + (j - 4); }

__host__ __device__ constexpr size_t dkdv_smem_floats(int d, int dp) {
    // Kt, Vt [d][LDT]; Qt, dOt [dp][LDT]; Pq, dSq [BM][LDT]; row m, 1/l, D [BM]; key flags [BN]
    return size_t(2) * d * LDT + size_t(2) * dp * LDT + size_t(2) * BM * LDT + 3 * BM + BN;
}

template <typename T, int NC>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ row_max,
                      const float* __restrict__ row_sum, const float* __restrict__ dsum,
                      const uint8_t* __restrict__ mask, T* __restrict__ dk, T* __restrict__ dv,
                      int H, int N, int d, float scale) {
    constexpr int DP = 8 * NC;
    extern __shared__ float4 smem4[];
    float* Kt = reinterpret_cast<float*>(smem4);
    float* Vt = Kt + d * LDT;
    float* Qt = Vt + d * LDT;
    float* dOt = Qt + DP * LDT;
    float* Pq = dOt + DP * LDT;   // Pq[query * LDT + key]: P transposed, float4 over 4 keys
    float* dSq = Pq + BM * LDT;
    float* qm = dSq + BM * LDT;
    float* qinv = qm + BM;
    float* qD = qinv + BM;
    int* kflag = reinterpret_cast<int*>(qD + BM);

    const int tid = threadIdx.x;
    const int ty = tid >> 3;  // keys ty*4 .. ty*4+3 of the key tile
    const int tx = tid & 7;   // query columns column(tx, j); output columns tx + 8*cc
    const int bh = blockIdx.y;
    const int b = bh / H;
    const int k0 = blockIdx.x * BN;
    const size_t base = size_t(bh) * N * d;
    const size_t stat = size_t(bh) * N;
    const int krows = min(BN, N - k0);

    load_transposed(Kt, k + base + size_t(k0) * d, krows, d);
    load_transposed(Vt, v + base + size_t(k0) * d, krows, d);
    for (int i = tid; i < (DP - d) * LDT; i += NT) {  // pad rows of Qt, dOt stay zero
        Qt[d * LDT + i] = 0.f;
        dOt[d * LDT + i] = 0.f;
    }
    if (tid < BN) kflag[tid] = tid >= krows ? KEY_OUT : (mask[size_t(b) * N + k0 + tid] ? KEY_REAL : KEY_MASKED);

    float acc_k[4][NC], acc_v[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

    for (int q0 = 0; q0 < N; q0 += BM) {
        const int qrows = min(BM, N - q0);
        __syncthreads();  // the previous query tile is no longer read
        load_transposed(Qt, q + base + size_t(q0) * d, qrows, d);
        load_transposed(dOt, dout + base + size_t(q0) * d, qrows, d);
        if (tid < BM) {
            const bool in = tid < qrows;
            qm[tid] = in ? row_max[stat + q0 + tid] : 0.f;
            qinv[tid] = in ? 1.f / row_sum[stat + q0 + tid] : 0.f;  // l >= 1
            qD[tid] = in ? dsum[stat + q0 + tid] : 0.f;
        }
        __syncthreads();

        float s[4][8], dp[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
        product_4x8(s, Kt, Qt, d, ty, tx);   // s[i][j] = k_key . q_query
        product_4x8(dp, Vt, dOt, d, ty, tx); // dp[i][j] = v_key . dO_query

#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int col = column(tx, j);
            const bool qin = col < qrows;
            float p4[4], ds4[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int flag = kflag[ty * 4 + i];
                const float x = flag == KEY_REAL ? s[i][j] * scale : MASKED_LOGIT;
                const float p = (qin && flag != KEY_OUT) ? expf(x - qm[col]) * qinv[col] : 0.f;
                p4[i] = p;
                ds4[i] = (qin && flag == KEY_REAL) ? p * (dp[i][j] - qD[col]) : 0.f;
            }
            *reinterpret_cast<float4*>(&Pq[col * LDT + ty * 4]) = make_float4(p4[0], p4[1], p4[2], p4[3]);
            *reinterpret_cast<float4*>(&dSq[col * LDT + ty * 4]) = make_float4(ds4[0], ds4[1], ds4[2], ds4[3]);
        }
        __syncthreads();

        for (int r = 0; r < qrows; ++r) {
            const float4 p = *reinterpret_cast<const float4*>(&Pq[r * LDT + ty * 4]);
            const float4 ds = *reinterpret_cast<const float4*>(&dSq[r * LDT + ty * 4]);
            const float pv[4] = {p.x, p.y, p.z, p.w};
            const float dsv[4] = {ds.x, ds.y, ds.z, ds.w};
#pragma unroll
            for (int cc = 0; cc < NC; ++cc) {
                const float qv = Qt[(tx + 8 * cc) * LDT + r];
                const float dov = dOt[(tx + 8 * cc) * LDT + r];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    acc_v[i][cc] = fmaf(pv[i], dov, acc_v[i][cc]);
                    acc_k[i][cc] = fmaf(dsv[i], qv, acc_k[i][cc]);
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        if (r >= krows) continue;
        T* dkrow = dk + base + size_t(k0 + r) * d;
        T* dvrow = dv + base + size_t(k0 + r) * d;
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
            const int col = tx + 8 * cc;
            if (col < d) {
                dkrow[col] = from_f32<T>(acc_k[i][cc] * scale);
                dvrow[col] = from_f32<T>(acc_v[i][cc]);
            }
        }
    }
}

__host__ __device__ constexpr size_t dq_smem_floats(int d, int dp) {
    // Qt, dOt, Vt [d][LDT]; Kt [dp][LDT]; dSk [BN][LDT]; key flags [BN]
    return size_t(3) * d * LDT + size_t(dp) * LDT + size_t(BN) * LDT + BN;
}

template <typename T, int NC>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ row_max,
                    const float* __restrict__ row_sum, const float* __restrict__ dsum,
                    const uint8_t* __restrict__ mask, T* __restrict__ dq, int H, int N, int d,
                    float scale) {
    constexpr int DP = 8 * NC;
    extern __shared__ float4 smem4[];
    float* Qt = reinterpret_cast<float*>(smem4);
    float* dOt = Qt + d * LDT;
    float* Vt = dOt + d * LDT;
    float* Kt = Vt + d * LDT;
    float* dSk = Kt + DP * LDT;  // dSk[key * LDT + query]: float4 over 4 query rows
    int* kflag = reinterpret_cast<int*>(dSk + BN * LDT);

    const int tid = threadIdx.x;
    const int ty = tid >> 3;  // query rows ty*4 .. ty*4+3
    const int tx = tid & 7;   // key columns column(tx, j); output columns tx + 8*cc
    const int bh = blockIdx.y;
    const int b = bh / H;
    const int q0 = blockIdx.x * BM;
    const size_t base = size_t(bh) * N * d;
    const size_t stat = size_t(bh) * N;
    const int qrows = min(BM, N - q0);

    load_transposed(Qt, q + base + size_t(q0) * d, qrows, d);
    load_transposed(dOt, dout + base + size_t(q0) * d, qrows, d);
    for (int i = tid; i < (DP - d) * LDT; i += NT) Kt[d * LDT + i] = 0.f;
    float m_i[4], inv_i[4], D_i[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        const bool in = r < qrows;
        m_i[i] = in ? row_max[stat + q0 + r] : 0.f;
        inv_i[i] = in ? 1.f / row_sum[stat + q0 + r] : 0.f;
        D_i[i] = in ? dsum[stat + q0 + r] : 0.f;
    }

    float acc[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

    for (int k0 = 0; k0 < N; k0 += BN) {
        const int krows = min(BN, N - k0);
        __syncthreads();  // the previous key tile is no longer read
        load_transposed(Kt, k + base + size_t(k0) * d, krows, d);
        load_transposed(Vt, v + base + size_t(k0) * d, krows, d);
        if (tid < BN) kflag[tid] = tid >= krows ? KEY_OUT : (mask[size_t(b) * N + k0 + tid] ? KEY_REAL : KEY_MASKED);
        __syncthreads();

        float s[4][8], dp[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
        product_4x8(s, Qt, Kt, d, ty, tx);
        product_4x8(dp, dOt, Vt, d, ty, tx);

#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int col = column(tx, j);
            const bool real = kflag[col] == KEY_REAL;  // masked and out-of-range keys: dS = 0
            float ds4[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const bool in = ty * 4 + i < qrows;
                const float p = expf(s[i][j] * scale - m_i[i]) * inv_i[i];
                ds4[i] = (in && real) ? p * (dp[i][j] - D_i[i]) : 0.f;
            }
            *reinterpret_cast<float4*>(&dSk[col * LDT + ty * 4]) = make_float4(ds4[0], ds4[1], ds4[2], ds4[3]);
        }
        __syncthreads();

        for (int c = 0; c < krows; ++c) {
            const float4 ds = *reinterpret_cast<const float4*>(&dSk[c * LDT + ty * 4]);
            const float dsv[4] = {ds.x, ds.y, ds.z, ds.w};
#pragma unroll
            for (int cc = 0; cc < NC; ++cc) {
                const float kv = Kt[(tx + 8 * cc) * LDT + c];
#pragma unroll
                for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(dsv[i], kv, acc[i][cc]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        if (r >= qrows) continue;
        T* dqrow = dq + base + size_t(q0 + r) * d;
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
            const int col = tx + 8 * cc;
            if (col < d) dqrow[col] = from_f32<T>(acc[i][cc] * scale);
        }
    }
}

struct Args {
    const void *q, *k, *v, *dout, *row_max, *row_sum, *dsum, *mask;
    int B, H, N, d;
    cudaStream_t stream;
};

template <typename T, int NC>
cudaError_t launch_dkdv(const Args& a, void* dk, void* dv) {
    const size_t bytes = dkdv_smem_floats(a.d, 8 * NC) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, NC>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
    if (err != cudaSuccess) return err;
    const dim3 grid((a.N + BN - 1) / BN, a.B * a.H);
    flash_bwd_dkdv_kernel<T, NC><<<grid, NT, bytes, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.dout), static_cast<const float*>(a.row_max),
        static_cast<const float*>(a.row_sum), static_cast<const float*>(a.dsum),
        static_cast<const uint8_t*>(a.mask), static_cast<T*>(dk), static_cast<T*>(dv), a.H, a.N,
        a.d, 1.0f / sqrtf(float(a.d)));
    return cudaGetLastError();
}

template <typename T, int NC>
cudaError_t launch_dq(const Args& a, void* dq) {
    const size_t bytes = dq_smem_floats(a.d, 8 * NC) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, NC>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
    if (err != cudaSuccess) return err;
    const dim3 grid((a.N + BM - 1) / BM, a.B * a.H);
    flash_bwd_dq_kernel<T, NC><<<grid, NT, bytes, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.dout), static_cast<const float*>(a.row_max),
        static_cast<const float*>(a.row_sum), static_cast<const float*>(a.dsum),
        static_cast<const uint8_t*>(a.mask), static_cast<T*>(dq), a.H, a.N, a.d,
        1.0f / sqrtf(float(a.d)));
    return cudaGetLastError();
}

bool valid(const Args& a, int dtype) {
    return a.B >= 1 && a.H >= 1 && a.N >= 1 && a.d >= 1 && a.d <= 128 && a.B * a.H <= 65535
           && (dtype == 0 || dtype == 1);
}

}  // namespace

// Dispatch on the head dim padded to a multiple of 16 (NC = 2 .. 16) and the dtype.
#define FLASH_BWD_DISPATCH(CALL)                                                   \
    switch ((a.d + 15) / 16 * 2) {                                                 \
        case 2: return int(dtype == 1 ? CALL(__nv_bfloat16, 2) : CALL(float, 2));   \
        case 4: return int(dtype == 1 ? CALL(__nv_bfloat16, 4) : CALL(float, 4));   \
        case 6: return int(dtype == 1 ? CALL(__nv_bfloat16, 6) : CALL(float, 6));   \
        case 8: return int(dtype == 1 ? CALL(__nv_bfloat16, 8) : CALL(float, 8));   \
        case 10: return int(dtype == 1 ? CALL(__nv_bfloat16, 10) : CALL(float, 10)); \
        case 12: return int(dtype == 1 ? CALL(__nv_bfloat16, 12) : CALL(float, 12)); \
        case 14: return int(dtype == 1 ? CALL(__nv_bfloat16, 14) : CALL(float, 14)); \
        case 16: return int(dtype == 1 ? CALL(__nv_bfloat16, 16) : CALL(float, 16)); \
    }                                                                              \
    return int(cudaErrorInvalidValue);

extern "C" {

// Both return a cudaError_t (0 on success). dtype: 0 = fp32, 1 = bf16 (q, k, v,
// dout and the outputs); row_max, row_sum and dsum are [B, H, N] fp32.
int flash_attn_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                        const void* row_max, const void* row_sum, const void* dsum,
                        const void* mask, void* dk, void* dv, int B, int H, int N, int d,
                        int dtype, void* stream) {
    const Args a{q, k, v, dout, row_max, row_sum, dsum, mask, B, H, N, d,
                 static_cast<cudaStream_t>(stream)};
    if (!valid(a, dtype)) return int(cudaErrorInvalidValue);
#define DKDV(T, NC) launch_dkdv<T, NC>(a, dk, dv)
    FLASH_BWD_DISPATCH(DKDV)
#undef DKDV
}

int flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* row_max, const void* row_sum, const void* dsum,
                      const void* mask, void* dq, int B, int H, int N, int d, int dtype,
                      void* stream) {
    const Args a{q, k, v, dout, row_max, row_sum, dsum, mask, B, H, N, d,
                 static_cast<cudaStream_t>(stream)};
    if (!valid(a, dtype)) return int(cudaErrorInvalidValue);
#define DQ(T, NC) launch_dq<T, NC>(a, dq)
    FLASH_BWD_DISPATCH(DQ)
#undef DQ
}

const char* flash_attn_bwd_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
