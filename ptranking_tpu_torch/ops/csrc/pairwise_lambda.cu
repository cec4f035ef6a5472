// The fused pairwise lambda loss (RankNet / LambdaRank core), forward and
// backward, for Hopper (sm_90a).
//
// Replaces: ptranking_tpu/ops/pallas/pairwise.py, _fwd_kernel (per
// (query, i-tile) partial sums over the strict upper triangle) and
// _bwd_kernel (per-row sums of the analytic gradient over j != i), TPU tiles
// of 256 x 256 pairs.
//
// Inputs, all [B, N] contiguous: s (scores, fp32), l (labels, fp32), g
// (normalised gains gain/IDCG, fp32; unread when unweighted) and m (one byte
// per doc, nonzero = real). LambdaRank rows arrive sorted by predicted score
// with pads last, and the discount of a row is 1/log2(pos+2) of its position
// in the row. For a pair (i, j) with x = sigma*(s_i - s_j):
//     t    = (1 + clamp(l_i - l_j, -1, 1)) / 2
//     w    = |g_i - g_j| * |1/log2(i+2) - 1/log2(j+2)|   (WEIGHTED), else 1
//     loss = w * (softplus(x) - t*x),  softplus(x) = max(x, 0) + log1p(exp(-|x|))
//     grad = w * sigma * (sigmoid(x) - t)
// The forward writes partials[b, ti] = sum over real i in tile ti and real
// j > i; the caller sums them (no atomics: the same inputs give the same
// bits). The backward writes grad[b, i] = scale * sum over real j != i, 0 on
// a padded row; scale is the upstream gradient, read from device memory.
//
// Padded docs: their pair terms are SELECTED out (a ternary on the validity
// flag), never multiplied by a 0 mask, because a pad's score may be -1e9
// (|x| ~ 1e9) or any garbage in an unsorted RankNet row.
//
// What bounds it: per pair, two transcendental operations (exp and log1p
// forward, exp and a reciprocal backward) on the SFUs, about a dozen fp32
// operations, and no memory traffic beyond 4 reads of N values per row:
// B*N*(N-1)/2 pairs forward and B*N*(N-1) backward. The SFUs (16 results per
// clock per SM) are the bound. Design: one block of 256 threads per (query,
// 256-row tile); thread r owns row i, holds its values in registers and
// walks the j tiles, each staged once in shared memory and read as a
// broadcast, so every pair is computed with no global traffic.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 256;

struct Staged {
    float s[TILE], l[TILE], g[TILE], d[TILE];
    int real[TILE];
};

__device__ __forceinline__ float discount(int pos) { return 1.0f / log2f(float(pos) + 2.0f); }

// Stage j-tile tj of row b (values past N are flagged not real).
template <bool WEIGHTED>
__device__ __forceinline__ void stage(Staged& st, const float* sb, const float* lb,
                                      const float* gb, const uint8_t* mb, int tj, int N) {
    const int j = tj * TILE + threadIdx.x;
    const bool in = j < N;
    st.s[threadIdx.x] = in ? sb[j] : 0.f;
    st.l[threadIdx.x] = in ? lb[j] : 0.f;
    if (WEIGHTED) {
        st.g[threadIdx.x] = in ? gb[j] : 0.f;
        st.d[threadIdx.x] = discount(j);
    }
    st.real[threadIdx.x] = in && mb[j] != 0;
}

__device__ __forceinline__ float block_sum(float x, float* red) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
    __syncthreads();
    x = threadIdx.x < TILE / 32 ? red[threadIdx.x] : 0.f;
    if (threadIdx.x < 32) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    }
    return x;
}

template <bool WEIGHTED>
__global__ void __launch_bounds__(TILE)
pair_fwd_kernel(const float* __restrict__ s, const float* __restrict__ l,
                const float* __restrict__ g, const uint8_t* __restrict__ m,
                float* __restrict__ partials, int N, int n_tiles, float sigma) {
    __shared__ Staged st;
    __shared__ float red[TILE / 32];
    const int b = blockIdx.y, ti = blockIdx.x;
    const int i = ti * TILE + threadIdx.x;
    const size_t row = size_t(b) * N;
    const float *sb = s + row, *lb = l + row, *gb = g + row;
    const uint8_t* mb = m + row;
    const bool i_real = i < N && mb[i] != 0;
    const float si = i < N ? sb[i] : 0.f, li = i < N ? lb[i] : 0.f;
    const float gi = (WEIGHTED && i < N) ? gb[i] : 0.f;
    const float di = WEIGHTED ? discount(i) : 0.f;

    float acc = 0.f;
    for (int tj = ti; tj < n_tiles; ++tj) {
        __syncthreads();  // the previous tile is no longer read
        stage<WEIGHTED>(st, sb, lb, gb, mb, tj, N);
        __syncthreads();
        if (!i_real) continue;
        const int j0 = tj == ti ? threadIdx.x + 1 : 0;  // strict upper triangle
        const int j1 = min(TILE, N - tj * TILE);
        for (int jj = j0; jj < j1; ++jj) {
            const float x = sigma * (si - st.s[jj]);
            const float t = 0.5f * (1.0f + fminf(fmaxf(li - st.l[jj], -1.0f), 1.0f));
            float term = fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x))) - t * x;
            if (WEIGHTED) term *= fabsf(gi - st.g[jj]) * fabsf(di - st.d[jj]);
            acc += st.real[jj] ? term : 0.0f;
        }
    }
    const float total = block_sum(acc, red);
    if (threadIdx.x == 0) partials[size_t(b) * n_tiles + ti] = total;
}

template <bool WEIGHTED>
__global__ void __launch_bounds__(TILE)
pair_bwd_kernel(const float* __restrict__ s, const float* __restrict__ l,
                const float* __restrict__ g, const uint8_t* __restrict__ m,
                const float* __restrict__ scale, float* __restrict__ grad, int N,
                int n_tiles, float sigma) {
    __shared__ Staged st;
    const int b = blockIdx.y, ti = blockIdx.x;
    const int i = ti * TILE + threadIdx.x;
    const size_t row = size_t(b) * N;
    const float *sb = s + row, *lb = l + row, *gb = g + row;
    const uint8_t* mb = m + row;
    const bool i_real = i < N && mb[i] != 0;
    const float si = i < N ? sb[i] : 0.f, li = i < N ? lb[i] : 0.f;
    const float gi = (WEIGHTED && i < N) ? gb[i] : 0.f;
    const float di = WEIGHTED ? discount(i) : 0.f;

    float acc = 0.f;
    for (int tj = 0; tj < n_tiles; ++tj) {
        __syncthreads();
        stage<WEIGHTED>(st, sb, lb, gb, mb, tj, N);
        __syncthreads();
        if (!i_real) continue;
        const int j1 = min(TILE, N - tj * TILE);
        const int self = tj == ti ? int(threadIdx.x) : -1;
        for (int jj = 0; jj < j1; ++jj) {
            const float x = sigma * (si - st.s[jj]);
            const float t = 0.5f * (1.0f + fminf(fmaxf(li - st.l[jj], -1.0f), 1.0f));
            float core = sigma * (1.0f / (1.0f + expf(-x)) - t);
            if (WEIGHTED) core *= fabsf(gi - st.g[jj]) * fabsf(di - st.d[jj]);
            acc += (st.real[jj] && jj != self) ? core : 0.0f;
        }
    }
    if (i < N) grad[row + i] = i_real ? acc * scale[0] : 0.0f;
}

}  // namespace

extern "C" {

// Both return a cudaError_t (0 on success). weighted: 1 = LambdaRank, 0 = RankNet.
int pairwise_lambda_fwd(const void* s, const void* l, const void* g, const void* m,
                        void* partials, int B, int N, float sigma, int weighted, void* stream) {
    if (B < 1 || B > 65535 || N < 1) return int(cudaErrorInvalidValue);
    const int n_tiles = (N + TILE - 1) / TILE;
    const dim3 grid(n_tiles, B);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* sp = static_cast<const float*>(s);
    const float* lp = static_cast<const float*>(l);
    const float* gp = static_cast<const float*>(g);
    const uint8_t* mp = static_cast<const uint8_t*>(m);
    float* out = static_cast<float*>(partials);
    if (weighted)
        pair_fwd_kernel<true><<<grid, TILE, 0, st>>>(sp, lp, gp, mp, out, N, n_tiles, sigma);
    else
        pair_fwd_kernel<false><<<grid, TILE, 0, st>>>(sp, lp, gp, mp, out, N, n_tiles, sigma);
    return int(cudaGetLastError());
}

int pairwise_lambda_bwd(const void* s, const void* l, const void* g, const void* m,
                        const void* scale, void* grad, int B, int N, float sigma, int weighted,
                        void* stream) {
    if (B < 1 || B > 65535 || N < 1) return int(cudaErrorInvalidValue);
    const int n_tiles = (N + TILE - 1) / TILE;
    const dim3 grid(n_tiles, B);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* sp = static_cast<const float*>(s);
    const float* lp = static_cast<const float*>(l);
    const float* gp = static_cast<const float*>(g);
    const uint8_t* mp = static_cast<const uint8_t*>(m);
    const float* sc = static_cast<const float*>(scale);
    float* out = static_cast<float*>(grad);
    if (weighted)
        pair_bwd_kernel<true><<<grid, TILE, 0, st>>>(sp, lp, gp, mp, sc, out, N, n_tiles, sigma);
    else
        pair_bwd_kernel<false><<<grid, TILE, 0, st>>>(sp, lp, gp, mp, sc, out, N, n_tiles, sigma);
    return int(cudaGetLastError());
}

const char* pairwise_lambda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
