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
// The backward's term is odd in the pair: w is symmetric, sigmoid(-x) =
// 1 - sigmoid(x) and t_ji = 1 - t_ij (the clamp is odd), so c_ji = -c_ij, and
// dL/ds_i = sum_{j > i} c_ij - sum_{j < i} c_ji over real pairs: each
// unordered pair is evaluated once (ptranking_tpu/ops/pallas/pairwise.py
// states the same identity).
//
// Padded docs: their pair terms are SELECTED out (a ternary on the validity
// flag), never multiplied by a 0 mask, because a pad's score may be -1e9
// (|x| ~ 1e9) or any garbage in an unsorted RankNet row.
//
// What bounds it: per pair two transcendental operations on the SFUs (16
// results a clock per SM) and about twenty fp32 operations, with no memory
// traffic beyond the rows: B*N*(N-1)/2 pairs each way. Design:
//   * one block of 256 threads per (row, tile pair ti <= tj) of TI x TI
//     pairs, grid.x folding the row B into it: at (32, 1408), 66 tile pairs
//     x 32 = 2,112 blocks, all with the same work but the diagonal's half,
//     where the first design gave (6 - ti) key tiles to each of 192 blocks;
//   * a thread owns 8 rows x 8 columns of the tile (16 row groups x 16
//     column groups, rows and columns interleaved by 16), their values in
//     registers after one staging in shared memory, so the pair loop is pure
//     arithmetic: one exp(-|x|) a pair gives both softplus and sigmoid
//     (__expf, then __logf(1 + e) forward and one reciprocal backward);
//   * the forward writes one partial a block, its sum over the block in a
//     fixed order; the caller sums the [B, tile pairs] partials;
//   * the backward adds c_ij to its row sum and to its column sum; the row
//     sums (over the 16 column groups, by shuffles) and the column sums (over
//     the 16 row groups, shuffles and shared memory) are written as partials
//     rowpart[b, tj, i] and colpart[b, ti, j], and a second kernel gives
//     grad_i = scale * (sum_{t >= tile(i)} rowpart - sum_{t <= tile(i)} colpart)
//     in that order: no atomics, the same inputs give the same bits. scale
//     is the upstream gradient, read from device memory.
// At (32, 1408) LambdaRank the forward takes 0.049..0.051 ms and the
// backward 0.071..0.074 ms against an SFU bound of 0.015 ms each (the first
// design: 0.19 and 0.17 ms); the exact transcendentals (expf, log1pf, a
// division) take 0.075..0.078 / 0.073..0.076 ms, 64 x 64 tiles 0.058..0.060 /
// 0.075..0.078 (ptranking_tpu_torch/tools/kernel_variants.py on an NVIDIA
// H100 80GB HBM3 at 700 W; PERF.md keeps the runs).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TI = 128;  // rows and columns of a tile of pairs (TILE in ops/pairwise_fused.py)
constexpr int GROUPS = 16;  // row groups and column groups of a block
constexpr int NT = GROUPS * GROUPS;
constexpr int PER = TI / GROUPS;  // rows (and columns) a thread owns

struct Staged {
    float s[TI], l[TI], g[TI], d[TI];
    int real[TI];
};

__device__ __forceinline__ float discount(int pos) { return 1.0f / log2f(float(pos) + 2.0f); }

// exp(-|x|), the one transcendental both terms share
__device__ __forceinline__ float exp_neg_abs(float x) { return __expf(-fabsf(x)); }
// softplus(x) = max(x, 0) + log1p(exp(-|x|)), from e = exp(-|x|)
__device__ __forceinline__ float softplus_e(float x, float e) {
    return fmaxf(x, 0.0f) + __logf(1.0f + e);
}
// sigmoid(x) from e = exp(-|x|)
__device__ __forceinline__ float sigmoid_e(float x, float e) {
    const float r = __frcp_rn(1.0f + e);
    return x >= 0.0f ? r : e * r;
}

// Tile `tile` of row b into st (values past N are flagged not real).
template <bool WEIGHTED>
__device__ __forceinline__ void stage(Staged& st, const float* sb, const float* lb,
                                      const float* gb, const uint8_t* mb, int tile, int N) {
    for (int c = threadIdx.x; c < TI; c += NT) {
        const int j = tile * TI + c;
        const bool in = j < N;
        st.s[c] = in ? sb[j] : 0.f;
        st.l[c] = in ? lb[j] : 0.f;
        if (WEIGHTED) {
            st.g[c] = in ? gb[j] : 0.f;
            st.d[c] = discount(j);
        }
        st.real[c] = in && mb[j] != 0;
    }
}

// The block's tile pair (ti <= tj) and row b from grid.x: pairs = T(T+1)/2
// per row, row-major over the upper triangle.
__device__ __forceinline__ int tile_pair(int tiles, int pairs, int& ti, int& tj) {
    const int b = blockIdx.x / pairs;
    int p = blockIdx.x - b * pairs;
    ti = 0;
    while (p >= tiles - ti) {
        p -= tiles - ti;
        ++ti;
    }
    tj = ti + p;
    return b;
}

// One thread's rows (r) and columns (u) of the tile pair: values in registers.
struct Owned {
    float s[PER], l[PER], g[PER], d[PER];
    bool real[PER];
};

template <bool WEIGHTED>
__device__ __forceinline__ void own(Owned& o, const Staged& st, int first) {
#pragma unroll
    for (int r = 0; r < PER; ++r) {
        const int c = first + GROUPS * r;
        o.s[r] = st.s[c];
        o.l[r] = st.l[c];
        o.g[r] = WEIGHTED ? st.g[c] : 0.f;
        o.d[r] = WEIGHTED ? st.d[c] : 0.f;
        o.real[r] = st.real[c];
    }
}

template <bool WEIGHTED>
__global__ void __launch_bounds__(NT)
pair_fwd_kernel(const float* __restrict__ s, const float* __restrict__ l,
                const float* __restrict__ g, const uint8_t* __restrict__ m,
                float* __restrict__ partials, int N, int tiles, int pairs, float sigma) {
    __shared__ Staged rows, cols;
    __shared__ float red[NT / 32];
    int ti, tj;
    const int b = tile_pair(tiles, pairs, ti, tj);
    const size_t row = size_t(b) * N;
    stage<WEIGHTED>(rows, s + row, l + row, g + row, m + row, ti, N);
    stage<WEIGHTED>(cols, s + row, l + row, g + row, m + row, tj, N);
    __syncthreads();
    const int rg = threadIdx.x / GROUPS, cg = threadIdx.x % GROUPS;
    Owned a, c;
    own<WEIGHTED>(a, rows, rg);
    own<WEIGHTED>(c, cols, cg);

    float acc = 0.f;
#pragma unroll
    for (int r = 0; r < PER; ++r)
#pragma unroll
        for (int u = 0; u < PER; ++u) {
            // strict upper triangle: every pair of an off-diagonal tile, i < j on the diagonal
            const bool upper = ti < tj || rg + GROUPS * r < cg + GROUPS * u;
            const float x = sigma * (a.s[r] - c.s[u]);
            const float t = 0.5f * (1.0f + fminf(fmaxf(a.l[r] - c.l[u], -1.0f), 1.0f));
            float term = softplus_e(x, exp_neg_abs(x)) - t * x;
            if (WEIGHTED) term *= fabsf(a.g[r] - c.g[u]) * fabsf(a.d[r] - c.d[u]);
            acc += (a.real[r] && c.real[u] && upper) ? term : 0.0f;
        }

#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
        float total = 0.f;
#pragma unroll
        for (int w = 0; w < NT / 32; ++w) total += red[w];
        partials[blockIdx.x] = total;
    }
}

template <bool WEIGHTED>
__global__ void __launch_bounds__(NT)
pair_bwd_kernel(const float* __restrict__ s, const float* __restrict__ l,
                const float* __restrict__ g, const uint8_t* __restrict__ m,
                float* __restrict__ rowpart, float* __restrict__ colpart, int N, int tiles,
                int pairs, float sigma) {
    __shared__ Staged rows, cols;
    __shared__ float colred[NT / 32][TI];
    int ti, tj;
    const int b = tile_pair(tiles, pairs, ti, tj);
    const size_t row = size_t(b) * N;
    stage<WEIGHTED>(rows, s + row, l + row, g + row, m + row, ti, N);
    stage<WEIGHTED>(cols, s + row, l + row, g + row, m + row, tj, N);
    __syncthreads();
    const int rg = threadIdx.x / GROUPS, cg = threadIdx.x % GROUPS;
    Owned a, c;
    own<WEIGHTED>(a, rows, rg);
    own<WEIGHTED>(c, cols, cg);

    float racc[PER], cacc[PER];
#pragma unroll
    for (int r = 0; r < PER; ++r) racc[r] = cacc[r] = 0.f;
#pragma unroll
    for (int r = 0; r < PER; ++r)
#pragma unroll
        for (int u = 0; u < PER; ++u) {
            const bool upper = ti < tj || rg + GROUPS * r < cg + GROUPS * u;
            const float x = sigma * (a.s[r] - c.s[u]);
            const float t = 0.5f * (1.0f + fminf(fmaxf(a.l[r] - c.l[u], -1.0f), 1.0f));
            float core = sigma * (sigmoid_e(x, exp_neg_abs(x)) - t);
            if (WEIGHTED) core *= fabsf(a.g[r] - c.g[u]) * fabsf(a.d[r] - c.d[u]);
            core = (a.real[r] && c.real[u] && upper) ? core : 0.0f;
            racc[r] += core;
            cacc[u] += core;
        }

    // a row's sum over the 16 column groups: the 16 lanes of a half warp
#pragma unroll
    for (int r = 0; r < PER; ++r)
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) racc[r] += __shfl_xor_sync(0xffffffffu, racc[r], o);
    // a column's sum over the 16 row groups: the warp's two, then the 8 warps in order
#pragma unroll
    for (int u = 0; u < PER; ++u) cacc[u] += __shfl_xor_sync(0xffffffffu, cacc[u], 16);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane < GROUPS) {
#pragma unroll
        for (int u = 0; u < PER; ++u) colred[warp][cg + GROUPS * u] = cacc[u];
    }
    const int i0 = ti * TI, j0 = tj * TI;
    if (cg == 0) {
#pragma unroll
        for (int r = 0; r < PER; ++r) {
            const int i = i0 + rg + GROUPS * r;
            if (i < N) rowpart[(size_t(b) * tiles + tj) * N + i] = racc[r];
        }
    }
    __syncthreads();
    for (int c2 = threadIdx.x; c2 < TI; c2 += NT) {
        const int j = j0 + c2;
        if (j >= N) continue;
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < NT / 32; ++w) sum += colred[w][c2];
        colpart[(size_t(b) * tiles + ti) * N + j] = sum;
    }
}

// grad[b, i] = scale * (sum over tiles t >= tile(i) of rowpart[b, t, i]
// minus the sum over t <= tile(i) of colpart[b, t, i]), 0 on a padded doc.
__global__ void __launch_bounds__(256)
pair_bwd_reduce_kernel(const uint8_t* __restrict__ m, const float* __restrict__ rowpart,
                       const float* __restrict__ colpart, const float* __restrict__ scale,
                       float* __restrict__ grad, long long BN, int N, int tiles) {
    const long long idx = (long long)blockIdx.x * 256 + threadIdx.x;
    if (idx >= BN) return;
    const long long b = idx / N;
    const int i = int(idx - b * N);
    const int ti = i / TI;
    float up = 0.f, down = 0.f;
    for (int t = ti; t < tiles; ++t) up += rowpart[(b * tiles + t) * N + i];
    for (int t = 0; t <= ti; ++t) down += colpart[(b * tiles + t) * N + i];
    grad[idx] = m[idx] ? (up - down) * scale[0] : 0.0f;
}

// tiles a row, tile pairs a row, blocks of the pair kernels (< 2^31 or -1)
struct Grid {
    int tiles, pairs;
    long long blocks;
};

Grid grid_of(int B, int N) {
    const int tiles = (N + TI - 1) / TI;
    const long long pairs = (long long)tiles * (tiles + 1) / 2;
    const long long blocks = pairs * B;
    return {tiles, int(pairs), blocks < (1LL << 31) ? blocks : -1};
}

}  // namespace

extern "C" {

// Both return a cudaError_t (0 on success). weighted: 1 = LambdaRank, 0 = RankNet.
// partials: [B, T(T+1)/2] fp32 with T = ceil(N / TI), in grid order.
int pairwise_lambda_fwd(const void* s, const void* l, const void* g, const void* m,
                        void* partials, int B, int N, float sigma, int weighted, void* stream) {
    if (B < 1 || N < 1) return int(cudaErrorInvalidValue);
    const Grid gr = grid_of(B, N);
    if (gr.blocks < 0) return int(cudaErrorInvalidConfiguration);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* sp = static_cast<const float*>(s);
    const float* lp = static_cast<const float*>(l);
    const float* gp = static_cast<const float*>(g);
    const uint8_t* mp = static_cast<const uint8_t*>(m);
    float* out = static_cast<float*>(partials);
    const unsigned blocks = unsigned(gr.blocks);
    if (weighted)
        pair_fwd_kernel<true><<<blocks, NT, 0, st>>>(sp, lp, gp, mp, out, N, gr.tiles, gr.pairs,
                                                     sigma);
    else
        pair_fwd_kernel<false><<<blocks, NT, 0, st>>>(sp, lp, gp, mp, out, N, gr.tiles, gr.pairs,
                                                      sigma);
    return int(cudaGetLastError());
}

// scratch: 2 * B * T * N fp32 (the row and column partials).
int pairwise_lambda_bwd(const void* s, const void* l, const void* g, const void* m,
                        const void* scale, void* grad, void* scratch, int B, int N, float sigma,
                        int weighted, void* stream) {
    if (B < 1 || N < 1) return int(cudaErrorInvalidValue);
    const Grid gr = grid_of(B, N);
    const long long BN = (long long)B * N;
    if (gr.blocks < 0 || (BN + 255) / 256 >= (1LL << 31)) return int(cudaErrorInvalidConfiguration);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* sp = static_cast<const float*>(s);
    const float* lp = static_cast<const float*>(l);
    const float* gp = static_cast<const float*>(g);
    const uint8_t* mp = static_cast<const uint8_t*>(m);
    float* rowpart = static_cast<float*>(scratch);
    float* colpart = rowpart + BN * gr.tiles;
    const unsigned blocks = unsigned(gr.blocks);
    if (weighted)
        pair_bwd_kernel<true><<<blocks, NT, 0, st>>>(sp, lp, gp, mp, rowpart, colpart, N,
                                                     gr.tiles, gr.pairs, sigma);
    else
        pair_bwd_kernel<false><<<blocks, NT, 0, st>>>(sp, lp, gp, mp, rowpart, colpart, N,
                                                      gr.tiles, gr.pairs, sigma);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
    pair_bwd_reduce_kernel<<<unsigned((BN + 255) / 256), 256, 0, st>>>(
        mp, rowpart, colpart, static_cast<const float*>(scale), static_cast<float*>(grad), BN, N,
        gr.tiles);
    return int(cudaGetLastError());
}

const char* pairwise_lambda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
