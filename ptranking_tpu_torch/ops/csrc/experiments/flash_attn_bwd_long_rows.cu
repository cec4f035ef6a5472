// An experiment, not on any path of the package: the long backward of
// ../flash_attn_bwd.cu (bf16 lists of 129 .. 256 docs, one a block of 8
// warps) with the other ownership. The shipped kernel takes the list's keys
// in two halves of 128, so dk and dv come whole and dq is the sum of two
// partials; here the block takes the list's query rows in two passes of 128
// and each pass all 256 keys, so dq comes whole and dk and dv are each the
// sum of two partials. Built and timed against the shipped kernel by
// ptranking_tpu_torch/tools/kernel_variants.py (PERF.md has the times).
//
// A pass of 128 query rows (warp w: rows 16w .. 16w + 15 of the pass):
//   1. for each half of 128 keys: S and dP of the pass's rows by the half's
//      keys over d in double-buffered 32-column chunks (the shipped kernel's
//      step 1), then P and dS (p_ds_packed) stored into [128][264] tiles at
//      the half's columns;
//   2. for each 64-column output chunk of K (all 256 keys): dq of the warp's
//      16 rows over all 256 keys, whole, written once;
//   3. for each 64-column output chunk of Q and dO (the pass's rows): dv and
//      dk of the warp's two groups of 16 keys (16w and 128 + 16w) over the
//      pass's rows. The first pass writes these partials to fp32 scratch (dv,
//      then dk: 2 * B*H*N*d values), the second reads them back, adds its own
//      and rounds once; each thread reads back the values it wrote.
// Shared memory: the P and dS tiles (135,168 bytes), two stages of 40,960
// and the key info: 218,112 bytes.

#include "../flash_attn_bwd.cu"

namespace {

constexpr int ROWS_LDP = LONG_ROWS + 8;  // row stride of the P and dS tiles: every key

__host__ __device__ constexpr size_t long_rows_smem_bytes(int cw, int dq_cw) {
    return (2 * size_t(LONG_HALF) * ROWS_LDP + 2 * long_stage_elems(cw, dq_cw)) * sizeof(bf16)
           + LONG_ROWS * sizeof(int);
}

template <int CW, int DQ_CW>
__global__ void __launch_bounds__(LONG_NT, 1)
flash_bwd_long_rows_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, const bf16* __restrict__ dout,
                               const float* __restrict__ row_max,
                               const float* __restrict__ row_sum, const float* __restrict__ dsum,
                               const uint8_t* __restrict__ mask, bf16* __restrict__ dq,
                               bf16* __restrict__ dk, bf16* __restrict__ dv, float* part,
                               int lists, int H, int N, int d, float scale, int copy, int how) {
    constexpr int KS = CW;
    constexpr int LDC = 16 * CW + 8;      // step 1's chunk tiles
    constexpr int LDO = 16 * DQ_CW + 8;   // steps 2 and 3's output-chunk tiles
    constexpr int HALF_CHUNK = LONG_HALF * LDC;
    constexpr int STAGE = int(long_stage_elems(CW, DQ_CW));
    static_assert(LONG_ROWS * LDO <= STAGE, "step 2's K chunk fits a stage");
    extern __shared__ uint4 smem_mma[];
    bf16* Ps = reinterpret_cast<bf16*>(smem_mma);  // [LONG_HALF query rows of the pass][ROWS_LDP]
    bf16* dSs = Ps + LONG_HALF * ROWS_LDP;
    bf16* Cs = dSs + LONG_HALF * ROWS_LDP;         // [2][STAGE]
    int* kinfo = reinterpret_cast<int*>(Cs + 2 * STAGE);  // [LONG_ROWS]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    const int per_tile = LONG_ROWS / N;
    const int l0 = blockIdx.x * per_tile;
    const int nrows = min(per_tile, lists - l0) * N;
    const size_t row0 = size_t(l0) * N;
    const size_t base = row0 * d;
    const size_t n = size_t(lists) * N * d;
    const int chunks = (d + 16 * CW - 1) / (16 * CW);
    const int out_chunks = (d + 16 * DQ_CW - 1) / (16 * DQ_CW);
    const int per_pass = 2 * chunks + 2 * out_chunks;
    const int stages = 2 * per_pass;
    auto rows_from = [&](int r0) { return max(min(nrows - r0, LONG_HALF), 0); };

    // stage st of pass st / per_pass, at u = st % per_pass: u < 2 * chunks
    // step 1's d-chunk u % chunks of the half u / chunks (Q, dO of the pass's
    // rows, K, V of the half's keys); then step 2's output chunks (K of
    // every key), then step 3's (Q, dO of the pass's rows)
    auto prefetch = [&](int st) {
        bf16* cs = Cs + (st & 1) * STAGE;
        const int pass = st / per_pass, u = st % per_pass;
        const size_t qb = base + size_t(pass) * LONG_HALF * d;
        const int qrows = rows_from(pass * LONG_HALF);
        if (u < 2 * chunks) {
            const int half = u / chunks, c0 = (u - half * chunks) * 16 * CW;
            const size_t kb = base + size_t(half) * LONG_HALF * d;
            const int krows = rows_from(half * LONG_HALF);
            load_chunk<LONG_NT, CW, LONG_HALF>(cs, q + qb, qrows, d, c0, copy);
            load_chunk<LONG_NT, CW, LONG_HALF>(cs + HALF_CHUNK, dout + qb, qrows, d, c0, copy);
            load_chunk<LONG_NT, CW, LONG_HALF>(cs + 2 * HALF_CHUNK, k + kb, krows, d, c0, copy);
            load_chunk<LONG_NT, CW, LONG_HALF>(cs + 3 * HALF_CHUNK, v + kb, krows, d, c0, copy);
        } else if (u < 2 * chunks + out_chunks) {
            load_chunk<LONG_NT, DQ_CW, LONG_ROWS>(cs, k + base, nrows, d,
                                                  (u - 2 * chunks) * 16 * DQ_CW, copy);
        } else {
            const int c0 = (u - 2 * chunks - out_chunks) * 16 * DQ_CW;
            load_chunk<LONG_NT, DQ_CW, LONG_HALF>(cs, q + qb, qrows, d, c0, copy);
            load_chunk<LONG_NT, DQ_CW, LONG_HALF>(cs + LONG_HALF * LDO, dout + qb, qrows, d, c0,
                                                  copy);
        }
        cp_async_commit();
    };
    auto next = [&](int st) {
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

    int st = 0;
    for (int pass = 0; pass < 2; ++pass) {
        int seg[2];
        float m[2], inv[2], D[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = pass * LONG_HALF + warp * 16 + g + 8 * h;
            const bool in = r < nrows;
            seg[h] = in ? r / N : -2;
            m[h] = in ? row_max[row0 + r] : 0.f;
            inv[h] = in ? 1.f / row_sum[row0 + r] : 0.f;
            D[h] = in ? dsum[row0 + r] : 0.f;
        }
        // step 1, for each half of the keys
        for (int half = 0; half < 2; ++half) {
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
                __syncthreads();
            }
            uint32_t pa[LONG_HALF / 16][4], dsa[LONG_HALF / 16][4];
            p_ds_packed<LONG_HALF / 8>(pa, dsa, s, dp, kinfo + half * LONG_HALF + 2 * t4, seg, m,
                                       inv, D, scale);
#pragma unroll
            for (int j = 0; j < LONG_HALF / 8; ++j)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int at = (warp * 16 + g + 8 * h) * ROWS_LDP + half * LONG_HALF + 8 * j
                                   + 2 * t4;
                    *reinterpret_cast<uint32_t*>(Ps + at) = pa[j >> 1][(j & 1) * 2 + h];
                    *reinterpret_cast<uint32_t*>(dSs + at) = dsa[j >> 1][(j & 1) * 2 + h];
                }
        }

        // step 2: dq of the warp's rows over every key, whole
        for (int oc = 0; oc < out_chunks; ++oc, ++st) {
            next(st);
            const bf16* ks = Cs + (st & 1) * STAGE;
            uint32_t fa[LONG_ROWS / 16][4];
            float acc[2 * DQ_CW][4];
#pragma unroll
            for (int j = 0; j < 2 * DQ_CW; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
            load_a<LONG_ROWS / 16>(fa, dSs, warp * 16, lane);
            product_kn<DQ_CW, LONG_ROWS / 16>(acc, fa, ks, 0, lane);
            const int c0 = oc * 16 * DQ_CW;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = pass * LONG_HALF + warp * 16 + g + 8 * h;
                if (r >= nrows) continue;
                bf16* row = dq + base + size_t(r) * d;
#pragma unroll
                for (int j = 0; j < 2 * DQ_CW; ++j)
                    store_pair(row, c0 + 8 * j + 2 * t4, acc[j][2 * h] * scale,
                               acc[j][2 * h + 1] * scale, d, pairs);
            }
            __syncthreads();
        }

        // step 3: dv and dk of the warp's two groups of 16 keys over the pass's rows
        for (int oc = 0; oc < out_chunks; ++oc, ++st) {
            next(st);
            const bf16* qo = Cs + (st & 1) * STAGE;
            const bf16* doo = qo + LONG_HALF * LDO;
            const int c0 = oc * 16 * DQ_CW;
#pragma unroll 1
            for (int grp = 0; grp < 2; ++grp) {
                const int key0 = grp * LONG_HALF + warp * 16;
                uint32_t fa[LONG_HALF / 16][4];
                float acc[2 * DQ_CW][4];
                auto combine = [&](bf16* out, float* prt, float mul) {
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const int r = key0 + g + 8 * h;
                        if (r >= nrows) continue;
                        float* p = prt + (row0 + r) * d;
                        bf16* row = out + base + size_t(r) * d;
#pragma unroll
                        for (int j = 0; j < 2 * DQ_CW; ++j) {
                            const int col = c0 + 8 * j + 2 * t4;
                            float x = acc[j][2 * h], y = acc[j][2 * h + 1];
                            if (pass == 0) {
                                if (col < d) p[col] = x;
                                if (col + 1 < d) p[col + 1] = y;
                            } else {
                                if (col < d) x += p[col];
                                if (col + 1 < d) y += p[col + 1];
                                store_pair(row, col, x * mul, y * mul, d, pairs);
                            }
                        }
                    }
                };
                auto product = [&](const bf16* tile, const bf16* btile) {
#pragma unroll
                    for (int j = 0; j < 2 * DQ_CW; ++j)
#pragma unroll
                        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
                    load_a_trans<LONG_HALF / 16, ROWS_LDP>(fa, tile, key0, lane);
                    product_kn<DQ_CW, LONG_HALF / 16>(acc, fa, btile, 0, lane);
                };
                product(Ps, doo);  // dv's share: P^T dO
                combine(dv, part, 1.f);
                product(dSs, qo);  // dk's share: dS^T Q
                combine(dk, part + n, scale);
            }
            __syncthreads();
        }
    }
}

cudaError_t launch_bwd_long_rows(const Args& a, void* dq, void* dk, void* dv, float* part) {
    const auto kernel = flash_bwd_long_rows_mma_kernel<LONG_CW, LONG_DQ_CW>;
    const size_t bytes = long_rows_smem_bytes(LONG_CW, LONG_DQ_CW);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           int(bytes));
    if (err != cudaSuccess) return err;
    const int lists = a.B * a.H, per_tile = LONG_ROWS / a.N;
    kernel<<<unsigned((lists + per_tile - 1) / per_tile), LONG_NT, bytes, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
        static_cast<const float*>(a.row_max), static_cast<const float*>(a.row_sum),
        static_cast<const float*>(a.dsum), static_cast<const uint8_t*>(a.mask),
        static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv), part, lists, a.H,
        a.N, a.d, 1.0f / sqrtf(float(a.d)), wide_copy(a),
        store_mode(a, dq) & store_mode(a, dk) & store_mode(a, dv));
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// As flash_attn_bwd_long; part is fp32 scratch of 2*B*H*N*d values.
int flash_attn_bwd_long_rows(const void* q, const void* k, const void* v, const void* dout,
                             const void* row_max, const void* row_sum, const void* dsum,
                             const void* mask, void* dq, void* dk, void* dv, void* part, int B,
                             int H, int N, int d, int dtype, void* stream) {
    const Args a{q, k, v, dout, row_max, row_sum, dsum, mask, B, H, N, d,
                 static_cast<cudaStream_t>(stream)};
    if (B < 1 || H < 1 || N < 1 || N > LONG_ROWS || d < 1 || dtype != 1
        || (long long)B * H >= (1LL << 31))
        return int(cudaErrorInvalidValue);
    return int(launch_bwd_long_rows(a, dq, dk, dv, static_cast<float*>(part)));
}

}  // extern "C"
