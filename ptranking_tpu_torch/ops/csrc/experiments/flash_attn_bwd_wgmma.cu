// An experiment, not on any path of the package: the bf16 backward kernels of
// ../flash_attn_bwd.cu with all four products as warpgroup instructions
// (wgmma.mma_async, m64n64k16 and m64n80k16), for head dims 65..80 with
// 8-byte-aligned rows (the flagship's d = 68). Built and timed against the
// shipped mma.sync kernels by ptranking_tpu_torch/tools/kernel_variants.py;
// it gives the same bits and was not faster on an H100 (PERF.md has the
// times), so the package keeps mma.sync. It stays as the measured record and
// as a checked example of wgmma operand descriptors without swizzle.
//
// The block is one warpgroup (4 warps) owning 64 keys (dk/dv) or 64 query
// rows (dq). S^T = K Q^T and dP^T = V dO^T (dq: S = Q K^T, dP = dO V^T) take
// both operands from shared memory; warp w then holds rows 16w .. 16w + 15 of
// the accumulators in the mma.sync fragment layout, so the fragment
// arithmetic and the register hand-over of P^T and dS^T as the A operand of
// dv += P^T dO, dk += dS^T Q (dq += dS K) are those of the shipped kernels.
// The same shared tile serves as a K-major operand of the first products and
// as a transposed (MN-major) B operand of the second ones.

#include "../flash_attn_bwd.cu"

namespace {

static_assert(MMA_WARPS == 4, "one warpgroup a block");

constexpr int WG_DP = 80;                       // padded head dim
constexpr int WG_TILE_BYTES = TILE * WG_DP * 2;  // one [64][80] bf16 tile

// A tile for wgmma without swizzle is cut into core matrices of 8 rows x 16
// bytes (8 bf16), each 128 contiguous bytes; the core matrices of one 8-row
// group follow each other along the columns, and the 8-row groups follow each
// other WG_DP * 16 bytes apart. Byte offset of element (r, c):
__device__ __forceinline__ int cm_offset(int r, int c) {
    return (((r >> 3) * WG_DP + (c >> 3) * 8 + (r & 7)) << 4) + ((c & 7) << 1);
}

// The 64-bit shared-memory operand descriptor, no swizzle: address, leading
// and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo16, uint32_t sbo16) {
    return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo16) << 16) | (uint64_t(sbo16) << 32);
}
// The tile as a K-major operand (rows = the operand's M or N index, columns =
// the product's depth), 16-deep step ks: the step's two core matrices lie 8
// units apart, the 8-row groups WG_DP units.
__device__ __forceinline__ uint64_t wg_desc_rows(uint32_t tile, int ks) {
    return wg_desc(tile + ks * 256, 8, WG_DP);
}
// The tile as an MN-major B operand (rows = the product's depth, columns = N;
// the instruction transposes it), 16-deep step ch = rows 16ch .. 16ch + 15: the
// step's two 8-row groups lie WG_DP units apart, the 8-column groups 8 units.
__device__ __forceinline__ uint64_t wg_desc_depth(uint32_t tile, int ch) {
    return wg_desc(tile + ch * 2 * WG_DP * 16, WG_DP, 8);
}

#define ACC4(a, j) "+f"(a[j][0]), "+f"(a[j][1]), "+f"(a[j][2]), "+f"(a[j][3])

// d (64 x 64, fp32) += A (64 x 16) * B^T (B: 64 x 16), both K-major in shared
// memory. A thread of warp w holds d[j][0..1] = (row 16w + g, columns 8j + 2t,
// 8j + 2t + 1) and d[j][2..3] = (row 16w + g + 8, the same columns): the
// mma.sync fragment, one per 8-column tile j.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : ACC4(d, 0), ACC4(d, 1), ACC4(d, 2), ACC4(d, 3), ACC4(d, 4), ACC4(d, 5), ACC4(d, 6),
          ACC4(d, 7)
        : "l"(a), "l"(b), "r"(1));
}

// d (64 x 80, fp32) += A (64 x 16, the warps' mma.sync A fragments in
// registers) * B (16 x 80, MN-major in shared memory, transposed on the way).
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[10][4], const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39}, "
        "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
        : ACC4(d, 0), ACC4(d, 1), ACC4(d, 2), ACC4(d, 3), ACC4(d, 4), ACC4(d, 5), ACC4(d, 6),
          ACC4(d, 7), ACC4(d, 8), ACC4(d, 9)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
#undef ACC4

__device__ __forceinline__ void wg_fence() {  // registers written before it are seen by wgmma
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// shared-memory writes of this thread (stores, cp.async) become visible to wgmma
__device__ __forceinline__ void fence_async_shared() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps the compiler from reading an accumulator before the wait above it
template <int NTILES>
__device__ __forceinline__ void fence_accumulator(float (&d)[NTILES][4]) {
#pragma unroll
    for (int j = 0; j < NTILES; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// A thread's share of a tile copy in 8-byte chunks (4 bf16): chunk tid + MMA_NT*i
// of the tile is (row, chunk of the row); one division a kernel, not one a chunk.
struct Chunks {
    int per_row, row, col, row_step, col_step;
    __device__ Chunks(int d, int tid) {
        per_row = max(d >> 2, 1);
        row = tid / per_row;
        col = tid - row * per_row;
        row_step = MMA_NT / per_row;
        col_step = MMA_NT - row_step * per_row;
    }
};

// load_tile for the core-matrix layout: 8-byte cp.async only
__device__ __forceinline__ void load_tile_cm(unsigned char* dst, const bf16* __restrict__ src,
                                             int nrows, int d, const Chunks& ch) {
    int r = ch.row, c = ch.col;
    while (r < TILE) {
        unsigned char* p = dst + cm_offset(r, c * 4);
        if (r < nrows) cp_async_8(smem_addr(p), src + size_t(r) * d + c * 4, 8);
        else *reinterpret_cast<uint2*>(p) = make_uint2(0u, 0u);
        r += ch.row_step;
        c += ch.col_step;
        if (c >= ch.per_row) {
            c -= ch.per_row;
            ++r;
        }
    }
}

// columns d .. WG_DP-1 of `ntiles` tiles: written once, no copy touches them
__device__ __forceinline__ void zero_pad_columns_cm(unsigned char* tiles, int ntiles, int d) {
    for (int i = threadIdx.x; i < ntiles * TILE; i += MMA_NT)
        for (int c = d; c < WG_DP; ++c)
            *reinterpret_cast<bf16*>(tiles + (i / TILE) * WG_TILE_BYTES + cm_offset(i % TILE, c)) =
                __float2bfloat16(0.f);
}

__host__ __device__ constexpr size_t wg_smem_bytes() {
    return size_t(6) * WG_TILE_BYTES + size_t(6) * TILE * 4;
}

// The block is one warpgroup; warp w holds rows 16w .. 16w + 15 of every
// accumulator in the mma.sync fragment layout, so the fragment arithmetic and
// the register hand-over of P^T and dS^T are those of the mma.sync kernel.
__global__ void __launch_bounds__(MMA_NT, 2)
flash_bwd_dkdv_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const bf16* __restrict__ dout,
                            const float* __restrict__ row_max,
                            const float* __restrict__ row_sum, const float* __restrict__ dsum,
                            const uint8_t* __restrict__ mask, bf16* __restrict__ dk,
                            bf16* __restrict__ dv, int H, int N, int d, float scale, int how) {
    extern __shared__ uint4 smem_mma[];
    unsigned char* Ks = reinterpret_cast<unsigned char*>(smem_mma);  // the block's keys
    unsigned char* Vs = Ks + WG_TILE_BYTES;
    unsigned char* Qs = Vs + WG_TILE_BYTES;                          // two buffers each
    unsigned char* dOs = Qs + 2 * WG_TILE_BYTES;
    float* stats = reinterpret_cast<float*>(dOs + 2 * WG_TILE_BYTES);  // [2][m, 1/l, D][TILE]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    const int bh = blockIdx.y;
    const int b = bh / H;
    const int k0 = blockIdx.x * TILE;
    const size_t base = size_t(bh) * N * d;
    const size_t stat = size_t(bh) * N;
    const int krows = min(TILE, N - k0);
    const Chunks ch(d, tid);

    zero_pad_columns_cm(Ks, 6, d);
    load_tile_cm(Ks, k + base + size_t(k0) * d, krows, d, ch);
    load_tile_cm(Vs, v + base + size_t(k0) * d, krows, d, ch);
    load_tile_cm(Qs, q + base, min(TILE, N), d, ch);
    load_tile_cm(dOs, dout + base, min(TILE, N), d, ch);
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

    float acc_k[WG_DP / 8][4], acc_v[WG_DP / 8][4];
#pragma unroll
    for (int j = 0; j < WG_DP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;

    cp_async_wait_all();
    fence_async_shared();
    __syncthreads();

    const uint32_t Ka = smem_addr(Ks), Va = smem_addr(Vs);
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
            load_tile_cm(Qs + (buf ^ 1) * WG_TILE_BYTES, q + base + size_t(q1) * d, nrows, d, ch);
            load_tile_cm(dOs + (buf ^ 1) * WG_TILE_BYTES, dout + base + size_t(q1) * d, nrows, d,
                         ch);
            cp_async_commit();
            next_in = tid < TILE && q1 + tid < N;
            if (next_in) {
                next_m = row_max[stat + q1 + tid];
                next_l = row_sum[stat + q1 + tid];
                next_D = dsum[stat + q1 + tid];
            }
        }

        const uint32_t Qa = smem_addr(Qs + buf * WG_TILE_BYTES);
        const uint32_t dOa = smem_addr(dOs + buf * WG_TILE_BYTES);
        // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries
        float s[TILE / 8][4], dp[TILE / 8][4];
#pragma unroll
        for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < WG_DP / 16; ++ks)
            wgmma_ss_n64(s, wg_desc_rows(Ka, ks), wg_desc_rows(Qa, ks));
#pragma unroll
        for (int ks = 0; ks < WG_DP / 16; ++ks)
            wgmma_ss_n64(dp, wg_desc_rows(Va, ks), wg_desc_rows(dOa, ks));
        wg_commit();
        wg_wait_all();
        fence_accumulator(s);
        fence_accumulator(dp);

        uint32_t pa[TILE / 16][4], dsa[TILE / 16][4];
        p_ds_transposed<TILE / 8>(pa, dsa, s, dp, stats + buf * 3 * TILE + 2 * t4, flag, scale);
        wg_fence();
#pragma unroll
        for (int c = 0; c < TILE / 16; ++c)
            wgmma_rs_n80(acc_v, pa[c], wg_desc_depth(dOa, c));   // dv += P^T dO
#pragma unroll
        for (int c = 0; c < TILE / 16; ++c)
            wgmma_rs_n80(acc_k, dsa[c], wg_desc_depth(Qa, c));   // dk += dS^T Q
        wg_commit();

        if (more && tid < TILE) {
            float* nx = stats + (buf ^ 1) * 3 * TILE;
            nx[tid] = next_m;
            nx[TILE + tid] = next_in ? 1.f / next_l : 0.f;
            nx[2 * TILE + tid] = next_D;
        }
        wg_wait_all();
        fence_accumulator(acc_v);
        fence_accumulator(acc_k);
        cp_async_wait_all();
        fence_async_shared();
        __syncthreads();  // tile t+1 has landed, and nothing reads tile t any more
    }

    const bool pairs = how & STORE_PAIRS;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + g + 8 * h;
        if (r >= krows) continue;
        bf16* dkrow = dk + base + size_t(k0 + r) * d;
        bf16* dvrow = dv + base + size_t(k0 + r) * d;
#pragma unroll
        for (int j = 0; j < WG_DP / 8; ++j) {
            const int col = 8 * j + 2 * t4;
            store_pair(dkrow, col, acc_k[j][2 * h] * scale, acc_k[j][2 * h + 1] * scale, d, pairs);
            store_pair(dvrow, col, acc_v[j][2 * h], acc_v[j][2 * h + 1], d, pairs);
        }
    }
}

__global__ void __launch_bounds__(MMA_NT, 2)
flash_bwd_dq_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ row_max, const float* __restrict__ row_sum,
                          const float* __restrict__ dsum, const uint8_t* __restrict__ mask,
                          bf16* __restrict__ dq, int H, int N, int d, float scale, int how) {
    extern __shared__ uint4 smem_mma[];
    unsigned char* Qs = reinterpret_cast<unsigned char*>(smem_mma);  // the block's query rows
    unsigned char* dOs = Qs + WG_TILE_BYTES;
    unsigned char* Ks = dOs + WG_TILE_BYTES;                         // two buffers each
    unsigned char* Vs = Ks + 2 * WG_TILE_BYTES;
    int* kflag = reinterpret_cast<int*>(Vs + 2 * WG_TILE_BYTES);     // [2][TILE]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    const int bh = blockIdx.y;
    const int b = bh / H;
    const int q0 = blockIdx.x * TILE;
    const size_t base = size_t(bh) * N * d;
    const size_t stat = size_t(bh) * N;
    const int qrows = min(TILE, N - q0);
    const uint8_t* mask_row = mask + size_t(b) * N;
    const Chunks ch(d, tid);

    zero_pad_columns_cm(Qs, 6, d);
    load_tile_cm(Qs, q + base + size_t(q0) * d, qrows, d, ch);
    load_tile_cm(dOs, dout + base + size_t(q0) * d, qrows, d, ch);
    load_tile_cm(Ks, k + base, min(TILE, N), d, ch);
    load_tile_cm(Vs, v + base, min(TILE, N), d, ch);
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

    float acc[WG_DP / 8][4];
#pragma unroll
    for (int j = 0; j < WG_DP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

    cp_async_wait_all();
    fence_async_shared();
    __syncthreads();

    const uint32_t Qa = smem_addr(Qs), dOa = smem_addr(dOs);
    const int tiles = (N + TILE - 1) / TILE;
    for (int t = 0; t < tiles; ++t) {
        const int buf = t & 1;
        const bool more = t + 1 < tiles;
        int next_flag = KEY_OUT;
        if (more) {  // the next key tile: copies in flight, its flags in a register
            const int k1 = (t + 1) * TILE;
            const int nrows = min(TILE, N - k1);
            load_tile_cm(Ks + (buf ^ 1) * WG_TILE_BYTES, k + base + size_t(k1) * d, nrows, d, ch);
            load_tile_cm(Vs + (buf ^ 1) * WG_TILE_BYTES, v + base + size_t(k1) * d, nrows, d, ch);
            cp_async_commit();
            if (tid < TILE) next_flag = key_flag(mask_row, k1 + tid, N);
        }

        const uint32_t Ka = smem_addr(Ks + buf * WG_TILE_BYTES);
        const uint32_t Va = smem_addr(Vs + buf * WG_TILE_BYTES);
        // S = Q K^T and dP = dO V^T: 64 query rows x 64 keys
        float s[TILE / 8][4], dp[TILE / 8][4];
#pragma unroll
        for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < WG_DP / 16; ++ks)
            wgmma_ss_n64(s, wg_desc_rows(Qa, ks), wg_desc_rows(Ka, ks));
#pragma unroll
        for (int ks = 0; ks < WG_DP / 16; ++ks)
            wgmma_ss_n64(dp, wg_desc_rows(dOa, ks), wg_desc_rows(Va, ks));
        wg_commit();
        wg_wait_all();
        fence_accumulator(s);
        fence_accumulator(dp);

        uint32_t dsa[TILE / 16][4];
        ds_fragment<TILE / 8>(dsa, s, dp, kflag + buf * TILE + 2 * t4, m, inv, D, scale);
        wg_fence();
#pragma unroll
        for (int c = 0; c < TILE / 16; ++c)
            wgmma_rs_n80(acc, dsa[c], wg_desc_depth(Ka, c));  // dq += dS K
        wg_commit();

        if (more && tid < TILE) kflag[(buf ^ 1) * TILE + tid] = next_flag;
        wg_wait_all();
        fence_accumulator(acc);
        cp_async_wait_all();
        fence_async_shared();
        __syncthreads();  // tile t+1 has landed, and nothing reads tile t any more
    }

    const bool pairs = how & STORE_PAIRS;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + g + 8 * h;
        if (r >= qrows) continue;
        bf16* dqrow = dq + base + size_t(q0 + r) * d;
#pragma unroll
        for (int j = 0; j < WG_DP / 8; ++j)
            store_pair(dqrow, 8 * j + 2 * t4, acc[j][2 * h] * scale, acc[j][2 * h + 1] * scale, d,
                       pairs);
    }
}

#define BF16_ARGS(a)                                                                   \
    static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),                      \
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),               \
        static_cast<const float*>(a.row_max), static_cast<const float*>(a.row_sum),    \
        static_cast<const float*>(a.dsum), static_cast<const uint8_t*>(a.mask)

// head dims 65..80 with 8-byte copies: the warpgroup kernels
bool use_wgmma(const Args& a) { return (a.d + 15) / 16 * 16 == WG_DP && copy_mode(a); }

cudaError_t launch_dkdv_wgmma(const Args& a, void* dk, void* dv) {
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           int(wg_smem_bytes()));
    if (err != cudaSuccess) return err;
    const dim3 grid((a.N + TILE - 1) / TILE, a.B * a.H);
    flash_bwd_dkdv_wgmma_kernel<<<grid, MMA_NT, wg_smem_bytes(), a.stream>>>(
        BF16_ARGS(a), static_cast<bf16*>(dk), static_cast<bf16*>(dv), a.H, a.N, a.d,
        1.0f / sqrtf(float(a.d)), store_mode(a, dk) & store_mode(a, dv));
    return cudaGetLastError();
}

cudaError_t launch_dq_wgmma(const Args& a, void* dq) {
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           int(wg_smem_bytes()));
    if (err != cudaSuccess) return err;
    const dim3 grid((a.N + TILE - 1) / TILE, a.B * a.H);
    flash_bwd_dq_wgmma_kernel<<<grid, MMA_NT, wg_smem_bytes(), a.stream>>>(
        BF16_ARGS(a), static_cast<bf16*>(dq), a.H, a.N, a.d, 1.0f / sqrtf(float(a.d)),
        store_mode(a, dq));
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// As flash_attn_bwd_dkdv / flash_attn_bwd_dq for bf16; cudaErrorInvalidValue
// outside head dims 65..80 with 8-byte copies.
int flash_attn_bwd_dkdv_wgmma(const void* q, const void* k, const void* v, const void* dout,
                              const void* row_max, const void* row_sum, const void* dsum,
                              const void* mask, void* dk, void* dv, int B, int H, int N, int d,
                              void* stream) {
    const Args a{q, k, v, dout, row_max, row_sum, dsum, mask, B, H, N, d,
                 static_cast<cudaStream_t>(stream)};
    if (!valid(a, 1) || !use_wgmma(a)) return int(cudaErrorInvalidValue);
    return int(launch_dkdv_wgmma(a, dk, dv));
}

int flash_attn_bwd_dq_wgmma(const void* q, const void* k, const void* v, const void* dout,
                            const void* row_max, const void* row_sum, const void* dsum,
                            const void* mask, void* dq, int B, int H, int N, int d, void* stream) {
    const Args a{q, k, v, dout, row_max, row_sum, dsum, mask, B, H, N, d,
                 static_cast<cudaStream_t>(stream)};
    if (!valid(a, 1) || !use_wgmma(a)) return int(cudaErrorInvalidValue);
    return int(launch_dq_wgmma(a, dq));
}

}  // extern "C"
