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
// Head dims above 128: flash_fwd_wide_mma_kernel (bf16), which splits the
// output's head dim over the grid and streams the contraction over d (the
// section "d > 128: the bf16 wide kernel" below says why and how), and
// flash_fwd_wide_tf32_kernel (fp32, 3xTF32), a block for each 64 query rows
// and all of their output columns, S once a key tile (the section "fp32,
// d > 128"). Any d and any batch is taken: the kernels here take b*h from
// grid.y, so a batch past 65535 (b, h) pairs runs in several launches of
// whole lists; the wide kernels fold every axis into grid.x.
//
// Short lists: flash_fwd_packed_mma_kernel (bf16, N <= 128, any d; entry
// flash_attn_fwd_packed) puts 64 / N lists of at most 64 docs, or one list of
// 65 .. 128 docs, in one key tile and computes S once a tile (the section
// "the packed kernel" below); flash_fwd_long_mma_kernel (entry
// flash_attn_fwd_long) one list of 129 .. 256 docs in a 256-key tile, S once
// in two halves of 128 keys (the section "the long kernel"). The package
// routes the bf16 forward at d > 128 to the first at N <= FWD_PACK_MAX_N and
// to the second at N <= LONG_MAX_N, in place of the wide kernel
// (ops/attention.py's fwd_route).
//
// fp32 inputs at d <= 128: flash_fwd_tf32_kernel, the bf16 kernel's layout
// with both products in TF32 parts on the tensor cores (each fp32 product as
// three TF32 products, P V as four: about fp32's accuracy, where TF32 alone
// keeps 3 digits; the section "fp32, head dims up to 128" below), the head
// dim padded to a multiple of 8. At (32, 2, 1408, 68) with statistics it
// takes 0.884..0.889 ms on an NVIDIA H100 80GB HBM3 at 700 W, against a
// bound of 0.209 (three TF32 products a product at 495 TFLOP/s), the
// CUDA-core kernel it replaced at 1.543 and SDPA's fp32 forward at 1.572
// (tools/kernel_variants.py; PERF.md keeps the runs). fp32 lists of at most
// 64 docs at d > 128 take flash_fwd_packed_tf32_kernel (entry flash_attn_fwd_packed, dtype 0; the
// route at N <= F32_PACK_MAX_N), the packed kernel's design with its two
// products in 3xTF32 on the tensor cores (the section "fp32, lists of at
// most 64 docs" below); fp32 lists of 65 .. 256 docs at d > 128 take
// flash_fwd_list_tf32_kernel (entries flash_attn_fwd_packed up to 128 docs
// and flash_attn_fwd_long, dtype 0; the routes at N <= F32_FWD_LIST_MAX_N
// and N <= F32_FWD_LONG_MAX_N), one list a 128- or 256-row tile, S once in
// 64-key slices, 3xTF32 (the section "fp32, lists of 65 .. 256 docs"); the
// fp32 wide kernel (3xTF32) the rest of d > 128: lists of more than 256 docs.

#include <cuda_runtime.h>
#include <algorithm>
#include <math.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

constexpr float M_INIT = -1e30f;  // below any logit, -1e9 included; finite, so m_old - m_new never is NaN

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

// ---------------------------------------------------------------------------
// fp32, head dims up to 128: 3xTF32
// ---------------------------------------------------------------------------
//
// flash_fwd_tf32_kernel: the bf16 forward's layout (flash_fwd_mma_kernel) in
// fp32, both products on the tensor cores in TF32 parts (mma_common.cuh's
// 3xTF32: about fp32's accuracy), the dq kernel of flash_attn_bwd.cu's fp32
// pair (flash_bwd_dq_tf32_kernel) with the dP product dropped and an online
// softmax and O += P V added. A block of F32N_WARPS warps owns F32N_OWN query
// rows, 16 a warp, and loops over the keys in tiles of F32N_TILE, K, V and
// the keys' flags double-buffered (cp.async; the next tile's flags
// prefetched into a register):
//   * S = Q K^T: each operand split into hi and lo at its fragment load as
//     CUTLASS's fast fp32 products split it (F32N_SPLIT), the warp's Q split
//     once into registers up to NC = F32N_QREG_NC (8 * NC of them a
//     thread), re-split from shared memory each tile above; the three TF32
//     products of F32N_GROUP k-steps summed in a fresh
//     fragment, then added to S in fp32;
//   * the online softmax on S's C fragment, in fp32 and natural-log units
//     with expf, as the other fp32 kernels compute it: a masked key's logit
//     is -1e9, a key past N is left out (p = 0); the running max from -1e30,
//     the row's tile max by two shuffles in its quad, O and the thread's
//     share of l rescaled by exp(m_old - m_new), l summed from the fp32 p;
//   * O += P V: P's C fragment is its own A fragment (c_as_a_tf32: k slots
//     renumbered), split in registers, so P never reaches shared memory; V is
//     the B operand in k-major order, split in three parts whose sum is
//     exact (frag_b_kn_tf32x3), four TF32 products a product: a list of one
//     real document gets its v exactly, as in fp32, so the backward's
//     dP - D cancels to 0 there as it does in the plain version (V in two
//     parts gives v to 2^-22, and the fp32 backward's gate at one doc a
//     list fails); O is 4 * NC fp32 accumulators a thread,
//     summed by the same fresh-fragment groups;
//   * O / l stored in fp32, and row_max, row_sum as the other fp32 kernels
//     write them, when their pointers are set.
// The head dim is padded to a multiple of 8, TF32's k-step (NC = 1 .. 16;
// 68 -> 72): tiles of rows of 8 * NC + 4 floats, whose fragment reads meet
// 32 distinct banks, with zero pad columns. The tiles are copied whole by
// 16-byte cp.async where d % 4 == 0 (load_tile_f32), else by narrower
// copies (chunk_copy_f32). No atomics: the same inputs give the same bits.
// What bounds it: the products, 4 * B*H*N^2*d operations, each taken as
// three TF32 products (0.209 ms at (32, 2, 1408, 68) at 495 TFLOP/s; P V
// takes a fourth), and the instructions that feed them: each operand's
// loads and split, the fp32 additions of the partial sums, the
// exponentials; the bytes, 4 * B*H*N*d * 4, are far below. It replaces a
// CUDA-core kernel (4x8 register blocks over transposed tiles copied
// synchronously, P through shared memory). On an NVIDIA H100 80GB HBM3 at
// 700 W (tools/kernel_variants.py, PERF.md): 0.884..0.889 ms at
// (32, 2, 1408, 68) with statistics (that kernel 1.543, SDPA's fp32 forward
// 1.572), 0.115 at (1, 2, 1536, 68), 0.051 at (1024, 2, 32, 68). P V takes
// 0.33 of it (0.558 without), its fourth product 0.10, the exponentials
// 0.06; Q re-split each tile took 6% longer, 64-key tiles 19% (spilling),
// three blocks an SM 3%.

// F32N: the fp32 forward of d <= 128 (narrow)
constexpr int F32N_WARPS = 4;              // warps a block
constexpr int F32N_NT = 32 * F32N_WARPS;   // threads a block
constexpr int F32N_OWN = 16 * F32N_WARPS;  // query rows a block owns, 16 a warp
constexpr int F32N_TILE = 32;              // keys a tile
// blocks an SM the registers are cut for (three blocks' 168 registers
// spilled at NC = 10, 11 and took 3% longer at d = 68, PERF.md)
constexpr int F32N_BLOCKS = 2;
// how the operands are split (mma_common.cuh: hi rounded to TF32, lo = x - hi
// cut to TF32 by the tensor cores, three instructions a value)
constexpr int F32N_SPLIT = SPLIT_INT_CUT;
// k-steps (8-deep) whose 3xTF32 products a fresh fragment sums before it is
// added to S or O in fp32
constexpr int F32N_GROUP = 4;
// the widest NC whose warp keeps Q's split in registers (8 * NC a thread);
// above, each key tile re-splits Q from shared memory
constexpr int F32N_QREG_NC = 9;

// the resident [F32N_OWN][8 * nc + 4] Q tile, two stages of K and V tiles of
// [F32N_TILE][8 * nc + 4] floats, and two stages of F32N_TILE key flags
__host__ __device__ constexpr size_t narrow_tf32_smem_bytes(int nc) {
    return (size_t(F32N_OWN) + size_t(4) * F32N_TILE) * (8 * nc + 4) * sizeof(float)
           + size_t(2) * F32N_TILE * sizeof(int);
}

// x = hi + lo + lo2 exactly, as the tensor cores read three TF32 operands
// (the top 19 bits of each register): hi is x cut to TF32, lo = x - hi cut
// likewise, lo2 what that cut leaves (at most two significant bits). Both
// differences are exact in fp32, and the three parts keep x's exponent, so
// a product by an exact 1 sums back to x itself.
__device__ __forceinline__ void split_tf32x3(float x, uint32_t& hi, uint32_t& lo, uint32_t& lo2) {
    hi = __float_as_uint(x);
    const float r = x - __uint_as_float(hi & 0xffffe000u);
    lo = __float_as_uint(r);
    lo2 = __float_as_uint(r - __uint_as_float(lo & 0xffffe000u));
}

// frag_b_kn_tf32's B fragment of V (columns n0 .. n0 + 7; k = rows k0 + 2t
// and k0 + 2t + 1 in slots t and t+4) in three parts (split_tf32x3)
template <int LD>
__device__ __forceinline__ void frag_b_kn_tf32x3(uint32_t (&hi)[2], uint32_t (&lo)[2],
                                                 uint32_t (&lo2)[2], const float* tile, int k0,
                                                 int n0, int lane) {
    const float* p = tile + (k0 + 2 * (lane & 3)) * LD + n0 + (lane >> 2);
    split_tf32x3(p[0], hi[0], lo[0], lo2[0]);
    split_tf32x3(p[LD], hi[1], lo[1], lo2[1]);
}

// The online softmax on S's fragment (rows: the thread's two query rows g and
// g + 8 of the warp's 16; 8-key tiles j; kf points at the flag of the
// thread's first key): the logits (a masked key: -1e9; a key past N: -inf),
// the running max m[h], the O accumulators and this thread's share l[h] of
// the running sum rescaled by exp(m_old - m_new), and p = exp(x - m) in place
// of S, l summed from the fp32 p. The tile's first key is < N, so m is finite.
template <int NJ, int NC>
__device__ __forceinline__ void online_softmax_f32(float (&s)[NJ][4], const int* kf, float (&m)[2],
                                                   float (&l)[2], float (&acc)[NC][4],
                                                   float scale) {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
        const int2 f2 = *reinterpret_cast<const int2*>(kf + 8 * j);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int f = (e & 1) ? f2.y : f2.x;
            const float x = f == KEY_REAL ? s[j][e] * scale
                            : (f == KEY_MASKED ? MASKED_LOGIT : -INFINITY);
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
        alpha[h] = expf(m[h] - m_new);
        m[h] = m_new;
        l[h] *= alpha[h];
    }
#pragma unroll
    for (int n = 0; n < NC; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float p = expf(s[j][e] - m[e >> 1]);  // 0 past N
            s[j][e] = p;
            l[e >> 1] += p;
        }
}

// acc[n] (16 x 8: output columns 8n .. 8n + 7) += P V, where P is the
// 16 x 8*NJ matrix whose C fragments are p[j] (its k = the tile's keys
// 8j .. 8j + 7: c_as_a_tf32, all split first) and V the rows 0 .. 8*NJ - 1 of
// the [*][LD] tile in three parts (frag_b_kn_tf32x3): P_lo V_hi + P_hi V_lo2
// + P_hi V_lo + P_hi V_hi, four TF32 products, so that a row whose p is 1 on
// one key and 0 on the others (a list of one real document) gets that key's
// v exactly, as in fp32; each F32N_GROUP k-steps summed in a fresh fragment,
// then added
template <int LD, int NJ, int NC>
__device__ __forceinline__ void product_pv_tf32(float (&acc)[NC][4], const float (&p)[NJ][4],
                                                const float* tile, int lane) {
    uint32_t ahi[NJ][4], alo[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) c_as_a_tf32<F32N_SPLIT>(ahi[j], alo[j], p[j]);
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int g = 0; g < NJ; g += F32N_GROUP) {
            float tc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int j = g; j < (g + F32N_GROUP < NJ ? g + F32N_GROUP : NJ); ++j) {
                uint32_t bhi[2], blo[2], blo2[2];
                frag_b_kn_tf32x3<LD>(bhi, blo, blo2, tile, 8 * j, 8 * n, lane);
                mma_1688_tf32(tc, alo[j], bhi[0], bhi[1]);
                mma_1688_tf32(tc, ahi[j], blo2[0], blo2[1]);
                mma_1688_tf32(tc, ahi[j], blo[0], blo[1]);
                mma_1688_tf32(tc, ahi[j], bhi[0], bhi[1]);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[n][e] += tc[e];
        }
}

template <int NC>
__global__ void __launch_bounds__(F32N_NT, F32N_BLOCKS)
flash_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const uint8_t* __restrict__ mask,
                      float* __restrict__ o, float* __restrict__ row_max,
                      float* __restrict__ row_sum, int H, int N, int d, float scale, int copy,
                      int how) {
    constexpr int LD = 8 * NC + 4;
    constexpr int TS = F32N_TILE * LD;  // a K or V tile
    constexpr int NJ = F32N_TILE / 8;   // 8-key tiles of S
    constexpr bool QREG = NC <= F32N_QREG_NC;
    constexpr int QN = QREG ? NC : 1;
    extern __shared__ uint4 smem_mma[];
    float* Qs = reinterpret_cast<float*>(smem_mma);  // the block's query rows
    float* Ks = Qs + F32N_OWN * LD;                  // two buffers each
    float* Vs = Ks + 2 * TS;
    int* kflag = reinterpret_cast<int*>(Vs + 2 * TS);  // [2][F32N_TILE]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    const int bh = blockIdx.y;
    const int b = bh / H;
    const int q0 = blockIdx.x * F32N_OWN;
    const size_t base = size_t(bh) * N * d;
    const int qrows = min(F32N_OWN, N - q0);
    const uint8_t* mask_row = mask + size_t(b) * N;
    const uint32_t magic = copy_magic(d);

    zero_pad_columns<F32N_NT, LD>(Qs, F32N_OWN + 4 * F32N_TILE, d);
    load_tile_f32<F32N_NT, LD, F32N_OWN>(Qs, q + base + size_t(q0) * d, qrows, d, copy, magic);
    load_tile_f32<F32N_NT, LD, F32N_TILE>(Ks, k + base, min(F32N_TILE, N), d, copy, magic);
    load_tile_f32<F32N_NT, LD, F32N_TILE>(Vs, v + base, min(F32N_TILE, N), d, copy, magic);
    cp_async_commit();
    if (tid < F32N_TILE) kflag[tid] = key_flag(mask_row, tid, N);

    float acc[NC][4];
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    // of the thread's two query rows: the running max and the thread's share
    // of the running sum
    float m[2] = {M_INIT, M_INIT}, l[2] = {0.f, 0.f};

    cp_async_wait_all();
    __syncthreads();
    uint32_t qhi[QN][4], qlo[QN][4];  // the warp's Q rows, split once (QREG)
    if constexpr (QREG) {
#pragma unroll
        for (int ks = 0; ks < NC; ++ks)
            frag_a_tf32<LD, F32N_SPLIT>(qhi[ks], qlo[ks], Qs, warp * 16, 8 * ks, lane);
    }

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
        const float* Kt = Ks + buf * TS;
        const float* Vt = Vs + buf * TS;

        // S = Q K^T: the warp's 16 query rows by the tile's keys
        float s[NJ][4];
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
        for (int g0 = 0; g0 < NC; g0 += F32N_GROUP) {
            float ts[NJ][4];
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) ts[j][e] = 0.f;
#pragma unroll
            for (int ks = g0; ks < (g0 + F32N_GROUP < NC ? g0 + F32N_GROUP : NC); ++ks) {
                uint32_t ahi[4], alo[4], bhi[2], blo[2];
                if constexpr (QREG) {
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        ahi[i] = qhi[ks][i];
                        alo[i] = qlo[ks][i];
                    }
                } else {
                    frag_a_tf32<LD, F32N_SPLIT>(ahi, alo, Qs, warp * 16, 8 * ks, lane);
                }
#pragma unroll
                for (int j = 0; j < NJ; ++j) {
                    frag_b_nk_tf32<LD, F32N_SPLIT>(bhi, blo, Kt, 8 * j, 8 * ks, lane);
                    mma_3xtf32_into(ts[j], ahi, alo, bhi, blo);
                }
            }
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[j][e] += ts[j][e];
        }

        online_softmax_f32<NJ, NC>(s, kflag + buf * F32N_TILE + 2 * t4, m, l, acc, scale);
        product_pv_tf32<LD, NJ, NC>(acc, s, Vt, lane);  // O += P V

        if (more && tid < F32N_TILE) kflag[(buf ^ 1) * F32N_TILE + tid] = next_flag;
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
        const float inv = 1.f / sum;  // sum >= 1: the row max contributes exp(0)
        float* orow = o + base + size_t(q0 + r) * d;
#pragma unroll
        for (int n = 0; n < NC; ++n)
            store_pair_f32(orow, 8 * n + 2 * t4, acc[n][2 * h] * inv, acc[n][2 * h + 1] * inv, d,
                           pairs);
        if (row_max != nullptr && t4 == 0) {  // the quad holds the same m and sum
            const size_t at = size_t(bh) * N + q0 + r;
            row_max[at] = m[h];
            row_sum[at] = sum;
        }
    }
}

template <int NC>
cudaError_t launch_tf32(const void* q, const void* k, const void* v, const void* mask, void* o,
                        float* row_max, float* row_sum, int B, int H, int N, int d,
                        cudaStream_t stream) {
    const auto kernel = flash_fwd_tf32_kernel<NC>;
    const size_t bytes = narrow_tf32_smem_bytes(NC);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           int(bytes));
    if (err != cudaSuccess) return err;
    // 16-byte copies need d % 4 == 0 on 16-byte-aligned tensors (chunk_copy_f32);
    // 8-byte stores of two floats need even rows on an 8-byte-aligned output
    const int copy = chunk_copy_f32(d, std::min({alignment(q), alignment(k), alignment(v)}));
    const int how = d % 2 == 0 && aligned(o, 8) ? STORE_PAIRS : 0;
    const dim3 grid((N + F32N_OWN - 1) / F32N_OWN, B * H);
    kernel<<<grid, F32N_NT, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const uint8_t*>(mask), static_cast<float*>(o), row_max, row_sum, H, N, d,
        1.0f / sqrtf(float(d)), copy, how);
    return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// d > 128: the bf16 wide kernel
// ---------------------------------------------------------------------------
//
// The kernels above keep every column of a row at hand (the bf16 one holds
// the warp's Q in registers, KC fragments, and both keep d-wide tiles in
// shared memory), so their resources grow with d: at d = 384 the bf16 one
// would need 251,392 bytes of shared memory (the H100 allows 232,448). The
// bf16 wide kernel splits the OUTPUT's head dim over the grid instead: a
// block owns 64 query rows and one chunk of output columns, and streams the
// contraction of S = Q K^T over d in 64-column chunks staged in shared
// memory, so nothing of it grows with d. Every chunk-block of a row tile
// computes S, the running max and the running sum in the same order with the
// same instructions, so their normalisations agree bit for bit; the block of
// chunk 0 alone writes the row statistics. No atomics. The price is that Q
// and K are read once per output chunk (ceil(d / chunk) times) and S
// computed as often. grid.x folds (b*h, output chunk, 64-row tile)
// (mma_common.cuh's fold_wide).
//
// What bounds it: at the Yahoo! LTR listsf's shapes (N = 128) attention
// does N/2 = 64 operations a byte, below the H100's ~295 bf16 ridge, so the
// bytes do: 0.055 ms at (256, 2, 128, 350) bf16. What holds it
// (ptranking_tpu_torch/tools/kernel_variants.py on an NVIDIA H100 80GB HBM3
// at 700 W; PERF.md keeps the runs): its chunk copies, 0.53..0.54 ms at
// d = 350, whose 700-byte rows allow only 4-byte copies, against
// 0.23 ms at d = 384 (16-byte copies); 64-column output chunks (twice the
// re-reads) take 0.94 / 0.39 ms.

constexpr int DCH = 64;  // columns of a d-chunk of the S product
constexpr int WIDE_CW = 8;  // 16-column steps of the bf16 kernel's output chunk: 128 columns

// bf16: two stages of (Q d-chunk [OWN][72], K d-chunk [TILE][72]), two V
// tiles of the output chunk [TILE][16*CW + 8], two tiles' key flags
__host__ __device__ constexpr size_t wide_mma_smem_bytes(int cw) {
    return (size_t(2) * (OWN + TILE) * (16 * (DCH / 16) + 8) + size_t(2) * TILE * (16 * cw + 8))
               * sizeof(bf16) + size_t(2) * TILE * 4;
}

// The bf16 wide kernel: flash_fwd_mma_kernel's warps, fragments, online
// softmax and P V product, with S accumulated over d-chunks. Its stages are
// (key tile t, d-chunk c) in order; stage s + 1's copies are in flight while
// stage s is multiplied (double-buffered cp.async 16, 8 or 4 bytes wide as d
// and alignment allow, or synchronous for odd d). The first stage of a tile also brings the tile's V
// columns of the output chunk and its key flags, into the buffer of the
// tile's parity.
template <int CW>
__global__ void __launch_bounds__(MMA_NT, 2)
flash_fwd_wide_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                          bf16* __restrict__ o, float* __restrict__ row_max,
                          float* __restrict__ row_sum, int H, int N, int d, float scale2,
                          int copy, int how) {
    constexpr int KS = DCH / 16;        // 16-deep steps of a d-chunk
    constexpr int LDC = 16 * KS + 8;    // row stride of the d-chunk tiles
    constexpr int LDV = 16 * CW + 8;    // row stride of the V tiles
    constexpr int STAGE = (OWN + TILE) * LDC;
    extern __shared__ uint4 smem_mma[];
    bf16* QK = reinterpret_cast<bf16*>(smem_mma);  // [2][Q chunk; K chunk]
    bf16* Vs = QK + 2 * STAGE;                     // [2][TILE][LDV]
    int* kflag = reinterpret_cast<int*>(Vs + 2 * TILE * LDV);  // [2][TILE]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    int oc, bh;
    const int q0 = fold_wide(N, d, 16 * CW, oc, bh);
    const int c0 = oc * 16 * CW;
    const int b = bh / H;
    const size_t base = size_t(bh) * N * d;
    const int qrows = min(OWN, N - q0);
    const uint8_t* mask_row = mask + size_t(b) * N;
    const int chunks = (d + DCH - 1) / DCH;
    const int tiles = (N + TILE - 1) / TILE;
    const int stages = tiles * chunks;

    auto prefetch = [&](int st) {
        const int t = st / chunks, c = st - t * chunks;
        const int k0 = t * TILE, krows = min(TILE, N - k0);
        bf16* qs = QK + (st & 1) * STAGE;
        load_chunk<MMA_NT, KS, OWN>(qs, q + base + size_t(q0) * d, qrows, d, c * DCH, copy);
        load_chunk<MMA_NT, KS, TILE>(qs + OWN * LDC, k + base + size_t(k0) * d, krows, d,
                                     c * DCH, copy);
        if (c == 0) {
            load_chunk<MMA_NT, CW, TILE>(Vs + (t & 1) * TILE * LDV, v + base + size_t(k0) * d,
                                         krows, d, c0, copy);
            if (tid < TILE) kflag[(t & 1) * TILE + tid] = key_flag(mask_row, k0 + tid, N);
        }
        cp_async_commit();
    };

    float acc[2 * CW][4];
#pragma unroll
    for (int j = 0; j < 2 * CW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    float m[2] = {M_INIT, M_INIT}, l[2] = {0.f, 0.f};
    float s[TILE / 8][4];

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
                for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
        }
        const bf16* qs = QK + (st & 1) * STAGE;
        uint32_t a[KS][4];
        load_a<KS>(a, qs, warp * 16, lane);
        product_nk<KS, TILE / 8>(s, a, qs + OWN * LDC, 0, lane);
        if (c == chunks - 1) {
            uint32_t pa[TILE / 16][4];
            online_softmax<TILE / 8>(pa, s, kflag + (t & 1) * TILE + 2 * t4, m, l, acc, scale2);
            product_kn<CW, TILE / 16>(acc, pa, Vs + (t & 1) * TILE * LDV, 0, lane);  // O += P V
        }
        __syncthreads();  // no warp reads stage st's buffers any more
    }

    const bool pairs = how & STORE_PAIRS;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        float sum = l[h];
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const int r = warp * 16 + g + 8 * h;
        if (r >= qrows) continue;
        const float inv = 1.f / sum;
        bf16* orow = o + base + size_t(q0 + r) * d;
#pragma unroll
        for (int j = 0; j < 2 * CW; ++j)
            store_pair(orow, c0 + 8 * j + 2 * t4, acc[j][2 * h] * inv, acc[j][2 * h + 1] * inv, d,
                       pairs);
        if (row_max != nullptr && t4 == 0 && oc == 0) {
            const size_t at = size_t(bh) * N + q0 + r;
            row_max[at] = m[h] == MASKED_LOGIT2 ? MASKED_LOGIT : m[h] * LN2;
            row_sum[at] = sum;
        }
    }
}

cudaError_t launch_wide_mma(const void* q, const void* k, const void* v, const void* mask,
                            void* o, float* row_max, float* row_sum, int B, int H, int N, int d,
                            cudaStream_t stream) {
    const size_t bytes = wide_mma_smem_bytes(WIDE_CW);
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_wide_mma_kernel<WIDE_CW>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
    if (err != cudaSuccess) return err;
    const int copy = chunk_copy(d, std::min({alignment(q), alignment(k), alignment(v)}));
    const int how = d % 2 == 0 && aligned(o, 4) ? STORE_PAIRS : 0;
    const dim3 grid(unsigned(wide_blocks(B, H, N, d, 16 * WIDE_CW)));
    flash_fwd_wide_mma_kernel<WIDE_CW><<<grid, MMA_NT, bytes, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const uint8_t*>(mask), static_cast<bf16*>(o), row_max, row_sum, H, N, d,
        LOG2E / sqrtf(float(d)), copy, how);
    return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32, d > 128: the wide kernel on 3xTF32
// ---------------------------------------------------------------------------
//
// flash_fwd_wide_tf32_kernel takes every fp32 call at d > 128 that the
// packed and list kernels below do not (lists of more than 256 docs; any N
// through this entry). It replaces a CUDA-core kernel that split the output
// into 64-column chunks over the grid and computed S once per chunk (6 times
// at d = 350, 3 at d = 136): 4.46 ms at (32, 1, 1408, 136) on an NVIDIA H100
// 80GB HBM3 at 700 W, against SDPA's fp32 forward at 1.31 (PERF.md). Here a
// block of F32W_WARPS warps owns F32W_OWN query rows of one (b, h), 16 a
// warp, and ALL of their output columns, and loops over the keys in tiles of
// F32W_TILE, as flash_fwd_tf32_kernel does at d <= 128, with the steps of
// the fp32 list kernel (flash_fwd_list_tf32_kernel) inside a tile:
//   1. S = Q K^T of the warp's 16 rows by the tile's 64 keys (32 fp32
//      registers a thread) over d in W-column chunks of Q and of the tile's
//      K, double-buffered by cp.async (load_rows_f32), every product in
//      3xTF32 with the d <= 128 kernel's split (F32N_SPLIT), a chunk's four
//      k-steps summed in a fresh fragment and then added to S;
//   2. the online softmax on S's C fragment, as flash_fwd_tf32_kernel's
//      (a masked key's logit -1e9, a key past N left out, the running max
//      from -1e30, O and the thread's share of l rescaled by
//      exp(m_old - m_new)), P split once into TF32 parts in registers;
//   3. for each W-column output chunk of the tile's V, O = O exp(m_old -
//      m_new) + P V with V in three parts, four TF32 products a product
//      (frag_b_kn_tf32x3: a list of one real document gets its v exactly,
//      which the fp32 backward's gate needs), four k-steps a fresh fragment.
// The output's C fragments stay in shared memory, each thread's own float4
// slots ([column tile][thread]: no barrier guards them), where at d = 350 the
// 4 * 44 registers a thread of O would not fit beside S and P. S and P are
// computed once per (query tile, key tile) for every output column: where
// d's columns do not fit one block's shared memory beside the stages (past
// d = 752, wide_tf32_group), the block runs its output groups in turn and
// computes S again for each, with the same instructions, so every group's
// normalisation is the same bits. The group of column 0 writes row_max and
// row_sum as the other fp32 kernels write them; an all-padded list gets
// m = -1e9, l = N. grid.x folds (b*h, 64-row tile) (fold_wide with one
// output chunk), so any batch is one launch. No atomics: the same inputs
// give the same bits.
// What bounds it: the products, 4 * B*H*N^2*d operations, three TF32
// products each (P V four), 0.209 ms at (32, 1, 1408, 136) at 495 TFLOP/s;
// the bytes (Q and K re-read once a key tile, mostly from L2) far below;
// before either, the instructions that feed the tensor cores: each
// operand's loads and split, the fp32 additions of the fresh fragments, the
// exponentials, and the accumulator's shared-memory round trip a chunk. On
// an NVIDIA H100 80GB HBM3 at 700 W (tools/kernel_variants.py, PERF.md):
// 0.944 ms at (32, 1, 1408, 136) with statistics, 4.5x its bound (SDPA's
// fp32 forward 1.31), three blocks an SM (two: 1.056); it loses to SDPA at
// d = 350 and 384, 512 docs (one block an SM), and on one list of 1536 docs
// (0.32 against 0.21: 24 blocks on 132 SMs).

// columns of the fp32 wide kernel's d-chunks and output chunks (16 took
// 7..24% longer at d = 136; at d = 350 they fit a second block an SM and
// saved 22%, a width no model sends past 256 docs; PERF.md); blocks an SM
// the registers are cut for (three: 11% less time than two at
// (32, 1, 1408, 136), where three fit the shared memory)
constexpr int F32W_CW = 32;
constexpr int F32W_BLOCKS = 3;

template <int W>
__global__ void __launch_bounds__(F32W_NT, F32W_BLOCKS)
flash_fwd_wide_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const uint8_t* __restrict__ mask,
                           float* __restrict__ o, float* __restrict__ row_max,
                           float* __restrict__ row_sum, int H, int N, int d, float scale, int copy,
                           int how, int cg) {
    constexpr int NT = F32W_NT, LD = W + 4;
    constexpr int STAGE = (F32W_OWN + F32W_TILE) * LD;  // a Q chunk and a K chunk, or a V chunk
    constexpr int NJ = F32W_TILE / 8;                     // 8-key tiles of S
    constexpr int CT = W / 8;                             // 8-column tiles of an output chunk
    static_assert(W % 8 == 0, "chunks of 8-deep steps");
    extern __shared__ uint4 smem_mma[];
    float4* acc = reinterpret_cast<float4*>(smem_mma);       // [cg / 8][NT]: O's C fragments
    float* Cs = reinterpret_cast<float*>(acc + (cg / 8) * NT);  // [2][STAGE]
    int* kflag = reinterpret_cast<int*>(Cs + 2 * STAGE);      // [2][F32W_TILE]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    int oc_unused, bh;
    const int q0 = fold_wide(N, d, d, oc_unused, bh);
    const int b = bh / H;
    const size_t base = size_t(bh) * N * d;
    const int qrows = min(F32W_OWN, N - q0);
    const uint8_t* mask_row = mask + size_t(b) * N;
    const float* qb = q + base + size_t(q0) * d;
    const float* kb = k + base;
    const float* vb = v + base;
    const WideStages sg{1, (d + W - 1) / W, (N + F32W_TILE - 1) / F32W_TILE, d, cg, W};
    const int stages = sg.total();

    // stage st: S's d-chunk c of Q and of the key tile t's K (the first also
    // brings the tile's key flags), or an output chunk of the tile's V
    auto prefetch = [&](int st) {
        int gi, t, c;
        sg.decode(st, gi, t, c);
        const int k0 = t * F32W_TILE, krows = min(F32W_TILE, N - k0);
        float* cs = Cs + (st & 1) * STAGE;
        if (c < sg.chunks) {
            load_rows_f32<NT, W, F32W_OWN>(cs, qb, qrows, d, c * W, copy);
            load_rows_f32<NT, W, F32W_TILE>(cs + F32W_OWN * LD, kb + size_t(k0) * d, krows, d,
                                            c * W, copy);
            if (c == 0 && tid < F32W_TILE)  // the buffer of the tile's parity over all groups
                kflag[((gi * sg.tiles + t) & 1) * F32W_TILE + tid] =
                    key_flag(mask_row, k0 + tid, N);
        } else {
            load_rows_f32<NT, W, F32W_TILE>(cs, vb + size_t(k0) * d, krows, d,
                                            gi * cg + (c - sg.chunks) * W, copy);
        }
        cp_async_commit();
    };
    int st = 0;
    // stage st's buffers, landed, with stage st + 1's copies in flight
    auto next = [&]() -> const float* {
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
        const int c0 = gi * cg, ntiles = (min(cg, d - c0) + 7) / 8;  // its 8-column output tiles
        const int och = sg.out_chunks(gi);
        for (int n = 0; n < ntiles; ++n) acc[n * NT + tid] = make_float4(0.f, 0.f, 0.f, 0.f);
        // of the thread's two query rows: the running max and the thread's
        // share of the running sum
        float m[2] = {M_INIT, M_INIT}, l[2] = {0.f, 0.f};

        for (int t = 0; t < sg.tiles; ++t, ++tt) {
            // step 1: S = Q K^T, the warp's 16 query rows by the tile's keys
            float s[NJ][4];
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
            for (int c = 0; c < sg.chunks; ++c, ++st) {
                const float* cs = next();
                chunk_product_tf32<W, NJ, F32N_SPLIT>(s, cs, cs + F32W_OWN * LD, warp * 16,
                                                      c * W, d, lane);
                __syncthreads();  // no warp reads stage st's buffers any more
            }

            // step 2: the online softmax; P split into its TF32 parts
            const int* kf = kflag + (tt & 1) * F32W_TILE + 2 * t4;
            float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const int2 f2 = *reinterpret_cast<const int2*>(kf + 8 * j);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int f = (e & 1) ? f2.y : f2.x;
                    const float x = f == KEY_REAL ? s[j][e] * scale
                                    : (f == KEY_MASKED ? MASKED_LOGIT : -INFINITY);
                    s[j][e] = x;
                    mx[e >> 1] = fmaxf(mx[e >> 1], x);
                }
            }
            float alpha[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
                mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
                const float m_new = fmaxf(m[h], mx[h]);  // the tile's first key is < N: finite
                alpha[h] = expf(m[h] - m_new);
                m[h] = m_new;
                l[h] *= alpha[h];
            }
            uint32_t phi[NJ][4], plo[NJ][4];
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float p = expf(s[j][e] - m[e >> 1]);  // 0 past N
                    s[j][e] = p;
                    l[e >> 1] += p;
                }
                c_as_a_tf32<F32N_SPLIT>(phi[j], plo[j], s[j]);
            }

            // step 3: O = O alpha + P V, an output chunk a stage
            for (int oc = 0; oc < och; ++oc, ++st) {
                const float* vs = next();
#pragma unroll
                for (int n = 0; n < CT; ++n) {
                    const int nt = oc * CT + n;  // the group's output tile
                    if (nt < ntiles) {
                        float4 a = acc[nt * NT + tid];
                        a.x *= alpha[0];
                        a.y *= alpha[0];
                        a.z *= alpha[1];
                        a.w *= alpha[1];
#pragma unroll
                        for (int j0 = 0; j0 < NJ; j0 += F32N_GROUP) {
                            float tc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
                            for (int j = j0; j < j0 + F32N_GROUP; ++j) {
                                uint32_t bhi[2], blo[2], blo2[2];
                                frag_b_kn_tf32x3<LD>(bhi, blo, blo2, vs, 8 * j, 8 * n, lane);
                                mma_1688_tf32(tc, plo[j], bhi[0], bhi[1]);
                                mma_1688_tf32(tc, phi[j], blo2[0], blo2[1]);
                                mma_1688_tf32(tc, phi[j], blo[0], blo[1]);
                                mma_1688_tf32(tc, phi[j], bhi[0], bhi[1]);
                            }
                            a.x += tc[0];
                            a.y += tc[1];
                            a.z += tc[2];
                            a.w += tc[3];
                        }
                        acc[nt * NT + tid] = a;
                    }
                }
                __syncthreads();  // no warp reads stage st's buffer any more
            }
        }

        // O / l of the group's columns; the row statistics once
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            float sum = l[h];  // the quad's four shares
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            sum += __shfl_xor_sync(0xffffffffu, sum, 2);
            const int r = warp * 16 + g + 8 * h;
            if (r >= qrows) continue;
            const float inv = 1.f / sum;  // sum >= 1: the row max contributes exp(0)
            float* orow = o + base + size_t(q0 + r) * d;
            for (int n = 0; n < ntiles; ++n) {
                const float4 a = acc[n * NT + tid];
                store_pair_f32(orow, c0 + 8 * n + 2 * t4, (h ? a.z : a.x) * inv,
                               (h ? a.w : a.y) * inv, d, pairs);
            }
            if (gi == 0 && row_max != nullptr && t4 == 0) {  // the quad holds the same m and sum
                const size_t at = size_t(bh) * N + q0 + r;
                row_max[at] = m[h];
                row_sum[at] = sum;
            }
        }
    }
}

// one block per (b, h) and 64 query rows, on grid.x
cudaError_t launch_wide_tf32(const void* q, const void* k, const void* v, const void* mask,
                             void* o, float* row_max, float* row_sum, int B, int H, int N, int d,
                             cudaStream_t stream) {
    const auto kernel = flash_fwd_wide_tf32_kernel<F32W_CW>;
    const int cg = wide_tf32_group(d, 1, F32W_CW);  // one accumulator: O
    const size_t bytes = wide_tf32_smem_bytes(cg, 1, F32W_CW);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           int(bytes));
    if (err != cudaSuccess) return err;
    const int copy = chunk_copy_f32(d, std::min({alignment(q), alignment(k), alignment(v)}));
    const int how = d % 2 == 0 && aligned(o, 8) ? STORE_PAIRS : 0;
    const dim3 grid(unsigned(wide_blocks(B, H, N, d, d)));
    kernel<<<grid, F32W_NT, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const uint8_t*>(mask), static_cast<float*>(o), row_max, row_sum, H, N, d,
        1.0f / sqrtf(float(d)), copy, how, cg);
    return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16, short lists: the packed kernel
// ---------------------------------------------------------------------------
//
// At N <= 64 a wide block fills N of its 64 rows, and each of its output
// chunks streams the whole of S = Q K^T over d again (3 chunks at d = 350
// and 384). Here, as in flash_attn_bwd.cu's packed backward, KEYS / N
// consecutive (b, h) lists share one key tile: q, k and v are [B*H*N, d]
// row-major, so tile t is the contiguous span of rows t*p*N .. t*p*N + p*N - 1
// with p = KEYS / N (fewer in the last tile when B*H % p != 0; rows past p*N
// stay empty). A list attends only to itself, so the tile is closed under
// attention. KEYS = 64 takes lists of at most 64 docs, one block a tile;
// KEYS = 128 one list of 65 .. 128 docs a tile, with a block for each 64
// query rows of it. A block of 4 warps owns 64 query rows, 16 a warp:
//   1. S = Q K^T (the warp's 16 rows by all KEYS keys, fp32) computed once,
//      over d in 64-column chunks double-buffered through shared memory as
//      the wide kernel streams them;
//   2. the softmax on the fragment: every key of the row's list lies in the
//      tile, so it takes one max and one sum, no online rescale. A key of
//      ANOTHER list of the tile is left out (P = 0), not masked: the
//      unpacked kernels' rules hold within the list, so a list with no real
//      key gets m = -1e9, l = N and the mean of its own v (as
//      flash_fwd_mma_kernel gives it). P is rounded to bf16 in registers as
//      the A operand: the warp's 16 rows hold all KEYS keys, so P never
//      reaches shared memory;
//   3. for each output chunk of 16*CW columns, O = P V with V's chunk
//      streamed through the same double buffer; O / l rounded once at the
//      store, row_max and row_sum (when asked) in natural-log units as the
//      other kernels write them.
// Q and K are read once a block and V once (KEYS = 128: K and V once for
// each of the list's two query blocks, the second mostly from L2), and O is
// written once. What bounds it: bytes; the products, those on the zeros of
// other lists included, are 4 * 64 * KEYS * d operations a block, far below
// the tensor cores' ridge. A row of d = 350 is 700 bytes, so its chunk
// copies are 4 bytes wide (tools/kernel_variants.py times d = 352, the same
// work with 16-byte copies). On an NVIDIA H100 80GB HBM3 at 700 W (PERF.md):
// 0.119 ms with statistics at (2048, 2, 16, 350), and at 32 and 64 docs,
// against a byte bound of 0.055 ms and the wide kernel's 0.86; 0.20 ms at
// (256, 2, 128, 350) (128 keys) against 0.53; 0.092 / 0.108 ms at d = 384.

constexpr int PACK_KEYS = OWN;  // keys of the packed tile for lists of at most 64 docs
constexpr int LIST_KEYS = 2 * OWN;  // keys of the tile of one list of 65 .. 128 docs
constexpr int PACK_CW = 4;  // 16-column steps of the packed kernel's output chunk: 64 columns

// two stages (step 1's Q and K d-chunks, or step 3's V chunk) and the key info
__host__ __device__ constexpr size_t packed_stage_elems(int keys, int cw) {
    return size_t(OWN + keys) * (DCH + 8) > size_t(keys) * (16 * cw + 8)
               ? size_t(OWN + keys) * (DCH + 8) : size_t(keys) * (16 * cw + 8);
}
__host__ __device__ constexpr size_t packed_smem_bytes(int keys, int cw) {
    return 2 * packed_stage_elems(keys, cw) * sizeof(bf16) + size_t(keys) * sizeof(int);
}

// The packed kernel's softmax on the fragment of S (rows = the thread's two
// query rows with their list in the tile; 8-column tiles j = keys): ki points
// at the key info of the thread's first key, its list in the tile << 2 | its
// flag (key_flag), or -1 past the tile's rows; a row past them has list -2.
// A real key of the row's own list: the logit in log2 units; a masked one:
// the constant; a key of another list: -inf (p = 0). m (log2 units, from
// M_INIT as the online softmax starts) and the thread's share l of the row's
// sum; P = 2^(x - m) packed as the A operand of O = P V.
template <int NTILES>
__device__ __forceinline__ void softmax_packed(uint32_t (&pa)[NTILES / 2][4],
                                               float (&s)[NTILES][4], const int* ki,
                                               const int (&seg)[2], float (&m)[2], float (&l)[2],
                                               float scale2) {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NTILES; ++j) {
        const int2 f2 = *reinterpret_cast<const int2*>(ki + 8 * j);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int f = (e & 1) ? f2.y : f2.x, h = e >> 1;
            const bool same = (f >> 2) == seg[h];
            const float x = !same ? -INFINITY
                            : (f & 3) == KEY_REAL ? s[j][e] * scale2 : MASKED_LOGIT2;
            s[j][e] = x;
            mx[h] = fmaxf(mx[h], x);
        }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        m[h] = fmaxf(M_INIT, mx[h]);  // M_INIT on a row past the tile's: every p is 0
        l[h] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < NTILES; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const float p0 = ex2(s[j][2 * h] - m[h]);  // 0 on another list's key
            const float p1 = ex2(s[j][2 * h + 1] - m[h]);
            l[h] += p0 + p1;  // fp32 p, before rounding
            pa[j >> 1][(j & 1) * 2 + h] = pack_bf16(p0, p1);
        }
}

template <int KEYS, int CW>
__global__ void __launch_bounds__(MMA_NT, KEYS == PACK_KEYS ? 4 : 2)
flash_fwd_packed_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                            bf16* __restrict__ o, float* __restrict__ row_max,
                            float* __restrict__ row_sum, int lists, int H, int N, int d,
                            float scale2, int copy, int how) {
    constexpr int KS = DCH / 16;          // 16-deep steps of a d-chunk
    constexpr int LDC = 16 * KS + 8;      // row stride of the d-chunk tiles
    constexpr int QCHUNK = OWN * LDC;     // a Q d-chunk; the K d-chunk follows it
    constexpr int STAGE = int(packed_stage_elems(KEYS, CW));
    constexpr int QBLOCKS = KEYS / OWN;   // blocks of a key tile: one for each 64 query rows
    extern __shared__ uint4 smem_mma[];
    bf16* Cs = reinterpret_cast<bf16*>(smem_mma);         // [2][STAGE]
    int* kinfo = reinterpret_cast<int*>(Cs + 2 * STAGE);  // [KEYS]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    const int per_tile = KEYS / N;
    const int tile = blockIdx.x / QBLOCKS;
    const int l0 = tile * per_tile;                      // the tile's first (b, h) list
    const int nkeys = min(per_tile, lists - l0) * N;     // the tile's rows
    const int qoff = (blockIdx.x - tile * QBLOCKS) * OWN;  // the block's first query row in it
    const int nq = min(OWN, nkeys - qoff);
    if (nq <= 0) return;  // a query block past a short tile's rows (not at 65 <= N <= 128)
    const size_t row0 = size_t(l0) * N;
    const bf16* qb = q + (row0 + qoff) * d;
    const bf16* kb = k + row0 * d;
    const bf16* vb = v + row0 * d;
    const int chunks = (d + DCH - 1) / DCH;
    const int out_chunks = (d + 16 * CW - 1) / (16 * CW);
    const int stages = chunks + out_chunks;

    // stage st < chunks: step 1's d-chunk st of Q and K; st >= chunks: step
    // 3's output chunk st - chunks of V
    auto prefetch = [&](int st) {
        bf16* cs = Cs + (st & 1) * STAGE;
        if (st < chunks) {
            load_chunk<MMA_NT, KS, OWN>(cs, qb, nq, d, st * DCH, copy);
            load_chunk<MMA_NT, KS, KEYS>(cs + QCHUNK, kb, nkeys, d, st * DCH, copy);
        } else {
            load_chunk<MMA_NT, CW, KEYS>(cs, vb, nkeys, d, (st - chunks) * 16 * CW, copy);
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
    for (int j = tid; j < KEYS; j += MMA_NT) {
        int info = -1;
        if (j < nkeys) {
            const int list = j / N, key = j - list * N;
            info = list << 2 | key_flag(mask + size_t((l0 + list) / H) * N, key, N);
        }
        kinfo[j] = info;
    }
    int seg[2];  // of the thread's two query rows (g and g + 8 of the warp's 16): its list
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + g + 8 * h;
        seg[h] = r < nq ? (qoff + r) / N : -2;
    }

    // step 1
    float s[KEYS / 8][4];
#pragma unroll
    for (int j = 0; j < KEYS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    for (int c = 0; c < chunks; ++c) {
        next(c);
        const bf16* cs = Cs + (c & 1) * STAGE;
        uint32_t a[KS][4];
        load_a<KS>(a, cs, warp * 16, lane);
        product_nk<KS, KEYS / 8>(s, a, cs + QCHUNK, 0, lane);
        __syncthreads();  // no warp reads stage c's buffers any more
    }

    // step 2 (stage `chunks`, step 3's first, is in flight)
    uint32_t pa[KEYS / 16][4];
    float m[2], l[2];
    softmax_packed<KEYS / 8>(pa, s, kinfo + 2 * t4, seg, m, l, scale2);
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);  // the quad's four shares
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        inv[h] = 1.f / l[h];  // l >= 1 on a row of the tile: its max contributes 2^0
    }

    // step 3
    const bool pairs = how & STORE_PAIRS;
    for (int oc = 0; oc < out_chunks; ++oc) {
        const int st = chunks + oc;
        next(st);
        float acc[2 * CW][4];
#pragma unroll
        for (int j = 0; j < 2 * CW; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
        product_kn<CW, KEYS / 16>(acc, pa, Cs + (st & 1) * STAGE, 0, lane);  // O = P V
        const int c0 = oc * 16 * CW;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = warp * 16 + g + 8 * h;
            if (r >= nq) continue;
            bf16* orow = o + (row0 + qoff + r) * d;
#pragma unroll
            for (int j = 0; j < 2 * CW; ++j)
                store_pair(orow, c0 + 8 * j + 2 * t4, acc[j][2 * h] * inv[h],
                           acc[j][2 * h + 1] * inv[h], d, pairs);
        }
        __syncthreads();  // no warp reads stage st's buffer any more
    }
    if (row_max != nullptr && t4 == 0) {  // the quad holds the same m and l
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = warp * 16 + g + 8 * h;
            if (r >= nq) continue;
            const size_t at = row0 + qoff + r;
            row_max[at] = m[h] == MASKED_LOGIT2 ? MASKED_LOGIT : m[h] * LN2;
            row_sum[at] = l[h];
        }
    }
}

// blocks of the packed kernel's grid for B*H lists of N <= 128 docs
inline long long packed_blocks(long long lists, int N) {
    const int keys = N <= PACK_KEYS ? PACK_KEYS : LIST_KEYS;
    return (lists + keys / N - 1) / (keys / N) * (keys / OWN);
}

template <int KEYS>
cudaError_t launch_packed(const void* q, const void* k, const void* v, const void* mask, void* o,
                          float* row_max, float* row_sum, int B, int H, int N, int d,
                          cudaStream_t stream) {
    const auto kernel = flash_fwd_packed_mma_kernel<KEYS, PACK_CW>;
    const size_t bytes = packed_smem_bytes(KEYS, PACK_CW);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           int(bytes));
    if (err != cudaSuccess) return err;
    const int copy = chunk_copy(d, std::min({alignment(q), alignment(k), alignment(v)}));
    const int how = d % 2 == 0 && aligned(o, 4) ? STORE_PAIRS : 0;
    const dim3 grid(unsigned(packed_blocks((long long)B * H, N)));
    kernel<<<grid, MMA_NT, bytes, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const uint8_t*>(mask), static_cast<bf16*>(o), row_max, row_sum, B * H, H, N,
        d, LOG2E / sqrtf(float(d)), copy, how);
    return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16, lists of 129 .. 256 docs: the long kernel
// ---------------------------------------------------------------------------
//
// At 129 .. 256 docs the wide kernel recomputes S for each of its 128-column
// output chunks (3 at d = 350 and 384). Here, as in the packed kernel, a tile
// holds 256 / N lists (one list of 129 .. 256 docs) with a block for each 64
// query rows of it (4 warps of 16 rows), and S is computed once; but a warp's
// 16 rows by 256 keys would be 128 fp32 values of S a thread beside 64 more
// of P's fragments, so the keys go in two halves of 128:
//   1. S of the warp's rows by the half's keys (64 fp32 a thread) over d in
//      the packed kernel's double-buffered 64-column chunks of Q and K;
//   2. the softmax on the fragment with softmax_packed's rules, online
//      across the halves: the first half's P is rounded to bf16 against its
//      own max m0, the second's against m = max(m0, its max), and the first
//      half's share of l and of O is scaled by 2^(m0 - m), as the unpacked
//      kernels rescale between their 64-key tiles. Both halves' P stay in
//      registers as A operands (64 registers);
//   3. for each 64-column output chunk of V (all 256 keys): O = 2^(m0 - m)
//      P0 V0 + P1 V1, O / l rounded once at the store; row_max and row_sum
//      as the other kernels write them.
// LONG_TWO_PASS computes S twice instead: a first pass over both halves
// finds m, the second rounds every P against it (no rescale; Q and K read
// twice, the second time mostly from L2). tools/kernel_variants.py times it.
// What bounds it: bytes, as the packed kernel.

constexpr int LONG_KEYS = 4 * OWN;  // keys of the tile of one list of 129 .. 256 docs
constexpr int LONG_HALF = 2 * OWN;  // keys of S a warp holds at a time
constexpr int LONG_CW = 4;          // 16-column steps of the long kernel's output chunk: 64 columns
constexpr bool LONG_TWO_PASS = false;

// two stages (step 1's Q and K d-chunks of a half, or step 3's V chunk) and the key info
__host__ __device__ constexpr size_t long_stage_elems(int cw) {
    return size_t(OWN + LONG_HALF) * (DCH + 8) > size_t(LONG_KEYS) * (16 * cw + 8)
               ? size_t(OWN + LONG_HALF) * (DCH + 8) : size_t(LONG_KEYS) * (16 * cw + 8);
}
__host__ __device__ constexpr size_t long_smem_bytes(int cw) {
    return 2 * long_stage_elems(cw) * sizeof(bf16) + size_t(LONG_KEYS) * sizeof(int);
}

// softmax_packed on one half's fragment of S, online: m (log2 units, from
// M_INIT) and the thread's share l of the row's sum (from 0) carry the
// halves before; the new max m' = max(m, the half's max), l' = l 2^(m - m')
// + sum p, P = 2^(x - m') packed as the A operand, and alpha = 2^(m - m'),
// the factor of what the halves before contributed.
template <int NTILES>
__device__ __forceinline__ void softmax_online_packed(uint32_t (&pa)[NTILES / 2][4],
                                                      float (&s)[NTILES][4], const int* ki,
                                                      const int (&seg)[2], float (&m)[2],
                                                      float (&l)[2], float (&alpha)[2],
                                                      float scale2) {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NTILES; ++j) {
        const int2 f2 = *reinterpret_cast<const int2*>(ki + 8 * j);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int f = (e & 1) ? f2.y : f2.x, h = e >> 1;
            const bool same = (f >> 2) == seg[h];
            const float x = !same ? -INFINITY
                            : (f & 3) == KEY_REAL ? s[j][e] * scale2 : MASKED_LOGIT2;
            s[j][e] = x;
            mx[h] = fmaxf(mx[h], x);
        }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);  // M_INIT where no key of the row's list is seen yet
        alpha[h] = ex2(m[h] - m_new);
        m[h] = m_new;
        l[h] *= alpha[h];
    }
#pragma unroll
    for (int j = 0; j < NTILES; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const float p0 = ex2(s[j][2 * h] - m[h]);  // 0 on another list's key
            const float p1 = ex2(s[j][2 * h + 1] - m[h]);
            l[h] += p0 + p1;  // fp32 p, before rounding
            pa[j >> 1][(j & 1) * 2 + h] = pack_bf16(p0, p1);
        }
}

template <int CW, bool TWO_PASS>
__global__ void __launch_bounds__(MMA_NT, 2)
flash_fwd_long_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                          bf16* __restrict__ o, float* __restrict__ row_max,
                          float* __restrict__ row_sum, int lists, int H, int N, int d,
                          float scale2, int copy, int how) {
    constexpr int KS = DCH / 16;          // 16-deep steps of a d-chunk
    constexpr int LDC = 16 * KS + 8;      // row stride of the d-chunk tiles
    constexpr int QCHUNK = OWN * LDC;     // a Q d-chunk; the K d-chunk follows it
    constexpr int STAGE = int(long_stage_elems(CW));
    constexpr int QBLOCKS = LONG_KEYS / OWN;  // blocks of a key tile: one for each 64 query rows
    constexpr int HALVES = LONG_KEYS / LONG_HALF;
    constexpr int PASSES = TWO_PASS ? 2 : 1;
    static_assert(HALVES == 2, "the output rescales one half against the other");
    extern __shared__ uint4 smem_mma[];
    bf16* Cs = reinterpret_cast<bf16*>(smem_mma);         // [2][STAGE]
    int* kinfo = reinterpret_cast<int*>(Cs + 2 * STAGE);  // [LONG_KEYS]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    const int per_tile = LONG_KEYS / N;
    const int tile = blockIdx.x / QBLOCKS;
    const int l0 = tile * per_tile;                      // the tile's first (b, h) list
    const int nkeys = min(per_tile, lists - l0) * N;     // the tile's rows
    const int qoff = (blockIdx.x - tile * QBLOCKS) * OWN;  // the block's first query row in it
    const int nq = min(OWN, nkeys - qoff);
    if (nq <= 0) return;  // a query block past a short tile's rows
    const size_t row0 = size_t(l0) * N;
    const bf16* qb = q + (row0 + qoff) * d;
    const bf16* kb = k + row0 * d;
    const bf16* vb = v + row0 * d;
    const int chunks = (d + DCH - 1) / DCH;
    const int out_chunks = (d + 16 * CW - 1) / (16 * CW);
    const int s_stages = PASSES * HALVES * chunks;
    const int stages = s_stages + out_chunks;

    // stage st < s_stages: step 1's d-chunk st % chunks of Q and of the
    // half (st / chunks) % HALVES of K; st >= s_stages: step 3's output
    // chunk st - s_stages of V
    auto prefetch = [&](int st) {
        bf16* cs = Cs + (st & 1) * STAGE;
        if (st < s_stages) {
            const int h = (st / chunks) % HALVES, c = st % chunks;
            load_chunk<MMA_NT, KS, OWN>(cs, qb, nq, d, c * DCH, copy);
            load_chunk<MMA_NT, KS, LONG_HALF>(cs + QCHUNK, kb + size_t(h) * LONG_HALF * d,
                                              max(min(nkeys - h * LONG_HALF, LONG_HALF), 0), d,
                                              c * DCH, copy);
        } else {
            load_chunk<MMA_NT, CW, LONG_KEYS>(cs, vb, nkeys, d, (st - s_stages) * 16 * CW, copy);
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
    for (int j = tid; j < LONG_KEYS; j += MMA_NT) {
        int info = -1;
        if (j < nkeys) {
            const int list = j / N, key = j - list * N;
            info = list << 2 | key_flag(mask + size_t((l0 + list) / H) * N, key, N);
        }
        kinfo[j] = info;
    }
    int seg[2];  // of the thread's two query rows (g and g + 8 of the warp's 16): its list
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + g + 8 * h;
        seg[h] = r < nq ? (qoff + r) / N : -2;
    }

    // steps 1 and 2: for each half, S over the d-chunks, then its softmax
    uint32_t pa[HALVES][LONG_HALF / 16][4];
    float m[2] = {M_INIT, M_INIT}, l[2], alpha[2];
    int st = 0;
#pragma unroll 1
    for (int pass = 0; pass < PASSES; ++pass) {
        l[0] = l[1] = 0.f;  // a second pass keeps the first one's m
#pragma unroll
        for (int h = 0; h < HALVES; ++h) {
            float s[LONG_HALF / 8][4];
#pragma unroll
            for (int j = 0; j < LONG_HALF / 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
            for (int c = 0; c < chunks; ++c, ++st) {
                next(st);
                const bf16* cs = Cs + (st & 1) * STAGE;
                uint32_t a[KS][4];
                load_a<KS>(a, cs, warp * 16, lane);
                product_nk<KS, LONG_HALF / 8>(s, a, cs + QCHUNK, 0, lane);
                __syncthreads();  // no warp reads stage st's buffers any more
            }
            softmax_online_packed<LONG_HALF / 8>(pa[h], s, kinfo + h * LONG_HALF + 2 * t4, seg,
                                                 m, l, alpha, scale2);
        }
    }
    // alpha is now the second half's factor of the first half's share
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);  // the quad's four shares
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        inv[h] = 1.f / l[h];  // l >= 1 on a row of the tile: its max contributes 2^0
    }

    // step 3
    const bool pairs = how & STORE_PAIRS;
    for (int oc = 0; oc < out_chunks; ++oc, ++st) {
        next(st);
        const bf16* vs = Cs + (st & 1) * STAGE;
        float acc[2 * CW][4];
#pragma unroll
        for (int j = 0; j < 2 * CW; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
        product_kn<CW, LONG_HALF / 16>(acc, pa[0], vs, 0, lane);  // P0 V0
#pragma unroll
        for (int j = 0; j < 2 * CW; ++j) {
            acc[j][0] *= alpha[0];
            acc[j][1] *= alpha[0];
            acc[j][2] *= alpha[1];
            acc[j][3] *= alpha[1];
        }
        product_kn<CW, LONG_HALF / 16>(acc, pa[1], vs, LONG_HALF, lane);  // + P1 V1
        const int c0 = oc * 16 * CW;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = warp * 16 + g + 8 * h;
            if (r >= nq) continue;
            bf16* orow = o + (row0 + qoff + r) * d;
#pragma unroll
            for (int j = 0; j < 2 * CW; ++j)
                store_pair(orow, c0 + 8 * j + 2 * t4, acc[j][2 * h] * inv[h],
                           acc[j][2 * h + 1] * inv[h], d, pairs);
        }
        __syncthreads();  // no warp reads stage st's buffer any more
    }
    if (row_max != nullptr && t4 == 0) {  // the quad holds the same m and l
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = warp * 16 + g + 8 * h;
            if (r >= nq) continue;
            const size_t at = row0 + qoff + r;
            row_max[at] = m[h] == MASKED_LOGIT2 ? MASKED_LOGIT : m[h] * LN2;
            row_sum[at] = l[h];
        }
    }
}

// blocks of the long kernel's grid for B*H lists of N <= 256 docs
inline long long long_blocks(long long lists, int N) {
    return (lists + LONG_KEYS / N - 1) / (LONG_KEYS / N) * (LONG_KEYS / OWN);
}

cudaError_t launch_long(const void* q, const void* k, const void* v, const void* mask, void* o,
                        float* row_max, float* row_sum, int B, int H, int N, int d,
                        cudaStream_t stream) {
    const auto kernel = flash_fwd_long_mma_kernel<LONG_CW, LONG_TWO_PASS>;
    const size_t bytes = long_smem_bytes(LONG_CW);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           int(bytes));
    if (err != cudaSuccess) return err;
    const int copy = chunk_copy(d, std::min({alignment(q), alignment(k), alignment(v)}));
    const int how = d % 2 == 0 && aligned(o, 4) ? STORE_PAIRS : 0;
    const dim3 grid(unsigned(long_blocks((long long)B * H, N)));
    kernel<<<grid, MMA_NT, bytes, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const uint8_t*>(mask), static_cast<bf16*>(o), row_max, row_sum, B * H, H, N,
        d, LOG2E / sqrtf(float(d)), copy, how);
    return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32, lists of at most 64 docs: the packed kernel on 3xTF32
// ---------------------------------------------------------------------------
//
// The fp32 wide kernel it replaced recomputed S on the CUDA cores for each
// of its 64-column output chunks (6 at d = 350), on 64-row tiles of one list
// of N docs (at 16 docs, 15/16 of each S tile is padding): 3.28 ms at
// (2048, 2, 16, 350) on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md). Here
// the bf16 packed kernel's design in fp32: 64 / N consecutive (b, h) lists in
// one 64-key tile, a block of 4 warps owning the tile's 64 query rows:
//   1. S = Q K^T (a warp's 16 rows by the 64 keys, fp32) computed once, over
//      d in TF32_W-column chunks of Q and K double-buffered through shared
//      memory, on the tensor cores in 3xTF32 (mma_common.cuh): about fp32's
//      accuracy, where TF32 alone keeps 3 digits;
//   2. the softmax on the fragment with softmax_packed's rules (a key of
//      another list left out, a masked key of the row's own list at -1e9),
//      in natural-log units with expf, as the fp32 kernels compute it;
//   3. for each TF32_W-column output chunk of V, O = P V in 3xTF32 with P in
//      registers: its C fragment is the A fragment of the product once the
//      k slots are renumbered (mma_1688_tf32), so P never reaches shared
//      memory; O / l and the row statistics stored in fp32.
// Each operand is split into hi and lo at its fragment load (PERF.md has the
// times of a split staged once in shared memory, which lost).
// What bounds it: bytes. Q, K and V are read once and O written once; the
// products, those on the zeros of other lists included, are 3 x 4 * 64 * 64
// * d operations a tile in TF32, below the tensor cores' ridge. On an NVIDIA
// H100 80GB HBM3 at 700 W (PERF.md): 0.24 ms with statistics at (2048, 2,
// 16, 350), and at 32 and 64 docs, against a byte bound of 0.110 ms, the
// wide kernel's 3.28 and SDPA's fp32 0.39; 0.21 ms at d = 384. Its worst
// errors at chip_smoke.py's fp32 gates: 1.4e-6 of the output's scale,
// 3.2e-6 in the statistics.

constexpr int TF32_W = 32;  // columns of the fp32 packed kernel's d-chunks and output chunks

// two stages (step 1's Q and K chunks, or step 3's V chunk) and the key info
__host__ __device__ constexpr size_t packed_tf32_smem_bytes(int w) {
    return size_t(2) * 2 * PACK_KEYS * (w + 4) * sizeof(float) + PACK_KEYS * sizeof(int);
}

template <int W>
__global__ void __launch_bounds__(MMA_NT, 2)
flash_fwd_packed_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const uint8_t* __restrict__ mask,
                             float* __restrict__ o, float* __restrict__ row_max,
                             float* __restrict__ row_sum, int lists, int H, int N, int d,
                             float scale, int copy, int how) {
    constexpr int LD = W + 4;              // row stride of the chunk tiles (floats)
    constexpr int TS = PACK_KEYS * LD;     // a chunk tile: a tensor's share of a stage
    constexpr int STAGE = 2 * TS;
    extern __shared__ uint4 smem_mma[];
    float* Cs = reinterpret_cast<float*>(smem_mma);       // [2][STAGE]
    int* kinfo = reinterpret_cast<int*>(Cs + 2 * STAGE);  // [PACK_KEYS]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    const int per_tile = PACK_KEYS / N;
    const int l0 = blockIdx.x * per_tile;              // the tile's first (b, h) list
    const int nkeys = min(per_tile, lists - l0) * N;   // the tile's rows: query rows and keys
    const size_t row0 = size_t(l0) * N;
    const float* qb = q + row0 * d;
    const float* kb = k + row0 * d;
    const float* vb = v + row0 * d;
    const int chunks = (d + W - 1) / W;
    const int stages = 2 * chunks;

    // stage st < chunks: step 1's d-chunk st of Q and K; st >= chunks: step
    // 3's output chunk st - chunks of V
    auto prefetch = [&](int st) {
        float* cs = Cs + (st & 1) * STAGE;
        if (st < chunks) {
            load_chunk_f32<MMA_NT, W, PACK_KEYS>(cs, qb, nkeys, d, st * W, copy);
            load_chunk_f32<MMA_NT, W, PACK_KEYS>(cs + TS, kb, nkeys, d, st * W, copy);
        } else {
            load_chunk_f32<MMA_NT, W, PACK_KEYS>(cs, vb, nkeys, d, (st - chunks) * W, copy);
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
    for (int j = tid; j < PACK_KEYS; j += MMA_NT) {
        int info = -1;
        if (j < nkeys) {
            const int list = j / N, key = j - list * N;
            info = list << 2 | key_flag(mask + size_t((l0 + list) / H) * N, key, N);
        }
        kinfo[j] = info;
    }
    int seg[2];  // of the thread's two query rows (g and g + 8 of the warp's 16): its list
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + g + 8 * h;
        seg[h] = r < nkeys ? r / N : -2;
    }

    // step 1
    float s[PACK_KEYS / 8][4];
#pragma unroll
    for (int j = 0; j < PACK_KEYS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    for (int c = 0; c < chunks; ++c) {
        next(c);
        const float* qs = Cs + (c & 1) * STAGE;
#pragma unroll
        for (int kk = 0; kk < W; kk += 8) {
            uint32_t ahi[4], alo[4];
            frag_a_tf32<LD>(ahi, alo, qs, warp * 16, kk, lane);
#pragma unroll
            for (int j = 0; j < PACK_KEYS / 8; ++j) {
                uint32_t bhi[2], blo[2];
                frag_b_nk_tf32<LD>(bhi, blo, qs + TS, 8 * j, kk, lane);
                mma_3xtf32(s[j], ahi, alo, bhi, blo);
            }
        }
        __syncthreads();  // no warp reads stage c's buffers any more
    }

    // step 2 (stage `chunks`, step 3's first, is in flight): the max over the
    // row's own keys, p = exp(x - m) in place of S, and the thread's share of l
    float m[2], l[2], inv[2];
    {
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < PACK_KEYS / 8; ++j) {
            const int2 f2 = *reinterpret_cast<const int2*>(kinfo + 8 * j + 2 * t4);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int f = (e & 1) ? f2.y : f2.x, h = e >> 1;
                const float x = (f >> 2) != seg[h] ? -INFINITY
                                : (f & 3) == KEY_REAL ? s[j][e] * scale : MASKED_LOGIT;
                s[j][e] = x;
                mx[h] = fmaxf(mx[h], x);
            }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
            m[h] = fmaxf(M_INIT, mx[h]);  // M_INIT on a row past the tile's: every p is 0
            l[h] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < PACK_KEYS / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float p = expf(s[j][e] - m[e >> 1]);  // 0 on another list's key
                s[j][e] = p;
                l[e >> 1] += p;
            }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);  // the quad's four shares
            l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
            inv[h] = 1.f / l[h];  // l >= 1 on a row of the tile: its max contributes exp(0)
        }
    }

    // step 3
    const bool pairs = how & STORE_PAIRS;
    for (int oc = 0; oc < chunks; ++oc) {
        const int st = chunks + oc;
        next(st);
        const float* vs = Cs + (st & 1) * STAGE;
        float acc[W / 8][4];
#pragma unroll
        for (int n = 0; n < W / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
        for (int j = 0; j < PACK_KEYS / 8; ++j) {  // O += P V over the keys 8j .. 8j + 7
            uint32_t ahi[4], alo[4];
            c_as_a_tf32(ahi, alo, s[j]);
#pragma unroll
            for (int n = 0; n < W / 8; ++n) {
                uint32_t bhi[2], blo[2];
                frag_b_kn_tf32<LD>(bhi, blo, vs, 8 * j, 8 * n, lane);
                mma_3xtf32(acc[n], ahi, alo, bhi, blo);
            }
        }
        const int c0 = oc * W;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = warp * 16 + g + 8 * h;
            if (r >= nkeys) continue;
            float* orow = o + (row0 + r) * d;
#pragma unroll
            for (int n = 0; n < W / 8; ++n)
                store_pair_f32(orow, c0 + 8 * n + 2 * t4, acc[n][2 * h] * inv[h],
                               acc[n][2 * h + 1] * inv[h], d, pairs);
        }
        __syncthreads();  // no warp reads stage st's buffer any more
    }
    if (row_max != nullptr && t4 == 0) {  // the quad holds the same m and l
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = warp * 16 + g + 8 * h;
            if (r >= nkeys) continue;
            row_max[row0 + r] = m[h];
            row_sum[row0 + r] = l[h];
        }
    }
}

// one block per tile of 64 / N lists
cudaError_t launch_packed_tf32(const void* q, const void* k, const void* v, const void* mask,
                               void* o, float* row_max, float* row_sum, int B, int H, int N,
                               int d, cudaStream_t stream) {
    const auto kernel = flash_fwd_packed_tf32_kernel<TF32_W>;
    const size_t bytes = packed_tf32_smem_bytes(TF32_W);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           int(bytes));
    if (err != cudaSuccess) return err;
    const int copy = chunk_copy_f32(d, std::min({alignment(q), alignment(k), alignment(v)}));
    const int how = d % 2 == 0 && aligned(o, 8) ? STORE_PAIRS : 0;
    const dim3 grid(unsigned(packed_blocks((long long)B * H, N)));
    kernel<<<grid, MMA_NT, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const uint8_t*>(mask), static_cast<float*>(o), row_max, row_sum, B * H, H,
        N, d, 1.0f / sqrtf(float(d)), copy, how);
    return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32, lists of 65 .. 256 docs: the list and long kernels on 3xTF32
// ---------------------------------------------------------------------------
//
// At 65 .. 256 docs the CUDA-core fp32 wide kernel these replaced recomputed
// S for each of its 64-column output chunks (6 at d = 350): 2.06 ms at (256, 2,
// 128, 350) and 3.98 at (128, 2, 256, 350) on an NVIDIA H100 80GB HBM3 at
// 700 W, where SDPA's fp32 forward takes 0.58 and 0.91 (PERF.md). The fp32
// packed kernel's tile does not stretch to these lists: S of a warp's 16 rows
// by 128 or 256 keys would be 64 or 128 fp32 registers a thread beside the
// 3xTF32 fragments (that kernel holds 249 with 64 keys). Here a tile holds
// ROWS / N consecutive (b, h) lists (one list of 65 .. ROWS docs; ROWS = 128
// for the packed entry, 256 for the long one), a block of 2 * OWN threads
// owns OWN of its query rows (16 a warp; ROWS / OWN blocks a tile; OWN =
// f32_own(ROWS): 64 of the 128-row tile, 128 of the 256-row one) and all
// of its keys, and S is computed once:
//   1. for each slice of F32_SLICE keys, S of the warp's 16 rows by the
//      slice (32 fp32 registers a thread) over d in F32_W-column chunks of Q
//      and of the slice's K, double-buffered by cp.async (load_rows_f32: a
//      thread's copies at constant strides), every product in
//      3xTF32 (mma_3xtf32), each operand split into hi and lo at its fragment
//      load by integer rounding of its bits (F32_INT_ROUND: the same bits as
//      cvt.rna.tf32.f32, as in flash_attn_bwd.cu's fp32 list kernel). The
//      slice's logits, with softmax_packed's rules (a key of another list
//      left out, a masked key of the row's own list at -1e9), go to shared
//      memory, and the thread's running max over them stays in registers;
//   2. the row's max m over all its keys (one max: no rescale), then
//      p = exp(x - m) in place and the row's sum l, in natural-log units
//      with expf, as the fp32 kernels compute them;
//   3. for each F32_W-column output chunk of V (all the tile's keys), O = P V
//      in 3xTF32, O / l stored in fp32; row_max and row_sum as the other fp32
//      kernels write them.
// A thread stores the logits and p of its own C fragments (rows g, g + 8;
// columns 2t, 2t + 1 of each 8-key tile) as one float4 a tile, at
// [tile][thread], and reads back exactly what it wrote: C fragment is A
// fragment (mma_1688_tf32's renumbered k slots), so step 3 reads P's A
// fragments with one conflict-free 16-byte load and no barrier is needed
// between the steps; shared memory holds what registers cannot (ROWS / 8
// float4 a thread). Shared memory: that store (OWN * ROWS floats), two
// stages (the Q chunk and the slice's K chunk, or all ROWS keys of a V
// chunk) and the key info: 70,144 bytes at ROWS = 128 (two blocks of 4
// warps an SM, by registers), 205,824 at 256 (one block of 8 warps). No
// atomics: the same inputs give the same bits.
// What bounds it: the bytes at 128 docs, the products at 256 (4 * N^2 * d
// operations a list, each three TF32 products; q, k, v read and o written
// once, K and V read by each of a tile's blocks, the second time mostly
// from L2), and before either the instructions that feed the tensor cores:
// two loads and five integer or fp32 operations to split each operand
// value, four fp32 additions a 3xTF32 product, the cp.async copies (4 bytes
// wide at d = 350), with 8 warps an SM to hide their latency. On an NVIDIA
// H100 80GB HBM3 at 700 W (PERF.md): 0.32 ms at (256, 2, 128, 350) and 0.69
// at (128, 2, 256, 350), against the wide kernel's 2.02 and 3.89 and SDPA's
// fp32 0.58 and 0.91; at d = 384 0.32 and 0.64 (SDPA 0.34 and 0.64).
// Splitting each K chunk once in shared memory for all warps, 16-column
// chunks and the cvt split all took longer (PERF.md).

// query rows a block owns, a warp for each 16: of the 128-row tile, of the
// 256-row tile (tools/kernel_variants.py times each the other way: 128 rows
// of 8 warps took 5..10% longer at 128 docs, 64 of 4 warps 15..24% longer
// at 256 docs, PERF.md)
constexpr int F32_LIST_OWN = 64;
constexpr int F32_LONG_OWN = 128;
constexpr int F32_SLICE = 64;  // keys of S a warp holds at a time: 16 rows by 64
// columns of the d-chunks and output chunks (tools/kernel_variants.py times 16)
constexpr int F32_W = 32;
// whether the operands' hi/lo split rounds by integer arithmetic (the same
// bits as cvt.rna.tf32.f32: mma_common.cuh's to_tf32_int)
constexpr bool F32_INT_ROUND = true;

// query rows a block of the `rows`-row tile owns
__host__ __device__ constexpr int f32_own(int rows) {
    return rows > LIST_KEYS ? F32_LONG_OWN : F32_LIST_OWN;
}
// a stage: step 1's Q chunk and the slice's K chunk, or step 3's V chunk of `rows` keys
__host__ __device__ constexpr size_t list_tf32_stage_floats(int rows, int w) {
    return size_t(f32_own(rows) + F32_SLICE) * (w + 4) > size_t(rows) * (w + 4)
               ? size_t(f32_own(rows) + F32_SLICE) * (w + 4) : size_t(rows) * (w + 4);
}
// the threads' logits and p (own * rows floats), two stages and the key info
__host__ __device__ constexpr size_t list_tf32_smem_bytes(int rows, int w) {
    return (size_t(f32_own(rows)) * rows + 2 * list_tf32_stage_floats(rows, w)) * sizeof(float)
           + rows * sizeof(int);
}

template <int ROWS, int W>
__global__ void __launch_bounds__(2 * f32_own(ROWS), 1)
flash_fwd_list_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const uint8_t* __restrict__ mask,
                           float* __restrict__ o, float* __restrict__ row_max,
                           float* __restrict__ row_sum, int lists, int H, int N, int d,
                           float scale, int copy, int how) {
    constexpr int OWN = f32_own(ROWS);   // query rows a block owns
    constexpr int NT = 2 * OWN;          // threads
    static_assert(ROWS % OWN == 0 && ROWS % F32_SLICE == 0, "whole blocks and slices a tile");
    static_assert(W % 8 == 0, "chunks of 8-deep steps");
    constexpr int LD = W + 4;                // row stride of the chunk tiles (floats)
    constexpr int QT = OWN * LD;             // a Q chunk tile; the slice's K chunk follows it
    constexpr int STAGE = int(list_tf32_stage_floats(ROWS, W));
    constexpr int QBLOCKS = ROWS / OWN;      // blocks of a tile
    constexpr int STILES = F32_SLICE / 8;    // 8-key tiles of a slice
    extern __shared__ uint4 smem_mma[];
    float4* Xs = reinterpret_cast<float4*>(smem_mma);       // [ROWS / 8][NT]: x, then p
    float* Cs = reinterpret_cast<float*>(Xs + (ROWS / 8) * NT);  // [2][STAGE]
    int* kinfo = reinterpret_cast<int*>(Cs + 2 * STAGE);    // [ROWS]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    const int per_tile = ROWS / N;
    const int tile = blockIdx.x / QBLOCKS;
    const int l0 = tile * per_tile;                          // the tile's first (b, h) list
    const int nkeys = min(per_tile, lists - l0) * N;         // the tile's rows
    const int qoff = (blockIdx.x - tile * QBLOCKS) * OWN;  // the block's first query row in it
    const int nq = min(OWN, nkeys - qoff);
    if (nq <= 0) return;  // a query block past a short tile's rows
    const size_t row0 = size_t(l0) * N;
    const float* qb = q + (row0 + qoff) * d;
    const float* kb = k + row0 * d;
    const float* vb = v + row0 * d;
    const int chunks = (d + W - 1) / W;
    const int slices = (nkeys + F32_SLICE - 1) / F32_SLICE;
    const int s_stages = slices * chunks;
    const int stages = s_stages + chunks;

    // stage st < s_stages: step 1's d-chunk st % chunks of Q and of the
    // slice st / chunks of K; st >= s_stages: step 3's output chunk
    // st - s_stages of V
    auto prefetch = [&](int st) {
        float* cs = Cs + (st & 1) * STAGE;
        if (st < s_stages) {
            const int slice = st / chunks, c0 = (st - slice * chunks) * W;
            load_rows_f32<NT, W, OWN>(cs, qb, nq, d, c0, copy);
            load_rows_f32<NT, W, F32_SLICE>(cs + QT, kb + size_t(slice) * F32_SLICE * d,
                                            min(nkeys - slice * F32_SLICE, F32_SLICE), d, c0, copy);
        } else {
            load_rows_f32<NT, W, ROWS>(cs, vb, nkeys, d, (st - s_stages) * W, copy);
        }
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
    for (int j = tid; j < ROWS; j += NT) {
        int info = -1;
        if (j < nkeys) {
            const int list = j / N, key = j - list * N;
            info = list << 2 | key_flag(mask + size_t((l0 + list) / H) * N, key, N);
        }
        kinfo[j] = info;
    }
    int seg[2];  // of the thread's two query rows (g and g + 8 of the warp's 16): its list
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + g + 8 * h;
        seg[h] = r < nq ? (qoff + r) / N : -2;
    }

    // step 1
    float mx[2] = {-INFINITY, -INFINITY};
    int st = 0;
    for (int slice = 0; slice < slices; ++slice) {
        float s[STILES][4];
#pragma unroll
        for (int j = 0; j < STILES; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
        for (int c = 0; c < chunks; ++c, ++st) {
            const float* cs = next(st);
#pragma unroll
            for (int kk = 0; kk < W; kk += 8) {
                uint32_t ahi[4], alo[4];
                frag_a_tf32<LD, F32_INT_ROUND>(ahi, alo, cs, warp * 16, kk, lane);
#pragma unroll
                for (int j = 0; j < STILES; ++j) {
                    uint32_t bhi[2], blo[2];
                    frag_b_nk_tf32<LD, F32_INT_ROUND>(bhi, blo, cs + QT, 8 * j, kk, lane);
                    mma_3xtf32(s[j], ahi, alo, bhi, blo);
                }
            }
            __syncthreads();  // no warp reads stage st's buffers any more
        }
        // the slice's logits (a key of another list: -inf, p = 0) into the
        // thread's own slots, and their running max
        const int* ki = kinfo + slice * F32_SLICE + 2 * t4;
#pragma unroll
        for (int j = 0; j < STILES; ++j) {
            const int2 f2 = *reinterpret_cast<const int2*>(ki + 8 * j);
            float x[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int f = (e & 1) ? f2.y : f2.x, h = e >> 1;
                x[e] = (f >> 2) != seg[h] ? -INFINITY
                       : (f & 3) == KEY_REAL ? s[j][e] * scale : MASKED_LOGIT;
                mx[h] = fmaxf(mx[h], x[e]);
            }
            Xs[(slice * STILES + j) * NT + tid] = make_float4(x[0], x[1], x[2], x[3]);
        }
    }

    // step 2 (stage s_stages, step 3's first, is in flight): the row's max,
    // p = exp(x - m) in place of x, and the thread's share of l
    const int ktiles = slices * STILES;  // the 8-key tiles that hold keys
    float m[2], l[2] = {0.f, 0.f}, inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        m[h] = fmaxf(M_INIT, mx[h]);  // M_INIT on a row past the tile's: every p is 0
    }
    for (int j = 0; j < ktiles; ++j) {
        float4 x = Xs[j * NT + tid];
        x.x = expf(x.x - m[0]);  // 0 on another list's key
        x.y = expf(x.y - m[0]);
        x.z = expf(x.z - m[1]);
        x.w = expf(x.w - m[1]);
        l[0] += x.x + x.y;
        l[1] += x.z + x.w;
        Xs[j * NT + tid] = x;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);  // the quad's four shares
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        inv[h] = 1.f / l[h];  // l >= 1 on a row of the tile: its max contributes exp(0)
    }

    // step 3
    const bool pairs = how & STORE_PAIRS;
    for (int oc = 0; oc < chunks; ++oc, ++st) {
        const float* vs = next(st);
        float acc[W / 8][4];
#pragma unroll
        for (int n = 0; n < W / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll 2
        for (int j = 0; j < ktiles; ++j) {  // O += P V over the keys 8j .. 8j + 7
            const float4 p = Xs[j * NT + tid];
            const float c[4] = {p.x, p.y, p.z, p.w};
            uint32_t ahi[4], alo[4];
            c_as_a_tf32<F32_INT_ROUND>(ahi, alo, c);
#pragma unroll
            for (int n = 0; n < W / 8; ++n) {
                uint32_t bhi[2], blo[2];
                frag_b_kn_tf32<LD, F32_INT_ROUND>(bhi, blo, vs, 8 * j, 8 * n, lane);
                mma_3xtf32(acc[n], ahi, alo, bhi, blo);
            }
        }
        const int c0 = oc * W;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = warp * 16 + g + 8 * h;
            if (r >= nq) continue;
            float* orow = o + (row0 + qoff + r) * d;
#pragma unroll
            for (int n = 0; n < W / 8; ++n)
                store_pair_f32(orow, c0 + 8 * n + 2 * t4, acc[n][2 * h] * inv[h],
                               acc[n][2 * h + 1] * inv[h], d, pairs);
        }
        __syncthreads();  // no warp reads stage st's buffer any more
    }
    if (row_max != nullptr && t4 == 0) {  // the quad holds the same m and l
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = warp * 16 + g + 8 * h;
            if (r >= nq) continue;
            row_max[row0 + qoff + r] = m[h];
            row_sum[row0 + qoff + r] = l[h];
        }
    }
}

// blocks of the fp32 list or long kernel's grid for B*H lists of N <= rows
// docs: rows / f32_own(rows) a tile of rows / N lists
inline long long list_tf32_blocks(long long lists, int N, int rows) {
    return (lists + rows / N - 1) / (rows / N) * (rows / f32_own(rows));
}

template <int ROWS>
cudaError_t launch_list_tf32(const void* q, const void* k, const void* v, const void* mask,
                             void* o, float* row_max, float* row_sum, int B, int H, int N, int d,
                             cudaStream_t stream) {
    const auto kernel = flash_fwd_list_tf32_kernel<ROWS, F32_W>;
    const size_t bytes = list_tf32_smem_bytes(ROWS, F32_W);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           int(bytes));
    if (err != cudaSuccess) return err;
    const int copy = chunk_copy_f32(d, std::min({alignment(q), alignment(k), alignment(v)}));
    const int how = d % 2 == 0 && aligned(o, 8) ? STORE_PAIRS : 0;
    const dim3 grid(unsigned(list_tf32_blocks((long long)B * H, N, ROWS)));
    kernel<<<grid, 2 * f32_own(ROWS), bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const uint8_t*>(mask), static_cast<float*>(o), row_max, row_sum, B * H, H,
        N, d, 1.0f / sqrtf(float(d)), copy, how);
    return cudaGetLastError();
}

// d <= 128: bf16 on the head dim padded to a multiple of 16 (KC steps of
// 16), fp32 on the head dim padded to a multiple of 8 (NC steps of 8)
int launch_narrow(const void* q, const void* k, const void* v, const void* mask, void* o,
                  float* rm, float* rs, int B, int H, int N, int d, int dtype,
                  cudaStream_t st) {
#define ARGS (q, k, v, mask, o, rm, rs, B, H, N, d, st)
    if (dtype == 1) {
        switch ((d + 15) / 16) {
            case 1: return int(launch_mma<1> ARGS);
            case 2: return int(launch_mma<2> ARGS);
            case 3: return int(launch_mma<3> ARGS);
            case 4: return int(launch_mma<4> ARGS);
            case 5: return int(launch_mma<5> ARGS);
            case 6: return int(launch_mma<6> ARGS);
            case 7: return int(launch_mma<7> ARGS);
            case 8: return int(launch_mma<8> ARGS);
        }
    } else {
        switch ((d + 7) / 8) {
            case 1: return int(launch_tf32<1> ARGS);
            case 2: return int(launch_tf32<2> ARGS);
            case 3: return int(launch_tf32<3> ARGS);
            case 4: return int(launch_tf32<4> ARGS);
            case 5: return int(launch_tf32<5> ARGS);
            case 6: return int(launch_tf32<6> ARGS);
            case 7: return int(launch_tf32<7> ARGS);
            case 8: return int(launch_tf32<8> ARGS);
            case 9: return int(launch_tf32<9> ARGS);
            case 10: return int(launch_tf32<10> ARGS);
            case 11: return int(launch_tf32<11> ARGS);
            case 12: return int(launch_tf32<12> ARGS);
            case 13: return int(launch_tf32<13> ARGS);
            case 14: return int(launch_tf32<14> ARGS);
            case 15: return int(launch_tf32<15> ARGS);
            case 16: return int(launch_tf32<16> ARGS);
        }
    }
#undef ARGS
    return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success). dtype: 0 = fp32 (3xTF32 on the tensor
// cores), 1 = bf16 (tensor cores). row_max and row_sum are both null (no
// statistics) or both [B, H, N] fp32. d <= 128 runs the kernels above, in
// launches of at most narrow_lists(H) lists (mma_common.cuh), d > 128 the
// wide ones (fp32: flash_fwd_wide_tf32_kernel, every column of a row a
// block); every shape is taken whose grids fit (grid_fits).
int flash_attn_fwd(const void* q, const void* k, const void* v, const void* mask, void* o,
                   void* row_max, void* row_sum, int B, int H, int N, int d, int dtype,
                   void* stream) {
    if (B < 1 || H < 1 || N < 1 || d < 1 || (dtype != 0 && dtype != 1)
        || ((row_max == nullptr) != (row_sum == nullptr)))
        return int(cudaErrorInvalidValue);
    if (!grid_fits(B, H, N, d, dtype == 1 ? 16 * WIDE_CW : d))
        return int(cudaErrorInvalidConfiguration);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    float* rm = static_cast<float*>(row_max);
    float* rs = static_cast<float*>(row_sum);
    if (d > 128)
        return int(dtype == 1 ? launch_wide_mma(q, k, v, mask, o, rm, rs, B, H, N, d, st)
                              : launch_wide_tf32(q, k, v, mask, o, rm, rs, B, H, N, d, st));
    // bytes of one list: of q, k, v and o, and of a row statistic
    const size_t list = size_t(H) * N * d * (dtype == 1 ? 2 : 4), stat = size_t(H) * N * 4;
    for (int b0 = 0; b0 < B; b0 += narrow_lists(H)) {
        const size_t l = b0;
        const int err = launch_narrow(advance(q, l * list), advance(k, l * list),
                                      advance(v, l * list), advance(mask, l * N),
                                      advance(o, l * list), advance(rm, l * stat),
                                      advance(rs, l * stat), std::min(narrow_lists(H), B - b0),
                                      H, N, d, dtype, st);
        if (err != 0) return err;
    }
    return 0;
}

// The packed kernels: lists of at most 128 docs, any d, the same arguments
// as flash_attn_fwd: bf16 on the packed kernel; fp32 (3xTF32) of at most 64
// docs on the fp32 packed kernel, of 65 .. 128 on the fp32 list kernel's
// 128-row tile. One launch, whose grid (packed_blocks, list_tf32_blocks)
// must fit grid.x.
int flash_attn_fwd_packed(const void* q, const void* k, const void* v, const void* mask, void* o,
                          void* row_max, void* row_sum, int B, int H, int N, int d, int dtype,
                          void* stream) {
    const bool f32_list = dtype == 0 && N > PACK_KEYS;
    if (B < 1 || H < 1 || N < 1 || N > LIST_KEYS || d < 1 || (dtype != 0 && dtype != 1)
        || ((row_max == nullptr) != (row_sum == nullptr))
        || (f32_list ? list_tf32_blocks((long long)B * H, N, LIST_KEYS)
                     : packed_blocks((long long)B * H, N)) >= (1LL << 31))
        return int(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    float* rm = static_cast<float*>(row_max);
    float* rs = static_cast<float*>(row_sum);
    if (f32_list)
        return int(launch_list_tf32<LIST_KEYS>(q, k, v, mask, o, rm, rs, B, H, N, d, st));
    if (dtype == 0) return int(launch_packed_tf32(q, k, v, mask, o, rm, rs, B, H, N, d, st));
    return int(N <= PACK_KEYS ? launch_packed<PACK_KEYS>(q, k, v, mask, o, rm, rs, B, H, N, d, st)
                              : launch_packed<LIST_KEYS>(q, k, v, mask, o, rm, rs, B, H, N, d, st));
}

// The long kernels: lists of at most 256 docs (any d; the routes take them
// at 129 .. 256), the same arguments as flash_attn_fwd: bf16 on the long
// kernel, fp32 (3xTF32) on the fp32 list kernel's 256-row tile. One launch,
// whose grid (long_blocks, list_tf32_blocks) must fit grid.x.
int flash_attn_fwd_long(const void* q, const void* k, const void* v, const void* mask, void* o,
                        void* row_max, void* row_sum, int B, int H, int N, int d, int dtype,
                        void* stream) {
    if (B < 1 || H < 1 || N < 1 || N > LONG_KEYS || d < 1 || (dtype != 0 && dtype != 1)
        || ((row_max == nullptr) != (row_sum == nullptr))
        || (dtype == 0 ? list_tf32_blocks((long long)B * H, N, LONG_KEYS)
                       : long_blocks((long long)B * H, N)) >= (1LL << 31))
        return int(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    float* rm = static_cast<float*>(row_max);
    float* rs = static_cast<float*>(row_sum);
    if (dtype == 0)
        return int(launch_list_tf32<LONG_KEYS>(q, k, v, mask, o, rm, rs, B, H, N, d, st));
    return int(launch_long(q, k, v, mask, o, rm, rs, B, H, N, d, st));
}

const char* flash_attn_fwd_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
