// Fused int8 dequant-matmul for the weight-only int8 serve path (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel dist_mnist_tpu/ops/pallas/quant_matmul.py
// (`_qmm_kernel`, launched by `_qmm_2d` under `quant_matmul`):
//
//     out[m, h] = cast_to_T(scale[h] * sum_k f32(x[m, k]) * f32(q[k, h]))
//
// x is float or bf16 [M, K] row-major, q is int8 [K, H] row-major, scale is
// f32 [H], out is T [M, H]. Accumulation is in f32 and the per-channel scale
// is applied once to the accumulator at the epilogue: dequantization commutes
// with the contraction, so no float copy of the weight is ever made.
//
// What bounds it. At serve batch the call moves mostly weight bytes: LeNet-5's
// fc1 is a 3136 x 512 int8 kernel (1.6 MB) against 0.4 MB of bf16 activations
// at M = 64, and 0.2 GFLOP, far below the card's ridge point: the bound is the
// bytes over device-memory bandwidth, 0.6 us. What holds a kernel back from it
// is filling the card and the latency of its loads: a grid of one block per
// output tile gives fc1 64 blocks on 132 SMs, each walking all of K in series.
//
// Two routes, picked by the wrapper by x's type:
//
// bf16 (`qmm_bf16_splitk_kernel`): split-K on the tensor cores.
//   * An int8 value in [-127, 127] is exact in bf16, and the product of two
//     bf16 values is exact in f32, so mma.sync m16n8k16 (bf16 in, f32
//     accumulator) forms exactly the reference's products; only the order of
//     the f32 sums changes.
//   * One block of 4 warps per (64-row, 32-channel) output tile and K split:
//     the grid is (H/32, M/64, splits), splits a function of (M, K, H) alone
//     chosen by the wrapper so the grid fills the 132 SMs at M <= 64 (fc1: 16
//     tiles x 9 splits). The same input gives the same bits on any card.
//   * Each K chunk of 64 is staged by 16-byte cp.async in a 4-stage ring: the
//     activations as bf16 (rows padded to 144 bytes, so ldmatrix reads them
//     without bank conflicts), the weights as int8 (48-byte rows). Warp w owns
//     the 8 channels [8w, 8w+8) of the tile and every 16-row slice of it that
//     holds a real row: A through ldmatrix.x4, B as int8 read from shared
//     memory and widened to bf16 in registers.
//   * Reduction, deterministic and in the same launch: with one split, the
//     block stores its tile directly. Otherwise each split writes its f32
//     partial tile to a workspace the wrapper allocates; the last block to
//     arrive at a tile (a per-tile arrival counter, which that block resets to
//     0 for the next launch) sums the partials in split index order, multiplies
//     by scale[h] once, rounds to bf16 and stores, masking the ragged M and H
//     edges (H = 10 for fc2).
//   * Operands whose rows are not 16-byte aligned (K % 8 for x, H % 16 for q)
//     are staged by plain loads instead of cp.async: same tiles, same sums.
//
// f32 (`qmm_f32_splitk_kernel`): split-K on the CUDA cores. The f32 products must
// stay full f32 (TF32, or bf16 tensor cores, would cut the activations), and the
// MLP's layers ([M,784]x[784,100], [M,100]x[100,10]) are latency-bound, not
// FLOP-bound (10 MFLOP at M = 64): what the kernel has to do is put every SM to
// work on a short stretch of K.
//   * One block of 128 threads per (ROWS-row, 32-channel) output tile and split
//     of K. ROWS is M rounded up to a power of two, at most 16, so M = 1 computes
//     one row: the lanes of a channel group that rows cannot use take k slices
//     instead, summed in slice order through shared memory. K is split by the
//     bf16 route's plan with this route's tile (chunks of 32, at most 32
//     splits, two blocks per SM): hid at M = 1 is 4 tiles x 25 splits of one
//     chunk, at M = 64 16 tiles x 13 splits of two.
//   * Each chunk of 32 k is staged in shared memory by cp.async in a
//     two-slot ring (x by 16 bytes when K % 4 == 0, q by 4 when H % 4 == 0:
//     the MLP's rows of 100 int8; else plain loads), and q is widened to f32
//     there once per block, not once per row. A thread keeps 4 f32 sums, k
//     ascending (fmaf), reading a float4 of weights and one activation per
//     k. A split's loads are one round trip to memory (loading into
//     registers a group of 4 k at a time cost ~1 us a group on an H100).
//   * The same reduction as the bf16 route: f32 partial tiles summed in split
//     order by the last block to arrive (its loads of up to 16 splits' float4
//     partials in flight at once), so an input gives the same bits on any
//     card, run or stream.
//
// Both epilogues round with __float2bfloat16 (round-to-nearest-even, as
// torch's cast) or store f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

// -- f32 route ---------------------------------------------------------------

constexpr int F_THREADS = 128;
constexpr int F_BN = 32;                           // output channels per tile
constexpr int F_CG = F_BN / 4;                     // channel groups: one char4 of q each
constexpr int F_BK = 32;                           // the K chunk the splits are counted in
constexpr int F_LANES = F_THREADS / F_CG;          // 16: rows x k slices

constexpr int F_XP = F_BK + 4;                     // staged x row pitch (floats)
constexpr int F_SUM_F4 = 16;                       // float4 partials a thread loads at once

// One block of 128 threads per (ROWS-row, 32-channel) output tile and split of K.
// Thread (cg, row, ks) owns channels [4 cg, 4 cg + 4) of one row and the k ks,
// ks + KS, ... of each chunk of 32: with fewer than 16 rows the lanes that would hold
// padding rows take k slices instead. Each chunk of x (f32) and q
// (int8) is staged in shared memory by cp.async in a two-slot ring, the next chunk
// in flight while this one is used; q is widened to f32 there once per block.
template <int ROWS>
__global__ void __launch_bounds__(F_THREADS)
qmm_f32_splitk_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                      const float* __restrict__ scale, float* __restrict__ out,
                      float* __restrict__ partial, unsigned int* __restrict__ arrivals, int M,
                      int K, int H, int chunks_per_split, int vec_x, int vec_w) {
    constexpr int KS = F_LANES / ROWS;                    // k slices
    constexpr int TILE_N = ROWS * F_BN;                   // sums of a tile
    constexpr int PER_THREAD = (TILE_N + F_THREADS - 1) / F_THREADS;
    constexpr int TILE_F4 = TILE_N / 4;
    constexpr int F4_PER_THREAD = (TILE_F4 + F_THREADS - 1) / F_THREADS;
    constexpr int SUM_BATCH = F_SUM_F4 / F4_PER_THREAD;   // splits loaded at once
    static_assert(ROWS * KS == F_LANES, "ROWS: a power of two <= 16");
    __shared__ __align__(16) float x_s[2][ROWS][F_XP];          // x chunks, [row][k]
    __shared__ __align__(16) unsigned char q_s[2][F_BK][F_BN];  // q chunks, [k][channel]
    __shared__ __align__(16) float w_s[F_BK][F_BN];             // this chunk's q in f32
    __shared__ __align__(16) float red[KS * TILE_N];            // [ks][row][channel]
    __shared__ int last_block;

    const int tid = threadIdx.x;
    const int cg = tid % F_CG;
    const int row = (tid / F_CG) % ROWS;
    const int ks = tid / (F_CG * ROWS);
    const int h0 = blockIdx.x * F_BN, m0 = blockIdx.y * ROWS;
    const int split = blockIdx.z, splits = gridDim.z;
    const int c0 = split * chunks_per_split;
    const int nch = min(chunks_per_split, (K + F_BK - 1) / F_BK - c0);

    // chunk c (of the whole K axis) into ring slot st; out of range reads as 0. x by
    // 16 bytes (vec_x: K % 4 == 0 and a 16-byte base, so a group of 4 k is wholly in
    // or out), q by 4 (vec_w: H % 4 == 0 and a 4-byte base: 4 channels); else plain
    // loads.
    auto load = [&](int c, int st) {
        const int k0 = c * F_BK;
        if (vec_x) {
            for (int e = tid; e < ROWS * (F_BK / 4); e += F_THREADS) {
                const int r = e / (F_BK / 4), kk = (e % (F_BK / 4)) * 4;
                const bool ok = m0 + r < M && k0 + kk < K;
                tc::cp_async16(&x_s[st][r][kk], ok ? x + (size_t)(m0 + r) * K + k0 + kk : x,
                               ok ? 16 : 0);
            }
        } else {
            for (int e = tid; e < ROWS * F_BK; e += F_THREADS) {
                const int r = e / F_BK, kk = e % F_BK;
                x_s[st][r][kk] = m0 + r < M && k0 + kk < K ? x[(size_t)(m0 + r) * K + k0 + kk]
                                                            : 0.f;
            }
        }
        if (vec_w) {
            for (int e = tid; e < F_BK * F_CG; e += F_THREADS) {
                const int kk = e / F_CG, n = (e % F_CG) * 4;
                const bool ok = k0 + kk < K && h0 + n < H;
                tc::cp_async4(&q_s[st][kk][n], ok ? q + (size_t)(k0 + kk) * H + h0 + n : q,
                              ok ? 4 : 0);
            }
        } else {
            for (int e = tid; e < F_BK * F_BN; e += F_THREADS) {
                const int kk = e / F_BN, n = e % F_BN;
                q_s[st][kk][n] = k0 + kk < K && h0 + n < H
                                     ? (unsigned char)q[(size_t)(k0 + kk) * H + h0 + n]
                                     : 0;
            }
        }
    };

    // k ascending within the thread (chunks in order, its k in order in a chunk)
    float acc[4] = {};
    if (nch > 0) load(c0, 0);
    tc::cp_async_commit();
    for (int i = 0; i < nch; ++i) {
        if (i + 1 < nch) load(c0 + i + 1, (i + 1) & 1);
        tc::cp_async_commit();
        tc::cp_async_wait<1>();  // chunk i has landed, for this thread
        __syncthreads();         // ... for all
        for (int e = tid; e < F_BK * F_CG; e += F_THREADS) {  // widen q once (exact)
            const int kk = e / F_CG, n = (e % F_CG) * 4;
            const char4 b = *reinterpret_cast<const char4*>(&q_s[i & 1][kk][n]);
            *reinterpret_cast<float4*>(&w_s[kk][n]) = make_float4(b.x, b.y, b.z, b.w);
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < F_BK / KS; ++j) {
            const int kk = ks + KS * j;
            const float4 w = *reinterpret_cast<const float4*>(&w_s[kk][4 * cg]);
            const float xk = x_s[i & 1][row][kk];
            acc[0] = fmaf(xk, w.x, acc[0]);
            acc[1] = fmaf(xk, w.y, acc[1]);
            acc[2] = fmaf(xk, w.z, acc[2]);
            acc[3] = fmaf(xk, w.w, acc[3]);
        }
        __syncthreads();  // slot i & 1 and w_s are free for the next chunk
    }
    tc::cp_async_wait<0>();

    // the block's sums: each tile element adds its k slices in slice order
#pragma unroll
    for (int c = 0; c < 4; ++c) red[(ks * ROWS + row) * F_BN + 4 * cg + c] = acc[c];
    __syncthreads();
    float sum[PER_THREAD];
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
        const int e = tid + j * F_THREADS;
        sum[j] = 0.f;
        if (e < TILE_N) {
            sum[j] = red[e];
#pragma unroll
            for (int s = 1; s < KS; ++s) sum[j] += red[s * TILE_N + e];
        }
    }

    // element e of a tile is (row e / F_BN, channel e % F_BN)
    auto store = [&](int e, float v) {
        const int m = m0 + e / F_BN, hh = h0 + e % F_BN;
        if (e < TILE_N && m < M && hh < H) out[(size_t)m * H + hh] = v * scale[hh];
    };
    if (splits == 1) {
#pragma unroll
        for (int j = 0; j < PER_THREAD; ++j) store(tid + j * F_THREADS, sum[j]);
        return;
    }

    // split-K: this split's partial tile, then the bf16 route's ordered last-block sum
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    float* tile_base = partial + (size_t)tile * splits * TILE_N;
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
        const int e = tid + j * F_THREADS;
        if (e < TILE_N) tile_base[(size_t)split * TILE_N + e] = sum[j];
    }
    __threadfence();  // the partial is visible device-wide before the arrival
    __syncthreads();
    if (tid == 0) {
        const unsigned int arrived = atomicAdd(&arrivals[tile], 1u);
        __threadfence();
        last_block = arrived == (unsigned int)(splits - 1);
        if (last_block) arrivals[tile] = 0;  // every split has arrived: reset for the next launch
    }
    __syncthreads();
    if (!last_block) return;

    // the last block: each float4 of the tile summed over the splits in split order,
    // SUM_BATCH splits' loads in flight at once
    const float4* parts = reinterpret_cast<const float4*>(tile_base);
    float4 tot[F4_PER_THREAD];
#pragma unroll
    for (int j = 0; j < F4_PER_THREAD; ++j) tot[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int p0 = 0; p0 < splits; p0 += SUM_BATCH) {
        float4 v[F4_PER_THREAD][SUM_BATCH];
#pragma unroll
        for (int j = 0; j < F4_PER_THREAD; ++j) {
            const int e = tid + j * F_THREADS;
#pragma unroll
            for (int r = 0; r < SUM_BATCH; ++r)
                v[j][r] = e < TILE_F4 && p0 + r < splits
                              ? __ldcg(parts + (size_t)(p0 + r) * TILE_F4 + e)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int j = 0; j < F4_PER_THREAD; ++j) {
#pragma unroll
            for (int r = 0; r < SUM_BATCH; ++r) {
                if (p0 + r < splits) {  // in split order
                    tot[j].x += v[j][r].x;
                    tot[j].y += v[j][r].y;
                    tot[j].z += v[j][r].z;
                    tot[j].w += v[j][r].w;
                }
            }
        }
    }
#pragma unroll
    for (int j = 0; j < F4_PER_THREAD; ++j) {
        const int e = tid + j * F_THREADS;
        if (e >= TILE_F4) continue;
        store(4 * e, tot[j].x);
        store(4 * e + 1, tot[j].y);
        store(4 * e + 2, tot[j].z);
        store(4 * e + 3, tot[j].w);
    }
}

// -- bf16 route --------------------------------------------------------------

constexpr int TC_BM = 64;                          // activation rows per tile
constexpr int TC_BN = 32;                          // output channels per tile: 8 per warp
constexpr int TC_BK = 64;                          // contraction chunk per stage
constexpr int TC_STAGES = 4;                       // cp.async ring depth
constexpr int TC_THREADS = 128;                    // 4 warps
constexpr int TC_MT = TC_BM / 16;                  // 16-row slices of a tile
constexpr int XS_PITCH = TC_BK + 8;                // bf16 per staged x row (144 B)
constexpr int WS_PITCH = 48;                       // bytes per staged weight row
constexpr int X_STAGE = TC_BM * XS_PITCH;          // bf16 elements per stage
constexpr int W_STAGE = TC_BK * WS_PITCH;          // bytes per stage
constexpr int TC_SMEM = TC_STAGES * (X_STAGE * 2 + W_STAGE);  // 49,152 bytes
constexpr int TILE_F4 = TC_BM * TC_BN / 4;         // float4s in a partial tile
constexpr int F4_PER_THREAD = TILE_F4 / TC_THREADS;

static_assert(TC_BN == 8 * (TC_THREADS / 32), "one 8-channel slice per warp");
static_assert(TILE_F4 % TC_THREADS == 0, "the reduction's split of a tile");

// two int8 weights widened to a bf16 pair (exact), lo in the low half
__device__ __forceinline__ uint32_t widen_pair(unsigned char lo, unsigned char hi) {
    return tc::pack_bf16((float)(int8_t)lo, (float)(int8_t)hi);
}

__device__ __forceinline__ void store_bf16(__nv_bfloat16* out, int M, int H, int m, int h,
                                           float v, const float* __restrict__ scale) {
    if (m < M && h < H) out[(size_t)m * H + h] = __float2bfloat16(v * scale[h]);
}

__global__ void __launch_bounds__(TC_THREADS)
qmm_bf16_splitk_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                       const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
                       float* __restrict__ partial, unsigned int* __restrict__ arrivals,
                       int M, int K, int H, int chunks_per_split, int vec_x, int vec_w) {
    extern __shared__ __align__(16) unsigned char smem[];
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // [stage][BM][XS_PITCH]
    unsigned char* wsm = smem + TC_STAGES * X_STAGE * 2;           // [stage][BK][WS_PITCH]
    __shared__ int last_block;

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int h0 = blockIdx.x * TC_BN, m0 = blockIdx.y * TC_BM;
    const int split = blockIdx.z, splits = gridDim.z;
    const int rows = min(TC_BM, M - m0);            // real rows of this tile
    const int mtiles = (rows + 15) >> 4;             // 16-row slices holding one
    const int c0 = split * chunks_per_split;
    const int nch = min(chunks_per_split, (K + TC_BK - 1) / TC_BK - c0);

    // chunk c (of the whole K axis) into ring slot st; out of range reads as 0
    auto load = [&](int c, int st) {
        const int k0 = c * TC_BK;
        __nv_bfloat16* xd = xs + st * X_STAGE;
        if (vec_x) {  // K % 8 == 0: an 8-element group is wholly in or out
            for (int e = tid; e < TC_BM * (TC_BK / 8); e += TC_THREADS) {
                const int r = e >> 3, kk = (e & 7) * 8;
                const bool ok = r < rows && k0 + kk < K;
                tc::cp_async16(xd + r * XS_PITCH + kk,
                               ok ? x + (size_t)(m0 + r) * K + k0 + kk : x, ok ? 16 : 0);
            }
        } else {
            for (int e = tid; e < TC_BM * TC_BK; e += TC_THREADS) {
                const int r = e / TC_BK, kk = e % TC_BK;
                xd[r * XS_PITCH + kk] = (r < rows && k0 + kk < K)
                                            ? x[(size_t)(m0 + r) * K + k0 + kk]
                                            : __float2bfloat16(0.f);
            }
        }
        unsigned char* wd = wsm + st * W_STAGE;
        if (vec_w) {  // H % 16 == 0: a 16-channel group is wholly in or out
            for (int e = tid; e < TC_BK * (TC_BN / 16); e += TC_THREADS) {
                const int r = e >> 1, n = (e & 1) * 16;
                const bool ok = k0 + r < K && h0 + n < H;
                tc::cp_async16(wd + r * WS_PITCH + n,
                               ok ? q + (size_t)(k0 + r) * H + h0 + n : q, ok ? 16 : 0);
            }
        } else {
            for (int e = tid; e < TC_BK * TC_BN; e += TC_THREADS) {
                const int r = e / TC_BN, n = e % TC_BN;
                wd[r * WS_PITCH + n] = (k0 + r < K && h0 + n < H)
                                           ? (unsigned char)q[(size_t)(k0 + r) * H + h0 + n]
                                           : 0;
            }
        }
    };

    float acc[TC_MT][4] = {};
#pragma unroll
    for (int s = 0; s < TC_STAGES - 1; ++s) {
        if (s < nch) load(c0 + s, s);
        tc::cp_async_commit();
    }
    for (int i = 0; i < nch; ++i) {
        tc::cp_async_wait<TC_STAGES - 2>();  // chunk i has landed, for this thread
        __syncthreads();                     // ... for all; slot (i - 1) is free
        if (i + TC_STAGES - 1 < nch) load(c0 + i + TC_STAGES - 1, (i + TC_STAGES - 1) % TC_STAGES);
        tc::cp_async_commit();

        const __nv_bfloat16* xt = xs + (i % TC_STAGES) * X_STAGE;
        const unsigned char* wt = wsm + (i % TC_STAGES) * W_STAGE + warp * 8 + g;
#pragma unroll
        for (int kk = 0; kk < TC_BK; kk += 16) {
            const unsigned char* wp = wt + (kk + 2 * t) * WS_PITCH;
            const uint32_t b0 = widen_pair(wp[0], wp[WS_PITCH]);
            const uint32_t b1 = widen_pair(wp[8 * WS_PITCH], wp[9 * WS_PITCH]);
#pragma unroll
            for (int mt = 0; mt < TC_MT; ++mt) {
                if (mt < mtiles) {
                    uint32_t a[4];
                    tc::ldmatrix_x4(a, xt + (mt * 16 + (lane & 15)) * XS_PITCH + kk +
                                           (lane >> 4) * 8);
                    tc::mma_bf16(acc[mt], a, b0, b1);
                }
            }
        }
    }
    tc::cp_async_wait<0>();

    const int col = warp * 8 + 2 * t;  // this thread's two channels in the tile
    if (splits == 1) {
#pragma unroll
        for (int mt = 0; mt < TC_MT; ++mt) {
            if (mt >= mtiles) continue;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int m = m0 + mt * 16 + g + 8 * half;
                store_bf16(out, M, H, m, h0 + col, acc[mt][2 * half], scale);
                store_bf16(out, M, H, m, h0 + col + 1, acc[mt][2 * half + 1], scale);
            }
        }
        return;
    }

    // split-K: this split's f32 partial tile, rows < `rows` only
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    float* tile_base = partial + (size_t)tile * splits * (TC_BM * TC_BN);
    float* mine = tile_base + (size_t)split * (TC_BM * TC_BN);
#pragma unroll
    for (int mt = 0; mt < TC_MT; ++mt) {
        if (mt >= mtiles) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int r = mt * 16 + g + 8 * half;
            if (r < rows)
                *reinterpret_cast<float2*>(mine + r * TC_BN + col) =
                    make_float2(acc[mt][2 * half], acc[mt][2 * half + 1]);
        }
    }
    __threadfence();  // the partial is visible device-wide before the arrival
    __syncthreads();
    if (tid == 0) {
        const unsigned int arrived = atomicAdd(&arrivals[tile], 1u);
        __threadfence();
        last_block = arrived == (unsigned int)(splits - 1);
        if (last_block) arrivals[tile] = 0;  // every split has arrived: reset for the next launch
    }
    __syncthreads();
    if (!last_block) return;

    // the last block: sum the partials in split index order, then scale, round, store
    const float4* parts = reinterpret_cast<const float4*>(tile_base);
    float4 sum[F4_PER_THREAD];
#pragma unroll
    for (int j = 0; j < F4_PER_THREAD; ++j) {
        const int e = tid + j * TC_THREADS;
        sum[j] = (e / (TC_BN / 4)) < rows ? __ldcg(parts + e) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll 4
    for (int p = 1; p < splits; ++p) {
#pragma unroll
        for (int j = 0; j < F4_PER_THREAD; ++j) {
            const int e = tid + j * TC_THREADS;
            if ((e / (TC_BN / 4)) < rows) {
                const float4 v = __ldcg(parts + (size_t)p * TILE_F4 + e);
                sum[j].x += v.x;
                sum[j].y += v.y;
                sum[j].z += v.z;
                sum[j].w += v.w;
            }
        }
    }
#pragma unroll
    for (int j = 0; j < F4_PER_THREAD; ++j) {
        const int e = tid + j * TC_THREADS;
        const int m = m0 + e / (TC_BN / 4), h = h0 + (e % (TC_BN / 4)) * 4;
        store_bf16(out, M, H, m, h, sum[j].x, scale);
        store_bf16(out, M, H, m, h + 1, sum[j].y, scale);
        store_bf16(out, M, H, m, h + 2, sum[j].z, scale);
        store_bf16(out, M, H, m, h + 3, sum[j].w, scale);
    }
}

}  // namespace

// Each entry launches one kernel on `stream` (PyTorch's current stream) and
// returns cudaGetLastError() after the launch: nonzero means the launch was
// refused and nothing ran.

// `rows` (a power of two <= 16), `splits` and `chunks_per_split` (chunks of 32 along
// K) come from the wrapper's plan, which also allocates `partial` (f32, tiles x splits
// x rows x 32; unused with one split) and owns `arrivals` (one zeroed counter per
// output tile, left zeroed).
extern "C" int dmt_quant_matmul_f32(const void* x, const void* q, const void* scale, void* out,
                                    void* partial, void* arrivals, int M, int K, int H,
                                    int rows, int splits, int chunks_per_split, int vec_x,
                                    int vec_w, void* stream) {
    const dim3 grid((H + F_BN - 1) / F_BN, (M + rows - 1) / rows, splits);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* xf = static_cast<const float*>(x);
    const int8_t* qi = static_cast<const int8_t*>(q);
    const float* sc = static_cast<const float*>(scale);
    float* o = static_cast<float*>(out);
    float* part = static_cast<float*>(partial);
    unsigned int* arr = static_cast<unsigned int*>(arrivals);
#define DMT_QMM_F32(R)                                                                      \
    qmm_f32_splitk_kernel<R><<<grid, F_THREADS, 0, st>>>(xf, qi, sc, o, part, arr, M, K, H, \
                                                         chunks_per_split, vec_x, vec_w)
    switch (rows) {
        case 1: DMT_QMM_F32(1); break;
        case 2: DMT_QMM_F32(2); break;
        case 4: DMT_QMM_F32(4); break;
        case 8: DMT_QMM_F32(8); break;
        case 16: DMT_QMM_F32(16); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef DMT_QMM_F32
    return static_cast<int>(cudaGetLastError());
}

// `splits` and `chunks_per_split` (chunks of 64 along K) come from the wrapper,
// which also allocates `partial` (f32, tiles x splits x 64 x 32; unused with one
// split) and owns `arrivals` (one zeroed counter per output tile, left zeroed).
extern "C" int dmt_quant_matmul_bf16(const void* x, const void* q, const void* scale,
                                     void* out, void* partial, void* arrivals, int M, int K,
                                     int H, int splits, int chunks_per_split, int vec_x,
                                     int vec_w, void* stream) {
    const cudaError_t err = cudaFuncSetAttribute(
        qmm_bf16_splitk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((H + TC_BN - 1) / TC_BN, (M + TC_BM - 1) / TC_BM, splits);
    qmm_bf16_splitk_kernel<<<grid, TC_THREADS, TC_SMEM, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
        static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out),
        static_cast<float*>(partial), static_cast<unsigned int*>(arrivals), M, K, H,
        chunks_per_split, vec_x, vec_w);
    return static_cast<int>(cudaGetLastError());
}
