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
// f32 (`qmm_f32_kernel`): the f32 products must stay full f32 (TF32 would cut
// the activations), so this route is CUDA-core FMAs: one block per (32-row,
// 16-channel) tile, 128 threads, K in chunks of 32 staged as f32 in shared
// memory with the next chunk's loads in flight, a 2 x 2 micro-tile of f32
// accumulators per thread summed over k in order (fmaf).
//
// Both epilogues round with __float2bfloat16 (round-to-nearest-even, as
// torch's cast) or store f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

// -- f32 route ---------------------------------------------------------------

constexpr int BM = 32;                             // activation rows per block
constexpr int BN = 16;                             // output channels per block
constexpr int BK = 32;                             // contraction chunk per step
constexpr int TM = 2;                              // rows per thread
constexpr int TN = 2;                              // channels per thread
constexpr int THREADS = (BM / TM) * (BN / TN);     // 128
constexpr int X_PER_THREAD = BM * BK / THREADS;    // 8
constexpr int W_PER_THREAD = BK * BN / THREADS;    // 4
constexpr int XS_LD = BM + 2;                      // padded, keeps float2 alignment

static_assert(BM * BK % THREADS == 0 && BK * BN % THREADS == 0, "tile split");
static_assert(TM == 2 && TN == 2, "the inner loop reads float2 pairs");

__global__ void __launch_bounds__(THREADS)
qmm_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
               const float* __restrict__ scale, float* __restrict__ out,
               int M, int K, int H) {
    __shared__ __align__(16) float xs[BK][XS_LD];  // x chunk, transposed: xs[k][m]
    __shared__ __align__(16) float ws[BK][BN];     // weight chunk: ws[k][h]

    const int tid = threadIdx.x;
    const int tx = tid % (BN / TN);  // channel group
    const int ty = tid / (BN / TN);  // row group
    const int m0 = blockIdx.y * BM;
    const int h0 = blockIdx.x * BN;

    float xr[X_PER_THREAD];
    float wr[W_PER_THREAD];

    // Global -> registers for the chunk starting at k0. Consecutive threads
    // take consecutive k (x) and consecutive h (q): coalesced along the
    // contiguous axis of each operand. Out-of-range elements load as 0.
    auto load_chunk = [&](int k0) {
#pragma unroll
        for (int i = 0; i < X_PER_THREAD; ++i) {
            const int e = tid + i * THREADS;
            const int m = m0 + e / BK, k = k0 + e % BK;
            xr[i] = (m < M && k < K) ? x[(size_t)m * K + k] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < W_PER_THREAD; ++i) {
            const int e = tid + i * THREADS;
            const int k = k0 + e / BN, h = h0 + e % BN;
            wr[i] = (k < K && h < H) ? (float)q[(size_t)k * H + h] : 0.f;
        }
    };

    float acc[TM][TN] = {};
    load_chunk(0);
    for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
        for (int i = 0; i < X_PER_THREAD; ++i) {
            const int e = tid + i * THREADS;
            xs[e % BK][e / BK] = xr[i];
        }
#pragma unroll
        for (int i = 0; i < W_PER_THREAD; ++i) {
            const int e = tid + i * THREADS;
            ws[e / BN][e % BN] = wr[i];
        }
        __syncthreads();
        if (k0 + BK < K) load_chunk(k0 + BK);  // in flight during the FMAs below
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            const float2 a = *reinterpret_cast<const float2*>(&xs[kk][ty * TM]);
            const float2 b = *reinterpret_cast<const float2*>(&ws[kk][tx * TN]);
            acc[0][0] = fmaf(a.x, b.x, acc[0][0]);
            acc[0][1] = fmaf(a.x, b.y, acc[0][1]);
            acc[1][0] = fmaf(a.y, b.x, acc[1][0]);
            acc[1][1] = fmaf(a.y, b.y, acc[1][1]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < TN; ++j) {
        const int h = h0 + tx * TN + j;
        if (h >= H) continue;
        const float s = scale[h];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
            const int m = m0 + ty * TM + i;
            if (m < M) out[(size_t)m * H + h] = acc[i][j] * s;
        }
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

extern "C" int dmt_quant_matmul_f32(const void* x, const void* q, const void* scale, void* out,
                                    int M, int K, int H, void* stream) {
    const dim3 grid((H + BN - 1) / BN, (M + BM - 1) / BM);
    qmm_f32_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(q),
        static_cast<const float*>(scale), static_cast<float*>(out), M, K, H);
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
