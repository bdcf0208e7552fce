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
// at M = 64, and 205 MFLOP — far below the card's ridge point, so the bound is
// the int8 weight bytes over device-memory bandwidth. The design serves that
// bound first: the weight stays int8 in device memory and is widened to f32
// only in shared memory, so it is read at one byte per element and never
// written back; every weight tile is read once per block of rows, and at
// M <= 32 once in all.
//
// Design. The TPU kernel keeps the whole contraction resident in VMEM
// ([bm, D] activations and [D, 128] weights); that does not fit a Hopper
// block at D = 3136, so this kernel loops over K instead:
//   * one block per (BN output channels, BM rows) tile, 128 threads;
//   * each K step stages a BM x BK activation chunk (transposed, as f32) and
//     a BK x BN int8 weight chunk (as f32) in shared memory; global loads are
//     coalesced along K for x and along H for q, and the next chunk's loads
//     are issued into registers before the current chunk is computed, so
//     their latency hides behind the FMAs;
//   * each thread keeps a TM x TN micro-tile of f32 accumulators in registers
//     and sums over k in order (fmaf), so a given input always gives the same
//     bits;
//   * the epilogue multiplies by scale[h], rounds to T (__float2bfloat16 is
//     round-to-nearest-even, as torch's cast) and masks the ragged M and H
//     edges (H = 10 for fc2).
// Tensor cores (mma.sync / wgmma), split-K and filling all 132 SMs at M <= 64
// are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
qmm_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
           const float* __restrict__ scale, T* __restrict__ out,
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
            xr[i] = (m < M && k < K) ? to_f32(x[(size_t)m * K + k]) : 0.f;
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
            if (m < M) store_out(&out[(size_t)m * H + h], acc[i][j] * s);
        }
    }
}

}  // namespace

// Launch on `stream` (PyTorch's current stream). Returns cudaGetLastError()
// after the launch: nonzero means the launch was refused and nothing ran.
extern "C" int dmt_quant_matmul(const void* x, const void* q, const void* scale,
                                void* out, int M, int K, int H, int x_is_bf16,
                                void* stream) {
    const dim3 grid((H + BN - 1) / BN, (M + BM - 1) / BM);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (x_is_bf16) {
        qmm_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
            static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
            static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out),
            M, K, H);
    } else {
        qmm_kernel<float><<<grid, THREADS, 0, s>>>(
            static_cast<const float*>(x), static_cast<const int8_t*>(q),
            static_cast<const float*>(scale), static_cast<float*>(out), M, K, H);
    }
    return static_cast<int>(cudaGetLastError());
}
