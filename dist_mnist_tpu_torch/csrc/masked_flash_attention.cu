// Variable-length (key-prefix masked) flash attention, forward (Hopper, sm_90a).
// Its backward is the dQ and dK/dV kernels of csrc/flash_attention.cu with the
// lengths vector.
//
// Replaces the forward Pallas TPU kernel `_masked_attn_fwd_kernel` of
// dist_mnist_tpu/ops/pallas/flash_attention.py (launched by
// `_masked_flash_fwd_impl`). Query row s of batch row b attends keys
// [0, lengths[b]) of its own row:
//
//   s_k   = dot(f32(q[b, s, h, :]), f32(k[b, key, h, :])) * scale,
//           -1e30 where key >= lengths[b]
//   online softmax over key blocks of BK = 32 (m starts at -1e30, as the
//   TPU kernel's m_scr does); p is rounded to v's dtype before the p @ V
//   product, which accumulates in f32, as the TPU kernel casts p to v.dtype
//   out[b, s, h, :] = acc / l in q's dtype;  visits[b, h, s] = blocks entered;
//   lse[b, h, s] = m + log(l) in f32 when a backward will need it (lse may be
//   null: the decode step passes none, and its output does not depend on it)
//
// Layouts (all contiguous): q [B, Sq, H, D], k and v [B, Sk, H, D], all f32 or
// all bf16; lengths [B] int32 with 1 <= len <= Sk; out like q; visits [B, H, Sq]
// f32. Sq is general (the decode step runs Sq = 1; zoo and ViT serving run
// more rows).
//
// Grid and skipping. One block of 4 warps per (4 query rows, head, batch row);
// each warp owns one query row, and lane i of a warp owns key i of the current
// key block. The block stages a key block of K and V (BK x D, as f32) in
// shared memory, padded by one float per K row so that 32 lanes reading 32
// keys at one dimension hit 32 banks, and every warp scores it against its
// row. Blocks are entered only for kb*BK < len: a key block at or past the
// row's length is neither read nor computed, as the TPU kernel's `pl.when`
// skips its math. Key positions past Sk (the ragged last block) read as zeros
// and are masked like any key past the length.
//
// What bounds it. Each (b, h) reads its active K and V rows once per block of
// 4 query rows and the queries once: at Sq = 1 the work is bytes of the active
// prefix of the cache (2*len*D elements per head) against 4*len*D operations,
// so device-memory bytes bound it, as in the decode step of the serving path
// (B = 9 rows, H = 8, D = 16, Sk = 4096, lengths of a few dozen tokens). For
// large Sq the K/V tile would be better shared by more query rows and fed to
// the tensor cores; that is later work. No --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 4;  // warps per block, one query row each
constexpr int THREADS = ROWS * 32;
constexpr int BK = 32;  // keys per block: one per lane
constexpr int MAX_D = 128;
constexpr int D_PER_LANE = MAX_D / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
// p in v's dtype, back in f32 for the f32 accumulation
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
    return __bfloat162float(__float2bfloat16(x));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
masked_flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int32_t* __restrict__ lengths,
                        T* __restrict__ out, float* __restrict__ visits,
                        float* __restrict__ lse, int Sq, int Sk, int H, int D, float scale) {
    extern __shared__ float smem[];
    float* k_s = smem;                 // [BK][D + 1]
    float* v_s = k_s + BK * (D + 1);   // [BK][D]
    float* q_s = v_s + BK * D;         // [ROWS][D]

    const int b = blockIdx.z;
    const int h = blockIdx.y;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * ROWS + warp;
    const bool live = row < Sq;

    const int len = min(lengths[b], Sk);
    const int blocks = len > 0 ? (len + BK - 1) / BK : 0;

    for (int d = lane; d < D; d += 32)
        q_s[warp * D + d] = live ? to_f32(q[(((size_t)b * Sq + row) * H + h) * D + d]) : 0.f;

    float m = -1e30f;
    float l = 0.f;
    float acc[D_PER_LANE];
#pragma unroll
    for (int i = 0; i < D_PER_LANE; ++i) acc[i] = 0.f;

    for (int kb = 0; kb < blocks; ++kb) {
        for (int e = threadIdx.x; e < BK * D; e += THREADS) {
            const int kk = e / D;
            const int d = e - kk * D;
            const int key = kb * BK + kk;
            float kx = 0.f, vx = 0.f;
            if (key < Sk) {
                const size_t off = (((size_t)b * Sk + key) * H + h) * D + d;
                kx = to_f32(k[off]);
                vx = to_f32(v[off]);
            }
            k_s[kk * (D + 1) + d] = kx;
            v_s[kk * D + d] = vx;
        }
        __syncthreads();  // also publishes q_s on the first block
        if (live) {
            float s = 0.f;
            for (int d = 0; d < D; ++d) s = fmaf(q_s[warp * D + d], k_s[lane * (D + 1) + d], s);
            s = kb * BK + lane < len ? s * scale : -1e30f;
            float m_blk = s;
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
                m_blk = fmaxf(m_blk, __shfl_xor_sync(0xffffffffu, m_blk, o));
            const float m_new = fmaxf(m, m_blk);
            const float alpha = expf(m - m_new);
            const float p = expf(s - m_new);
            float p_sum = p;
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) p_sum += __shfl_xor_sync(0xffffffffu, p_sum, o);
            l = l * alpha + p_sum;
            const float p_v = round_to(p, T());
#pragma unroll
            for (int i = 0; i < D_PER_LANE; ++i) acc[i] *= alpha;
            for (int kk = 0; kk < BK; ++kk) {
                const float pk = __shfl_sync(0xffffffffu, p_v, kk);
#pragma unroll
                for (int i = 0; i < D_PER_LANE; ++i) {
                    const int d = lane + 32 * i;
                    if (d < D) acc[i] = fmaf(pk, v_s[kk * D + d], acc[i]);
                }
            }
            m = m_new;
        }
        __syncthreads();  // the next block overwrites k_s / v_s
    }
    if (live) {
#pragma unroll
        for (int i = 0; i < D_PER_LANE; ++i) {
            const int d = lane + 32 * i;
            if (d < D) store_out(out + (((size_t)b * Sq + row) * H + h) * D + d, acc[i] / l);
        }
        if (lane == 0) visits[((size_t)b * H + h) * Sq + row] = (float)blocks;
        if (lse && lane == 0) lse[((size_t)b * H + h) * Sq + row] = m + logf(l);
    }
}

}  // namespace

// Launch on `stream` (PyTorch's current stream). Returns cudaGetLastError()
// after the launch: nonzero means the launch was refused and nothing ran.
extern "C" int dmt_masked_flash_attention(const void* q, const void* k, const void* v,
                                          const void* lengths, void* out, void* visits,
                                          void* lse, int B, int Sq, int Sk, int H, int D,
                                          int is_bf16, float scale, void* stream) {
    const dim3 grid((Sq + ROWS - 1) / ROWS, H, B);
    const size_t smem = sizeof(float) * (BK * (D + 1) + BK * D + ROWS * D);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int32_t* lens = static_cast<const int32_t*>(lengths);
    float* vis = static_cast<float*>(visits);
    float* ls = static_cast<float*>(lse);
    if (is_bf16) {
        masked_flash_fwd_kernel<__nv_bfloat16><<<grid, THREADS, smem, s>>>(
            static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
            static_cast<const __nv_bfloat16*>(v), lens, static_cast<__nv_bfloat16*>(out), vis,
            ls, Sq, Sk, H, D, scale);
    } else {
        masked_flash_fwd_kernel<float><<<grid, THREADS, smem, s>>>(
            static_cast<const float*>(q), static_cast<const float*>(k),
            static_cast<const float*>(v), lens, static_cast<float*>(out), vis, ls, Sq, Sk,
            H, D, scale);
    }
    return static_cast<int>(cudaGetLastError());
}
