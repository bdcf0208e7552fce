// Paged-attention decode step over an int8 KV page pool (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel `_paged_attn_kernel` of
// dist_mnist_tpu/ops/pallas/paged_attention.py (launched by
// `_paged_attention_impl`). One query token per row r attends the first
// `lengths[r]` positions of its page-table view:
//
//   for page j of row r (pool page table[r, j]), token t, position j*T + t:
//       k   = f32(kq[page, t, h, :]) * ks[page, t, h]       (dequant in registers)
//       s   = dot(f32(q[r, h, :]), k) * scale,  s = -1e30 where j*T + t >= len
//       online softmax over all visited positions (m starts at -inf)
//       acc = sum p * (f32(vq[page, t, h, :]) * vs[page, t, h])
//   out[r, h, :] = acc / l  in q's dtype;  visits[r, h] = pages visited
//
// Layouts (all contiguous): q [R, H, D] f32 or bf16; kq, vq [P, T, H, D] int8;
// ks, vs [P, T, H] f32 (the pools' [.., 1] scale axis); table [R, n] int32;
// lengths [R] int32; out [R, H, D] like q; visits [R, H] f32.
//
// Grid and skipping. The TPU kernel runs a sequential grid over (r, h, page)
// and still DMAs pages past the length (it only skips their math). Here one
// block of 128 threads owns one (r, h) and loops over its pages in order, and
// only over j < min(n, ceil(len / T)): a page at or past the length is never
// read. Nothing carries between blocks, so no cross-block reduction is
// needed. Page ids are clamped into [0, P) so a bad table cannot read outside
// the pool; lengths must be 1 <= len <= n*T, as in the reference.
//
// Inside a page the block takes T tokens at a time (128 per tile): thread i
// scores token i (a D-long dot over its int8 row, dequantized in registers),
// block reductions give the tile's max and sum, and thread d < D then
// accumulates dimension d of p @ V over the tile. The running max, sum and
// accumulator live in registers across pages, as the TPU kernel keeps them in
// VMEM scratch across its grid steps.
//
// What bounds it. The decode step reads each active page's int8 K and V tiles
// and f32 scales once per (row, head): (D + 4) bytes per token per head for K
// and the same for V, against 4*D operations per token — far below the card's
// operations per byte, so device-memory bytes bound it. At the serving path's
// shapes (R = 9, H = 8, D = 16, T = 32, a few pages per row) the work is a few
// hundred KB, so launch latency and the serial page loop of each block bound
// it in practice; a split over pages with a second merge pass is later work.
// No --use_fast_math: expf and the final division are IEEE-accurate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_D = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Block-wide max / sum; every thread gets the result. `red` holds WARPS
// floats; the trailing barrier lets the next reduction reuse it.
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    float r = red[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) r = fmaxf(r, red[w]);
    __syncthreads();
    return r;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    float r = red[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) r += red[w];
    __syncthreads();
    return r;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_attn_kernel(const T* __restrict__ q, const int8_t* __restrict__ kq,
                  const float* __restrict__ ks, const int8_t* __restrict__ vq,
                  const float* __restrict__ vs, const int32_t* __restrict__ table,
                  const int32_t* __restrict__ lengths, T* __restrict__ out,
                  float* __restrict__ visits, int H, int D, int Tp, int P, int n,
                  float scale) {
    const int h = blockIdx.x;
    const int r = blockIdx.y;
    const int tid = threadIdx.x;

    __shared__ float q_s[MAX_D];
    __shared__ float p_s[THREADS];
    __shared__ float red[WARPS];

    for (int d = tid; d < D; d += THREADS) q_s[d] = to_f32(q[((size_t)r * H + h) * D + d]);
    const int len = lengths[r];
    const int active = len > 0 ? min(n, (len + Tp - 1) / Tp) : 0;
    __syncthreads();

    float m = -INFINITY;  // running max, as the TPU kernel's m_scr starts
    float l = 0.f;        // running denominator
    float acc = 0.f;      // thread d < D: dimension d of the running p @ V

    for (int j = 0; j < active; ++j) {
        const int page = min(max(table[(size_t)r * n + j], 0), P - 1);
        const size_t page_row = (size_t)page * Tp;
        for (int t0 = 0; t0 < Tp; t0 += THREADS) {
            const int t = t0 + tid;
            const int nt = min(THREADS, Tp - t0);
            float s = -INFINITY;  // no token in this lane of the tile
            if (t < Tp) {
                const size_t row = (page_row + t) * H + h;
                const int8_t* k_row = kq + row * D;
                const float k_scale = ks[row];
                float dot = 0.f;
                for (int d = 0; d < D; ++d)
                    dot = fmaf(q_s[d], __fmul_rn((float)k_row[d], k_scale), dot);
                s = j * Tp + t < len ? dot * scale : -1e30f;
            }
            const float m_new = fmaxf(m, block_max(s, red));
            const float alpha = expf(m - m_new);
            const float p = t < Tp ? expf(s - m_new) : 0.f;
            p_s[tid] = p;
            l = l * alpha + block_sum(p, red);  // its barriers publish p_s
            if (tid < D) {
                float pv = 0.f;
                for (int i = 0; i < nt; ++i) {
                    const size_t row = (page_row + t0 + i) * H + h;
                    pv = fmaf(p_s[i], __fmul_rn((float)vq[row * D + tid], vs[row]), pv);
                }
                acc = acc * alpha + pv;
            }
            m = m_new;
            __syncthreads();  // p_s is rewritten by the next tile
        }
    }
    if (tid < D) store_out(out + ((size_t)r * H + h) * D + tid, acc / l);
    if (tid == 0) visits[(size_t)r * H + h] = (float)active;
}

}  // namespace

// Launch on `stream` (PyTorch's current stream). Returns cudaGetLastError()
// after the launch: nonzero means the launch was refused and nothing ran.
extern "C" int dmt_paged_attention(const void* q, const void* kq, const void* ks,
                                   const void* vq, const void* vs, const void* table,
                                   const void* lengths, void* out, void* visits, int R,
                                   int H, int D, int Tp, int P, int n, int q_is_bf16,
                                   float scale, void* stream) {
    const dim3 grid(H, R);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int8_t* kq8 = static_cast<const int8_t*>(kq);
    const int8_t* vq8 = static_cast<const int8_t*>(vq);
    const float* ksf = static_cast<const float*>(ks);
    const float* vsf = static_cast<const float*>(vs);
    const int32_t* tab = static_cast<const int32_t*>(table);
    const int32_t* lens = static_cast<const int32_t*>(lengths);
    float* vis = static_cast<float*>(visits);
    if (q_is_bf16) {
        paged_attn_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
            static_cast<const __nv_bfloat16*>(q), kq8, ksf, vq8, vsf, tab, lens,
            static_cast<__nv_bfloat16*>(out), vis, H, D, Tp, P, n, scale);
    } else {
        paged_attn_kernel<float><<<grid, THREADS, 0, s>>>(
            static_cast<const float*>(q), kq8, ksf, vq8, vsf, tab, lens,
            static_cast<float*>(out), vis, H, D, Tp, P, n, scale);
    }
    return static_cast<int>(cudaGetLastError());
}
