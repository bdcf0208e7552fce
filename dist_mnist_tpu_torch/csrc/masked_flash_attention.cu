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
// Layouts (all contiguous): q [B, 1, H, D], k and v [B, Sk, H, D], all f32 or all
// bf16; lengths [B] int32 with 1 <= len <= Sk; out like q; visits [B, H, 1] f32.
//
// This file holds the Sq = 1 route, the decode step (`masked_flash_decode_kernel`).
// One warp owns one (b, h) (csrc/decode_attention.cuh: G lanes a key, 16 dimensions a
// lane; at the decode path's D = 16 lane i owns key i of a 32-key block, and at D = 64
// four lanes share a key and a block takes four slices). A key at or past the row's
// length is never read; visits count the 32-key blocks entered, ceil(len / 32). At
// the serving path's shapes (B = 9, H = 8, D = 16, Sk = 4096, lengths of a few dozen)
// the bytes are a few hundred KB and the time goes to dependent memory round trips,
// so: the length and q are loaded together; a lane's K and V rows are requested
// together as 16-byte vectors (four float4 each in f32, two in bf16 at D = 16), slice
// c + 2's before slice c's arithmetic (a register ring); each lane runs its own online
// softmax over its keys, and the lanes are merged once at the end by fixed butterflies
// (`decode::finish`, which also gives the lse's max and sum). No barrier.
//
// Sq > 1 (zoo and ViT masked buckets, and the lse the masked backward reads) runs the
// flash forward kernels of csrc/flash_attention.cu with the lengths vector and the
// streamed rule: `flash_fwd_mma_onepass` (bf16, Sk <= 128) or `flash_fwd_mma_tiled`
// (bf16 above) on the tensor cores, `flash_fwd_f32` (f32) on the CUDA cores, each
// block of query rows staging K and V once for all its rows and entering no 32-key
// group at or past a row's length (ops/kernels/masked_flash.py routes the call).
//
// What bounds it. At Sq = 1 the work is bytes of the active prefix of the cache
// (2*len*D elements per head) against 4*len*D operations, so device-memory bytes
// bound it. No --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decode_attention.cuh"

namespace {

constexpr int BK = 32;  // keys per visit: the skip granularity

// p in v's dtype, back in f32 for the f32 accumulation
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
    return __bfloat162float(__float2bfloat16(x));
}

// Sq = 1: one warp per (b, h), G lanes a key, two slices of rows in flight ahead
// of the arithmetic (see the header).
template <typename T, int G, bool VEC>
__global__ void __launch_bounds__(decode::THREADS)
masked_flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const int32_t* __restrict__ lengths,
                           T* __restrict__ out, float* __restrict__ visits,
                           float* __restrict__ lse, int Sk, int H, int D, float scale) {
    constexpr int SLICE = 32 / G;                                       // keys a warp takes at a time
    constexpr int NW = decode::DIMS * static_cast<int>(sizeof(T)) / 4;  // words of a lane's share
    using Raw = decode::Raw<NW>;
    struct Row {
        Raw k, v;
    };
    const int h = blockIdx.x;
    const int b = blockIdx.y;
    const int lane = threadIdx.x;
    const int slot = lane / G;                 // key of the slice
    const int d0 = (lane % G) * decode::DIMS;  // first dimension this lane holds
    const int dn = min(decode::DIMS, D - d0);  // dimensions it holds (<= 0: none)
    const size_t bh = static_cast<size_t>(b) * H + h;
    // this lane's share of key `slot`, and how far a slice moves it
    const size_t first = ((static_cast<size_t>(b) * Sk + slot) * H + h) * D + d0;
    const size_t stride = static_cast<size_t>(SLICE) * H * D;

    // requested together: the length and q
    const int len = min(lengths[b], Sk);
    float qf[decode::DIMS];
    const T* q_row = q + bh * D + d0;
#pragma unroll
    for (int e = 0; e < decode::DIMS; ++e) qf[e] = e < dn ? decode::to_f32(q_row[e]) : 0.f;
    const int slices = len > 0 ? (len + SLICE - 1) / SLICE : 0;
    const int blocks = len > 0 ? (len + BK - 1) / BK : 0;

    auto admitted = [&](int key) { return key < len; };  // keys at or past the length: never read
    // this lane's share of key `c * SLICE + slot`'s K and V rows, zeros if not admitted
    auto load = [&](int c) -> Row {
        Row x;
        if (admitted(c * SLICE + slot)) {
            const size_t off = first + static_cast<size_t>(c) * stride;
            if constexpr (VEC) {
                if (dn > 0) {
                    decode::load_vec(x.k, k + off);
                    decode::load_vec(x.v, v + off);
                } else {
                    x.k = Raw{};
                    x.v = Raw{};
                }
            } else {
                decode::load_each(x.k, k + off, dn);
                decode::load_each(x.v, v + off, dn);
            }
        } else {
            x.k = Raw{};
            x.v = Raw{};
        }
        return x;
    };

    float m = -1e30f;  // this lane's running max, as the TPU kernel's m_scr starts
    float l = 0.f;     // its running denominator, relative to m
    float acc[decode::DIMS];  // its running p @ V, dimensions d0 .., relative to m
#pragma unroll
    for (int e = 0; e < decode::DIMS; ++e) acc[e] = 0.f;

    Row cur = load(0);
    Row next = load(1);
    for (int c = 0; c < slices; ++c) {
        const Row after = load(c + 2);  // before any arithmetic on this slice
        const bool live = admitted(c * SLICE + slot);
        float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int e = 0; e < decode::DIMS; ++e)
            part[e & 3] = fmaf(qf[e], decode::elem(cur.k, e, T()), part[e & 3]);
        // every lane: the butterfly needs the whole warp
        const float dot = decode::token_sum<G>((part[0] + part[1]) + (part[2] + part[3]));
        const float s = dot * scale;
        // this lane's own online softmax; a lane without a live token keeps its state
        const float m_new = live ? fmaxf(m, s) : m;
        const float alpha = live ? expf(m - m_new) : 1.f;
        const float p = live ? expf(s - m_new) : 0.f;
        l = l * alpha + p;
        const float p_v = round_to(p, T());
#pragma unroll
        for (int e = 0; e < decode::DIMS; ++e)
            acc[e] = fmaf(p_v, decode::elem(cur.v, e, T()), acc[e] * alpha);
        m = m_new;
        cur = next;
        next = after;
    }

    const float2 m_l = decode::finish<G>(m, l, acc, out + bh * D + d0, dn, lane);
    if (lane == 0) {
        visits[bh] = static_cast<float>(blocks);
        if (lse) lse[bh] = m_l.x + logf(m_l.y);
    }
}

// The empty kernel with the decode route's arguments: the launch floor.
__global__ void masked_flash_empty(const void*, const void*, const void*, const void*, void*,
                                   void*, void*, int, int, int, int, float) {}

template <typename T, int G>
void launch_decode_g(bool vec, dim3 grid, cudaStream_t s, const void* q, const void* k,
                     const void* v, const int32_t* lens, void* out, float* vis, float* ls,
                     int Sk, int H, int D, float scale) {
    const T* qt = static_cast<const T*>(q);
    const T* kt = static_cast<const T*>(k);
    const T* vt = static_cast<const T*>(v);
    T* ot = static_cast<T*>(out);
    if (vec)
        masked_flash_decode_kernel<T, G, true><<<grid, decode::THREADS, 0, s>>>(
            qt, kt, vt, lens, ot, vis, ls, Sk, H, D, scale);
    else
        masked_flash_decode_kernel<T, G, false><<<grid, decode::THREADS, 0, s>>>(
            qt, kt, vt, lens, ot, vis, ls, Sk, H, D, scale);
}

template <typename T>
void launch_decode(int G, bool vec, dim3 grid, cudaStream_t s, const void* q, const void* k,
                   const void* v, const int32_t* lens, void* out, float* vis, float* ls, int Sk,
                   int H, int D, float scale) {
    switch (G) {
        case 1: launch_decode_g<T, 1>(vec, grid, s, q, k, v, lens, out, vis, ls, Sk, H, D, scale); break;
        case 2: launch_decode_g<T, 2>(vec, grid, s, q, k, v, lens, out, vis, ls, Sk, H, D, scale); break;
        case 4: launch_decode_g<T, 4>(vec, grid, s, q, k, v, lens, out, vis, ls, Sk, H, D, scale); break;
        default: launch_decode_g<T, 8>(vec, grid, s, q, k, v, lens, out, vis, ls, Sk, H, D, scale); break;
    }
}

}  // namespace

// Lanes per key, grid (H, B) and threads of the Sq = 1 route on B rows, H heads,
// head_dim D (`decode::plan`; the wrapper's `decode_launch_plan` computes the same).
extern "C" void dmt_masked_flash_decode_plan(int B, int H, int D, int* out) {
    decode::plan(B, H, D, out);
}

// Launch `masked_flash_decode_kernel` on `stream` (PyTorch's current stream). Returns
// cudaGetLastError() after the launch: nonzero means the launch was refused and
// nothing ran. Sq must be 1 (cudaErrorInvalidValue else): the wrapper sends Sq > 1 to
// the flash forward entry of csrc/flash_attention.cu.
extern "C" int dmt_masked_flash_attention(const void* q, const void* k, const void* v,
                                          const void* lengths, void* out, void* visits,
                                          void* lse, int B, int Sq, int Sk, int H, int D,
                                          int is_bf16, float scale, void* stream) {
    if (Sq != 1) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int32_t* lens = static_cast<const int32_t*>(lengths);
    float* vis = static_cast<float*>(visits);
    float* ls = static_cast<float*>(lse);
    int plan[4];
    decode::plan(B, H, D, plan);
    const dim3 grid(plan[1], plan[2]);
    // 16-byte loads need 16-byte aligned rows: D a multiple of 16, aligned k and v
    const bool vec = D % 16 == 0 &&
                     ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) & 15) == 0;
    if (is_bf16)
        launch_decode<__nv_bfloat16>(plan[0], vec, grid, s, q, k, v, lens, out, vis, ls, Sk, H,
                                     D, scale);
    else
        launch_decode<float>(plan[0], vec, grid, s, q, k, v, lens, out, vis, ls, Sk, H, D,
                             scale);
    return static_cast<int>(cudaGetLastError());
}

// The same arguments into an empty kernel of the decode route's grid and block: what a
// launch costs before the kernel does anything. Sq must be 1, as above.
extern "C" int dmt_masked_flash_attention_empty(const void* q, const void* k, const void* v,
                                                const void* lengths, void* out, void* visits,
                                                void* lse, int B, int Sq, int Sk, int H, int D,
                                                int is_bf16, float scale, void* stream) {
    (void)is_bf16;
    if (Sq != 1) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    int plan[4];
    decode::plan(B, H, D, plan);
    masked_flash_empty<<<dim3(plan[1], plan[2]), plan[3], 0, s>>>(q, k, v, lengths, out, visits,
                                                                  lse, B, Sk, H, D, scale);
    return static_cast<int>(cudaGetLastError());
}
