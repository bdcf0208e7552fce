// Shared pieces of the two decode kernels (Hopper, sm_90a): `paged_attn_kernel`
// (csrc/paged_attention.cu) and `masked_flash_decode_kernel`, the Sq = 1 route of
// csrc/masked_flash_attention.cu.
//
// Layout. One warp owns one (row, head) and is a block of its own: the grid is
// (heads, rows), so no index is divided out and no barrier is needed, and the
// warps of a call spread over the SMs (the decode path's 72 warps take 72 SMs,
// each with its own L1 and path to L2). G = lanes_per_row(D) lanes share one
// token (or key), each holding DIMS = 16 of its dimensions, so a warp takes
// SLICE = 32 / G tokens at a time: lane i owns token i of the slice at D <= 16
// (the decode path's D = 16), and G = 2, 4, 8 take D up to 32, 64, 128.
//
// Latency. Nothing here is bound by bytes or operations at decode shapes: a
// warp's time is its chain of dependent memory round trips and instructions. So
// the kernels load the length, q and what addresses the first rows before any
// of it is used, keep two slices of rows in flight (a register ring: the loads
// of slice c + 2 are requested before the arithmetic of slice c), and walk
// positions without integer division.
//
// Softmax state. Each lane runs its own online softmax over the tokens it holds
// (its running max m, and l and p @ V relative to it), so the loop over slices
// needs no shuffle at D <= 16 (G lanes of a token sum their partial scores
// first). After the loop `finish` rescales every lane's l and p @ V to the warp's
// max, sums l over the lanes, and sums p @ V by a reduce-scatter butterfly: each
// step sends half of a lane's values to its partner, so 16 values take 16
// shuffles instead of 80 and leave each lane with G / 2 dimensions (one at
// G <= 2), which it divides by l and stores; no lane divides more than four.
//
// Order. Every sum across lanes is a butterfly over offsets fixed by the code, so
// the same inputs give the same bits on every call and stream, and both lanes of
// a pair end with the same value (float addition commutes).
//
// Raw rows. A lane's 16 elements of a row travel as 32-bit words (`Raw`): int8 K/V
// rows as 4 words, f32 rows as 16, bf16 rows as 8. With 16-byte aligned rows whose
// length is a multiple of 16 elements, each 16 bytes is one vector load; otherwise
// the lane loads its elements one by one (the tail past D reads as zeros).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace decode {

constexpr int THREADS = 32;  // one warp a block
constexpr int DIMS = 16;     // dimensions a lane holds
constexpr unsigned FULL = 0xffffffffu;

// Lanes per token: the power of two that covers D in blocks of DIMS (D <= 128).
inline int lanes_per_row(int D) {
    int g = 1;
    while (g * DIMS < D) g *= 2;
    return g;
}

// The launch plan both C entries use and export: lanes per token, the grid
// (heads, rows) and the threads of a block.
inline void plan(int rows, int heads, int D, int* out) {
    out[0] = lanes_per_row(D);
    out[1] = heads;
    out[2] = rows;
    out[3] = THREADS;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <int NW>
struct Raw {
    uint32_t w[NW];
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
    return v;
}

// Sum over the G lanes of one token (offsets 1 .. G/2).
template <int G>
__device__ __forceinline__ float token_sum(float v) {
#pragma unroll
    for (int o = 1; o < G; o <<= 1) v += __shfl_xor_sync(FULL, v, o);
    return v;
}

// Sum over the lanes that hold the same dimensions of the slice's tokens
// (offsets G .. 16).
template <int G>
__device__ __forceinline__ float slice_sum(float v) {
#pragma unroll
    for (int o = G; o < 32; o <<= 1) v += __shfl_xor_sync(FULL, v, o);
    return v;
}

// One step of `reduce_scatter` at lane offset O with N values left, then the
// rest: templates, so every index is a constant and the values stay in registers.
template <int G, int O, int N>
__device__ __forceinline__ void reduce_step(float (&v)[DIMS], int lane, int& base) {
    if constexpr (O >= G) {
        if constexpr (N > 1) {
            constexpr int HALF = N / 2;
            const bool upper = (lane & O) != 0;
#pragma unroll
            for (int i = 0; i < HALF; ++i) {
                const float send = upper ? v[i] : v[i + HALF];
                const float keep = upper ? v[i + HALF] : v[i];
                v[i] = keep + __shfl_xor_sync(FULL, send, O);
            }
            base += upper ? HALF : 0;
            reduce_step<G, O / 2, HALF>(v, lane, base);
        } else {
            v[0] += __shfl_xor_sync(FULL, v[0], O);
            reduce_step<G, O / 2, 1>(v, lane, base);
        }
    }
}

// Sum a lane's DIMS values over the lanes that hold the same dimensions (offsets
// 16 .. G), halving the values a lane keeps at each step: the lower lane of a
// pair keeps the lower half. Returns the dimension (from the lane's first) of
// v[0]; the lane then holds the sums of dimensions base .. base + K - 1 in
// v[0 .. K), K = max(1, G / 2). At G = 1 the last offset has one value left, so
// lanes 2i and 2i + 1 end with the same sum.
template <int G>
__device__ __forceinline__ int reduce_scatter(float (&v)[DIMS], int lane) {
    int base = 0;
    reduce_step<G, 16, DIMS>(v, lane, base);
    return base;
}

// The end of a decode kernel: merge the lanes' softmax states (m, l, acc as in
// "Softmax state" above) and store out = acc / l for the dimensions this lane
// holds after `reduce_scatter` (out_row points at dimension d0 of the row, dn
// of them). Returns the warp's max and the total l, for the lse.
template <int G, typename T>
__device__ __forceinline__ float2 finish(float m, float l, float (&acc)[DIMS], T* out_row,
                                         int dn, int lane) {
    constexpr int K = G >= 2 ? G / 2 : 1;  // dimensions a lane stores
    const float m_all = warp_max(m);
    const float f = expf(m - m_all);  // 0 for a lane that never saw a live token
    const float l_all = slice_sum<G>(l * f);
#pragma unroll
    for (int e = 0; e < DIMS; ++e) acc[e] *= f;
    const int base = reduce_scatter<G>(acc, lane);
    if (G > 1 || (lane & 1) == 0) {
#pragma unroll
        for (int i = 0; i < K; ++i)
            if (base + i < dn) store_out(out_row + base + i, acc[i] / l_all);
    }
    return make_float2(m_all, l_all);
}

// NW / 4 vector loads of 16 bytes each from a 16-byte aligned address.
template <int NW>
__device__ __forceinline__ void load_vec(Raw<NW>& raw, const void* src) {
    const uint4* p = static_cast<const uint4*>(src);
#pragma unroll
    for (int i = 0; i < NW / 4; ++i) {
        const uint4 x = __ldg(p + i);
        raw.w[4 * i] = x.x;
        raw.w[4 * i + 1] = x.y;
        raw.w[4 * i + 2] = x.z;
        raw.w[4 * i + 3] = x.w;
    }
}

// Element e of a lane's row, in f32. int8: 4 per word; f32: 1; bf16: 2 (the
// lower index in the low half), widened exactly.
__device__ __forceinline__ float elem_i8(const Raw<4>& raw, int e) {
    return static_cast<float>(static_cast<int8_t>((raw.w[e >> 2] >> (8 * (e & 3))) & 0xffu));
}
__device__ __forceinline__ float elem(const Raw<16>& raw, int e, float) {
    return __uint_as_float(raw.w[e]);
}
__device__ __forceinline__ float elem(const Raw<8>& raw, int e, __nv_bfloat16) {
    const uint32_t w = raw.w[e >> 1];
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
}

// Element by element, for rows that are not 16-byte aligned or not a multiple of
// 16 elements long: elements at or past `n` read as zero.
__device__ __forceinline__ void load_each(Raw<4>& raw, const int8_t* src, int n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) raw.w[i] = 0u;
#pragma unroll
    for (int e = 0; e < DIMS; ++e)
        if (e < n) raw.w[e >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(src[e])) << (8 * (e & 3));
}
__device__ __forceinline__ void load_each(Raw<16>& raw, const float* src, int n) {
#pragma unroll
    for (int e = 0; e < DIMS; ++e) raw.w[e] = e < n ? __float_as_uint(src[e]) : 0u;
}
__device__ __forceinline__ void load_each(Raw<8>& raw, const __nv_bfloat16* src, int n) {
    const uint16_t* s = reinterpret_cast<const uint16_t*>(src);
#pragma unroll
    for (int i = 0; i < 8; ++i) raw.w[i] = 0u;
#pragma unroll
    for (int e = 0; e < DIMS; ++e)
        if (e < n) raw.w[e >> 1] |= static_cast<uint32_t>(s[e]) << (16 * (e & 1));
}


}  // namespace decode
