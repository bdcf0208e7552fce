// Warp-level tensor-core and async-copy helpers shared by the bf16 kernels
// (Hopper, sm_90a; every instruction here exists since sm_80).
//
//   mma_bf16      mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32: D = A B + C
//                 for a 16 x 16 bf16 A, a 16 x 8 bf16 B and a 16 x 8 f32 C/D. The
//                 product of two bf16 values is exact in f32, so the only rounding
//                 is that of the f32 sums.
//   ldmatrix_x4   four 8 x 8 b16 matrices from shared memory, one row address per
//                 lane (lanes 8i..8i+7 address matrix i); `_trans` transposes each.
//   cp_async16    a 16-byte global -> shared copy that bypasses the registers;
//                 `src_bytes` 0 writes 16 zero bytes and reads nothing.
//   cp_async4     the same for 4 bytes (through L1: .ca).
//   split_bf16    an f32 pair as two bf16 pairs, hi = bf16(x) and lo = bf16(x - hi):
//                 |x - hi - lo| <= 2^-16 |x|, so two mma (hi, then lo) into one f32
//                 sum take an f32 operand at 2^-16 relative per term.
//
// Fragment layouts (g = lane / 4, t = lane % 4):
//   A regs a0..a3: (row g, cols 2t, 2t+1), (row g+8, cols 2t, 2t+1),
//                  (row g, cols 2t+8, 2t+9), (row g+8, cols 2t+8, 2t+9)
//   B regs b0, b1: (k 2t, 2t+1; n g), (k 2t+8, 2t+9; n g)
//   C regs c0..c3: (row g, cols 2t, 2t+1), (row g+8, cols 2t, 2t+1)
// Each 32-bit register holds two bf16 values, the lower index in the low half.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// two f32 values rounded to bf16 (round-to-nearest-even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// (a, b) split into bf16 halves: hi = (bf16(a), bf16(b)), lo = the residues a - hi and
// b - hi (exact in f32) rounded to bf16; lower index in the low half of each register
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const float2 hf = __bfloat1622float2(h);
    const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
}

}  // namespace tc
