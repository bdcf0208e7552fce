// Flash attention, forward and backward (Hopper, sm_90a).
//
// Replaces three Pallas TPU kernels of dist_mnist_tpu/ops/pallas/flash_attention.py:
//
//   flash_fwd_mma_onepass,  <- `_flash_fwd_impl` (`_attn_fwd_kernel`, and the streamed
//   flash_fwd_mma_tiled,       `_attn_fwd_kernel_kt`) and, with per-row lengths,
//   flash_fwd_f32              `_masked_flash_fwd_impl` (`_masked_attn_fwd_kernel`) at
//                              Sq > 1: the first two for bf16, the last for f32
//   flash_dq_mma,           <- `_flash_bwd_impl` (`_attn_dq_kernel`, `_attn_dq_kernel_kt`)
//   flash_dq_f32               and `_masked_flash_bwd_impl` (`_masked_attn_dq_kernel`):
//                              bf16, f32
//   flash_dkv_mma,          <- `_flash_bwd_impl` (`_attn_dkv_kernel`, `_attn_dkv_kernel_qt`)
//   flash_dkv_f32              and `_masked_flash_bwd_impl` (`_masked_attn_dkv_kernel`):
//                              bf16, f32
//
// What they compute, per (batch row b, head h), with scale = D**-0.5:
//
//   s_ij  = dot(f32(q_i), f32(k_j)) * scale; -1e30 for keys j >= len (len = Sk, or
//           lengths[b] in the masked forward and backward)
//   forward: m_i = max_j s_ij, l_i = sum_j exp(s_ij - m_i), lse_i = m_i + log(l_i)
//     normalized = 1 (the reference's full-K kernel, which every call with one
//       128-key tile takes): out_i = sum_j round_v(exp(s_ij - m_i) / l_i) * f32(v_j)
//     normalized = 0 (the reference's streamed kernel, and its masked kernel): online
//       softmax over the key tiles; out_i = (sum_j round_v(exp(s_ij - m_cur)) *
//       f32(v_j)) / l_i
//     round_v rounds to v's dtype (identity for f32); accumulation in f32; out in
//     q's dtype
//   backward, from the forward's lse and delta_i = rowsum(f32(dO_i) * f32(O_i))
//   (minus the lse cotangent; computed by the caller):
//     p_ij = exp(s_ij - lse_i) (exactly 0 past len), dp_ij = dot(dO_i, v_j),
//     ds_ij = p_ij * (dp_ij - delta_i)
//     dq_i = scale * sum_j ds_ij k_j;  dk_j = scale * sum_i ds_ij q_i;
//     dv_j = sum_i p_ij dO_i; all in f32, stored in the inputs' dtype
//
// Layouts: q, k, v are [B, S, H, D] in f32 or bf16 with unit stride along D and any
// element strides along B, S and H (passed in), so the strided q/k/v views of a
// fused qkv projection are read in place; q has its own strides, k and v share
// one set. dO, out, dq, dk, dv are contiguous [B, S, H, D]; lse and delta are
// contiguous [B, H, S] f32; lengths (optional) [B] int32; visits (optional) [B, H, Sq]
// f32. Every kernel takes Sq and Sk apart (the masked shapes; unmasked self-attention
// has Sq = Sk = S).
//
// With lengths (the masked forward at Sq > 1), a forward kernel stages and computes
// only the whole groups of TILE = 32 keys before a row's length (rows at and past the
// length within the last group read as zeros and score -1e30), enters no key tile past
// it, and counts the groups it entered per query row into visits, ceil(len / TILE);
// the rule is the streamed one. Without lengths the same code runs with len = Sk.
//
// The bf16 forward: mma.sync on the tensor cores. The product of two bf16 values is
// exact in f32, so mma.sync m16n8k16 with an f32 accumulator forms exactly the
// reference's f32(q) f32(k) and round_v(p) f32(v) products; only the order of the f32
// sums changes. A warp owns 16 query rows; a block of up to 8 warps shares K and V
// tiles staged in shared memory as bf16 by 16-byte cp.async, read in place from the
// strided views (rows padded by 16 bytes, so ldmatrix reads them without bank
// conflicts; D padded with zeros to 16, 32, 64 or 128). Q goes into A fragments once.
// QK^T leaves the f32 logits in the accumulator fragments; keys at or past the length
// are set to -1e30, and a row's max and sum are taken over its quad of lanes by
// shuffles. A block owns up to 8 warps of query rows (ceil(Sq / 16) warps).
//   * Sk <= 128 (every ViT call: S = 65, 80 padded keys, 40 logits a thread): one block
//     holds the whole head up to 128 query rows (192 blocks of 5 warps at ViT's B = 64,
//     H = 3) and the whole key axis in registers: one pass of scores, max, sum, then
//     round_bf16(exp(s - m) / l) (IEEE expf and division, no --use_fast_math; the
//     streamed rule: round_bf16(exp(s - m)), acc / l at the store), which is re-packed
//     from the accumulator fragments as the A operand of PV (FlashAttention-2's
//     register reuse). V's tile lands while QK^T runs.
//   * Sk > 128: the blocks walk key tiles of 64: the normalized rule in two passes (max
//     and sum, then the product), the streamed rule in one (online softmax,
//     unnormalized rounded p, acc / l at the end).
//   PV reads V by ldmatrix.trans and accumulates in f32; out is rounded to bf16 and
//   lse = m + log(l) stored in f32. Views whose base or row strides are not 16-byte
//   aligned are staged by plain loads (the VEC = false instantiations).
//
// The bf16 backward: mma.sync too, two kernels as on the TPU (dQ over query rows, dK/dV
// over key rows), so that every output element is written by one thread in a fixed
// order: no atomics, the same bits on every run and every card. A warp owns 16 rows
// (queries in flash_dq_mma, keys in flash_dkv_mma), a block up to 8 warps of one (b, h)
// (ViT: 5 warps, 192 blocks each). The other axis (K and V, or Q and dO with lse and
// delta) is staged in shared memory as the forward stages it, whole up to 128 rows, in
// tiles of 64 above, and walked in steps of TILE = 32. QK^T and dO V^T (K Q^T and V dO^T
// in dK/dV, the reference's `logits_t`) take bf16 operands and are exact products in the
// f32 accumulators. P and dS = P (dP - delta) are formed there (IEEE expf, exactly 0 at
// keys >= len). The three products with an f32 operand, dQ += dS K, dV += P^T dO and
// dK += dS^T Q, re-pack that operand from the accumulator fragments as the A operand
// (as the forward's PV does) in two bf16 halves, hi = bf16(x) and lo = bf16(x - hi), and
// run two mma into one f32 sum: |x - hi - lo| <= 2^-16 |x|, 256 times under the bf16
// output's rounding, where rounding x to bf16 once (FlashAttention-2) would change the
// function. K, Q and dO are exact in bf16. The dQ kernel enters no step of keys past a
// row's length (visits: ceil(len / TILE)); a dK/dV warp whose 16 keys (KEY_BLOCK) lie at
// or past it writes exact zeros and does no work (visits: ceil(len / KEY_BLOCK)).
//
// The f32 forward (`flash_fwd_f32`): CUDA-core FMAs (f32 operands would be cut by TF32
// on the tensor cores), tiled as an SGEMM is. A block owns a group of query rows of one
// (b, h) (ViT: 2 groups of 36 rows, 384 blocks of 160 threads) and stages its Q rows
// once, then K and V once per key tile (Sk <= 128: one tile of every key, so the
// normalized rule takes one pass), by 16-byte cp.async where the views are aligned.
// QK^T and PV are register-tiled: a thread owns 4 x 4 scores, then up to two 4 x 4
// tiles of the output, reading float4 rows of Q and K, or of P and V, from shared
// memory; the scores pass through shared memory, where a warp per row takes the max
// and sum by shuffles. Rows are padded by 4 floats, so lanes reading consecutive rows
// at one offset spread over the banks. Above Sk = 128, key tiles of 64: the normalized
// rule walks K once more first for each row's max and sum, the streamed one keeps a
// running max and rescales its sums (online softmax).
//
// The f32 backward (`flash_dq_f32`, `flash_dkv_f32`): CUDA-core FMAs, register-tiled as
// the f32 forward is, two kernels kept apart as on the TPU so that every output element
// is written by one thread in a fixed order (no atomics: the same bits on every run and
// stream). A block owns a group of rows of one (b, h), query rows in dQ and key rows in
// dK/dV, by the plan `f32_plan` (the wrapper's `f32_backward_plan`; ViT: 2 groups of
// 36 rows, 384 blocks of 160 threads a kernel). It stages its rows once (Q and dO, or K
// and V) and the other axis once when it has at most ONE_PASS_KEYS rows (K and V; Q, dO,
// lse and delta), else in tiles of F32_KEY_TILE, by 16-byte cp.async where the views are
// aligned, rows padded by 4 floats and D by zeros to DP. Per tile a thread owns 4 x 4 of
// S = Q K^T and dP = dO V^T (S^T = K Q^T and dP^T = V dO^T in dK/dV) from float4 reads of
// shared memory, forms P = exp(s * scale - lse) and dS = P (dP - delta) in registers
// (exactly 0 at keys >= len) and writes dS (and P^T) to shared memory; then dQ = scale dS
// K (dV = P^T dO, dK = scale dS^T Q) is register-tiled, 4 rows x 4 dims a thread, the
// other axis in ascending order. The dQ kernel reads no key past a row's length (its
// visits: the steps of TILE keys it entered, ceil(len / TILE)); the dK/dV kernel does no
// work for a 4-key group at or past the length, so a 16-key KEY_BLOCK whose first key is
// at or past it does none (its visits entry 0, the others 1), and a block wholly past it
// stages nothing and writes exact zeros.
//
// What bounds it. At ViT-Tiny's shape (B = 64, S = 65, H = 3, D = 64, bf16) a call
// moves a few MB and does 0.2 (forward) to 0.5 (backward) GFLOP. Every product runs
// on the tensor cores, so the forward is bound by the 6.4 MB it moves (1.9 us) and
// the backward kernels, whose ten bf16 products (1.0 GFLOP, the split counted) take
// 1.1 us, by the 11.3 MB they move (3.4 us). What is left between them and the
// kernels is latency: each block loads its head's operands once and a warp does ~80
// (forward), ~160 (dQ) or ~240 (dK/dV) mma. The f32 route's FMAs on the CUDA cores
// bound it (the backward's seven f32 products: 10.9 us at the f32 peak at ViT's shape),
// and the shared-memory reads that feed them. With lengths, a forward moves only each
// row's active K and V rows and multiplies only them (ViT's shape with lengths 2..65,
// bf16: 4.8 MB, 1.4 us at 3.35 TB/s), so the masked forward is bound the same way and
// skipping past the length is what moves it. No --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int TILE = 32;           // keys per step of a dQ kernel: its skip granularity
constexpr float NEG = -1e30f;      // the reference's mask value
constexpr unsigned FULL = 0xffffffffu;

struct Layout {  // element strides of a [B, S, H, D] operand (D stride 1)
    long long b, s, h;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
    return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
    return x;
}

// a row's length: lengths[b] clipped to Sk, or Sk when there are no lengths
__device__ __forceinline__ int row_length(const int32_t* __restrict__ lengths, int b, int Sk) {
    return lengths ? min((int)lengths[b], Sk) : Sk;
}

// the forward's mask: a key is scored when it lies before the row's length
__device__ __forceinline__ bool key_live(int key, int len) { return key < len; }

// -- f32 forward on the CUDA cores ----------------------------------------------

constexpr int F32_MAX_THREADS = 256;
constexpr int F32_OUT_TILES = 2;  // 4 x 4 output tiles a thread owns, at most

// rows [row0, row0 + n) of (b, h) into dst (row pitch `pitch` floats) with D padded
// by zeros to DP; rows at or past `limit` read as zeros. VEC: 16-byte cp.async
// (base, strides and D all multiples of 4 elements); else plain loads and stores.
template <int DP, bool VEC>
__device__ __forceinline__ void stage_f32(float* dst, int pitch, const float* __restrict__ src,
                                          Layout L, int b, int h, int row0, int n, int limit,
                                          int D) {
    const float* base = src + b * L.b + h * L.h;
    if (VEC) {
        constexpr int GROUPS = DP / 4;
        for (int e = threadIdx.x; e < n * GROUPS; e += blockDim.x) {
            const int r = e / GROUPS;
            const int c = (e - r * GROUPS) * 4;
            const int row = row0 + r;
            const bool ok = row < limit && c < D;
            tc::cp_async16(dst + r * pitch + c, ok ? base + row * L.s + c : src, ok ? 16 : 0);
        }
    } else {
        for (int e = threadIdx.x; e < n * DP; e += blockDim.x) {
            const int r = e / DP;
            const int c = e - r * DP;
            const int row = row0 + r;
            dst[r * pitch + c] = row < limit && c < D ? base[row * L.s + c] : 0.f;
        }
    }
}

__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

// One block per (group of `rows` query rows, h, b), `threads` threads (the plan
// `f32_plan`: rows and ktile multiples of 4, rows <= 64, ktile <= 128). It stages its Q
// rows once and walks the keys before the row's length in tiles of `ktile`, each K and V
// tile staged once for all its rows: Sk <= 128 is one tile of every key, so the
// normalized rule takes one pass (scores, max, sum, divide). A tile's keys before the
// length, rounded up to 4, are staged (zeros at and past the length) and computed; no
// key past them is. Per tile:
//   scores  a thread owns 4 query rows x 4 keys (keys kg + j * nk for the tile's nk
//           groups of 4: lanes read consecutive K rows, which the pitch of DP + 4 floats
//           spreads over the banks), f32 FMAs over D from float4 reads of Q and K;
//           s * scale into P;
//   softmax a warp per row over P: keys at or past the length at -1e30, the row's max
//           and sum by shuffles, P replaced by the probabilities (NORMALIZED:
//           exp(s - m) / l, with m and l from the one tile or from pass 1; streamed:
//           exp(s - m_new), the rescale exp(m - m_new) kept for the row);
//   PV      a thread owns up to F32_OUT_TILES tiles of 4 rows x 4 dims of the
//           output in registers across the tiles, keys ascending, float4 reads of P
//           and V.
// NORMALIZED with more than one tile first walks K alone for each row's max and sum.
// visits (optional): the steps of TILE keys each query row entered, ceil(len / TILE).
template <int DP, bool VEC, bool NORMALIZED>
__global__ void __launch_bounds__(F32_MAX_THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const int32_t* __restrict__ lengths,
              float* __restrict__ out, float* __restrict__ lse, float* __restrict__ visits,
              int Sq, int Sk, int H, int D, Layout lq, Layout lkv, float scale, int rows,
              int ktile) {
    constexpr int PITCH = DP + 4;
    extern __shared__ __align__(16) float fsm[];
    const int pp = ktile + 4;
    float* q_s = fsm;                 // [rows][PITCH]
    float* k_s = q_s + rows * PITCH;  // [ktile][PITCH]
    float* v_s = k_s + ktile * PITCH; // [ktile][PITCH]
    float* p_s = v_s + ktile * PITCH; // [rows][pp]: scores, then probabilities
    float* m_s = p_s + rows * pp;     // [rows] running row max
    float* l_s = m_s + rows;          // [rows] running row sum
    float* a_s = l_s + rows;          // [rows] the streamed rule's rescale
    const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * rows;
    const int tid = threadIdx.x, threads = blockDim.x;
    const int warp = tid >> 5, lane = tid & 31, warps = threads >> 5;
    const int rq = rows / 4, nd = DP / 4;
    const int len = row_length(lengths, b, Sk);
    const int tiles = (len + ktile - 1) / ktile;  // key tiles before the length

    stage_f32<DP, VEC>(q_s, PITCH, q, lq, b, h, row0, rows, Sq, D);
    tc::cp_async_commit();
    for (int r = tid; r < rows; r += threads) {
        m_s[r] = NEG;
        l_s[r] = 0.f;
    }

    // keys of tile kt before the length, rounded up to 4: the K and V rows staged and
    // the keys scored
    auto tile_keys = [&](int kt) { return (min(ktile, len - kt * ktile) + 3) & ~3; };
    // P = Q K^T * scale for the first 4 * nk keys of the tile staged in k_s
    auto scores = [&](int nk) {
        for (int t = tid; t < rq * nk; t += threads) {
            const int ri = t / nk, kg = t - ri * nk;
            const float* qr = q_s + 4 * ri * PITCH;
            const float* kr = k_s + kg * PITCH;
            float s[4][4] = {};
#pragma unroll
            for (int d = 0; d < DP; d += 4) {
                float4 a[4], c[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    a[i] = ld4(qr + i * PITCH + d);
                    c[i] = ld4(kr + i * nk * PITCH + d);
                }
#pragma unroll
                for (int i = 0; i < 4; ++i) {
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        s[i][j] = fmaf(a[i].x, c[j].x, s[i][j]);
                        s[i][j] = fmaf(a[i].y, c[j].y, s[i][j]);
                        s[i][j] = fmaf(a[i].z, c[j].z, s[i][j]);
                        s[i][j] = fmaf(a[i].w, c[j].w, s[i][j]);
                    }
                }
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
#pragma unroll
                for (int j = 0; j < 4; ++j) p_s[(4 * ri + i) * pp + kg + j * nk] = s[i][j] * scale;
            }
        }
    };
    // each row's logits of key tile kt (up to 4 a lane), -1e30 at keys at or past the
    // length
    auto logits = [&](int r, int kt, float (&x)[4]) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int j = lane + 32 * i;
            x[i] = j < ktile && key_live(kt * ktile + j, len) ? p_s[r * pp + j] : NEG;
        }
    };

    if (NORMALIZED && tiles > 1) {  // pass 1: each row's max and sum over every key
        for (int kt = 0; kt < tiles; ++kt) {
            __syncthreads();  // the previous tile's readers are done with k_s and p_s
            const int nkeys = tile_keys(kt);
            stage_f32<DP, VEC>(k_s, PITCH, k, lkv, b, h, kt * ktile, nkeys, len, D);
            tc::cp_async_commit();
            tc::cp_async_wait<0>();
            __syncthreads();
            scores(nkeys / 4);
            __syncthreads();
            for (int r = warp; r < rows; r += warps) {
                float x[4];
                logits(r, kt, x);
                const float m_new = fmaxf(m_s[r], warp_max(fmaxf(fmaxf(x[0], x[1]),
                                                                 fmaxf(x[2], x[3]))));
                const float e = expf(x[0] - m_new) + expf(x[1] - m_new) +
                                expf(x[2] - m_new) + expf(x[3] - m_new);
                const float l = l_s[r] * expf(m_s[r] - m_new) + warp_sum(e);
                __syncwarp();
                if (lane == 0) {
                    m_s[r] = m_new;
                    l_s[r] = l;
                }
            }
        }
    }

    float acc[F32_OUT_TILES][4][4] = {};
    int steps = 0;
    for (int kt = 0; kt < tiles; ++kt) {  // the main pass
        __syncthreads();  // the previous tile's readers are done with k_s, v_s and p_s
        const int nkeys = tile_keys(kt);
        steps += (min(ktile, len - kt * ktile) + TILE - 1) / TILE;
        stage_f32<DP, VEC>(k_s, PITCH, k, lkv, b, h, kt * ktile, nkeys, len, D);
        tc::cp_async_commit();
        stage_f32<DP, VEC>(v_s, PITCH, v, lkv, b, h, kt * ktile, nkeys, len, D);
        tc::cp_async_commit();
        tc::cp_async_wait<1>();  // Q and K here; V still in flight
        __syncthreads();
        scores(nkeys / 4);
        tc::cp_async_wait<0>();
        __syncthreads();
        for (int r = warp; r < rows; r += warps) {
            float x[4];
            logits(r, kt, x);
            float m = m_s[r], l = l_s[r], alpha = 1.f;
            if (!NORMALIZED || tiles == 1) {
                const float m_new = fmaxf(m, warp_max(fmaxf(fmaxf(x[0], x[1]),
                                                            fmaxf(x[2], x[3]))));
#pragma unroll
                for (int i = 0; i < 4; ++i) x[i] = expf(x[i] - m_new);
                alpha = expf(m - m_new);
                l = l * alpha + warp_sum(x[0] + x[1] + x[2] + x[3]);
                m = m_new;
            } else {
#pragma unroll
                for (int i = 0; i < 4; ++i) x[i] = expf(x[i] - m);
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int j = lane + 32 * i;
                if (j < ktile) p_s[r * pp + j] = NORMALIZED ? x[i] / l : x[i];
            }
            __syncwarp();
            if (lane == 0) {
                m_s[r] = m;
                l_s[r] = l;
                a_s[r] = alpha;
            }
        }
        __syncthreads();
#pragma unroll
        for (int o = 0; o < F32_OUT_TILES; ++o) {
            const int t = tid + o * threads;
            if (t >= rq * nd) continue;
            const int ri = t / nd, dj = t - ri * nd;
            const float* pr = p_s + 4 * ri * pp;
            const float* vc = v_s + 4 * dj;
            if (!NORMALIZED) {
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float al = a_s[4 * ri + i];
#pragma unroll
                    for (int c = 0; c < 4; ++c) acc[o][i][c] *= al;
                }
            }
            for (int j = 0; j < nkeys; j += 4) {  // keys past the length: p = 0
                float4 p[4], w[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    p[i] = ld4(pr + i * pp + j);
                    w[i] = ld4(vc + (j + i) * PITCH);
                }
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float pi[4] = {p[i].x, p[i].y, p[i].z, p[i].w};
#pragma unroll
                    for (int jj = 0; jj < 4; ++jj) {
                        acc[o][i][0] = fmaf(pi[jj], w[jj].x, acc[o][i][0]);
                        acc[o][i][1] = fmaf(pi[jj], w[jj].y, acc[o][i][1]);
                        acc[o][i][2] = fmaf(pi[jj], w[jj].z, acc[o][i][2]);
                        acc[o][i][3] = fmaf(pi[jj], w[jj].w, acc[o][i][3]);
                    }
                }
            }
        }
    }
    tc::cp_async_wait<0>();  // Q, when no key tile was entered

#pragma unroll
    for (int o = 0; o < F32_OUT_TILES; ++o) {
        const int t = tid + o * threads;
        if (t >= rq * nd) continue;
        const int ri = t / nd, dj = t - ri * nd;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = 4 * ri + i, row = row0 + r;
            if (row >= Sq) continue;
            const float div = NORMALIZED ? 1.f : l_s[r];
            float* orow = out + (((size_t)b * Sq + row) * H + h) * D;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int d = 4 * dj + c;
                if (d < D) orow[d] = NORMALIZED ? acc[o][i][c] : acc[o][i][c] / div;
            }
        }
    }
    for (int r = tid; r < rows; r += threads) {
        if (row0 + r >= Sq) continue;
        const size_t at = ((size_t)b * H + h) * Sq + row0 + r;
        lse[at] = m_s[r] + logf(l_s[r]);
        if (visits) visits[at] = (float)steps;
    }
}

// -- bf16 forward on the tensor cores -----------------------------------------

constexpr int MMA_MAX_WARPS = 8;   // query rows per block: 16 a warp
constexpr int ONE_PASS_KEYS = 128; // the whole key axis in registers up to this S
constexpr int KEY_TILE = 64;       // keys per tile above it
constexpr int KEY_BLOCK = 16;      // keys a dK/dV warp owns: its skip granularity

// rows [row0, row0 + n) of (b, h) into dst (row pitch `pitch` bf16) with D padded
// by zeros to DP; rows at or past `limit` read as zeros. VEC: 16-byte cp.async
// (base, strides and D all multiples of 8 elements); else plain loads and stores.
template <int DP, bool VEC>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst, int pitch,
                                           const __nv_bfloat16* __restrict__ src, Layout L,
                                           int b, int h, int row0, int n, int limit, int D) {
    const __nv_bfloat16* base = src + b * L.b + h * L.h;
    if (VEC) {
        constexpr int GROUPS = DP / 8;
        for (int e = threadIdx.x; e < n * GROUPS; e += blockDim.x) {
            const int r = e / GROUPS;
            const int c = (e - r * GROUPS) * 8;
            const int row = row0 + r;
            const bool ok = row < limit && c < D;
            tc::cp_async16(dst + r * pitch + c, ok ? base + row * L.s + c : src, ok ? 16 : 0);
        }
    } else {
        for (int e = threadIdx.x; e < n * DP; e += blockDim.x) {
            const int r = e / DP;
            const int c = e - r * DP;
            const int row = row0 + r;
            dst[r * pitch + c] =
                row < limit && c < D ? base[row * L.s + c] : __float2bfloat16(0.f);
        }
    }
}

// Q's A fragments for the warp's 16 rows, from q_s (row pitch PITCH)
template <int DP>
__device__ __forceinline__ void load_q_frags(uint32_t (&qf)[DP / 16][4],
                                             const __nv_bfloat16* q_s, int pitch) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
        tc::ldmatrix_x4(qf[kk], q_s + (lane & 15) * pitch + kk * 16 + (lane >> 4) * 8);
}

// c[2j], c[2j+1] = A (16 rows, fragments af) . B[16j .. + 16)^T for j < groups, B's rows
// from b_s (row pitch `pitch`) by ldmatrix; zero for j >= groups
template <int DP, int NT>
__device__ __forceinline__ void mma_abt(float (&c)[NT][4], const uint32_t (&af)[DP / 16][4],
                                        const __nv_bfloat16* b_s, int pitch, int groups) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) c[2 * j][i] = c[2 * j + 1][i] = 0.f;
        if (j < groups) {
#pragma unroll
            for (int kk = 0; kk < DP / 16; ++kk) {
                uint32_t bb[4];
                tc::ldmatrix_x4(bb, b_s + (j * 16 + (lane & 7) + (lane >> 4) * 8) * pitch +
                                        kk * 16 + ((lane >> 3) & 1) * 8);
                tc::mma_bf16(c[2 * j], af[kk], bb[0], bb[1]);
                tc::mma_bf16(c[2 * j + 1], af[kk], bb[2], bb[3]);
            }
        }
    }
}

// s = Q (16 rows) . K[key0 + 16j .. + 16)^T for j < groups (`mma_abt`), times `scale`,
// -1e30 at keys at or past the row's length
template <int DP, int NT>
__device__ __forceinline__ void scores(float (&s)[NT][4], const uint32_t (&qf)[DP / 16][4],
                                       const __nv_bfloat16* k_s, int pitch, int groups,
                                       int key0, int len, float scale) {
    const int t = threadIdx.x & 3;
    mma_abt<DP, NT>(s, qf, k_s, pitch, groups);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int key = key0 + n * 8 + 2 * t + (i & 1);
            s[n][i] = key_live(key, len) ? s[n][i] * scale : NEG;
        }
    }
}

__device__ __forceinline__ float quad_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
    return fmaxf(x, __shfl_xor_sync(FULL, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(FULL, x, 1);
    return x + __shfl_xor_sync(FULL, x, 2);
}

// row max of the thread's two rows (g: regs 0, 1; g + 8: regs 2, 3) over the quad
template <int NT>
__device__ __forceinline__ void row_max(const float (&s)[NT][4], float (&mx)[2]) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
}

// o[2dt], o[2dt+1] += P (16 rows x 16 keys per group, A fragments packed from the
// probabilities p[2j], p[2j+1]) . V[16j .. + 16) for j < groups; V from v_s by
// ldmatrix.trans
template <int DP, int NT>
__device__ __forceinline__ void accumulate_pv(float (&o)[DP / 8][4], const float (&p)[NT][4],
                                              const __nv_bfloat16* v_s, int pitch,
                                              int groups) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
        if (j < groups) {
            const uint32_t a[4] = {tc::pack_bf16(p[2 * j][0], p[2 * j][1]),
                                   tc::pack_bf16(p[2 * j][2], p[2 * j][3]),
                                   tc::pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]),
                                   tc::pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3])};
#pragma unroll
            for (int dt = 0; dt < DP / 16; ++dt) {
                uint32_t vb[4];
                tc::ldmatrix_x4_trans(
                    vb, v_s + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * pitch + dt * 16 +
                            (lane >> 4) * 8);
                tc::mma_bf16(o[2 * dt], a, vb[0], vb[1]);
                tc::mma_bf16(o[2 * dt + 1], a, vb[2], vb[3]);
            }
        }
    }
}

// out rows (row g and g + 8 of the warp's 16) as bf16, each divided by l first when
// DIVIDE (the streamed rule), their lse, and (when `visits` is given) the steps of TILE
// keys each entered; rows >= Sq and columns >= D are not stored
template <int DP, bool DIVIDE>
__device__ __forceinline__ void store_rows(const float (&o)[DP / 8][4], const float (&mx)[2],
                                           const float (&l)[2],
                                           __nv_bfloat16* __restrict__ out,
                                           float* __restrict__ lse, float* __restrict__ visits,
                                           int steps, int b, int h, int row0, int Sq, int H,
                                           int D) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int row = row0 + g + 8 * half;
        if (row >= Sq) continue;
        __nv_bfloat16* orow = out + (((size_t)b * Sq + row) * H + h) * D;
#pragma unroll
        for (int dt = 0; dt < DP / 8; ++dt) {
            const int col = dt * 8 + 2 * t;
            const float v0 = DIVIDE ? o[dt][2 * half] / l[half] : o[dt][2 * half];
            const float v1 = DIVIDE ? o[dt][2 * half + 1] / l[half] : o[dt][2 * half + 1];
            if (col + 1 < D && (D & 1) == 0) {
                *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(v0, v1);
            } else {
                if (col < D) orow[col] = __float2bfloat16(v0);
                if (col + 1 < D) orow[col + 1] = __float2bfloat16(v1);
            }
        }
        if (t == 0) {
            const size_t at = ((size_t)b * H + h) * Sq + row;
            lse[at] = mx[half] + logf(l[half]);
            if (visits) visits[at] = (float)steps;
        }
    }
}

// Sk <= ONE_PASS_KEYS: blocks of up to MMA_MAX_WARPS warps over the query rows (one
// block per (b, h) up to 128 rows), every key in registers. The keys staged and
// computed are the whole TILE-key groups before the row's length (zeros at and past
// it), padded to 16 at Sk: no QK^T or PV mma is issued for a group past them.
// NORMALIZED: p = exp(s - m) / l rounded to bf16 before PV (the reference's full-K
// rule); else the streamed rule's one tile: exp(s - m) rounded, out = acc / l.
template <int DP, bool VEC, bool NORMALIZED>
__global__ void __launch_bounds__(MMA_MAX_WARPS * 32)
flash_fwd_mma_onepass(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ lengths,
                      __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                      float* __restrict__ visits, int Sq, int Sk, int H, int D, Layout lq,
                      Layout lkv, float scale) {
    constexpr int PITCH = DP + 8;
    constexpr int NT = ONE_PASS_KEYS / 8;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int rows = (blockDim.x >> 5) * 16;
    const int kp = (Sk + 15) & ~15;  // keys padded to 16
    __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [rows][PITCH]
    __nv_bfloat16* k_s = q_s + rows * PITCH;                             // [kp][PITCH]
    __nv_bfloat16* v_s = k_s + kp * PITCH;                               // [kp][PITCH]
    const int b = blockIdx.z, h = blockIdx.y;
    const int warp = threadIdx.x >> 5;
    const int row0 = blockIdx.x * rows;
    const int len = row_length(lengths, b, Sk);
    const int keys = min(kp, (len + TILE - 1) / TILE * TILE);  // staged and computed

    stage_bf16<DP, VEC>(q_s, PITCH, q, lq, b, h, row0, rows, Sq, D);
    stage_bf16<DP, VEC>(k_s, PITCH, k, lkv, b, h, 0, keys, len, D);
    tc::cp_async_commit();
    stage_bf16<DP, VEC>(v_s, PITCH, v, lkv, b, h, 0, keys, len, D);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // Q and K here; V still in flight
    __syncthreads();

    uint32_t qf[DP / 16][4];
    load_q_frags<DP>(qf, q_s + warp * 16 * PITCH, PITCH);
    float s[NT][4];
    const int groups = keys / 16;
    scores<DP, NT>(s, qf, k_s, PITCH, groups, 0, len, scale);
    float mx[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
    row_max<NT>(s, mx);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            s[n][i] = expf(s[n][i] - mx[i >> 1]);
            l[i >> 1] += s[n][i];
        }
    }
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);
    if (NORMALIZED) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
            for (int i = 0; i < 4; ++i) s[n][i] = s[n][i] / l[i >> 1];  // rounded to bf16 in PV
        }
    }

    tc::cp_async_wait<0>();
    __syncthreads();
    float o[DP / 8][4] = {};
    accumulate_pv<DP, NT>(o, s, v_s, PITCH, groups);
    store_rows<DP, !NORMALIZED>(o, mx, l, out, lse, visits, (groups + 1) / 2, b, h,
                                row0 + warp * 16, Sq, H, D);
}

// Sk > ONE_PASS_KEYS: blocks of up to MMA_MAX_WARPS warps over the query rows, key tiles
// of KEY_TILE up to the row's length, each tile's whole TILE-key groups before it staged
// and computed; NORMALIZED: two passes, else the streamed online softmax
template <int DP, bool VEC, bool NORMALIZED>
__global__ void __launch_bounds__(MMA_MAX_WARPS * 32)
flash_fwd_mma_tiled(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ lengths,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                    float* __restrict__ visits, int Sq, int Sk, int H, int D, Layout lq,
                    Layout lkv, float scale) {
    constexpr int PITCH = DP + 8;
    constexpr int NT = KEY_TILE / 8;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int rows = (blockDim.x >> 5) * 16;
    __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [rows][PITCH]
    __nv_bfloat16* k_s = q_s + rows * PITCH;                             // [KEY_TILE][PITCH]
    __nv_bfloat16* v_s = k_s + KEY_TILE * PITCH;                         // [KEY_TILE][PITCH]
    const int b = blockIdx.z, h = blockIdx.y;
    const int warp = threadIdx.x >> 5;
    const int row0 = blockIdx.x * rows;
    const int len = row_length(lengths, b, Sk);
    const int end = (len + TILE - 1) / TILE * TILE;  // keys staged and computed
    // the keys of the tile at k0 that are staged and computed: whole TILE-key groups
    auto tile_keys = [&](int k0) { return min(KEY_TILE, end - k0); };

    stage_bf16<DP, VEC>(q_s, PITCH, q, lq, b, h, row0, rows, Sq, D);
    tc::cp_async_commit();
    uint32_t qf[DP / 16][4];
    float s[NT][4];
    float mx[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
    float o[DP / 8][4] = {};

    if (NORMALIZED) {  // pass 1: each row's max and sum over every key
        for (int k0 = 0; k0 < len; k0 += KEY_TILE) {
            __syncthreads();  // the previous tile's readers are done with k_s
            const int nk = tile_keys(k0);
            stage_bf16<DP, VEC>(k_s, PITCH, k, lkv, b, h, k0, nk, len, D);
            tc::cp_async_commit();
            tc::cp_async_wait<0>();
            __syncthreads();
            if (k0 == 0) load_q_frags<DP>(qf, q_s + warp * 16 * PITCH, PITCH);
            scores<DP, NT>(s, qf, k_s, PITCH, nk / 16, k0, len, scale);
            float m_new[2] = {mx[0], mx[1]};
            row_max<NT>(s, m_new);
            float sum[2] = {0.f, 0.f};
#pragma unroll
            for (int n = 0; n < NT; ++n) {
#pragma unroll
                for (int i = 0; i < 4; ++i) sum[i >> 1] += expf(s[n][i] - m_new[i >> 1]);
            }
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                l[r] = l[r] * expf(mx[r] - m_new[r]) + quad_sum(sum[r]);
                mx[r] = m_new[r];
            }
        }
    }

    int steps = 0;
    for (int k0 = 0; k0 < len; k0 += KEY_TILE) {
        __syncthreads();  // the previous tile's readers are done with k_s and v_s
        const int nk = tile_keys(k0);
        steps += nk / TILE;
        stage_bf16<DP, VEC>(k_s, PITCH, k, lkv, b, h, k0, nk, len, D);
        stage_bf16<DP, VEC>(v_s, PITCH, v, lkv, b, h, k0, nk, len, D);
        tc::cp_async_commit();
        tc::cp_async_wait<0>();
        __syncthreads();
        if (!NORMALIZED && k0 == 0) load_q_frags<DP>(qf, q_s + warp * 16 * PITCH, PITCH);
        scores<DP, NT>(s, qf, k_s, PITCH, nk / 16, k0, len, scale);
        if (NORMALIZED) {
#pragma unroll
            for (int n = 0; n < NT; ++n) {
#pragma unroll
                for (int i = 0; i < 4; ++i) s[n][i] = expf(s[n][i] - mx[i >> 1]) / l[i >> 1];
            }
        } else {
            float m_new[2] = {mx[0], mx[1]};
            row_max<NT>(s, m_new);
            float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
            for (int r = 0; r < 2; ++r) alpha[r] = expf(mx[r] - m_new[r]);
#pragma unroll
            for (int n = 0; n < NT; ++n) {
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    s[n][i] = expf(s[n][i] - m_new[i >> 1]);
                    sum[i >> 1] += s[n][i];
                }
            }
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                l[r] = l[r] * alpha[r] + quad_sum(sum[r]);
                mx[r] = m_new[r];
            }
#pragma unroll
            for (int dt = 0; dt < DP / 8; ++dt) {
#pragma unroll
                for (int i = 0; i < 4; ++i) o[dt][i] *= alpha[i >> 1];
            }
        }
        accumulate_pv<DP, NT>(o, s, v_s, PITCH, nk / 16);
    }
    tc::cp_async_wait<0>();  // Q, when no key tile was entered
    store_rows<DP, !NORMALIZED>(o, mx, l, out, lse, visits, steps, b, h, row0 + warp * 16, Sq,
                                H, D);
}

// -- bf16 backward on the tensor cores ----------------------------------------

// o[2dt], o[2dt+1] += X . M[16j .. + 16) for j < groups: X (16 rows x 16 columns per
// group) is the f32 tile x[2j], x[2j+1], re-packed as A fragments in bf16 hi and lo
// halves (`tc::split_bf16`), two mma into the same f32 sum; M's rows from m_s by
// ldmatrix.trans
template <int DP, int NT>
__device__ __forceinline__ void accumulate_split(float (&o)[DP / 8][4], const float (&x)[NT][4],
                                                 const __nv_bfloat16* m_s, int pitch,
                                                 int groups) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
        if (j < groups) {
            uint32_t hi[4], lo[4];
            tc::split_bf16(x[2 * j][0], x[2 * j][1], hi[0], lo[0]);
            tc::split_bf16(x[2 * j][2], x[2 * j][3], hi[1], lo[1]);
            tc::split_bf16(x[2 * j + 1][0], x[2 * j + 1][1], hi[2], lo[2]);
            tc::split_bf16(x[2 * j + 1][2], x[2 * j + 1][3], hi[3], lo[3]);
#pragma unroll
            for (int dt = 0; dt < DP / 16; ++dt) {
                uint32_t mb[4];
                tc::ldmatrix_x4_trans(
                    mb, m_s + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * pitch + dt * 16 +
                            (lane >> 4) * 8);
                tc::mma_bf16(o[2 * dt], hi, mb[0], mb[1]);
                tc::mma_bf16(o[2 * dt + 1], hi, mb[2], mb[3]);
                tc::mma_bf16(o[2 * dt], lo, mb[0], mb[1]);
                tc::mma_bf16(o[2 * dt + 1], lo, mb[2], mb[3]);
            }
        }
    }
}

// rows row0 + g and row0 + g + 8 of a warp's 16 x DP f32 tile, times `mul`, as bf16 into
// `dst` (row stride H * D); rows >= limit and columns >= D are not stored
template <int DP>
__device__ __forceinline__ void store_bf16_rows(const float (&o)[DP / 8][4],
                                                __nv_bfloat16* __restrict__ dst, int row0,
                                                int limit, int H, int D, float mul) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int row = row0 + g + 8 * half;
        if (row >= limit) continue;
        __nv_bfloat16* drow = dst + (size_t)row * H * D;
#pragma unroll
        for (int dt = 0; dt < DP / 8; ++dt) {
            const int col = dt * 8 + 2 * t;
            const float v0 = o[dt][2 * half] * mul, v1 = o[dt][2 * half + 1] * mul;
            if (col + 1 < D && (D & 1) == 0) {
                *reinterpret_cast<__nv_bfloat162*>(drow + col) = __floats2bfloat162_rn(v0, v1);
            } else {
                if (col < D) drow[col] = __float2bfloat16(v0);
                if (col + 1 < D) drow[col + 1] = __float2bfloat16(v1);
            }
        }
    }
}

// dQ: a warp owns 16 query rows, a block up to MMA_MAX_WARPS warps of one (b, h). K and V
// are staged in tiles of `tile` keys (all of them up to ONE_PASS_KEYS, else KEY_TILE) and
// walked in steps of TILE keys; no step starts at or past the row's length.
template <int DP, bool VEC>
__global__ void __launch_bounds__(MMA_MAX_WARPS * 32)
flash_dq_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             const int32_t* __restrict__ lengths, __nv_bfloat16* __restrict__ dq,
             float* __restrict__ visits, int Sq, int Sk, int H, int D, Layout lq, Layout lkv,
             int tile, float scale) {
    constexpr int PITCH = DP + 8;
    constexpr int NT = TILE / 8;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int rows = (blockDim.x >> 5) * 16;
    __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [rows][PITCH]
    __nv_bfloat16* do_s = q_s + rows * PITCH;                            // [rows][PITCH]
    __nv_bfloat16* k_s = do_s + rows * PITCH;                            // [tile][PITCH]
    __nv_bfloat16* v_s = k_s + tile * PITCH;                             // [tile][PITCH]
    const int b = blockIdx.z, h = blockIdx.y;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int row0 = blockIdx.x * rows;  // the block's first query row
    const int wrow0 = row0 + warp * 16;  // the warp's
    const Layout ld = {(long long)Sq * H * D, (long long)H * D, D};
    const int len = lengths ? min((int)lengths[b], Sk) : Sk;

    stage_bf16<DP, VEC>(q_s, PITCH, q, lq, b, h, row0, rows, Sq, D);
    stage_bf16<DP, VEC>(do_s, PITCH, dout, ld, b, h, row0, rows, Sq, D);
    tc::cp_async_commit();
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int row = wrow0 + g + 8 * half;
        const size_t at = ((size_t)b * H + h) * Sq + row;
        lse_r[half] = row < Sq ? lse[at] : 0.f;
        delta_r[half] = row < Sq ? delta[at] : 0.f;
    }

    uint32_t qf[DP / 16][4], df[DP / 16][4];
    float acc[DP / 8][4] = {};
    int steps = 0;
    for (int k0 = 0; k0 < len; k0 += tile) {
        if (k0 > 0) __syncthreads();  // the previous tile's readers are done with k_s, v_s
        stage_bf16<DP, VEC>(k_s, PITCH, k, lkv, b, h, k0, tile, len, D);
        stage_bf16<DP, VEC>(v_s, PITCH, v, lkv, b, h, k0, tile, len, D);
        tc::cp_async_commit();
        tc::cp_async_wait<0>();
        __syncthreads();
        if (k0 == 0) {
            load_q_frags<DP>(qf, q_s + warp * 16 * PITCH, PITCH);
            load_q_frags<DP>(df, do_s + warp * 16 * PITCH, PITCH);
        }
        const int n = min(tile, len - k0);  // keys of this tile before the length
        for (int j0 = 0; j0 < n; j0 += TILE) {
            ++steps;
            if (wrow0 >= Sq) continue;
            const int groups = min(2, (n - j0 + 15) / 16);
            float s[NT][4], dp[NT][4];
            mma_abt<DP, NT>(s, qf, k_s + j0 * PITCH, PITCH, groups);
            mma_abt<DP, NT>(dp, df, v_s + j0 * PITCH, PITCH, groups);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int key = k0 + j0 + nt * 8 + 2 * t + (i & 1);
                    float ds = 0.f;  // exactly 0 at keys >= len
                    if (key < len) {
                        const float p = expf(s[nt][i] * scale - lse_r[i >> 1]);
                        ds = p * (dp[nt][i] - delta_r[i >> 1]);
                    }
                    s[nt][i] = ds;
                }
            }
            accumulate_split<DP, NT>(acc, s, k_s + j0 * PITCH, PITCH, groups);
        }
    }
    tc::cp_async_wait<0>();  // Q and dO, when no key tile was entered

    store_bf16_rows<DP>(acc, dq + ((size_t)b * Sq * H + h) * D, wrow0, Sq, H, D, scale);
    if (visits && t == 0) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int row = wrow0 + g + 8 * half;
            if (row < Sq) visits[((size_t)b * H + h) * Sq + row] = (float)steps;
        }
    }
}

// dK and dV: a warp owns 16 key rows (one key block of KEY_BLOCK), a block up to
// MMA_MAX_WARPS warps of one (b, h). Q, dO, lse and delta are staged in tiles of `tile`
// queries (all of them up to ONE_PASS_KEYS, else KEY_TILE) and walked in steps of TILE
// queries. A warp whose keys all lie at or past the row's length does no work and writes
// exact zeros; a block wholly past it stages nothing.
template <int DP, bool VEC>
__global__ void __launch_bounds__(MMA_MAX_WARPS * 32)
flash_dkv_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const int32_t* __restrict__ lengths, __nv_bfloat16* __restrict__ dk,
              __nv_bfloat16* __restrict__ dv, float* __restrict__ visits, int Sq, int Sk, int H,
              int D, Layout lq, Layout lkv, int tile, float scale) {
    constexpr int PITCH = DP + 8;
    constexpr int NT = TILE / 8;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int rows = (blockDim.x >> 5) * 16;
    __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [rows][PITCH]
    __nv_bfloat16* v_s = k_s + rows * PITCH;                             // [rows][PITCH]
    __nv_bfloat16* q_s = v_s + rows * PITCH;                             // [tile][PITCH]
    __nv_bfloat16* do_s = q_s + tile * PITCH;                            // [tile][PITCH]
    float* lse_s = reinterpret_cast<float*>(do_s + tile * PITCH);       // [tile]
    float* delta_s = lse_s + tile;                                       // [tile]
    const int b = blockIdx.z, h = blockIdx.y;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int key0 = blockIdx.x * rows;  // the block's first key
    const int wkey0 = key0 + warp * 16;  // the warp's
    const Layout ld = {(long long)Sq * H * D, (long long)H * D, D};
    const int len = lengths ? min((int)lengths[b], Sk) : Sk;
    const bool active = wkey0 < len;
    __nv_bfloat16* dkh = dk + ((size_t)b * Sk * H + h) * D;  // (b, key 0, h)
    __nv_bfloat16* dvh = dv + ((size_t)b * Sk * H + h) * D;

    const int kblocks = (Sk + KEY_BLOCK - 1) / KEY_BLOCK;
    if (visits && lane == 0 && wkey0 < Sk)
        visits[((size_t)b * H + h) * kblocks + wkey0 / KEY_BLOCK] = active ? 1.f : 0.f;
    float acc_k[DP / 8][4] = {}, acc_v[DP / 8][4] = {};
    if (key0 < len) {
        stage_bf16<DP, VEC>(k_s, PITCH, k, lkv, b, h, key0, rows, len, D);
        stage_bf16<DP, VEC>(v_s, PITCH, v, lkv, b, h, key0, rows, len, D);
    }
    for (int q0 = 0; key0 < len && q0 < Sq; q0 += tile) {
        if (q0 > 0) __syncthreads();  // the previous tile's readers are done with it
        stage_bf16<DP, VEC>(q_s, PITCH, q, lq, b, h, q0, tile, Sq, D);
        stage_bf16<DP, VEC>(do_s, PITCH, dout, ld, b, h, q0, tile, Sq, D);
        tc::cp_async_commit();
        for (int i = threadIdx.x; i < tile; i += blockDim.x) {
            const int row = q0 + i;
            const size_t at = ((size_t)b * H + h) * Sq + row;
            lse_s[i] = row < Sq ? lse[at] : 0.f;
            delta_s[i] = row < Sq ? delta[at] : 0.f;
        }
        tc::cp_async_wait<0>();
        __syncthreads();
        if (!active) continue;
        const int n = min(tile, Sq - q0);  // queries of this tile
        for (int j0 = 0; j0 < n; j0 += TILE) {
            const int groups = min(2, (n - j0 + 15) / 16);
            float s[NT][4], dp[NT][4];
            {
                uint32_t kf[DP / 16][4];
                load_q_frags<DP>(kf, k_s + warp * 16 * PITCH, PITCH);
                mma_abt<DP, NT>(s, kf, q_s + j0 * PITCH, PITCH, groups);
            }
            {
                uint32_t vf[DP / 16][4];
                load_q_frags<DP>(vf, v_s + warp * 16 * PITCH, PITCH);
                mma_abt<DP, NT>(dp, vf, do_s + j0 * PITCH, PITCH, groups);
            }
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int col = j0 + nt * 8 + 2 * t + (i & 1);  // the tile's query
                    const int key = wkey0 + g + 8 * (i >> 1);
                    float p = 0.f, ds = 0.f;  // exactly 0 at keys >= len
                    if (key < len && col < n) {
                        p = expf(s[nt][i] * scale - lse_s[col]);
                        ds = p * (dp[nt][i] - delta_s[col]);
                    }
                    s[nt][i] = p;    // P^T
                    dp[nt][i] = ds;  // dS^T
                }
            }
            accumulate_split<DP, NT>(acc_v, s, do_s + j0 * PITCH, PITCH, groups);
            accumulate_split<DP, NT>(acc_k, dp, q_s + j0 * PITCH, PITCH, groups);
        }
    }

    store_bf16_rows<DP>(acc_k, dkh, wkey0, Sk, H, D, scale);
    store_bf16_rows<DP>(acc_v, dvh, wkey0, Sk, H, D, 1.f);
}

// -- f32 backward on the CUDA cores ---------------------------------------------

constexpr int F32_KEY_TILE = 64;        // the other axis's tile above ONE_PASS_KEYS
constexpr int F32_MAX_ROWS = 64;        // rows a block owns, at most
constexpr int F32_TARGET_BLOCKS = 264;  // two per SM of the H100 SXM: a design constant
constexpr size_t SMEM_LIMIT = 232448;   // dynamic shared memory a block may take

// the row pitch (in floats) of dS and P^T for a tile of `tile` columns: 4 more than a
// multiple of 8, so that the rows 4 apart that the two halves of a warp read in the
// products (4 * pitch floats apart) fall in different banks
__host__ __device__ __forceinline__ int score_pitch(int tile) {
    return tile % 8 == 0 ? tile + 4 : tile;
}

// s[i][j] = sum over DP of a[i * ap + d] * c[j * cs + d]: 4 rows of a against 4 of c
// (rows padded with zeros past D), from float4 reads of shared memory
template <int DP>
__device__ __forceinline__ void dots4x4(float (&s)[4][4], const float* a, int ap,
                                        const float* c, int cs) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    }
#pragma unroll
    for (int d = 0; d < DP; d += 4) {
        float4 x[4], y[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            x[i] = ld4(a + i * ap + d);
            y[i] = ld4(c + i * cs + d);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                s[i][j] = fmaf(x[i].x, y[j].x, s[i][j]);
                s[i][j] = fmaf(x[i].y, y[j].y, s[i][j]);
                s[i][j] = fmaf(x[i].z, y[j].z, s[i][j]);
                s[i][j] = fmaf(x[i].w, y[j].w, s[i][j]);
            }
        }
    }
}

// acc[i][c] += sum over j < n (ascending) of x[i * xp + j] * m[j * mp + c]: 4 rows of x
// (row pitch xp) times rows 0 .. n of m (row pitch mp), 4 columns; n a multiple of 4
__device__ __forceinline__ void accumulate4x4(float (&acc)[4][4], const float* x, int xp,
                                              const float* m, int mp, int n) {
    for (int j = 0; j < n; j += 4) {
        float4 p[4], w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            p[i] = ld4(x + i * xp + j);
            w[i] = ld4(m + (j + i) * mp);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float pi[4] = {p[i].x, p[i].y, p[i].z, p[i].w};
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
                acc[i][0] = fmaf(pi[jj], w[jj].x, acc[i][0]);
                acc[i][1] = fmaf(pi[jj], w[jj].y, acc[i][1]);
                acc[i][2] = fmaf(pi[jj], w[jj].z, acc[i][2]);
                acc[i][3] = fmaf(pi[jj], w[jj].w, acc[i][3]);
            }
        }
    }
}

// dQ: one block per (group of `rows` query rows, h, b), `threads` threads, K and V staged
// in tiles of `ktile` keys (all of them up to ONE_PASS_KEYS) up to the row's length.
// Per tile: dS into ds_s (a thread 4 rows x 4 keys: keys kg + j * nk, so lanes read
// consecutive K rows, which the pitch spreads over the banks), then dQ += dS K in
// registers (a thread up to F32_OUT_TILES tiles of 4 rows x 4 dims).
template <int DP, bool VEC>
__global__ void __launch_bounds__(F32_MAX_THREADS)
flash_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             const int32_t* __restrict__ lengths, float* __restrict__ dq,
             float* __restrict__ visits, int Sq, int Sk, int H, int D, Layout lq, Layout lkv,
             float scale, int rows, int ktile) {
    constexpr int PITCH = DP + 4;
    extern __shared__ __align__(16) float fsm[];
    const int pp = score_pitch(ktile);
    float* q_s = fsm;                   // [rows][PITCH]
    float* do_s = q_s + rows * PITCH;   // [rows][PITCH]
    float* k_s = do_s + rows * PITCH;   // [ktile][PITCH]
    float* v_s = k_s + ktile * PITCH;   // [ktile][PITCH]
    float* ds_s = v_s + ktile * PITCH;  // [rows][pp]
    float* lse_s = ds_s + rows * pp;    // [rows]
    float* delta_s = lse_s + rows;      // [rows]
    const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * rows;
    const int tid = threadIdx.x, threads = blockDim.x;
    const int rq = rows / 4, nd = DP / 4;
    const Layout ld = {(long long)Sq * H * D, (long long)H * D, D};
    const int len = lengths ? min((int)lengths[b], Sk) : Sk;

    stage_f32<DP, VEC>(q_s, PITCH, q, lq, b, h, row0, rows, Sq, D);
    stage_f32<DP, VEC>(do_s, PITCH, dout, ld, b, h, row0, rows, Sq, D);
    tc::cp_async_commit();
    for (int r = tid; r < rows; r += threads) {
        const int row = row0 + r;
        const size_t at = ((size_t)b * H + h) * Sq + row;
        lse_s[r] = row < Sq ? lse[at] : 0.f;
        delta_s[r] = row < Sq ? delta[at] : 0.f;
    }

    float acc[F32_OUT_TILES][4][4] = {};
    int steps = 0;
    for (int k0 = 0; k0 < len; k0 += ktile) {
        __syncthreads();  // the previous tile's readers are done with k_s, v_s and ds_s
        stage_f32<DP, VEC>(k_s, PITCH, k, lkv, b, h, k0, ktile, len, D);
        stage_f32<DP, VEC>(v_s, PITCH, v, lkv, b, h, k0, ktile, len, D);
        tc::cp_async_commit();
        tc::cp_async_wait<0>();
        __syncthreads();
        const int n = min(ktile, len - k0);  // keys of this tile before the length
        const int nk = (n + 3) / 4;          // groups of 4 keys
        steps += (n + TILE - 1) / TILE;
        for (int t = tid; t < rq * nk; t += threads) {
            const int ri = t / nk, kg = t - ri * nk;
            float s[4][4], dp[4][4];
            dots4x4<DP>(s, q_s + 4 * ri * PITCH, PITCH, k_s + kg * PITCH, nk * PITCH);
            dots4x4<DP>(dp, do_s + 4 * ri * PITCH, PITCH, v_s + kg * PITCH, nk * PITCH);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int r = 4 * ri + i;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int key = kg + j * nk;
                    float ds = 0.f;  // exactly 0 at keys >= len
                    if (k0 + key < len) {
                        const float p = expf(s[i][j] * scale - lse_s[r]);
                        ds = p * (dp[i][j] - delta_s[r]);
                    }
                    ds_s[r * pp + key] = ds;
                }
            }
        }
        __syncthreads();
#pragma unroll
        for (int o = 0; o < F32_OUT_TILES; ++o) {  // dQ += dS K, keys ascending
            const int t = tid + o * threads;
            if (t >= rq * nd) continue;
            const int ri = t / nd, dj = t - ri * nd;
            accumulate4x4(acc[o], ds_s + 4 * ri * pp, pp, k_s + 4 * dj, PITCH, 4 * nk);
        }
    }
    tc::cp_async_wait<0>();  // Q and dO, when no key tile was entered

#pragma unroll
    for (int o = 0; o < F32_OUT_TILES; ++o) {
        const int t = tid + o * threads;
        if (t >= rq * nd) continue;
        const int ri = t / nd, dj = t - ri * nd;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int row = row0 + 4 * ri + i;
            if (row >= Sq) continue;
            float* orow = dq + (((size_t)b * Sq + row) * H + h) * D;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int d = 4 * dj + c;
                if (d < D) orow[d] = acc[o][i][c] * scale;
            }
        }
    }
    for (int r = tid; visits && r < rows; r += threads) {
        if (row0 + r < Sq) visits[((size_t)b * H + h) * Sq + row0 + r] = (float)steps;
    }
}

// dK and dV: one block per (group of `rows` key rows, h, b), `threads` threads, Q, dO,
// lse and delta staged in tiles of `qtile` queries (all of them up to ONE_PASS_KEYS).
// Only the block's keys before the length take part, in groups of 4: a group at or
// past it does no work and its dK and dV are exact zeros. Per tile: P^T and dS^T into
// p_s and ds_s (a thread 4 keys x 4 queries: queries qg + j * nq), then dV += P^T dO and
// dK += dS^T Q in registers (a thread one tile of 4 keys x 4 dims of each: the plan
// gives every tile a thread, and the kernel at most 128 registers a thread, so that
// three blocks of 160 threads share an SM at ViT's shape).
template <int DP, bool VEC>
__global__ void __launch_bounds__(F32_MAX_THREADS, 2)
flash_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const int32_t* __restrict__ lengths, float* __restrict__ dk,
              float* __restrict__ dv, float* __restrict__ visits, int Sq, int Sk, int H, int D,
              Layout lq, Layout lkv, float scale, int rows, int qtile) {
    constexpr int PITCH = DP + 4;
    extern __shared__ __align__(16) float fsm[];
    const int pp = score_pitch(qtile);
    float* k_s = fsm;                    // [rows][PITCH]
    float* v_s = k_s + rows * PITCH;     // [rows][PITCH]
    float* q_s = v_s + rows * PITCH;     // [qtile][PITCH]
    float* do_s = q_s + qtile * PITCH;   // [qtile][PITCH]
    float* p_s = do_s + qtile * PITCH;   // [rows][pp]: P^T
    float* ds_s = p_s + rows * pp;       // [rows][pp]: dS^T
    float* lse_s = ds_s + rows * pp;     // [qtile]
    float* delta_s = lse_s + qtile;      // [qtile]
    const int b = blockIdx.z, h = blockIdx.y, key0 = blockIdx.x * rows;
    const int tid = threadIdx.x, threads = blockDim.x;
    const int rq = rows / 4, nd = DP / 4;
    const Layout ld = {(long long)Sq * H * D, (long long)H * D, D};
    const int len = lengths ? min((int)lengths[b], Sk) : Sk;
    const int rk = (min(max(len - key0, 0), rows) + 3) / 4;  // key groups with work
    const int ko = tid / nd, dj = tid - ko * nd;  // the thread's output tile

    if (visits) {  // each KEY_BLOCK whose first key is this block's: 1 if before the length
        const int kblocks = (Sk + KEY_BLOCK - 1) / KEY_BLOCK;
        const int end = min(key0 + rows, Sk);
        for (int kb = (key0 + KEY_BLOCK - 1) / KEY_BLOCK + tid; kb * KEY_BLOCK < end;
             kb += threads)
            visits[((size_t)b * H + h) * kblocks + kb] = kb * KEY_BLOCK < len ? 1.f : 0.f;
    }
    float acc_k[4][4] = {}, acc_v[4][4] = {};
    if (rk > 0) {
        stage_f32<DP, VEC>(k_s, PITCH, k, lkv, b, h, key0, rows, len, D);
        stage_f32<DP, VEC>(v_s, PITCH, v, lkv, b, h, key0, rows, len, D);
        tc::cp_async_commit();
        for (int q0 = 0; q0 < Sq; q0 += qtile) {
            __syncthreads();  // the previous tile's readers are done with it
            stage_f32<DP, VEC>(q_s, PITCH, q, lq, b, h, q0, qtile, Sq, D);
            stage_f32<DP, VEC>(do_s, PITCH, dout, ld, b, h, q0, qtile, Sq, D);
            tc::cp_async_commit();
            for (int i = tid; i < qtile; i += threads) {
                const int row = q0 + i;
                const size_t at = ((size_t)b * H + h) * Sq + row;
                lse_s[i] = row < Sq ? lse[at] : 0.f;
                delta_s[i] = row < Sq ? delta[at] : 0.f;
            }
            tc::cp_async_wait<0>();
            __syncthreads();
            const int n = min(qtile, Sq - q0);  // queries of this tile
            const int nq = (n + 3) / 4;         // groups of 4 queries
            for (int t = tid; t < rk * nq; t += threads) {
                const int ki = t / nq, qg = t - ki * nq;
                float s[4][4], dp[4][4];
                dots4x4<DP>(s, k_s + 4 * ki * PITCH, PITCH, q_s + qg * PITCH, nq * PITCH);
                dots4x4<DP>(dp, v_s + 4 * ki * PITCH, PITCH, do_s + qg * PITCH, nq * PITCH);
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int r = 4 * ki + i;
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const int col = qg + j * nq;  // the tile's query
                        float p = 0.f, ds = 0.f;      // exactly 0 at keys >= len
                        if (key0 + r < len && col < n) {
                            p = expf(s[i][j] * scale - lse_s[col]);
                            ds = p * (dp[i][j] - delta_s[col]);
                        }
                        p_s[r * pp + col] = p;
                        ds_s[r * pp + col] = ds;
                    }
                }
            }
            __syncthreads();
            if (ko < rk) {  // queries ascending
                accumulate4x4(acc_v, p_s + 4 * ko * pp, pp, do_s + 4 * dj, PITCH, 4 * nq);
                accumulate4x4(acc_k, ds_s + 4 * ko * pp, pp, q_s + 4 * dj, PITCH, 4 * nq);
            }
        }
    }

    if (ko >= rq) return;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int key = key0 + 4 * ko + i;
        if (key >= Sk) continue;
        const size_t at = (((size_t)b * Sk + key) * H + h) * D;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const int d = 4 * dj + c;
            if (d < D) {
                dk[at + d] = acc_k[i][c] * scale;
                dv[at + d] = acc_v[i][c];
            }
        }
    }
}

// lets `kernel` take `smem` bytes of dynamic shared memory (above 48 KB only
// on request: the f32 backward at ViT's shape, and D = 128)
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    return cudaSuccess;
}


// whether a [B, S, H, D] operand of `el`-byte elements (bf16 by default) may be staged
// by 16-byte copies: base 16-byte aligned, row strides and D whole multiples of 16
// bytes (the rule of `views_aligned16`)
bool aligned16(const void* p, Layout L, int D, int el = 2) {
    const int n = 16 / el;  // elements per 16 bytes
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && L.b % n == 0 && L.s % n == 0 &&
           L.h % n == 0 && D % n == 0;
}

// rows per block and the staged tile of the other axis for the bf16 backward: one block
// of ceil(rows / 16) warps per (b, h) up to 8 warps, and the whole other axis (padded to
// 16) up to ONE_PASS_KEYS, else tiles of KEY_TILE
struct BwdPlan {
    int warps, tile;
    dim3 grid;
};

BwdPlan bwd_plan(int B, int rows, int other, int H) {
    const int warps = min(MMA_MAX_WARPS, (rows + 15) / 16);
    const int tile = other <= ONE_PASS_KEYS ? (other + 15) & ~15 : KEY_TILE;
    return {warps, tile, dim3((rows + warps * 16 - 1) / (warps * 16), H, B)};
}

template <int DP, bool VEC>
cudaError_t launch_dq_mma(const __nv_bfloat16* q, const __nv_bfloat16* k,
                          const __nv_bfloat16* v, const __nv_bfloat16* dout, const float* lse,
                          const float* delta, const int32_t* lengths, __nv_bfloat16* dq,
                          float* visits, int B, int Sq, int Sk, int H, int D, Layout lq,
                          Layout lkv, float scale, cudaStream_t st) {
    const BwdPlan pl = bwd_plan(B, Sq, Sk, H);
    const size_t smem = sizeof(__nv_bfloat16) * (DP + 8) * (size_t)(2 * pl.warps * 16 + 2 * pl.tile);
    const cudaError_t err = allow_smem(flash_dq_mma<DP, VEC>, smem);
    if (err != cudaSuccess) return err;
    flash_dq_mma<DP, VEC><<<pl.grid, pl.warps * 32, smem, st>>>(
        q, k, v, dout, lse, delta, lengths, dq, visits, Sq, Sk, H, D, lq, lkv, pl.tile, scale);
    return cudaGetLastError();
}

template <int DP, bool VEC>
cudaError_t launch_dkv_mma(const __nv_bfloat16* q, const __nv_bfloat16* k,
                           const __nv_bfloat16* v, const __nv_bfloat16* dout, const float* lse,
                           const float* delta, const int32_t* lengths, __nv_bfloat16* dk,
                           __nv_bfloat16* dv, float* visits, int B, int Sq, int Sk, int H,
                           int D, Layout lq, Layout lkv, float scale, cudaStream_t st) {
    const BwdPlan pl = bwd_plan(B, Sk, Sq, H);
    const size_t smem = sizeof(__nv_bfloat16) * (DP + 8) * (size_t)(2 * pl.warps * 16 + 2 * pl.tile) +
                        sizeof(float) * 2 * pl.tile;
    const cudaError_t err = allow_smem(flash_dkv_mma<DP, VEC>, smem);
    if (err != cudaSuccess) return err;
    flash_dkv_mma<DP, VEC><<<pl.grid, pl.warps * 32, smem, st>>>(
        q, k, v, dout, lse, delta, lengths, dk, dv, visits, Sq, Sk, H, D, lq, lkv, pl.tile,
        scale);
    return cudaGetLastError();
}

int padded_dim(int D) { return D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : 128; }

// the f32 kernels, each with its own shared-memory layout and its own output tiles a
// thread owns (F32_OUT_TILES in the forward and dQ, one of dK and one of dV in dK/dV)
enum F32Kernel { F32_FWD, F32_DQ, F32_DKV };

// shared-memory bytes of one f32 block owning `rows` rows against a tile of `tile` rows
// of the other axis (both padded by 4 floats to DP + 4). Forward: the scores (rows of
// tile + 4 floats) and three row statistics. Backward: dS (and P^T in dK/dV) and two
// statistics per query row held.
size_t f32_smem(F32Kernel kind, int rows, int tile, int DP) {
    const size_t pitch = DP + 4;
    if (kind == F32_FWD)
        return sizeof(float) * (((size_t)rows + 2 * (size_t)tile) * pitch +
                                (size_t)rows * (tile + 4) + 3 * (size_t)rows);
    const bool dkv = kind == F32_DKV;
    const size_t pp = score_pitch(tile);
    return sizeof(float) * ((2 * (size_t)rows + 2 * (size_t)tile) * pitch +
                            (dkv ? 2 : 1) * (size_t)rows * pp + 2 * (size_t)(dkv ? tile : rows));
}

// an f32 kernel's plan for `own` rows per (b, h) against `other` (the wrapper's
// `f32_forward_plan` and `f32_backward_plan`, functions of the shape alone): the other
// axis in one tile up to ONE_PASS_KEYS (rounded up to 4), tiles of F32_KEY_TILE above;
// the rows in enough groups to reach F32_TARGET_BLOCKS (none under 16 rows, at most
// F32_MAX_ROWS a group), rounded up to 4, then cut by 4 while the output needs more
// tiles than the threads hold or the block's shared memory does not fit; threads enough
// for one 4 x 4 tile of scores each and those output tiles, in whole warps, 64 to
// F32_MAX_THREADS
struct F32Plan {
    int rows, tile, threads;
};

F32Plan f32_plan(F32Kernel kind, int B, int own, int other, int H, int D) {
    const int tile = other <= ONE_PASS_KEYS ? (max(other, 1) + 3) & ~3 : F32_KEY_TILE;
    const int target = (F32_TARGET_BLOCKS + B * H - 1) / (B * H);
    const int groups = max((own + F32_MAX_ROWS - 1) / F32_MAX_ROWS, min((own + 15) / 16, target));
    const int DP = padded_dim(D), per = kind == F32_DKV ? 1 : F32_OUT_TILES;
    int rows = (((own + groups - 1) / groups) + 3) & ~3;
    while (rows > 4 && (rows / 4 * (DP / 4) > per * F32_MAX_THREADS ||
                        f32_smem(kind, rows, tile, DP) > SMEM_LIMIT))
        rows -= 4;
    const int out_tiles = (rows / 4 * (DP / 4) + per - 1) / per;
    const int tiles = max(rows / 4 * (tile / 4), out_tiles);
    return {rows, tile, min(F32_MAX_THREADS, max(64, (tiles + 31) & ~31))};
}

// the forward's launch for [B, Sq | Sk, H, D]: the grid, threads and dynamic shared memory
// of its kernel, and the query rows a block owns and the keys it stages at a time.
// bf16: blocks of ceil(Sq / 16) warps up to MMA_MAX_WARPS, every key (padded to 16) up to
// ONE_PASS_KEYS (`flash_fwd_mma_onepass`), tiles of KEY_TILE above (`flash_fwd_mma_tiled`);
// f32 (`flash_fwd_f32`): `f32_plan` over the query rows against the keys.
struct FwdPlan {
    dim3 grid;
    int threads;
    size_t smem;
    int rows, tile;
};

FwdPlan fwd_plan(int B, int Sq, int Sk, int H, int D, bool bf16) {
    const int DP = padded_dim(D);
    if (bf16) {
        const int warps = min(MMA_MAX_WARPS, (Sq + 15) / 16), rows = warps * 16;
        const int tile = Sk <= ONE_PASS_KEYS ? (Sk + 15) & ~15 : KEY_TILE;
        return {dim3((Sq + rows - 1) / rows, H, B), warps * 32,
                sizeof(__nv_bfloat16) * (DP + 8) * (size_t)(rows + 2 * tile), rows, tile};
    }
    const F32Plan p = f32_plan(F32_FWD, B, Sq, Sk, H, D);
    return {dim3((Sq + p.rows - 1) / p.rows, H, B), p.threads,
            f32_smem(F32_FWD, p.rows, p.tile, DP), p.rows, p.tile};
}

// The empty kernel with the forward's arguments: its launch floor.
__global__ void flash_fwd_empty(const void*, const void*, const void*, const int32_t*, void*,
                                float*, float*, int, int, int, int, Layout, Layout, float, int,
                                int) {}

// `kernel` on the plan's grid, block and shared memory, on stream `st`
template <typename K, typename... Args>
cudaError_t launch_fwd(K kernel, const FwdPlan& pl, cudaStream_t st, Args... args) {
    const cudaError_t err = allow_smem(kernel, pl.smem);
    if (err != cudaSuccess) return err;
    kernel<<<pl.grid, pl.threads, pl.smem, st>>>(args...);
    return cudaGetLastError();
}

// the forward for head dims padded to DP: the bf16 kernels on the tensor cores (one pass
// up to ONE_PASS_KEYS keys, key tiles above) or the f32 kernel, by the plan; `normalized`
// picks the rounding rule
template <int DP, bool VEC>
cudaError_t launch_fwd_dp(const void* q, const void* k, const void* v, const int32_t* lens,
                          void* out, float* lse, float* vis, int Sq, int Sk, int H, int D,
                          Layout lq, Layout lkv, bool bf16, bool normalized, float scale,
                          const FwdPlan& pl, cudaStream_t st) {
    if (bf16) {
        const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(q);
        const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(k);
        const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(v);
        __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out);
        if (Sk <= ONE_PASS_KEYS) {
            auto kernel = normalized ? flash_fwd_mma_onepass<DP, VEC, true>
                                     : flash_fwd_mma_onepass<DP, VEC, false>;
            return launch_fwd(kernel, pl, st, qb, kb, vb, lens, ob, lse, vis, Sq, Sk, H, D, lq,
                              lkv, scale);
        }
        auto kernel = normalized ? flash_fwd_mma_tiled<DP, VEC, true>
                                 : flash_fwd_mma_tiled<DP, VEC, false>;
        return launch_fwd(kernel, pl, st, qb, kb, vb, lens, ob, lse, vis, Sq, Sk, H, D, lq, lkv,
                          scale);
    }
    auto kernel = normalized ? flash_fwd_f32<DP, VEC, true> : flash_fwd_f32<DP, VEC, false>;
    return launch_fwd(kernel, pl, st, static_cast<const float*>(q),
                      static_cast<const float*>(k), static_cast<const float*>(v), lens,
                      static_cast<float*>(out), lse, vis, Sq, Sk, H, D, lq, lkv, scale, pl.rows,
                      pl.tile);
}

template <int DP, bool VEC>
cudaError_t launch_dq_f32(const float* q, const float* k, const float* v, const float* dout,
                          const float* lse, const float* delta, const int32_t* lengths,
                          float* dq, float* visits, int B, int Sq, int Sk, int H, int D,
                          Layout lq, Layout lkv, float scale, cudaStream_t st) {
    const F32Plan pl = f32_plan(F32_DQ, B, Sq, Sk, H, D);
    const size_t smem = f32_smem(F32_DQ, pl.rows, pl.tile, DP);
    const cudaError_t err = allow_smem(flash_dq_f32<DP, VEC>, smem);
    if (err != cudaSuccess) return err;
    flash_dq_f32<DP, VEC><<<dim3((Sq + pl.rows - 1) / pl.rows, H, B), pl.threads, smem, st>>>(
        q, k, v, dout, lse, delta, lengths, dq, visits, Sq, Sk, H, D, lq, lkv, scale, pl.rows,
        pl.tile);
    return cudaGetLastError();
}

template <int DP, bool VEC>
cudaError_t launch_dkv_f32(const float* q, const float* k, const float* v, const float* dout,
                           const float* lse, const float* delta, const int32_t* lengths,
                           float* dk, float* dv, float* visits, int B, int Sq, int Sk, int H,
                           int D, Layout lq, Layout lkv, float scale, cudaStream_t st) {
    const F32Plan pl = f32_plan(F32_DKV, B, Sk, Sq, H, D);
    const size_t smem = f32_smem(F32_DKV, pl.rows, pl.tile, DP);
    const cudaError_t err = allow_smem(flash_dkv_f32<DP, VEC>, smem);
    if (err != cudaSuccess) return err;
    flash_dkv_f32<DP, VEC><<<dim3((Sk + pl.rows - 1) / pl.rows, H, B), pl.threads, smem, st>>>(
        q, k, v, dout, lse, delta, lengths, dk, dv, visits, Sq, Sk, H, D, lq, lkv, scale,
        pl.rows, pl.tile);
    return cudaGetLastError();
}

// whether every operand of an f32 backward call may be staged by 16-byte copies
bool f32_bwd_vec(const void* q, const void* k, const void* v, const void* dout, Layout lq,
                 Layout lkv, int Sq, int H, int D) {
    const Layout ld = {(long long)Sq * H * D, (long long)H * D, D};
    return aligned16(q, lq, D, 4) && aligned16(k, lkv, D, 4) && aligned16(v, lkv, D, 4) &&
           aligned16(dout, ld, D, 4);
}

}  // namespace

// 1 when the bf16 backward's entry points stage a [B, S, H, D] view at `p` with these
// strides (in elements) by 16-byte copies, else 0: their own rule, exported so that
// the card tests hold it to `views_aligned16`, which decides for the forward
extern "C" int dmt_flash_aligned16(const void* p, long long sb, long long ss, long long sh,
                                   int D) {
    return aligned16(p, Layout{sb, ss, sh}, D) ? 1 : 0;
}

// the f32 backward's plans for [B, Sq | Sk, H, D] into out[0..5]: the dQ kernel's rows,
// key tile and threads, then the dK/dV kernel's rows, query tile and threads; exported
// so that the card tests hold it to the wrapper's `f32_backward_plan`
extern "C" void dmt_flash_f32_backward_plan(int B, int Sq, int Sk, int H, int D, int* out) {
    const F32Plan dq = f32_plan(F32_DQ, B, Sq, Sk, H, D);
    const F32Plan dkv = f32_plan(F32_DKV, B, Sk, Sq, H, D);
    const int plan[6] = {dq.rows, dq.tile, dq.threads, dkv.rows, dkv.tile, dkv.threads};
    for (int i = 0; i < 6; ++i) out[i] = plan[i];
}

// the forward's launch plan for [B, Sq | Sk, H, D] into out[0..6]: the grid's x, y and z,
// the threads, the dynamic shared-memory bytes, the query rows a block owns and the keys
// it stages at a time; exported so that the card tests hold it to the wrapper's
// `forward_plan`
extern "C" void dmt_flash_forward_plan(int B, int Sq, int Sk, int H, int D, int is_bf16,
                                       int* out) {
    const FwdPlan p = fwd_plan(B, Sq, Sk, H, D, is_bf16 != 0);
    const int plan[7] = {(int)p.grid.x, (int)p.grid.y, (int)p.grid.z, p.threads, (int)p.smem,
                         p.rows, p.tile};
    for (int i = 0; i < 7; ++i) out[i] = plan[i];
}

// Each entry point launches one kernel on `stream` (PyTorch's current stream)
// and returns cudaGetLastError() after the launch: nonzero means the launch was
// refused and nothing ran. Strides are in elements.

// The forward: q [B, Sq, H, D] against k and v [B, Sk, H, D] (k and v with one set of
// strides); `lengths` (optional, int32 [B]) masks each row's keys at and past its length
// and takes the streamed rule; `visits` (optional, f32 [B, H, Sq]) gets the steps of TILE
// keys each query row entered; `vec`: every view may be staged by 16-byte copies
extern "C" int dmt_flash_attention_fwd(const void* q, const void* k, const void* v,
                                       const void* lengths, void* out, void* lse, void* visits,
                                       int B, int Sq, int Sk, int H, int D, long long qsb,
                                       long long qss, long long qsh, long long ksb,
                                       long long kss, long long ksh, int is_bf16,
                                       int normalized, int vec, float scale, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const Layout lq = {qsb, qss, qsh}, lkv = {ksb, kss, ksh};
    const int32_t* lens = static_cast<const int32_t*>(lengths);
    float* l = static_cast<float*>(lse);
    float* vis = static_cast<float*>(visits);
    const FwdPlan pl = fwd_plan(B, Sq, Sk, H, D, is_bf16 != 0);
    const bool bf16 = is_bf16 != 0, norm = normalized != 0;
#define DMT_FWD(DP)                                                                          \
    return static_cast<int>(                                                                 \
        vec ? launch_fwd_dp<DP, true>(q, k, v, lens, out, l, vis, Sq, Sk, H, D, lq, lkv, bf16, \
                                      norm, scale, pl, st)                                   \
            : launch_fwd_dp<DP, false>(q, k, v, lens, out, l, vis, Sq, Sk, H, D, lq, lkv,    \
                                       bf16, norm, scale, pl, st))
    if (D <= 16) { DMT_FWD(16); }
    if (D <= 32) { DMT_FWD(32); }
    if (D <= 64) { DMT_FWD(64); }
    DMT_FWD(128);
#undef DMT_FWD
}

// The same arguments into an empty kernel of the forward's grid, block and shared
// memory: what a launch costs before the kernel does anything.
extern "C" int dmt_flash_attention_fwd_empty(const void* q, const void* k, const void* v,
                                             const void* lengths, void* out, void* lse,
                                             void* visits, int B, int Sq, int Sk, int H, int D,
                                             long long qsb, long long qss, long long qsh,
                                             long long ksb, long long kss, long long ksh,
                                             int is_bf16, int normalized, int vec, float scale,
                                             void* stream) {
    (void)normalized;
    (void)vec;
    const FwdPlan pl = fwd_plan(B, Sq, Sk, H, D, is_bf16 != 0);
    return static_cast<int>(launch_fwd(
        flash_fwd_empty, pl, static_cast<cudaStream_t>(stream), q, k, v,
        static_cast<const int32_t*>(lengths), out, static_cast<float*>(lse),
        static_cast<float*>(visits), Sq, Sk, H, D, Layout{qsb, qss, qsh}, Layout{ksb, kss, ksh},
        scale, pl.rows, pl.tile));
}

extern "C" int dmt_flash_attention_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      const void* lengths, void* dq, void* visits, int B, int Sq,
                                      int Sk, int H, int D, long long qsb, long long qss,
                                      long long qsh, long long ksb, long long kss,
                                      long long ksh, int is_bf16, float scale, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const Layout lq = {qsb, qss, qsh}, lkv = {ksb, kss, ksh};
    const float* l = static_cast<const float*>(lse);
    const float* dl = static_cast<const float*>(delta);
    const int32_t* lens = static_cast<const int32_t*>(lengths);
    float* vis = static_cast<float*>(visits);
    cudaError_t err;
    if (is_bf16) {  // the tensor-core kernel
        const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(q);
        const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(k);
        const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(v);
        const __nv_bfloat16* db = static_cast<const __nv_bfloat16*>(dout);
        __nv_bfloat16* dqb = static_cast<__nv_bfloat16*>(dq);
        const Layout ld = {(long long)Sq * H * D, (long long)H * D, D};
        const bool vec = aligned16(q, lq, D) && aligned16(k, lkv, D) && aligned16(v, lkv, D) &&
                         aligned16(dout, ld, D);
#define DMT_DQ_MMA(DP)                                                                       \
    err = vec ? launch_dq_mma<DP, true>(qb, kb, vb, db, l, dl, lens, dqb, vis, B, Sq, Sk, H, D, \
                                        lq, lkv, scale, st)                                   \
              : launch_dq_mma<DP, false>(qb, kb, vb, db, l, dl, lens, dqb, vis, B, Sq, Sk, H,  \
                                         D, lq, lkv, scale, st)
        if (D <= 16) { DMT_DQ_MMA(16); }
        else if (D <= 32) { DMT_DQ_MMA(32); }
        else if (D <= 64) { DMT_DQ_MMA(64); }
        else { DMT_DQ_MMA(128); }
#undef DMT_DQ_MMA
        return static_cast<int>(err);
    }
    const float* qf = static_cast<const float*>(q);  // the CUDA-core kernel
    const float* kf = static_cast<const float*>(k);
    const float* vf = static_cast<const float*>(v);
    const float* df = static_cast<const float*>(dout);
    float* dqf = static_cast<float*>(dq);
    const bool vec = f32_bwd_vec(q, k, v, dout, lq, lkv, Sq, H, D);
#define DMT_DQ_F32(DP)                                                                       \
    err = vec ? launch_dq_f32<DP, true>(qf, kf, vf, df, l, dl, lens, dqf, vis, B, Sq, Sk, H, D, \
                                        lq, lkv, scale, st)                                   \
              : launch_dq_f32<DP, false>(qf, kf, vf, df, l, dl, lens, dqf, vis, B, Sq, Sk, H,  \
                                         D, lq, lkv, scale, st)
    if (D <= 16) { DMT_DQ_F32(16); }
    else if (D <= 32) { DMT_DQ_F32(32); }
    else if (D <= 64) { DMT_DQ_F32(64); }
    else { DMT_DQ_F32(128); }
#undef DMT_DQ_F32
    return static_cast<int>(err);
}

extern "C" int dmt_flash_attention_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       const void* lengths, void* dk, void* dv, void* visits,
                                       int B, int Sq, int Sk, int H, int D, long long qsb,
                                       long long qss, long long qsh, long long ksb,
                                       long long kss, long long ksh, int is_bf16, float scale,
                                       void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const Layout lq = {qsb, qss, qsh}, lkv = {ksb, kss, ksh};
    const float* l = static_cast<const float*>(lse);
    const float* dl = static_cast<const float*>(delta);
    const int32_t* lens = static_cast<const int32_t*>(lengths);
    float* vis = static_cast<float*>(visits);
    cudaError_t err;
    if (is_bf16) {  // the tensor-core kernel
        const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(q);
        const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(k);
        const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(v);
        const __nv_bfloat16* db = static_cast<const __nv_bfloat16*>(dout);
        __nv_bfloat16* dkb = static_cast<__nv_bfloat16*>(dk);
        __nv_bfloat16* dvb = static_cast<__nv_bfloat16*>(dv);
        const Layout ld = {(long long)Sq * H * D, (long long)H * D, D};
        const bool vec = aligned16(q, lq, D) && aligned16(k, lkv, D) && aligned16(v, lkv, D) &&
                         aligned16(dout, ld, D);
#define DMT_DKV_MMA(DP)                                                                      \
    err = vec ? launch_dkv_mma<DP, true>(qb, kb, vb, db, l, dl, lens, dkb, dvb, vis, B, Sq, Sk, \
                                         H, D, lq, lkv, scale, st)                            \
              : launch_dkv_mma<DP, false>(qb, kb, vb, db, l, dl, lens, dkb, dvb, vis, B, Sq,   \
                                          Sk, H, D, lq, lkv, scale, st)
        if (D <= 16) { DMT_DKV_MMA(16); }
        else if (D <= 32) { DMT_DKV_MMA(32); }
        else if (D <= 64) { DMT_DKV_MMA(64); }
        else { DMT_DKV_MMA(128); }
#undef DMT_DKV_MMA
        return static_cast<int>(err);
    }
    const float* qf = static_cast<const float*>(q);  // the CUDA-core kernel
    const float* kf = static_cast<const float*>(k);
    const float* vf = static_cast<const float*>(v);
    const float* df = static_cast<const float*>(dout);
    float* dkf = static_cast<float*>(dk);
    float* dvf = static_cast<float*>(dv);
    const bool vec = f32_bwd_vec(q, k, v, dout, lq, lkv, Sq, H, D);
#define DMT_DKV_F32(DP)                                                                      \
    err = vec ? launch_dkv_f32<DP, true>(qf, kf, vf, df, l, dl, lens, dkf, dvf, vis, B, Sq, Sk, \
                                         H, D, lq, lkv, scale, st)                            \
              : launch_dkv_f32<DP, false>(qf, kf, vf, df, l, dl, lens, dkf, dvf, vis, B, Sq,   \
                                          Sk, H, D, lq, lkv, scale, st)
    if (D <= 16) { DMT_DKV_F32(16); }
    else if (D <= 32) { DMT_DKV_F32(32); }
    else if (D <= 64) { DMT_DKV_F32(64); }
    else { DMT_DKV_F32(128); }
#undef DMT_DKV_F32
    return static_cast<int>(err);
}
