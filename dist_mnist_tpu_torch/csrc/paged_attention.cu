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
// Grid. The TPU kernel runs a sequential grid over (r, h, page) and still DMAs
// pages past the length (it only skips their math). Here one warp owns one
// (r, h) (csrc/decode_attention.cuh: G lanes a token, 16 dimensions a lane,
// SLICE = 32 / G tokens at a time; at the decode path's D = 16 lane i owns
// token i of a 32-token slice) and walks the row's positions [0, L), L =
// min(len, n*T), in slices. A slice may end inside a page (T = 200) or span
// several (T = 8); each lane steps its own token's page and offset from slice to
// slice without a division. Positions at or past L are never read, so a page at
// or past ceil(len / T) is never read. Page ids are clamped into [0, P) so a bad
// table cannot read outside the pool; lengths must be 1 <= len <= n*T, as in the
// reference.
//
// What bounds it. The decode step reads each active page's int8 K and V rows
// and f32 scales once per (row, head): (D + 4) bytes per token per head for K
// and the same for V, against 4*D operations per token, so device-memory bytes
// bound it. At the serving path's shapes (R = 9, H = 8, D = 16, T = 32, one or
// two pages per row) those bytes are a few hundred KB, and the time goes to
// chains of dependent memory round trips and instructions. The design keeps that
// chain short:
//   - the length, q and the first three slices' page ids are loaded together
//     (the ids speculatively, anywhere inside the row's table);
//   - a lane's K row, V row and both scales are requested together (one 16-byte
//     load each at D = 16), and slice c + 2's loads (and slice c + 3's page
//     ids) are requested before slice c's arithmetic: a row with two active pages
//     waits on about two round trips (ids, then rows) instead of one per token;
//   - the score is dequantized in registers as the reference does
//     (f32(kq) * ks rounded, then an FMA with q, four partial sums); each lane
//     runs its own online softmax over its tokens (m, l and p @ V, rescaled by
//     alpha when its max grows), and the lanes are merged once at the end by
//     fixed butterflies (`decode::finish`): no shuffle in the slice loop and
//     no barrier anywhere.
// A split over pages with an ordered merge, for long rows, is later work.
// No --use_fast_math: expf and the final division are IEEE-accurate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decode_attention.cuh"

namespace {

using decode::DIMS;
using decode::Raw;

// One lane's share of one token: its 16 int8 K and V elements and the scales.
struct Token {
    Raw<4> k, v;
    float ks, vs;
};

// Where a lane's token of a slice lives: the page id as the table holds it and
// the token's offset in that page.
struct Where {
    int page, t;
};

template <typename T, int G, bool VEC>
__global__ void __launch_bounds__(decode::THREADS)
paged_attn_kernel(const T* __restrict__ q, const int8_t* __restrict__ kq,
                  const float* __restrict__ ks, const int8_t* __restrict__ vq,
                  const float* __restrict__ vs, const int32_t* __restrict__ table,
                  const int32_t* __restrict__ lengths, T* __restrict__ out,
                  float* __restrict__ visits, int H, int D, int Tp, int P, int n,
                  float scale) {
    constexpr int SLICE = 32 / G;  // tokens a warp takes at a time
    const int h = blockIdx.x;
    const int r = blockIdx.y;
    const int lane = threadIdx.x;
    const int slot = lane / G;         // token of the slice
    const int d0 = (lane % G) * DIMS;  // first dimension this lane holds
    const int dn = min(DIMS, D - d0);  // dimensions it holds (<= 0: none)
    const int span = n * Tp;           // positions the table covers
    const int32_t* row_table = table + static_cast<size_t>(r) * n;
    const size_t rh = static_cast<size_t>(r) * H + h;

    // a lane's position walks SLICE tokens a slice: step_j pages and step_t tokens
    const int step_j = SLICE / Tp;
    const int step_t = SLICE - step_j * Tp;
    int walk_j = slot / Tp;  // page index and token of the next slice to look up
    int walk_t = slot - walk_j * Tp;
    // the page id of slice c's token (read while the position is below `limit`)
    auto where = [&](int c, int limit) -> Where {
        const Where w{c * SLICE + slot < limit ? row_table[walk_j] : 0, walk_t};
        walk_t += step_t;
        walk_j += step_j;
        if (walk_t >= Tp) {
            walk_t -= Tp;
            ++walk_j;
        }
        return w;
    };
    // this lane's share of slice c's token, or zeros past the length
    auto load = [&](int c, Where w, int limit) -> Token {
        Token tok;
        if (c * SLICE + slot < limit) {
            const int page = min(max(w.page, 0), P - 1);
            const size_t row = (static_cast<size_t>(page) * Tp + w.t) * H + h;
            tok.ks = ks[row];
            tok.vs = vs[row];
            if constexpr (VEC) {
                if (dn > 0) {
                    decode::load_vec(tok.k, kq + row * D + d0);
                    decode::load_vec(tok.v, vq + row * D + d0);
                } else {
                    tok.k = Raw<4>{};
                    tok.v = Raw<4>{};
                }
            } else {
                decode::load_each(tok.k, kq + row * D + d0, dn);
                decode::load_each(tok.v, vq + row * D + d0, dn);
            }
        } else {
            tok.k = Raw<4>{};
            tok.v = Raw<4>{};
            tok.ks = 0.f;
            tok.vs = 0.f;
        }
        return tok;
    };

    // requested together: the length, q and the first three slices' page ids
    const int len = lengths[r];
    const Where w0 = where(0, span);
    const Where w1 = where(1, span);
    Where w2 = where(2, span);
    float qf[DIMS];
    const T* q_row = q + rh * D + d0;
#pragma unroll
    for (int e = 0; e < DIMS; ++e) qf[e] = e < dn ? decode::to_f32(q_row[e]) : 0.f;
    const int L = min(len, span);
    const int slices = L > 0 ? (L + SLICE - 1) / SLICE : 0;

    float m = -INFINITY;  // this lane's running max (m_scr starts at -inf)
    float l = 0.f;        // its running denominator, relative to m
    float acc[DIMS];      // its running p @ V, dimensions d0 .., relative to m
#pragma unroll
    for (int e = 0; e < DIMS; ++e) acc[e] = 0.f;

    Token cur = load(0, w0, L);
    Token next = load(1, w1, L);
    for (int c = 0; c < slices; ++c) {
        // slice c + 2's rows and slice c + 3's page ids, before any math
        const Where w3 = where(c + 3, L);
        const Token after = load(c + 2, w2, L);
        const bool live = c * SLICE + slot < L;

        float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int e = 0; e < DIMS; ++e)
            part[e & 3] = fmaf(qf[e], __fmul_rn(decode::elem_i8(cur.k, e), cur.ks), part[e & 3]);
        // every lane: the butterfly needs the whole warp
        const float dot = decode::token_sum<G>((part[0] + part[1]) + (part[2] + part[3]));
        const float s = dot * scale;
        // this lane's own online softmax; a lane without a live token keeps its state
        const float m_new = live ? fmaxf(m, s) : m;
        const float alpha = live ? expf(m - m_new) : 1.f;
        const float p = live ? expf(s - m_new) : 0.f;
        l = l * alpha + p;
#pragma unroll
        for (int e = 0; e < DIMS; ++e)
            acc[e] = fmaf(p, __fmul_rn(decode::elem_i8(cur.v, e), cur.vs), acc[e] * alpha);
        m = m_new;

        cur = next;
        next = after;
        w2 = w3;
    }

    decode::finish<G>(m, l, acc, out + rh * D + d0, dn, lane);
    if (lane == 0) visits[rh] = static_cast<float>(len > 0 ? min(n, (len + Tp - 1) / Tp) : 0);
}

// The empty kernel with the same arguments, grid and block: the launch floor.
__global__ void paged_attn_empty(const void*, const void*, const void*, const void*,
                                 const void*, const void*, const void*, void*, void*, int,
                                 int, int, int, int, float) {}

template <typename T, int G>
void launch_g(bool vec, dim3 grid, cudaStream_t s, const void* q, const int8_t* kq,
              const float* ks, const int8_t* vq, const float* vs, const int32_t* tab,
              const int32_t* lens, void* out, float* vis, int H, int D, int Tp, int P,
              int n, float scale) {
    const T* qt = static_cast<const T*>(q);
    T* ot = static_cast<T*>(out);
    if (vec)
        paged_attn_kernel<T, G, true><<<grid, decode::THREADS, 0, s>>>(
            qt, kq, ks, vq, vs, tab, lens, ot, vis, H, D, Tp, P, n, scale);
    else
        paged_attn_kernel<T, G, false><<<grid, decode::THREADS, 0, s>>>(
            qt, kq, ks, vq, vs, tab, lens, ot, vis, H, D, Tp, P, n, scale);
}

template <typename T>
void launch_t(int G, bool vec, dim3 grid, cudaStream_t s, const void* q, const int8_t* kq,
              const float* ks, const int8_t* vq, const float* vs, const int32_t* tab,
              const int32_t* lens, void* out, float* vis, int H, int D, int Tp, int P,
              int n, float scale) {
    switch (G) {
        case 1: launch_g<T, 1>(vec, grid, s, q, kq, ks, vq, vs, tab, lens, out, vis, H, D, Tp, P, n, scale); break;
        case 2: launch_g<T, 2>(vec, grid, s, q, kq, ks, vq, vs, tab, lens, out, vis, H, D, Tp, P, n, scale); break;
        case 4: launch_g<T, 4>(vec, grid, s, q, kq, ks, vq, vs, tab, lens, out, vis, H, D, Tp, P, n, scale); break;
        default: launch_g<T, 8>(vec, grid, s, q, kq, ks, vq, vs, tab, lens, out, vis, H, D, Tp, P, n, scale); break;
    }
}

}  // namespace

// Lanes per token, grid (H, R) and threads of a launch on R rows, H heads, head_dim D
// (`decode::plan`; the wrapper's `decode_launch_plan` computes the same).
extern "C" void dmt_paged_attention_plan(int R, int H, int D, int* out) {
    decode::plan(R, H, D, out);
}

// Launch on `stream` (PyTorch's current stream). Returns cudaGetLastError()
// after the launch: nonzero means the launch was refused and nothing ran.
extern "C" int dmt_paged_attention(const void* q, const void* kq, const void* ks,
                                   const void* vq, const void* vs, const void* table,
                                   const void* lengths, void* out, void* visits, int R,
                                   int H, int D, int Tp, int P, int n, int q_is_bf16,
                                   float scale, void* stream) {
    int plan[4];
    decode::plan(R, H, D, plan);
    const dim3 grid(plan[1], plan[2]);
    // 16-byte loads need 16-byte aligned rows: D a multiple of 16, aligned pools
    const bool vec = D % 16 == 0 &&
                     ((reinterpret_cast<uintptr_t>(kq) | reinterpret_cast<uintptr_t>(vq)) & 15) == 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int8_t* kq8 = static_cast<const int8_t*>(kq);
    const int8_t* vq8 = static_cast<const int8_t*>(vq);
    const float* ksf = static_cast<const float*>(ks);
    const float* vsf = static_cast<const float*>(vs);
    const int32_t* tab = static_cast<const int32_t*>(table);
    const int32_t* lens = static_cast<const int32_t*>(lengths);
    float* vis = static_cast<float*>(visits);
    if (q_is_bf16)
        launch_t<__nv_bfloat16>(plan[0], vec, grid, s, q, kq8, ksf, vq8, vsf, tab, lens, out,
                                vis, H, D, Tp, P, n, scale);
    else
        launch_t<float>(plan[0], vec, grid, s, q, kq8, ksf, vq8, vsf, tab, lens, out, vis, H,
                        D, Tp, P, n, scale);
    return static_cast<int>(cudaGetLastError());
}

// The same arguments into an empty kernel of the same grid and block: what a
// launch costs before the kernel does anything.
extern "C" int dmt_paged_attention_empty(const void* q, const void* kq, const void* ks,
                                         const void* vq, const void* vs, const void* table,
                                         const void* lengths, void* out, void* visits, int R,
                                         int H, int D, int Tp, int P, int n, int q_is_bf16,
                                         float scale, void* stream) {
    (void)q_is_bf16;
    int plan[4];
    decode::plan(R, H, D, plan);
    paged_attn_empty<<<dim3(plan[1], plan[2]), plan[3], 0, static_cast<cudaStream_t>(stream)>>>(
        q, kq, ks, vq, vs, table, lengths, out, visits, H, D, Tp, P, n, scale);
    return static_cast<int>(cudaGetLastError());
}
