// Flash attention, forward and backward (Hopper, sm_90a).
//
// Replaces three Pallas TPU kernels of dist_mnist_tpu/ops/pallas/flash_attention.py:
//
//   flash_fwd_kernel  <- `_flash_fwd_impl` (`_attn_fwd_kernel`, and the streamed
//                        `_attn_fwd_kernel_kt`)
//   flash_dq_kernel   <- `_flash_bwd_impl` (`_attn_dq_kernel`, `_attn_dq_kernel_kt`)
//                        and `_masked_flash_bwd_impl` (`_masked_attn_dq_kernel`)
//   flash_dkv_kernel  <- `_flash_bwd_impl` (`_attn_dkv_kernel`, `_attn_dkv_kernel_qt`)
//                        and `_masked_flash_bwd_impl` (`_masked_attn_dkv_kernel`)
//
// What they compute, per (batch row b, head h), with scale = D**-0.5:
//
//   s_ij  = dot(f32(q_i), f32(k_j)) * scale; -1e30 for keys j >= len (len = S, or
//           lengths[b] in the masked backward)
//   forward: m_i = max_j s_ij, l_i = sum_j exp(s_ij - m_i), lse_i = m_i + log(l_i)
//     normalized = 1 (the reference's full-K kernel, which every call with one
//       128-key tile takes): out_i = sum_j round_v(exp(s_ij - m_i) / l_i) * f32(v_j)
//     normalized = 0 (the reference's streamed kernel): online softmax over the
//       key tiles; out_i = (sum_j round_v(exp(s_ij - m_cur)) * f32(v_j)) / l_i
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
// contiguous [B, H, S] f32; lengths (optional) [B] int32. The forward takes
// Sq = Sk = S; the backward takes Sq and Sk apart (the masked decode shapes).
//
// Design. The TPU kernels keep a whole query tile's [block_q, S] scores in VMEM
// and let the MXU take the three or four products. Here a block of 4 warps owns
// ROWS = 16 rows (queries in the forward and dQ kernels, keys in the dK/dV kernel),
// 4 per warp, and walks the other axis in tiles of TILE = 32 staged in shared
// memory as f32, one element of the tile per lane: lane j scores its key (or
// query) against the warp's 4 rows, a warp reduction takes the row max and sum,
// and the products accumulate D/32 output dimensions per lane from the lanes'
// probabilities passed round by shuffles. Rows staged with lane-indexed reads are
// padded by one float, so 32 lanes reading one dimension of 32 rows hit 32 banks.
// The dQ and dK/dV kernels are kept apart, as on the TPU, so that every output
// element is written by one thread in a fixed order: no atomics, and the
// gradients are the same bits on every run. The normalized forward takes two
// passes over the keys (max and sum, then the product), because it divides by
// the full row sum before rounding; the streamed one takes one. Key tiles past a
// row's length are never entered; a dK/dV block wholly past the length writes
// exact zeros. No loop runs past S: keys and queries beyond it are masked where
// they could enter a softmax and read as zeros elsewhere.
//
// What bounds it. At ViT-Tiny's shape (B = 64, S = 65, H = 3, D = 64, bf16) a call
// moves a few MB and does 0.2 (forward) to 0.7 (backward) GFLOP, all of it as f32
// FMAs on the CUDA cores, because the TPU kernels form the logits from f32
// operands. Against the card's f32 rate the operations bound it, a few us; the
// tensor cores (wgmma on bf16 tiles) would lift that bound, and are later work.
// No --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int TILE = 32;           // keys (fwd, dQ) or queries (dK/dV) per tile: one per lane
constexpr int RPW = 4;             // rows a warp owns
constexpr int ROWS = WARPS * RPW;  // rows a block owns
constexpr int MAX_D = 128;
constexpr int DPL = MAX_D / 32;    // output dimensions per lane
constexpr float NEG = -1e30f;      // the reference's mask value
constexpr unsigned FULL = 0xffffffffu;

struct Layout {  // element strides of a [B, S, H, D] operand (D stride 1)
    long long b, s, h;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
    return __bfloat162float(__float2bfloat16(x));
}

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

// rows [row0, row0 + n) of (b, h) into dst (row pitch `pitch` floats) as f32;
// rows at or past `limit` read as zeros
template <typename T>
__device__ __forceinline__ void stage(float* dst, int pitch, const T* __restrict__ src, Layout L,
                                      int b, int h, int row0, int n, int limit, int D) {
    for (int e = threadIdx.x; e < n * D; e += THREADS) {
        const int r = e / D;
        const int d = e - r * D;
        const int row = row0 + r;
        dst[r * pitch + d] =
            row < limit ? to_f32(src[b * L.b + row * L.s + h * L.h + d]) : 0.f;
    }
}

template <typename T, bool NORMALIZED>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int S, int H, int D, Layout lq,
                 Layout lkv, float scale) {
    extern __shared__ float smem[];
    float* k_s = smem;                  // [TILE][D + 1]
    float* v_s = k_s + TILE * (D + 1);  // [TILE][D]
    float* q_s = v_s + TILE * D;        // [ROWS][D]

    const int b = blockIdx.z;
    const int h = blockIdx.y;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int row0 = blockIdx.x * ROWS;
    const float* qw = q_s + warp * RPW * D;
    const float* kr = k_s + lane * (D + 1);

    stage(q_s, D, q, lq, b, h, row0, ROWS, S, D);

    float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
        m[r] = NEG;
        l[r] = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
    }
    const int tiles = (S + TILE - 1) / TILE;

    if (NORMALIZED) {  // pass 1: each row's max and sum over every key
        for (int kt = 0; kt < tiles; ++kt) {
            stage(k_s, D + 1, k, lkv, b, h, kt * TILE, TILE, S, D);
            __syncthreads();  // also publishes q_s on the first tile
            float s[RPW] = {};
            for (int d = 0; d < D; ++d) {
                const float kd = kr[d];
#pragma unroll
                for (int r = 0; r < RPW; ++r) s[r] = fmaf(qw[r * D + d], kd, s[r]);
            }
            const bool real = kt * TILE + lane < S;
#pragma unroll
            for (int r = 0; r < RPW; ++r) {
                const float x = real ? s[r] * scale : NEG;
                const float m_new = fmaxf(m[r], warp_max(x));
                l[r] = l[r] * expf(m[r] - m_new) + warp_sum(expf(x - m_new));
                m[r] = m_new;
            }
            __syncthreads();  // the next tile overwrites k_s
        }
    }

    for (int kt = 0; kt < tiles; ++kt) {
        stage(k_s, D + 1, k, lkv, b, h, kt * TILE, TILE, S, D);
        stage(v_s, D, v, lkv, b, h, kt * TILE, TILE, S, D);
        __syncthreads();
        float s[RPW] = {};
        for (int d = 0; d < D; ++d) {
            const float kd = kr[d];
#pragma unroll
            for (int r = 0; r < RPW; ++r) s[r] = fmaf(qw[r * D + d], kd, s[r]);
        }
        const bool real = kt * TILE + lane < S;
        float pv[RPW];
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
            const float x = real ? s[r] * scale : NEG;
            if (NORMALIZED) {
                pv[r] = round_to(expf(x - m[r]) / l[r], T());
            } else {
                const float m_new = fmaxf(m[r], warp_max(x));
                const float alpha = expf(m[r] - m_new);
                const float p = expf(x - m_new);
                l[r] = l[r] * alpha + warp_sum(p);
#pragma unroll
                for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
                m[r] = m_new;
                pv[r] = round_to(p, T());
            }
        }
        const int nk = min(TILE, S - kt * TILE);
        for (int kk = 0; kk < nk; ++kk) {
            float vv[DPL];
#pragma unroll
            for (int i = 0; i < DPL; ++i) {
                const int d = lane + 32 * i;
                vv[i] = d < D ? v_s[kk * D + d] : 0.f;
            }
#pragma unroll
            for (int r = 0; r < RPW; ++r) {
                const float pk = __shfl_sync(FULL, pv[r], kk);
#pragma unroll
                for (int i = 0; i < DPL; ++i) acc[r][i] = fmaf(pk, vv[i], acc[r][i]);
            }
        }
        __syncthreads();
    }

#pragma unroll
    for (int r = 0; r < RPW; ++r) {
        const int row = row0 + warp * RPW + r;
        if (row >= S) continue;
        T* o = out + (((size_t)b * S + row) * H + h) * D;
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
            const int d = lane + 32 * i;
            if (d < D) store(o + d, NORMALIZED ? acc[r][i] : acc[r][i] / l[r]);
        }
        if (lane == 0) lse[((size_t)b * H + h) * S + row] = m[r] + logf(l[r]);
    }
}

// dQ over query tiles of ROWS, keys streamed in tiles of TILE up to the row's length.
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, const int32_t* __restrict__ lengths,
                T* __restrict__ dq, float* __restrict__ visits, int Sq, int Sk, int H, int D,
                Layout lq, Layout lkv, float scale) {
    extern __shared__ float smem[];
    float* k_s = smem;                   // [TILE][D + 1]
    float* v_s = k_s + TILE * (D + 1);   // [TILE][D + 1]
    float* q_s = v_s + TILE * (D + 1);   // [ROWS][D]
    float* do_s = q_s + ROWS * D;        // [ROWS][D]

    const int b = blockIdx.z;
    const int h = blockIdx.y;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int row0 = blockIdx.x * ROWS;
    const Layout ld = {(long long)Sq * H * D, (long long)H * D, D};
    const float* qw = q_s + warp * RPW * D;
    const float* dow = do_s + warp * RPW * D;
    const float* kr = k_s + lane * (D + 1);
    const float* vr = v_s + lane * (D + 1);

    stage(q_s, D, q, lq, b, h, row0, ROWS, Sq, D);
    stage(do_s, D, dout, ld, b, h, row0, ROWS, Sq, D);
    const int len = lengths ? min((int)lengths[b], Sk) : Sk;
    const int tiles = len > 0 ? (len + TILE - 1) / TILE : 0;

    float lse_r[RPW], delta_r[RPW], acc[RPW][DPL];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
        const int row = row0 + warp * RPW + r;
        const size_t at = ((size_t)b * H + h) * Sq + row;
        lse_r[r] = row < Sq ? lse[at] : 0.f;
        delta_r[r] = row < Sq ? delta[at] : 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
    }

    for (int kt = 0; kt < tiles; ++kt) {
        stage(k_s, D + 1, k, lkv, b, h, kt * TILE, TILE, Sk, D);
        stage(v_s, D + 1, v, lkv, b, h, kt * TILE, TILE, Sk, D);
        __syncthreads();
        float s[RPW] = {}, dp[RPW] = {};
        for (int d = 0; d < D; ++d) {
            const float kd = kr[d];
            const float vd = vr[d];
#pragma unroll
            for (int r = 0; r < RPW; ++r) {
                s[r] = fmaf(qw[r * D + d], kd, s[r]);
                dp[r] = fmaf(dow[r * D + d], vd, dp[r]);
            }
        }
        const bool real = kt * TILE + lane < len;
        float ds[RPW];
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
            const float p = real ? expf(s[r] * scale - lse_r[r]) : 0.f;
            ds[r] = p * (dp[r] - delta_r[r]);
        }
        const int nk = min(TILE, len - kt * TILE);
        for (int kk = 0; kk < nk; ++kk) {
            float kv[DPL];
#pragma unroll
            for (int i = 0; i < DPL; ++i) {
                const int d = lane + 32 * i;
                kv[i] = d < D ? k_s[kk * (D + 1) + d] : 0.f;
            }
#pragma unroll
            for (int r = 0; r < RPW; ++r) {
                const float dsk = __shfl_sync(FULL, ds[r], kk);
#pragma unroll
                for (int i = 0; i < DPL; ++i) acc[r][i] = fmaf(dsk, kv[i], acc[r][i]);
            }
        }
        __syncthreads();
    }

#pragma unroll
    for (int r = 0; r < RPW; ++r) {
        const int row = row0 + warp * RPW + r;
        if (row >= Sq) continue;
        T* o = dq + (((size_t)b * Sq + row) * H + h) * D;
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
            const int d = lane + 32 * i;
            if (d < D) store(o + d, acc[r][i] * scale);
        }
        if (visits && lane == 0) visits[((size_t)b * H + h) * Sq + row] = (float)tiles;
    }
}

// dK and dV over key blocks of ROWS, queries streamed in tiles of TILE. A block
// wholly at or past the row's length does no work and writes exact zeros.
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, const int32_t* __restrict__ lengths,
                 T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ visits, int Sq,
                 int Sk, int H, int D, Layout lq, Layout lkv, float scale) {
    extern __shared__ float smem[];
    float* q_s = smem;                    // [TILE][D + 1]
    float* do_s = q_s + TILE * (D + 1);   // [TILE][D + 1]
    float* k_s = do_s + TILE * (D + 1);   // [ROWS][D]
    float* v_s = k_s + ROWS * D;          // [ROWS][D]
    float* lse_s = v_s + ROWS * D;        // [TILE]
    float* delta_s = lse_s + TILE;        // [TILE]

    const int b = blockIdx.z;
    const int h = blockIdx.y;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int key0 = blockIdx.x * ROWS;
    const Layout ld = {(long long)Sq * H * D, (long long)H * D, D};
    const int len = lengths ? min((int)lengths[b], Sk) : Sk;
    const bool active = key0 < len;

    if (visits && threadIdx.x == 0)
        visits[((size_t)b * H + h) * gridDim.x + blockIdx.x] = active ? 1.f : 0.f;
    if (!active) {
        for (int e = threadIdx.x; e < ROWS * D; e += THREADS) {
            const int r = e / D;
            const int d = e - r * D;
            const int key = key0 + r;
            if (key < Sk) {
                const size_t at = (((size_t)b * Sk + key) * H + h) * D + d;
                store(dk + at, 0.f);
                store(dv + at, 0.f);
            }
        }
        return;
    }

    stage(k_s, D, k, lkv, b, h, key0, ROWS, Sk, D);
    stage(v_s, D, v, lkv, b, h, key0, ROWS, Sk, D);
    const float* kw = k_s + warp * RPW * D;
    const float* vw = v_s + warp * RPW * D;
    const float* qr = q_s + lane * (D + 1);
    const float* dr = do_s + lane * (D + 1);

    float acc_k[RPW][DPL], acc_v[RPW][DPL];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
            acc_k[r][i] = 0.f;
            acc_v[r][i] = 0.f;
        }
    }
    const int qtiles = (Sq + TILE - 1) / TILE;
    for (int qt = 0; qt < qtiles; ++qt) {
        stage(q_s, D + 1, q, lq, b, h, qt * TILE, TILE, Sq, D);
        stage(do_s, D + 1, dout, ld, b, h, qt * TILE, TILE, Sq, D);
        for (int i = threadIdx.x; i < TILE; i += THREADS) {
            const int row = qt * TILE + i;
            const size_t at = ((size_t)b * H + h) * Sq + row;
            lse_s[i] = row < Sq ? lse[at] : 0.f;
            delta_s[i] = row < Sq ? delta[at] : 0.f;
        }
        __syncthreads();  // also publishes k_s / v_s on the first tile
        float s[RPW] = {}, dp[RPW] = {};
        for (int d = 0; d < D; ++d) {
            const float qd = qr[d];
            const float dd = dr[d];
#pragma unroll
            for (int r = 0; r < RPW; ++r) {
                s[r] = fmaf(qd, kw[r * D + d], s[r]);
                dp[r] = fmaf(dd, vw[r * D + d], dp[r]);
            }
        }
        const bool q_real = qt * TILE + lane < Sq;
        float p[RPW], ds[RPW];
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
            const int key = key0 + warp * RPW + r;
            p[r] = q_real && key < len ? expf(s[r] * scale - lse_s[lane]) : 0.f;
            ds[r] = p[r] * (dp[r] - delta_s[lane]);
        }
        const int nq = min(TILE, Sq - qt * TILE);
        for (int ii = 0; ii < nq; ++ii) {
            float qv[DPL], dov[DPL];
#pragma unroll
            for (int i = 0; i < DPL; ++i) {
                const int d = lane + 32 * i;
                qv[i] = d < D ? q_s[ii * (D + 1) + d] : 0.f;
                dov[i] = d < D ? do_s[ii * (D + 1) + d] : 0.f;
            }
#pragma unroll
            for (int r = 0; r < RPW; ++r) {
                const float pi = __shfl_sync(FULL, p[r], ii);
                const float dsi = __shfl_sync(FULL, ds[r], ii);
#pragma unroll
                for (int i = 0; i < DPL; ++i) {
                    acc_v[r][i] = fmaf(pi, dov[i], acc_v[r][i]);
                    acc_k[r][i] = fmaf(dsi, qv[i], acc_k[r][i]);
                }
            }
        }
        __syncthreads();  // the next tile overwrites q_s / do_s
    }

#pragma unroll
    for (int r = 0; r < RPW; ++r) {
        const int key = key0 + warp * RPW + r;
        if (key >= Sk) continue;
        const size_t at = (((size_t)b * Sk + key) * H + h) * D;
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
            const int d = lane + 32 * i;
            if (d < D) {
                store(dk + at + d, acc_k[r][i] * scale);
                store(dv + at + d, acc_v[r][i]);
            }
        }
    }
}

// lets `kernel` take `smem` bytes of dynamic shared memory (above 48 KB only
// on request: D = 128 in the backward kernels)
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    return cudaSuccess;
}

}  // namespace

// Each entry point launches one kernel on `stream` (PyTorch's current stream)
// and returns cudaGetLastError() after the launch: nonzero means the launch was
// refused and nothing ran. Strides are in elements.

extern "C" int dmt_flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                       void* lse, int B, int S, int H, int D, long long qsb,
                                       long long qss, long long qsh, long long ksb,
                                       long long kss, long long ksh, int is_bf16,
                                       int normalized, float scale, void* stream) {
    const dim3 grid((S + ROWS - 1) / ROWS, H, B);
    const size_t smem = sizeof(float) * (TILE * (D + 1) + TILE * D + ROWS * D);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const Layout lq = {qsb, qss, qsh}, lkv = {ksb, kss, ksh};
    float* l = static_cast<float*>(lse);
    cudaError_t err;
#define DMT_FWD(T, N)                                                                      \
    err = allow_smem(flash_fwd_kernel<T, N>, smem);                                  \
    if (err != cudaSuccess) return static_cast<int>(err);                                 \
    flash_fwd_kernel<T, N><<<grid, THREADS, smem, st>>>(                                   \
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),      \
        static_cast<T*>(out), l, S, H, D, lq, lkv, scale)
    if (is_bf16) {
        if (normalized) { DMT_FWD(__nv_bfloat16, true); } else { DMT_FWD(__nv_bfloat16, false); }
    } else {
        if (normalized) { DMT_FWD(float, true); } else { DMT_FWD(float, false); }
    }
#undef DMT_FWD
    return static_cast<int>(cudaGetLastError());
}

extern "C" int dmt_flash_attention_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      const void* lengths, void* dq, void* visits, int B, int Sq,
                                      int Sk, int H, int D, long long qsb, long long qss,
                                      long long qsh, long long ksb, long long kss,
                                      long long ksh, int is_bf16, float scale, void* stream) {
    const dim3 grid((Sq + ROWS - 1) / ROWS, H, B);
    const size_t smem = sizeof(float) * (2 * TILE * (D + 1) + 2 * ROWS * D);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const Layout lq = {qsb, qss, qsh}, lkv = {ksb, kss, ksh};
    const float* l = static_cast<const float*>(lse);
    const float* dl = static_cast<const float*>(delta);
    const int32_t* lens = static_cast<const int32_t*>(lengths);
    float* vis = static_cast<float*>(visits);
    cudaError_t err;
#define DMT_DQ(T)                                                                          \
    err = allow_smem(flash_dq_kernel<T>, smem);                                      \
    if (err != cudaSuccess) return static_cast<int>(err);                                 \
    flash_dq_kernel<T><<<grid, THREADS, smem, st>>>(                                       \
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),      \
        static_cast<const T*>(dout), l, dl, lens, static_cast<T*>(dq), vis, Sq, Sk, H, D,  \
        lq, lkv, scale)
    if (is_bf16) { DMT_DQ(__nv_bfloat16); } else { DMT_DQ(float); }
#undef DMT_DQ
    return static_cast<int>(cudaGetLastError());
}

extern "C" int dmt_flash_attention_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       const void* lengths, void* dk, void* dv, void* visits,
                                       int B, int Sq, int Sk, int H, int D, long long qsb,
                                       long long qss, long long qsh, long long ksb,
                                       long long kss, long long ksh, int is_bf16, float scale,
                                       void* stream) {
    const dim3 grid((Sk + ROWS - 1) / ROWS, H, B);
    const size_t smem = sizeof(float) * (2 * TILE * (D + 1) + 2 * ROWS * D + 2 * TILE);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const Layout lq = {qsb, qss, qsh}, lkv = {ksb, kss, ksh};
    const float* l = static_cast<const float*>(lse);
    const float* dl = static_cast<const float*>(delta);
    const int32_t* lens = static_cast<const int32_t*>(lengths);
    float* vis = static_cast<float*>(visits);
    cudaError_t err;
#define DMT_DKV(T)                                                                         \
    err = allow_smem(flash_dkv_kernel<T>, smem);                                     \
    if (err != cudaSuccess) return static_cast<int>(err);                                 \
    flash_dkv_kernel<T><<<grid, THREADS, smem, st>>>(                                      \
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),      \
        static_cast<const T*>(dout), l, dl, lens, static_cast<T*>(dk), static_cast<T*>(dv), \
        vis, Sq, Sk, H, D, lq, lkv, scale)
    if (is_bf16) { DMT_DKV(__nv_bfloat16); } else { DMT_DKV(float); }
#undef DMT_DKV
    return static_cast<int>(cudaGetLastError());
}
