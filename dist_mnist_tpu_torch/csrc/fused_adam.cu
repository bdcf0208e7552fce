// One-pass Adam updates for the training path (Hopper, sm_90a).
//
// Replaces the two Pallas TPU kernels of dist_mnist_tpu/ops/pallas/fused_adam.py:
//
//   `_adam_kernel` (launched by `fused_adam_update`), per element:
//       m'    = b1*m + (1-b1)*g
//       v'    = b2*v + (1-b2)*g*g
//       delta = -lr_t*m' / (sqrt(v') + eps)
//   `_adam_clip_wd_kernel` (launched by `fused_adam_clip_wd_update`): the same
//   with g := g*clip_scale before the moments and `- lr_wd*p` added to delta.
//
// Inputs are contiguous f32 leaves; delta, m' and v' go to new buffers, as the
// JAX functions return new arrays. The per-step scalars stay on the device: `sc`
// points to [lr_t] (kernel 1) or [lr_t, clip_scale, lr*wd] (kernel 2), as the
// Pallas kernels read them from SMEM, so no step reads a device value back to the
// host. b1, b2, eps, (1-b1) and (1-b2) are launch arguments: the host computes
// 1-b in double and rounds once to f32, as JAX does (1.0f - 0.9f would give
// 0.100000024, not 0.1f).
//
// Rounding. No --use_fast_math: sqrt and division are IEEE (round to nearest).
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn, which nvcc
// never contracts into an FMA), in the order the JAX expressions and the plain
// torch version in ops/kernels/fused_adam.py evaluate them, so on the same inputs
// the kernel and the plain version give the same bits.
//
// What bounds it. An elementwise pass: kernel 1 reads g, m, v and writes delta,
// m', v' (24 B per element), kernel 2 also reads p (28 B), against about a dozen
// f32 operations per element, so the bound is device-memory bytes. LeNet-5's 8
// leaves (1,663,370 elements) move 39.9 MB per step under kernel 1: 11.9 us at
// 3.35 TB/s. One pass, each byte read or written once, float4 (16 B) loads and
// stores on neighbouring threads where a leaf's pointers allow it.
//
// One launch over every leaf. The TPU launches once per leaf; here a step's
// leaves (10 elements for fc2/b up to 1,605,632 for fc1/w) share one launch, so
// the small ones pay no launch and tail of their own. The host passes a table
// (`Table`, by value as a __grid_constant__ kernel parameter, under the 4 KB a
// launch's parameters may take): for each leaf its input pointers, n, its
// element offset in the three flat output buffers (a multiple of 4, so every
// leaf's outputs, and the next step's m and v, start 16-byte aligned) and its
// first chunk. Leaves past one table's TABLE_LEAVES go in a further launch. Each
// block takes one chunk of CHUNK elements (256 threads x 4 float4) and finds its
// leaf in the table. A leaf whose pointers are all 16-byte aligned runs the
// float4 loop over its chunk, and its last chunk a scalar loop over the tail
// (< 4 elements); any other leaf runs the scalar loop throughout. Nothing is
// padded or copied; a 0-d leaf has n = 1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 4;                       // float4 a thread takes per chunk
constexpr int CHUNK = THREADS * PER_THREAD * 4;     // elements per block
constexpr int TABLE_LEAVES = 64;                    // leaves one launch takes

struct Consts {
    float b1, b2, omb1, omb2, eps;
};

struct Scalars {
    float lr_t, clip, lr_wd;
};

struct Leaf {
    const float* g;
    const float* m;
    const float* v;
    const float* p;    // the clip-wd kernel's params (unused by kernel 1)
    long long n;       // elements
    long long off;     // element offset of its outputs in d_out, m_out, v_out
    int chunk0;        // its first chunk (block) of the launch
    int vec;           // 1: every pointer 16-byte aligned, the float4 loop
};

struct Table {
    Leaf leaf[TABLE_LEAVES];
    int count;
};

// the launch's parameters: the table, four pointers and the constants
static_assert(sizeof(Table) + 4 * sizeof(void*) + sizeof(Consts) <= 4096,
              "a launch's parameters must fit in 4 KB");

template <bool kClipWd>
__device__ __forceinline__ void adam_elem(float g, float m, float v, float p,
                                          const Scalars& s, const Consts& c,
                                          float& d_out, float& m_out, float& v_out) {
    if (kClipWd) g = __fmul_rn(g, s.clip);
    const float m2 = __fadd_rn(__fmul_rn(c.b1, m), __fmul_rn(c.omb1, g));
    const float v2 = __fadd_rn(__fmul_rn(c.b2, v), __fmul_rn(__fmul_rn(c.omb2, g), g));
    float d = __fdiv_rn(__fmul_rn(-s.lr_t, m2), __fadd_rn(__fsqrt_rn(v2), c.eps));
    if (kClipWd) d = __fsub_rn(d, __fmul_rn(s.lr_wd, p));
    d_out = d;
    m_out = m2;
    v_out = v2;
}

template <bool kClipWd>
__global__ void __launch_bounds__(THREADS)
adam_kernel(const __grid_constant__ Table t, const float* __restrict__ sc,
            float* __restrict__ d_out, float* __restrict__ m_out,
            float* __restrict__ v_out, Consts c) {
    Scalars s;
    s.lr_t = sc[0];
    s.clip = kClipWd ? sc[1] : 1.f;
    s.lr_wd = kClipWd ? sc[2] : 0.f;
    int l = 0;  // the block's leaf: the last whose first chunk is at or before it
    while (l + 1 < t.count && t.leaf[l + 1].chunk0 <= (int)blockIdx.x) ++l;
    const Leaf& L = t.leaf[l];
    const long long c0 = (long long)((int)blockIdx.x - L.chunk0) * CHUNK;
    const long long c1 = min(c0 + CHUNK, L.n);
    float* d = d_out + L.off;
    float* mo = m_out + L.off;
    float* vo = v_out + L.off;
    long long done = c0;
    if (L.vec) {
        const float4* g4 = reinterpret_cast<const float4*>(L.g);
        const float4* m4 = reinterpret_cast<const float4*>(L.m);
        const float4* v4 = reinterpret_cast<const float4*>(L.v);
        const float4* p4 = reinterpret_cast<const float4*>(L.p);
        const long long e4 = c1 / 4;
        float4 gg[PER_THREAD], mm[PER_THREAD], vv[PER_THREAD], pp[PER_THREAD];
#pragma unroll
        for (int u = 0; u < PER_THREAD; ++u) {  // every load in flight first
            const long long j = c0 / 4 + u * THREADS + threadIdx.x;
            if (j < e4) {
                gg[u] = g4[j];
                mm[u] = m4[j];
                vv[u] = v4[j];
                pp[u] = kClipWd ? p4[j] : make_float4(0.f, 0.f, 0.f, 0.f);
            }
        }
#pragma unroll
        for (int u = 0; u < PER_THREAD; ++u) {
            const long long j = c0 / 4 + u * THREADS + threadIdx.x;
            if (j < e4) {
                float4 dd, mn, vn;
                adam_elem<kClipWd>(gg[u].x, mm[u].x, vv[u].x, pp[u].x, s, c, dd.x, mn.x, vn.x);
                adam_elem<kClipWd>(gg[u].y, mm[u].y, vv[u].y, pp[u].y, s, c, dd.y, mn.y, vn.y);
                adam_elem<kClipWd>(gg[u].z, mm[u].z, vv[u].z, pp[u].z, s, c, dd.z, mn.z, vn.z);
                adam_elem<kClipWd>(gg[u].w, mm[u].w, vv[u].w, pp[u].w, s, c, dd.w, mn.w, vn.w);
                reinterpret_cast<float4*>(d)[j] = dd;
                reinterpret_cast<float4*>(mo)[j] = mn;
                reinterpret_cast<float4*>(vo)[j] = vn;
            }
        }
        done = e4 * 4;
    }
    // scalar loop: the whole chunk without vector access, else the leaf's tail (< 4)
    for (long long j = done + threadIdx.x; j < c1; j += THREADS) {
        adam_elem<kClipWd>(L.g[j], L.m[j], L.v[j], kClipWd ? L.p[j] : 0.f, s, c, d[j], mo[j],
                           vo[j]);
    }
}

bool aligned16(const void* ptr) {
    return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

}  // namespace

// sizeof(Table): the wrapper's plan holds its tables to it
extern "C" int dmt_fused_adam_table_bytes() { return static_cast<int>(sizeof(Table)); }

// One launch over `count` (<= TABLE_LEAVES) leaves on `stream` (PyTorch's current
// stream). `desc` (host memory) holds 7 int64 per leaf: the g, m, v and p pointers
// (p 0 for kernel 1), n, the output offset (a multiple of 4) and the first chunk;
// `chunks` is the launch's block count. Returns cudaGetLastError() after the
// launch: nonzero means the launch was refused and nothing ran.
extern "C" int dmt_fused_adam_leaves(const long long* desc, int count, int chunks,
                                     const void* sc, void* d_out, void* m_out, void* v_out,
                                     float b1, float b2, float omb1, float omb2, float eps,
                                     int clip_wd, void* stream) {
    if (count < 1 || count > TABLE_LEAVES || chunks < 1) return static_cast<int>(cudaErrorInvalidValue);
    Table t;
    t.count = count;
    const bool outs = aligned16(d_out) && aligned16(m_out) && aligned16(v_out);
    for (int i = 0; i < count; ++i) {
        const long long* e = desc + 7 * i;
        Leaf& L = t.leaf[i];
        L.g = reinterpret_cast<const float*>(e[0]);
        L.m = reinterpret_cast<const float*>(e[1]);
        L.v = reinterpret_cast<const float*>(e[2]);
        L.p = reinterpret_cast<const float*>(e[3]);
        L.n = e[4];
        L.off = e[5];
        L.chunk0 = static_cast<int>(e[6]);
        L.vec = outs && L.off % 4 == 0 && aligned16(L.g) && aligned16(L.m) && aligned16(L.v) &&
                (!clip_wd || aligned16(L.p));
    }
    const Consts c{b1, b2, omb1, omb2, eps};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* scf = static_cast<const float*>(sc);
    float* dof = static_cast<float*>(d_out);
    float* mof = static_cast<float*>(m_out);
    float* vof = static_cast<float*>(v_out);
    if (clip_wd) {
        adam_kernel<true><<<chunks, THREADS, 0, s>>>(t, scf, dof, mof, vof, c);
    } else {
        adam_kernel<false><<<chunks, THREADS, 0, s>>>(t, scf, dof, mof, vof, c);
    }
    return static_cast<int>(cudaGetLastError());
}
