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
// All tensors are contiguous f32 of n elements; delta, m' and v' go to new
// buffers, as the JAX functions return new arrays. The per-step scalars stay
// on the device: `sc` points to [lr_t] (kernel 1) or [lr_t, clip_scale, lr*wd]
// (kernel 2), as the Pallas kernels read them from SMEM, so no step reads a
// device value back to the host. b1, b2, eps, (1-b1) and (1-b2) are
// launch arguments: the host computes 1-b in double and rounds once to f32,
// as JAX does (1.0f - 0.9f would give 0.100000024, not 0.1f).
//
// Rounding. No --use_fast_math: sqrt and division are IEEE (round to nearest).
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn, which
// nvcc never contracts into an FMA), in the order the JAX expressions and the
// plain torch version in ops/kernels/fused_adam.py evaluate them, so on the
// same inputs the kernel and the plain version give the same bits.
//
// What bounds it. An elementwise pass: kernel 1 reads g, m, v and writes
// delta, m', v' (24 B per element), kernel 2 also reads p (28 B), against
// about a dozen f32 operations per element, so the bound is device-memory
// bytes. LeNet-5's 8 leaves (1,663,370 elements) move 39.9 MB per step under
// kernel 1: 11.9 us at 3.35 TB/s. The design serves that bound: one pass,
// each byte read or written once, float4 (16 B) loads and stores on
// neighbouring threads where n and every pointer allow it, and a grid-stride
// loop over at most 16 blocks of 256 threads per SM.
//
// Ragged leaves. Sizes run from 10 (fc2/b) to 1,605,632 (fc1/w); a 0-d leaf
// has n = 1. The TPU path pads to 128 lanes; here the vector loop covers the
// first 4*(n/4) elements and a scalar loop the rest, so nothing is padded or
// copied. One launch per leaf, as on the TPU; a launch over all leaves at
// once is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 16;

struct Consts {
    float b1, b2, omb1, omb2, eps;
};

struct Scalars {
    float lr_t, clip, lr_wd;
};

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

template <bool kClipWd, bool kVec>
__global__ void __launch_bounds__(THREADS)
adam_kernel(const float* __restrict__ g, const float* __restrict__ m,
            const float* __restrict__ v, const float* __restrict__ p,
            const float* __restrict__ sc, float* __restrict__ d_out,
            float* __restrict__ m_out, float* __restrict__ v_out,
            long long n, Consts c) {
    Scalars s;
    s.lr_t = sc[0];
    s.clip = kClipWd ? sc[1] : 1.f;
    s.lr_wd = kClipWd ? sc[2] : 0.f;
    const long long stride = (long long)gridDim.x * THREADS;
    long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    long long done = 0;
    if (kVec) {
        const long long n4 = n / 4;
        const float4* g4 = reinterpret_cast<const float4*>(g);
        const float4* m4 = reinterpret_cast<const float4*>(m);
        const float4* v4 = reinterpret_cast<const float4*>(v);
        const float4* p4 = reinterpret_cast<const float4*>(p);
        float4* d4o = reinterpret_cast<float4*>(d_out);
        float4* m4o = reinterpret_cast<float4*>(m_out);
        float4* v4o = reinterpret_cast<float4*>(v_out);
        for (long long j = i; j < n4; j += stride) {
            const float4 gg = g4[j], mm = m4[j], vv = v4[j];
            const float4 pp = kClipWd ? p4[j] : make_float4(0.f, 0.f, 0.f, 0.f);
            float4 dd, mo, vo;
            adam_elem<kClipWd>(gg.x, mm.x, vv.x, pp.x, s, c, dd.x, mo.x, vo.x);
            adam_elem<kClipWd>(gg.y, mm.y, vv.y, pp.y, s, c, dd.y, mo.y, vo.y);
            adam_elem<kClipWd>(gg.z, mm.z, vv.z, pp.z, s, c, dd.z, mo.z, vo.z);
            adam_elem<kClipWd>(gg.w, mm.w, vv.w, pp.w, s, c, dd.w, mo.w, vo.w);
            d4o[j] = dd;
            m4o[j] = mo;
            v4o[j] = vo;
        }
        done = n4 * 4;
    }
    // scalar loop: the whole leaf without vector access, else its tail (< 4)
    for (long long j = done + i; j < n; j += stride) {
        adam_elem<kClipWd>(g[j], m[j], v[j], kClipWd ? p[j] : 0.f, s, c,
                           d_out[j], m_out[j], v_out[j]);
    }
}

bool aligned16(const void* ptr) {
    return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

template <bool kClipWd>
int launch(const void* g, const void* m, const void* v, const void* p,
           const void* sc, void* d_out, void* m_out, void* v_out, long long n,
           float b1, float b2, float omb1, float omb2, float eps, void* stream) {
    const Consts c{b1, b2, omb1, omb2, eps};
    const bool vec = n >= 4 && aligned16(g) && aligned16(m) && aligned16(v) &&
                     (!kClipWd || aligned16(p)) && aligned16(d_out) &&
                     aligned16(m_out) && aligned16(v_out);
    static int sm_count[64] = {};  // per device; a launch asks the CUDA runtime once
    int device = 0;
    cudaGetDevice(&device);
    int sms = device < 64 ? sm_count[device] : 0;
    if (sms == 0) {
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
        if (device < 64) sm_count[device] = sms;
    }
    const long long work = vec ? (n / 4) : n;
    long long blocks = (work + THREADS - 1) / THREADS;
    const long long cap = (long long)(sms > 0 ? sms : 1) * BLOCKS_PER_SM;
    if (blocks > cap) blocks = cap;
    if (blocks < 1) blocks = 1;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* gf = static_cast<const float*>(g);
    const float* mf = static_cast<const float*>(m);
    const float* vf = static_cast<const float*>(v);
    const float* pf = static_cast<const float*>(p);
    const float* scf = static_cast<const float*>(sc);
    float* dof = static_cast<float*>(d_out);
    float* mof = static_cast<float*>(m_out);
    float* vof = static_cast<float*>(v_out);
    if (vec) {
        adam_kernel<kClipWd, true><<<(unsigned)blocks, THREADS, 0, s>>>(
            gf, mf, vf, pf, scf, dof, mof, vof, n, c);
    } else {
        adam_kernel<kClipWd, false><<<(unsigned)blocks, THREADS, 0, s>>>(
            gf, mf, vf, pf, scf, dof, mof, vof, n, c);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` (PyTorch's current stream). Each returns
// cudaGetLastError() after the launch: nonzero means the launch was refused
// and nothing ran.
extern "C" int dmt_fused_adam(const void* g, const void* m, const void* v,
                              const void* lr_t, void* d_out, void* m_out,
                              void* v_out, long long n, float b1, float b2,
                              float omb1, float omb2, float eps, void* stream) {
    return launch<false>(g, m, v, nullptr, lr_t, d_out, m_out, v_out, n, b1,
                         b2, omb1, omb2, eps, stream);
}

extern "C" int dmt_fused_adam_clip_wd(const void* g, const void* m,
                                      const void* v, const void* p,
                                      const void* scalars, void* d_out,
                                      void* m_out, void* v_out, long long n,
                                      float b1, float b2, float omb1,
                                      float omb2, float eps, void* stream) {
    return launch<true>(g, m, v, p, scalars, d_out, m_out, v_out, n, b1, b2,
                        omb1, omb2, eps, stream);
}
