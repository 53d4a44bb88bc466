// Fused Adam (B3) and fused Adam + ISP significance filter (B2) for Hopper
// (sm_90a).
//
// Replace the Pallas TPU kernels in src/repro/kernels/fused_adam.py:
// `adam_update` (`_adam_kernel`) and `adam_sig_update` (`_adam_sig_kernel`).
// Per element, in float32 whatever the storage types, with the host-side
// float32 scalar block `s`:
//
//   mu'  = b1*mu + (1-b1)*g
//   nu'  = b2*nu + (1-b2)*(g*g)
//   upd  = (-lr * (mu'/bc1)) / (sqrt(nu'/bc2) + eps)
//
//   B3:  p' = p + (upd - (lr*wd)*p)            (the wd term only if wd != 0)
//   B2:  u = upd * scale;  acc = r + u
//        mask = |acc| > v_t * max(|p|, floor)
//        sig = mask ? acc : 0;  r' = mask ? 0 : acc
//
// Storage types, as the TPU kernels take them (each ref loaded, computed
// in float32, each output rounded once to its ref's type): p and g share
// one type, mu and nu one type, and (B2) r its own, each float32 or
// bfloat16. B3 writes p' in p's type and the moments in theirs; B2 writes
// sig and u in p's type, mu' and nu' in the moments' type and r' in r's.
// bfloat16 is rounded to nearest even (`__float2bfloat16_rn`).
//
// B2 also writes `u`: the FaaS worker applies its own full update locally
// and reports the conservation witness on it, and `u` cannot be recovered
// bit-exactly from sig + r' - r. `scale` (the 1/P_active factor, in the
// slot the TPU kernel leaves at 0) multiplies u before the accumulate; at
// scale 1 the product is exact and B2 computes the TPU kernel's function
// plus the store of u. `1-b1` and `1-b2` come from the host rounded once
// from double, as the JAX package's `adam_ref` and `optim.adam` round them
// (the TPU kernel subtracts in float32, which moves `1-b2` by 1.3e-5
// relative).
//
// Bound: bytes. At float32 B2 moves 5 reads and 5 writes (40 B) per
// element and B3 4 reads and 3 writes (28 B); all in bfloat16, 20 B and
// 14 B. Each is about 15 flops an element, far below the card's ridge
// point; so the design is one elementwise pass with vector loads of four
// elements (16 bytes of float32, 8 of bfloat16) where every pointer is
// aligned to its four elements, and a scalar tail. Every rounding is
// pinned (`__fmul_rn`, `__fadd_rn`, `__fdiv_rn`, `__fsqrt_rn`): nvcc may
// not contract a product and a sum into an FMA, so the kernel is
// bit-identical to its plain PyTorch version (kernels/ref.py). The
// float32 instances compute exactly what they computed before bfloat16
// moments were added.
//
// Plain C interface, loaded with ctypes. Type codes are those of
// wire_pack.cu: 0 float32, 2 bfloat16; another code returns -1. The scalar
// block arrives as a host pointer to ten floats and is passed to the
// kernel by value. Each launch function returns cudaGetLastError() (the
// first error, or 0).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kF32 = 0;
constexpr int kBF16 = 2;

struct AdamScalars {  // layout of kernels/ref.py AdamScalars
  float lr, b1, b2, eps, bc1, bc2, last, scale, omb1, omb2;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// four elements of T as one aligned load: 16 bytes for float32, 8 for
// bfloat16
template <typename T>
struct Quad;
template <>
struct __align__(16) Quad<float> {
  float v[4];
};
template <>
struct __align__(8) Quad<__nv_bfloat16> {
  __nv_bfloat16 v[4];
};

__device__ __forceinline__ float adam_core(float g, float mu, float nu,
                                           const AdamScalars& s, float& mu2,
                                           float& nu2) {
  mu2 = __fadd_rn(__fmul_rn(s.b1, mu), __fmul_rn(s.omb1, g));
  nu2 = __fadd_rn(__fmul_rn(s.b2, nu), __fmul_rn(s.omb2, __fmul_rn(g, g)));
  float mhat = __fdiv_rn(mu2, s.bc1);
  float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(nu2, s.bc2)), s.eps);
  return __fdiv_rn(__fmul_rn(-s.lr, mhat), den);
}

// -- B2 -----------------------------------------------------------------------

template <typename P, typename M, typename R>
__device__ __forceinline__ void adam_sig_one(P p, P g, M mu, M nu, R r,
                                             const AdamScalars& s,
                                             float floor_, P& sig, M& mu_o,
                                             M& nu_o, R& res, P& u_o) {
  float mu2, nu2;
  float u = __fmul_rn(adam_core(to_f32(g), to_f32(mu), to_f32(nu), s, mu2,
                                nu2),
                      s.scale);
  float acc = __fadd_rn(to_f32(r), u);
  float ap = fabsf(to_f32(p));
  float denom = (ap < floor_) ? floor_ : ap;  // NaN in p stays NaN
  bool mask = fabsf(acc) > __fmul_rn(s.last, denom);
  sig = from_f32<P>(mask ? acc : 0.0f);
  res = from_f32<R>(mask ? 0.0f : acc);
  mu_o = from_f32<M>(mu2);
  nu_o = from_f32<M>(nu2);
  u_o = from_f32<P>(u);
}

template <typename P, typename M, typename R>
__global__ void adam_sig_vec4(const Quad<P>* __restrict__ p,
                              const Quad<P>* __restrict__ g,
                              const Quad<M>* __restrict__ mu,
                              const Quad<M>* __restrict__ nu,
                              const Quad<R>* __restrict__ r,
                              Quad<P>* __restrict__ sig,
                              Quad<M>* __restrict__ mu_out,
                              Quad<M>* __restrict__ nu_out,
                              Quad<R>* __restrict__ r_out,
                              Quad<P>* __restrict__ u_out, int64_t n4,
                              AdamScalars s, float floor_) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (; i < n4; i += stride) {
    Quad<P> a = p[i], b = g[i], o0, o4;
    Quad<M> c = mu[i], d = nu[i], o1, o2;
    Quad<R> e = r[i], o3;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      adam_sig_one(a.v[k], b.v[k], c.v[k], d.v[k], e.v[k], s, floor_,
                   o0.v[k], o1.v[k], o2.v[k], o3.v[k], o4.v[k]);
    }
    sig[i] = o0;
    mu_out[i] = o1;
    nu_out[i] = o2;
    r_out[i] = o3;
    u_out[i] = o4;
  }
}

template <typename P, typename M, typename R>
__global__ void adam_sig_scalar(const P* __restrict__ p,
                                const P* __restrict__ g,
                                const M* __restrict__ mu,
                                const M* __restrict__ nu,
                                const R* __restrict__ r, P* __restrict__ sig,
                                M* __restrict__ mu_out,
                                M* __restrict__ nu_out,
                                R* __restrict__ r_out, P* __restrict__ u_out,
                                int64_t start, int64_t n, AdamScalars s,
                                float floor_) {
  int64_t i = start + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (; i < n; i += stride) {
    adam_sig_one(p[i], g[i], mu[i], nu[i], r[i], s, floor_, sig[i],
                 mu_out[i], nu_out[i], r_out[i], u_out[i]);
  }
}

// -- B3 -----------------------------------------------------------------------

template <typename P, typename M>
__device__ __forceinline__ void adam_one(P p, P g, M mu, M nu,
                                         const AdamScalars& s, float lr_wd,
                                         P& p_out, M& mu_o, M& nu_o) {
  float pf = to_f32(p);
  float mu2, nu2;
  float upd = adam_core(to_f32(g), to_f32(mu), to_f32(nu), s, mu2, nu2);
  if (s.last != 0.0f) upd = __fsub_rn(upd, __fmul_rn(lr_wd, pf));
  p_out = from_f32<P>(__fadd_rn(pf, upd));
  mu_o = from_f32<M>(mu2);
  nu_o = from_f32<M>(nu2);
}

template <typename P, typename M>
__global__ void adam_vec4(const Quad<P>* __restrict__ p,
                          const Quad<P>* __restrict__ g,
                          const Quad<M>* __restrict__ mu,
                          const Quad<M>* __restrict__ nu,
                          Quad<P>* __restrict__ p_out,
                          Quad<M>* __restrict__ mu_out,
                          Quad<M>* __restrict__ nu_out, int64_t n4,
                          AdamScalars s, float lr_wd) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (; i < n4; i += stride) {
    Quad<P> a = p[i], b = g[i], po;
    Quad<M> c = mu[i], d = nu[i], m, v;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      adam_one(a.v[k], b.v[k], c.v[k], d.v[k], s, lr_wd, po.v[k], m.v[k],
               v.v[k]);
    }
    p_out[i] = po;
    mu_out[i] = m;
    nu_out[i] = v;
  }
}

template <typename P, typename M>
__global__ void adam_scalar(const P* __restrict__ p, const P* __restrict__ g,
                            const M* __restrict__ mu,
                            const M* __restrict__ nu, P* __restrict__ p_out,
                            M* __restrict__ mu_out, M* __restrict__ nu_out,
                            int64_t start, int64_t n, AdamScalars s,
                            float lr_wd) {
  int64_t i = start + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (; i < n; i += stride) {
    adam_one(p[i], g[i], mu[i], nu[i], s, lr_wd, p_out[i], mu_out[i],
             nu_out[i]);
  }
}

// -- launches ---------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;  // enough resident warps on 132 SMs

int64_t blocks_for(int64_t work) {
  int64_t b = (work + kThreads - 1) / kThreads;
  return b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b);
}

// true when `ptr` holds whole Quads of T
template <typename T>
bool quad_aligned(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % sizeof(Quad<T>) == 0;
}

template <typename P, typename M, typename R>
int adam_sig_launch(const void* p, const void* g, const void* mu,
                    const void* nu, const void* r, void* sig, void* mu_out,
                    void* nu_out, void* r_out, void* u_out, int64_t n,
                    const AdamScalars& s, float floor_, cudaStream_t st) {
  bool aligned = quad_aligned<P>(p) && quad_aligned<P>(g) &&
                 quad_aligned<P>(sig) && quad_aligned<P>(u_out) &&
                 quad_aligned<M>(mu) && quad_aligned<M>(nu) &&
                 quad_aligned<M>(mu_out) && quad_aligned<M>(nu_out) &&
                 quad_aligned<R>(r) && quad_aligned<R>(r_out);
  int64_t head = 0;
  if (aligned) {
    int64_t n4 = n / 4;
    if (n4 > 0) {
      adam_sig_vec4<P, M, R><<<static_cast<unsigned>(blocks_for(n4)),
                               kThreads, 0, st>>>(
          static_cast<const Quad<P>*>(p), static_cast<const Quad<P>*>(g),
          static_cast<const Quad<M>*>(mu), static_cast<const Quad<M>*>(nu),
          static_cast<const Quad<R>*>(r), static_cast<Quad<P>*>(sig),
          static_cast<Quad<M>*>(mu_out), static_cast<Quad<M>*>(nu_out),
          static_cast<Quad<R>*>(r_out), static_cast<Quad<P>*>(u_out), n4, s,
          floor_);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    head = n4 * 4;
  }
  if (head < n) {
    adam_sig_scalar<P, M, R><<<static_cast<unsigned>(blocks_for(n - head)),
                               kThreads, 0, st>>>(
        static_cast<const P*>(p), static_cast<const P*>(g),
        static_cast<const M*>(mu), static_cast<const M*>(nu),
        static_cast<const R*>(r), static_cast<P*>(sig),
        static_cast<M*>(mu_out), static_cast<M*>(nu_out),
        static_cast<R*>(r_out), static_cast<P*>(u_out), head, n, s, floor_);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename P, typename M>
int adam_launch(const void* p, const void* g, const void* mu, const void* nu,
                void* p_out, void* mu_out, void* nu_out, int64_t n,
                const AdamScalars& s, cudaStream_t st) {
  // the TPU kernel's `lr * wd` product, rounded once in float32
  float lr_wd = s.lr * s.last;
  bool aligned = quad_aligned<P>(p) && quad_aligned<P>(g) &&
                 quad_aligned<P>(p_out) && quad_aligned<M>(mu) &&
                 quad_aligned<M>(nu) && quad_aligned<M>(mu_out) &&
                 quad_aligned<M>(nu_out);
  int64_t head = 0;
  if (aligned) {
    int64_t n4 = n / 4;
    if (n4 > 0) {
      adam_vec4<P, M><<<static_cast<unsigned>(blocks_for(n4)), kThreads, 0,
                        st>>>(
          static_cast<const Quad<P>*>(p), static_cast<const Quad<P>*>(g),
          static_cast<const Quad<M>*>(mu), static_cast<const Quad<M>*>(nu),
          static_cast<Quad<P>*>(p_out), static_cast<Quad<M>*>(mu_out),
          static_cast<Quad<M>*>(nu_out), n4, s, lr_wd);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    head = n4 * 4;
  }
  if (head < n) {
    adam_scalar<P, M><<<static_cast<unsigned>(blocks_for(n - head)),
                        kThreads, 0, st>>>(
        static_cast<const P*>(p), static_cast<const P*>(g),
        static_cast<const M*>(mu), static_cast<const M*>(nu),
        static_cast<P*>(p_out), static_cast<M*>(mu_out),
        static_cast<M*>(nu_out), head, n, s, lr_wd);
  }
  return static_cast<int>(cudaGetLastError());
}

bool known(int code) { return code == kF32 || code == kBF16; }

template <typename P, typename M>
int adam_sig_for_r(int r_code, const void* p, const void* g, const void* mu,
                   const void* nu, const void* r, void* sig, void* mu_out,
                   void* nu_out, void* r_out, void* u_out, int64_t n,
                   const AdamScalars& s, float floor_, cudaStream_t st) {
  if (r_code == kBF16) {
    return adam_sig_launch<P, M, __nv_bfloat16>(
        p, g, mu, nu, r, sig, mu_out, nu_out, r_out, u_out, n, s, floor_,
        st);
  }
  return adam_sig_launch<P, M, float>(p, g, mu, nu, r, sig, mu_out, nu_out,
                                      r_out, u_out, n, s, floor_, st);
}

template <typename P>
int adam_sig_for_m(int m_code, int r_code, const void* p, const void* g,
                   const void* mu, const void* nu, const void* r, void* sig,
                   void* mu_out, void* nu_out, void* r_out, void* u_out,
                   int64_t n, const AdamScalars& s, float floor_,
                   cudaStream_t st) {
  if (m_code == kBF16) {
    return adam_sig_for_r<P, __nv_bfloat16>(r_code, p, g, mu, nu, r, sig,
                                            mu_out, nu_out, r_out, u_out, n,
                                            s, floor_, st);
  }
  return adam_sig_for_r<P, float>(r_code, p, g, mu, nu, r, sig, mu_out,
                                  nu_out, r_out, u_out, n, s, floor_, st);
}

template <typename P>
int adam_for_m(int m_code, const void* p, const void* g, const void* mu,
               const void* nu, void* p_out, void* mu_out, void* nu_out,
               int64_t n, const AdamScalars& s, cudaStream_t st) {
  if (m_code == kBF16) {
    return adam_launch<P, __nv_bfloat16>(p, g, mu, nu, p_out, mu_out, nu_out,
                                         n, s, st);
  }
  return adam_launch<P, float>(p, g, mu, nu, p_out, mu_out, nu_out, n, s,
                               st);
}

}  // namespace

// p, g, sig, u_out in `p_code`; mu, nu, mu_out, nu_out in `m_code`; r and
// r_out in `r_code`.
extern "C" int adam_sig_update_launch(const void* p, const void* g,
                                      const void* mu, const void* nu,
                                      const void* r, void* sig, void* mu_out,
                                      void* nu_out, void* r_out, void* u_out,
                                      int64_t n, int p_code, int m_code,
                                      int r_code, const float* scalars,
                                      float floor_, void* stream) {
  if (!known(p_code) || !known(m_code) || !known(r_code)) return -1;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  AdamScalars s;
  memcpy(&s, scalars, sizeof s);
  if (p_code == kBF16) {
    return adam_sig_for_m<__nv_bfloat16>(m_code, r_code, p, g, mu, nu, r,
                                         sig, mu_out, nu_out, r_out, u_out, n,
                                         s, floor_, st);
  }
  return adam_sig_for_m<float>(m_code, r_code, p, g, mu, nu, r, sig, mu_out,
                               nu_out, r_out, u_out, n, s, floor_, st);
}

// p, g, p_out in `p_code`; mu, nu, mu_out, nu_out in `m_code`.
extern "C" int adam_update_launch(const void* p, const void* g,
                                  const void* mu, const void* nu, void* p_out,
                                  void* mu_out, void* nu_out, int64_t n,
                                  int p_code, int m_code,
                                  const float* scalars, void* stream) {
  if (!known(p_code) || !known(m_code)) return -1;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  AdamScalars s;
  memcpy(&s, scalars, sizeof s);
  if (p_code == kBF16) {
    return adam_for_m<__nv_bfloat16>(m_code, p, g, mu, nu, p_out, mu_out,
                                     nu_out, n, s, st);
  }
  return adam_for_m<float>(m_code, p, g, mu, nu, p_out, mu_out, nu_out, n, s,
                           st);
}
