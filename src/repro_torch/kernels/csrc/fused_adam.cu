// Fused Adam (B3) and fused Adam + ISP significance filter (B2) for Hopper
// (sm_90a).
//
// Replace the Pallas TPU kernels in src/repro/kernels/fused_adam.py:
// `adam_update` (`_adam_kernel`) and `adam_sig_update` (`_adam_sig_kernel`).
// Per element, with the host-side float32 scalar block `s`:
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
// B2 also writes `u`: the worker applies its own full update locally and
// reports the conservation witness on it, and `u` cannot be recovered
// bit-exactly from sig + r' - r. `scale` (the 1/P_active factor, in the slot
// the TPU kernel leaves at 0) multiplies u before the accumulate; at scale 1
// the product is exact and B2 computes the TPU kernel's function plus the
// store of u. `1-b1` and `1-b2` come from the host rounded once from double,
// as the JAX package's `adam_ref` and `optim.adam` round them (the TPU
// kernel subtracts in float32, which moves `1-b2` by 1.3e-5 relative).
//
// Bound: bytes. B2 moves 5 float32 reads and 5 writes (40 B) per element,
// B3 4 reads and 3 writes (28 B at float32) for about 15 flops, far below
// the card's ridge point; so the design is one elementwise pass with
// 16-byte vector loads where every pointer is aligned and a scalar tail.
// Every rounding is pinned (`__fmul_rn`, `__fadd_rn`, `__fdiv_rn`,
// `__fsqrt_rn`): nvcc may not contract a product and a sum into an FMA, so
// the kernel is bit-identical to its plain PyTorch version (kernels/ref.py).
//
// Plain C interface, loaded with ctypes. The scalar block arrives as a host
// pointer to ten floats and is passed to the kernel by value. Each launch
// function returns cudaGetLastError() (the first error, or 0).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

struct AdamScalars {  // layout of kernels/ref.py AdamScalars
  float lr, b1, b2, eps, bc1, bc2, last, scale, omb1, omb2;
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

__device__ __forceinline__ void adam_sig_one(float p, float g, float mu,
                                             float nu, float r,
                                             const AdamScalars& s,
                                             float floor_, float& sig,
                                             float& mu2, float& nu2,
                                             float& res, float& u) {
  u = __fmul_rn(adam_core(g, mu, nu, s, mu2, nu2), s.scale);
  float acc = __fadd_rn(r, u);
  float ap = fabsf(p);
  float denom = (ap < floor_) ? floor_ : ap;  // NaN in p stays NaN
  bool mask = fabsf(acc) > __fmul_rn(s.last, denom);
  sig = mask ? acc : 0.0f;
  res = mask ? 0.0f : acc;
}

__global__ void adam_sig_vec4(const float4* __restrict__ p,
                              const float4* __restrict__ g,
                              const float4* __restrict__ mu,
                              const float4* __restrict__ nu,
                              const float4* __restrict__ r,
                              float4* __restrict__ sig,
                              float4* __restrict__ mu_out,
                              float4* __restrict__ nu_out,
                              float4* __restrict__ r_out,
                              float4* __restrict__ u_out, int64_t n4,
                              AdamScalars s, float floor_) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (; i < n4; i += stride) {
    float4 a = p[i], b = g[i], c = mu[i], d = nu[i], e = r[i];
    float4 o0, o1, o2, o3, o4;
    adam_sig_one(a.x, b.x, c.x, d.x, e.x, s, floor_, o0.x, o1.x, o2.x, o3.x,
                 o4.x);
    adam_sig_one(a.y, b.y, c.y, d.y, e.y, s, floor_, o0.y, o1.y, o2.y, o3.y,
                 o4.y);
    adam_sig_one(a.z, b.z, c.z, d.z, e.z, s, floor_, o0.z, o1.z, o2.z, o3.z,
                 o4.z);
    adam_sig_one(a.w, b.w, c.w, d.w, e.w, s, floor_, o0.w, o1.w, o2.w, o3.w,
                 o4.w);
    sig[i] = o0;
    mu_out[i] = o1;
    nu_out[i] = o2;
    r_out[i] = o3;
    u_out[i] = o4;
  }
}

__global__ void adam_sig_scalar(const float* __restrict__ p,
                                const float* __restrict__ g,
                                const float* __restrict__ mu,
                                const float* __restrict__ nu,
                                const float* __restrict__ r,
                                float* __restrict__ sig,
                                float* __restrict__ mu_out,
                                float* __restrict__ nu_out,
                                float* __restrict__ r_out,
                                float* __restrict__ u_out, int64_t start,
                                int64_t n, AdamScalars s, float floor_) {
  int64_t i = start + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (; i < n; i += stride) {
    adam_sig_one(p[i], g[i], mu[i], nu[i], r[i], s, floor_, sig[i],
                 mu_out[i], nu_out[i], r_out[i], u_out[i]);
  }
}

// -- B3 -----------------------------------------------------------------------

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

template <typename T>
__device__ __forceinline__ void adam_one(T p, T g, float mu, float nu,
                                         const AdamScalars& s, float lr_wd,
                                         T& p_out, float& mu2, float& nu2) {
  float pf = to_f32(p);
  float upd = adam_core(to_f32(g), mu, nu, s, mu2, nu2);
  if (s.last != 0.0f) upd = __fsub_rn(upd, __fmul_rn(lr_wd, pf));
  p_out = from_f32<T>(__fadd_rn(pf, upd));
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

template <typename T>
__global__ void adam_vec4(const Quad<T>* __restrict__ p,
                          const Quad<T>* __restrict__ g,
                          const float4* __restrict__ mu,
                          const float4* __restrict__ nu,
                          Quad<T>* __restrict__ p_out,
                          float4* __restrict__ mu_out,
                          float4* __restrict__ nu_out, int64_t n4,
                          AdamScalars s, float lr_wd) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (; i < n4; i += stride) {
    Quad<T> a = p[i], b = g[i], po;
    float4 c = mu[i], d = nu[i], m, v;
    adam_one(a.v[0], b.v[0], c.x, d.x, s, lr_wd, po.v[0], m.x, v.x);
    adam_one(a.v[1], b.v[1], c.y, d.y, s, lr_wd, po.v[1], m.y, v.y);
    adam_one(a.v[2], b.v[2], c.z, d.z, s, lr_wd, po.v[2], m.z, v.z);
    adam_one(a.v[3], b.v[3], c.w, d.w, s, lr_wd, po.v[3], m.w, v.w);
    p_out[i] = po;
    mu_out[i] = m;
    nu_out[i] = v;
  }
}

template <typename T>
__global__ void adam_scalar(const T* __restrict__ p, const T* __restrict__ g,
                            const float* __restrict__ mu,
                            const float* __restrict__ nu,
                            T* __restrict__ p_out,
                            float* __restrict__ mu_out,
                            float* __restrict__ nu_out, int64_t start,
                            int64_t n, AdamScalars s, float lr_wd) {
  int64_t i = start + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (; i < n; i += stride) {
    adam_one(p[i], g[i], mu[i], nu[i], s, lr_wd, p_out[i], mu_out[i],
             nu_out[i]);
  }
}

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;  // enough resident warps on 132 SMs

int64_t blocks_for(int64_t work) {
  int64_t b = (work + kThreads - 1) / kThreads;
  return b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b);
}

uintptr_t addr(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr); }

template <typename T>
int adam_launch(const void* p, const void* g, const void* mu, const void* nu,
                void* p_out, void* mu_out, void* nu_out, int64_t n,
                const AdamScalars& s, cudaStream_t st) {
  // the TPU kernel's `lr * wd` product, rounded once in float32
  float lr_wd = s.lr * s.last;
  bool aligned = ((addr(p) | addr(g) | addr(p_out)) % (4 * sizeof(T)) == 0) &&
                 ((addr(mu) | addr(nu) | addr(mu_out) | addr(nu_out)) & 15u) ==
                     0;
  int64_t head = 0;
  if (aligned) {
    int64_t n4 = n / 4;
    if (n4 > 0) {
      adam_vec4<T><<<static_cast<unsigned>(blocks_for(n4)), kThreads, 0,
                     st>>>(
          static_cast<const Quad<T>*>(p),
          static_cast<const Quad<T>*>(g),
          static_cast<const float4*>(mu), static_cast<const float4*>(nu),
          static_cast<Quad<T>*>(p_out), static_cast<float4*>(mu_out),
          static_cast<float4*>(nu_out), n4, s, lr_wd);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    head = n4 * 4;
  }
  if (head < n) {
    adam_scalar<T><<<static_cast<unsigned>(blocks_for(n - head)), kThreads, 0,
                     st>>>(
        static_cast<const T*>(p), static_cast<const T*>(g),
        static_cast<const float*>(mu), static_cast<const float*>(nu),
        static_cast<T*>(p_out), static_cast<float*>(mu_out),
        static_cast<float*>(nu_out), head, n, s, lr_wd);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int adam_sig_update_launch(const void* p, const void* g,
                                      const void* mu, const void* nu,
                                      const void* r, void* sig, void* mu_out,
                                      void* nu_out, void* r_out, void* u_out,
                                      int64_t n, const float* scalars,
                                      float floor_, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  AdamScalars s;
  memcpy(&s, scalars, sizeof s);
  uintptr_t all = addr(p) | addr(g) | addr(mu) | addr(nu) | addr(r) |
                  addr(sig) | addr(mu_out) | addr(nu_out) | addr(r_out) |
                  addr(u_out);
  int64_t head = 0;
  if ((all & 15u) == 0) {
    int64_t n4 = n / 4;
    if (n4 > 0) {
      adam_sig_vec4<<<static_cast<unsigned>(blocks_for(n4)), kThreads, 0,
                      st>>>(
          static_cast<const float4*>(p), static_cast<const float4*>(g),
          static_cast<const float4*>(mu), static_cast<const float4*>(nu),
          static_cast<const float4*>(r), static_cast<float4*>(sig),
          static_cast<float4*>(mu_out), static_cast<float4*>(nu_out),
          static_cast<float4*>(r_out), static_cast<float4*>(u_out), n4, s,
          floor_);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    head = n4 * 4;
  }
  if (head < n) {
    adam_sig_scalar<<<static_cast<unsigned>(blocks_for(n - head)), kThreads,
                      0, st>>>(
        static_cast<const float*>(p), static_cast<const float*>(g),
        static_cast<const float*>(mu), static_cast<const float*>(nu),
        static_cast<const float*>(r), static_cast<float*>(sig),
        static_cast<float*>(mu_out), static_cast<float*>(nu_out),
        static_cast<float*>(r_out), static_cast<float*>(u_out), head, n, s,
        floor_);
  }
  return static_cast<int>(cudaGetLastError());
}

// `bf16` selects bfloat16 for p, g and p_out (else float32); the moments are
// float32 either way.
extern "C" int adam_update_launch(const void* p, const void* g,
                                  const void* mu, const void* nu, void* p_out,
                                  void* mu_out, void* nu_out, int64_t n,
                                  int bf16, const float* scalars,
                                  void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  AdamScalars s;
  memcpy(&s, scalars, sizeof s);
  if (bf16) {
    return adam_launch<__nv_bfloat16>(p, g, mu, nu, p_out, mu_out, nu_out, n,
                                      s, st);
  }
  return adam_launch<float>(p, g, mu, nu, p_out, mu_out, nu_out, n, s, st);
}
