// Fused ISP significance filter for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `significance_filter` in
// src/repro/kernels/significance.py (`_sig_kernel`). Per element, in float32
// whatever the storage type (float32, float16 or bfloat16, one type for
// u, x and r):
//
//   acc  = f32(r) + f32(u)
//   mask = |acc| > v_t * max(|f32(x)|, floor)
//   sig  = mask ? acc : 0    rounded to the storage type (nearest even)
//   res  = mask ? 0 : acc    likewise
//
// `x` may be shared by `pods` stacked copies of u and r (the pod path's
// per-pod updates against the one set of parameters): u, r, sig and res
// hold pods x nx elements, x holds nx, and blockIdx.y is the pod. So x is
// never broadcast into device memory, and the function moves 4 x pods x nx
// + nx elements: the card's memory rate bounds it.
//
// Design: one elementwise pass with 16-byte vector loads where every base
// is 16-byte aligned (4 float32 or 8 half-width elements a load) and a
// scalar tail. `__fadd_rn` / `__fmul_rn` keep nvcc from contracting the
// product into an FMA, so the compare sees exactly the rounded product the
// plain version computes. max() propagates NaN like torch.maximum.
//
// Plain C interface, loaded with ctypes: returns cudaGetLastError() after
// the launch (0 on success), -1 for a type code it does not take.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float tof(float v) { return v; }
__device__ __forceinline__ float tof(__half v) { return __half2float(v); }
__device__ __forceinline__ float tof(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T fromf(float v);
template <>
__device__ __forceinline__ float fromf<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __half fromf<__half>(float v) {
  return __float2half_rn(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 fromf<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ void split_one(T u, T x, T r, float vt,
                                          float floor_, T& sig, T& res) {
  float acc = __fadd_rn(tof(r), tof(u));
  float ax = fabsf(tof(x));
  float denom = (ax < floor_) ? floor_ : ax;  // NaN in x stays NaN
  bool mask = fabsf(acc) > __fmul_rn(vt, denom);
  sig = fromf<T>(mask ? acc : 0.0f);
  res = fromf<T>(mask ? 0.0f : acc);
}

// Grid: (x blocks, pods). Elements [0, nx) of pod blockIdx.y; the first
// nx / V as 16-byte vectors when `vec`, the rest one by one.
template <typename T>
__global__ void sig_kernel(const T* __restrict__ u, const T* __restrict__ x,
                           const T* __restrict__ r, T* __restrict__ sig,
                           T* __restrict__ res, int64_t nx, int vec,
                           float vt, float floor_) {
  constexpr int V = 16 / sizeof(T);
  const int64_t off = static_cast<int64_t>(blockIdx.y) * nx;
  const T* up = u + off;
  const T* rp = r + off;
  T* sp = sig + off;
  T* qp = res + off;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t n_vec = vec ? nx / V : 0;
  for (int64_t i = tid; i < n_vec; i += stride) {
    uint4 a = reinterpret_cast<const uint4*>(up)[i];
    uint4 b = reinterpret_cast<const uint4*>(x)[i];
    uint4 c = reinterpret_cast<const uint4*>(rp)[i];
    uint4 s, q;
    const T* ae = reinterpret_cast<const T*>(&a);
    const T* be = reinterpret_cast<const T*>(&b);
    const T* ce = reinterpret_cast<const T*>(&c);
    T* se = reinterpret_cast<T*>(&s);
    T* qe = reinterpret_cast<T*>(&q);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      split_one(ae[j], be[j], ce[j], vt, floor_, se[j], qe[j]);
    }
    reinterpret_cast<uint4*>(sp)[i] = s;
    reinterpret_cast<uint4*>(qp)[i] = q;
  }
  for (int64_t i = n_vec * V + tid; i < nx; i += stride) {
    split_one(up[i], x[i], rp[i], vt, floor_, sp[i], qp[i]);
  }
}

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;  // enough resident warps on 132 SMs

template <typename T>
int launch(const void* u, const void* x, const void* r, void* sig, void* res,
           int64_t nx, int pods, float vt, float floor_, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  uintptr_t all = reinterpret_cast<uintptr_t>(u) |
                  reinterpret_cast<uintptr_t>(x) |
                  reinterpret_cast<uintptr_t>(r) |
                  reinterpret_cast<uintptr_t>(sig) |
                  reinterpret_cast<uintptr_t>(res);
  // every pod's base is aligned when the bases are and nx fills vectors
  const int vec = (all & 15u) == 0 && (pods == 1 || nx % V == 0);
  const int64_t work = vec ? nx / V + nx % V : nx;
  const int64_t cap = pods < kMaxBlocks ? kMaxBlocks / pods : 1;
  int64_t bx = (work + kThreads - 1) / kThreads;
  bx = bx < 1 ? 1 : (bx > cap ? cap : bx);
  dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(pods));
  sig_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(u), static_cast<const T*>(x),
      static_cast<const T*>(r), static_cast<T*>(sig), static_cast<T*>(res),
      nx, vec, vt, floor_);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// u, r, sig, res: pods x nx elements; x: nx elements; code 0 float32,
// 1 float16, 2 bfloat16 (the codes of wire_pack.cu).
extern "C" int significance_filter_launch(const void* u, const void* x,
                                          const void* r, void* sig, void* res,
                                          int64_t nx, int pods, int code,
                                          float vt, float floor_,
                                          void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (code) {
    case 0:
      return launch<float>(u, x, r, sig, res, nx, pods, vt, floor_, s);
    case 1:
      return launch<__half>(u, x, r, sig, res, nx, pods, vt, floor_, s);
    case 2:
      return launch<__nv_bfloat16>(u, x, r, sig, res, nx, pods, vt, floor_,
                                   s);
    default:
      return -1;
  }
}
