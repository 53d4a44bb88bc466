// Fused ISP significance filter for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `significance_filter` in
// src/repro/kernels/significance.py (`_sig_kernel`). Per element:
//
//   acc  = r + u
//   mask = |acc| > v_t * max(|x|, floor)
//   sig  = mask ? acc : 0
//   res  = mask ? 0 : acc
//
// Bound: bytes. Three float32 reads and two writes per element and a handful
// of flops, far below the card's ridge point, so the design is one
// elementwise pass with 16-byte vector loads where the tensors are aligned
// and a scalar tail. `__fadd_rn` / `__fmul_rn` keep nvcc from contracting
// the product into an FMA, so the compare sees exactly the rounded product
// the plain version computes. max() propagates NaN like torch.maximum.
//
// Plain C interface, loaded with ctypes: returns cudaGetLastError() after
// each launch (the first error, or 0).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void split_one(float u, float x, float r, float vt,
                                          float floor_, float& sig,
                                          float& res) {
  float acc = __fadd_rn(r, u);
  float ax = fabsf(x);
  float denom = (ax < floor_) ? floor_ : ax;  // NaN in x stays NaN
  bool mask = fabsf(acc) > __fmul_rn(vt, denom);
  sig = mask ? acc : 0.0f;
  res = mask ? 0.0f : acc;
}

__global__ void sig_kernel_vec4(const float4* __restrict__ u,
                                const float4* __restrict__ x,
                                const float4* __restrict__ r,
                                float4* __restrict__ sig,
                                float4* __restrict__ res, int64_t n4,
                                float vt, float floor_) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (; i < n4; i += stride) {
    float4 a = u[i], b = x[i], c = r[i], s, q;
    split_one(a.x, b.x, c.x, vt, floor_, s.x, q.x);
    split_one(a.y, b.y, c.y, vt, floor_, s.y, q.y);
    split_one(a.z, b.z, c.z, vt, floor_, s.z, q.z);
    split_one(a.w, b.w, c.w, vt, floor_, s.w, q.w);
    sig[i] = s;
    res[i] = q;
  }
}

__global__ void sig_kernel_scalar(const float* __restrict__ u,
                                  const float* __restrict__ x,
                                  const float* __restrict__ r,
                                  float* __restrict__ sig,
                                  float* __restrict__ res, int64_t start,
                                  int64_t n, float vt, float floor_) {
  int64_t i = start + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (; i < n; i += stride) {
    split_one(u[i], x[i], r[i], vt, floor_, sig[i], res[i]);
  }
}

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;  // enough resident warps on 132 SMs

int64_t blocks_for(int64_t work) {
  int64_t b = (work + kThreads - 1) / kThreads;
  return b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b);
}

}  // namespace

extern "C" int significance_filter_launch(const void* u, const void* x,
                                          const void* r, void* sig, void* res,
                                          int64_t n, float vt, float floor_,
                                          void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  uintptr_t all = reinterpret_cast<uintptr_t>(u) |
                  reinterpret_cast<uintptr_t>(x) |
                  reinterpret_cast<uintptr_t>(r) |
                  reinterpret_cast<uintptr_t>(sig) |
                  reinterpret_cast<uintptr_t>(res);
  int64_t head = 0;
  if ((all & 15u) == 0) {
    int64_t n4 = n / 4;
    if (n4 > 0) {
      sig_kernel_vec4<<<static_cast<unsigned>(blocks_for(n4)), kThreads, 0,
                        s>>>(
          static_cast<const float4*>(u), static_cast<const float4*>(x),
          static_cast<const float4*>(r), static_cast<float4*>(sig),
          static_cast<float4*>(res), n4, vt, floor_);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    head = n4 * 4;
  }
  if (head < n) {
    sig_kernel_scalar<<<static_cast<unsigned>(blocks_for(n - head)),
                        kThreads, 0, s>>>(
        static_cast<const float*>(u), static_cast<const float*>(x),
        static_cast<const float*>(r), static_cast<float*>(sig),
        static_cast<float*>(res), head, n, vt, floor_);
  }
  return static_cast<int>(cudaGetLastError());
}
