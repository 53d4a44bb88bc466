// Fused wire encode (B4), decode/apply (B5) and hit count (B6) for Hopper
// (sm_90a).
//
// B4 replaces the Pallas TPU kernel `wire_pack` in
// src/repro/kernels/wire_pack.py (`_pack_kernel` plus its cumsum-scatter
// compaction epilogue). B5 replaces `wire_unpack_add` (`_unpack_kernel` and
// `_add_kernel`) and its decode-only form `wire_unpack`. B6 replaces
// `wire_nnz` (`_nnz_kernel`): the nonzero count of a flat tensor.
//
// Bound: bytes. Every pass is a streaming elementwise pass with a few integer
// operations per element. The TPU bit-packs the mask on the MXU with a
// (128, 128) weight matrix; on Hopper a warp's `__ballot_sync` already *is*
// four little-endian mask bytes for 32 consecutive elements, so packbits
// costs one instruction per warp. The TPU's full-length cumsum-scatter
// compaction becomes a real stream compaction: a per-block count (pass 1), a
// hand-written device-wide exclusive scan of the block counts (pass 2, one
// block), and a scatter at block offset + warp prefix + lane prefix (pass 3).
// No CUB or thrust primitive is used.
//
// Bit-exactness: quantization is `__float2half_rn` / `__float2bfloat16_rn`
// (round to nearest even, as numpy and ml_dtypes do), the residual is one
// correctly rounded subtraction, and the decode add is `__fadd_rn` with an
// unconditional `+ 0.0f` off the support, so `-0.0` in the target turns into
// `+0.0` exactly as numpy's `target + decoded` does. The decode-only form
// writes each value itself (widened or narrowed once, round to nearest even,
// as numpy's `astype`), so a `-0.0` on the support survives; it also takes
// float16 and bfloat16 targets, which the add does not (as in the JAX
// package, only exact accumulates are fused).
//
// Type codes shared with the Python wrapper: 0 float32, 1 float16,
// 2 bfloat16, 3 int32. Each entry point checks cudaGetLastError() after
// every launch and returns the first error (0 when all launched), or -1
// for a type pair it does not take.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;  // elements per block, one per thread
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

#define RETURN_IF_LAUNCH_FAILED()                        \
  do {                                                   \
    cudaError_t err_ = cudaGetLastError();               \
    if (err_ != cudaSuccess) return static_cast<int>(err_); \
  } while (0)

__device__ __forceinline__ float tof(float v) { return v; }
__device__ __forceinline__ float tof(__half v) { return __half2float(v); }
__device__ __forceinline__ float tof(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float tof(int32_t v) { return __int2float_rn(v); }

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
__device__ __forceinline__ bool nonzero(T v) {
  return tof(v) != 0.0f;  // -0.0 is insignificant, NaN is significant
}
template <>
__device__ __forceinline__ bool nonzero<int32_t>(int32_t v) {
  return v != 0;
}

template <typename Tin, typename Tout>
struct Quant {
  __device__ static Tout apply(Tin v) { return fromf<Tout>(tof(v)); }
};
template <typename T>
struct Quant<T, T> {
  __device__ static T apply(T v) { return v; }
};

// Exclusive prefix of `bit` over the block, in element order. `warp_tot`
// is shared scratch of kWarps ints. Returns the block total in *total.
__device__ __forceinline__ int block_prefix(bool bit, int* warp_tot,
                                            int* total) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned ballot = __ballot_sync(kFull, bit);
  int lane_pre = __popc(ballot & ((1u << lane) - 1u));
  if (lane == 0) warp_tot[warp] = __popc(ballot);
  __syncthreads();
  int warp_pre = 0, tot = 0;
  for (int w = 0; w < kWarps; ++w) {
    int c = warp_tot[w];
    warp_pre += (w < warp) ? c : 0;
    tot += c;
  }
  *total = tot;
  return warp_pre + lane_pre;
}

// ---- B4 pass 1: mask bytes, quantized dense values, residual, counts ----

template <typename Tin, typename Tout>
__global__ void pack_pass1(const Tin* __restrict__ x, int64_t n,
                           uint8_t* __restrict__ mask_bytes, int64_t mb,
                           Tout* __restrict__ qdense,
                           float* __restrict__ residual,
                           int32_t* __restrict__ block_counts) {
  int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  bool m = false;
  if (i < n) {
    Tin v = x[i];
    m = nonzero(v);
    Tout q = Quant<Tin, Tout>::apply(v);
    qdense[i] = q;
    residual[i] = __fsub_rn(tof(v), tof(q));
  }
  unsigned ballot = __ballot_sync(kFull, m);
  int lane = threadIdx.x & 31;
  if (lane < 4) {
    int64_t byte = ((int64_t)blockIdx.x * kThreads + (threadIdx.x & ~31)) / 8 +
                   lane;
    if (byte < mb) mask_bytes[byte] = (uint8_t)((ballot >> (8 * lane)) & 0xffu);
  }
  int cnt = __syncthreads_count(m);
  if (threadIdx.x == 0) block_counts[blockIdx.x] = cnt;
}

// ---- pass 2 (B4 and B5): exclusive scan of the per-block counts ----------

__global__ void scan_offsets(const int32_t* __restrict__ counts, int64_t nb,
                             int32_t* __restrict__ offsets,
                             int32_t* __restrict__ total) {
  __shared__ int warp_sums[kScanThreads / 32];
  __shared__ int carry_s;
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry_s = 0;
  __syncthreads();
  for (int64_t base = 0; base < nb; base += kScanThreads) {
    int64_t j = base + threadIdx.x;
    int v = j < nb ? counts[j] : 0;
    int incl = v;  // inclusive warp scan
    for (int d = 1; d < 32; d <<= 1) {
      int y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int s = warp_sums[lane];
      for (int d = 1; d < 32; d <<= 1) {
        int y = __shfl_up_sync(kFull, s, d);
        if (lane >= d) s += y;
      }
      warp_sums[lane] = s;  // inclusive over warps
    }
    __syncthreads();
    int carry = carry_s;
    int warp_pre = warp == 0 ? 0 : warp_sums[warp - 1];
    if (j < nb) offsets[j] = carry + warp_pre + incl - v;
    __syncthreads();
    if (threadIdx.x == 0) carry_s = carry + warp_sums[kScanThreads / 32 - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) *total = carry_s;
}

// ---- B4 pass 3: compaction of values and flat indices --------------------

template <typename Tin, typename Tout>
__global__ void pack_compact(const Tin* __restrict__ x, int64_t n,
                             const int32_t* __restrict__ offsets,
                             Tout* __restrict__ cvals,
                             int32_t* __restrict__ cidx) {
  __shared__ int warp_tot[kWarps];
  int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  Tin v{};
  bool m = false;
  if (i < n) {
    v = x[i];
    m = nonzero(v);
  }
  int tot;
  int pre = block_prefix(m, warp_tot, &tot);
  if (m) {
    int64_t pos = (int64_t)offsets[blockIdx.x] + pre;
    cvals[pos] = Quant<Tin, Tout>::apply(v);
    cidx[pos] = (int32_t)i;
  }
}

// ---- B5 pass 1: set bits per block ---------------------------------------

__device__ __forceinline__ bool mask_bit(const uint8_t* __restrict__ mask,
                                         int64_t i, int64_t n) {
  return i < n && ((mask[i >> 3] >> (i & 7)) & 1u);
}

__global__ void unpack_count(const uint8_t* __restrict__ mask, int64_t n,
                             int32_t* __restrict__ block_counts) {
  int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  int cnt = __syncthreads_count(mask_bit(mask, i, n));
  if (threadIdx.x == 0) block_counts[blockIdx.x] = cnt;
}

// ---- B5 pass 3: gather by prefix position, then add (or write) -----------

__device__ __forceinline__ float add_rn(float t, float v) {
  return __fadd_rn(t, v);
}
__device__ __forceinline__ int32_t add_rn(int32_t t, int32_t v) {
  return (int32_t)((uint32_t)t + (uint32_t)v);  // wraps like numpy int32
}

template <typename Tt, typename Tv>
struct Widen {
  __device__ static Tt apply(Tv v) { return fromf<Tt>(tof(v)); }
};
template <>
struct Widen<int32_t, int32_t> {
  __device__ static int32_t apply(int32_t v) { return v; }
};

template <typename Tt, typename Tv>
__global__ void unpack_apply(const Tt* __restrict__ target,
                             const uint8_t* __restrict__ mask, int64_t n,
                             const Tv* __restrict__ cvals,
                             const int32_t* __restrict__ offsets,
                             Tt* __restrict__ out, int accumulate) {
  __shared__ int warp_tot[kWarps];
  int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  bool bit = mask_bit(mask, i, n);
  int tot;
  int pre = block_prefix(bit, warp_tot, &tot);
  if (i < n) {
    Tt v = bit ? Widen<Tt, Tv>::apply(cvals[(int64_t)offsets[blockIdx.x] + pre])
               : Tt{};
    if constexpr (std::is_same<Tt, float>::value ||
                  std::is_same<Tt, int32_t>::value) {
      out[i] = accumulate ? add_rn(target[i], v) : v;
    } else {
      out[i] = v;  // float16 / bfloat16: decode only
    }
  }
}

// ---- B6: nonzero count --------------------------------------------------
//
// The TPU kernel writes one int32 per (block_rows, 128) tile and sums the
// tiles afterwards. Here the test is on the bits with the sign masked off
// (`x != 0` of the Pallas body: -0.0 counts as zero, NaN as nonzero; int32
// keeps every bit), on 16-byte vector loads where the base is aligned and
// element by element for the tail. Each warp counts a load's lanes with
// `__popc(__ballot_sync(...))`, one ballot per element of the vector; the
// block reduces its warps in shared memory and adds its total to the
// result with one integer atomic (exact in any order). The wrapper zeroes
// the result first. Bound: bytes (the input read once).

template <int ES>  // element size in bytes: 4 (float32, int32) or 2
__device__ __forceinline__ int vec_hits(uint4 w, bool valid, uint32_t mask) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
  int hits = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    hits += __popc(__ballot_sync(kFull, valid && (words[k] & mask) != 0u));
    if (ES == 2) {  // the upper half-word is the next element
      hits += __popc(
          __ballot_sync(kFull, valid && ((words[k] >> 16) & mask) != 0u));
    }
  }
  return hits;
}

template <int ES>
__global__ void nnz_kernel(const void* __restrict__ x, int64_t n, int vec,
                           uint32_t mask, int32_t* __restrict__ out) {
  __shared__ int warp_hits[kWarps];
  constexpr int V = 16 / ES;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t n_vec = vec ? n / V : 0;
  int hits = 0;  // the same in every lane of a warp
  // bases step by whole blocks, so every lane of a warp runs every ballot
  for (int64_t base = (int64_t)blockIdx.x * kThreads; base < n_vec;
       base += stride) {
    const int64_t i = base + threadIdx.x;
    const bool valid = i < n_vec;
    uint4 w = valid ? reinterpret_cast<const uint4*>(x)[i]
                    : make_uint4(0u, 0u, 0u, 0u);
    hits += vec_hits<ES>(w, valid, mask);
  }
  for (int64_t base = n_vec * V + (int64_t)blockIdx.x * kThreads; base < n;
       base += stride) {
    const int64_t i = base + threadIdx.x;
    uint32_t bits = 0u;
    if (i < n) {
      bits = ES == 4 ? static_cast<const uint32_t*>(x)[i]
                     : static_cast<const uint16_t*>(x)[i];
    }
    hits += __popc(__ballot_sync(kFull, (bits & mask) != 0u));
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_hits[warp] = hits;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int k = 0; k < kWarps; ++k) total += warp_hits[k];
    if (total) atomicAdd(out, total);
  }
}

template <typename Tin, typename Tout>
int pack_all(const void* x, int64_t n, void* mask_bytes, void* qdense,
             void* cvals, void* cidx, void* residual, void* counts,
             void* offsets, void* nnz, cudaStream_t s) {
  int64_t nb = (n + kThreads - 1) / kThreads;
  pack_pass1<Tin, Tout><<<static_cast<unsigned>(nb), kThreads, 0, s>>>(
      static_cast<const Tin*>(x), n, static_cast<uint8_t*>(mask_bytes),
      (n + 7) / 8, static_cast<Tout*>(qdense), static_cast<float*>(residual),
      static_cast<int32_t*>(counts));
  RETURN_IF_LAUNCH_FAILED();
  scan_offsets<<<1, kScanThreads, 0, s>>>(
      static_cast<const int32_t*>(counts), nb, static_cast<int32_t*>(offsets),
      static_cast<int32_t*>(nnz));
  RETURN_IF_LAUNCH_FAILED();
  pack_compact<Tin, Tout><<<static_cast<unsigned>(nb), kThreads, 0, s>>>(
      static_cast<const Tin*>(x), n, static_cast<const int32_t*>(offsets),
      static_cast<Tout*>(cvals), static_cast<int32_t*>(cidx));
  RETURN_IF_LAUNCH_FAILED();
  return 0;
}

template <typename Tt, typename Tv>
int unpack_all(const void* target, const void* mask, int64_t n,
               const void* cvals, void* counts, void* offsets, void* nnz,
               void* out, int accumulate, cudaStream_t s) {
  int64_t nb = (n + kThreads - 1) / kThreads;
  unpack_count<<<static_cast<unsigned>(nb), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(mask), n, static_cast<int32_t*>(counts));
  RETURN_IF_LAUNCH_FAILED();
  scan_offsets<<<1, kScanThreads, 0, s>>>(
      static_cast<const int32_t*>(counts), nb, static_cast<int32_t*>(offsets),
      static_cast<int32_t*>(nnz));
  RETURN_IF_LAUNCH_FAILED();
  unpack_apply<Tt, Tv><<<static_cast<unsigned>(nb), kThreads, 0, s>>>(
      static_cast<const Tt*>(target), static_cast<const uint8_t*>(mask), n,
      static_cast<const Tv*>(cvals), static_cast<const int32_t*>(offsets),
      static_cast<Tt*>(out), accumulate);
  RETURN_IF_LAUNCH_FAILED();
  return 0;
}

}  // namespace

extern "C" int wire_pack_launch(const void* x, int in_code, int out_code,
                                int64_t n, void* mask_bytes, void* qdense,
                                void* cvals, void* cidx, void* residual,
                                void* counts, void* offsets, void* nnz,
                                void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define PACK(TI, TO) \
  return pack_all<TI, TO>(x, n, mask_bytes, qdense, cvals, cidx, residual, \
                          counts, offsets, nnz, s)
  switch (in_code * 4 + out_code) {
    case 0 * 4 + 0: PACK(float, float);
    case 0 * 4 + 1: PACK(float, __half);
    case 0 * 4 + 2: PACK(float, __nv_bfloat16);
    case 1 * 4 + 1: PACK(__half, __half);
    case 1 * 4 + 2: PACK(__half, __nv_bfloat16);
    case 2 * 4 + 1: PACK(__nv_bfloat16, __half);
    case 2 * 4 + 2: PACK(__nv_bfloat16, __nv_bfloat16);
    case 3 * 4 + 3: PACK(int32_t, int32_t);
    default: return -1;
  }
#undef PACK
}

extern "C" int wire_unpack_add_launch(const void* target, int target_code,
                                      const void* mask, int64_t n,
                                      const void* cvals, int val_code,
                                      void* counts, void* offsets, void* nnz,
                                      void* out, int accumulate,
                                      void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (accumulate && (target_code == 1 || target_code == 2)) return -1;
#define UNPACK(TT, TV)                                                \
  return unpack_all<TT, TV>(target, mask, n, cvals, counts, offsets, nnz, \
                            out, accumulate, s)
  switch (target_code * 4 + val_code) {
    case 0 * 4 + 0: UNPACK(float, float);
    case 0 * 4 + 1: UNPACK(float, __half);
    case 0 * 4 + 2: UNPACK(float, __nv_bfloat16);
    case 1 * 4 + 1: UNPACK(__half, __half);
    case 1 * 4 + 2: UNPACK(__half, __nv_bfloat16);
    case 2 * 4 + 1: UNPACK(__nv_bfloat16, __half);
    case 2 * 4 + 2: UNPACK(__nv_bfloat16, __nv_bfloat16);
    case 3 * 4 + 3: UNPACK(int32_t, int32_t);
    default: return -1;
  }
#undef UNPACK
}

// B6: out (one int32, zeroed by the caller) += the nonzeros of x[0:n];
// code 0 float32, 1 float16, 2 bfloat16, 3 int32.
extern "C" int wire_nnz_launch(const void* x, int code, int64_t n, void* out,
                               void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int es = code == 1 || code == 2 ? 2 : 4;
  uint32_t mask;
  switch (code) {
    case 0: mask = 0x7fffffffu; break;  // float32: the sign is not a hit
    case 1:
    case 2: mask = 0x7fffu; break;  // float16, bfloat16
    case 3: mask = 0xffffffffu; break;  // int32
    default: return -1;
  }
  const int vec = (reinterpret_cast<uintptr_t>(x) & 15u) == 0;
  const int64_t per = 16 / es;
  const int64_t work = vec ? n / per + n % per : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t max_blocks = 132 * 8;  // one full wave of 256-thread blocks
  blocks = blocks < 1 ? 1 : (blocks > max_blocks ? max_blocks : blocks);
  if (es == 4) {
    nnz_kernel<4><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        x, n, vec, mask, static_cast<int32_t*>(out));
  } else {
    nnz_kernel<2><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        x, n, vec, mask, static_cast<int32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
