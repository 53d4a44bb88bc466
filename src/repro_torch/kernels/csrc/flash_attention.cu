// Blocked online-softmax (flash) attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention_bhsd` in
// src/repro/kernels/flash_attention.py (`_flash_kernel`). For each query row
// and the keys its mask allows (causal, one-sided sliding window, absolute
// query position q + q_offset, keys past Skv never):
//
//   s = (q . k) * sm_scale,  masked s = -1e30
//   m' = max(m, max_j s),  p = exp(s - m'),  c = exp(m - m')
//   l' = l * c + sum_j p,  acc' = acc * c + p @ v,  o = acc / max(l, 1e-30)
//
// Layouts: q and o (B, Sq, H, Dh), k and v (B, Skv, K, Dh), all contiguous,
// float32 or bfloat16 (one type). Query head h reads KV head h / (H / K),
// the grouping of `attention._group`: GQA is taken as it is, K/V are never
// repeated to H. Dh in {32, 64, 128, 256}; Sq and Skv are any length
// (ragged tiles are masked, nothing is padded).
//
// Bound: operations. At phi4-mini's prefill (B 4, S 1024, H 24, Dh 128,
// causal, bf16) the function needs about 25.8 GFLOP (4*B*H*S^2*Dh/2), 26 us
// at the card's 989 TFLOP/s bf16 tensor-core rate, against 67 MB of q, k, v
// and o (20 us at 3.35 TB/s). This first kernel is simple and right, not
// fast: every product is a float32 FMA on the CUDA cores (67 TFLOP/s peak,
// so >= 0.4 ms at this shape), operands upcast from bf16 as the TPU kernel
// does. What it does keep from the TPU design is the work skipping: a block
// visits only the KV tiles that hold an allowed key for one of its rows
// (the causal upper triangle, keys older than the window and tiles wholly
// past Skv are never loaded), and only tiles that straddle a mask boundary
// pay for the mask. `wgmma` on bf16 tiles fed by TMA is the next step.
//
// Design: one block of 128 threads per (query tile of BQ rows, head,
// batch row); BQ = 64, or 32 at Dh 256 (to keep the accumulator in
// registers) and at Dh 32 (ptxas holds the 64-row float32 tile to 96
// registers and spills; at 32 rows it needs 56). Q, one KV tile of 64
// keys and the tile's probabilities live in shared memory, rows padded by
// one 32-bit word against bank conflicts.
// Thread (ty, tx) of a 16 x 8 grid owns rows ty + 16 i and score columns
// tx + 8 j, output columns tx + 8 c; m, l and acc are float32 registers,
// row max and row sum reduce over the 8 lanes of a row by shuffles.
// Query tiles start from the last one, whose causal rows are longest.
// Precise expf and IEEE division throughout.
//
// Plain C interface, loaded with ctypes: returns the first CUDA error of
// the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 16 row groups x 8 column lanes
constexpr int kBK = 64;        // keys per KV tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f(float x, float* p) { *p = x; }
__device__ __forceinline__ void store_f(float x, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(x);
}

// Copies `rows` rows of DH elements into shared memory rows of `ld`
// elements; row r comes from src + r * stride, rows >= valid are zeros.
template <typename T, int DH>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          int64_t stride, int rows,
                                          int valid) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int PER_ROW = DH / V;
  for (int idx = threadIdx.x; idx < rows * PER_ROW; idx += kThreads) {
    const int r = idx / PER_ROW;
    const int c = (idx % PER_ROW) * V;
    T* d = dst + r * ld + c;
    if (r < valid) {
      uint4 raw = *reinterpret_cast<const uint4*>(src + r * stride + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) d[j] = e[j];
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) store_f(0.0f, d + j);
    }
  }
}

template <typename T, int DH, int BQ>
__global__ void __launch_bounds__(kThreads)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int sq, int skv,
              int heads, int kv_heads, int causal, int window, int q_offset,
              float sm_scale) {
  constexpr int PAD = 4 / sizeof(T);  // one 32-bit word per row
  constexpr int LD = DH + PAD;
  constexpr int LDP = kBK + 1;
  constexpr int R = BQ / 16;   // rows per thread
  constexpr int CK = kBK / 8;  // score columns per thread
  constexpr int CD = DH / 8;   // output columns per thread

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + BQ * LD;
  T* sV = sK + kBK * LD;
  float* sP = reinterpret_cast<float*>(sV + kBK * LD);

  const int tx = threadIdx.x & 7;
  const int ty = threadIdx.x >> 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest rows first
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kv_head = head / (heads / kv_heads);
  const int q_rows = min(BQ, sq - q0);
  const int64_t q_stride = static_cast<int64_t>(heads) * DH;
  const int64_t kv_stride = static_cast<int64_t>(kv_heads) * DH;
  const T* qb = q + (static_cast<int64_t>(b) * sq + q0) * q_stride +
                static_cast<int64_t>(head) * DH;
  const int64_t kv_base = static_cast<int64_t>(b) * skv * kv_stride +
                          static_cast<int64_t>(kv_head) * DH;

  load_tile<T, DH>(sQ, LD, qb, q_stride, BQ, q_rows);

  // the KV tiles that hold an allowed key for some row of this tile
  const int first_q = q_offset + q0;
  const int last_q = first_q + q_rows - 1;
  const int n_kt = (skv + kBK - 1) / kBK;
  const int kt_hi = causal ? min(n_kt, last_q / kBK + 1) : n_kt;
  const int kt_lo = (window > 0 && first_q - window + 1 > 0)
                        ? (first_q - window + 1) / kBK
                        : 0;

  float m[R], l[R], acc[R][CD];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.0f;
  }

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBK;
    const int k_rows = min(kBK, skv - k0);
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, DH>(sK, LD, k + kv_base + k0 * kv_stride, kv_stride, kBK,
                     k_rows);
    load_tile<T, DH>(sV, LD, v + kv_base + k0 * kv_stride, kv_stride, kBK,
                     k_rows);
    __syncthreads();

    float s[R][CK];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qv[R], kv[CK];
#pragma unroll
      for (int i = 0; i < R; ++i) qv[i] = to_f(sQ[(ty + 16 * i) * LD + d]);
#pragma unroll
      for (int j = 0; j < CK; ++j) kv[j] = to_f(sK[(tx + 8 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // the mask only where the tile straddles a boundary
    const bool boundary = (k0 + kBK > skv) ||
                          (causal && k0 + kBK - 1 > first_q) ||
                          (window > 0 && last_q - k0 >= window);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qp = first_q + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        float x = s[i][j] * sm_scale;
        if (boundary) {
          const int kp = k0 + tx + 8 * j;
          const bool ok = kp < skv && (!causal || kp <= qp) &&
                          (window <= 0 || qp - kp < window);
          x = ok ? x : kNegInf;
        }
        s[i][j] = x;
      }
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < CK; ++j) mx = fmaxf(mx, s[i][j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        sP[(ty + 16 * i) * LDP + tx + 8 * j] = p;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) pv[i] = sP[(ty + 16 * i) * LDP + j];
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        const float vv = to_f(sV[j * LD + tx + 8 * c]);
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = ty + 16 * i;
    if (row < q_rows) {
      const float lv = fmaxf(l[i], 1e-30f);
      T* orow = o + (static_cast<int64_t>(b) * sq + q0 + row) * q_stride +
                static_cast<int64_t>(head) * DH;
#pragma unroll
      for (int c = 0; c < CD; ++c) store_f(acc[i][c] / lv, orow + tx + 8 * c);
    }
  }
}

template <typename T, int DH, int BQ>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int sq, int skv, int heads, int kv_heads, int causal, int window,
           int q_offset, float sm_scale, cudaStream_t st) {
  constexpr int PAD = 4 / sizeof(T);
  const size_t smem =
      static_cast<size_t>(BQ + 2 * kBK) * (DH + PAD) * sizeof(T) +
      static_cast<size_t>(BQ) * (kBK + 1) * sizeof(float);
  auto kern = flash_fwd<T, DH, BQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sq + BQ - 1) / BQ, heads, batch);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, skv, heads, kv_heads,
      causal, window, q_offset, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dh(int dh, const void* q, const void* k, const void* v, void* o,
              int batch, int sq, int skv, int heads, int kv_heads, int causal,
              int window, int q_offset, float sm_scale, cudaStream_t st) {
  switch (dh) {
    case 32:
      return launch<T, 32, 32>(q, k, v, o, batch, sq, skv, heads, kv_heads,
                               causal, window, q_offset, sm_scale, st);
    case 64:
      return launch<T, 64, 64>(q, k, v, o, batch, sq, skv, heads, kv_heads,
                               causal, window, q_offset, sm_scale, st);
    case 128:
      return launch<T, 128, 64>(q, k, v, o, batch, sq, skv, heads, kv_heads,
                                causal, window, q_offset, sm_scale, st);
    case 256:
      return launch<T, 256, 32>(q, k, v, o, batch, sq, skv, heads, kv_heads,
                                causal, window, q_offset, sm_scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o: (batch, sq, heads, dh); k, v: (batch, skv, kv_heads, dh); window <=
// 0 is no window; bf16 selects bfloat16 operands, else float32.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int batch,
                                      int sq, int skv, int heads,
                                      int kv_heads, int dh, int bf16,
                                      int causal, int window, int q_offset,
                                      float sm_scale, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch_dh<__nv_bfloat16>(dh, q, k, v, o, batch, sq, skv, heads,
                                    kv_heads, causal, window, q_offset,
                                    sm_scale, st);
  }
  return launch_dh<float>(dh, q, k, v, o, batch, sq, skv, heads, kv_heads,
                          causal, window, q_offset, sm_scale, st);
}
