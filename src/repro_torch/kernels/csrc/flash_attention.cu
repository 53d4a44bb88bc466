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
// and o (20 us at 3.35 TB/s). Both designs below keep the TPU kernel's work
// skipping: a block visits only the KV tiles that hold an allowed key for
// one of its rows (the causal upper triangle, keys older than the window
// and tiles wholly past Skv are never loaded), only tiles that straddle a
// mask boundary pay for the mask, and query tiles start from the last one,
// whose causal rows are longest. Precise expf and IEEE division throughout.
//
// bfloat16: the tensor cores, fed by TMA (`tc` below). One block per
// (query tile of BQ rows, head, batch row). Warpgroup 0 is the producer: one
// thread loads the Q tile once and streams K/V tiles of BK keys through a
// 2-stage shared-memory ring with TMA, each stage guarded by "full"
// mbarriers (K and V apart, completed by the copies' byte counts) and an
// "empty" mbarrier (one arrival per consumer warp). Each consumer warpgroup
// owns 64 query rows: S = Q K^T is `wgmma` m64nBKk16 with both operands in
// shared memory (K-major, Dh/16 steps), the softmax runs on the float32
// accumulator fragment in registers (row max and sum over the 4 lanes that
// share a row), P is rounded to bf16 in registers and becomes the A
// fragment of O += P V (`wgmma` m64nDhk16, V read MN-major through the
// transpose bit), so P never touches shared memory. m, l and O stay
// float32 in registers. At Dh 128, BQ is 128 (two consumers; `setmaxnreg`
// moves registers from the producer to them) unless Sq <= 64. At Dh 32 and
// 64, BQ is 64 (one consumer) with BK 64, in 128 registers, so that two
// blocks share an SM and overlap; Dh 256 takes BQ 64 and BK 64. TMA reads
// q, k and v in place through 4-d tensor maps (Dh, heads, S, B) with boxes
// of 64 columns (32 at Dh 32), one head and BQ or BK rows: rows past Sq or
// Skv load as zeros (and tail keys are masked), and each 128-byte (64-byte
// at Dh 32) row lands swizzled as `wgmma`'s descriptors expect. One
// rounding is new against the TPU kernel: P goes to bf16 before P V.
//
// float32: the CUDA cores (`simt` below; tensor cores would need TF32,
// which breaks the 2e-5 float32 tolerance). One block of 128 threads per
// query tile of BQ rows (64, or 32 at Dh 32 and 256 to keep the
// accumulator in registers); Q, one KV tile of 64 keys and the tile's
// probabilities live in shared memory, rows padded by one 32-bit word
// against bank conflicts. Thread (ty, tx) of a 16 x 8 grid owns rows
// ty + 16 i, score columns tx + 8 j and output columns tx + 8 c; row max
// and row sum reduce over the 8 lanes of a row by shuffles.
//
// Plain C interface, loaded with ctypes: returns the first CUDA error of
// the launch (0 on success), or 10000 + the driver's CUresult where a
// tensor map cannot be encoded.

#include <cuda.h>  // CUtensorMap; the encoder is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

// ---- float32: CUDA cores ---------------------------------------------------

namespace simt {

constexpr int kThreads = 128;  // 16 row groups x 8 column lanes
constexpr int kBK = 64;        // keys per KV tile

// Copies `rows` rows of DH floats into shared memory rows of `ld`; row r
// comes from src + r * stride, rows >= valid are zeros.
template <int DH>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const float* src, int64_t stride,
                                          int rows, int valid) {
  constexpr int PER_ROW = DH / 4;  // 16-byte loads per row
  for (int idx = threadIdx.x; idx < rows * PER_ROW; idx += kThreads) {
    const int r = idx / PER_ROW;
    const int c = (idx % PER_ROW) * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < valid) x = *reinterpret_cast<const float4*>(src + r * stride + c);
    float* d = dst + r * ld + c;
    d[0] = x.x;
    d[1] = x.y;
    d[2] = x.z;
    d[3] = x.w;
  }
}

template <int DH, int BQ>
__global__ void __launch_bounds__(kThreads)
    flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int sq,
              int skv, int heads, int kv_heads, int causal, int window,
              int q_offset, float sm_scale) {
  constexpr int LD = DH + 1;
  constexpr int LDP = kBK + 1;
  constexpr int R = BQ / 16;   // rows per thread
  constexpr int CK = kBK / 8;  // score columns per thread
  constexpr int CD = DH / 8;   // output columns per thread

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + BQ * LD;
  float* sV = sK + kBK * LD;
  float* sP = sV + kBK * LD;

  const int tx = threadIdx.x & 7;
  const int ty = threadIdx.x >> 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest rows first
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kv_head = head / (heads / kv_heads);
  const int q_rows = min(BQ, sq - q0);
  const int64_t q_stride = static_cast<int64_t>(heads) * DH;
  const int64_t kv_stride = static_cast<int64_t>(kv_heads) * DH;
  const float* qb = q + (static_cast<int64_t>(b) * sq + q0) * q_stride +
                    static_cast<int64_t>(head) * DH;
  const int64_t kv_base = static_cast<int64_t>(b) * skv * kv_stride +
                          static_cast<int64_t>(kv_head) * DH;

  load_tile<DH>(sQ, LD, qb, q_stride, BQ, q_rows);

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
    load_tile<DH>(sK, LD, k + kv_base + k0 * kv_stride, kv_stride, kBK,
                  k_rows);
    load_tile<DH>(sV, LD, v + kv_base + k0 * kv_stride, kv_stride, kBK,
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
      for (int i = 0; i < R; ++i) qv[i] = sQ[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < CK; ++j) kv[j] = sK[(tx + 8 * j) * LD + d];
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
        const float vv = sV[j * LD + tx + 8 * c];
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
      float* orow = o + (static_cast<int64_t>(b) * sq + q0 + row) * q_stride +
                    static_cast<int64_t>(head) * DH;
#pragma unroll
      for (int c = 0; c < CD; ++c) orow[tx + 8 * c] = acc[i][c] / lv;
    }
  }
}

template <int DH, int BQ>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int sq, int skv, int heads, int kv_heads, int causal, int window,
           int q_offset, float sm_scale, cudaStream_t st) {
  const size_t smem =
      static_cast<size_t>(BQ + 2 * kBK) * (DH + 1) * sizeof(float) +
      static_cast<size_t>(BQ) * (kBK + 1) * sizeof(float);
  auto kern = flash_fwd<DH, BQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sq + BQ - 1) / BQ, heads, batch);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), sq, skv, heads,
      kv_heads, causal, window, q_offset, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_dh(int dh, const void* q, const void* k, const void* v, void* o,
              int batch, int sq, int skv, int heads, int kv_heads, int causal,
              int window, int q_offset, float sm_scale, cudaStream_t st) {
  switch (dh) {
    case 32:
      return launch<32, 32>(q, k, v, o, batch, sq, skv, heads, kv_heads,
                            causal, window, q_offset, sm_scale, st);
    case 64:
      return launch<64, 64>(q, k, v, o, batch, sq, skv, heads, kv_heads,
                            causal, window, q_offset, sm_scale, st);
    case 128:
      return launch<128, 64>(q, k, v, o, batch, sq, skv, heads, kv_heads,
                             causal, window, q_offset, sm_scale, st);
    case 256:
      return launch<256, 32>(q, k, v, o, batch, sq, skv, heads, kv_heads,
                             causal, window, q_offset, sm_scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace simt

// ---- bfloat16: tensor cores fed by TMA -------------------------------------

namespace tc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Arrives once and adds `bytes` to the transactions the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spins until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA copy of a (c0.., c1, c2.., c3) box of a 4-d tensor map into
// shared memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// A shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle layout (1: 128 B, 2: 64 B).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(layout) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous `wgmma` that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x 64, float32) = A (64 x 16) * B (64 x 16)^T, A and B bf16 in
// shared memory, both K-major; D is overwritten where scale_d is 0.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D (64 x 128, float32) = A (64 x 16) * B (128 x 16)^T, A and B bf16 in
// shared memory, both K-major; D is overwritten where scale_d is 0.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D (64 x 32, float32) += A (64 x 16, bf16 in registers) * B (16 x 32,
// bf16 in shared memory, MN-major: the transpose bit is set).
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, 1, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// D (64 x 64, float32) += A (64 x 16, bf16 in registers) * B (16 x 64,
// bf16 in shared memory, MN-major: the transpose bit is set).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// D (64 x 128, float32) += A (64 x 16, bf16 in registers) * B (16 x 128,
// bf16 in shared memory, MN-major: the transpose bit is set).
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// D (64 x 256, float32) += A (64 x 16, bf16 in registers) * B (16 x 256,
// bf16 in shared memory, MN-major: the transpose bit is set).
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, 1, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// One online-softmax step on a tile's scores, in place in the S
// accumulator fragment: entry j is this thread's row h = (j >> 1) & 1 and
// the key 8 * (j >> 2) + (j & 1) past its first one. With MASK, keys
// outside [lo[h], hi[h]) (in those offsets) score -1e30. Rescales m, l
// (this thread's partial row sums) and acc, and leaves P rounded to bf16
// as the A fragments of P V: pair by pair the S fragment is the A
// fragment, 16 keys (entries 8kk .. 8kk + 7) a step.
template <bool MASK, int NS, int NO>
__device__ __forceinline__ void softmax_tile(float (&sc)[NS],
                                             uint32_t (&pa)[NS / 8][4],
                                             float (&acc)[NO], float (&m)[2],
                                             float (&l)[2], float sm_scale,
                                             const int (&lo)[2],
                                             const int (&hi)[2]) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int h = (j >> 1) & 1;
    float x = sc[j] * sm_scale;
    if (MASK) {
      const int off = 8 * (j >> 2) + (j & 1);
      x = off >= lo[h] && off < hi[h] ? x : kNegInf;
    }
    sc[j] = x;
    mx[h] = fmaxf(mx[h], x);
  }
  float corr[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h]);
    corr[h] = expf(m[h] - m_new);
    m[h] = m_new;
  }
#pragma unroll
  for (int j = 0; j < NS; j += 2) {
    const int h = (j >> 1) & 1;
    const float p0 = expf(sc[j] - m[h]);
    const float p1 = expf(sc[j + 1] - m[h]);
    rs[h] += p0 + p1;
    __nv_bfloat162 pk = __floats2bfloat162_rn(p0, p1);
    pa[j / 8][(j / 2) % 4] = *reinterpret_cast<uint32_t*>(&pk);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + rs[h];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j] *= corr[(j >> 1) & 1];
}

// Tile shapes and the shared-memory plan of one block.
template <int DH, int NC>
struct Tile {
  static constexpr int kBQ = 64 * NC;  // query rows
  // one consumer at Dh <= 64 takes BK 64 and stays within 128 registers,
  // so two blocks share an SM and overlap each other's loads and softmax
  static constexpr bool kPair = NC == 1 && DH <= 64;
  static constexpr int kBK = DH == 256 || kPair ? 64 : 128;  // keys a tile
  static constexpr int kStages = 2;
  static constexpr int kThreads = 128 * (NC + 1);
  static constexpr int kBlocksPerSM = kPair ? 2 : 1;
  // a "panel" is one TMA box wide: 64 columns (128 B rows, 128-byte
  // swizzle), or the whole 32 at Dh 32 (64 B rows, 64-byte swizzle)
  static constexpr int kCols = DH < 64 ? DH : 64;
  static constexpr int kPanels = DH / kCols;
  static constexpr int kRowBytes = kCols * 2;
  static constexpr uint32_t kLayout = kRowBytes == 128 ? 1 : 2;
  static constexpr int kGroupBytes = 8 * kRowBytes;  // 8 rows: the SBO
  static constexpr int kQPanel = kBQ * kRowBytes;
  static constexpr int kKVPanel = kBK * kRowBytes;
  static constexpr int kQBytes = kBQ * DH * 2;
  static constexpr int kKVBytes = kBK * DH * 2;  // one K or V tile
  static constexpr int kBars = 1 + 3 * kStages;   // q, k, v full; empty
  static constexpr size_t kSmem =
      1024 + kQBytes + 2 * kStages * kKVBytes + 8 * kBars;  // + alignment
};

template <int DH, int NC>
__global__ void __launch_bounds__(Tile<DH, NC>::kThreads,
                                  Tile<DH, NC>::kBlocksPerSM)
    flash_fwd(const __grid_constant__ CUtensorMap map_q,
              const __grid_constant__ CUtensorMap map_k,
              const __grid_constant__ CUtensorMap map_v,
              __nv_bfloat16* __restrict__ o, int sq, int skv, int heads,
              int kv_heads, int causal, int window, int q_offset,
              float sm_scale) {
  using T = Tile<DH, NC>;
  constexpr int BQ = T::kBQ, BK = T::kBK, S = T::kStages;

  extern __shared__ unsigned char smem_raw[];
  // swizzled tiles want 1024-byte alignment
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sKV = sQ + T::kQBytes;  // stage s: K, then V
  const uint32_t bars = sKV + 2 * S * T::kKVBytes;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + S + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * S + s); };
  auto k_tile = [&](int s) { return sKV + 2 * s * T::kKVBytes; };
  auto v_tile = [&](int s) { return k_tile(s) + T::kKVBytes; };

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest rows first
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kv_head = head / (heads / kv_heads);
  const int q_rows = min(BQ, sq - q0);

  // the KV tiles that hold an allowed key for some row of this tile
  const int first_q = q_offset + q0;
  const int last_q = first_q + q_rows - 1;
  const int n_kt = (skv + BK - 1) / BK;
  const int kt_hi = causal ? min(n_kt, last_q / BK + 1) : n_kt;
  const int kt_lo = (window > 0 && first_q - window + 1 > 0)
                        ? (first_q - window + 1) / BK
                        : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 4 * NC);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every copy ----
    if constexpr (NC == 2) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    }
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, T::kQBytes);
      for (int p = 0; p < T::kPanels; ++p) {
        tma_load(sQ + p * T::kQPanel, &map_q, q_full, p * T::kCols, head, q0,
                 b);
      }
      for (int kt = kt_lo; kt < kt_hi; ++kt) {
        const int it = kt - kt_lo, s = it % S;
        mbar_wait(empty(s), ((it / S) & 1) ^ 1);  // the first round passes
        const int k0 = kt * BK;
        mbar_expect_tx(k_full(s), T::kKVBytes);
        for (int p = 0; p < T::kPanels; ++p) {
          tma_load(k_tile(s) + p * T::kKVPanel, &map_k, k_full(s),
                   p * T::kCols, kv_head, k0, b);
        }
        mbar_expect_tx(v_full(s), T::kKVBytes);
        for (int p = 0; p < T::kPanels; ++p) {
          tma_load(v_tile(s) + p * T::kKVPanel, &map_v, v_full(s),
                   p * T::kCols, kv_head, k0, b);
        }
      }
    }
  } else {
    // ---- consumer warpgroup c: query rows 64c .. 64c + 63 of the tile ----
    if constexpr (NC == 2) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    }
    const int c = wg - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    // this thread's two rows (r and r + 8) and its first column in each
    // 8-column chunk of a `wgmma` accumulator fragment
    const int r_lo = 64 * c + 16 * warp + lane / 4;
    const int col = 2 * (lane % 4);
    const int wg_first = first_q + 64 * c, wg_last = wg_first + 63;

    float acc[DH / 2];
#pragma unroll
    for (int j = 0; j < DH / 2; ++j) acc[j] = 0.0f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
    const uint32_t q_rows_at = sQ + 64 * c * T::kRowBytes;

    mbar_wait(q_full, 0);
    for (int kt = kt_lo; kt < kt_hi; ++kt) {
      const int it = kt - kt_lo, s = it % S;
      const uint32_t ph = (it / S) & 1;
      const int k0 = kt * BK;

      // S = Q K^T: Dh/16 steps of 16 columns, 32 bytes along a swizzled
      // row (the hardware applies the swizzle to the advanced address)
      float sc[BK / 2];
      mbar_wait(k_full(s), ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const int p = kk / (T::kCols / 16);
        const uint32_t off = (kk % (T::kCols / 16)) * 32;
        const uint64_t da = smem_desc(q_rows_at + p * T::kQPanel + off, 16,
                                      T::kGroupBytes, T::kLayout);
        const uint64_t db = smem_desc(k_tile(s) + p * T::kKVPanel + off, 16,
                                      T::kGroupBytes, T::kLayout);
        wgmma_ss(sc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // the mask only where the tile straddles a boundary: each row's
      // allowed keys as offsets [lo, hi) past this thread's first key
      uint32_t pa[BK / 16][4];
      if ((k0 + BK > skv) || (causal && k0 + BK - 1 > wg_first) ||
          (window > 0 && wg_last - k0 >= window)) {
        int lo[2], hi[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int qp = q_offset + q0 + r_lo + 8 * h;
          hi[h] = (causal ? min(skv, qp + 1) : skv) - k0 - col;
          lo[h] = window > 0 ? qp - window + 1 - k0 - col : -1;
        }
        softmax_tile<true>(sc, pa, acc, m, l, sm_scale, lo, hi);
      } else {
        const int none[2] = {0, 0};
        softmax_tile<false>(sc, pa, acc, m, l, sm_scale, none, none);
      }

      // O += P V: BK/16 steps of 16 keys; V is MN-major (Dh contiguous),
      // its 64-column panels LBO apart, its 8-key groups SBO apart
      mbar_wait(v_full(s), ph);
      wgmma_fence();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db =
            smem_desc(v_tile(s) + kk * 16 * T::kRowBytes, T::kKVPanel,
                      T::kGroupBytes, T::kLayout);
        wgmma_rs(acc, pa[kk], db);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty(s));  // this warp is done with stage s
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r_lo + 8 * h;
      if (row < q_rows) {
        const float lv = fmaxf(l[h], 1e-30f);
        __nv_bfloat16* orow =
            o + ((static_cast<int64_t>(b) * sq + q0 + row) * heads + head) *
                    static_cast<int64_t>(DH);
#pragma unroll
        for (int i = 0; i < DH / 8; ++i) {
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i + col) =
              __floats2bfloat162_rn(acc[4 * i + 2 * h] / lv,
                                    acc[4 * i + 2 * h + 1] / lv);
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled, a driver function, reached through the runtime so
// the library links against nothing but the runtime.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      return nullptr;
    }
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map over a contiguous (batch, seq, heads, dh) bf16 tensor as the 4-d
// (dh, heads, seq, batch), boxes of `cols` x 1 head x `rows` x 1; reads
// past the tensor's edges fill zeros.
int encode(CUtensorMap* map, const void* ptr, int dh, int heads, int seq,
           int batch, int cols, int rows, CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t row = static_cast<cuuint64_t>(dh) * 2;  // bytes
  const cuuint64_t strides[3] = {row, row * heads, row * heads * seq};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                    const_cast<void*>(ptr), dims, strides, box, elem,
                    CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                    CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : 10000 + static_cast<int>(res);
}

template <int DH, int NC>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int sq, int skv, int heads, int kv_heads, int causal, int window,
           int q_offset, float sm_scale, cudaStream_t st) {
  using T = Tile<DH, NC>;
  const CUtensorMapSwizzle swz = T::kRowBytes == 128
                                     ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap mq, mk, mv;
  int err = encode(&mq, q, DH, heads, sq, batch, T::kCols, T::kBQ, swz);
  if (err == 0) {
    err = encode(&mk, k, DH, kv_heads, skv, batch, T::kCols, T::kBK, swz);
  }
  if (err == 0) {
    err = encode(&mv, v, DH, kv_heads, skv, batch, T::kCols, T::kBK, swz);
  }
  if (err != 0) return err;
  auto kern = flash_fwd<DH, NC>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::kSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((sq + T::kBQ - 1) / T::kBQ, heads, batch);
  kern<<<grid, T::kThreads, T::kSmem, st>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), sq, skv, heads, kv_heads,
      causal, window, q_offset, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// Two consumer warpgroups (a 128-row query tile) at Dh 128 where Sq > 64;
// one (64 rows) elsewhere: at Dh <= 64 two blocks share an SM, and where
// Sq <= 64 a second warpgroup would hold no row. The faster at each shape
// timed (PERF.md §6). Dh 256 is always 64.
int launch_dh(int dh, const void* q, const void* k, const void* v, void* o,
              int batch, int sq, int skv, int heads, int kv_heads, int causal,
              int window, int q_offset, float sm_scale, cudaStream_t st) {
  if (skv == 0) {  // no key: every row is 0 / 1e-30
    return static_cast<int>(cudaMemsetAsync(
        o, 0, static_cast<size_t>(batch) * sq * heads * dh * 2, st));
  }
#define TC_LAUNCH(DH, NC)                                                  \
  return launch<DH, NC>(q, k, v, o, batch, sq, skv, heads, kv_heads, causal, \
                        window, q_offset, sm_scale, st)
  switch (dh) {
    case 32:
      TC_LAUNCH(32, 1);
    case 64:
      TC_LAUNCH(64, 1);
    case 128:
      if (sq > 64) TC_LAUNCH(128, 2);
      TC_LAUNCH(128, 1);
    case 256:
      TC_LAUNCH(256, 1);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TC_LAUNCH
}

}  // namespace tc

}  // namespace

// q, o: (batch, sq, heads, dh); k, v: (batch, skv, kv_heads, dh); window <=
// 0 is no window; bf16 selects bfloat16 operands (the tensor-core kernel),
// else float32 (the CUDA-core kernel).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int batch,
                                      int sq, int skv, int heads,
                                      int kv_heads, int dh, int bf16,
                                      int causal, int window, int q_offset,
                                      float sm_scale, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (bf16) {
    return tc::launch_dh(dh, q, k, v, o, batch, sq, skv, heads, kv_heads,
                         causal, window, q_offset, sm_scale, st);
  }
  return simt::launch_dh(dh, q, k, v, o, batch, sq, skv, heads, kv_heads,
                         causal, window, q_offset, sm_scale, st);
}
