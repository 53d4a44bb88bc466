// Fused sLSTM time scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `slstm_scan` in
// src/repro/kernels/slstm_scan.py (`_slstm_kernel`, with R laid out as
// `block_diag_r` lays it out). For t = 0 .. S-1, per batch row:
//
//   g  = xg_t + h_{t-1} . R        (R block-diagonal per head)
//   i  = exp(min(g_i, 8)),  f = sigmoid(g_f),  z = tanh(g_z),  o = sigmoid(g_o)
//   c' = f*c + i*z,  n' = f*n + i,  h' = o * (c' / max(|n'|, 1))
//
// Gate `gate` of unit u of head hd sits at column gate*d + hd*dh + u of the
// fused (4d) gate vector, the reorder of `xlstm._slstm_cell`; R is the
// per-head (H, dh, 4*dh) tensor, gates contiguous per head. Unlike the TPU
// kernel, which starts from zeros and returns h alone, this one takes an
// initial (c, n, h) and writes the final one (the prefill fills the
// decode cache from it); with a zero state and h alone it computes what
// the TPU kernel computes.
//
// Bound: at xlstm-1.3b's prefill (B 4, S 1024, d 2048, H 4, dh 512) the
// scan moves about 176 MB (xg read once, h written once, R once: 53 us at
// 3.35 TB/s) and does 34 GFLOP of float32 products (0.51 ms at 67 TFLOP/s
// on the CUDA cores), as a chain of 1024 dependent steps: its floor is the
// per-step latency, not a rate.
//
// Design. R (8.4 MB in bf16) does not fit one SM, so the TPU's "R resident
// in VMEM" becomes R resident across the card: a cooperative persistent
// kernel of d/16 blocks (128 at d 2048), each owning 16 hidden units of one
// head (all four gates' columns, for every batch row), with its 64-column
// slice of R (dh x 64, 64 KB in bf16) in shared memory for all S steps.
// Each step a block reads h_{t-1} of its head from the output (written by
// the head's blocks the step before; L2, bypassing L1), forms its 64 gate
// dot products of length dh for every batch row (256 threads: 64 columns x
// 4 slices of the dot, reduced through shared memory), and updates c, n
// and h of its units in registers; xg of the next step is prefetched
// meanwhile. One grid-wide barrier per step orders the steps.
// Precise expf/tanhf; the state update pins every rounding, as the plain
// version rounds each tensor operation.
//
// Plain C interface, loaded with ctypes: returns the first CUDA error of
// the launch (0 on success), cudaErrorCooperativeLaunchTooLarge when the
// blocks cannot all be resident at once.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kU = 16;                    // hidden units per block
constexpr int kCols = 4 * kU;             // gate columns per block
constexpr int kThreads = 256;             // kCols columns x kSplit slices
constexpr int kSplit = kThreads / kCols;  // slices of each dot product
constexpr int kBch = 4;                   // batch rows per register pass

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

template <typename TR>
__global__ void __launch_bounds__(kThreads)
    slstm_kernel(const float* __restrict__ xg, const TR* __restrict__ r,
                 const float* __restrict__ c0, const float* __restrict__ n0,
                 const float* __restrict__ h0, float* hs,
                 float* __restrict__ c1, float* __restrict__ n1,
                 float* __restrict__ h1, int batch, int steps, int d,
                 int dh) {
  cg::grid_group grid = cg::this_grid();
  const int per_head = dh / kU;
  const int head = blockIdx.x / per_head;
  const int u0 = (blockIdx.x % per_head) * kU;  // first unit within the head
  const int unit0 = head * dh + u0;             // first unit within d
  const int bpad = (batch + kBch - 1) / kBch * kBch;
  const int64_t row4 = 4 * static_cast<int64_t>(d);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  TR* sR = reinterpret_cast<TR*>(smem_raw);                 // (dh, kCols)
  float* sH = reinterpret_cast<float*>(sR + dh * kCols);  // (bpad, dh)
  float* sPart = sH + bpad * dh;                          // (kSplit, bpad, kCols)

  // R slice: column gate*kU + u holds R[head, :, gate*dh + u0 + u]
  for (int idx = threadIdx.x; idx < dh * kCols; idx += kThreads) {
    const int kk = idx / kCols;
    const int col = idx % kCols;
    sR[idx] = r[(static_cast<int64_t>(head) * dh + kk) * 4 * dh +
                (col / kU) * dh + u0 + col % kU];
  }
  for (int idx = batch * dh + threadIdx.x; idx < bpad * dh;
       idx += kThreads) {
    sH[idx] = 0.0f;  // padding rows of the batch stay zero
  }

  const int col = threadIdx.x % kCols;
  const int part = threadIdx.x / kCols;
  const int klen = dh / kSplit;
  const int kbeg = part * klen;

  // thread (ub, uu) < (batch, kU) keeps the state of one unit of one row
  const bool upd = threadIdx.x < batch * kU;
  const int ub = threadIdx.x / kU;
  const int uu = threadIdx.x % kU;
  float c = 0.0f, n = 0.0f, xgv[4] = {}, xgn[4] = {};
  const float* xrow =
      upd ? xg + static_cast<int64_t>(ub) * steps * row4 + unit0 + uu : xg;
  if (upd) {
    c = c0[static_cast<int64_t>(ub) * d + unit0 + uu];
    n = n0[static_cast<int64_t>(ub) * d + unit0 + uu];
#pragma unroll
    for (int g = 0; g < 4; ++g) xgv[g] = xrow[g * d];
  }

  for (int t = 0; t < steps; ++t) {
    // h_{t-1} of this head, every batch row
    const float* hprev = t == 0 ? h0 + head * dh
                                : hs + static_cast<int64_t>(t - 1) * d +
                                      head * dh;
    const int64_t hstride =
        t == 0 ? d : static_cast<int64_t>(steps) * d;
    for (int idx = threadIdx.x; idx < batch * dh; idx += kThreads) {
      sH[idx] = __ldcg(hprev + (idx / dh) * hstride + idx % dh);
    }
    if (upd && t + 1 < steps) {
#pragma unroll
      for (int g = 0; g < 4; ++g) xgn[g] = xrow[(t + 1) * row4 + g * d];
    }
    __syncthreads();

    for (int b0 = 0; b0 < bpad; b0 += kBch) {
      float a[kBch];
#pragma unroll
      for (int bi = 0; bi < kBch; ++bi) a[bi] = 0.0f;
      for (int kk = kbeg; kk < kbeg + klen; kk += 4) {
        const float r0 = to_f(sR[(kk + 0) * kCols + col]);
        const float r1 = to_f(sR[(kk + 1) * kCols + col]);
        const float r2 = to_f(sR[(kk + 2) * kCols + col]);
        const float r3 = to_f(sR[(kk + 3) * kCols + col]);
#pragma unroll
        for (int bi = 0; bi < kBch; ++bi) {
          const float4 hv =
              *reinterpret_cast<const float4*>(sH + (b0 + bi) * dh + kk);
          a[bi] = fmaf(hv.x, r0, a[bi]);
          a[bi] = fmaf(hv.y, r1, a[bi]);
          a[bi] = fmaf(hv.z, r2, a[bi]);
          a[bi] = fmaf(hv.w, r3, a[bi]);
        }
      }
#pragma unroll
      for (int bi = 0; bi < kBch; ++bi) {
        sPart[(part * bpad + b0 + bi) * kCols + col] = a[bi];
      }
    }
    __syncthreads();

    if (upd) {
      float g[4];
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) {
        float rh = 0.0f;
#pragma unroll
        for (int p = 0; p < kSplit; ++p) {
          rh += sPart[(p * bpad + ub) * kCols + gate * kU + uu];
        }
        g[gate] = __fadd_rn(xgv[gate], rh);
      }
      const float ig = expf(fminf(g[0], 8.0f));
      const float fg = sigmoid(g[1]);
      const float zg = tanhf(g[2]);
      const float og = sigmoid(g[3]);
      c = __fadd_rn(__fmul_rn(fg, c), __fmul_rn(ig, zg));
      n = __fadd_rn(__fmul_rn(fg, n), ig);
      const float h = __fmul_rn(og, __fdiv_rn(c, fmaxf(fabsf(n), 1.0f)));
      hs[(static_cast<int64_t>(ub) * steps + t) * d + unit0 + uu] = h;
      if (t == steps - 1) {
        const int64_t at = static_cast<int64_t>(ub) * d + unit0 + uu;
        c1[at] = c;
        n1[at] = n;
        h1[at] = h;
      }
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) xgv[gate] = xgn[gate];
    }
    grid.sync();  // h_t of every block is written before step t+1 reads it
  }
}

template <typename TR>
int launch(const void* xg, const void* r, const void* c0, const void* n0,
           const void* h0, void* hs, void* c1, void* n1, void* h1, int batch,
           int steps, int d, int heads, cudaStream_t st) {
  int dh = d / heads;
  if (dh % kU != 0 || batch > kThreads / kU) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = d / kU;
  const int bpad = (batch + kBch - 1) / kBch * kBch;
  const size_t smem =
      static_cast<size_t>(dh) * kCols * sizeof(TR) +
      (static_cast<size_t>(bpad) * dh + static_cast<size_t>(kSplit) * bpad *
                                            kCols) * sizeof(float);
  auto kern = slstm_kernel<TR>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, kThreads, smem)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  if (per_sm * sms < blocks) {
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  }
  const float* xg_ = static_cast<const float*>(xg);
  const TR* r_ = static_cast<const TR*>(r);
  const float* c0_ = static_cast<const float*>(c0);
  const float* n0_ = static_cast<const float*>(n0);
  const float* h0_ = static_cast<const float*>(h0);
  float* hs_ = static_cast<float*>(hs);
  float* c1_ = static_cast<float*>(c1);
  float* n1_ = static_cast<float*>(n1);
  float* h1_ = static_cast<float*>(h1);
  void* args[] = {&xg_, &r_, &c0_, &n0_, &h0_, &hs_, &c1_, &n1_,
                  &h1_, &batch, &steps, &d, &dh};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kern),
                                    dim3(blocks), dim3(kThreads), args, smem,
                                    st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xg (batch, steps, 4d) float32; r (heads, d/heads, 4d/heads) float32 or
// bfloat16 (r_bf16); c0, n0, h0, c1, n1, h1 (batch, d) float32; hs (batch,
// steps, d) float32. batch <= 16, d/heads a multiple of 16.
extern "C" int slstm_scan_launch(const void* xg, const void* r,
                                 const void* c0, const void* n0,
                                 const void* h0, void* hs, void* c1, void* n1,
                                 void* h1, int batch, int steps, int d,
                                 int heads, int r_bf16, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (r_bf16) {
    return launch<__nv_bfloat16>(xg, r, c0, n0, h0, hs, c1, n1, h1, batch,
                                 steps, d, heads, st);
  }
  return launch<float>(xg, r, c0, n0, h0, hs, c1, n1, h1, batch, steps, d,
                       heads, st);
}
