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
// Two routes, chosen by the caller's plan (kernels/slstm_scan.py `plan`),
// which this file checks and never replaces:
//
// Cluster route (`clu`, bf16 R at dh 32..512). Heads never exchange state
// (R is block-diagonal), so each (head, group of up to 4 batch rows) is one
// thread-block cluster of dh/32 CTAs (16 at dh 512), and nothing is
// synchronised across clusters. A CTA owns 32 units of the head, all four
// gate columns of each, and keeps that 128-column slice of R (128 KiB of
// bf16 at dh 512) in its warps' registers as tensor-core A fragments for
// all S steps. Each step it multiplies them by h_{t-1} of its rows on the
// tensor cores (mma.sync m16n8k16, float32 accumulators), with h split
// into three bf16 terms (hi + mid + lo, h to 2^-27 of it): every product
// is exact and every sum float32, so the dot products are float32 dot
// products in another order. One warp a batch row then adds xg and
// updates c, n, h of the CTA's 32 units in registers, and sends h_t to
// every CTA of the cluster through distributed shared memory (st.async
// into the peer's next h buffer, counted by the peer's mbarrier). A CTA
// waits only on its own mbarrier, for h_{t-1} from all its peers; h is
// double buffered, and a peer's h_t can only arrive after that peer has
// read the buffer it overwrites, so no cluster barrier is needed per
// step. xg is loaded four steps ahead with cp.async into a ring.
//
// Cooperative route (`coop`, float32 R, whose slice does not fit 16
// CTAs' registers or shared memory): one persistent launch of d/16
// blocks, each owning 16 units (64 columns of R) in shared memory; h_{t-1}
// read back from the output through L2 and one grid-wide barrier a step.
//
// Precise expf/tanhf on both routes; the state update pins every rounding,
// as the plain version rounds each tensor operation.
//
// Plain C interface, loaded with ctypes: each entry returns the first CUDA
// error (0 on success), cudaErrorInvalidValue for a plan it does not take
// and cudaErrorCooperativeLaunchTooLarge when the cooperative blocks cannot
// all be resident at once. A cluster that the card cannot schedule fails
// its launch; nothing falls back to the other route.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxSmem = 232448;  // a block's shared memory on sm_90

// The launch plan (kernels/slstm_scan.py `Plan`): route 0 cooperative,
// 1 cluster; CTAs a cluster (C), hidden units a CTA (U), batch rows a
// cluster, slices of each dot product (KS), dynamic shared memory bytes.
struct Plan {
  int route, cluster, units, rows, kslices, smem;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// One cell update from the gate pre-activations g (i, f, z, o); returns h.
__device__ __forceinline__ float cell(const float g[4], float& c, float& n) {
  const float ig = expf(fminf(g[0], 8.0f));
  const float fg = sigmoid(g[1]);
  const float zg = tanhf(g[2]);
  const float og = sigmoid(g[3]);
  c = __fadd_rn(__fmul_rn(fg, c), __fmul_rn(ig, zg));
  n = __fadd_rn(__fmul_rn(fg, n), ig);
  return __fmul_rn(og, __fdiv_rn(c, fmaxf(fabsf(n), 1.0f)));
}

}  // namespace

namespace coop {

constexpr int kU = 16;                    // hidden units per block
constexpr int kCols = 4 * kU;             // gate columns per block
constexpr int kThreads = 256;             // kCols columns x kSplit slices
constexpr int kSplit = kThreads / kCols;  // slices of each dot product
constexpr int kBch = 4;                   // batch rows per register pass

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
      const float h = cell(g, c, n);
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
           int steps, int d, int heads, const Plan& p, cudaStream_t st) {
  int dh = d / heads;
  const int blocks = d / kU;
  const int bpad = (batch + kBch - 1) / kBch * kBch;
  const size_t smem =
      static_cast<size_t>(dh) * kCols * sizeof(TR) +
      (static_cast<size_t>(bpad) * dh + static_cast<size_t>(kSplit) * bpad *
                                            kCols) * sizeof(float);
  if (dh % kU != 0 || batch > kThreads / kU || p.cluster != 1 ||
      p.units != kU || p.rows != batch || p.kslices != kSplit ||
      p.smem != static_cast<int>(smem) || p.smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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

}  // namespace coop

namespace clu {

constexpr int kUnits = 32;    // hidden units a CTA
constexpr int kCols = 4 * kUnits;  // gate columns a CTA: unit*4 + gate
constexpr int kMaxRows = 4;   // batch rows a cluster
constexpr int kN = 8;         // columns of a tensor-core tile
constexpr int kTerms = 3;     // bf16 terms of h: column row*3 + term
constexpr int kRing = 4;      // steps of xg loaded ahead
constexpr int kPStride = 132;  // a row of partial sums, padded
constexpr int kParts = 2;     // K parts of each dot product, 4 warps each
constexpr int kThreads = 128 * kParts;

__device__ __forceinline__ uint32_t cta_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cta_count() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A shared::cta address of this CTA as the same place in CTA `rank`.
__device__ __forceinline__ uint32_t in_peer(uint32_t a, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(a), "r"(rank));
  return out;
}

__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(bytes) : "memory");
}

// Waits for the phase of parity `parity` of a barrier that stores from
// other CTAs of the cluster complete.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// 16 bytes to `dst` in a CTA of the cluster, completing on that CTA's
// barrier `bar` (both shared::cluster addresses).
__device__ __forceinline__ void store_to_peer(uint32_t dst, float4 v,
                                              uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];" ::"r"(dst), "f"(v.x), "f"(v.y), "f"(v.z),
      "f"(v.w), "r"(bar) : "memory");
}

__device__ __forceinline__ void load4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst),
               "l"(src) : "memory");
}

__device__ __forceinline__ void load_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo_k,
                                         __nv_bfloat16 hi_k) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo_k)) |
         static_cast<uint32_t>(__bfloat16_as_ushort(hi_k)) << 16;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return pack(v.x, v.y);
}

// h = hi + mid + lo for the pair (a, b): three bf16 terms whose sum is
// each value to 2^-27 of it, hi = bf16(h), mid = bf16(h - hi), lo =
// bf16(h - hi - mid); out[s] holds term s of (a, b), a in the low half.
__device__ __forceinline__ void split(float a, float b, uint32_t* out) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(a, b);
  const float2 hif = __bfloat1622float2(hi);
  const float ra = __fsub_rn(a, hif.x);
  const float rb = __fsub_rn(b, hif.y);
  const __nv_bfloat162 mid = __floats2bfloat162_rn(ra, rb);
  const float2 midf = __bfloat1622float2(mid);
  out[0] = bits(hi);
  out[1] = bits(mid);
  out[2] = bits(__floats2bfloat162_rn(__fsub_rn(ra, midf.x),
                                      __fsub_rn(rb, midf.y)));
}

// D += A (16 x 16, bf16, rows = gate columns) * B (16 x 8, bf16, columns =
// (batch row, term) pairs), float32 accumulators.
__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Tile columns of N: (row, term) pairs of up to 2 rows fill one tile,
// of 3 or 4 rows two.
__host__ __device__ constexpr int n_tiles(int rows) {
  return rows <= 2 ? 1 : 2;
}

// K tiles of a warp's A fragments held in registers; the rest (at dh 512
// all 16 would leave the step too few registers) in shared memory.
__host__ __device__ constexpr int k_regs(int kt) { return kt == 16 ? 12 : kt; }

// Dynamic shared memory of a CTA, in this order: the A fragments past
// k_regs (16 bytes a thread each), h_{t-1} as bf16 terms (B^T: one row of
// dh per tile column), h (two buffers, nb rows), the K parts' partial sums
// (one row per tile column), the xg ring, two barriers.
__host__ __device__ constexpr int64_t smem_bytes(int dh, int nb, int kp) {
  return static_cast<int64_t>(16) * 2 * kThreads *
             (dh / (16 * kp) - k_regs(dh / (16 * kp))) +
         static_cast<int64_t>(n_tiles(nb)) * kN * (dh + 8) * 2 +
         static_cast<int64_t>(4) *
             (2 * nb * dh + kp * kTerms * kMaxRows * kPStride +
              kRing * nb * kCols) +
         16;
}

// One cluster per (head, group of batch rows); CTA `rank` holds units
// 32*rank .. +31 of the head, gate columns m = unit*4 + gate. Warp w =
// (pair p = w % 4, part kq = w / 4) keeps in registers, for all S steps,
// the A fragments of M tiles 2p and 2p+1 (32 gate columns) over K tiles
// kq*KT .. +KT-1 of R (KT = dh / 32: 8 warps a CTA, so that up to 255
// registers a thread hold 12 of dh 512's 16 K tiles, the other 4 in
// shared memory), and each step multiplies them by h_{t-1}'s three
// bf16 terms, one tile column for each (row, term) (mma.sync m16n8k16,
// float32 accumulators): every product is exact, and the terms carry h
// to 2^-27. Then warp `row` (one per batch row), lane `unit`, adds for
// each of the unit's four gates, part by part in order, each part's terms
// (lo + mid) + hi, and xg, updates (c, n, h), and sends h_t of the row's
// 32 units to every CTA of the cluster: lane l the units 4(l % 8) .. +3
// to CTAs l / 8 + 4j (st.async of 16 bytes into its next h buffer,
// completing on its barrier). Each step opens with every CTA splitting
// the h_{t-1} it received into the three terms.
template <int KT, int NT>
__global__ void __launch_bounds__(kThreads, 1)
    slstm_cluster_kernel(const float* __restrict__ xg,
                         const __nv_bfloat16* __restrict__ r,
                         const float* __restrict__ c0,
                         const float* __restrict__ n0,
                         const float* __restrict__ h0, float* __restrict__ hs,
                         float* __restrict__ c1, float* __restrict__ n1,
                         float* __restrict__ h1, int batch, int steps, int d,
                         int dh, int rows, int groups) {
  const int csize = static_cast<int>(cta_count());
  const int rank = static_cast<int>(cta_rank());
  const int cid = blockIdx.x / csize;
  const int head = cid / groups;
  const int b0 = (cid % groups) * rows;  // first batch row of the cluster
  const int nrows = min(rows, batch - b0);
  const int nb = rows >= 3 ? 4 : rows;  // rows of the h buffers, xg ring
  constexpr int kp = kParts;
  const int u0 = rank * kUnits;  // first unit of this CTA within the head
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gid = lane / 4;  // fragment row group
  const int tig = lane % 4;  // thread in group
  const int tstride = dh + 8;  // a row of a term buffer, bf16

  constexpr int KA = k_regs(KT);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint4* sA = reinterpret_cast<uint4*>(smem_raw);  // (KT - KA, 2, threads)
  __nv_bfloat16* sB =
      reinterpret_cast<__nv_bfloat16*>(sA + (KT - KA) * 2 * kThreads);
  float* sH = reinterpret_cast<float*>(sB + NT * kN * tstride);  // (2, nb, dh)
  float* sP = sH + 2 * nb * dh;  // (kp, 3 * kMaxRows, kPStride)
  float* sX = sP + kp * kTerms * kMaxRows * kPStride;  // (kRing, nb * kCols)
  uint64_t* bars = reinterpret_cast<uint64_t*>(sX + kRing * nb * kCols);
  const uint32_t bar0 = smem_addr(bars);
  const uint32_t in_bytes = static_cast<uint32_t>(nrows * dh * 4);

  // this warp's A fragments: a[mt][kk] for M tile 2p + mt, K tile
  // kq*KT + kk; element (m, k) is R[head, k, gate*dh + u0 + unit]
  const int pair = warp % 4;
  const int kq = warp / 4;
  uint32_t a[2][KA][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t f[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = (2 * pair + mt) * 16 + gid + 8 * (i & 1);
        const int k = (kq * KT + kk) * 16 + 2 * tig + 8 * (i >> 1);
        const __nv_bfloat16* col =
            r + (static_cast<int64_t>(head) * dh + k) * 4 * dh +
            (m % 4) * dh + u0 + m / 4;
        f[i] = pack(col[0], col[4 * dh]);
      }
      if (kk < KA) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[mt][kk % KA][i] = f[i];
      } else {
        sA[((kk - KA) * 2 + mt) * kThreads + tid] =
            make_uint4(f[0], f[1], f[2], f[3]);
      }
    }
  }
  uint32_t* sBw = reinterpret_cast<uint32_t*>(sB);
  for (int idx = tid; idx < NT * kN * tstride / 2; idx += blockDim.x) {
    sBw[idx] = 0u;  // columns past the batch stay zero
  }
  for (int idx = tid; idx < 2 * nb * dh; idx += blockDim.x) {
    const int rr = idx / dh % nb;
    sH[idx] = idx < nb * dh && rr < nrows
                  ? h0[static_cast<int64_t>(b0 + rr) * d + head * dh +
                       idx % dh]
                  : 0.0f;
  }

  // warp `row` < nrows keeps (c, n) of units u0 .. u0+31 (one a lane)
  const int row = warp;
  const bool active = row < nrows;
  const int b = b0 + row;
  const int unit = head * dh + u0 + lane;  // within d
  const int64_t row4 = 4 * static_cast<int64_t>(d);
  const float* xsrc =
      active ? xg + static_cast<int64_t>(b) * steps * row4 + unit : xg;
  float* xslot = sX + (row * kUnits + lane) * 4;  // + step % kRing * ring
  const int ring = nb * kCols;
  float c = 0.0f, n = 0.0f;
  if (active) {
    c = c0[static_cast<int64_t>(b) * d + unit];
    n = n0[static_cast<int64_t>(b) * d + unit];
    for (int s = 0; s < kRing; ++s) {
      if (s < steps) {
        for (int g = 0; g < 4; ++g) {
          load4(smem_addr(xslot + s * ring + g), xsrc + s * row4 + g * d);
        }
      }
      load_commit();
    }
  }
  if (tid == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (steps > 1) mbar_expect_tx(bar0 + 8, in_bytes);  // h_0, for step 1
  }
  cluster_sync_all();  // every CTA has started, holds R and h_{-1}

  for (int t = 0; t < steps; ++t) {
    const int x = t & 1;
    if (t > 0) mbar_wait(bar0 + 8 * x, ((t - 1) >> 1) & 1);
    if (tid == 0 && t + 2 < steps) mbar_expect_tx(bar0 + 8 * x, in_bytes);
    for (int idx = tid; idx < nrows * dh / 2; idx += blockDim.x) {
      const int rr = idx / (dh / 2);
      const int w = idx % (dh / 2);
      const float2 hv =
          reinterpret_cast<const float2*>(sH + (x * nb + rr) * dh)[w];
      uint32_t tw[3];
      split(hv.x, hv.y, tw);
#pragma unroll
      for (int s = 0; s < kTerms; ++s) {
        sBw[(rr * kTerms + s) * tstride / 2 + w] = tw[s];
      }
    }
    __syncthreads();

    {
      float acc[2][NT][4] = {};
      const uint32_t* tb = sBw + gid * tstride / 2;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        const int w0 = (kq * KT + kk) * 8 + tig;  // 32-bit words
        uint32_t af[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if (kk < KA) {
#pragma unroll
            for (int i = 0; i < 4; ++i) af[mt][i] = a[mt][kk % KA][i];
          } else {
            const uint4 q = sA[((kk - KA) * 2 + mt) * kThreads + tid];
            af[mt][0] = q.x;
            af[mt][1] = q.y;
            af[mt][2] = q.z;
            af[mt][3] = q.w;
          }
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint32_t* ts = tb + nt * kN * tstride / 2;
          const uint32_t b0w = ts[w0];
          const uint32_t b1w = ts[w0 + 4];
          mma(acc[0][nt], af[0], b0w, b1w);
          mma(acc[1][nt], af[1], b0w, b1w);
        }
        // load B two K tiles ahead at most: registers hold A
        if (kk % 2 == 1) asm volatile("" ::: "memory");
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = nt * kN + 2 * tig;  // tile columns n, n + 1
        if (n < kTerms * kMaxRows) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            float* p = sP + (kq * kTerms * kMaxRows + n) * kPStride +
                       (2 * pair + mt) * 16 + gid;
            p[0] = acc[mt][nt][0];
            p[kPStride] = acc[mt][nt][1];
            p[8] = acc[mt][nt][2];
            p[kPStride + 8] = acc[mt][nt][3];
          }
        }
      }
    }
    __syncthreads();

    if (active) {
      asm volatile("cp.async.wait_group %0;" ::"n"(kRing - 1) : "memory");
      // the four gates' sums: K parts in order, each (lo + mid) + hi
      float4 rh = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q < kp) {
          const float* p = sP + (q * kTerms * kMaxRows + row * kTerms) *
                                    kPStride + lane * 4;
          const float4 hi = *reinterpret_cast<const float4*>(p);
          const float4 mid = *reinterpret_cast<const float4*>(p + kPStride);
          const float4 lo =
              *reinterpret_cast<const float4*>(p + 2 * kPStride);
          rh.x = __fadd_rn(rh.x, __fadd_rn(__fadd_rn(lo.x, mid.x), hi.x));
          rh.y = __fadd_rn(rh.y, __fadd_rn(__fadd_rn(lo.y, mid.y), hi.y));
          rh.z = __fadd_rn(rh.z, __fadd_rn(__fadd_rn(lo.z, mid.z), hi.z));
          rh.w = __fadd_rn(rh.w, __fadd_rn(__fadd_rn(lo.w, mid.w), hi.w));
        }
      }
      float* slot = xslot + (t % kRing) * ring;
      const float4 xv = *reinterpret_cast<const float4*>(slot);
      const float g[4] = {__fadd_rn(xv.x, rh.x), __fadd_rn(xv.y, rh.y),
                          __fadd_rn(xv.z, rh.z), __fadd_rn(xv.w, rh.w)};
      if (t + kRing < steps) {
        for (int k = 0; k < 4; ++k) {
          load4(smem_addr(slot + k), xsrc + (t + kRing) * row4 + k * d);
        }
      }
      load_commit();
      const float h = cell(g, c, n);
      hs[(static_cast<int64_t>(b) * steps + t) * d + unit] = h;
      if (t == steps - 1) {
        const int64_t at = static_cast<int64_t>(b) * d + unit;
        c1[at] = c;
        n1[at] = n;
        h1[at] = h;
      }
      // h_t of this row's 32 units into the next h buffer of every CTA:
      // lane l sends units 4(l % 8) .. +3 to CTAs l / 8 + 4j
      const int chunk = lane % 8;
      float4 v;
      v.x = __shfl_sync(0xffffffffu, h, 4 * chunk + 0);
      v.y = __shfl_sync(0xffffffffu, h, 4 * chunk + 1);
      v.z = __shfl_sync(0xffffffffu, h, 4 * chunk + 2);
      v.w = __shfl_sync(0xffffffffu, h, 4 * chunk + 3);
      if (t + 1 < steps) {
        const int nx = (t + 1) & 1;
        const uint32_t dst =
            smem_addr(sH + (nx * nb + row) * dh + u0 + 4 * chunk);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int q = lane / 8 + 4 * j;
          if (q < csize) {
            store_to_peer(in_peer(dst, q), v, in_peer(bar0 + 8 * nx, q));
          }
        }
      }
    }
    // the next step's partial sums overwrite sP only after its barrier,
    // which waits for h_t of every row warp of this CTA
  }
}

using Kernel = void (*)(const float*, const __nv_bfloat16*, const float*,
                        const float*, const float*, float*, float*, float*,
                        float*, int, int, int, int, int, int);

inline int k_tiles(int dh) { return dh / (16 * kParts); }

template <int NT>
Kernel pick_k(int kt) {
  switch (kt) {
    case 1: return slstm_cluster_kernel<1, NT>;
    case 2: return slstm_cluster_kernel<2, NT>;
    case 4: return slstm_cluster_kernel<4, NT>;
    case 8: return slstm_cluster_kernel<8, NT>;
    default: return slstm_cluster_kernel<16, NT>;
  }
}

inline Kernel pick(int kt, int rows) {
  return n_tiles(rows) == 1 ? pick_k<1>(kt) : pick_k<2>(kt);
}

// Whether this file takes the plan for this dh: dh in {32, 64, ..., 512},
// 32 units a CTA, kParts K parts, at most 4 rows.
bool valid(int dh, const Plan& p) {
  if (p.route != 1 || p.units != kUnits || p.cluster * kUnits != dh ||
      (dh != 32 && dh != 64 && dh != 128 && dh != 256 && dh != 512) ||
      p.kslices != kParts || p.rows < 1 ||
      p.rows > kMaxRows) {
    return false;
  }
  const int nb = p.rows >= 3 ? 4 : p.rows;
  const int64_t smem = smem_bytes(dh, nb, p.kslices);
  return smem == p.smem && smem <= kMaxSmem;
}

cudaError_t configure(int dh, const Plan& p, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr, Kernel* kern) {
  *kern = pick(k_tiles(dh), p.rows);
  const void* f = reinterpret_cast<const void*>(*kern);
  cudaError_t err = cudaFuncSetAttribute(
      f, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             p.smem);
  if (err != cudaSuccess) return err;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = p.smem;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

int launch(const void* xg, const void* r, const void* c0, const void* n0,
           const void* h0, void* hs, void* c1, void* n1, void* h1, int batch,
           int steps, int d, int heads, const Plan& p, cudaStream_t st) {
  const int dh = d / heads;
  if (!valid(dh, p)) return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (batch + p.rows - 1) / p.rows;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  Kernel kern;
  cudaError_t err = configure(dh, p, &cfg, attr, &kern);
  if (err != cudaSuccess) return static_cast<int>(err);
  cfg.gridDim = dim3(p.cluster * heads * groups);
  cfg.stream = st;
  err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const float*>(xg),
      static_cast<const __nv_bfloat16*>(r), static_cast<const float*>(c0),
      static_cast<const float*>(n0), static_cast<const float*>(h0),
      static_cast<float*>(hs), static_cast<float*>(c1),
      static_cast<float*>(n1), static_cast<float*>(h1), batch, steps, d, dh,
      p.rows, groups);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

int max_clusters(int dh, const Plan& p, int* out) {
  if (!valid(dh, p)) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  Kernel kern;
  cudaError_t err = configure(dh, p, &cfg, attr, &kern);
  if (err != cudaSuccess) return static_cast<int>(err);
  cfg.gridDim = dim3(p.cluster);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      out, reinterpret_cast<const void*>(kern), &cfg));
}

}  // namespace clu

// xg (batch, steps, 4d) float32; r (heads, d/heads, 4d/heads) float32 or
// bfloat16 (r_bf16); c0, n0, h0, c1, n1, h1 (batch, d) float32; hs (batch,
// steps, d) float32. The plan (route, cluster, units, rows, kslices, smem)
// is kernels/slstm_scan.py `plan`'s; one this file does not take is
// refused with cudaErrorInvalidValue.
extern "C" int slstm_scan_launch(const void* xg, const void* r,
                                 const void* c0, const void* n0,
                                 const void* h0, void* hs, void* c1, void* n1,
                                 void* h1, int batch, int steps, int d,
                                 int heads, int r_bf16, int route,
                                 int cluster, int units, int rows,
                                 int kslices, int smem, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const Plan p{route, cluster, units, rows, kslices, smem};
  if (heads <= 0 || d % heads != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (route == 1) {
    if (!r_bf16) return static_cast<int>(cudaErrorInvalidValue);
    return clu::launch(xg, r, c0, n0, h0, hs, c1, n1, h1, batch, steps, d,
                       heads, p, st);
  }
  if (route != 0) return static_cast<int>(cudaErrorInvalidValue);
  return r_bf16 ? coop::launch<__nv_bfloat16>(xg, r, c0, n0, h0, hs, c1, n1,
                                              h1, batch, steps, d, heads, p,
                                              st)
                : coop::launch<float>(xg, r, c0, n0, h0, hs, c1, n1, h1,
                                      batch, steps, d, heads, p, st);
}

// How many clusters of a cluster-route plan the card holds at once
// (cudaOccupancyMaxActiveClusters), into *out.
extern "C" int slstm_scan_max_clusters(int d, int heads, int r_bf16,
                                       int route, int cluster, int units,
                                       int rows, int kslices, int smem,
                                       int* out) {
  const Plan p{route, cluster, units, rows, kslices, smem};
  if (heads <= 0 || d % heads != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!r_bf16) return static_cast<int>(cudaErrorInvalidValue);
  return clu::max_clusters(d / heads, p, out);
}
