// Fused wire encode (B4), decode/apply (B5) and hit count (B6) for Hopper
// (sm_90a).
//
// B4 replaces the Pallas TPU kernel `wire_pack` in
// src/repro/kernels/wire_pack.py (`_pack_kernel` plus its cumsum-scatter
// compaction epilogue). B5 replaces `wire_unpack_add` (`_unpack_kernel` and
// `_add_kernel`) and its decode-only form `wire_unpack`. B6 replaces
// `wire_nnz` (`_nnz_kernel`): the nonzero count of a flat tensor.
//
// Bound: bytes. Every kernel streams its inputs once with a few integer
// operations per element. The TPU bit-packs the mask on the MXU with a
// (128, 128) weight matrix and compacts with a full-length cumsum and
// scatter; here B4 is one single-pass stream compaction and B5 its inverse,
// each one launch, on a decoupled look-back prefix (Merrill and Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", 2016). No
// CUB or thrust primitive is used.
//
// B4 and B5 layout. A block takes one tile of kTile elements, kItems a
// thread. A warp owns kWarpSpan consecutive elements as kRuns runs of kRun;
// in each run lane l holds the kGroup consecutive elements from kGroup * l,
// read and written as one vector access (16 bytes for 4-byte types), so
// every access of a warp is contiguous. A lane's kGroup flags are a nibble
// of one mask byte: B5 reads it, B4 ORs the nibbles of 8 lanes into one
// 32-bit mask word with three shuffles. The tile's set bits are scanned
// with warp shuffles and one shared-memory pass over the warps, and thread
// 0 publishes the tile's count at once; warp 0 then finds the tile's
// offset by look-back, and each element's place in the compacted values is
// offset + in-tile prefix. x (B4), or the target and the mask (B5), are
// read once. B4 writes the mask, the quantized values and the residual
// before it publishes and keeps the quantized values in registers for the
// scatter; B5 loads the target only after it publishes (a release store
// waits for the thread's earlier loads), while warp 0 looks back.
//
// The hazards of a single pass, and what answers each:
// (a) Forward progress. A block's tile is a ticket from an atomic counter,
//     not blockIdx.x. Blocks may start in any order, but only a running
//     block draws a ticket, so every tile that a tile waits on is resident
//     and finishes.
// (b) No reset launch. The counter and the tiles' status words live in a
//     buffer the wrapper keeps per (device, stream), zeroed once when it is
//     made or grows. Each call brings a new sequence number from the host
//     (1, 2, ...): a word counts only when its upper 32 bits are this
//     call's number, so the words of earlier calls never need clearing.
//     The block that draws the last ticket sets the counter back to 0;
//     every ticket is drawn by then, and the next call on the stream
//     starts after this one ends. Calls on one stream are ordered, so B4
//     and B5 share the buffer. The host zeroes a fresh buffer before the
//     number would wrap. (The other way, the last tile restoring the words,
//     needs a second counter of finished tiles and a serial pass over all
//     the words at the end of every call.)
// (c) Memory ordering. A word is published with st.release.gpu and read
//     with ld.acquire.gpu, both at GPU scope. The count and the flag travel
//     in that one 64-bit word, so a reader needs nothing else the writer
//     wrote; each release costs a GPU-scope fence, twice a tile on the
//     look-back chain.
// (d) Sizes. A word is (sequence << 32) | (inclusive flag << 31) | count;
//     31 bits hold any count or prefix of n < 2^31 elements, and the entry
//     points refuse a larger n.
//
// Bit-exactness: quantization is `__float2half_rn` / `__float2bfloat16_rn`
// (round to nearest even, as numpy and ml_dtypes do), the residual is one
// correctly rounded subtraction, and the decode add is `__fadd_rn` with an
// unconditional `+ 0.0f` off the support, so `-0.0` in the target turns into
// `+0.0` exactly as numpy's `target + decoded` does. The decode-only form
// writes each value itself (widened or narrowed once, round to nearest even,
// as numpy's `astype`; unchanged where the types agree), so a `-0.0` on the
// support survives; it also takes float16 and bfloat16 targets, which the
// add does not (as in the JAX package, only exact accumulates are fused).
// With fewer values than set mask bits, a gather position past the last
// value reads the last value, and no values read as zeros: JAX clamps the
// gather to the values' capacity the same way.
//
// Type codes shared with the Python wrapper: 0 float32, 1 float16,
// 2 bfloat16, 3 int32. Each entry point returns cudaGetLastError() after
// its launch (0 when it launched), or -1 for a type pair or a length it
// does not take.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;  // threads a block (B4, B5, B6)
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// B4 and B5 tiles
constexpr int kItems = 16;                // elements a thread
constexpr int kTile = kThreads * kItems;  // elements a block
constexpr int kGroup = 4;                 // elements of one vector access
constexpr int kRuns = kItems / kGroup;    // runs of a warp
constexpr int kRun = 32 * kGroup;         // elements a run
constexpr int kWarpSpan = kRuns * kRun;   // elements a warp
constexpr int64_t kMaxElements = 2147483647;  // n < 2^31
// the look-back buffer, 64-bit words: word 0 the ticket counter, word
// kStatusBase + t tile t's status
constexpr int kStatusBase = 1;
constexpr int kSeqShift = 32;
constexpr uint64_t kInclusive = 1ull << 31;  // the word holds a prefix
constexpr uint64_t kCountMask = kInclusive - 1;

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

// encode: x to the wire type; decode: a wire value to the target's type
template <typename To, typename From>
struct Convert {
  __device__ static To apply(From v) { return fromf<To>(tof(v)); }
};
template <typename T>
struct Convert<T, T> {
  __device__ static T apply(T v) { return v; }
};

__device__ __forceinline__ float add_rn(float t, float v) {
  return __fadd_rn(t, v);
}
__device__ __forceinline__ int32_t add_rn(int32_t t, int32_t v) {
  return (int32_t)((uint32_t)t + (uint32_t)v);  // wraps like numpy int32
}

// ---- vector access to one lane's kGroup elements -------------------------

template <int Bytes>
struct VecOf;
template <>
struct VecOf<16> {
  using type = uint4;
};
template <>
struct VecOf<8> {
  using type = uint2;
};

// p[g : g + kGroup], zeros past n; one vector load where vec is set (the
// base is 16-byte aligned) and the group is whole
template <typename T>
__device__ __forceinline__ void load_group(const T* __restrict__ p, int64_t g,
                                           int64_t n, bool vec,
                                           T (&r)[kGroup]) {
  using V = typename VecOf<static_cast<int>(kGroup * sizeof(T))>::type;
  if (vec && g + kGroup <= n) {
    const V w = *reinterpret_cast<const V*>(p + g);
    memcpy(r, &w, sizeof(V));
  } else {
#pragma unroll
    for (int e = 0; e < kGroup; ++e) r[e] = g + e < n ? p[g + e] : T{};
  }
}

template <typename T>
__device__ __forceinline__ void store_group(T* __restrict__ p, int64_t g,
                                            int64_t n, bool vec,
                                            const T (&r)[kGroup]) {
  using V = typename VecOf<static_cast<int>(kGroup * sizeof(T))>::type;
  if (vec && g + kGroup <= n) {
    V w;
    memcpy(&w, r, sizeof(V));
    *reinterpret_cast<V*>(p + g) = w;
  } else {
#pragma unroll
    for (int e = 0; e < kGroup; ++e) {
      if (g + e < n) p[g + e] = r[e];
    }
  }
}

// ---- the single-pass prefix -----------------------------------------------

__device__ __forceinline__ void st_release(uint64_t* p, uint64_t v) {
  asm volatile("st.release.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}
__device__ __forceinline__ uint64_t ld_acquire(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.acquire.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

struct TileShared {
  uint32_t warp_total[kWarps];
  uint32_t tile;
  uint32_t offset;
};

// The block's tile, in the order blocks reach this point (hazard a).
__device__ __forceinline__ uint32_t take_ticket(unsigned long long* counter,
                                                uint32_t ntiles,
                                                TileShared& sh) {
  if (threadIdx.x == 0) {
    const unsigned long long t = atomicAdd(counter, 1ull);
    if (t == ntiles - 1) atomicExch(counter, 0ull);  // every ticket drawn
    sh.tile = static_cast<uint32_t>(t);
  }
  __syncthreads();
  return sh.tile;
}

// Counts this lane's flags: nib[r] holds them for run r (bit e: element
// kGroup * lane + e of the run). Sets pos[r] to the in-tile position of
// the run's first flagged element of this lane and publishes the tile's
// count (tile 0: its inclusive prefix) from thread 0. Returns the count.
__device__ __forceinline__ uint32_t publish_count(
    const unsigned (&nib)[kRuns], uint32_t (&pos)[kRuns], TileShared& sh,
    uint64_t* status, uint32_t tile, uint32_t seq) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t warp_sum = 0;  // flags of this warp's earlier runs
#pragma unroll
  for (int r = 0; r < kRuns; ++r) {
    const uint32_t c = __popc(nib[r]);
    uint32_t incl = c;  // inclusive scan over the lanes
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    pos[r] = warp_sum + incl - c;
    warp_sum += __shfl_sync(kFull, incl, 31);
  }
  if (lane == 0) sh.warp_total[warp] = warp_sum;
  __syncthreads();
  uint32_t before = 0, agg = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t c = sh.warp_total[w];
    before += w < warp ? c : 0u;
    agg += c;
  }
#pragma unroll
  for (int r = 0; r < kRuns; ++r) pos[r] += before;
  if (threadIdx.x == 0) {
    const uint64_t tag = static_cast<uint64_t>(seq) << kSeqShift;
    st_release(status + tile, tag | (tile == 0 ? kInclusive : 0ull) | agg);
  }
  return agg;
}

// Warp 0 of tile `tile` (> 0), after publish_count: reads the
// predecessors' words 32 at a time (lane k reads tile - 1 - k) until one
// holds an inclusive prefix, then publishes the tile's own; every thread
// of the block gets the tile's exclusive prefix.
__device__ __forceinline__ uint32_t look_back(uint64_t* status, uint32_t tile,
                                              uint32_t agg, uint32_t seq,
                                              TileShared& sh) {
  if (tile == 0) return 0;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const uint64_t tag = static_cast<uint64_t>(seq) << kSeqShift;
    uint32_t excl = 0;
    for (int64_t last = static_cast<int64_t>(tile) - 1;; last -= 32) {
      const int64_t j = last - lane;
      uint64_t w;
      do {  // before tile 0 reads as an inclusive prefix of 0
        w = j >= 0 ? ld_acquire(status + j) : (tag | kInclusive);
      } while (!__all_sync(kFull, (w >> kSeqShift) == seq));
      const unsigned incl = __ballot_sync(kFull, (w & kInclusive) != 0);
      // sum the counts up to and including the nearest inclusive prefix
      const int stop = incl ? __ffs(incl) - 1 : 31;
      uint32_t c = lane <= stop ? static_cast<uint32_t>(w & kCountMask) : 0u;
#pragma unroll
      for (int d = 16; d; d >>= 1) c += __shfl_xor_sync(kFull, c, d);
      excl += c;
      if (incl) break;
    }
    if (lane == 0) {
      st_release(status + tile, tag | kInclusive | (excl + agg));
      sh.offset = excl;
    }
  }
  __syncthreads();
  return sh.offset;
}

// ---- B4: encode ------------------------------------------------------------

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
    pack_kernel(const Tin* __restrict__ x, int64_t n, int vec,
                uint8_t* __restrict__ mask_bytes, Tout* __restrict__ qdense,
                float* __restrict__ residual, Tout* __restrict__ cvals,
                int32_t* __restrict__ cidx, int32_t* __restrict__ nnz,
                unsigned long long* __restrict__ words, uint32_t ntiles,
                uint32_t seq) {
  __shared__ TileShared sh;
  uint64_t* status = reinterpret_cast<uint64_t*>(words) + kStatusBase;
  const uint32_t tile = take_ticket(words, ntiles, sh);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t first = static_cast<int64_t>(tile) * kTile +
                        warp * kWarpSpan + kGroup * lane;
  const int64_t mb = (n + 7) >> 3;
  const bool mask_vec = (reinterpret_cast<uintptr_t>(mask_bytes) & 3u) == 0;
  unsigned nib[kRuns];
  Tout q[kRuns][kGroup];  // kept for the scatter
#pragma unroll
  for (int r = 0; r < kRuns; ++r) {
    const int64_t g = first + r * kRun;
    Tin v[kGroup];
    load_group(x, g, n, vec, v);
    float res[kGroup];
    unsigned m = 0;
#pragma unroll
    for (int e = 0; e < kGroup; ++e) {
      q[r][e] = Convert<Tout, Tin>::apply(v[e]);
      res[e] = __fsub_rn(tof(v[e]), tof(q[r][e]));
      m |= (g + e < n && nonzero(v[e]) ? 1u : 0u) << e;
    }
    nib[r] = m;
    store_group(qdense, g, n, vec, q[r]);
    store_group(residual, g, n, vec, res);
    // the 8 lanes of one 32-element mask word OR their nibbles together
    unsigned word = m << (kGroup * (lane & 7));
    word |= __shfl_xor_sync(kFull, word, 1);
    word |= __shfl_xor_sync(kFull, word, 2);
    word |= __shfl_xor_sync(kFull, word, 4);
    const int64_t b = g >> 3;  // a multiple of 4 in lanes 0, 8, 16, 24
    if ((lane & 7) == 0 && b < mb) {
      if (mask_vec && b + 4 <= mb) {
        *reinterpret_cast<uint32_t*>(mask_bytes + b) = word;
      } else {
        for (int k = 0; k < 4 && b + k < mb; ++k) {
          mask_bytes[b + k] = static_cast<uint8_t>(word >> (8 * k));
        }
      }
    }
  }
  uint32_t pos[kRuns];
  const uint32_t agg = publish_count(nib, pos, sh, status, tile, seq);
  const uint32_t off = look_back(status, tile, agg, seq, sh);
  if (tile == ntiles - 1 && threadIdx.x == 0) {
    *nnz = static_cast<int32_t>(off + agg);
  }
#pragma unroll
  for (int r = 0; r < kRuns; ++r) {
    const int64_t g = first + r * kRun;
    uint32_t p = off + pos[r];
#pragma unroll
    for (int e = 0; e < kGroup; ++e) {
      if ((nib[r] >> e) & 1u) {
        cvals[p] = q[r][e];
        cidx[p] = static_cast<int32_t>(g + e);
        ++p;
      }
    }
  }
}

// ---- B5: decode, and add (or write) ---------------------------------------

// this lane's kGroup mask bits from element g (a multiple of kGroup), none
// at or past n (the last byte's tail bits are not read as flags)
__device__ __forceinline__ unsigned group_bits(const uint8_t* __restrict__ mask,
                                               int64_t g, int64_t n) {
  if (g >= n) return 0u;
  const unsigned nib = (mask[g >> 3] >> (g & 4)) & 0xfu;
  return n - g >= kGroup ? nib : nib & ((1u << (n - g)) - 1u);
}

template <typename Tt, typename Tv>
__device__ __forceinline__ Tt gather(const Tv* __restrict__ cvals,
                                     uint32_t pos, int64_t nvals) {
  if (nvals <= 0) return Tt{};  // no values: one zero slot
  const int64_t i = pos < nvals ? pos : nvals - 1;  // clamped, as JAX does
  return Convert<Tt, Tv>::apply(cvals[i]);
}

template <typename Tt, typename Tv>
__global__ void __launch_bounds__(kThreads)
    unpack_kernel(const Tt* __restrict__ target,
                  const uint8_t* __restrict__ mask, int64_t n,
                  const Tv* __restrict__ cvals, int64_t nvals,
                  Tt* __restrict__ out, int accumulate, int vec,
                  unsigned long long* __restrict__ words, uint32_t ntiles,
                  uint32_t seq) {
  constexpr bool kAdds =
      std::is_same<Tt, float>::value || std::is_same<Tt, int32_t>::value;
  __shared__ TileShared sh;
  uint64_t* status = reinterpret_cast<uint64_t*>(words) + kStatusBase;
  const uint32_t tile = take_ticket(words, ntiles, sh);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t first = static_cast<int64_t>(tile) * kTile +
                        warp * kWarpSpan + kGroup * lane;
  unsigned nib[kRuns];
#pragma unroll
  for (int r = 0; r < kRuns; ++r) {
    nib[r] = group_bits(mask, first + r * kRun, n);
  }
  uint32_t pos[kRuns];
  const uint32_t agg = publish_count(nib, pos, sh, status, tile, seq);
  Tt t[kRuns][kGroup];  // the target, loaded while the look-back waits
  if (kAdds && accumulate) {
#pragma unroll
    for (int r = 0; r < kRuns; ++r) {
      load_group(target, first + r * kRun, n, vec, t[r]);
    }
  }
  const uint32_t off = look_back(status, tile, agg, seq, sh);
#pragma unroll
  for (int r = 0; r < kRuns; ++r) {
    const int64_t g = first + r * kRun;
    uint32_t p = off + pos[r];
    Tt o[kGroup];
#pragma unroll
    for (int e = 0; e < kGroup; ++e) {
      const Tt v = (nib[r] >> e) & 1u ? gather<Tt, Tv>(cvals, p++, nvals)
                                      : Tt{};
      if constexpr (kAdds) {
        o[e] = accumulate ? add_rn(t[r][e], v) : v;
      } else {
        o[e] = v;  // float16 / bfloat16: decode only
      }
    }
    store_group(out, g, n, vec, o);
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

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

uint32_t tiles_of(int64_t n) {
  return static_cast<uint32_t>((n + kTile - 1) / kTile);
}

template <typename Tin, typename Tout>
int pack_all(const void* x, int64_t n, void* mask_bytes, void* qdense,
             void* cvals, void* cidx, void* residual, void* nnz, void* words,
             uint32_t seq, cudaStream_t s) {
  const int vec = aligned16(x) && aligned16(qdense) && aligned16(residual);
  const uint32_t nt = tiles_of(n);
  pack_kernel<Tin, Tout><<<nt, kThreads, 0, s>>>(
      static_cast<const Tin*>(x), n, vec, static_cast<uint8_t*>(mask_bytes),
      static_cast<Tout*>(qdense), static_cast<float*>(residual),
      static_cast<Tout*>(cvals), static_cast<int32_t*>(cidx),
      static_cast<int32_t*>(nnz), static_cast<unsigned long long*>(words), nt,
      seq);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tt, typename Tv>
int unpack_all(const void* target, const void* mask, int64_t n,
               const void* cvals, int64_t nvals, void* out, int accumulate,
               void* words, uint32_t seq, cudaStream_t s) {
  const int vec = aligned16(out) && (!accumulate || aligned16(target));
  const uint32_t nt = tiles_of(n);
  unpack_kernel<Tt, Tv><<<nt, kThreads, 0, s>>>(
      static_cast<const Tt*>(target), static_cast<const uint8_t*>(mask), n,
      static_cast<const Tv*>(cvals), nvals, static_cast<Tt*>(out), accumulate,
      vec, static_cast<unsigned long long*>(words), nt, seq);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B4: one launch. `words` is the look-back buffer (at least
// kStatusBase + ceil(n / kTile) zeroed-once 64-bit words) and `seq` this
// call's sequence number, never used before on that buffer.
extern "C" int wire_pack_launch(const void* x, int in_code, int out_code,
                                int64_t n, void* mask_bytes, void* qdense,
                                void* cvals, void* cidx, void* residual,
                                void* nnz, void* words, unsigned seq,
                                void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (n < 1 || n > kMaxElements || seq == 0) return -1;
#define PACK(TI, TO)                                                     \
  return pack_all<TI, TO>(x, n, mask_bytes, qdense, cvals, cidx, residual, \
                          nnz, words, seq, s)
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

// B5: one launch; `nvals` values at `cvals` (gathers clamp to the last, and
// none read as zeros); `words` and `seq` as for B4.
extern "C" int wire_unpack_add_launch(const void* target, int target_code,
                                      const void* mask, int64_t n,
                                      const void* cvals, int64_t nvals,
                                      int val_code, void* out, int accumulate,
                                      void* words, unsigned seq,
                                      void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (n < 1 || n > kMaxElements || seq == 0) return -1;
  if (accumulate && (target_code == 1 || target_code == 2)) return -1;
#define UNPACK(TT, TV)                                                      \
  return unpack_all<TT, TV>(target, mask, n, cvals, nvals, out, accumulate, \
                            words, seq, s)
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
