// The fused when2com communication step for Hopper (sm_90a).
//
// Replaces the TPU kernel multiagentperception_tpu/ops/pallas/comm_fusion.py
// (fused_comm_step -> _comm_kernel). Per batch element b:
//     logits = K Q'^T                          (N x N, keys x queries)
//     soft   = softmax over keys + diag_bias I (the pre-mask graph)
//     coef   = mode mask of soft: softmax | activated (soft > thres, else 0)
//              | argmax (one-hot, lowest key index on ties)
//     fused  = coef^T V                        (N x M, M = C*h*w)
//
// Bound on the H100: bytes. V is read once and fused written once
// (2 x 2 x 6 x 131,072 x 4 B = 12.6 MB at the flagship, ~3.8 us at
// 3.35 TB/s; half that in bf16); the graph is ~37k FMAs per batch element
// and the fusion 2*N FLOPs per value of V.
//
// Design: grid (tiles of M, B) in clusters of kCluster CTAs along M (a
// cluster belongs to one batch element), no more clusters than the card
// holds at once, so the flagship runs in one wave. What matters then is
// that V's bytes are in flight from the start and that the graph is a short
// chain that hides under them:
// 1. Each thread loads its part of this CTA's slice of Q' and K (rank r of
//    the cluster takes the r-th 1/kCluster of D: 6 KB at the flagship) into
//    shared memory, and only then issues its loads of V: kCols columns
//    (16-byte packs: 4 floats or 8 bf16) of every agent's row, in
//    registers (kCols = 2 for N <= 8, 1 above). Issued first, the whole
//    card's V requests queue in L2 ahead of the slices', and the graph
//    waited ~3.5 us for its 6 KB.
// 2. The CTA's partial logits over its slice are
//    summed in registers per 8 x 8 group of (key, query) pairs, then by
//    warp shuffles (warp_sum_scatter) and over the warps in order. Each CTA
//    stores its partial into every CTA of the cluster (st.async into
//    distributed shared memory, counted by the receiver's mbarrier), and
//    every CTA adds the kCluster partials in rank order, so all CTAs agree.
//    The cluster barrier that makes the mbarriers ready is arrived at before
//    any load is issued: a release there would wait for V. One thread per (key,
//    query) pair then forms the softmax over keys, the diagonal bias, the
//    argmax and the mode mask by shuffles among its query's lanes.
// 3. Each thread combines its N packs of a column with coef and writes N
//    fused packs; columns beyond the grid's are streamed after. Loads and
//    stores of V stream (evict-first).
// Measured on an H100 (globaltimer probes inside the kernel): a design in
// which every block built the whole graph, one warp per pair and the
// softmax on N threads, left the V stream waiting ~7 us behind chains of
// dependent round trips; a block-wide graph of register sums still spent
// ~4 us reading all of Q' and K in every block.
// Block (0, b) also writes coef and soft. The cluster design takes
// N <= kMaxAgents (16).
//
// The wide design, N > kMaxAgents (a MIMOcom of 24 or 48 agents; any N):
// two kernels, no workspace, and no query of the card on a call (its SM
// count and shared-memory opt-in are read once per device, as the cluster
// design's occupancy is). Bound on the H100: bytes, as
// the cluster design's (V read once and fused written once: 12.6 MB at the
// sweep's B.N = 96 in bf16, 3.75 us; 50.3 MB in float32 at (2, 24, 512,
// 16, 16), 15.0 us). What the choices below answer: a graph that a few
// CTAs form over all of D in dependent chains of scalar loads is a chain of
// trips to memory, and a fusion launch that waits for it leaves V's reads
// idle meanwhile.
// 1. comm_fusion_wide_graph, grid (kCluster, tiles of kWideQ = 8 queries,
//    B) in clusters of kCluster CTAs along D (96 CTAs at (2, 48)); rank r
//    owns query q0 + r. Each CTA issues cp.async loads of its slice of D
//    (wide_pitch: 128 values at D = 1024) of the tile's Q' rows and of up
//    to kWideKeys K rows (16 bytes each, zero past the slice), then forms
//    the slice's logits on the float64 tensor cores (mma m8n8k4: warp w
//    takes keys 8w .. 8w + 7; a float32 product is exact in float64, so
//    the logits are float64 sums of exact products, in a fixed order).
//    Each lane stores its two partials into their owners' shared memory
//    (st.async, counted by the owner's mbarrier); each owner sums the
//    kCluster partials of its query in rank order and keeps the logits (in
//    shared memory up to kWideColKeys keys; beyond, as a float32 pair in
//    soft (hi) and coef (lo), read back by the lane that wrote them). Keys
//    come in chunks of kWideKeys; a cluster barrier parts two chunks. One
//    warp of the owner then forms the softmax over keys in float64 (max,
//    sum of exp), adds diag_bias on the diagonal, rounds soft to float32
//    once and masks it: activated keeps soft > thres, argmax the first key
//    of the largest soft. The graph is that of the float32 values of Q' and
//    K in every type (within 1e-6 of the graph in float64 at any N). The
//    kernel lets the fusion kernel launch as it starts
//    (griddepcontrol.launch_dependents).
// 2. comm_fusion_wide_fuse, launched as a programmatic dependent of the
//    graph kernel: a CTA takes `per` tiles of kFuseCols = 128 columns of one
//    batch element, for every query (enough tiles that the grid is about
//    two CTAs an SM). It issues cp.async loads of V's rows of its first
//    tiles for every key into a ring of up to kFuseStages stages
//    (FuseSmem::rows; beyond kFuseResident bytes one chunk of kFuseKeys
//    keys, streamed again for each query tile) before it waits for the
//    graph kernel (griddepcontrol.wait), so V's reads overlap the graph, and
//    V is read from memory once. Where N fits one coef tile (kFuseKeys keys,
//    FuseSmem::kQ queries) coef is staged once for all the CTA's tiles, its
//    loads all in flight at once; a tile's stage takes a later tile's loads
//    as soon as it is read. Sums are float32, in a fixed order:
//    - 16-bit V on the tensor cores (mma.sync m16n8k16, ldmatrix; warp w
//      takes 16 columns and all 64 queries of a tile): coef is split into
//      three bf16 terms (coef = t0 + t1 + t2 exactly), each product with a
//      bf16 value exact in float32, so the sum is float32's: 906 M
//      operations at (2, 48, 512, 8, 8), ~0.9 us at 989 TF/s, under the
//      3.75 us of bytes, where CUDA-core FMAs alone take ~4.5 us. float16
//      V cannot share a bf16 product, and coef split into float16 terms
//      loses its low bits to float16's exponent range: V is split into two
//      bf16 terms instead (hi holds 8 of its 11 significant bits, lo the
//      rest, exactly), 6 products a value. The tile's output goes through
//      shared memory and out in 16-byte packs, each row contiguous.
//    - float32 V on the CUDA cores (thread: 4 queries x 4 columns, 16 FMAs
//      a key): 151 M FMAs at (2, 24, 512, 16, 16), ~4.5 us against 15 us
//      of bytes.
//    fused is rounded to V's type once, at the store. mma.sync rather than
//    wgmma: a wgmma route (coef's terms and V K-major in shared memory, one
//    warpgroup a tile) took the same time within noise on an H100 (PERF.md
//    section 6), with a transpose and descriptors more. What holds this
//    kernel above its bound at (2, 48) on an H100 (globaltimer probes):
//    coef's staging (~1.6-2.1 us, every CTA of a batch element reading the
//    same 9 KB from L2), then per tile the products (~1.4 us) and the store
//    (~0.5 us), one tile after another in a CTA.
// Types: comm_fusion_f32 takes float32 Q', K and V; comm_fusion_bf16 and
// comm_fusion_f16 take bfloat16 or float16 ones (the mixed-precision
// MIMOcom's), as the TPU kernel does (comm_fusion.py:42-43, 63-67): Q' and
// K are converted to float32 (the wide design: float64) as they are read, so
// the graph is the float32 route's; V moves in 16-byte loads of 8 values,
// the fusion accumulates in float32, and fused is rounded to V's type once,
// at the store. coef and soft are
// float32 in all three. bf16's conversions to float32 are shifts of its
// bits (bf16_lo / bf16_hi); float16's are the hardware's (__half22float2),
// its rounding __floats2half2_rn.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kMaxAgents = 16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;  // CTAs that share one batch element's graph
constexpr int kGroup = 8;    // keys x queries of one group of logits in registers
constexpr int kPre = 2;      // float4s of the slice a thread loads at once (the flagship's all)

enum Mode { kSoftmax = 0, kActivated = 1, kArgmax = 2 };

// The two halves of a word of two bf16 values, as float32 (exact).
__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// V's 16-byte pack of T values, converted to and from float32.
template <typename T>
struct Pack;
template <>
struct Pack<float> {
  static constexpr int kElems = 4;
  __device__ static __forceinline__ void unpack(const uint4& p, float (&v)[4]) {
    v[0] = __uint_as_float(p.x);
    v[1] = __uint_as_float(p.y);
    v[2] = __uint_as_float(p.z);
    v[3] = __uint_as_float(p.w);
  }
  __device__ static __forceinline__ uint4 pack(const float (&v)[4]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
};
template <>
struct Pack<__nv_bfloat16> {
  static constexpr int kElems = 8;
  __device__ static __forceinline__ void unpack(const uint4& p, float (&v)[8]) {
    const uint32_t w[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = bf16_lo(w[i]);
      v[2 * i + 1] = bf16_hi(w[i]);
    }
  }
  __device__ static __forceinline__ uint4 pack(const float (&v)[8]) {  // round to nearest even
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};
// A word of two float16 values as float32 (exact).
__device__ __forceinline__ float2 f16x2(uint32_t u) {
  return __half22float2(*reinterpret_cast<const __half2*>(&u));
}
template <>
struct Pack<__half> {
  static constexpr int kElems = 8;
  __device__ static __forceinline__ void unpack(const uint4& p, float (&v)[8]) {
    const uint32_t w[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = f16x2(w[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static __forceinline__ uint4 pack(const float (&v)[8]) {  // round to nearest even
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __half2 h = __floats2half2_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

// The cluster barrier's halves. A release waits for this thread's loads in
// flight, so the kernel arrives before it issues any.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
// The shared-memory address `addr` of this CTA at the cluster's CTA `rank`
__device__ __forceinline__ uint32_t at_rank(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(addr), "r"(rank));
  return remote;
}
// v into another CTA's shared memory, counted by its mbarrier `bar`
__device__ __forceinline__ void store_remote(uint32_t addr, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];" ::"r"(
                   addr),
               "r"(__float_as_uint(v)), "r"(bar)
               : "memory");
}

// Loads issued where they stand (volatile: the compiler may not sink them
// below the graph's barriers).
__device__ __forceinline__ uint4 load_stream(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.cs.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}
__device__ __forceinline__ float4 load_now(const float4* p) {
  float4 v;
  asm volatile("ld.global.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

// 4 values of Q' or K at p (4-value aligned) as float32; `now`: a load
// issued where it stands.
__device__ __forceinline__ float4 load_qk4(const float* p, bool now) {
  return now ? load_now(reinterpret_cast<const float4*>(p)) : *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load_qk4(const __nv_bfloat16* p, bool now) {
  uint2 u;
  if (now)
    asm volatile("ld.global.v2.u32 {%0, %1}, [%2];" : "=r"(u.x), "=r"(u.y) : "l"(p));
  else
    u = *reinterpret_cast<const uint2*>(p);
  return make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y), bf16_hi(u.y));
}
__device__ __forceinline__ float4 load_qk4(const __half* p, bool now) {
  uint2 u;
  if (now)
    asm volatile("ld.global.v2.u32 {%0, %1}, [%2];" : "=r"(u.x), "=r"(u.y) : "l"(p));
  else
    u = *reinterpret_cast<const uint2*>(p);
  const float2 a = f16x2(u.x), b = f16x2(u.y);
  return make_float4(a.x, a.y, b.x, b.y);
}

template <int MAXN>
__device__ __forceinline__ void load_column(uint4 (&vals)[MAXN], const uint4* vb, int n,
                                            long long mp, long long j) {
#pragma unroll
  for (int kk = 0; kk < MAXN; ++kk)
    if (kk < n) vals[kk] = load_stream(vb + kk * mp + j);
}

// fused[qq] = sum over kk of coef[kk][qq] V[kk] for one pack of every
// agent's row, summed in float32 in key order, rounded to T at the store.
template <typename T, int MAXN>
__device__ __forceinline__ void fuse_column(const uint4 (&vals)[MAXN], const float* coef,
                                            uint4* fb, int n, long long mp, long long j) {
  constexpr int kE = Pack<T>::kElems;
#pragma unroll
  for (int qq = 0; qq < MAXN; ++qq) {
    if (qq < n) {
      float acc[kE];
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < MAXN; ++kk) {
        if (kk < n) {
          float v[kE];
          Pack<T>::unpack(vals[kk], v);
          const float c = coef[kk * n + qq];
#pragma unroll
          for (int e = 0; e < kE; ++e) acc[e] += c * v[e];
        }
      }
      __stcs(fb + qq * mp + j, Pack<T>::pack(acc));
    }
  }
}

// The width of a CTA's slice of D: a multiple of 4, kCluster of them cover D.
__host__ __device__ __forceinline__ int slice_pitch(int d) {
  return ((d + 3) / 4 + kCluster - 1) / kCluster * 4;
}

// Row `row` of the batch element's K (rows 0..n-1) and Q' (rows n..2n-1).
template <typename T>
__device__ __forceinline__ const T* qk_row(const T* kb, const T* qb, int n, int d, int row) {
  return row < n ? kb + (size_t)row * d : qb + (size_t)(row - n) * d;
}

// Sums v over the warp's 32 lanes by halving exchanges (62 shuffles, not
// 64 x 5): lane l ends with the sums of entries 2l and 2l + 1.
__device__ __forceinline__ float2 warp_sum_scatter(float (&v)[kGroup * kGroup], int lane) {
  int half = kGroup * kGroup / 2;
#pragma unroll
  for (int bit = 16; bit >= 1; bit >>= 1, half >>= 1) {
    const bool upper = lane & bit;  // keeps the upper half of the live entries
#pragma unroll
    for (int i = 0; i < kGroup * kGroup / 2; ++i) {
      if (i >= half) break;
      const float send = upper ? v[i] : v[i + half];
      const float keep = upper ? v[i + half] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, bit);
    }
  }
  return make_float2(v[0], v[1]);
}

// This CTA's partial logits over the slice in shared memory (2n rows of
// `pitch` floats, K's then Q''s, zero past the slice's end) into `partial`
// ([key][query]), by every thread of the block: per 8 x 8 group of (key,
// query) pairs, each thread's products over the columns 4t .. 4t + 3,
// 4t + 1024 .. in registers, the warp's sums by warp_sum_scatter, then the
// warps' in order.
__device__ __forceinline__ void slice_logits(const float* slice, int n, int pitch,
                                             float* partial, float (*red)[kGroup * kGroup]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = (n + kGroup - 1) / kGroup;
  const float* kb = slice;
  const float* qb = slice + n * pitch;
  for (int g = 0; g < groups * groups; ++g) {
    const int k0 = (g / groups) * kGroup, q0 = (g % groups) * kGroup;
    float part[kGroup * kGroup];
#pragma unroll
    for (int i = 0; i < kGroup * kGroup; ++i) part[i] = 0.f;
    for (int i = 4 * threadIdx.x; i < pitch; i += 4 * kThreads) {
      float4 kv[kGroup], qv[kGroup];
#pragma unroll
      for (int a = 0; a < kGroup; ++a) {
        const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
        kv[a] = k0 + a < n ? *reinterpret_cast<const float4*>(kb + (k0 + a) * pitch + i) : zero;
        qv[a] = q0 + a < n ? *reinterpret_cast<const float4*>(qb + (q0 + a) * pitch + i) : zero;
      }
#pragma unroll
      for (int a = 0; a < kGroup; ++a)
#pragma unroll
        for (int c = 0; c < kGroup; ++c)
          part[a * kGroup + c] +=
              kv[a].x * qv[c].x + kv[a].y * qv[c].y + kv[a].z * qv[c].z + kv[a].w * qv[c].w;
    }
    *reinterpret_cast<float2*>(&red[warp][2 * lane]) = warp_sum_scatter(part, lane);
    __syncthreads();
    if (threadIdx.x < kGroup * kGroup) {
      const int a = threadIdx.x / kGroup, c = threadIdx.x % kGroup;
      if (k0 + a < n && q0 + c < n) {
        float s = 0.f;
        for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
        partial[(k0 + a) * n + q0 + c] = s;
      }
    }
    __syncthreads();
  }
}

// mp: 16-byte packs of V per agent row (M / Pack<T>::kElems)
template <typename T, int MAXN>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
comm_fusion_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const uint4* __restrict__ v, uint4* __restrict__ fused,
                   float* __restrict__ coef_out, float* __restrict__ soft_out,
                   int n, int d, long long mp, int mode, float diag_bias,
                   float thres) {
  constexpr int kCols = kMaxAgents / MAXN;  // columns of V a thread has in flight
  extern __shared__ float4 slice4[];  // this CTA's slice of D: K's n rows, then Q''s n
  __shared__ float red[kWarps][kGroup * kGroup];
  __shared__ float partial[MAXN * MAXN];  // [key][query], over this CTA's slice
  __shared__ float gathered[kCluster][MAXN * MAXN];  // every CTA's partial, by rank
  __shared__ float logits[MAXN * MAXN];
  __shared__ float coef[MAXN * MAXN];
  __shared__ __align__(8) uint64_t arrived;  // counts the gathered bytes
  float* const slice = reinterpret_cast<float*>(slice4);
  const uint32_t bar = (uint32_t)__cvta_generic_to_shared(&arrived);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_expect_tx(bar, kCluster * n * n * sizeof(float));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_arrive();  // the mbarrier is ready for the others' stores
  const int b = blockIdx.y;
  const T* const kb = k + (size_t)b * n * d;
  const T* const qb = q + (size_t)b * n * d;
  const uint4* vb = v + (size_t)b * n * mp;
  uint4* fb = fused + (size_t)b * n * mp;

  // 1. this CTA's slice of K and Q' into shared memory (float4s where D and
  //    the rows allow; zeros past its end), then V's loads (see the note above)
  const int pitch = slice_pitch(d);
  const int d0 = min(d, (int)cluster_rank() * pitch), len = min(d, d0 + pitch) - d0;
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(kb) % (4 * sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(qb) % (4 * sizeof(T)) == 0;
  const int row4 = max(len / 4, 1), total4 = vec ? 2 * n * (len / 4) : 0;
  float4 pre[kPre];
#pragma unroll
  for (int u = 0; u < kPre; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if (i < total4) pre[u] = load_qk4(qk_row(kb, qb, n, d, i / row4) + d0 + 4 * (i % row4), true);
  }
  if (vec && len == pitch) {
#pragma unroll
    for (int u = 0; u < kPre; ++u) {
      const int i = threadIdx.x + u * kThreads;
      if (i < total4) slice4[i] = pre[u];  // rows of len == pitch floats
    }
    for (int i = threadIdx.x + kPre * kThreads; i < total4; i += kThreads)
      slice4[i] = load_qk4(qk_row(kb, qb, n, d, i / row4) + d0 + 4 * (i % row4), false);
  } else {
    for (int i = threadIdx.x; i < 2 * n * pitch; i += kThreads) {
      const int row = i / pitch, col = i % pitch;
      slice[i] = col < len ? to_float(qk_row(kb, qb, n, d, row)[d0 + col]) : 0.f;
    }
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long j0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  uint4 vals[kCols][MAXN];
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    if (j0 + c * stride < mp) load_column<MAXN>(vals[c], vb, n, mp, j0 + c * stride);
  __syncthreads();

  // 2. the graph
  slice_logits(slice, n, pitch, partial, red);
  cluster_wait();  // every CTA's mbarrier is ready (long since, by now)
  if (threadIdx.x < n * n) {  // this CTA's partial into every CTA's `gathered`
    const uint32_t rank = cluster_rank();
    const uint32_t dst = (uint32_t)__cvta_generic_to_shared(&gathered[rank][threadIdx.x]);
    for (uint32_t r = 0; r < kCluster; ++r)
      store_remote(at_rank(dst, r), partial[threadIdx.x], at_rank(bar, r));
  }
  mbar_wait(bar, 0);  // all kCluster partials have landed here
  if (threadIdx.x < n * n) {
    float s = 0.f;
    for (int r = 0; r < kCluster; ++r) s += gathered[r][threadIdx.x];
    logits[threadIdx.x] = s;
  }
  __syncthreads();
  if (threadIdx.x < MAXN * MAXN) {  // MAXN lanes per query column, one per key
    const int qq = threadIdx.x / MAXN, kk = threadIdx.x % MAXN;
    const bool valid = qq < n && kk < n;
    const float l = valid ? logits[kk * n + qq] : -INFINITY;
    float mx = l;
#pragma unroll
    for (int off = MAXN / 2; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float e = valid ? expf(l - mx) : 0.f;
    float sum = e;
#pragma unroll
    for (int off = MAXN / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    float s = valid ? e / sum : -INFINITY;
    if (kk == qq) s += diag_bias;
    float best = s;  // the column's argmax; ties keep the lowest key
    int first = kk;
#pragma unroll
    for (int off = MAXN / 2; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, off);
      const int of = __shfl_xor_sync(0xffffffffu, first, off);
      if (ob > best || (ob == best && of < first)) {
        best = ob;
        first = of;
      }
    }
    float c = s;
    if (mode == kActivated) c = s > thres ? s : 0.f;
    if (mode == kArgmax) c = kk == first ? 1.f : 0.f;
    if (valid) {
      coef[kk * n + qq] = c;
      if (blockIdx.x == 0) {
        soft_out[((size_t)b * n + kk) * n + qq] = s;
        coef_out[((size_t)b * n + kk) * n + qq] = c;
      }
    }
  }
  __syncthreads();

  // 3. fuse the columns in flight, then any further ones
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    if (j0 + c * stride < mp) fuse_column<T, MAXN>(vals[c], coef, fb, n, mp, j0 + c * stride);
  for (long long j = j0 + kCols * stride; j < mp; j += stride) {
    load_column<MAXN>(vals[0], vb, n, mp, j);
    fuse_column<T, MAXN>(vals[0], coef, fb, n, mp, j);
  }
}

template <typename T, int MAXN>
int launch(const T* q, const T* k, const T* v, T* fused, float* coef, float* soft, int B,
           int N, int D, long long M, int mode, float diag_bias, float thres,
           cudaStream_t stream) {
  auto kernel = comm_fusion_kernel<T, MAXN>;
  constexpr int kCols = kMaxAgents / MAXN;
  const long long mp = M / Pack<T>::kElems;
  const size_t smem = (size_t)2 * N * slice_pitch(D) * sizeof(float);
  cudaError_t err;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return (int)err;
  // the clusters the card holds at once, shared over the batch (one wave
  // when the batch allows), and no more CTAs per batch element than give
  // each thread kCols columns. The query is host time on every eval batch,
  // so it is made once per device and shared-memory size (a stale value
  // could only change the grid's size).
  static int active_dev = -1, active = 0;
  static size_t active_smem = 0;
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if (dev != active_dev || smem != active_smem) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kCluster, 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    if ((err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg)) != cudaSuccess)
      return (int)err;
    active_dev = dev;
    active_smem = smem;
  }
  const long long cols = (mp + (long long)kThreads * kCols - 1) / ((long long)kThreads * kCols);
  long long per_b = active / B;  // clusters
  if (per_b < 1) per_b = 1;
  if (per_b * kCluster > cols) per_b = (cols + kCluster - 1) / kCluster;
  const dim3 grid((unsigned)(per_b * kCluster), B);
  kernel<<<grid, kThreads, smem, stream>>>(
      q, k, reinterpret_cast<const uint4*>(v), reinterpret_cast<uint4*>(fused), coef, soft,
      N, D, mp, mode, diag_bias, thres);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ the wide design

constexpr int kWideQ = kCluster;      // queries of a graph cluster: rank r owns query q0 + r
constexpr int kWideKeys = kWarps * 8;  // keys a graph CTA stages at once: an 8-key tile a warp
constexpr int kWideCols = 128;        // columns of a graph CTA's slice of D staged at once
constexpr int kWideColKeys = 1024;    // logits of its query a graph CTA keeps in shared memory
constexpr int kFuseKeys = 64;         // keys of coef a fusion CTA stages at once
constexpr int kFuseCols = 128;        // columns of V a fusion CTA owns
constexpr size_t kFuseResident = 160 * 1024;  // V bytes a fusion CTA may keep for all its keys
constexpr int kFuseStages = 4;                // tiles of V a fusion CTA may have in flight
constexpr size_t kFuseBudget = 110 * 1024;    // shared memory of a fusion CTA, two an SM

__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Sums v over the warp's lanes; every lane ends with the same bits (each
// exchange adds the same two values, in either order).
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The width of a graph CTA's slice of D: a multiple of 8 values (16-byte
// aligned in every type); kCluster of them cover D.
__host__ __device__ __forceinline__ int wide_pitch(int d) {
  return ((d + 7) / 8 + kCluster - 1) / kCluster * 8;
}

// Shared memory of a graph CTA (bytes, in order): the partial logits it
// receives ([rank][key] float64), its queries' slice block in float64, its
// query's logits (n <= kWideColKeys; beyond, soft/coef hold them), its
// mbarrier, then the raw staged rows of Q' and K (a pad of 16 values a row
// keeps a quarter-warp's loads on distinct banks).
template <typename T>
struct GraphSmem {
  static constexpr int kRow = (kWideCols + 16) * (int)sizeof(T);
  static constexpr int kQd = kWideCols + 2;  // doubles a row of the float64 block
  int keys, col;
  __host__ __device__ explicit GraphSmem(int n)
      : keys(n < kWideKeys ? round_up(n, 8) : kWideKeys), col(n <= kWideColKeys ? n : 0) {}
  __host__ __device__ size_t qd() const { return (size_t)kCluster * kWideKeys * 8; }
  __host__ __device__ size_t column() const { return qd() + (size_t)kWideQ * kQd * 8; }
  __host__ __device__ size_t bar() const { return (column() + (size_t)col * 8 + 15) / 16 * 16; }
  __host__ __device__ size_t qs() const { return bar() + 16; }
  __host__ __device__ size_t ks() const { return qs() + (size_t)kWideQ * kRow; }
  __host__ __device__ size_t bytes() const { return ks() + (size_t)keys * kRow; }
};

// The fusion CTA's shared memory: the coef tile, then V's rows of its
// columns (16-bit: a pad of 16 bytes a row keeps ldmatrix's 8 rows on
// distinct banks). 16-bit coef: three bf16 terms [term][key][query];
// float32: [key][query] floats.
template <typename T>
struct FuseSmem {
  static constexpr bool kTensor = sizeof(T) == 2;  // 16-bit V: the tensor cores
  static constexpr int kQ = kTensor ? 64 : 32;  // queries of a tile: four m16 tiles, 8 warps x 4
  static constexpr int kPacks = kFuseCols * (int)sizeof(T) / 16;
  static constexpr int kRow = kFuseCols * (int)sizeof(T) + (kTensor ? 16 : 0);
  static constexpr int kPitch = kQ + 8;  // bf16 values a key's row of a coef term
  static constexpr size_t kCoef =
      kTensor ? (size_t)3 * kFuseKeys * kPitch * 2 : (size_t)kFuseKeys * kQ * 4;
  // 16-bit: the tile's output rounded to T, [query][column] (rows of kRow
  // bytes), stored from there in 16-byte packs
  static constexpr size_t kOut = kTensor ? (size_t)kQ * kRow : 0;
  // V rows kept: every key's (rounded to 16) where they fit, else one chunk's
  static int rows(int n) {
    const int all = round_up(n, 16);
    return (size_t)all * kRow <= kFuseResident ? all : kFuseKeys;
  }
  // tiles of V in flight: where every key's rows are kept, as many as fit
  // two CTAs an SM (at most kFuseStages, at least 1, at most the CTA's
  // tiles); else 1
  static int stages(int n, int per) {
    const size_t tile = (size_t)rows(n) * kRow;
    if (rows(n) < round_up(n, 16)) return 1;
    const size_t room = kFuseBudget > kCoef + kOut + tile ? (kFuseBudget - kCoef - kOut) / tile : 1;
    return (int)std::max<size_t>(1, std::min<size_t>({room, (size_t)kFuseStages, (size_t)per}));
  }
  static size_t bytes(int n, int per) {
    return kCoef + kOut + (size_t)stages(n, per) * rows(n) * kRow;
  }
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}
// waits until at most `pending` (0 .. 3) of this thread's committed groups are in flight
__device__ __forceinline__ void cp_async_wait_pending(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;" ::: "memory"); break;
  }
}
// Programmatic dependent launch: the graph kernel lets the fusion kernel
// start; the fusion kernel waits for the graph kernel's end (and its writes).
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void wait_primary() { asm volatile("griddepcontrol.wait;" ::: "memory"); }

// c (8 x 8, f64) += a (8 x 4) b (4 x 8) on the float64 tensor cores: lane
// (g, t) = (lane / 4, lane % 4) holds a[g][t], b[t][g] and c[g][2t .. 2t + 1]
__device__ __forceinline__ void dmma(double (&c)[2], double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};"
               : "+d"(c[0]), "+d"(c[1])
               : "d"(a), "d"(b));
}
// v into another CTA's shared memory, counted by its mbarrier `bar`
__device__ __forceinline__ void store_remote(uint32_t addr, double v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];" ::"r"(
                   addr),
               "l"(__double_as_longlong(v)), "r"(bar)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
// d (16 x 8, f32) += a (16 x 16, bf16) b (16 x 8, bf16), mma.sync's fragments
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<const uint32_t*>(&h);
}
// two float16 values (a word) as two bf16 words hi + lo, exactly: hi holds
// the top 8 significant bits, lo the rest (at most 4)
__device__ __forceinline__ void split_f16(uint32_t w, uint32_t& hi, uint32_t& lo) {
  const float2 f = f16x2(w);
  const __nv_bfloat162 h = __floats2bfloat162_rn(f.x, f.y);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(f.x - hf.x, f.y - hf.y));
}
// two float32 sums rounded once to T, as a word
template <typename T>
__device__ __forceinline__ uint32_t pack2(float a, float b);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float a, float b) {
  return bits(__floats2bfloat162_rn(a, b));
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float a, float b) {
  const __half2 h = __floats2half2_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// four staged values of T (raw bits in shared memory) as float64
__device__ __forceinline__ void load4(const unsigned char* p, const float*, double (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
}
__device__ __forceinline__ void load4(const unsigned char* p, const __nv_bfloat16*,
                                      double (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  v[0] = bf16_lo(u.x), v[1] = bf16_hi(u.x), v[2] = bf16_lo(u.y), v[3] = bf16_hi(u.y);
}
__device__ __forceinline__ void load4(const unsigned char* p, const __half*, double (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = f16x2(u.x), b = f16x2(u.y);
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}

// `rows` rows of `src` (row r at src + r * d) from column c0, `cols` values,
// into shared memory rows of kRow bytes, zero up to the next multiple of 16
// values; 16-byte cp.async where `vec` (D % 8 == 0, aligned), else by value.
template <typename T>
__device__ __forceinline__ void stage_rows(unsigned char* dst, const T* src, int rows, int d,
                                           int c0, int cols, bool vec) {
  constexpr int kRow = GraphSmem<T>::kRow, kE = 16 / (int)sizeof(T);
  const int c16 = round_up(cols, 16);
  if (vec) {
    const int packs = c16 / kE;
    for (int i = threadIdx.x; i < rows * packs; i += kThreads) {
      const int r = i / packs, p = i % packs;
      const bool ok = p * kE < cols;
      cp_async16((uint32_t)__cvta_generic_to_shared(dst + r * kRow + p * 16),
                 ok ? (const void*)(src + (size_t)r * d + c0 + p * kE) : (const void*)src, ok);
    }
  } else {
    using Raw = typename std::conditional<sizeof(T) == 4, uint32_t, uint16_t>::type;
    for (int i = threadIdx.x; i < rows * c16; i += kThreads) {
      const int r = i / c16, c = i % c16;
      reinterpret_cast<Raw*>(dst + r * kRow)[c] =
          c < cols ? reinterpret_cast<const Raw*>(src + (size_t)r * d + c0)[c] : (Raw)0;
    }
  }
}

// soft[b][key][query] and coef: the graph of queries q0 .. q0 + kWideQ - 1
// (see the note at the top). Grid (kCluster, query tiles, B), clusters along
// D. Beyond kWideColKeys keys the logits pass through soft (hi) and coef
// (lo), which the same thread reads back: no __restrict__ on them.
template <typename T>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
comm_fusion_wide_graph(const T* __restrict__ q, const T* __restrict__ k, float* coef_out,
                       float* soft_out, int n, int d, int mode, float diag_bias, float thres) {
  extern __shared__ __align__(16) unsigned char smem[];
  const GraphSmem<T> lay(n);
  double(*gathered)[kWideKeys] = reinterpret_cast<double(*)[kWideKeys]>(smem);
  double(*qd)[GraphSmem<T>::kQd] = reinterpret_cast<double(*)[GraphSmem<T>::kQd]>(smem + lay.qd());
  double* const column = reinterpret_cast<double*>(smem + lay.column());
  unsigned char* const qs = smem + lay.qs();
  unsigned char* const ks = smem + lay.ks();
  const uint32_t bar = (uint32_t)__cvta_generic_to_shared(smem + lay.bar());
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const uint32_t rank = cluster_rank();
  const int b = blockIdx.z, q0 = blockIdx.y * kWideQ, qc = q0 + (int)rank;
  const int nq = min(kWideQ, n - q0), chunks = (n + kWideKeys - 1) / kWideKeys;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_expect_tx(bar, kCluster * min(kWideKeys, n) * 8);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_arrive();  // the mbarrier is ready for the others' stores
  launch_dependents();  // the fusion kernel may start streaming V

  const int pitch = wide_pitch(d);
  const int d0 = min(d, (int)rank * pitch), len = min(d, d0 + pitch) - d0;
  const T* const kb = k + (size_t)b * n * d;
  const T* const qb = q + ((size_t)b * n + q0) * d;
  const bool vec = d % 8 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0;
  float* const hi = soft_out + (size_t)b * n * n;
  float* const lo = coef_out + (size_t)b * n * n;
  // the query's value at `key` (its logit, then its exp): in shared memory,
  // or as a float32 pair in soft and coef, which lane key % 32 of warp 0
  // writes and reads back
  auto keep = [&](int key, double v) {
    if (lay.col) {
      column[key] = v;
    } else {
      const float h = (float)v;
      hi[(size_t)key * n + qc] = h;
      lo[(size_t)key * n + qc] = (float)(v - (double)h);
    }
  };
  auto kept = [&](int key) {
    if (lay.col) return column[key];
    return (double)hi[(size_t)key * n + qc] + (double)lo[(size_t)key * n + qc];
  };

  for (int c = 0; c < chunks; ++c) {
    const int k0 = c * kWideKeys, nk = min(kWideKeys, n - k0);
    // 1. this slice's logits of the chunk's keys against the tile's queries:
    //    warp w's 8 keys on the float64 tensor cores, four chains of products
    double acc[4][2] = {};
    for (int c0 = 0; c0 < len; c0 += kWideCols) {
      const int cols = min(kWideCols, len - c0);
      __syncthreads();  // the previous block is read
      stage_rows<T>(qs, qb, nq, d, d0 + c0, cols, vec);
      stage_rows<T>(ks, kb + (size_t)k0 * d, nk, d, d0 + c0, cols, vec);
      cp_async_wait_all();
      __syncthreads();
      const int c16 = round_up(cols, 16), c4 = c16 / 4;
      for (int i = threadIdx.x; i < nq * c4; i += kThreads) {  // the queries in float64
        const int r = i / c4, cc = 4 * (i % c4);
        double v[4];
        load4(qs + r * GraphSmem<T>::kRow + cc * (int)sizeof(T), (const T*)nullptr, v);
#pragma unroll
        for (int j = 0; j < 4; ++j) qd[r][cc + j] = v[j];
      }
      __syncthreads();
      if (8 * warp < nk) {
        // k-step j of a 16-column group takes column 4t + j on lane t (the
        // same permutation on both operands: the same sum of products)
        const unsigned char* const krow = ks + (8 * warp + g) * GraphSmem<T>::kRow;
        for (int gr = 0; gr < c16 / 16; ++gr) {
          double a[4];
          load4(krow + (16 * gr + 4 * t) * (int)sizeof(T), (const T*)nullptr, a);
          const double2 b01 = *reinterpret_cast<const double2*>(&qd[g][16 * gr + 4 * t]);
          const double2 b23 = *reinterpret_cast<const double2*>(&qd[g][16 * gr + 4 * t + 2]);
          dmma(acc[gr & 3], a[0], b01.x);
          dmma(acc[gr & 3], a[1], b01.y);
          dmma(acc[gr & 3], a[2], b23.x);
          dmma(acc[gr & 3], a[3], b23.y);
        }
      }
    }
    // 2. the partials into their owners (query 2t + i: rank 2t + i), then
    //    each owner sums the kCluster partials of its query in rank order
    if (c == 0) cluster_wait();  // every CTA's mbarrier is ready (long since, by now)
    if (8 * warp + g < nk) {
      const uint32_t dst = (uint32_t)__cvta_generic_to_shared(&gathered[rank][8 * warp + g]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t owner = 2 * t + i;
        store_remote(at_rank(dst, owner), (acc[0][i] + acc[1][i]) + (acc[2][i] + acc[3][i]),
                     at_rank(bar, owner));
      }
    }
    mbar_wait(bar, c & 1);
    if (warp == 0 && qc < n) {
      for (int kk = lane; kk < nk; kk += 32) {
        double s = 0.0;
#pragma unroll
        for (int r = 0; r < kCluster; ++r) s += gathered[r][kk];
        keep(k0 + kk, s);
      }
    }
    if (c + 1 < chunks) {  // the next chunk's partials wait for these sums
      if (threadIdx.x == 0) mbar_expect_tx(bar, kCluster * min(kWideKeys, n - k0 - nk) * 8);
      cluster_arrive();
      cluster_wait();
    }
  }

  // 3. one warp per query: the softmax over keys, the bias, the mask
  if (warp != 0 || qc >= n) return;
  double mx = -INFINITY;
  for (int key = lane; key < n; key += 32) mx = fmax(mx, kept(key));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmax(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  double sum = 0.0;
  for (int key = lane; key < n; key += 32) {
    const double e = exp(kept(key) - mx);
    keep(key, e);
    sum += e;
  }
  sum = warp_sum(sum);
  // soft of one key, rounded once; the same bits in both passes below
  auto soft_of = [&](int key) {
    const double s = kept(key) / sum;
    return (float)(key == qc ? s + (double)diag_bias : s);
  };
  float best = -INFINITY;  // the column's argmax; ties keep the lowest key
  int first = n;
  if (mode == kArgmax) {
    for (int key = lane; key < n; key += 32) {
      const float s = soft_of(key);
      if (s > best) {  // keys ascend in a lane: strict '>' keeps its lowest
        best = s;
        first = key;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, off);
      const int of = __shfl_xor_sync(0xffffffffu, first, off);
      if (ob > best || (ob == best && of < first)) {
        best = ob;
        first = of;
      }
    }
  }
  for (int key = lane; key < n; key += 32) {
    const float s = soft_of(key);  // reads (key, qc) before it is written
    float cv = s;
    if (mode == kActivated) cv = s > thres ? s : 0.f;
    if (mode == kArgmax) cv = key == first ? 1.f : 0.f;
    hi[(size_t)key * n + qc] = s;
    lo[(size_t)key * n + qc] = cv;
  }
}

// The coef tile of keys k0 .. and queries q0 .., zero past N, its loads all
// issued before any is used: 16-bit V, three bf16 terms (coef = t0 + t1 + t2
// exactly) [term][key][query]; float32 V, as it is, [key][query].
template <typename T>
__device__ __forceinline__ void stage_coef(unsigned char* cs, const float* cb, int n, int q0,
                                           int k0) {
  constexpr int kQ = FuseSmem<T>::kQ, kPer = kFuseKeys * kQ / kThreads;
  float x[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = threadIdx.x + u * kThreads, kk = i / kQ, qq = i % kQ;
    x[u] = k0 + kk < n && q0 + qq < n ? __ldcg(cb + (size_t)(k0 + kk) * n + q0 + qq) : 0.f;
  }
  if constexpr (FuseSmem<T>::kTensor) {
    constexpr int kPitch = FuseSmem<T>::kPitch, kTerm = kFuseKeys * kPitch;
    __nv_bfloat16* const a = reinterpret_cast<__nv_bfloat16*>(cs);
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = threadIdx.x + u * kThreads, at = i / kQ * kPitch + i % kQ;
      const __nv_bfloat16 h = __float2bfloat16_rn(x[u]);
      const float r = x[u] - __bfloat162float(h);
      const __nv_bfloat16 m = __float2bfloat16_rn(r);
      a[at] = h;
      a[kTerm + at] = m;
      a[2 * kTerm + at] = __float2bfloat16_rn(r - __bfloat162float(m));
    }
  } else {
#pragma unroll
    for (int u = 0; u < kPer; ++u) reinterpret_cast<float*>(cs)[threadIdx.x + u * kThreads] = x[u];
  }
}

// The fusion tile's sums: 16-bit on the tensor cores (warp w: columns
// 16w .. 16w + 15, every query of the tile), float32 on the CUDA cores.
template <typename T>
struct FuseAcc {
  static constexpr int kQ = FuseSmem<T>::kQ;
  float d[kQ / 16][2][4];  // (m16 tile, n8 tile, mma.sync's accumulator)
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int mt = 0; mt < kQ / 16; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[mt][nt][e] = 0.f;
  }
  // keys of the chunk: rows 0 .. nk - 1 of `vs` (zero up to a multiple of 16)
  __device__ __forceinline__ void add(const unsigned char* vs, const unsigned char* cs, int nk,
                                      int nq) {
    constexpr int kRow = FuseSmem<T>::kRow, kPitch = FuseSmem<T>::kPitch;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    // ldmatrix's row addresses: lane l gives row l % 8 of 8 x 8 matrix l / 8
    const int vk = (lane & 7) + 8 * ((lane >> 3) & 1), vn = 8 * (lane >> 4);  // V [key][column]
    const int ak = (lane & 7) + 8 * (lane >> 4), aq = 8 * ((lane >> 3) & 1);  // coef [key][query]
    const uint32_t vbase = (uint32_t)__cvta_generic_to_shared(vs);
    const uint32_t abase = (uint32_t)__cvta_generic_to_shared(cs);
    const int mtiles = (nq + 15) / 16;
    for (int ks = 0; ks < (nk + 15) / 16; ++ks) {
      uint32_t bv[4];  // V's k16 x n8 fragments of the warp's two n8 tiles
      ldsm_x4_trans(bv, vbase + (16 * ks + vk) * kRow + (16 * warp + vn) * 2);
      uint32_t bh[4], bl[4];  // float16: V = hi + lo, both bf16
      if constexpr (std::is_same<T, __half>::value) {
#pragma unroll
        for (int i = 0; i < 4; ++i) split_f16(bv[i], bh[i], bl[i]);
      }
#pragma unroll
      for (int mt = 0; mt < kQ / 16; ++mt) {
        if (mt >= mtiles) break;
#pragma unroll
        for (int term = 0; term < 3; ++term) {
          uint32_t a[4];  // coef^T's m16 x k16 fragment, from [key][query] by .trans
          ldsm_x4_trans(a, abase + ((term * kFuseKeys + 16 * ks + ak) * kPitch + 16 * mt + aq) * 2);
          if constexpr (std::is_same<T, __nv_bfloat16>::value) {
            mma_bf16(d[mt][0], a, bv[0], bv[1]);
            mma_bf16(d[mt][1], a, bv[2], bv[3]);
          } else {
            mma_bf16(d[mt][0], a, bh[0], bh[1]);
            mma_bf16(d[mt][1], a, bh[2], bh[3]);
            if (term < 2) {  // t2 x lo lies below float32's rounding of the sum
              mma_bf16(d[mt][0], a, bl[0], bl[1]);
              mma_bf16(d[mt][1], a, bl[2], bl[3]);
            }
          }
        }
      }
    }
  }
  // fused[q0 + query][the tile's packs from j0], rounded once to T: through
  // `os` (kQ rows of kRow bytes), then 16-byte packs, a row's contiguous
  __device__ __forceinline__ void store(uint4* fb, unsigned char* os, long long mp, long long j0,
                                        int q0, int n) {
    constexpr int kRow = FuseSmem<T>::kRow, kPacks = FuseSmem<T>::kPacks;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
    const int nq = min(kQ, n - q0);
#pragma unroll
    for (int mt = 0; mt < kQ / 16; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint32_t*>(os + (16 * mt + g + 8 * h) * kRow +
                                       (16 * warp + 8 * nt + 2 * t) * 2) =
              pack2<T>(d[mt][nt][2 * h], d[mt][nt][2 * h + 1]);
    __syncthreads();
    for (int i = threadIdx.x; i < nq * kPacks; i += kThreads) {
      const int r = i / kPacks, p = i % kPacks;
      if (j0 + p < mp)
        __stcs(fb + (size_t)(q0 + r) * mp + j0 + p, *reinterpret_cast<const uint4*>(os + r * kRow + p * 16));
    }
  }
};
// float32: thread (4 queries of warp w, 4w .. 4w + 3; pack tid % 32), key by key
template <>
struct FuseAcc<float> {
  float d[4][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[i][e] = 0.f;
  }
  __device__ __forceinline__ void add(const unsigned char* vs, const unsigned char* cs, int nk,
                                      int nq) {
    const int grp = threadIdx.x >> 5, p = threadIdx.x & 31;
    if (4 * grp >= nq) return;
    for (int kk = 0; kk < nk; ++kk) {
      const float4 x = *reinterpret_cast<const float4*>(vs + kk * FuseSmem<float>::kRow + p * 16);
      const float4 c4 = reinterpret_cast<const float4*>(cs)[kk * (FuseSmem<float>::kQ / 4) + grp];
      const float c[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        d[i][0] += c[i] * x.x;
        d[i][1] += c[i] * x.y;
        d[i][2] += c[i] * x.z;
        d[i][3] += c[i] * x.w;
      }
    }
  }
  __device__ __forceinline__ void store(uint4* fb, unsigned char*, long long mp, long long j0,
                                        int q0, int n) {
    const int grp = threadIdx.x >> 5, p = threadIdx.x & 31;
    const long long j = j0 + p;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qq = q0 + 4 * grp + i;
      if (j < mp && qq < n) __stcs(fb + (size_t)qq * mp + j, Pack<float>::pack(d[i]));
    }
  }
};

// fused[b][query] = sum over keys of coef[b][key][query] V[b][key] for
// `per` tiles of kFuseCols columns of batch element b (grid (tiles / per,
// B)) and every query, FuseSmem::kQ at a time; mp: 16-byte packs of V per
// agent row; vrows: V rows the CTA keeps a tile (FuseSmem::rows: every
// key's, or one chunk's, streamed again for each query tile); stages: tiles
// of V in flight (FuseSmem::stages), a ring. Where N fits one coef tile, it
// is staged once for all of the CTA's tiles.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
comm_fusion_wide_fuse(const uint4* __restrict__ v, uint4* __restrict__ fused,
                      const float* coef, int n, long long mp, int vrows, int per, int stages) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kQ = FuseSmem<T>::kQ, kPacks = FuseSmem<T>::kPacks, kRow = FuseSmem<T>::kRow;
  unsigned char* const cs = smem;
  unsigned char* const os = smem + FuseSmem<T>::kCoef;
  unsigned char* const vs = os + FuseSmem<T>::kOut;
  const int b = blockIdx.y;
  const long long tiles = (mp + kPacks - 1) / kPacks, t0 = (long long)blockIdx.x * per;
  const long long t1 = t0 + per < tiles ? t0 + per : tiles;
  const uint4* const vb = v + (size_t)b * n * mp;
  const float* const cb = coef + (size_t)b * n * n;
  const bool resident = vrows >= round_up(n, 16);
  const bool once = n <= kQ && n <= kFuseKeys;  // one coef tile serves every column tile
  const int chunks = (n + kFuseKeys - 1) / kFuseKeys;
  auto stage_of = [&](long long tile) { return vs + (size_t)((tile - t0) % stages) * vrows * kRow; };
  // chunk c's V rows of `tile` (its keys, zero up to a multiple of 16) at
  // row `row0` of the tile's stage
  auto load = [&](long long tile, int c, int row0) {
    const int k0 = c * kFuseKeys, rows = round_up(min(kFuseKeys, n - k0), 16);
    const long long j0 = tile * kPacks;
    unsigned char* const dst = stage_of(tile) + row0 * kRow;
    for (int i = threadIdx.x; i < rows * kPacks; i += kThreads) {
      const int r = i / kPacks, p = i % kPacks;
      const bool ok = k0 + r < n && j0 + p < mp;
      cp_async16((uint32_t)__cvta_generic_to_shared(dst + r * kRow + p * 16),
                 ok ? (const void*)(vb + (size_t)(k0 + r) * mp + j0 + p) : (const void*)vb, ok);
    }
  };
  // one commit group a tile, empty past the CTA's last
  auto load_tile = [&](long long tile) {
    if (tile < t1)
      for (int c = 0; c < (resident ? chunks : 1); ++c) load(tile, c, c * kFuseKeys);
    cp_async_commit();
  };
  for (int s = 0; s < stages; ++s) load_tile(t0 + s);  // V's loads first: they do not
  wait_primary();                                        // wait for the graph kernel
  if (once) stage_coef<T>(cs, cb, n, 0, 0);

  FuseAcc<T> acc;
  for (long long tile = t0; tile < t1; ++tile) {
    const unsigned char* const vt = stage_of(tile);
    for (int q0 = 0; q0 < n; q0 += kQ) {
      acc.zero();
      for (int c = 0; c < chunks; ++c) {
        const int k0 = c * kFuseKeys;
        if (!resident && (q0 > 0 || c > 0)) {
          __syncthreads();  // the previous chunk's rows are read
          load(tile, c, 0);
          cp_async_commit();
        }
        if (!once) {
          __syncthreads();  // the previous coef tile is read
          stage_coef<T>(cs, cb, n, q0, k0);
        }
        if (resident)
          cp_async_wait_pending(stages - 1);  // this tile's group; later tiles' stay in flight
        else
          cp_async_wait_all();
        __syncthreads();
        acc.add(vt + (resident ? k0 : 0) * kRow, cs, min(kFuseKeys, n - k0), min(kQ, n - q0));
      }
      if (q0 + kQ >= n) {  // this tile's stage is read: a later tile's loads
        __syncthreads();   // into it overlap the stores
        load_tile(tile + stages);
      }
      acc.store(fused + (size_t)b * n * mp, os, mp, tile * kPacks, q0, n);
    }
  }
}

// whether the fusion kernel starts while the graph kernel runs (a
// measurement turns it off to time each kernel alone)
bool wide_overlap = true;
constexpr int kFuseCtasPerSm = 2;  // fusion CTAs a grid aims at per SM

template <typename T>
int launch_wide(const T* q, const T* k, const T* v, T* fused, float* coef, float* soft, int B,
                int N, int D, long long M, int mode, float diag_bias, float thres,
                cudaStream_t stream) {
  const long long mp = M / Pack<T>::kElems;
  cudaError_t err;
  // once per device (never inside a graph's capture, which an eager call
  // precedes): the SMs of the card, the fusion grid's size, and both
  // kernels opted in to all the shared memory a block may have
  static int ready_dev = -1, sms = 0;
  int dev = 0, optin = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if (dev != ready_dev) {
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
            cudaSuccess ||
        (err = cudaFuncSetAttribute(comm_fusion_wide_graph<T>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, optin)) !=
            cudaSuccess ||
        (err = cudaFuncSetAttribute(comm_fusion_wide_fuse<T>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, optin)) !=
            cudaSuccess)
      return (int)err;
    ready_dev = dev;
  }
  // column tiles a fusion CTA walks: enough for kFuseCtasPerSm CTAs an SM
  const long long tiles = (mp + FuseSmem<T>::kPacks - 1) / FuseSmem<T>::kPacks;
  const long long target = (long long)sms * kFuseCtasPerSm;
  const int per = (int)std::max(1LL, (tiles * B + target - 1) / target);
  const size_t gsmem = GraphSmem<T>(N).bytes(), fsmem = FuseSmem<T>::bytes(N, per);
  const dim3 graph(kCluster, (N + kWideQ - 1) / kWideQ, B);
  comm_fusion_wide_graph<T><<<graph, kThreads, gsmem, stream>>>(q, k, coef, soft, N, D, mode,
                                                                 diag_bias, thres);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // the fusion kernel starts while the graph kernel runs (programmatic
  // dependent launch) and waits for it before it reads coef
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((tiles + per - 1) / per), B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = fsmem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = wide_overlap ? 1 : 0;
  return (int)cudaLaunchKernelEx(&cfg, comm_fusion_wide_fuse<T>, reinterpret_cast<const uint4*>(v),
                                 reinterpret_cast<uint4*>(fused), (const float*)coef, N, mp,
                                 FuseSmem<T>::rows(N), per, FuseSmem<T>::stages(N, per));
}

// the design by N: the cluster kernel up to kMaxAgents, the wide one above
template <typename T>
int launch_n(const T* q, const T* k, const T* v, T* fused, float* coef, float* soft, int B,
             int N, int D, long long M, int mode, float diag_bias, float thres, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (N > kMaxAgents)
    return launch_wide<T>(q, k, v, fused, coef, soft, B, N, D, M, mode, diag_bias, thres, st);
  if (N <= 8)
    return launch<T, 8>(q, k, v, fused, coef, soft, B, N, D, M, mode, diag_bias, thres, st);
  return launch<T, kMaxAgents>(q, k, v, fused, coef, soft, B, N, D, M, mode, diag_bias, thres,
                               st);
}

}  // namespace

// q, k: (B, N, D); v, fused: (B, N, M) with 16-byte aligned rows, M % 4 == 0
// (f32) or M % 8 == 0 (bf16, f16); coef, soft: (B, N, N) f32. mode: 0 softmax,
// 1 activated, 2 argmax. Any N >= 1: the cluster design up to 16 agents, the
// wide one above. Returns a cudaError_t.
extern "C" int comm_fusion_f32(const float* q, const float* k, const float* v,
                               float* fused, float* coef, float* soft, int B, int N,
                               int D, long long M, int mode, float diag_bias,
                               float thres, void* stream) {
  return launch_n(q, k, v, fused, coef, soft, B, N, D, M, mode, diag_bias, thres, stream);
}

extern "C" int comm_fusion_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                const __nv_bfloat16* v, __nv_bfloat16* fused, float* coef,
                                float* soft, int B, int N, int D, long long M, int mode,
                                float diag_bias, float thres, void* stream) {
  return launch_n(q, k, v, fused, coef, soft, B, N, D, M, mode, diag_bias, thres, stream);
}

// 1: the wide design's fusion kernel starts while its graph kernel runs (the
// default); 0: after it ends, so that a trace times each kernel alone.
extern "C" int comm_fusion_wide_overlap(int on) {
  wide_overlap = on != 0;
  return 0;
}

extern "C" int comm_fusion_f16(const __half* q, const __half* k, const __half* v, __half* fused,
                               float* coef, float* soft, int B, int N, int D, long long M,
                               int mode, float diag_bias, float thres, void* stream) {
  return launch_n(q, k, v, fused, coef, soft, B, N, D, M, mode, diag_bias, thres, stream);
}
