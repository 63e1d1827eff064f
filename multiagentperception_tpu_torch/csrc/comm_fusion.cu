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
// two kernels, no workspace, nothing sized by N in shared memory.
// 1. comm_fusion_wide_graph, grid (tiles of kWideQ queries, B): each warp
//    takes keys w, w + 8, ... and forms their logits against the tile's
//    queries over all of D in float64 (a float32 product is exact there;
//    the lanes' sums meet by an xor butterfly), and stores each logit as
//    a float32 pair, hi into soft and the rest into coef: the two outputs
//    hold the N x tile logits whatever N is. Then one warp per query reads
//    its column back, forms the softmax over keys in float64 (max, sum of
//    exp), adds diag_bias on the diagonal, rounds soft to float32 once and
//    masks it: activated keeps soft > thres, argmax the first key of the
//    largest soft. The graph is that of the float32 values of Q' and K in
//    every type, as the cluster design's (both lie within 1e-6 of the
//    graph in float64; this one within float32 rounding of it).
// 2. comm_fusion_wide_fuse, grid (tiles of queries, tiles of 256 packs of
//    M, B): each CTA stages kWideKeys keys of its queries' coef at a time in
//    shared memory and streams those keys' V rows of its columns (16-byte
//    packs, kWideUnroll in flight), summing coef x V in float32 registers
//    in key order (64 values a thread: 16 queries of 4 floats, 8 of 8
//    16-bit values), and rounds fused to V's type once. The query tiles of
//    one column tile are neighbours in the grid, so V's re-reads hit L2.
// Bound: the same bytes as the cluster design (V read once and fused
// written once: 12.6 MB at the sweep's B.N = 96 in bf16, 3.75 us).
// Types: comm_fusion_f32 takes float32 Q', K and V; comm_fusion_bf16 and
// comm_fusion_f16 take bfloat16 or float16 ones (the mixed-precision
// MIMOcom's), as the TPU kernel does (comm_fusion.py:42-43, 63-67): Q' and
// K are converted to float32 as they are staged into shared memory, so the
// graph is the float32 route's; V moves in 16-byte loads of 8 values, each
// converted to float32, the fusion accumulates in float32 registers, and
// fused is rounded to V's type once, at the store. coef and soft are
// float32 in all three. bf16's conversions to float32 are shifts of its
// bits (bf16_lo / bf16_hi); float16's are the hardware's (__half22float2),
// its rounding __floats2half2_rn.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>

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

constexpr int kWideQ = kWarps;  // queries of a graph CTA: one warp each in the softmax
constexpr int kWideKeys = 64;   // keys of coef a fusion CTA stages at once
constexpr int kWideUnroll = 4;  // V packs a fusion thread has in flight

// Sums v over the warp's lanes; every lane ends with the same bits (each
// exchange adds the same two values, in either order).
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// soft[b][key][query] and coef: the graph of queries q0 .. q0 + kWideQ - 1
// (see the note at the top). The logits pass through soft (hi) and coef (lo),
// which other threads of the block read back: no __restrict__ on them.
template <typename T>
__global__ void __launch_bounds__(kThreads)
comm_fusion_wide_graph(const T* __restrict__ q, const T* __restrict__ k, float* coef_out,
                       float* soft_out, int n, int d, int mode, float diag_bias,
                       float thres) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y, q0 = blockIdx.x * kWideQ;
  const int nq = min(kWideQ, n - q0);
  const T* const kb = k + (size_t)b * n * d;
  const T* qrow[kWideQ];  // past the last query: its row again, the sums unused
#pragma unroll
  for (int qq = 0; qq < kWideQ; ++qq)
    qrow[qq] = q + ((size_t)b * n + min(q0 + qq, n - 1)) * d;
  float* const hi = soft_out + (size_t)b * n * n;
  float* const lo = coef_out + (size_t)b * n * n;

  // 1. the logits, K's rows against the tile's queries, in float64
  for (int key = warp; key < n; key += kWarps) {
    const T* const kr = kb + (size_t)key * d;
    double acc[kWideQ];
#pragma unroll
    for (int qq = 0; qq < kWideQ; ++qq) acc[qq] = 0.0;
#pragma unroll 4
    for (int i = lane; i < d; i += 32) {
      const double kv = to_float(kr[i]);
#pragma unroll
      for (int qq = 0; qq < kWideQ; ++qq) acc[qq] += kv * (double)to_float(qrow[qq][i]);
    }
#pragma unroll
    for (int qq = 0; qq < kWideQ; ++qq) {
      const double l = warp_sum(acc[qq]);
      if (lane == qq && qq < nq) {
        const float h = (float)l;
        hi[(size_t)key * n + q0 + qq] = h;
        lo[(size_t)key * n + q0 + qq] = (float)(l - (double)h);
      }
    }
  }
  __syncthreads();  // the block's global writes are visible to the block

  // 2. one warp per query: the softmax over keys, the bias, the mask
  if (warp >= nq) return;
  const int qc = q0 + warp;
  double mx = -INFINITY;
  for (int key = lane; key < n; key += 32) {
    const size_t at = (size_t)key * n + qc;
    mx = fmax(mx, (double)hi[at] + (double)lo[at]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmax(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  double sum = 0.0;
  for (int key = lane; key < n; key += 32) {
    const size_t at = (size_t)key * n + qc;
    sum += exp((double)hi[at] + (double)lo[at] - mx);
  }
  sum = warp_sum(sum);
  // soft of one key, rounded once; the same bits in both passes below
  auto soft_of = [&](int key) {
    const size_t at = (size_t)key * n + qc;
    const double s = exp((double)hi[at] + (double)lo[at] - mx) / sum;
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
    float c = s;
    if (mode == kActivated) c = s > thres ? s : 0.f;
    if (mode == kArgmax) c = key == first ? 1.f : 0.f;
    hi[(size_t)key * n + qc] = s;
    lo[(size_t)key * n + qc] = c;
  }
}

// fused[b][query] = sum over keys of coef[b][key][query] V[b][key], for a
// tile of kQ queries and the 16-byte packs j of every column tile of this
// CTA (grid-strided along M); mp: packs of V per agent row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
comm_fusion_wide_fuse(const uint4* __restrict__ v, uint4* __restrict__ fused,
                      const float* __restrict__ coef, int n, long long mp) {
  constexpr int kE = Pack<T>::kElems;
  constexpr int kQ = 64 / kE;  // 64 float32 sums a thread
  __shared__ float cs[kWideKeys][kQ];
  const int b = blockIdx.z, q0 = blockIdx.x * kQ;
  const int nq = min(kQ, n - q0);
  const uint4* const vb = v + (size_t)b * n * mp;
  const float* const cb = coef + (size_t)b * n * n;
  for (long long j0 = (long long)blockIdx.y * kThreads; j0 < mp;
       j0 += (long long)gridDim.y * kThreads) {
    const long long j = j0 + threadIdx.x;
    float acc[kQ][kE];
#pragma unroll
    for (int qq = 0; qq < kQ; ++qq)
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[qq][e] = 0.f;
    for (int k0 = 0; k0 < n; k0 += kWideKeys) {
      const int nk = min(kWideKeys, n - k0);
      __syncthreads();  // the previous keys' coef is read
      for (int i = threadIdx.x; i < kWideKeys * kQ; i += kThreads) {
        const int kk = i / kQ, qq = i % kQ;
        cs[kk][qq] = kk < nk && qq < nq ? cb[(size_t)(k0 + kk) * n + q0 + qq] : 0.f;
      }
      __syncthreads();
      if (j < mp) {
        for (int kk = 0; kk < nk; kk += kWideUnroll) {
          uint4 vals[kWideUnroll];
#pragma unroll
          for (int u = 0; u < kWideUnroll; ++u)
            if (kk + u < nk) vals[u] = vb[(size_t)(k0 + kk + u) * mp + j];
#pragma unroll
          for (int u = 0; u < kWideUnroll; ++u) {
            if (kk + u < nk) {
              float x[kE];
              Pack<T>::unpack(vals[u], x);
#pragma unroll
              for (int qq = 0; qq < kQ; ++qq) {
                const float c = cs[kk + u][qq];
#pragma unroll
                for (int e = 0; e < kE; ++e) acc[qq][e] += c * x[e];
              }
            }
          }
        }
      }
    }
    if (j < mp) {
#pragma unroll
      for (int qq = 0; qq < kQ; ++qq)
        if (qq < nq) __stcs(fused + ((size_t)b * n + q0 + qq) * mp + j, Pack<T>::pack(acc[qq]));
    }
  }
}

template <typename T>
int launch_wide(const T* q, const T* k, const T* v, T* fused, float* coef, float* soft, int B,
                int N, int D, long long M, int mode, float diag_bias, float thres,
                cudaStream_t stream) {
  constexpr int kQ = 64 / Pack<T>::kElems;
  const long long mp = M / Pack<T>::kElems;
  const dim3 graph((N + kWideQ - 1) / kWideQ, B);
  comm_fusion_wide_graph<T><<<graph, kThreads, 0, stream>>>(q, k, coef, soft, N, D, mode,
                                                             diag_bias, thres);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long cols = (mp + kThreads - 1) / kThreads;
  const dim3 fuse((N + kQ - 1) / kQ, (unsigned)(cols < 65535 ? cols : 65535), B);
  comm_fusion_wide_fuse<T><<<fuse, kThreads, 0, stream>>>(
      reinterpret_cast<const uint4*>(v), reinterpret_cast<uint4*>(fused), coef, N, mp);
  return (int)cudaGetLastError();
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

extern "C" int comm_fusion_f16(const __half* q, const __half* k, const __half* v, __half* fused,
                               float* coef, float* soft, int B, int N, int D, long long M,
                               int mode, float diag_bias, float thres, void* stream) {
  return launch_n(q, k, v, fused, coef, soft, B, N, D, M, mode, diag_bias, thres, stream);
}
