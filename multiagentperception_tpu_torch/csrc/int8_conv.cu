// int8 convolution for Hopper (sm_90a): K4 of the port, two launches.
//
// Replaces XLA's int8 convolution in multiagentperception_tpu/quantize.py:106-117
// (_int8_conv: lax.conv_general_dilated on int8 operands with
// preferred_element_type=int32). The JAX package has no Pallas kernel
// here; PyTorch on CUDA has no int8 convolution (cuDNN refuses int8
// through F.conv2d, torch._int_mm is a matrix product only), so the int8
// towers run this kernel. For one models.blocks.Conv2d it computes
//     x_i8 = rint(clip(x / s_x, -127, 127))                (half to even)
//     acc  = conv(x_i8, w_i8)  in int32, padding = int8 zeros
//     y    = float(acc) * (s_x * s_w[c]) (+ bias[c])        float32, no FMA
// and rounds y once to the output type (float32, bfloat16 or float16); the s32
// entry point writes acc itself (the checks hold it against the plain
// version's exact sum).
//
// Bound on the H100: bytes, at the flagship's bench batch (B*N = 120 at
// 512x512). The step's 48 int8 convolutions are ~2.6e12 operations, 1.3
// ms at the int8 tensor cores' 1,979 TOPS dense; their activations, int8
// scratch and outputs move 7.5 GB (float32 network) or 4.5 GB (bf16 or
// float16),
// 7.5 / 4.5 ms at 3.35 TB/s (the 512-channel 16x16 convolutions alone are
// bound by operations). chip_smoke.py phase 10 splits the bound between
// the two launches and times each.
//
// Launch 1, the quantize pass, at its byte bound (one read of x, one write
// of the scratch). quantize_nhwc_kernel: NCHW float32/bf16/float16 to NHWC
// int8 with Cp channels (Cin rounded up to 16, the padding zero), so that
// K, the channels of one tap, is contiguous in 16-byte pieces. A block
// takes 64 channels x 16 16-byte runs along the image row (64 pixels
// float32, 128 bf16 or float16, whose values are converted to float32
// exactly before the same division and rounding): a thread loads 4
// channels x one run, packs each pixel's 4 int8 channels into a word in
// shared memory, and the block writes 16-byte pieces along the channels. quantize_s2d_kernel (the stride-2 stem, Cin <=
// 4): space to depth, a 16-byte scratch pixel per 2 x 2 block of pixels x 4
// channels, so that the stem runs as a stride-1 convolution over 16
// channels on the halo route.
//
// Launch 2, int8_conv_kernel: an implicit GEMM on wgmma s8, M = output
// pixels, N = Cout, K = the taps x Cp. A persistent grid (one CTA per SM)
// walks over tiles of 128 output pixels x NB output channels; NB is 64, 128
// or 256, the least that holds Cout (Cout 512 in two slices, the slice
// slowest so that the CTAs in flight share one slice of weights in L2), so a
// tile's activations are fetched once for all of Cout up to 256 (the
// wrapper halves NB on geometries too small to give half the SMs a tile).
// Warpgroup 2 produces; warpgroups 0 and 1 consume with
// wgmma.mma_async m64nNBk32 s32 += s8 x s8, both operands K-major in shared
// memory, no swizzle (core matrices of 8 rows x 16 bytes; a k32 step is 32
// bytes, as a k16 step of bf16). At NB 64 and 128 the two warpgroups take
// whole tiles in turn (ping-pong: one's epilogue runs beside the other's
// products; an mbarrier pair keeps their waits on the ring in order); at NB
// 256 they share a tile, 64 pixels each (128 accumulators a thread either
// way). Integer sums are exact in any order, so the accumulator takes every
// stage of a tile with D = 2 (1) wgmma groups in flight, a slot given back
// D slots later. The weights come as (slice, stage, 4 planes, NB, 16 bytes)
// from ops/kernels/int8_conv.py's pack_weight, a slot's by one
// cp.async.bulk. K is (64-channel chunk, tap, 64 channels); channels past
// Cp are not loaded (or zero-filled) and their weights are 0. The A operand
// comes by one of three routes, which the wrapper's plan() picks from the
// geometry:
// - halo (3x3, stride 1: 85% of the step's operations): a tile is TH x TW
//   = 8 x 16 pixels of one image (16 x 8 where the output is at most 8
//   wide). One thread loads its (TH+2) x (TW+2) halo a chunk of 64
//   channels at a time by TMA (4 boxes of 16 channels, planes of 16-byte
//   pixels; TMA's zero fill is the padding and the image's edge, so tiles
//   never read across images) into a ring of 4 chunks. The taps read a
//   chunk through shifted descriptors: core matrix i of a 64-pixel block is
//   halo row i, 8 neighbouring pixels (SBO = the halo's pitch), a tap moves
//   the start by (dy*(TW+2) + dx)*16 bytes. Below 256 channels a slot holds
//   a kernel row, 3 taps.
// - s2d (stride 2, Cin <= 4: the stem): the halo over the space-to-depth
//   scratch (16 channels), K dense in (tap, 16 channels), 4 taps to the
//   right of each other a stage; a k32 step reads 2 of them, its two core
//   matrices one pixel apart (LBO = 16 bytes).
// - gather16 (any other geometry: stride 2, 1x1, other kernels): the
//   producer warpgroup's 128 threads gather the tile's 128 pixels x 64
//   bytes of K by cp.async (16-byte pieces, four threads a pixel), zero
//   fill for the padding, in the same (chunk, tap, 64 channels) order, into
//   planes of [pixel][16 bytes]. Each thread waits for its own copies a few
//   stages later, fences them for the async proxy and arrives.
// Epilogue: rescale in registers ((s_x * s_w) first, then __fmul_rn, then
// __fadd_rn for the bias: nvcc would otherwise contract an FMA, one
// rounding fewer than the plain version and XLA), stage 64 channels x 128
// pixels at a time in shared memory as [channel][pixel], and write each
// channel's pixels as 16-byte vector stores along NCHW's rows (a scalar
// store where a run is ragged or unaligned): 64-byte runs per halo row of
// 16, whole 128-pixel runs at 16x16 and in the gather route. The stores
// are one template on the output's element type (store_pass<OutT>): float
// (f32, or the s32 bits), or a 16-bit float (bf16, float16) rounded to
// nearest even, 8 values a store.
//
// Shared memory: the halo chunks, the ring, each epilogue's staging, the
// mbarriers. The wrapper's plan() is the one source of that layout: it
// picks the instantiation (route, NB, TPS, NS) from INT8_CONV_KERNELS
// below and passes every offset and the size in; the launch refuses a
// layout that cannot hold the instantiation's ring, epilogues and barriers,
// or that passes 227 KB, so a plan out of step with the kernel fails its
// launch instead of overlapping shared memory.

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "hopper.cuh"

namespace {

constexpr int kKS = 64;                       // bytes of K a stage: two k32 steps
constexpr int kConsumers = 256;               // two warpgroups
constexpr int kThreads = kConsumers + 128;    // + the producer warpgroup
constexpr int kEpiChannels = 64;              // channels the epilogue stages at a time
constexpr int kHaloChunks = 4;                // halo chunks in flight (two tiles' at Cp 128)
constexpr int kQThreads = 256;
constexpr int kSmemLimit = 232448;            // dynamic shared memory a CTA may hold (227 KB)

// A debug build's lagging warp (default off): with INT8_CONV_LAG_CYCLES > 0,
// warp 1 of each consumer warpgroup spins that many cycles after every
// epilogue, so the other warps run a tile ahead of it; the turn barriers
// must hold the ring's order all the same (tests/test_torch_cuda.py builds
// it as ops/kernels/_build.py's "int8_conv_lag").
#ifndef INT8_CONV_LAG_CYCLES
#define INT8_CONV_LAG_CYCLES 0
#endif

enum Route { kHalo = 0, kGather16 = 1, kS2d = 2 };
enum OutKind { kF32 = 0, kBF16 = 1, kS32 = 2, kF16 = 3 };

// routes whose A comes from a TMA halo
__host__ __device__ constexpr bool halo_a(int r) { return r == kHalo || r == kS2d; }

// A tile is TM = 128 pixels x NB channels. At NB <= 128 the consumer
// warpgroups take turns (PP, ping-pong), each a whole tile: MB = 2 blocks of
// 64 pixels; at NB = 256 both take one tile, a block each (MB = 1). Either
// way a thread holds MB * NB / 2 <= 128 accumulators. A ring slot holds
// TPS stages' weights (and, gathering, a stage's A); NS slots (both the
// plan's, from INT8_CONV_KERNELS). Each epilogue (one per warpgroup in PP)
// stages 64 channels x TM pixels of words, then the tile's scales and shifts.
template <int NB_, int R_, int TPS_, int NS_>
struct Tiling {
  static constexpr int NB = NB_;
  static constexpr int R = R_;
  static constexpr bool PP = NB < 256;
  static constexpr int MB = PP ? 2 : 1;
  static constexpr int TM = 128;
  static constexpr int TPS = TPS_;              // 64-byte K stages a slot
  static constexpr int NS = NS_;                // ring slots
  static constexpr int D = PP && NS > 4 ? 2 : 1;  // wgmma groups in flight (slots kept)
  static constexpr int SUB = kKS * NB;          // a 64-byte stage's weights
  static constexpr int WSTAGE = SUB * TPS;
  static constexpr int STAGE = WSTAGE + (halo_a(R) ? 0 : TM * kKS);
  static constexpr int EPI_T = PP ? 128 : 256;  // threads of an epilogue
  static constexpr int EPI_PITCH = TM + 4;      // words between staged channels
  static constexpr int EPI = kEpiChannels * EPI_PITCH * 4 + 2 * NB * 4;
  static constexpr int N_EPI = PP ? 2 : 1;
  static constexpr int BARS = (2 * NS + 2 * kHaloChunks + 2) * 8;  // full, empty, halo, turn
};

struct Geometry {
  int n_img, h, w, cp, cout, kh, kw, stride, pad, oh, ow;
  int stages, out_kind;                          // K stages a slice
  int tw, th, xw, pl;                            // halo tile, its pitch and plane bytes
  int tiles_w, tiles_per_img, tiles_px, n_tiles;
  int off_ring, off_epi, off_bar, smem;          // the plan's layout
  long long m_total;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

// A float32 value, and a pair of them as one word, rounded (to nearest
// even) to the 16-bit output type of the tag's
__device__ __forceinline__ __nv_bfloat16 round_to(float v, __nv_bfloat16) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ __half round_to(float v, __half) { return __float2half_rn(v); }
__device__ __forceinline__ uint32_t round_pair(float a, float b, __nv_bfloat16) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t round_pair(float a, float b, __half) {
  const __half2 h = __floats2half2_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t quantize(float v, float s) {
  const float q = fminf(fmaxf(__fdiv_rn(v, s), -127.f), 127.f);
  return static_cast<uint8_t>(static_cast<int8_t>(__float2int_rn(q)));  // half to even
}

// V values of x from p on, zero past hw (one 16- or 8-byte load when vec)
template <typename T, int V>
__device__ __forceinline__ void load_run(const T* __restrict__ row, int p, int hw, bool vec,
                                         float (&v)[V]) {
  static_assert(V * sizeof(T) == 16 || V * sizeof(T) == 8, "a 16- or 8-byte run");
  if (vec && p + V <= hw) {
    T e[V];
    if constexpr (V * sizeof(T) == 16)
      *reinterpret_cast<uint4*>(e) = __ldg(reinterpret_cast<const uint4*>(row + p));
    else
      *reinterpret_cast<uint2*>(e) = __ldg(reinterpret_cast<const uint2*>(row + p));
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = to_float(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = p + i < hw ? to_float(row[p + i]) : 0.f;
  }
}

// A block quantizes 16 V pixels x 64 channels of one image
// (V: 16 bytes of pixels, or 8 where the image is smaller than 16 runs).
template <typename T, int V>
__global__ void __launch_bounds__(kQThreads) quantize_nhwc_kernel(
    const T* __restrict__ x, const float* __restrict__ sx, int c_in, int hw, int cp, int vec,
    int8_t* __restrict__ xq) {
  constexpr int TP = 16 * V;
  __shared__ uint32_t tile[TP][17];  // [pixel][4-channel group], padded against conflicts
  const int p0 = blockIdx.x * TP, c0 = blockIdx.y * 64, img = blockIdx.z;
  const float s = *sx;
  const int pg = threadIdx.x & 15, cg = threadIdx.x >> 4;
  float v[4][V];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + 4 * cg + i;
    if (c < c_in) {
      load_run<T, V>(x + ((long long)img * c_in + c) * hw, p0 + pg * V, hw, vec, v[i]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) v[i][e] = 0.f;  // channels past Cin: the zero padding of Cp
    }
  }
#pragma unroll
  for (int e = 0; e < V; ++e) {
    uint32_t word = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) word |= quantize(v[i][e], s) << (8 * i);
    tile[pg * V + e][cg] = word;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < TP * 4; idx += kQThreads) {
    const int p = idx >> 2, piece = idx & 3, c = c0 + 16 * piece;
    if (p0 + p < hw && c < cp) {
      const uint4 val = make_uint4(tile[p][4 * piece], tile[p][4 * piece + 1],
                                   tile[p][4 * piece + 2], tile[p][4 * piece + 3]);
      *reinterpret_cast<uint4*>(xq + ((long long)img * hw + p0 + p) * cp + c) = val;
    }
  }
}

// The stride-2 stem's scratch, space to depth: the NCHW activation (Cin <=
// 4) to (N, ceil(H/2), ceil(W/2), 16) int8, a 16-byte "pixel" holding a
// 2 x 2 block of pixels x 4 channels as [row][column][channel] (zero past
// the image and past Cin). A thread takes two neighbouring blocks: 4
// columns of 2 rows, read as 16-byte runs (float32) or 8-byte ones (bf16,
// float16),
// written as two 16-byte stores. Over this scratch the stride-2 convolution
// is a stride-1 one over 16 channels with about half the taps a side
// (int8_conv.py's s2d_taps), which the halo's TMA boxes can feed.
template <typename T>
__global__ void __launch_bounds__(kQThreads) quantize_s2d_kernel(
    const T* __restrict__ x, const float* __restrict__ sx, int c_in, int h, int w, int h2,
    int w2, int vec, int8_t* __restrict__ xq) {
  const int pairs = (w2 + 1) / 2;
  const int idx = blockIdx.x * kQThreads + threadIdx.x, img = blockIdx.y;
  if (idx >= h2 * pairs) return;
  const int by = idx / pairs, bx = 2 * (idx - by * pairs), ix0 = 2 * bx;
  const float s = *sx;
  uint32_t word[2][4] = {};  // [block][row * 2 + column], byte c = channel c
#pragma unroll
  for (int sy = 0; sy < 2; ++sy) {
    const int iy = 2 * by + sy;
    if (iy >= h) break;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c >= c_in) break;
      const T* const row = x + (((long long)img * c_in + c) * h + iy) * w;
      float v[4];
      if (vec && ix0 + 4 <= w) {
        if constexpr (sizeof(T) == 4) {
          const float4 r = __ldg(reinterpret_cast<const float4*>(row + ix0));
          v[0] = r.x, v[1] = r.y, v[2] = r.z, v[3] = r.w;
        } else {
          const uint2 raw = __ldg(reinterpret_cast<const uint2*>(row + ix0));
          const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int i = 0; i < 4; ++i) v[i] = to_float(e[i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = ix0 + i < w ? to_float(row[ix0 + i]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (ix0 + i < w) word[i >> 1][sy * 2 + (i & 1)] |= quantize(v[i], s) << (8 * c);
    }
  }
  int8_t* const dst = xq + (((long long)img * h2 + by) * w2 + bx) * 16;
  *reinterpret_cast<uint4*>(dst) = make_uint4(word[0][0], word[0][1], word[0][2], word[0][3]);
  if (bx + 1 < w2)
    *reinterpret_cast<uint4*>(dst + 16) =
        make_uint4(word[1][0], word[1][1], word[1][2], word[1][3]);
}

__device__ __forceinline__ void mbar_expect_tx_only(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}
// 16 bytes from src, or 16 zero bytes where !ok
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

struct Bars {
  uint32_t full, empty, hfull, hempty, turn;  // shared addresses of the arrays
};

struct Tile {
  int slice, img, ty0, tx0;  // halo: image, first output row and column
  long long m0;              // gather: first output pixel (flattened)
};

template <int TM, int R>
__device__ __forceinline__ Tile tile_of(int t, const Geometry& g) {
  const int r = t % g.tiles_px;
  Tile tl{t / g.tiles_px, 0, 0, 0, 0};
  if (halo_a(R)) {
    const int q = r % g.tiles_per_img;
    tl.img = r / g.tiles_per_img;
    tl.ty0 = (q / g.tiles_w) * g.th;
    tl.tx0 = (q % g.tiles_w) * g.tw;
  } else {
    tl.m0 = (long long)r * TM;
  }
  return tl;
}

// The halo routes' producer: one thread issues every tile's halo chunks
// (TMA) and weight stages (bulk copies), in the order the consumers take them.
template <class Tl>
__device__ __forceinline__ void produce_halo(const CUtensorMap* map, const int8_t* wq,
                                             uint32_t base, const Bars& bars, const Geometry& g) {
  const int chunks = (g.cp + 63) / 64, spc = g.stages / chunks;  // stages a chunk serves
  const int chunk = 4 * g.pl;
  uint32_t st = 0, hc = 0;
  for (int t = blockIdx.x; t < g.n_tiles; t += gridDim.x) {
    const Tile tl = tile_of<Tl::TM, Tl::R>(t, g);
    for (int kc = 0; kc < chunks; ++kc, ++hc) {
      const uint32_t hs = hc % kHaloChunks;
      if (hc >= (uint32_t)kHaloChunks)
        mbar_wait(bars.hempty + hs * 8, ((hc / kHaloChunks) - 1) & 1);
      const int planes = min(4, (g.cp - kc * 64) / 16);  // planes past Cp stay unloaded
      mbar_expect_tx(bars.hfull + hs * 8, planes * (g.th + g.kh - 1) * g.xw * 16);
      for (int p = 0; p < planes; ++p)
        tma_load_4d(base + hs * chunk + p * g.pl, map, bars.hfull + hs * 8, kc * 64 + 16 * p,
                    tl.tx0 - g.pad, tl.ty0 - g.pad, tl.img);
      const int8_t* const w = wq + ((size_t)tl.slice * g.stages + kc * spc) * Tl::SUB;
      for (int j = 0; j < spc; j += Tl::TPS, ++st) {
        const uint32_t slot = st % Tl::NS;
        if (st >= (uint32_t)Tl::NS) mbar_wait(bars.empty + slot * 8, ((st / Tl::NS) - 1) & 1);
        mbar_expect_tx(bars.full + slot * 8, Tl::WSTAGE);
        bulk_load(base + g.off_ring + slot * Tl::STAGE, w + (size_t)j * Tl::SUB, Tl::WSTAGE,
                  bars.full + slot * 8);
      }
    }
  }
}

// The gather route's producer: the warpgroup's 128 threads copy each
// stage's A (TM pixels x 64 bytes of K) by cp.async; thread 0 also issues
// the stage's weights. A thread arrives on a stage's barrier once its own
// copies of it have landed (kLag stages later) and are fenced for wgmma
// (kLag + D < NS: the consumers give a slot back D stages after its own).
// Addresses: a row's offset is decoded once a tile, a piece's (tap,
// channel) offset once a stage.
template <class Tl>
__device__ __forceinline__ void produce_gather(const int8_t* __restrict__ xq, const int8_t* wq,
                                               uint32_t base, const Bars& bars,
                                               const Geometry& g) {
  constexpr int TM = Tl::TM, NS = Tl::NS, WOFF = TM * kKS;  // the weights follow A in a slot
  constexpr int kLag = NS - 1 - Tl::D;  // so that a slot comes back before the lag stalls
  constexpr int kRows = TM / 32;
  const int tid = threadIdx.x - kConsumers;
  const int ohw = g.oh * g.ow, taps = g.kh * g.kw;
  uint32_t st = 0;
  for (int t = blockIdx.x; t < g.n_tiles; t += gridDim.x) {
    const Tile tl = tile_of<TM, Tl::R>(t, g);
    // this thread's rows: tid/4 + 32i, its piece tid%4
    long long row_off[kRows];
    int iy0[kRows], ix0[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = (tid >> 2) + 32 * i;
      const long long m = tl.m0 + row;
      row_off[i] = 0;
      iy0[i] = -(1 << 28);  // past the output: every tap falls outside, zero-filled
      ix0[i] = 0;
      if (m < g.m_total) {
        const int img = static_cast<int>(m / ohw), pix = static_cast<int>(m - (long long)img * ohw);
        const int oy = pix / g.ow, ox = pix - oy * g.ow;
        iy0[i] = oy * g.stride - g.pad;
        ix0[i] = ox * g.stride - g.pad;
        row_off[i] = ((long long)(img * g.h + iy0[i]) * g.w + ix0[i]) * g.cp;
      }
    }
    const int8_t* const w = wq + (size_t)tl.slice * g.stages * Tl::WSTAGE;
    int kc = 0, tap = 0, ky = 0, kx = 0;  // the stage's (chunk, tap)
    for (int s = 0; s < g.stages; ++s, ++st) {
      const uint32_t slot = st % NS;
      if (st >= (uint32_t)NS) mbar_wait(bars.empty + slot * 8, ((st / NS) - 1) & 1);
      const uint32_t a_s = base + g.off_ring + slot * Tl::STAGE;
      if (tid == 0) {
        mbar_expect_tx_only(bars.full + slot * 8, Tl::WSTAGE);
        bulk_load(a_s + WOFF, w + (size_t)s * Tl::WSTAGE, Tl::WSTAGE, bars.full + slot * 8);
      }
      const int piece = tid & 3, ch = kc * 64 + 16 * piece;
      const int off = (ky * g.w + kx) * g.cp + ch;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int iy = iy0[i] + ky, ix = ix0[i] + kx;
        const bool ok = ch < g.cp && (unsigned)iy < (unsigned)g.h && (unsigned)ix < (unsigned)g.w;
        cp_async16(a_s + piece * (TM * 16) + ((tid >> 2) + 32 * i) * 16,
                   ok ? xq + row_off[i] + off : xq, ok);
      }
      if (++tap == taps) {
        tap = 0;
        ++kc;
      }
      if (++kx == g.kw) {
        kx = 0;
        if (++ky == g.kh) ky = 0;
      }
      cp_async_commit();
      if (st >= (uint32_t)kLag) {
        cp_async_wait<kLag>();
        fence_proxy_async();
        mbar_arrive(bars.full + ((st - kLag) % NS) * 8);
      }
    }
  }
  cp_async_wait<0>();
  fence_proxy_async();
  for (uint32_t done = st > (uint32_t)kLag ? st - kLag : 0; done < st; ++done)
    mbar_arrive(bars.full + (done % NS) * 8);
}

// One pass's stores by NT threads: 64 staged channels x the tile's TM
// pixels, VL pixels (16 bytes) a store. A thread keeps one pixel run (its
// output offset decoded once) and steps over the channels. OutT: float
// (f32, or the s32 bits staged as floats) or a 16-bit float type.
template <typename OutT, int TM, int NT, int R>
__device__ __forceinline__ void store_pass(const float* epi, const Tile& tl, const Geometry& g,
                                           int co0, void* out) {
  constexpr bool kHalf = sizeof(OutT) == 2;
  constexpr int VL = 16 / sizeof(OutT);
  constexpr int G = TM / VL;           // runs a channel
  constexpr int CSTEP = NT / G;        // channels a step
  constexpr int PITCH = TM + 4;
  const int ct = threadIdx.x % NT, j0 = (ct % G) * VL;
  const long long ohw = (long long)g.oh * g.ow;
  long long pix;  // the run's offset in its image's first channel
  int limit;      // pixels j0 .. j0 + limit - 1 lie in the output, contiguous
  if (halo_a(R)) {
    const int gy = tl.ty0 + j0 / g.tw, gx = tl.tx0 + j0 % g.tw;
    if (gy >= g.oh || gx >= g.ow) return;
    pix = (long long)tl.img * g.cout * ohw + (long long)gy * g.ow + gx;
    limit = min(VL, g.ow - gx);
  } else {
    const long long m = tl.m0 + j0;
    if (m >= g.m_total) return;
    const long long img = m / ohw, p = m - img * ohw;
    pix = img * g.cout * ohw + p;
    limit = (int)min((long long)VL, min(ohw - p, g.m_total - m));
  }
  const bool vec = limit == VL && pix % VL == 0 && ohw % VL == 0;
  for (int cl = ct / G; cl < kEpiChannels; cl += CSTEP) {
    const int co = co0 + cl;
    if (co >= g.cout) return;
    const float* const src = epi + cl * PITCH + j0;
    const long long idx = pix + co * ohw;
    if (vec) {
      const float4 a = *reinterpret_cast<const float4*>(src);
      if constexpr (kHalf) {
        const float4 b = *reinterpret_cast<const float4*>(src + 4);
        *reinterpret_cast<uint4*>(static_cast<OutT*>(out) + idx) =
            make_uint4(round_pair(a.x, a.y, OutT{}), round_pair(a.z, a.w, OutT{}),
                       round_pair(b.x, b.y, OutT{}), round_pair(b.z, b.w, OutT{}));
      } else {
        *reinterpret_cast<float4*>(static_cast<float*>(out) + idx) = a;  // f32 or s32 bits
      }
      continue;
    }
    for (int e = 0; e < VL; ++e) {
      long long at = idx + e;
      if (e >= limit) {  // a gather tile's run crosses into the next image, or ends
        if (halo_a(R)) break;
        const long long m = tl.m0 + j0 + e;
        if (m >= g.m_total) break;
        const long long img = m / ohw;
        at = (img * g.cout + co) * ohw + (m - img * ohw);
      }
      if constexpr (kHalf)
        static_cast<OutT*>(out)[at] = round_to(src[e], OutT{});
      else
        static_cast<uint32_t*>(out)[at] = __float_as_uint(src[e]);  // f32, or s32 bits
    }
  }
}

// The epilogue of one tile, by the EPI_T threads that computed it (in PP
// the other warpgroup runs its own tile's products meanwhile): acc
// rescaled, staged 64 channels at a time in shared memory as [channel]
// [pixel], and stored as NCHW runs. sc / sh: the tile's NB scales and
// shifts, written here from the (scale, shift) of channel ct that this
// thread loaded while the tile's products ran.
template <class Tl>
__device__ __forceinline__ void epilogue(int (&acc)[Tl::MB][Tl::NB / 2], float* epi,
                                         float2 my_scale, const Tile& tl, const Geometry& g,
                                         void* out, int wg) {
  constexpr int NB = Tl::NB, R = Tl::R, MB = Tl::MB, PITCH = Tl::EPI_PITCH;
  float* const sc = epi + kEpiChannels * PITCH;
  float* const sh = sc + NB;
  const int ct = threadIdx.x % Tl::EPI_T, lane = ct & 31, warp = (ct >> 5) & 3;
  // the staged pixel of accumulator row lane/4 + 8i of this warp's 16, in
  // the tile's 64-pixel block bb
  int jrow[MB][2];
#pragma unroll
  for (int b = 0; b < MB; ++b)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = warp * 16 + (lane >> 2) + 8 * i, bb = Tl::PP ? b : wg;
      if (halo_a(R))
        jrow[b][i] = g.tw == 16 ? (r >> 3) * 16 + 8 * bb + (r & 7)
                                : (8 * bb + (r >> 3)) * 8 + (r & 7);
      else
        jrow[b][i] = 64 * bb + r;
    }
  if (ct < NB) {
    sc[ct] = my_scale.x;
    sh[ct] = my_scale.y;
  }
  const int bar = Tl::PP ? 1 + wg : 1;
#pragma unroll
  for (int pass = 0; pass < NB / kEpiChannels; ++pass) {
    named_sync(bar, Tl::EPI_T);  // sc and sh written; the previous pass's stores have read epi
#pragma unroll
    for (int jn = 0; jn < kEpiChannels / 8; ++jn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = jn * 8 + 2 * (lane & 3) + e;
        const float scale = sc[pass * kEpiChannels + cl], shift = sh[pass * kEpiChannels + cl];
#pragma unroll
        for (int b = 0; b < MB; ++b)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int v = acc[b][(pass * 8 + jn) * 4 + i * 2 + e];
            // (s_x * s_w) first (in sc), then the product, then the bias: no FMA
            epi[cl * PITCH + jrow[b][i]] =
                g.out_kind == kS32 ? __int_as_float(v) : affine(__int2float_rn(v), scale, shift);
          }
      }
    named_sync(bar, Tl::EPI_T);
    const int co0 = tl.slice * NB + pass * kEpiChannels;
    if (g.out_kind == kBF16)
      store_pass<__nv_bfloat16, Tl::TM, Tl::EPI_T, R>(epi, tl, g, co0, out);
    else if (g.out_kind == kF16)
      store_pass<__half, Tl::TM, Tl::EPI_T, R>(epi, tl, g, co0, out);
    else
      store_pass<float, Tl::TM, Tl::EPI_T, R>(epi, tl, g, co0, out);
  }
  if (INT8_CONV_LAG_CYCLES > 0 && warp == 1) {
    const long long until = clock64() + INT8_CONV_LAG_CYCLES;
    while (clock64() < until) {
    }
  }
}

// Consumer warpgroup wg. In PP it takes every other tile of its CTA (one
// warpgroup's epilogue runs beside the other's products), else block wg of
// every tile. Per tile: every K stage into acc with D wgmma groups kept in
// flight, each stage's slot (and the last tap's halo chunk) released D
// stages later; then the epilogue. In PP the two warpgroups take turns at the
// ring (turn[wg]): a warpgroup waits for a tile's first stage only once the
// other has waited for its tile's last, so the ring's stages are waited for
// in order and no mbarrier is waited on a phase ahead of the one filling.
// Each of the 4 warps arrives on the other's turn barrier once it has
// issued its tile's last products, so every warp has passed its own turn
// wait before the other warpgroup can complete that barrier's next phase:
// a warp still storing its previous tile (its leader already a tile ahead)
// never finds turn[wg] two phases on, which a parity wait reads as not yet.
template <class Tl>
__device__ __forceinline__ void consume(uint32_t base, uint8_t* sbase, const Bars& bars,
                                        const Geometry& g, const float* __restrict__ sx,
                                        const float* __restrict__ sw,
                                        const float* __restrict__ bias, void* out, int wg) {
  constexpr int NB = Tl::NB, R = Tl::R, MB = Tl::MB, TM = Tl::TM, NS = Tl::NS;
  const bool leader = threadIdx.x % 128 == 0, warp_lead = threadIdx.x % 32 == 0;
  const int ct = threadIdx.x % Tl::EPI_T;
  // halo routes: stages a chunk serves, and the columns a stage's taps move the halo by
  const int chunks = (g.cp + 63) / 64, spc = g.stages / chunks, dx_step = R == kS2d ? 4 : 1;
  const int step = Tl::PP ? 2 : 1;  // tiles of the CTA's sequence a warpgroup steps over
  const float s_x = *sx;
  float* const epi =
      reinterpret_cast<float*>(sbase + g.off_epi + (Tl::PP ? wg * Tl::EPI : 0));
  int acc[MB][NB / 2];
#pragma unroll
  for (int b = 0; b < MB; ++b)
#pragma unroll
    for (int i = 0; i < NB / 2; ++i) acc[b][i] = 0;
  // descriptors (16-byte units) of A and B at their first slot or chunk; a
  // block's and a k32 step's moves of A
  // (kS2d: K's next 16 bytes are the next tap to the right, the next pixel)
  const uint64_t desc_a = R == kHalo  ? desc(base, g.pl, g.xw * 16)
                          : R == kS2d ? desc(base, 16, g.xw * 16)
                                      : desc(base + g.off_ring, TM * 16, 128);
  const uint64_t desc_b =
      desc(base + g.off_ring + (halo_a(R) ? 0 : TM * kKS), NB * 16, 128);
  const uint32_t a_kstep = R == kHalo ? 2 * g.pl >> 4 : R == kS2d ? 2 : 2 * TM;
  // block 1: pixel columns 8-15 of a 8 x 16 halo tile, rows 8-15 of a 16 x 8
  // one, or rows 64-127 of a gather tile
  const uint32_t bstep = halo_a(R) ? (g.tw == 16 ? 8 : 8 * g.xw) : 64;
  uint32_t a_block[MB];
#pragma unroll
  for (int b = 0; b < MB; ++b) a_block[b] = (Tl::PP ? b : wg) * bstep;
  int k = Tl::PP ? wg : 0;  // the CTA's k-th tile, t = blockIdx.x + k * gridDim.x
  for (int t = blockIdx.x + k * gridDim.x; t < g.n_tiles; t += step * gridDim.x, k += step) {
    const Tile tl = tile_of<TM, R>(t, g);
    if (Tl::PP && k > 0) mbar_wait(bars.turn + wg * 8, ((k - 1) >> 1) & 1);  // the other's k-1
    // (s_x * s_w, bias) of channel ct, loaded while the products run
    float2 my_scale = make_float2(0.f, 0.f);
    const int co = tl.slice * NB + ct;
    if (g.out_kind != kS32 && ct < NB && co < g.cout) {
      my_scale.x = __fmul_rn(s_x, __ldg(sw + co));  // (s_x * s_w) first, as quantize.py:118
      if (bias != nullptr) my_scale.y = __ldg(bias + co);
    }
    uint32_t st = (uint32_t)k * (g.stages / Tl::TPS), hc = (uint32_t)k * chunks, hs = 0;
    uint64_t da_chunk = 0;
    int tap = 0, dx = 0;
    uint32_t tap_off = 0;  // the tap's shift of the halo, in 16-byte units (pixels)
    int held_slot[Tl::D], held_halo[Tl::D];  // the last D slots', oldest first
#pragma unroll
    for (int d = 0; d < Tl::D; ++d) held_slot[d] = held_halo[d] = -1;
#pragma unroll 1
    for (int s = 0; s < g.stages; s += Tl::TPS, ++st) {
      const uint32_t slot = st % NS;
      if (halo_a(R) && tap == 0) {
        hs = hc % kHaloChunks;
        mbar_wait(bars.hfull + hs * 8, (hc / kHaloChunks) & 1);
        ++hc;
        da_chunk = desc_a + hs * (4 * g.pl >> 4);
        tap_off = 0;
        dx = 0;
      }
      const uint64_t db = desc_b + slot * (Tl::STAGE >> 4);
      mbar_wait(bars.full + slot * 8, (st / NS) & 1);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < Tl::TPS; ++j) {
        const uint64_t da = halo_a(R) ? da_chunk + tap_off : desc_a + slot * (Tl::STAGE >> 4);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
          for (int b = 0; b < MB; ++b)
            wgmma_s8(acc[b], da + a_block[b] + kk * a_kstep,
                     db + j * (Tl::SUB >> 4) + kk * (2 * NB), s + j + kk > 0);
        if (halo_a(R)) {
          tap_off += dx_step;
          if ((dx += dx_step) == g.kw) {
            dx = 0;
            tap_off += g.xw - g.kw;
          }
        }
      }
      wgmma_commit();
      // this warp (converged by the .sync.aligned issue) is past its turn wait
      if (Tl::PP && warp_lead && s + Tl::TPS >= g.stages) mbar_arrive(bars.turn + (1 - wg) * 8);
      wgmma_wait<Tl::D>();  // the slot D back is done with
      if (leader && held_slot[0] >= 0) mbar_arrive(bars.empty + held_slot[0] * 8);
      if (leader && held_halo[0] >= 0) mbar_arrive(bars.hempty + held_halo[0] * 8);
#pragma unroll
      for (int d = 0; d + 1 < Tl::D; ++d) {
        held_slot[d] = held_slot[d + 1];
        held_halo[d] = held_halo[d + 1];
      }
      held_slot[Tl::D - 1] = slot;
      held_halo[Tl::D - 1] = -1;
      if (halo_a(R) && (tap += Tl::TPS) == spc) {
        tap = 0;
        held_halo[Tl::D - 1] = (int)hs;  // the chunk's last stage
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int b = 0; b < MB; ++b) fence_regs(acc[b]);
#pragma unroll
    for (int d = 0; d < Tl::D; ++d) {
      if (leader && held_slot[d] >= 0) mbar_arrive(bars.empty + held_slot[d] * 8);
      if (leader && held_halo[d] >= 0) mbar_arrive(bars.hempty + held_halo[d] * 8);
    }
    epilogue<Tl>(acc, epi, my_scale, tl, g, out, wg);
  }
}

template <class Tl>
__global__ void __launch_bounds__(kThreads, 1) int8_conv_kernel(
    const __grid_constant__ CUtensorMap map, const int8_t* __restrict__ xq,
    const int8_t* __restrict__ wq, const float* __restrict__ sw, const float* __restrict__ sx,
    const float* __restrict__ bias, void* __restrict__ out, const Geometry g) {
  constexpr int R = Tl::R, NS = Tl::NS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 127) & ~127u;
  uint8_t* const sbase = smem_raw + (base - raw);
  const Bars bars{base + g.off_bar, base + g.off_bar + NS * 8, base + g.off_bar + 2 * NS * 8,
                  base + g.off_bar + (2 * NS + kHaloChunks) * 8,
                  base + g.off_bar + (2 * NS + 2 * kHaloChunks) * 8};
  if (threadIdx.x == 0) {
    const int consumers = Tl::PP ? 1 : 2;  // warpgroups that give a slot or a chunk back
    for (int i = 0; i < NS; ++i) {
      mbar_init(bars.full + i * 8, halo_a(R) ? 1 : 128);  // gather: each producer thread
      mbar_init(bars.empty + i * 8, consumers);
    }
    for (int i = 0; i < kHaloChunks; ++i) {
      mbar_init(bars.hfull + i * 8, 1);
      mbar_init(bars.hempty + i * 8, consumers);
    }
    mbar_init(bars.turn, 4);  // a consumer warpgroup's warps
    mbar_init(bars.turn + 8, 4);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // the warpgroup index, made warp-uniform for the compiler
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  // registers a thread: the producer gives its own to the consumers
  // (halo: 128 x 40 + 256 x 232 <= 65536; gather: 128 x 56 + 256 x 224)
  if (wg == 2) {
    if constexpr (halo_a(R)) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
      if (threadIdx.x == kConsumers) produce_halo<Tl>(&map, wq, base, bars, g);
    } else {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 56;");
      produce_gather<Tl>(xq, wq, base, bars, g);
    }
  } else {
    if constexpr (halo_a(R)) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    } else {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 224;");
    }
    consume<Tl>(base, sbase, bars, g, sx, sw, bias, out, wg);
  }
}

int sm_count() {
  static int sms[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 0;
  if (sms[dev] == 0) cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev];
}

// A 4-D tensor map of the NHWC int8 scratch (N, H, W, Cp) with boxes of
// 16 channels x the halo's pixels.
int encode_halo(CUtensorMap* map, const int8_t* xq, const Geometry& g) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)g.cp, (cuuint64_t)g.w, (cuuint64_t)g.h,
                              (cuuint64_t)g.n_img};
  const cuuint64_t strides[3] = {(cuuint64_t)g.cp, (cuuint64_t)g.w * g.cp,
                                 (cuuint64_t)g.h * g.w * g.cp};
  const cuuint32_t box[4] = {16, (cuuint32_t)g.xw, (cuuint32_t)(g.th + g.kh - 1), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<int8_t*>(xq), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

// Launch instantiation Tl with the plan's layout in g (off_ring, off_epi,
// off_bar, smem; the halo's tile th x tw and plane bytes pl), refused where
// it cannot hold Tl's halo chunks, ring, epilogues and barriers or passes
// the card's limit.
template <class Tl>
int launch(Geometry g, const int8_t* xq, const int8_t* wq, const float* sw, const float* sx,
           const float* bias, void* out, cudaStream_t stream) {
  const int nsl = (g.cout + Tl::NB - 1) / Tl::NB;
  bool fits = g.off_ring >= 0 && g.off_epi >= g.off_ring + Tl::NS * Tl::STAGE &&
              g.off_bar >= g.off_epi + Tl::N_EPI * Tl::EPI &&
              g.smem >= g.off_bar + Tl::BARS + 128 && g.smem <= kSmemLimit;  // 128: alignment
  if (halo_a(Tl::R)) {
    g.xw = g.tw + g.kw - 1;
    fits = fits && (g.tw == 8 || g.tw == 16) && g.tw * g.th == Tl::TM && g.pl % 128 == 0 &&
           g.pl >= (g.th + g.kh - 1) * g.xw * 16 && g.off_ring >= kHaloChunks * 4 * g.pl;
    g.tiles_w = (g.ow + g.tw - 1) / g.tw;
    g.tiles_per_img = g.tiles_w * ((g.oh + g.th - 1) / g.th);
    g.tiles_px = g.tiles_per_img * g.n_img;
  } else {
    g.tiles_px = (int)((g.m_total + Tl::TM - 1) / Tl::TM);
  }
  if (!fits) return (int)cudaErrorInvalidValue;
  g.n_tiles = g.tiles_px * nsl;
  CUtensorMap map{};
  if (halo_a(Tl::R)) {
    const int rc = encode_halo(&map, xq, g);
    if (rc != 0) return rc;
  }
  auto kernel = int8_conv_kernel<Tl>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
  if (err != cudaSuccess) return (int)err;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const int grid = g.n_tiles < sms ? g.n_tiles : sms;
  kernel<<<grid, kThreads, g.smem, stream>>>(map, xq, wq, sw, sx, bias, out, g);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_quantize(const T* x, const float* sx, int n_img, int c_in, int hw, int cp,
                    int8_t* xq, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int vec = hw % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (cp % 16 != 0 || cp < c_in) return (int)cudaErrorInvalidValue;
  if (V == 4 || hw > 64) {
    const dim3 grid((hw + 16 * V - 1) / (16 * V), (cp + 63) / 64, n_img);
    quantize_nhwc_kernel<T, V><<<grid, kQThreads, 0, stream>>>(x, sx, c_in, hw, cp, vec, xq);
  } else {  // 16-bit at most 64 pixels: 8-byte runs, a block's 64 pixels
    const int vec8 = hw % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 8 == 0;
    const dim3 grid((hw + 63) / 64, (cp + 63) / 64, n_img);
    quantize_nhwc_kernel<T, 4><<<grid, kQThreads, 0, stream>>>(x, sx, c_in, hw, cp, vec8, xq);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_quantize_s2d(const T* x, const float* sx, int n_img, int c_in, int h, int w,
                        int8_t* xq, cudaStream_t stream) {
  if (c_in > 4) return (int)cudaErrorInvalidValue;
  const int h2 = (h + 1) / 2, w2 = (w + 1) / 2;
  const int vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const dim3 grid((h2 * ((w2 + 1) / 2) + kQThreads - 1) / kQThreads, n_img);
  quantize_s2d_kernel<T><<<grid, kQThreads, 0, stream>>>(x, sx, c_in, h, w, h2, w2, vec, xq);
  return static_cast<int>(cudaGetLastError());
}

// K stages of one output-channel slice, as ops/kernels/int8_conv.py's
// pack_weight lays them out: (64-channel chunk, tap) (kS2d: 16 channels, 4
// taps a stage).
int k_stages(int route, int cp, int kh, int kw) {
  return route == kS2d ? kh * kw / 4 : (cp + 63) / 64 * kh * kw;
}

// The instantiations (route, NB, TPS, NS) that the wrapper's plan() picks
// from (int8_conv.py's RINGS, which a CPU test holds equal to this list):
// the halo route below 256 channels takes a kernel row (3 taps) a slot, to
// spend its barriers on 3x the products.
#define INT8_CONV_KERNELS(X)                                                      \
  X(kHalo, 64, 3, 8) X(kHalo, 128, 3, 4) X(kHalo, 256, 1, 8)                      \
  X(kS2d, 64, 1, 8) X(kS2d, 128, 1, 8) X(kS2d, 256, 1, 8)                         \
  X(kGather16, 64, 1, 8) X(kGather16, 128, 1, 8) X(kGather16, 256, 1, 6)

int launch_conv(int out_kind, const int8_t* xq, const int8_t* wq, const float* sw,
                const float* sx, const float* bias, void* out, int n_img, int h, int w, int cp,
                int cout, int kh, int kw, int stride, int pad, int oh, int ow, int route, int nb,
                int tps, int ns, int tw, int th, int plane, int off_ring, int off_epi,
                int off_bar, int smem, cudaStream_t stream) {
  Geometry g{};
  g.n_img = n_img, g.h = h, g.w = w, g.cp = cp, g.cout = cout, g.kh = kh, g.kw = kw;
  g.stride = stride, g.pad = pad, g.oh = oh, g.ow = ow, g.out_kind = out_kind;
  g.stages = k_stages(route, cp, kh, kw);
  g.tw = tw, g.th = th, g.pl = plane;
  g.off_ring = off_ring, g.off_epi = off_epi, g.off_bar = off_bar, g.smem = smem;
  g.m_total = (long long)n_img * oh * ow;
  // the geometry each route's A operand takes
  const bool takes = cp % 16 == 0 && (route == kHalo ? kh == 3 && kw == 3 && stride == 1
                                      : route == kS2d ? cp == 16 && kw % 4 == 0 && stride == 1
                                                      : route == kGather16);
  if (!takes) return (int)cudaErrorInvalidValue;
#define INT8_CONV_LAUNCH(r, NB, TPS, NS)                                                 \
  if (route == r && nb == NB && tps == TPS && ns == NS)                                  \
    return launch<Tiling<NB, r, TPS, NS>>(g, xq, wq, sw, sx, bias, out, stream);
  INT8_CONV_KERNELS(INT8_CONV_LAUNCH)
#undef INT8_CONV_LAUNCH
  return (int)cudaErrorInvalidValue;  // an instantiation that is not compiled
}

}  // namespace

extern "C" int int8_quantize_f32(const float* x, const float* sx, int n_img, int c_in, int hw,
                                 int cp, int8_t* xq, void* stream) {
  return launch_quantize(x, sx, n_img, c_in, hw, cp, xq, (cudaStream_t)stream);
}

extern "C" int int8_quantize_bf16(const __nv_bfloat16* x, const float* sx, int n_img, int c_in,
                                  int hw, int cp, int8_t* xq, void* stream) {
  return launch_quantize(x, sx, n_img, c_in, hw, cp, xq, (cudaStream_t)stream);
}

extern "C" int int8_quantize_f16(const __half* x, const float* sx, int n_img, int c_in, int hw,
                                 int cp, int8_t* xq, void* stream) {
  return launch_quantize(x, sx, n_img, c_in, hw, cp, xq, (cudaStream_t)stream);
}

// x: (N, Cin <= 4, H, W); xq: (N, ceil(H/2), ceil(W/2), 16), every byte written
extern "C" int int8_quantize_s2d_f32(const float* x, const float* sx, int n_img, int c_in, int h,
                                     int w, int8_t* xq, void* stream) {
  return launch_quantize_s2d(x, sx, n_img, c_in, h, w, xq, (cudaStream_t)stream);
}

extern "C" int int8_quantize_s2d_bf16(const __nv_bfloat16* x, const float* sx, int n_img,
                                      int c_in, int h, int w, int8_t* xq, void* stream) {
  return launch_quantize_s2d(x, sx, n_img, c_in, h, w, xq, (cudaStream_t)stream);
}

extern "C" int int8_quantize_s2d_f16(const __half* x, const float* sx, int n_img, int c_in,
                                     int h, int w, int8_t* xq, void* stream) {
  return launch_quantize_s2d(x, sx, n_img, c_in, h, w, xq, (cudaStream_t)stream);
}

// xq: (N, H, W, Cp) int8; wq: pack_weight's (Cout/NB, stages, 4, NB, 16)
// int8; sw (Cout,), sx (1,), bias (Cout,) or null: float32; out: (N, Cout,
// OH, OW) of the entry's type. route: 0 halo, 1 gather16, 2 s2d (xq the
// space-to-depth scratch, H, W, Cp = 16, the kernel, stride 1 and the
// padding those of the stride-1 convolution over it); then the plan's
// instantiation (nb, tps, ns) and layout: the halo tile tw x th (0 x 0
// gathering) and its plane bytes, the ring's, the epilogues' and the
// barriers' offsets and the dynamic shared memory, in bytes. Returns a
// cudaError_t, or 10000 + the CUresult of a failed tensor-map encode.
#define INT8_CONV_ENTRY(name, kind)                                                           \
  extern "C" int name(const int8_t* xq, const int8_t* wq, const float* sw, const float* sx,   \
                      const float* bias, void* out, int n_img, int h, int w, int cp,          \
                      int cout, int kh, int kw, int stride, int pad, int oh, int ow,          \
                      int route, int nb, int tps, int ns, int tw, int th, int plane,          \
                      int off_ring, int off_epi, int off_bar, int smem, void* stream) {       \
    return launch_conv(kind, xq, wq, sw, sx, bias, out, n_img, h, w, cp, cout, kh, kw,        \
                       stride, pad, oh, ow, route, nb, tps, ns, tw, th, plane, off_ring,      \
                       off_epi, off_bar, smem, (cudaStream_t)stream);                         \
  }

INT8_CONV_ENTRY(int8_conv_f32, kF32)
INT8_CONV_ENTRY(int8_conv_bf16, kBF16)
INT8_CONV_ENTRY(int8_conv_f16, kF16)
INT8_CONV_ENTRY(int8_conv_s32, kS32)
