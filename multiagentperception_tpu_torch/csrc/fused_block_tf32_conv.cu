// Fused eval-mode ResNet basic block, float32, at C = 256 and 512, as two
// implicit-GEMM 3x3 convolutions on Hopper's tensor cores with
// error-compensated 3xTF32 products (sm_90a: wgmma, TMA, mbarriers).
//
// Replaces, for float32 at C = 256 and 512, the TPU kernel
// multiagentperception_tpu/ops/pallas/fused_block.py:201 (fused_basic_block,
// body _kernel_plain at :156):
//     out = relu(s2 * conv2(y1) + b2 + x),  y1 = relu(s1 * conv1(x) + b1)
// 3x3 stride-1 convs, zero padding at the image border (conv2 reads zeros
// there too, never relu(b1)), NHWC float32, weights split and arranged by
// the entry point's first kernel (the layout of
// fused_block.tf32x3_conv_weights), (s, b), the sums and the residual in
// float.
//
// Precision, as csrc/fused_block_tf32.cu: each operand v is split into TF32
// hi = rna(v) and lo = rna(v - hi), a product is hi*hi + hi*lo + lo*hi on the
// tensor cores (small terms first), the tensor cores sum one stage (a tap x
// 32 input channels) into `part`, and CUDA-core float adds sum the stages.
//
// Bound on the H100: operations. 4*B*H*W*9*C^2 operations, three TF32
// products each: 0.1757 ms at 495 TFLOP/s at both eval geometries (B=12 at
// 32x32x256 and 16x16x512); x, out and the weights take under 0.01 ms at
// 3.35 TB/s.
//
// Why not fused: see csrc/fused_block_wgmma_conv.cu. Here y1 is B*H*W*C
// floats, 12.6 MB at both eval geometries: written once and read once it
// stays in the 50 MB L2 (from device memory it would cost ~0.0075 ms, 4% of
// the bound). The entry point launches one kernel twice: conv1 over x into
// y1, conv2 over y1 with the residual.
//
// Design of one conv, an implicit GEMM (M = pixels, N = output channels,
// K = 9 taps x C) on the skeleton of csrc/conv3x3.cuh: a persistent grid
// walks over tiles of 8 x 8 pixels x NB = 64 output channels, the channel
// slice slowest. Small tiles keep the eval's layer4 (12 x 16 x 16 pixels x
// 512 channels) at 384 tiles, 2.9 waves on 132 SMs; the two consumer
// warpgroups then split K instead of M or N: in each stage warpgroup w
// takes input channels 32w..32w+31, and at the end of a tile they exchange
// halves of their sums through shared memory and each stores 32 channels.
// - The producer warpgroup (one thread; setmaxnreg hands its registers
//   away) loads the tile's 10 x 10 halo one chunk of 64 input channels at a
//   time by TMA (16 boxes of 4 channels: 16 planes of [pixel][4 floats]),
//   into a ring of NH chunks, and streams weight stages (one tap x 64 input
//   x NB output channels, hi then lo, 32 KB) by cp.async.bulk through a ring
//   of NS stages; a chunk serves 9 stages.
// - A comes from registers, as in csrc/fused_block_tf32.cu: each thread
//   loads its 4 values of the 64 x 8 fragment from the planes (a warp reads
//   128 contiguous bytes a plane), splits them and feeds hi or lo;
//   wgmma.mma_async m64n64k8 f32 += tf32 x tf32, B ([4-channel K groups]
//   [NB][4], K-major) in shared memory.
// - Shared memory: 2 chunks x 16 x 1664 B + 4 stages x 32 KB + a 16 KB
//   exchange = 200,928 B with the barriers (of 232,448).

#include "conv3x3.cuh"

namespace {

template <int C_>
struct Geo {
  using T = float;
  static constexpr int C = C_;
  static constexpr int TH = 8, TW = 8, XH = TH + 2, XW = TW + 2;
  static constexpr int NB = 64;       // output channels of a tile
  static constexpr int NSL = C / NB;  // channel slices
  static constexpr int KC = C / 64;   // 64-channel chunks of K
  static constexpr int G = 16;        // planes of 4 channels in a chunk
  static constexpr int PL = round128(XH * XW * 16);  // plane bytes (TMA: 128-aligned)
  static constexpr int CHUNK = G * PL;
  static constexpr int HALO_TX = G * XH * XW * 16;
  static constexpr int NH = 2;            // halo chunks in flight
  static constexpr int HALF = 16 * NB * 16;  // hi (or lo) of a stage: 16 K groups x NB x 4
  static constexpr int STAGE = 2 * HALF;
  static constexpr int NS = 4;  // weight stages in flight
  static constexpr int OFF_W = NH * CHUNK;
  static constexpr int OFF_X = OFF_W + NS * STAGE;  // the warpgroups' exchange
  static constexpr int X_BYTES = 2 * 16 * 128 * 4;
  static constexpr int OFF_BAR = OFF_X + X_BYTES;
  static constexpr int SMEM = OFF_BAR + (2 * NS + 2 * NH) * 8 + 128;  // + 128 to align
};

// This thread's four values of the A fragment of k-step kk: rows lane/4 and
// lane/4 + 8 (at a0, a1), channels lane%4 (plane 2kk) and lane%4 + 4 (plane
// 2kk + 1).
template <class Gm>
__device__ __forceinline__ void load_a(float (&raw)[4], const uint8_t* a0, const uint8_t* a1,
                                       int kk) {
  const int p = 2 * kk * Gm::PL;
  raw[0] = *reinterpret_cast<const float*>(a0 + p);
  raw[1] = *reinterpret_cast<const float*>(a1 + p);
  raw[2] = *reinterpret_cast<const float*>(a0 + p + Gm::PL);
  raw[3] = *reinterpret_cast<const float*>(a1 + p + Gm::PL);
}

// Consumer warpgroup WG: per tile, its half of every stage's K into acc,
// the exchange, then the epilogue of 64 pixels x its 32 channels.
template <class Gm, int WG, bool RES>
__device__ __forceinline__ void consume(uint8_t* sbase, uint32_t base, const Bars& bars,
                                        const float* __restrict__ s,
                                        const float* __restrict__ b,
                                        const typename Gm::T* __restrict__ res,
                                        typename Gm::T* __restrict__ out, int H, int W,
                                        int tiles_w, int tiles_per_img, int tiles_px,
                                        int n_tiles) {
  constexpr int C = Gm::C, NB = Gm::NB;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const bool leader = tid == 0;
  // byte offsets in a plane of this thread's rows (tile rows 2*warp + i,
  // column lane/4) at tap (0, 0), and of its column
  uint32_t row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) row[i] = ((2 * warp + i) * Gm::XW + lane / 4) * 16 + (lane % 4) * 4;
  float* const xch = reinterpret_cast<float*>(sbase + Gm::OFF_X);
  float acc[32], part[32];
  uint32_t st = 0, hc = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const Tile tl = tile_of(t, tiles_w, tiles_per_img, tiles_px, Gm::TH, Gm::TW);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll 1
    for (int kc = 0; kc < Gm::KC; ++kc, ++hc) {
      const uint32_t hs = hc % Gm::NH;
      mbar_wait(bars.hfull + hs * 8, (hc / Gm::NH) & 1);
      const uint8_t* const a_chunk = sbase + hs * Gm::CHUNK + 8 * WG * Gm::PL;  // its channels
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap, ++st) {
        const uint32_t slot = st % Gm::NS;
        mbar_wait(bars.full + slot * 8, (st / Gm::NS) & 1);
        const uint32_t b_hi = base + Gm::OFF_W + slot * Gm::STAGE + 8 * WG * NB * 16;
        const uint32_t b_lo = b_hi + Gm::HALF;
        const uint8_t* const a_tap = a_chunk + ((tap / 3) * Gm::XW + tap % 3) * 16;
        const uint8_t* const a0 = a_tap + row[0];
        const uint8_t* const a1 = a_tap + row[1];
        float raw[4];
        uint32_t hi[2][4], lo[2][4];
        load_a<Gm>(raw, a0, a1, 0);
        fence_regs(part);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int bb = kk & 1;
          if (kk >= 2) wgmma_wait<1>();  // step kk - 2, which read hi[bb] and lo[bb], is done
          split(raw, hi[bb], lo[bb]);
          if (kk + 1 < 4) load_a<Gm>(raw, a0, a1, kk + 1);
          const uint32_t kb = 2 * kk * NB * 16;  // the step's two K groups of B
          wgmma_fence();
          wgmma_tf32(part, lo[bb], desc(b_hi + kb, NB * 16, 128), kk > 0);
          wgmma_tf32(part, hi[bb], desc(b_lo + kb, NB * 16, 128), 1);
          wgmma_tf32(part, hi[bb], desc(b_hi + kb, NB * 16, 128), 1);
          wgmma_commit();
        }
        wgmma_wait<0>();
        fence_regs(part);
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] += part[i];
        if (leader) mbar_arrive(bars.empty + slot * 8);  // this warpgroup is done with it
      }
      if (leader) mbar_arrive(bars.hempty + hs * 8);
    }
    // The exchange: warpgroup WG keeps channels 32WG.. (acc[16WG..16WG+15])
    // and hands the other 32 to its peer. Both hold the same (row, column)
    // in the same register of the same thread index.
    named_sync(1, kConsumers);  // the peer is done reading the last tile's exchange
#pragma unroll
    for (int i = 0; i < 16; ++i) xch[(WG * 16 + i) * 128 + tid] = acc[16 * (1 - WG) + i];
    named_sync(1, kConsumers);
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[16 * WG + i] += xch[((1 - WG) * 16 + i) * 128 + tid];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int gy = tl.ty0 + 2 * warp + i, gx = tl.tx0 + lane / 4;
      if (gy >= H || gx >= W) continue;
      const size_t px = (((size_t)tl.img * H + gy) * W + gx) * C + tl.ns * NB;
      const float* const sn = s + tl.ns * NB;
      const float* const bn = b + tl.ns * NB;
#pragma unroll
      for (int n8 = 4 * WG; n8 < 4 * WG + 4; ++n8) {
        const int c = n8 * 8 + (lane % 4) * 2;
        float v0 = affine(acc[n8 * 4 + i * 2], __ldg(sn + c), __ldg(bn + c));
        float v1 = affine(acc[n8 * 4 + i * 2 + 1], __ldg(sn + c + 1), __ldg(bn + c + 1));
        if (RES) {
          const float2 r = __ldg(reinterpret_cast<const float2*>(res + px + c));
          v0 += r.x;
          v1 += r.y;
        }
        *reinterpret_cast<float2*>(out + px + c) = make_float2(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
      }
    }
  }
}

// Both convs' HWIO float32 weights w1, w2 (3, 3, C, C) split into TF32 hi
// and lo as the producer streams them: one thread per 4 input channels of
// an output channel, at (conv, slice, chunk, tap, K group, output channel).
template <class Gm>
__global__ void arrange_weights(const float* __restrict__ w1, const float* __restrict__ w2,
                                typename Gm::T* __restrict__ wk) {
  constexpr int C = Gm::C, NB = Gm::NB, KC = Gm::KC, NSL = Gm::NSL;
  const int n = 2 * 9 * C * C / 4;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    int r = i;
    const int co = r % NB;
    r /= NB;
    const int g = r % 16;
    r /= 16;
    const int tap = r % 9;
    r /= 9;
    const int kc = r % KC;
    r /= KC;
    const int ns = r % NSL;
    const float* const src = (r / NSL == 0 ? w1 : w2) + ((size_t)tap * C + kc * 64 + g * 4) * C +
                             ns * NB + co;
    float v[4];
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = src[(size_t)j * C];
    split(v, hi, lo);
    // the stage (i / (16 * NB)) holds hi, then lo, each [16 groups][NB][4]
    float* const dst = wk + (size_t)(i / (16 * NB)) * (2 * 16 * NB * 4) + (i % (16 * NB)) * 4;
    *reinterpret_cast<uint4*>(dst) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(dst + 16 * NB * 4) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

}  // namespace

// x, out, y1 (scratch): (B, H, W, C) float32 NHWC; w1, w2: (3, 3, C, C)
// HWIO float32; wk (scratch): both convs' weights split into TF32 hi and lo
// and arranged as (2, C/64, C/64, 9, 2, 16, 64, 4) = [conv][64-channel
// output slice][64-channel K chunk][tap][hi, lo][4-channel K group][output
// channel][4 input channels] (fused_block.tf32x3_conv_weights); sb: (4, C)
// float = s1, b1, s2, b2. C in {256, 512}. Launches the arrangement, conv1
// (x -> y1) and conv2 (y1 -> out) on `stream`. Returns a cudaError_t, or
// 10000 + the CUresult of a failed tensor-map encode.
extern "C" int fused_basic_block_tf32x3_conv(const void* x, const float* w1, const float* w2,
                                             void* wk, const float* sb, void* y1, void* out,
                                             int B, int H, int W, int C, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (C == 256) return launch<Geo<256>>(x, w1, w2, wk, sb, y1, out, B, H, W, st);
  if (C == 512) return launch<Geo<512>>(x, w1, w2, wk, sb, y1, out, B, H, W, st);
  return (int)cudaErrorInvalidValue;
}
