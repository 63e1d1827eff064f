// Fused eval-mode ResNet basic block, bfloat16, at C = 256 and 512, as two
// implicit-GEMM 3x3 convolutions on Hopper's tensor cores (sm_90a: wgmma,
// TMA, mbarriers).
//
// Replaces, for bf16 at C = 256 and 512, the TPU kernel
// multiagentperception_tpu/ops/pallas/fused_block.py:201 (fused_basic_block,
// body _kernel_plain at :156):
//     out = relu(s2 * conv2(y1) + b2 + x),  y1 = bf16(relu(s1 * conv1(x) + b1))
// 3x3 stride-1 convs, zero padding at the image border (conv2 reads zeros
// there too, never relu(b1)), NHWC activations, weights pre-arranged by the
// entry point's first kernel (the layout of fused_block.wgmma_conv_weights),
// (s, b) and the residual in float.
//
// Bound on the H100: operations. The block does 4*B*H*W*9*C^2 operations,
// 0.2931 ms at 989 TFLOP/s at both bench geometries (B=120 at 32x32x256
// and 16x16x512); x and out take 0.0751 ms at 3.35 TB/s.
//
// Why not fused. At these widths a tile's halo, its y1 ring and one tap's
// weights over all C channels do not fit 227 KB (a 512 x 512 tap alone is
// 512 KB), and y1 is cheap to move: it is B*H*W*C bf16 values, 31.5 MB at
// both bench geometries, written once and read once by TMA (62.9 MB,
// ~0.019 ms each way at 3.35 TB/s, 13% of the bound together; much of it
// stays in the 50 MB L2). So the entry point launches one kernel twice:
// conv1 over x, whose epilogue stores y1 to a scratch tensor, then conv2
// over y1, whose epilogue adds the residual. TMA's zero fill outside the
// image is conv1's padding and conv2's: y1 exists only inside the image.
//
// Design of one conv, an implicit GEMM: M = output pixels, N = output
// channels, K = 9 taps x C input channels, on the skeleton of
// csrc/conv3x3.cuh. A persistent grid (one CTA per SM) walks over tiles of
// TH x TW = 8 x 16 pixels x NB = 128 output channels, the channel slice
// slowest, so the CTAs in flight share one slice of weights in L2.
// Warpgroup 2 is the producer (one thread issues the copies; the warpgroup
// hands its registers to the others with setmaxnreg), warpgroups 0 and 1
// the consumers.
// - The producer loads the tile's (TH+2) x (TW+2) halo one chunk of 64
//   input channels at a time by TMA (8 boxes of 8 channels, so shared memory
//   holds a chunk as 8 planes of [pixel][8 channels]) into a ring of NH
//   chunks, and streams the weights in stages of one tap x 64 input x NB
//   output channels (cp.async.bulk) through a ring of NS stages; mbarriers
//   guard both rings. A chunk serves 9 stages, one per tap.
// - Consumer warpgroup w owns the 8 x 8 pixels of columns 8w..8w+7 (M =
//   64) and all NB channels: wgmma.mma_async m64n128k16 f32 += bf16 x bf16
//   with both operands in shared memory. A is a descriptor into the halo
//   chunk: core matrix i (8 rows of 16 bytes) is tile row i, 8 neighbouring
//   pixels of a halo row, so the stride between core matrices is the halo's
//   pitch (SBO = (TW+2)*16 bytes), and a tap moves the start by
//   (dy*(TW+2) + dx)*16 bytes: no im2col copy and no wasted rows.
// - Precision: the tensor cores sum one stage (64 products of a tap) into
//   `part`, and CUDA-core float adds sum the stages into `acc`, as on the
//   C = 64/128 routes (csrc/fused_block_wgmma.cu's conv()): the tensor
//   cores' float32 accumulation drops bits beyond its alignment.
// - Epilogue: acc * s + b (no FMA contraction, as the plain version
//   rounds), + the residual read from x (conv2), relu, bf16 pairs stored.
// - Shared memory: NH = 2 chunks x 8 planes x 2944 B + NS = 10 stages x
//   16 KB = 211,232 B with the barriers (of 232,448).
// - Waves: bench layer3 has 1920 tiles, layer4 960 (14.5 and 7.3 waves on
//   132 SMs).

#include <cuda_bf16.h>

#include "conv3x3.cuh"

namespace {

template <int C_>
struct Geo {
  using T = __nv_bfloat16;
  static constexpr int C = C_;
  static constexpr int TH = 8, TW = 16, XH = TH + 2, XW = TW + 2;
  static constexpr int NB = 128;      // output channels of a tile
  static constexpr int NSL = C / NB;  // channel slices
  static constexpr int KC = C / 64;   // 64-channel chunks of K
  static constexpr int G = 8;         // planes of 8 channels in a chunk
  static constexpr int PL = round128(XH * XW * 16);  // plane bytes (TMA: 128-aligned)
  static constexpr int CHUNK = G * PL;
  static constexpr int HALO_TX = G * XH * XW * 16;
  static constexpr int NH = 2;  // halo chunks in flight
  static constexpr int STAGE = 64 * NB * 2;
  static constexpr int NS = 10;  // weight stages in flight
  static constexpr int OFF_W = NH * CHUNK;
  static constexpr int OFF_BAR = OFF_W + NS * STAGE;
  static constexpr int SMEM = OFF_BAR + (2 * NS + 2 * NH) * 8 + 128;  // + 128 to align
};

// Consumer warpgroup WG: per tile, the 9 x KC stages into acc, then the
// epilogue of its 64 pixels x NB channels.
template <class Gm, int WG, bool RES>
__device__ __forceinline__ void consume(uint8_t*, uint32_t base, const Bars& bars,
                                        const float* __restrict__ s,
                                        const float* __restrict__ b,
                                        const typename Gm::T* __restrict__ res,
                                        typename Gm::T* __restrict__ out, int H, int W,
                                        int tiles_w, int tiles_per_img, int tiles_px,
                                        int n_tiles) {
  constexpr int C = Gm::C, NB = Gm::NB;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const bool leader = tid == 0;
  float acc[NB / 2], part[NB / 2];
  uint32_t st = 0, hc = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const Tile tl = tile_of(t, tiles_w, tiles_per_img, tiles_px, Gm::TH, Gm::TW);
#pragma unroll
    for (int i = 0; i < NB / 2; ++i) acc[i] = 0.f;
#pragma unroll 1
    for (int kc = 0; kc < Gm::KC; ++kc, ++hc) {
      const uint32_t hs = hc % Gm::NH;
      mbar_wait(bars.hfull + hs * 8, (hc / Gm::NH) & 1);
      const uint32_t a_chunk = base + hs * Gm::CHUNK + 8 * WG * 16;  // columns 8WG..8WG+7
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap, ++st) {
        const uint32_t slot = st % Gm::NS;
        mbar_wait(bars.full + slot * 8, (st / Gm::NS) & 1);
        const uint32_t a = a_chunk + ((tap / 3) * Gm::XW + tap % 3) * 16;
        const uint32_t bw = base + Gm::OFF_W + slot * Gm::STAGE;
        fence_regs(part);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma(part, desc(a + 2 * kk * Gm::PL, Gm::PL, Gm::XW * 16),
                desc(bw + kk * 2 * NB * 16, NB * 16, 128), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(part);
#pragma unroll
        for (int i = 0; i < NB / 2; ++i) acc[i] += part[i];
        if (leader) mbar_arrive(bars.empty + slot * 8);  // this warpgroup is done with it
      }
      if (leader) mbar_arrive(bars.hempty + hs * 8);
    }
    // row lane/4 + 8i of this warp's 16: tile row 2*warp + i, column 8WG + lane/4
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int gy = tl.ty0 + 2 * warp + i, gx = tl.tx0 + 8 * WG + lane / 4;
      if (gy >= H || gx >= W) continue;
      const size_t px = (((size_t)tl.img * H + gy) * W + gx) * C + tl.ns * NB;
      const float* const sn = s + tl.ns * NB;
      const float* const bn = b + tl.ns * NB;
#pragma unroll
      for (int n8 = 0; n8 < NB / 8; ++n8) {
        const int c = n8 * 8 + (lane % 4) * 2;
        float v0 = affine(acc[n8 * 4 + i * 2], __ldg(sn + c), __ldg(bn + c));
        float v1 = affine(acc[n8 * 4 + i * 2 + 1], __ldg(sn + c + 1), __ldg(bn + c + 1));
        if (RES) {
          const float2 r =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(res + px + c));
          v0 += r.x;
          v1 += r.y;
        }
        *reinterpret_cast<__nv_bfloat162*>(out + px + c) =
            __floats2bfloat162_rn(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
      }
    }
  }
}

// Both convs' HWIO float32 weights w1, w2 (3, 3, C, C) rounded to bf16 as
// the producer streams them: one thread per 8 input channels of an output
// channel, at (conv, slice, chunk, tap, K group, output channel) of wk.
template <class Gm>
__global__ void arrange_weights(const float* __restrict__ w1, const float* __restrict__ w2,
                                typename Gm::T* __restrict__ wk) {
  constexpr int C = Gm::C, NB = Gm::NB, KC = Gm::KC, NSL = Gm::NSL;
  const int n = 2 * 9 * C * C / 8;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    int r = i;
    const int co = r % NB;
    r /= NB;
    const int g = r % 8;
    r /= 8;
    const int tap = r % 9;
    r /= 9;
    const int kc = r % KC;
    r /= KC;
    const int ns = r % NSL;
    const float* const src = (r / NSL == 0 ? w1 : w2) + ((size_t)tap * C + kc * 64 + g * 8) * C +
                             ns * NB + co;
    __align__(16) __nv_bfloat16 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __float2bfloat16_rn(src[(size_t)j * C]);
    *reinterpret_cast<uint4*>(wk + (size_t)i * 8) = *reinterpret_cast<const uint4*>(v);
  }
}

}  // namespace

// x, out, y1 (scratch): (B, H, W, C) bf16 NHWC; w1, w2: (3, 3, C, C) HWIO
// float32; wk (scratch): both convs' weights rounded to bf16 and arranged as
// (2, C/128, C/64, 9, 8, 128, 8) = [conv][128-channel output slice]
// [64-channel K chunk][tap][8-channel K group][output channel][8 input
// channels] (fused_block.wgmma_conv_weights); sb: (4, C) float = s1, b1,
// s2, b2. C in {256, 512}. Launches the arrangement, conv1 (x -> y1) and
// conv2 (y1 -> out) on `stream`. Returns a cudaError_t, or 10000 + the
// CUresult of a failed tensor-map encode.
extern "C" int fused_basic_block_wgmma_conv(const void* x, const float* w1, const float* w2,
                                            void* wk, const float* sb, void* y1, void* out,
                                            int B, int H, int W, int C, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (C == 256) return launch<Geo<256>>(x, w1, w2, wk, sb, y1, out, B, H, W, st);
  if (C == 512) return launch<Geo<512>>(x, w1, w2, wk, sb, y1, out, B, H, W, st);
  return (int)cudaErrorInvalidValue;
}
