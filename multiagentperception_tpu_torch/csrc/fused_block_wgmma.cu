// Fused eval-mode ResNet basic block, bfloat16, on Hopper's tensor cores
// (sm_90a: wgmma, TMA, mbarriers). C in {64, 128}.
//
// Replaces, for bf16 at C = 64 and 128, the TPU kernel
// multiagentperception_tpu/ops/pallas/fused_block.py (fused_basic_block ->
// _kernel_pair / _kernel_plain); csrc/fused_block_wgmma_conv.cu takes bf16
// at C = 256 and 512 (the x halo, the y1 ring and one tap's weights of 512
// channels do not fit 227 KB of shared memory, so there the block runs as
// two convolutions with y1 in device memory):
//     out = relu(s2 * conv2(y1) + b2 + x),  y1 = bf16(relu(s1 * conv1(x) + b1))
// 3x3 stride-1 convs, zero padding at the image border (conv2 reads zeros
// there too, never relu(b1)), NHWC activations, weights pre-arranged by the
// wrapper (see below), (s, b) in float, sums and the residual in float.
//
// Bound on the H100: operations. The block does 4*B*H*W*9*C^2 operations
// (0.2931 ms at 989 TFLOP/s for both bench geometries, B=120) against
// 2*B*H*W*C*2 bytes of x and out (0.0751 ms at 3.35 TB/s).
//
// Design. A persistent grid (one CTA per SM) walks over (image, TH x TW
// output tile)s. Per CTA: warpgroup 2 is the producer (one thread issues
// the copies; the warpgroup hands its registers to the others with
// setmaxnreg), warpgroups 0 and 1 are the consumers.
// - The producer loads each tile's (TH+4) x (TW+4) x C halo of x by TMA
//   from a 4-D tensor map, one box of 8 channels x the halo's pixels per
//   8-channel group, so shared memory holds the halo as C/8 planes of
//   [pixel][8 channels] (16 bytes a pixel). TMA fills the boxes' parts
//   outside the image with zeros: conv1's padding. It then streams the two
//   convs' weights in stages of 64 input channels x C output channels
//   (cp.async.bulk), through a ring of NS stages guarded by mbarriers.
// - Each conv is 9 shifted GEMMs over K = C (one per tap). The trick that
//   makes the shifts free: the halo's pixels are numbered row by row with
//   the halo's pitch XW = TW+4, and conv1 is computed at flat positions
//   f = ry*XW + rx, which read flat positions f + dy*XW + dx. A 64-row
//   block of M is then 64 consecutive pixels of a plane (eight 8x16-byte
//   core matrices 128 bytes apart), so the A operand is a shared-memory
//   descriptor (no swizzle, K-major: LBO = the plane's size, SBO = 128 B)
//   moved by (dy*XW + dx)*16 bytes per tap: no im2col copy. B is the
//   stage's [8 k-groups][C][8] (LBO = C*16 B, SBO = 128 B). The MMA is
//   wgmma.mma_async m64nCk16 f32 += bf16 x bf16; warpgroup w takes the M
//   blocks w, w+2, ... The tensor cores sum each stage (64 channels of a
//   tap) apart, and CUDA-core float adds sum the stages (see conv()).
// - Columns rx >= TW+2 of each row are wasted work (they read across the
//   row's end), as are the rows of the last M block past the ring. conv1's
//   epilogue writes y1 = bf16(relu(s1*acc + b1)) over the (TH+2)x(TW+2)
//   ring into shared memory in the same plane layout and pitch, zero where
//   the ring lies outside the image; conv2 runs the same GEMMs over the
//   ring, and its epilogue adds the float residual read from the halo,
//   applies relu and stores bf16 pairs to device memory.
// - Work done against the bound: (MB1 + MB2) * 64 rows per TH*TW outputs
//   over 2*TH*TW: C=64 at 16x16 does 6 + 5 blocks, 1.375x the bound's
//   operations; C=128 at 8x16 does 4 + 3 blocks, 1.75x. y1 never leaves
//   shared memory (252 MB each way at bench layer1).
// - Shared memory: C=64 keeps two halo buffers (the next tile's halo loads
//   while this tile computes): 2 x 55.3 KB + ring 47.1 KB + 4 stages x
//   8 KB = 191 KB. C=128 keeps one halo: 77.8 + 61.4 + 5 x 16 KB = 219 KB.

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

constexpr int kConsumers = 256;             // two warpgroups
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
// registers a thread: the producer gives its own to the consumers'
// accumulators (128 x 40 + 256 x 232 <= 65536)
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

constexpr int round8(int v) { return (v + 7) / 8 * 8; }
constexpr int imax(int a, int b) { return a > b ? a : b; }

template <int C_, int TH_, int TW_, int NHALO_, int NS_>
struct Geo {
  static constexpr int C = C_, TH = TH_, TW = TW_, NHALO = NHALO_, NS = NS_;
  static constexpr int XW = TW + 4, XH = TH + 4, RW = TW + 2, RH = TH + 2;
  static constexpr int M1 = (RH - 1) * XW + RW;  // conv1 positions the ring needs
  static constexpr int MB1 = (M1 + 63) / 64;
  static constexpr int M2 = (TH - 1) * XW + TW;  // conv2 positions the tile needs
  static constexpr int MB2 = (M2 + 63) / 64;
  static constexpr int MBW = (imax(MB1, MB2) + 1) / 2;  // M blocks per warpgroup
  static constexpr int XPX = round8(imax(XH * XW, MB1 * 64 + 2 * XW + 2));  // halo plane, pixels
  static constexpr int YPX = round8(imax(M1, MB2 * 64 + 2 * XW + 2));       // ring plane, pixels
  static constexpr int G = C / 8;  // planes
  static constexpr int X_BYTES = G * XPX * 16;
  static constexpr int Y_BYTES = G * YPX * 16;
  static constexpr int KC = C / 64;  // 64-channel chunks of K per tap
  static constexpr int STAGE_BYTES = 64 * C * 2;
  static constexpr int CONV_STAGES = 9 * KC;
  static constexpr int HALO_TX = G * XH * XW * 16;
  // layout: halos, ring, weight stages, (s1, b1, s2, b2), barriers
  static constexpr int OFF_Y = NHALO * X_BYTES;
  static constexpr int OFF_W = OFF_Y + Y_BYTES;
  static constexpr int OFF_SB = OFF_W + NS * STAGE_BYTES;
  static constexpr int OFF_BAR = OFF_SB + 4 * C * 4;
  static constexpr int N_BARS = 2 * NS + 2 * NHALO;
  static constexpr int SMEM = OFF_BAR + N_BARS * 8 + 128;  // + 128 to align the base
  static_assert(SMEM <= 232448, "exceeds 227 KB of shared memory");
  static_assert(XH * XW <= XPX && XW <= 256 && XH <= 256, "TMA box");
};

using Geo64 = Geo<64, 16, 16, 2, 4>;
using Geo128 = Geo<128, 8, 16, 1, 5>;

// ------------------------------------------------------------- PTX helpers

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(2 + wg) : "memory");
}

// ------------------------------------------------------------- the kernel

struct Bars {
  uint32_t full, empty, hfull, hempty;  // shared addresses of the arrays
};

// One conv: 9 taps x KC stages of K, MB blocks of 64 flat positions of the
// A planes at `a_base` (plane size `a_plane` bytes), into acc; warpgroup WG
// owns the blocks WG, WG + 2, ... (a compile-time choice: a wgmma under a
// branch the compiler cannot prove uniform is serialized). Consumes
// CONV_STAGES weight stages from the ring, counting them in `st`.
//
// Two-level sums: the tensor cores sum each stage's 64 products of a block
// into `part`, and the float adds of the CUDA cores (round to nearest) add
// `part` into acc. The tensor cores' own float32 accumulation drops bits
// beyond its alignment. With all 72 steps of K = 9*128 in one accumulator,
// y1 rounded the other way about ten times as often as in the plain
// version's cuDNN sums (measured against a float64 reference on an H100);
// with the two levels the kernel's outputs lie no further from float64
// than the plain version's at 37x45 and larger images.
template <class Gm, int MB, int WG>
__device__ __forceinline__ void conv(float (&acc)[Gm::MBW][Gm::C / 2], uint32_t a_base,
                                     uint32_t a_plane, uint32_t w_base, const Bars& bars,
                                     bool leader, uint32_t& st) {
#pragma unroll
  for (int j = 0; j < Gm::MBW; ++j)
#pragma unroll
    for (int i = 0; i < Gm::C / 2; ++i) acc[j][i] = 0.f;
  float part[Gm::C / 2];
#pragma unroll 1
  for (int s = 0; s < Gm::CONV_STAGES; ++s, ++st) {
    const int tap = s / Gm::KC, kc = s % Gm::KC;
    const uint32_t shift = ((tap / 3) * Gm::XW + tap % 3) * 16;
    const uint32_t slot = st % Gm::NS;
    mbar_wait(bars.full + slot * 8, (st / Gm::NS) & 1);
    const uint32_t b_stage = w_base + slot * Gm::STAGE_BYTES;
    const uint32_t a_stage = a_base + kc * 8 * a_plane + shift;
#pragma unroll
    for (int j = 0; j < Gm::MBW; ++j) {
      if (WG + 2 * j >= MB) continue;
      fence_regs(part);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma(part, desc(a_stage + 2 * kk * a_plane + (WG + 2 * j) * 64 * 16, a_plane, 128),
              desc(b_stage + kk * 2 * Gm::C * 16, Gm::C * 16, 128), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(part);
#pragma unroll
      for (int i = 0; i < Gm::C / 2; ++i) acc[j][i] += part[i];
    }
    if (leader) mbar_arrive(bars.empty + slot * 8);  // this warpgroup is done with the stage
  }
}

// The producer: thread 0 of the producer warpgroup issues every tile's halo
// and both convs' weight stages, in the order the consumers take them.
template <class Gm>
__device__ __forceinline__ void produce(const CUtensorMap* xmap, const __nv_bfloat16* wk,
                                        uint32_t base, const Bars& bars, int tiles_w,
                                        int tiles_per_img, int n_tiles) {
  uint32_t st = 0;
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
    const int hb = it % Gm::NHALO, use = it / Gm::NHALO;
    if (use > 0) mbar_wait(bars.hempty + hb * 8, (use - 1) & 1);
    const int img = t / tiles_per_img, r = t % tiles_per_img;
    const int ty0 = (r / tiles_w) * Gm::TH, tx0 = (r % tiles_w) * Gm::TW;
    const uint32_t hbar = bars.hfull + hb * 8;
    mbar_expect_tx(hbar, Gm::HALO_TX);
    for (int g = 0; g < Gm::G; ++g)
      tma_load_4d(base + hb * Gm::X_BYTES + g * Gm::XPX * 16, xmap, hbar, 8 * g, tx0 - 2,
                  ty0 - 2, img);
    for (int s = 0; s < 2 * Gm::CONV_STAGES; ++s, ++st) {
      const uint32_t slot = st % Gm::NS;
      if (st >= (uint32_t)Gm::NS) mbar_wait(bars.empty + slot * 8, ((st / Gm::NS) - 1) & 1);
      mbar_expect_tx(bars.full + slot * 8, Gm::STAGE_BYTES);
      bulk_load(base + Gm::OFF_W + slot * Gm::STAGE_BYTES,
                wk + (size_t)s * (Gm::STAGE_BYTES / 2), Gm::STAGE_BYTES, bars.full + slot * 8);
    }
  }
}

// Consumer warpgroup WG: per tile, conv1 over the ring, its epilogue into
// the ring, conv2, the residual, relu and the store.
template <class Gm, int WG>
__device__ __forceinline__ void consume(uint8_t* sbase, uint32_t base, const Bars& bars,
                                        __nv_bfloat16* __restrict__ out, int H, int W,
                                        int tiles_w, int tiles_per_img, int n_tiles) {
  constexpr int C = Gm::C;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const bool leader = tid == 0;
  const float* const sbs = reinterpret_cast<const float*>(sbase + Gm::OFF_SB);
  float acc[Gm::MBW][C / 2];
  uint32_t st = 0;
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
    const int hb = it % Gm::NHALO;
    const int img = t / tiles_per_img, r = t % tiles_per_img;
    const int ty0 = (r / tiles_w) * Gm::TH, tx0 = (r % tiles_w) * Gm::TW;
    mbar_wait(bars.hfull + hb * 8, (it / Gm::NHALO) & 1);

    // conv1 over the ring
    conv<Gm, Gm::MB1, WG>(acc, base + hb * Gm::X_BYTES, Gm::XPX * 16, base + Gm::OFF_W, bars,
                          leader, st);
    consumers_sync();  // the other warpgroup is done reading the last tile's ring
#pragma unroll
    for (int j = 0; j < Gm::MBW; ++j) {
      if (WG + 2 * j >= Gm::MB1) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = (WG + 2 * j) * 64 + warp * 16 + lane / 4 + 8 * i;  // flat ring position
        if (m >= Gm::YPX) continue;
        const int ry = m / Gm::XW, rx = m % Gm::XW;
        const int gy = ty0 - 1 + ry, gx = tx0 - 1 + rx;
        const bool inside = ry < Gm::RH && rx < Gm::RW && gy >= 0 && gy < H && gx >= 0 && gx < W;
        uint8_t* const dst = sbase + Gm::OFF_Y + m * 16 + (lane % 4) * 4;
#pragma unroll
        for (int n8 = 0; n8 < C / 8; ++n8) {
          const int c = n8 * 8 + (lane % 4) * 2;
          float v0 = 0.f, v1 = 0.f;
          if (inside) {
            v0 = fmaxf(affine(acc[j][n8 * 4 + i * 2], sbs[c], sbs[C + c]), 0.f);
            v1 = fmaxf(affine(acc[j][n8 * 4 + i * 2 + 1], sbs[c + 1], sbs[C + c + 1]), 0.f);
          }
          *reinterpret_cast<__nv_bfloat162*>(dst + n8 * Gm::YPX * 16) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // ring -> wgmma's reads
    consumers_sync();

    // conv2 over the tile, the residual, relu, the store
    conv<Gm, Gm::MB2, WG>(acc, base + Gm::OFF_Y, Gm::YPX * 16, base + Gm::OFF_W, bars, leader,
                          st);
    const float* const s2 = sbs + 2 * C;
    const float* const b2 = sbs + 3 * C;
#pragma unroll
    for (int j = 0; j < Gm::MBW; ++j) {
      if (WG + 2 * j >= Gm::MB2) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = (WG + 2 * j) * 64 + warp * 16 + lane / 4 + 8 * i;  // flat tile position
        const int oy = m / Gm::XW, ox = m % Gm::XW;
        const int gy = ty0 + oy, gx = tx0 + ox;
        if (oy >= Gm::TH || ox >= Gm::TW || gy >= H || gx >= W) continue;
        const uint8_t* const res =
            sbase + hb * Gm::X_BYTES + (m + 2 * Gm::XW + 2) * 16 + (lane % 4) * 4;
        __nv_bfloat16* const o = out + (((size_t)img * H + gy) * W + gx) * C;
#pragma unroll
        for (int n8 = 0; n8 < C / 8; ++n8) {
          const int c = n8 * 8 + (lane % 4) * 2;
          const float2 x2 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(res + n8 * Gm::XPX * 16));
          const float v0 = affine(acc[j][n8 * 4 + i * 2], s2[c], b2[c]) + x2.x;
          const float v1 = affine(acc[j][n8 * 4 + i * 2 + 1], s2[c + 1], b2[c + 1]) + x2.y;
          *reinterpret_cast<__nv_bfloat162*>(o + c) =
              __floats2bfloat162_rn(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
        }
      }
    }
    warpgroup_sync(WG);  // this warpgroup is done with the halo
    if (leader) mbar_arrive(bars.hempty + hb * 8);
  }
}

template <class Gm>
__global__ void __launch_bounds__(kThreads, 1)
fused_block_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __nv_bfloat16* __restrict__ wk, const float* __restrict__ sb,
                         __nv_bfloat16* __restrict__ out, int H, int W, int tiles_w,
                         int tiles_per_img, int n_tiles) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 127) & ~127u;
  uint8_t* const sbase = smem_raw + (base - raw);
  float* const sbs = reinterpret_cast<float*>(sbase + Gm::OFF_SB);  // s1, b1, s2, b2
  const Bars bars{base + Gm::OFF_BAR, base + Gm::OFF_BAR + Gm::NS * 8,
                  base + Gm::OFF_BAR + 2 * Gm::NS * 8,
                  base + Gm::OFF_BAR + (2 * Gm::NS + Gm::NHALO) * 8};
  for (int i = threadIdx.x; i < 4 * Gm::C; i += blockDim.x) sbs[i] = sb[i];
  if (threadIdx.x == 0) {
    for (int i = 0; i < Gm::NS; ++i) {
      mbar_init(bars.full + i * 8, 1);
      mbar_init(bars.empty + i * 8, 2);  // one arrival per consumer warpgroup
    }
    for (int i = 0; i < Gm::NHALO; ++i) {
      mbar_init(bars.hfull + i * 8, 1);
      mbar_init(bars.hempty + i * 8, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // the warpgroup index, made warp-uniform for the compiler
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers)
      produce<Gm>(&xmap, wk, base, bars, tiles_w, tiles_per_img, n_tiles);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    if (wg == 0)
      consume<Gm, 0>(sbase, base, bars, out, H, W, tiles_w, tiles_per_img, n_tiles);
    else
      consume<Gm, 1>(sbase, base, bars, out, H, W, tiles_w, tiles_per_img, n_tiles);
  }
}

template <class Gm>
int launch(const void* x, const void* wk, const float* sb, void* out, int B, int H, int W,
           cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap map;
  const cuuint64_t dims[4] = {(cuuint64_t)Gm::C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)Gm::C * 2, (cuuint64_t)W * Gm::C * 2,
                                 (cuuint64_t)H * W * Gm::C * 2};
  const cuuint32_t box[4] = {8, (cuuint32_t)Gm::XW, (cuuint32_t)Gm::XH, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x),
                              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return kEncodeError + (int)res;
  auto kernel = fused_block_wgmma_kernel<Gm>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Gm::SMEM);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const int tiles_w = (W + Gm::TW - 1) / Gm::TW;
  const int tiles_per_img = tiles_w * ((H + Gm::TH - 1) / Gm::TH);
  const int n_tiles = tiles_per_img * B;
  const int grid = n_tiles < sms ? n_tiles : sms;
  kernel<<<grid, kThreads, Gm::SMEM, stream>>>(
      map, static_cast<const __nv_bfloat16*>(wk), sb, static_cast<__nv_bfloat16*>(out), H, W,
      tiles_w, tiles_per_img, n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: (B, H, W, C) bf16 NHWC; wk: both convs' weights as
// (2, 9, C/64, 8, C, 8) bf16 = [conv][tap][64-channel K chunk][8-channel K
// group][output channel][8 input channels]; sb: (4, C) float = s1, b1, s2,
// b2. C in {64, 128}. Returns a cudaError_t, or 10000 + the CUresult of a
// failed tensor-map encode.
extern "C" int fused_basic_block_wgmma(const void* x, const void* wk, const float* sb, void* out,
                                       int B, int H, int W, int C, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (C == 64) return launch<Geo64>(x, wk, sb, out, B, H, W, st);
  if (C == 128) return launch<Geo128>(x, wk, sb, out, B, H, W, st);
  return (int)cudaErrorInvalidValue;
}
