// The skeleton that K3's C = 256/512 routes share: one implicit-GEMM 3x3
// conv kernel (M = output pixels, N = output channels, K = 9 taps x C),
// launched twice by the route's entry point after a kernel that arranges
// the weights. Included by csrc/fused_block_wgmma_conv.cu (bf16) and
// csrc/fused_block_tf32_conv.cu (float32, 3xTF32), whose notes give the
// designs. Each source defines its Geo<C> (element type T, tile TH x TW
// pixels x NB output channels, NSL = C/NB channel slices, KC = C/64 halo
// chunks of G planes of 16-byte pixels, PL bytes each; NH chunks and NS
// weight stages of STAGE bytes in flight; OFF_W, OFF_BAR, SMEM), and the
// consume and arrange_weights templates declared below; this header gives
// the rest:
// - a persistent grid walks over the tiles, the channel slice slowest, so
//   the CTAs in flight share one slice of weights in L2;
// - warpgroup 2 is the producer: one thread loads each tile's (TH+2) x
//   (TW+2) halo a chunk of 64 input channels at a time by TMA (one box of
//   16 bytes of channels x the halo's pixels per plane; TMA's zero fill
//   outside the image is the conv's padding) into a ring of NH chunks, and
//   streams the weights in stages of one tap x 64 input x NB output channels
//   (cp.async.bulk) through a ring of NS stages; a chunk serves 9 stages,
//   one per tap; mbarriers guard both rings. The warpgroup hands its
//   registers to the consumers with setmaxnreg;
// - warpgroups 0 and 1 consume: the MMAs and the epilogue,
//   out = relu(s * acc + b [+ res]).

#pragma once

#include "hopper.cuh"

namespace {

constexpr int kConsumers = 256;             // two warpgroups
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
// registers a thread: the producer gives its own to the consumers
// (128 x 40 + 256 x 232 <= 65536)
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

constexpr int round128(int v) { return (v + 127) / 128 * 128; }

struct Bars {
  uint32_t full, empty, hfull, hempty;  // shared addresses of the arrays
};

struct Tile {
  int ns, img, ty0, tx0;  // channel slice, image, first row and column
};

__device__ __forceinline__ Tile tile_of(int t, int tiles_w, int tiles_per_img, int tiles_px,
                                        int th, int tw) {
  const int r = t % tiles_px, q = r % tiles_per_img;
  return {t / tiles_px, r / tiles_per_img, (q / tiles_w) * th, (q % tiles_w) * tw};
}

// Consumer warpgroup WG of a CTA: per tile, the 9 x KC stages, then the
// epilogue into out (RES: + res). Defined by each source.
template <class Gm, int WG, bool RES>
__device__ __forceinline__ void consume(uint8_t* sbase, uint32_t base, const Bars& bars,
                                        const float* __restrict__ s,
                                        const float* __restrict__ b,
                                        const typename Gm::T* __restrict__ res,
                                        typename Gm::T* __restrict__ out, int H, int W,
                                        int tiles_w, int tiles_per_img, int tiles_px,
                                        int n_tiles);

// Both convs' HWIO float32 weights (3, 3, C, C) into wk as the producer
// streams them. Defined by each source.
template <class Gm>
__global__ void arrange_weights(const float* __restrict__ w1, const float* __restrict__ w2,
                                typename Gm::T* __restrict__ wk);

// The producer: one thread issues every tile's halo chunks and weight
// stages, in the order the consumers take them.
template <class Gm>
__device__ __forceinline__ void produce(const CUtensorMap* map, const typename Gm::T* wk,
                                        uint32_t base, const Bars& bars, int tiles_w,
                                        int tiles_per_img, int tiles_px, int n_tiles) {
  constexpr int kPlaneChannels = 16 / sizeof(typename Gm::T);
  constexpr int kStageElems = Gm::STAGE / sizeof(typename Gm::T);
  uint32_t st = 0, hc = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const Tile tl = tile_of(t, tiles_w, tiles_per_img, tiles_px, Gm::TH, Gm::TW);
    for (int kc = 0; kc < Gm::KC; ++kc, ++hc) {
      const uint32_t hs = hc % Gm::NH;
      if (hc >= (uint32_t)Gm::NH) mbar_wait(bars.hempty + hs * 8, ((hc / Gm::NH) - 1) & 1);
      mbar_expect_tx(bars.hfull + hs * 8, Gm::HALO_TX);
      for (int g = 0; g < Gm::G; ++g)
        tma_load_4d(base + hs * Gm::CHUNK + g * Gm::PL, map, bars.hfull + hs * 8,
                    kc * 64 + kPlaneChannels * g, tl.tx0 - 1, tl.ty0 - 1, tl.img);
      const typename Gm::T* const w = wk + (size_t)(tl.ns * Gm::KC + kc) * 9 * kStageElems;
      for (int tap = 0; tap < 9; ++tap, ++st) {
        const uint32_t slot = st % Gm::NS;
        if (st >= (uint32_t)Gm::NS) mbar_wait(bars.empty + slot * 8, ((st / Gm::NS) - 1) & 1);
        mbar_expect_tx(bars.full + slot * 8, Gm::STAGE);
        bulk_load(base + Gm::OFF_W + slot * Gm::STAGE, w + (size_t)tap * kStageElems, Gm::STAGE,
                  bars.full + slot * 8);
      }
    }
  }
}

// out = relu(s * conv(src) + b [+ res]) over the tensor map `map` of src
template <class Gm, bool RES>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_kernel(const __grid_constant__ CUtensorMap map, const typename Gm::T* __restrict__ wk,
               const float* __restrict__ s, const float* __restrict__ b,
               const typename Gm::T* __restrict__ res, typename Gm::T* __restrict__ out, int H,
               int W, int tiles_w, int tiles_per_img, int tiles_px, int n_tiles) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 127) & ~127u;
  uint8_t* const sbase = smem_raw + (base - raw);
  const Bars bars{base + Gm::OFF_BAR, base + Gm::OFF_BAR + Gm::NS * 8,
                  base + Gm::OFF_BAR + 2 * Gm::NS * 8,
                  base + Gm::OFF_BAR + (2 * Gm::NS + Gm::NH) * 8};
  if (threadIdx.x == 0) {
    for (int i = 0; i < Gm::NS; ++i) {
      mbar_init(bars.full + i * 8, 1);
      mbar_init(bars.empty + i * 8, 2);  // one arrival per consumer warpgroup
    }
    for (int i = 0; i < Gm::NH; ++i) {
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
      produce<Gm>(&map, wk, base, bars, tiles_w, tiles_per_img, tiles_px, n_tiles);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    if (wg == 0)
      consume<Gm, 0, RES>(sbase, base, bars, s, b, res, out, H, W, tiles_w, tiles_per_img,
                          tiles_px, n_tiles);
    else
      consume<Gm, 1, RES>(sbase, base, bars, s, b, res, out, H, W, tiles_w, tiles_per_img,
                          tiles_px, n_tiles);
  }
}

// A 4-D tensor map of src (B, H, W, C) with boxes of 16 bytes of channels x
// the halo's pixels.
template <class Gm>
int encode_map(CUtensorMap* map, const void* src, int B, int H, int W) {
  constexpr int kItem = sizeof(typename Gm::T);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)Gm::C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)Gm::C * kItem, (cuuint64_t)W * Gm::C * kItem,
                                 (cuuint64_t)H * W * Gm::C * kItem};
  const cuuint32_t box[4] = {16 / kItem, (cuuint32_t)Gm::XW, (cuuint32_t)Gm::XH, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, kItem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
      const_cast<void*>(src), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

template <class Gm, bool RES>
int launch_conv(const void* src, const typename Gm::T* wk, const float* sb, const void* res,
                void* out, int B, int H, int W, int sms, cudaStream_t stream) {
  using T = typename Gm::T;
  static_assert(Gm::SMEM <= 232448, "exceeds 227 KB of shared memory");
  static_assert(Gm::XW <= 256 && Gm::XH <= 256, "TMA box");
  CUtensorMap map;
  const int rc = encode_map<Gm>(&map, src, B, H, W);
  if (rc != 0) return rc;
  auto kernel = conv3x3_kernel<Gm, RES>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Gm::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int tiles_w = (W + Gm::TW - 1) / Gm::TW;
  const int tiles_per_img = tiles_w * ((H + Gm::TH - 1) / Gm::TH);
  const int tiles_px = tiles_per_img * B;
  const int n_tiles = tiles_px * Gm::NSL;
  const int grid = n_tiles < sms ? n_tiles : sms;
  kernel<<<grid, kThreads, Gm::SMEM, stream>>>(map, wk, sb, sb + Gm::C,
                                                static_cast<const T*>(res), static_cast<T*>(out),
                                                H, W, tiles_w, tiles_per_img, tiles_px, n_tiles);
  return (int)cudaGetLastError();
}

// The block: the weights arranged into wk, conv1 (x -> y1, s1 and b1 at
// sb[0:2C]), conv2 (y1 -> out with the residual x, s2 and b2 at sb[2C:4C]).
template <class Gm>
int launch(const void* x, const float* w1, const float* w2, void* wk, const float* sb, void* y1,
           void* out, int B, int H, int W, cudaStream_t stream) {
  using T = typename Gm::T;
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  T* const w = static_cast<T*>(wk);
  arrange_weights<Gm><<<sms * 8, 256, 0, stream>>>(w1, w2, w);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int rc = launch_conv<Gm, false>(x, w, sb, nullptr, y1, B, H, W, sms, stream);
  if (rc != 0) return rc;
  const size_t per_conv = (size_t)Gm::NSL * Gm::KC * 9 * (Gm::STAGE / sizeof(T));
  return launch_conv<Gm, true>(y1, w + per_conv, sb + 2 * Gm::C, x, out, B, H, W, sms, stream);
}

}  // namespace
