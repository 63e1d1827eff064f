// Fused eval-mode ResNet basic block, float32, on Hopper's tensor cores
// with error-compensated 3xTF32 products (sm_90a: wgmma, TMA, mbarriers).
// C in {64, 128}.
//
// Replaces, for float32 at C = 64 and 128, the TPU kernel
// multiagentperception_tpu/ops/pallas/fused_block.py (fused_basic_block ->
// _kernel_pair / _kernel_plain); csrc/fused_block_tf32_conv.cu takes float32
// at C = 256 and 512, as two convolutions:
//     out = relu(s2 * conv2(y1) + b2 + x),  y1 = relu(s1 * conv1(x) + b1)
// 3x3 stride-1 convs, zero padding at the image border (conv2 reads zeros
// there too, never relu(b1)), NHWC float32 activations, y1 kept in float32,
// weights pre-split and pre-arranged by the wrapper (see below), (s, b),
// the sums and the residual in float.
//
// Precision. A TF32 product keeps 11 significant bits of each operand, too
// few for K3's float32 check (rtol/atol 1e-4). Each operand v is split into
// hi = rna(v) and lo = rna(v - hi) (cvt.rna.tf32.f32; v - hi is exact), and
// a product is hi*hi + hi*lo + lo*hi on the tensor cores; lo*lo (~2^-22 of
// the product) is dropped. wgmma reads only the top 19 bits of a 32-bit
// operand, so hi is rounded explicitly rather than truncated. The tensor
// cores' float32 accumulation drops bits beyond its alignment (see
// csrc/fused_block_wgmma.cu's conv()), so as on the bf16 route they sum
// only one weight stage (one tap, 64 channels at C=64, 32 at C=128) into
// `part`, small terms first, and CUDA-core float adds sum the stages.
//
// Bound on the H100: operations. The block does 4*B*H*W*9*C^2 operations,
// three TF32 products each: 0.1757 ms at 495 TFLOP/s at both eval
// geometries (B=12); its bytes (x, out, weights) take 0.0096 ms at 3.35 TB/s.
//
// Design. A persistent grid (one CTA per SM) walks over (image, TH x TW
// output tile)s. Warpgroup 2 is the producer (one thread issues the copies;
// the warpgroup hands its registers to the others with setmaxnreg),
// warpgroups 0 and 1 are the consumers.
// - The producer loads each tile's (TH+4) x (TW+4) x C halo of x by TMA from
//   a 4-D tensor map, one box of 4 channels x the halo's pixels per plane, so
//   shared memory holds the halo as C/4 planes of [pixel][4 floats]. TMA
//   fills the boxes' parts outside the image with zeros: conv1's padding. It
//   streams both convs' weight stages (hi then lo, KS input channels x C
//   output channels each) by cp.async.bulk through a ring of NS stages
//   guarded by mbarriers; the first NS stages of a tile go out before its
//   halo, while the last tile's conv2 still runs.
// - Each conv is 9 shifted GEMMs over K = C, as wgmma.mma_async m64n64k8
//   f32 += tf32 x tf32. A comes from registers: each thread loads its four
//   values of the 64 x 8 fragment from the planes (row = an output pixel,
//   column = a channel; a warp reads 128 contiguous bytes a plane), splits
//   them, and feeds hi or lo; the rows are gathered pixels, so no row is
//   wasted on the halo's pitch and no lo copy of the halo is stored. B is
//   the stage's [K/4 groups][C][4] in shared memory (K-major, the only
//   order wgmma takes for 32-bit types). Two fragment buffers let a k-step's
//   loads and splits overlap the previous step's products.
// - conv1 runs over the (TH+2) x (TW+2) ring; its epilogue writes y1 =
//   relu(s1*acc + b1), zero outside the image, back into the halo's planes
//   at (ry + 1, rx + 1) (x is no longer needed there), and conv2 runs over
//   the tile from that copy. Its epilogue reads the residual from x in
//   device memory (just loaded, so in L2), applies relu and stores float2s.
// - Work: C=64 at 16x16 tiles, warpgroup w takes M blocks w, w+2, ... (6
//   ring blocks and 4 tile blocks for 256 outputs); C=128 at 8x16 tiles,
//   each warpgroup takes all M blocks (3 + 2 for 128 outputs) over its half
//   of the output channels. Both do 1.25x the bound's operations (the
//   ring's recompute and the last ring block's padding rows).
// - Shared memory: C=64: halo 16 planes x 6400 B + 3 stages x 32 KB +
//   (s, b) = 201,728 B; C=128: 32 x 3840 B + 3 x 32 KB + 2 KB = 223,232 B
//   (of 232,448). One halo buffer: the next tile's halo load waits for this
//   tile's conv2.

#include "hopper.cuh"

namespace {

constexpr int kConsumers = 256;             // two warpgroups
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
// registers a thread: the producer gives its own to the consumers'
// accumulators (128 x 40 + 256 x 232 <= 65536)
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

constexpr int round128(int v) { return (v + 127) / 128 * 128; }
constexpr int imax(int a, int b) { return a > b ? a : b; }

template <int C_, int TH_, int TW_, int KS_, int NS_, bool NSPLIT_>
struct Geo {
  static constexpr int C = C_, TH = TH_, TW = TW_, KS = KS_, NS = NS_;
  static constexpr bool NSPLIT = NSPLIT_;  // warpgroups split N (else M blocks)
  static constexpr int XW = TW + 4, XH = TH + 4, RW = TW + 2, RH = TH + 2;
  static constexpr int M1 = RH * RW;  // conv1 over the ring
  static constexpr int MB1 = (M1 + 63) / 64;
  static constexpr int M2 = TH * TW;  // conv2 over the tile
  static constexpr int MB2 = (M2 + 63) / 64;
  static constexpr int NW = NSPLIT ? C / 2 : C;  // output channels of a warpgroup
  static constexpr int MBW = NSPLIT ? imax(MB1, MB2) : (imax(MB1, MB2) + 1) / 2;
  static constexpr int G = C / 4;                    // planes of 4 channels
  static constexpr int PL = round128(XH * XW * 16);  // plane bytes
  static constexpr int X_BYTES = G * PL;
  static constexpr int KC = C / KS;  // weight stages a tap
  static constexpr int KK = KS / 8;  // k8 steps a stage
  static constexpr int HALF = KS * C * 4;  // hi (or lo) bytes of a stage
  static constexpr int STAGE_BYTES = 2 * HALF;
  static constexpr int CONV_STAGES = 9 * KC;
  static constexpr int HALO_TX = G * XH * XW * 16;
  // layout: halo, weight stages, (s1, b1, s2, b2), barriers
  static constexpr int OFF_W = X_BYTES;
  static constexpr int OFF_SB = OFF_W + NS * STAGE_BYTES;
  static constexpr int OFF_BAR = OFF_SB + 4 * C * 4;
  static constexpr int N_BARS = 2 * NS + 2;
  static constexpr int SMEM = OFF_BAR + N_BARS * 8 + 128;  // + 128 to align the base
  static_assert(SMEM <= 232448, "exceeds 227 KB of shared memory");
  static_assert(NW == 64, "the MMA is m64n64k8");
  static_assert(XW <= 256 && XH <= 256, "TMA box");
};

using Geo64 = Geo<64, 16, 16, 64, 3, false>;
using Geo128 = Geo<128, 8, 16, 32, 3, true>;

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(2 + wg) : "memory");
}

struct Bars {
  uint32_t full, empty, hfull, hempty;  // shared addresses
};

// The M block that a warpgroup's j-th accumulator holds (a compile-time
// choice: a wgmma under a branch the compiler cannot prove uniform is
// serialized).
template <class Gm, int WG>
__host__ __device__ constexpr int block_of(int j) {
  return Gm::NSPLIT ? j : WG + 2 * j;
}

// The halo pixel that row m of a conv reads at tap (0, 0): conv1 runs over
// the ring, (ry, rx) -> halo (ry, rx); conv2 over the tile, (oy, ox) -> the
// ring's copy at halo (oy + 1, ox + 1). Rows past M read pixel 0.
template <class Gm, bool RING>
__device__ __forceinline__ int row_pixel(int m) {
  if (RING) return m < Gm::M1 ? (m / Gm::RW) * Gm::XW + m % Gm::RW : 0;
  return m < Gm::M2 ? (m / Gm::TW + 1) * Gm::XW + m % Gm::TW + 1 : 0;
}

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

// One conv: 9 taps x KC stages of K over the halo's planes at `sx`, MB
// blocks of 64 rows, into acc (warpgroup WG's blocks, its 64 output
// channels). Consumes CONV_STAGES weight stages from the ring, counting
// them in `st`.
template <class Gm, int MB, int WG, bool RING>
__device__ __forceinline__ void conv(float (&acc)[Gm::MBW][32], const uint8_t* sx,
                                     uint32_t w_base, const Bars& bars, bool leader,
                                     uint32_t& st) {
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  uint32_t row[Gm::MBW][2];  // byte offsets in a plane of this thread's rows and column
#pragma unroll
  for (int j = 0; j < Gm::MBW; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      row[j][i] =
          row_pixel<Gm, RING>(block_of<Gm, WG>(j) * 64 + warp * 16 + lane / 4 + 8 * i) * 16 +
          (lane % 4) * 4;
#pragma unroll
  for (int j = 0; j < Gm::MBW; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
  const uint32_t n_off = (Gm::NSPLIT ? WG * 64 : 0) * 16;  // this warpgroup's columns of B
  float part[32];
#pragma unroll 1
  for (int s = 0; s < Gm::CONV_STAGES; ++s, ++st) {
    const int tap = s / Gm::KC, kc = s % Gm::KC;
    const uint32_t slot = st % Gm::NS;
    mbar_wait(bars.full + slot * 8, (st / Gm::NS) & 1);
    const uint32_t b_hi = w_base + slot * Gm::STAGE_BYTES + n_off, b_lo = b_hi + Gm::HALF;
    const uint8_t* const a_stage =
        sx + kc * (Gm::KS / 4) * Gm::PL + ((tap / 3) * Gm::XW + tap % 3) * 16;
#pragma unroll
    for (int j = 0; j < Gm::MBW; ++j) {
      if (block_of<Gm, WG>(j) >= MB) continue;
      const uint8_t* const a0 = a_stage + row[j][0];
      const uint8_t* const a1 = a_stage + row[j][1];
      float raw[4];
      uint32_t hi[2][4], lo[2][4];
      load_a<Gm>(raw, a0, a1, 0);
      fence_regs(part);
#pragma unroll
      for (int kk = 0; kk < Gm::KK; ++kk) {
        const int b = kk & 1;
        if (kk >= 2) wgmma_wait<1>();  // step kk - 2, which read hi[b] and lo[b], is done
        split(raw, hi[b], lo[b]);
        if (kk + 1 < Gm::KK) load_a<Gm>(raw, a0, a1, kk + 1);
        const uint32_t kb = 2 * kk * Gm::C * 16;  // the step's two k-groups of B
        wgmma_fence();
        wgmma_tf32(part, lo[b], desc(b_hi + kb, Gm::C * 16, 128), kk > 0);
        wgmma_tf32(part, hi[b], desc(b_lo + kb, Gm::C * 16, 128), 1);
        wgmma_tf32(part, hi[b], desc(b_hi + kb, Gm::C * 16, 128), 1);
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_regs(part);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] += part[i];
    }
    if (leader) mbar_arrive(bars.empty + slot * 8);  // this warpgroup is done with the stage
  }
}

// The producer: thread 0 of the producer warpgroup issues every tile's halo
// and both convs' weight stages, in the order the consumers take them.
template <class Gm>
__device__ __forceinline__ void produce(const CUtensorMap* xmap, const float* wk, uint32_t base,
                                        const Bars& bars, int tiles_w, int tiles_per_img,
                                        int n_tiles) {
  uint32_t st = 0;
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
    const int img = t / tiles_per_img, r = t % tiles_per_img;
    const int ty0 = (r / tiles_w) * Gm::TH, tx0 = (r % tiles_w) * Gm::TW;
    for (int s = 0; s < 2 * Gm::CONV_STAGES; ++s, ++st) {
      if (s == Gm::NS) {  // the tile's first stages are on their way: now its halo
        if (it > 0) mbar_wait(bars.hempty, (it - 1) & 1);
        mbar_expect_tx(bars.hfull, Gm::HALO_TX);
        for (int g = 0; g < Gm::G; ++g)
          tma_load_4d(base + g * Gm::PL, xmap, bars.hfull, 4 * g, tx0 - 2, ty0 - 2, img);
      }
      const uint32_t slot = st % Gm::NS;
      if (st >= (uint32_t)Gm::NS) mbar_wait(bars.empty + slot * 8, ((st / Gm::NS) - 1) & 1);
      mbar_expect_tx(bars.full + slot * 8, Gm::STAGE_BYTES);
      bulk_load(base + Gm::OFF_W + slot * Gm::STAGE_BYTES,
                wk + (size_t)s * (Gm::STAGE_BYTES / 4), Gm::STAGE_BYTES, bars.full + slot * 8);
    }
  }
}

// Consumer warpgroup WG: per tile, conv1 over the ring, its epilogue into
// the halo's planes, conv2, the residual, relu and the store.
template <class Gm, int WG>
__device__ __forceinline__ void consume(uint8_t* sbase, const Bars& bars, uint32_t w_base,
                                        const float* __restrict__ x, float* __restrict__ out,
                                        int H, int W, int tiles_w, int tiles_per_img,
                                        int n_tiles) {
  constexpr int C = Gm::C;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const bool leader = tid == 0;
  const int n0 = Gm::NSPLIT ? WG * 64 : 0;
  const float* const sbs = reinterpret_cast<const float*>(sbase + Gm::OFF_SB);
  float acc[Gm::MBW][32];
  uint32_t st = 0;
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
    const int img = t / tiles_per_img, r = t % tiles_per_img;
    const int ty0 = (r / tiles_w) * Gm::TH, tx0 = (r % tiles_w) * Gm::TW;
    mbar_wait(bars.hfull, it & 1);

    conv<Gm, Gm::MB1, WG, true>(acc, sbase, w_base, bars, leader, st);
    consumers_sync();  // both warpgroups are done reading x from the halo
#pragma unroll
    for (int j = 0; j < Gm::MBW; ++j) {
      if (block_of<Gm, WG>(j) >= Gm::MB1) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = block_of<Gm, WG>(j) * 64 + warp * 16 + lane / 4 + 8 * i;  // ring pixel
        if (m >= Gm::M1) continue;
        const int ry = m / Gm::RW, rx = m % Gm::RW;
        const int gy = ty0 - 1 + ry, gx = tx0 - 1 + rx;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
        uint8_t* const px = sbase + ((ry + 1) * Gm::XW + rx + 1) * 16;
#pragma unroll
        for (int n8 = 0; n8 < 8; ++n8) {
          const int c = n0 + n8 * 8 + (lane % 4) * 2;
          float v0 = 0.f, v1 = 0.f;
          if (inside) {
            v0 = fmaxf(affine(acc[j][n8 * 4 + i * 2], sbs[c], sbs[C + c]), 0.f);
            v1 = fmaxf(affine(acc[j][n8 * 4 + i * 2 + 1], sbs[c + 1], sbs[C + c + 1]), 0.f);
          }
          *reinterpret_cast<float2*>(px + (c / 4) * Gm::PL + (c % 4) * 4) = make_float2(v0, v1);
        }
      }
    }
    consumers_sync();

    conv<Gm, Gm::MB2, WG, false>(acc, sbase, w_base, bars, leader, st);
    const float* const s2 = sbs + 2 * C;
    const float* const b2 = sbs + 3 * C;
#pragma unroll
    for (int j = 0; j < Gm::MBW; ++j) {
      if (block_of<Gm, WG>(j) >= Gm::MB2) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = block_of<Gm, WG>(j) * 64 + warp * 16 + lane / 4 + 8 * i;  // tile pixel
        if (m >= Gm::M2) continue;
        const int gy = ty0 + m / Gm::TW, gx = tx0 + m % Gm::TW;
        if (gy >= H || gx >= W) continue;
        const size_t px = (((size_t)img * H + gy) * W + gx) * C;
#pragma unroll
        for (int n8 = 0; n8 < 8; ++n8) {
          const int c = n0 + n8 * 8 + (lane % 4) * 2;
          const float2 res = __ldg(reinterpret_cast<const float2*>(x + px + c));
          const float v0 = affine(acc[j][n8 * 4 + i * 2], s2[c], b2[c]) + res.x;
          const float v1 = affine(acc[j][n8 * 4 + i * 2 + 1], s2[c + 1], b2[c + 1]) + res.y;
          *reinterpret_cast<float2*>(out + px + c) = make_float2(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
        }
      }
    }
    // the ring's writes come before the next halo's TMA writes to the same bytes
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    warpgroup_sync(WG);  // this warpgroup is done with the halo
    if (leader) mbar_arrive(bars.hempty);
  }
}

template <class Gm>
__global__ void __launch_bounds__(kThreads, 1)
fused_block_tf32_kernel(const __grid_constant__ CUtensorMap xmap, const float* __restrict__ x,
                        const float* __restrict__ wk, const float* __restrict__ sb,
                        float* __restrict__ out, int H, int W, int tiles_w, int tiles_per_img,
                        int n_tiles) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 127) & ~127u;
  uint8_t* const sbase = smem_raw + (base - raw);
  float* const sbs = reinterpret_cast<float*>(sbase + Gm::OFF_SB);  // s1, b1, s2, b2
  const Bars bars{base + Gm::OFF_BAR, base + Gm::OFF_BAR + Gm::NS * 8,
                  base + Gm::OFF_BAR + 2 * Gm::NS * 8, base + Gm::OFF_BAR + 2 * Gm::NS * 8 + 8};
  for (int i = threadIdx.x; i < 4 * Gm::C; i += blockDim.x) sbs[i] = sb[i];
  if (threadIdx.x == 0) {
    for (int i = 0; i < Gm::NS; ++i) {
      mbar_init(bars.full + i * 8, 1);
      mbar_init(bars.empty + i * 8, 2);  // one arrival per consumer warpgroup
    }
    mbar_init(bars.hfull, 1);
    mbar_init(bars.hempty, 2);
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
      consume<Gm, 0>(sbase, bars, base + Gm::OFF_W, x, out, H, W, tiles_w, tiles_per_img,
                     n_tiles);
    else
      consume<Gm, 1>(sbase, bars, base + Gm::OFF_W, x, out, H, W, tiles_w, tiles_per_img,
                     n_tiles);
  }
}

template <class Gm>
int launch(const void* x, const void* wk, const float* sb, void* out, int B, int H, int W,
           cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap map;
  const cuuint64_t dims[4] = {(cuuint64_t)Gm::C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)Gm::C * 4, (cuuint64_t)W * Gm::C * 4,
                                 (cuuint64_t)H * W * Gm::C * 4};
  const cuuint32_t box[4] = {4, (cuuint32_t)Gm::XW, (cuuint32_t)Gm::XH, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(x),
                              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return kEncodeError + (int)res;
  auto kernel = fused_block_tf32_kernel<Gm>;
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
      map, static_cast<const float*>(x), static_cast<const float*>(wk), sb,
      static_cast<float*>(out), H, W, tiles_w, tiles_per_img, n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: (B, H, W, C) float32 NHWC; wk: both convs' weights split into
// tf32 hi and lo as (2, 9, C/KS, 2, KS/4, C, 4) float32 = [conv][tap][KS-
// channel K chunk][hi, lo][4-channel K group][output channel][4 input
// channels], KS = 64 at C=64 and 32 at C=128; sb: (4, C) float = s1, b1,
// s2, b2. C in {64, 128}. Returns a cudaError_t, or 10000 + the CUresult of
// a failed tensor-map encode.
extern "C" int fused_basic_block_tf32x3(const void* x, const void* wk, const float* sb,
                                        void* out, int B, int H, int W, int C, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (C == 64) return launch<Geo64>(x, wk, sb, out, B, H, W, st);
  if (C == 128) return launch<Geo128>(x, wk, sb, out, B, H, W, st);
  return (int)cudaErrorInvalidValue;
}
