// Fused eval-mode ResNet basic block for Hopper (sm_90a).
//
// Replaces the TPU kernel multiagentperception_tpu/ops/pallas/fused_block.py
// (fused_basic_block -> _kernel_pair / _kernel_plain):
//     out = relu(s2 * conv2(relu(s1 * conv1(x) + b1)) + b2 + x)
// 3x3 stride-1 convs, zero padding at the image border, BN folded into
// per-channel (s, b), NHWC activations and HWIO weights in T (float or bf16),
// (s, b) in float. The convs accumulate in float; y1 is rounded to T before
// conv2 reads it, and outside the image conv2 reads zeros, never relu(b1);
// the residual is added in float.
//
// Bound on the H100: operations. The block does 4*B*H*W*9*C^2 operations
// against 2*B*H*W*C*sizeof(T) bytes of x and out: ~2300 operations per byte
// at C=64 bf16, far above the card's ~295 (bf16 tensor cores) or ~20
// (float FMAs) per byte.
//
// Design: correct and simple first; the TPU kernel's superpixel pair packing
// exists for the 128-lane MXU and has no place here. One block per (image,
// TILE x TILE output tile). It loads the (TILE+4)^2 x C halo of x into
// shared memory (zeros outside the image), computes conv1 over the
// (TILE+2)^2 ring that conv2 needs into shared memory (rounded to T, and
// zero where the ring lies outside the image), then conv2, the residual and
// the store. Each conv is an implicit GEMM on CUDA cores: a thread owns
// kPx pixels x kCx output channels of float accumulators and, per (tap,
// input channel), reads kPx activations from shared memory (a broadcast
// across the warp's channel groups) and kCx weights from global memory (one
// 16- or 32-byte row segment, cached). Pixels sit C + 4/sizeof(T) elements
// apart in shared memory so that a warp's pixel groups hit different banks.
// TILE is the largest of 16, 8, 4 whose halo and ring fit the 227 KB of
// shared memory.
//
// The wrapper (ops/kernels/fused_block.py, route()) sends C = 256/512 here
// in both types; at C = 64/128 bfloat16 goes to csrc/fused_block_wgmma.cu
// and float32 to csrc/fused_block_tf32.cu (3xTF32 products), both on the
// tensor cores. C = 256/512 stays on CUDA cores because their halo, ring
// and one tap's weights do not fit shared memory without cutting the
// channels into chunks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPx = 8;  // output pixels per thread item
constexpr int kCx = 8;  // output channels per thread item

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// kCx = 8 consecutive weights, 16-byte aligned (C and co0 are multiples of 8).
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // a bf16 is the high half of a float: widening is a shift
    out[2 * i] = __uint_as_float(words[i] << 16);
    out[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}

// y = a * s + b with no contraction into an FMA, as the plain version rounds.
__device__ __forceinline__ float affine(float a, float s, float b) {
  return __fadd_rn(__fmul_rn(a, s), b);
}

// One 3x3 conv over a shared-memory tile `in` ([IN_W * IN_W][S], pixel-major)
// into OUT_W x OUT_W output pixels; output pixel q = (qy, qx) reads input
// pixels (qy + dy, qx + dx), dy, dx in 0..2. `w` is HWIO (3, 3, C, C).
// Calls epi(q, co0, acc) with the kCx float sums of channels co0.. of q.
template <typename T, int C, int IN_W, int OUT_W, typename Epi>
__device__ __forceinline__ void conv3x3(const T* __restrict__ in,
                                        const T* __restrict__ w, Epi epi) {
  constexpr int S = C + 4 / sizeof(T);
  constexpr int P = OUT_W * OUT_W;
  constexpr int kGroups = (P + kPx - 1) / kPx;
  constexpr int kCGroups = C / kCx;
  for (int item = threadIdx.x; item < kGroups * kCGroups; item += blockDim.x) {
    const int co0 = (item % kCGroups) * kCx;
    const int pg = item / kCGroups;
    int base[kPx];
#pragma unroll
    for (int p = 0; p < kPx; ++p) {
      const int q = min(pg * kPx + p, P - 1);  // a ragged last group repeats a pixel
      base[p] = ((q / OUT_W) * IN_W + q % OUT_W) * S;
    }
    float acc[kPx][kCx];
#pragma unroll
    for (int p = 0; p < kPx; ++p)
#pragma unroll
      for (int c = 0; c < kCx; ++c) acc[p][c] = 0.f;
    for (int tap = 0; tap < 9; ++tap) {
      const int off = ((tap / 3) * IN_W + tap % 3) * S;
      const T* wt = w + (size_t)tap * C * C + co0;
#pragma unroll 4
      for (int ci = 0; ci < C; ++ci) {
        float a[kPx], b[kCx];
#pragma unroll
        for (int p = 0; p < kPx; ++p) a[p] = to_f(in[base[p] + off + ci]);
        load8(wt + (size_t)ci * C, b);
#pragma unroll
        for (int p = 0; p < kPx; ++p)
#pragma unroll
          for (int c = 0; c < kCx; ++c) acc[p][c] = fmaf(a[p], b[c], acc[p][c]);
      }
    }
#pragma unroll
    for (int p = 0; p < kPx; ++p) {
      const int q = pg * kPx + p;
      if (q < P) epi(q, co0, acc[p]);
    }
  }
}

template <typename T, int C, int TILE>
__global__ void __launch_bounds__(kThreads)
fused_basic_block_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                         const float* __restrict__ s1, const float* __restrict__ b1,
                         const T* __restrict__ w2, const float* __restrict__ s2,
                         const float* __restrict__ b2, T* __restrict__ out,
                         int H, int W, int tiles_w) {
  constexpr int S = C + 4 / sizeof(T);
  constexpr int XW = TILE + 4;  // x halo: conv1 over the ring needs 2 more each side
  constexpr int YW = TILE + 2;  // y1 ring: conv2 needs 1 more each side
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // [XW * XW][S]
  T* ys = xs + XW * XW * S;                // [YW * YW][S]
  const int img = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_w) * TILE;
  const int tx0 = (blockIdx.x % tiles_w) * TILE;
  const T* xi = x + (size_t)img * H * W * C;

  // 1. The x halo, zeros outside the image (conv1's zero padding).
  for (int i = threadIdx.x; i < XW * XW * C; i += blockDim.x) {
    const int c = i % C;
    const int p = i / C;
    const int gy = ty0 - 2 + p / XW;
    const int gx = tx0 - 2 + p % XW;
    T v = from_f<T>(0.f);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) v = xi[((size_t)gy * W + gx) * C + c];
    xs[p * S + c] = v;
  }
  __syncthreads();

  // 2. conv1 over the ring, rounded to T; zero outside the image, where
  //    conv2 pads with zeros (relu(b1) there would be wrong).
  conv3x3<T, C, XW, YW>(xs, w1, [&](int q, int co0, const float* acc) {
    const int gy = ty0 - 1 + q / YW;
    const int gx = tx0 - 1 + q % YW;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
    for (int c = 0; c < kCx; ++c) {
      const float v = inside ? fmaxf(affine(acc[c], s1[co0 + c], b1[co0 + c]), 0.f) : 0.f;
      ys[q * S + co0 + c] = from_f<T>(v);
    }
  });
  __syncthreads();

  // 3. conv2, the float residual from the halo, relu, the store.
  conv3x3<T, C, YW, TILE>(ys, w2, [&](int q, int co0, const float* acc) {
    const int oy = q / TILE;
    const int ox = q % TILE;
    const int gy = ty0 + oy;
    const int gx = tx0 + ox;
    if (gy >= H || gx >= W) return;  // the ragged edge
    const T* res = xs + ((oy + 2) * XW + ox + 2) * S + co0;
    T* o = out + (((size_t)img * H + gy) * W + gx) * C + co0;
#pragma unroll
    for (int c = 0; c < kCx; ++c) {
      const float v = affine(acc[c], s2[co0 + c], b2[co0 + c]) + to_f(res[c]);
      o[c] = from_f<T>(fmaxf(v, 0.f));
    }
  });
}

template <typename T, int C, int TILE>
int launch(const void* x, const void* w1, const float* s1, const float* b1,
           const void* w2, const float* s2, const float* b2, void* out,
           int B, int H, int W, cudaStream_t stream) {
  constexpr int S = C + 4 / sizeof(T);
  constexpr size_t kSmem =
      (size_t)((TILE + 4) * (TILE + 4) + (TILE + 2) * (TILE + 2)) * S * sizeof(T);
  static_assert(kSmem <= 232448, "halo and ring exceed 227 KB of shared memory");
  auto kernel = fused_basic_block_kernel<T, C, TILE>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_w = (W + TILE - 1) / TILE;
  const int tiles_h = (H + TILE - 1) / TILE;
  kernel<<<dim3(tiles_h * tiles_w, B), kThreads, kSmem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), s1, b1,
      static_cast<const T*>(w2), s2, b2, static_cast<T*>(out), H, W, tiles_w);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: (B, H, W, C) NHWC; w1, w2: (3, 3, C, C) HWIO, all in float (bf16=0)
// or bf16 (bf16=1); s1, b1, s2, b2: (C,) float. Returns a cudaError_t.
extern "C" int fused_basic_block(const void* x, const void* w1, const float* s1,
                                 const float* b1, const void* w2, const float* s2,
                                 const float* b2, void* out, int B, int H, int W, int C,
                                 int bf16, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  using bf = __nv_bfloat16;
#define FUSED_BLOCK_CASE(c, tile_f32, tile_bf16)                                       \
  case c:                                                                              \
    return bf16 ? launch<bf, c, tile_bf16>(x, w1, s1, b1, w2, s2, b2, out, B, H, W, st) \
                : launch<float, c, tile_f32>(x, w1, s1, b1, w2, s2, b2, out, B, H, W, st);
  switch (C) {
    FUSED_BLOCK_CASE(64, 16, 16)
    FUSED_BLOCK_CASE(128, 8, 16)
    FUSED_BLOCK_CASE(256, 4, 8)
    FUSED_BLOCK_CASE(512, 4, 4)
  }
#undef FUSED_BLOCK_CASE
  return (int)cudaErrorInvalidValue;
}
