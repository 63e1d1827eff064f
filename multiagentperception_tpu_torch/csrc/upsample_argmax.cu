// Fused x32 bilinear upsample + class argmax for Hopper (sm_90a).
//
// Replaces the TPU kernel multiagentperception_tpu/ops/pallas/upsample_argmax.py
// (upsample_argmax_pallas -> _kernel): the class map
//     out[i, O, P] = argmax_c  sum_{h,w} Wy[O,h] * x[i,c,h,w] * Wx[P,w]
// of the decoder's pre-upsample logits, without ever writing the
// full-resolution (B*N, C, H, W) logits to device memory.
//
// Bound on the H100: bytes. The only large stream is the int32 class map
// (12 x 512 x 512 x 4 B = 12.6 MB at the flagship, ~3.8 us at 3.35 TB/s);
// the logits read is 135 KB and the arithmetic is ~44 FMAs per pixel.
//
// Design: one block per (image, tile of kTileRows output rows). Phase 1 does
// the vertical interpolation of the tile's rows for every class into shared
// memory (C x kTileRows x w floats, 11 KB at 16x16 logits); phase 2 gives
// each thread output pixels of the tile, where neighbouring threads write
// neighbouring columns (coalesced int32 stores) and read one row's two
// horizontal taps per class from shared memory. Rows first, then columns:
// the order of the plain version's two matmuls. Every output row has at most
// two taps; the host passes their indices and weights, taken from the same
// _weight_matrix as the plain version, so the weights are bit-identical.
// The class loop compares with strict '>', so ties keep the lowest class.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 16;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
upsample_argmax_kernel(const float* __restrict__ x, int C, int h, int w,
                       const int* __restrict__ ytap, const float* __restrict__ ywt,
                       const int* __restrict__ xtap, const float* __restrict__ xwt,
                       int H, int W, int32_t* __restrict__ out) {
  extern __shared__ float rows[];  // [C][kTileRows][w]
  const int img = blockIdx.x;
  const int row0 = blockIdx.y * kTileRows;
  const int nrows = min(kTileRows, H - row0);
  const float* xi = x + (size_t)img * C * h * w;

  // Phase 1: rows[c][r][col] = Wy[O, y0] x[c, y0, col] + Wy[O, y1] x[c, y1, col]
  for (int i = threadIdx.x; i < C * nrows * w; i += blockDim.x) {
    const int col = i % w;
    const int r = (i / w) % nrows;
    const int c = i / (w * nrows);
    const int o = row0 + r;
    const float* xc = xi + (size_t)c * h * w;
    rows[(c * kTileRows + r) * w + col] =
        ywt[2 * o] * xc[ytap[2 * o] * w + col] +
        ywt[2 * o + 1] * xc[ytap[2 * o + 1] * w + col];
  }
  __syncthreads();

  // Phase 2: per output pixel, horizontal taps and the class argmax.
  for (int p = threadIdx.x; p < nrows * W; p += blockDim.x) {
    const int r = p / W;
    const int col = p % W;
    const int x0 = xtap[2 * col];
    const int x1 = xtap[2 * col + 1];
    const float w0 = xwt[2 * col];
    const float w1 = xwt[2 * col + 1];
    const float* rr = rows + r * w;
    float best = w0 * rr[x0] + w1 * rr[x1];
    int best_c = 0;
    for (int c = 1; c < C; ++c) {
      const float* rc = rows + (c * kTileRows + r) * w;
      const float v = w0 * rc[x0] + w1 * rc[x1];
      if (v > best) {  // strict: ties keep the lowest class
        best = v;
        best_c = c;
      }
    }
    out[((size_t)img * H + row0 + r) * W + col] = best_c;
  }
}

}  // namespace

// x: (n_img, C, h, w) f32; taps: (H, 2) / (W, 2) int32 indices and f32
// weights; out: (n_img, H, W) int32. Returns cudaGetLastError().
extern "C" int upsample_argmax_f32(const float* x, int n_img, int C, int h, int w,
                                   const int* ytap, const float* ywt,
                                   const int* xtap, const float* xwt,
                                   int H, int W, int32_t* out, void* stream) {
  const dim3 grid(n_img, (H + kTileRows - 1) / kTileRows);
  const size_t smem = (size_t)C * kTileRows * w * sizeof(float);  // <= 48 KB, checked by the wrapper
  upsample_argmax_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, C, h, w, ytap, ywt, xtap, xwt, H, W, out);
  return (int)cudaGetLastError();
}
