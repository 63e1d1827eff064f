// Fused x32 bilinear upsample + class argmax for Hopper (sm_90a).
//
// Replaces the TPU kernel multiagentperception_tpu/ops/pallas/upsample_argmax.py
// (upsample_argmax_pallas -> _kernel): the class map
//     out[i, O, P] = argmax_c  sum_{h,w} Wy[O,h] * x[i,c,h,w] * Wx[P,w]
// of the decoder's pre-upsample logits, without ever writing the
// full-resolution (B*N, C, H, W) logits to device memory.
//
// Bound on the H100: bytes, in principle. The only large stream is the
// int32 class map (12 x 512 x 512 x 4 B = 12.6 MB at the flagship, ~3.8 us
// at 3.35 TB/s); the logits read is 135 KB. In practice the class loop
// bounds it: a pixel and class cost a multiply, an add, a compare and two
// selects (~1.7e8 instructions at the flagship, ~5.8 us of issue at
// 1.755 GHz over 132 SMs), which the stores hide behind.
//
// Design: one block per (image, kRows output rows), 384 blocks of 128
// threads at the flagship (kRows = 16). Phase 1 does the vertical
// interpolation of the block's rows for every class into shared memory
// ([kRows][w][C] floats, 11 KB at 16x16 logits), without dividing by a
// run-time value per value. Phase 2 gives each warp ceil(kRows / kWarps)
// rows, one after another. kRows is the largest of 16, 8, 4, 2 and 1 whose
// rows fit in the block's shared memory (the wrapper's plan, up to the
// 227 KB a block may opt in to: 16 rows hold C * w up to 3,628 floats, one
// row 58,108); where even one row does not fit, the direct kernel reads
// each pixel's four source values from device memory instead. Rows
// first, then columns: the order of the plain version's two matmuls. Every
// output row and column has at most two taps; the host passes their
// indices and weights, taken from the same _weight_matrix as the plain
// version, so the weights are bit-identical. Each pixel is w0*a + w1*b of
// its two taps, and the class loop compares with strict '>', so ties keep
// the lowest class.
//
// The span path (span4 = 1): where every aligned run of 4 output columns
// shares one tap pair (at x32 the taps change between columns 15 and 16
// mod 32) and W is a multiple of 4, which the wrapper checks for the
// (w, W) at hand, a lane owns kGroups runs of 4 columns: it loads each
// run's taps and weights once per block, reads the run's two source
// values per class from shared memory once for 4 pixels (a class's values
// sit next to each other, so at the model's 11 classes the unrolled class
// loop addresses them by immediate offsets), keeps 16 independent argmax
// chains, and writes one 16-byte int4 a run. Other shapes, and other
// class counts than the model's 11, take the per-pixel path.
//
// The logits come in float32 (upsample_argmax_f32), bfloat16
// (upsample_argmax_bf16) or float16 (upsample_argmax_f16): the
// mixed-precision models' decoder output. A bf16 or float16 value is
// converted to float32 (exactly) as phase 1 reads it, as the TPU kernel
// upcasts each class's slice (upsample_argmax.py:38); everything after,
// the shared rows included, is the float32 route's, so the shared memory a
// block holds does not depend on the type.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;   // a warp takes ceil(kRows / kWarps) consecutive rows, in turn
constexpr int kThreads = 32 * kWarps;
constexpr int kGroups = 4;     // runs of 4 columns a lane keeps in flight on the span path
constexpr int kClasses = 11;   // the model's classes: the span path's class loop is unrolled

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

// kC > 0: C == kC, known to the compiler (the span path runs at the model's
// kClasses only); kC == 0: any C. kRows: output rows a block.
template <typename T, bool kSpan4, int kC, int kRows>
__global__ void __launch_bounds__(kThreads)
upsample_argmax_kernel(const T* __restrict__ x, int C, int h, int w,
                       const int* __restrict__ ytap, const float* __restrict__ ywt,
                       const int* __restrict__ xtap, const float* __restrict__ xwt,
                       int H, int W, int32_t* __restrict__ out) {
  extern __shared__ float rows[];  // [kRows][w][C]: the vertical interpolation
  __shared__ int ty[2 * kRows];    // the block's row taps (source row offsets) and weights
  __shared__ float tw[2 * kRows];
  if (kC > 0) C = kC;
  const int img = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, H - row0);
  const int tid = threadIdx.x;
  const T* xi = x + (size_t)img * C * h * w;
  if (tid < 2 * nrows) {
    ty[tid] = ytap[2 * row0 + tid] * w;
    tw[tid] = ywt[2 * row0 + tid];
  }
  __syncthreads();

  // Phase 1: rows[r][col][c] = Wy[o, y0] x[c, y0, col] + Wy[o, y1] x[c, y1, col]
  // for o = row0 + r, col fastest (coalesced reads), without a division by
  // a run-time value per value: where w divides kThreads a thread keeps one
  // column and divides by the compile-time kC; elsewhere it steps by
  // divmod(kThreads, w) and carries.
  if (kC > 0 && kThreads % w == 0) {
    const int col = tid % w;
#pragma unroll 4
    for (int rc = tid / w; rc < nrows * kC; rc += kThreads / w) {
      const int r = rc / kC, c = rc - r * kC;
      const T* xc = xi + (size_t)c * h * w + col;
      rows[(r * w + col) * kC + c] =
          tw[2 * r] * to_float(xc[ty[2 * r]]) + tw[2 * r + 1] * to_float(xc[ty[2 * r + 1]]);
    }
  } else {
    int col = tid % w, rc = tid / w;
    int r = rc / C, c = rc % C;
    const int dcol = kThreads % w, drc = kThreads / w;
    while (r < nrows) {
      const T* xc = xi + (size_t)c * h * w + col;
      rows[(r * w + col) * C + c] =
          tw[2 * r] * to_float(xc[ty[2 * r]]) + tw[2 * r + 1] * to_float(xc[ty[2 * r + 1]]);
      col += dcol;
      c += drc;
      if (col >= w) {
        col -= w;
        ++c;
      }
      while (c >= C) {
        c -= C;
        ++r;
      }
    }
  }
  __syncthreads();

  // Phase 2: the horizontal taps and the class argmax. A warp takes its
  // rows one after another, so that a row's stores drain while the next
  // row computes.
  constexpr int kWarpRows = (kRows + kWarps - 1) / kWarps;
  const int lane = tid % 32;
  const int r_begin = (tid / 32) * kWarpRows;
  const int r_end = min(r_begin + kWarpRows, nrows);
  int32_t* const oimg = out + ((size_t)img * H + row0) * W;
  if (kSpan4) {
    for (int g0 = lane; g0 < W / 4; g0 += 32 * kGroups) {
      int xa[kGroups], xb[kGroups];  // the runs' source columns, as offsets in a row
      float w0[kGroups][4], w1[kGroups][4];
#pragma unroll
      for (int j = 0; j < kGroups; ++j) {
        const int g = min(g0 + 32 * j, W / 4 - 1);  // a ragged last iteration repeats a run
        xa[j] = xtap[8 * g] * C;
        xb[j] = xtap[8 * g + 1] * C;
        const float4 wa = reinterpret_cast<const float4*>(xwt)[2 * g];      // cols 4g, 4g+1
        const float4 wb = reinterpret_cast<const float4*>(xwt)[2 * g + 1];  // cols 4g+2, 4g+3
        w0[j][0] = wa.x; w1[j][0] = wa.y; w0[j][1] = wa.z; w1[j][1] = wa.w;
        w0[j][2] = wb.x; w1[j][2] = wb.y; w0[j][3] = wb.z; w1[j][3] = wb.w;
      }
      for (int r = r_begin; r < r_end; ++r) {
        const float* rr = rows + r * w * C;
        float best[kGroups][4];
        int best_c[kGroups][4];
#pragma unroll
        for (int j = 0; j < kGroups; ++j) {
          const float av = rr[xa[j]], bv = rr[xb[j]];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            best[j][k] = w0[j][k] * av + w1[j][k] * bv;
            best_c[j][k] = 0;
          }
        }
#pragma unroll
        for (int c = 1; c < kC; ++c) {
#pragma unroll
          for (int j = 0; j < kGroups; ++j) {
            const float av = rr[xa[j] + c], bv = rr[xb[j] + c];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float v = w0[j][k] * av + w1[j][k] * bv;
              if (v > best[j][k]) {  // strict: ties keep the lowest class
                best[j][k] = v;
                best_c[j][k] = c;
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kGroups; ++j)
          if (g0 + 32 * j < W / 4)
            reinterpret_cast<int4*>(oimg + (size_t)r * W)[g0 + 32 * j] =
                make_int4(best_c[j][0], best_c[j][1], best_c[j][2], best_c[j][3]);
      }
    }
  } else {
    for (int col = lane; col < W; col += 32) {
      const int ia = xtap[2 * col] * C, ib = xtap[2 * col + 1] * C;
      const float u0 = xwt[2 * col], u1 = xwt[2 * col + 1];
      for (int r = r_begin; r < r_end; ++r) {
        const float* rr = rows + r * w * C;
        float best = u0 * rr[ia] + u1 * rr[ib];
        int best_c = 0;
        for (int c = 1; c < C; ++c) {
          const float v = u0 * rr[ia + c] + u1 * rr[ib + c];
          if (v > best) {
            best = v;
            best_c = c;
          }
        }
        oimg[(size_t)r * W + col] = best_c;
      }
    }
  }
}

// The class map with nothing staged, for logits too wide for one staged row:
// a thread per output pixel reads its (at most) four source values of every
// class from device memory, each as phase 1 and the per-pixel path would
// combine them: rows first, then columns.
template <typename T>
__global__ void __launch_bounds__(kThreads)
upsample_argmax_direct(const T* __restrict__ x, int C, int h, int w,
                       const int* __restrict__ ytap, const float* __restrict__ ywt,
                       const int* __restrict__ xtap, const float* __restrict__ xwt, int H,
                       int W, int32_t* __restrict__ out) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= (long long)H * W) return;
  const int img = blockIdx.y, o = (int)(p / W), col = (int)(p % W);
  const T* xi = x + (size_t)img * C * h * w;
  const int y0 = ytap[2 * o] * w, y1 = ytap[2 * o + 1] * w;
  const int x0 = xtap[2 * col], x1 = xtap[2 * col + 1];
  const float t0 = ywt[2 * o], t1 = ywt[2 * o + 1], u0 = xwt[2 * col], u1 = xwt[2 * col + 1];
  float best = 0.f;
  int best_c = 0;
  for (int c = 0; c < C; ++c) {
    const T* xc = xi + (size_t)c * h * w;
    const float a = t0 * to_float(xc[y0 + x0]) + t1 * to_float(xc[y1 + x0]);
    const float b = t0 * to_float(xc[y0 + x1]) + t1 * to_float(xc[y1 + x1]);
    const float v = u0 * a + u1 * b;
    if (c == 0 || v > best) {  // strict: ties keep the lowest class
      best = v;
      best_c = c;
    }
  }
  out[(size_t)img * H * W + p] = best_c;
}

template <typename T, int kRows>
int launch_rows(const T* x, int n_img, int C, int h, int w, const int* ytap, const float* ywt,
                const int* xtap, const float* xwt, int H, int W, int span4, int32_t* out,
                cudaStream_t st) {
  const dim3 grid((H + kRows - 1) / kRows, n_img);
  const size_t smem = (size_t)kRows * C * w * sizeof(float);  // fits: the wrapper's plan
  auto kernel = upsample_argmax_kernel<T, false, 0, kRows>;
  if (span4 && C == kClasses) kernel = upsample_argmax_kernel<T, true, kClasses, kRows>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, kThreads, smem, st>>>(x, C, h, w, ytap, ywt, xtap, xwt, H, W, out);
  return (int)cudaGetLastError();
}

// rows: output rows a block stages (16, 8, 4, 2 or 1), or 0 for the direct kernel
template <typename T>
int launch(const T* x, int n_img, int C, int h, int w, const int* ytap, const float* ywt,
           const int* xtap, const float* xwt, int H, int W, int span4, int rows, int32_t* out,
           cudaStream_t st) {
  switch (rows) {
    case 16:
      return launch_rows<T, 16>(x, n_img, C, h, w, ytap, ywt, xtap, xwt, H, W, span4, out, st);
    case 8:
      return launch_rows<T, 8>(x, n_img, C, h, w, ytap, ywt, xtap, xwt, H, W, span4, out, st);
    case 4:
      return launch_rows<T, 4>(x, n_img, C, h, w, ytap, ywt, xtap, xwt, H, W, span4, out, st);
    case 2:
      return launch_rows<T, 2>(x, n_img, C, h, w, ytap, ywt, xtap, xwt, H, W, span4, out, st);
    case 1:
      return launch_rows<T, 1>(x, n_img, C, h, w, ytap, ywt, xtap, xwt, H, W, span4, out, st);
    case 0: {
      const dim3 grid((unsigned)(((long long)H * W + kThreads - 1) / kThreads), n_img);
      upsample_argmax_direct<T><<<grid, kThreads, 0, st>>>(x, C, h, w, ytap, ywt, xtap, xwt,
                                                            H, W, out);
      return (int)cudaGetLastError();
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (n_img, C, h, w) f32, bf16 or f16; taps: (H, 2) / (W, 2) int32 indices and
// f32 weights; span4: 1 if W % 4 == 0 and every aligned run of 4 output
// columns shares one tap pair, else 0; rows: the output rows a block stages
// (16, 8, 4, 2 or 1; rows * C * w floats fit in its shared memory), or 0
// for the direct kernel; out: (n_img, H, W) int32, 16-byte aligned when
// span4. Returns a cudaError_t.
extern "C" int upsample_argmax_f32(const float* x, int n_img, int C, int h, int w,
                                   const int* ytap, const float* ywt,
                                   const int* xtap, const float* xwt,
                                   int H, int W, int span4, int rows, int32_t* out,
                                   void* stream) {
  return launch(x, n_img, C, h, w, ytap, ywt, xtap, xwt, H, W, span4, rows, out,
                (cudaStream_t)stream);
}

extern "C" int upsample_argmax_bf16(const __nv_bfloat16* x, int n_img, int C, int h, int w,
                                    const int* ytap, const float* ywt,
                                    const int* xtap, const float* xwt,
                                    int H, int W, int span4, int rows, int32_t* out,
                                    void* stream) {
  return launch(x, n_img, C, h, w, ytap, ywt, xtap, xwt, H, W, span4, rows, out,
                (cudaStream_t)stream);
}

extern "C" int upsample_argmax_f16(const __half* x, int n_img, int C, int h, int w,
                                   const int* ytap, const float* ywt,
                                   const int* xtap, const float* xwt,
                                   int H, int W, int span4, int rows, int32_t* out,
                                   void* stream) {
  return launch(x, n_img, C, h, w, ytap, ywt, xtap, xwt, H, W, span4, rows, out,
                (cudaStream_t)stream);
}
