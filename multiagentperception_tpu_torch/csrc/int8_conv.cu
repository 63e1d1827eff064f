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
// and rounds y once to the output type (float32 or bfloat16); the s32
// entry point writes acc itself (the checks hold it against the plain
// version's exact sum).
//
// Launch 1, int8_quantize_*: reads the NCHW activation (float32 or bf16)
// and writes NHWC int8 scratch with Cp channels (Cin, or Cin rounded up to
// 4 when Cin is not a multiple of 16: the stem's 3 become 4, the fourth
// zero), so that K, the input channels of one tap, is contiguous for the
// tensor cores. A block transposes 32 pixels x 32 channels through shared
// memory: coalesced reads along the image row, 4-byte writes along the
// channels; at Cp = 4 a thread takes one pixel.
//
// Launch 2, int8_conv_*: implicit GEMM, M = output pixels, N = Cout,
// K = KH*KW*Cp in (kh, kw, c) order, zero-padded to Kp, a multiple of
// kBK = 64. The wrapper arranges the weights once as a (Cout, Kp) int8
// matrix in the same order. A block owns a 128-pixel x 64-channel tile;
// its 8 warps (4 along M, 2 along N) each own 32 x 32 and run
// mma.sync.m16n8k32 s8.s8 -> s32 on the tensor cores, A and B fed by
// ldmatrix from a 3-stage cp.async ring. Rows of the ring are padded to 80
// bytes, so the 8 rows an ldmatrix reads fall on distinct banks. The im2col
// gather is in the cp.async addresses: a 16-byte piece (Cp % 16 == 0) or a
// 4-byte piece (the stem) lies inside one tap; a piece outside the image
// or past K is zero-filled (src-size 0). The epilogue rescales each
// accumulator with __fmul_rn/__fadd_rn (nvcc would otherwise contract the
// multiply and the add into an FMA, one rounding fewer than the plain
// version and XLA) and writes NCHW, the layout the next BatchNorm takes.
//
// Bound on the H100: operations. At the flagship's bench batch (B*N =
// 120 at 512x512) the step's eligible convolutions are ~2.5e12
// multiply-adds, 2.5 ms at the int8 tensor cores' 1,979 TOPS dense; their
// activations, int8 scratch and outputs are ~4 GB, 1.2 ms at 3.35 TB/s.
// mma.sync reaches about half of Hopper's int8 rate (wgmma, with both
// operands K-major in shared memory, is the rest: ROADMAP B.4), and this
// first kernel keeps its tiles simple: ldmatrix per k32 step, no TMA, no
// warp specialisation, and the NCHW epilogue writes 32-byte runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBM = 128;            // output pixels a block
constexpr int kBN = 64;             // output channels a block
constexpr int kBK = 64;             // bytes of K a stage
constexpr int kStages = 3;
constexpr int kPitch = kBK + 16;    // bytes between rows of a stage: 80, bank-conflict free
constexpr int kThreads = 256;       // 8 warps: 4 along M x 2 along N, 32 x 32 each
constexpr int kStageBytes = (kBM + kBN) * kPitch;
constexpr int kQTile = 32;          // quantize pass: pixels and channels a block

struct Geometry {
  int n_img, h, w, cp, cout, kh, kw, stride, pad, oh, ow, k_real, k_pad;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ int8_t quantize(float v, float s) {
  const float q = fminf(fmaxf(__fdiv_rn(v, s), -127.f), 127.f);
  return static_cast<int8_t>(__float2int_rn(q));  // round half to even, as jnp.round
}

template <typename T>
__global__ void __launch_bounds__(256) quantize_nhwc_kernel(
    const T* __restrict__ x, const float* __restrict__ sx, int c_in, int hw, int cp,
    int8_t* __restrict__ xq) {
  __shared__ int8_t tile[kQTile][kQTile + 4];  // [pixel][channel]
  const int p0 = blockIdx.x * kQTile, c0 = blockIdx.y * kQTile, img = blockIdx.z;
  const float s = *sx;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = warp; j < kQTile; j += kThreads / 32) {
    const int c = c0 + j, p = p0 + lane;
    int8_t q = 0;  // channels past Cin: the zero padding of Cp
    if (c < c_in && p < hw) q = quantize(to_float(x[((long long)img * c_in + c) * hw + p]), s);
    tile[lane][j] = q;
  }
  __syncthreads();
  const int p = threadIdx.x >> 3, cg = (threadIdx.x & 7) * 4;
  if (p0 + p < hw && c0 + cg < cp) {
    const char4 v = make_char4(tile[p][cg], tile[p][cg + 1], tile[p][cg + 2], tile[p][cg + 3]);
    *reinterpret_cast<char4*>(xq + ((long long)img * hw + p0 + p) * cp + c0 + cg) = v;
  }
}

// Cp = 4 (the stem's 3 channels and a zero): a thread per pixel reads its
// channels (coalesced across the warp's neighbouring pixels) and writes one
// 4-byte group.
template <typename T>
__global__ void __launch_bounds__(256) quantize_nhwc4_kernel(
    const T* __restrict__ x, const float* __restrict__ sx, int c_in, int hw, long long pixels,
    int8_t* __restrict__ xq) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= pixels) return;
  const float s = *sx;
  const long long img = i / hw, p = i - img * hw;
  int8_t q[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    q[c] = c < c_in ? quantize(to_float(x[(img * c_in + c) * hw + p]), s) : int8_t(0);
  *reinterpret_cast<char4*>(xq + i * 4) = make_char4(q[0], q[1], q[2], q[3]);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int kPiece>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, bool ok) {
  if constexpr (kPiece == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(ok ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
                 "r"(ok ? 4 : 0));
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <int kPiece, typename TOut>
__global__ void __launch_bounds__(kThreads, 2) int8_conv_kernel(
    const int8_t* __restrict__ xq, const int8_t* __restrict__ wq, const float* __restrict__ sw,
    const float* __restrict__ sx, const float* __restrict__ bias, TOut* __restrict__ out,
    Geometry g) {
  constexpr int kPiecesPerRow = kBK / kPiece;           // 4 or 16
  constexpr int kRowStep = kThreads / kPiecesPerRow;    // 64 or 16
  constexpr int kRowsPerThread = kBM / kRowStep;        // 2 or 8
  __shared__ __align__(128) int8_t smem[kStages * kStageBytes];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp & 3, warp_n = warp >> 2;
  const int ohw = g.oh * g.ow;
  const long long m_total = (long long)g.n_img * ohw;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  // this thread's A rows (output pixels): image row base, first input row and column
  const int kq = tid % kPiecesPerRow;
  int row_base[kRowsPerThread], ih0[kRowsPerThread], iw0[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const long long m = m0 + tid / kPiecesPerRow + i * kRowStep;
    if (m < m_total) {
      const int img = static_cast<int>(m / ohw), pix = static_cast<int>(m % ohw);
      const int oy = pix / g.ow, ox = pix - oy * g.ow;
      row_base[i] = img * g.h;
      ih0[i] = oy * g.stride - g.pad;
      iw0[i] = ox * g.stride - g.pad;
    } else {
      row_base[i] = 0;
      ih0[i] = -(1 << 28);  // every tap falls outside: zero-filled
      iw0[i] = 0;
    }
  }
  const int b_row = tid >> 2, b_piece = tid & 3;  // B: 64 rows x 4 pieces of 16 bytes
  const bool b_ok = n0 + b_row < g.cout;
  const int8_t* b_src = wq + (long long)(b_ok ? n0 + b_row : 0) * g.k_pad + b_piece * 16;

  auto load_stage = [&](int stage, int k0) {
    int8_t* a_s = smem + stage * kStageBytes;
    int8_t* b_s = a_s + kBM * kPitch;
    const int kk = k0 + kq * kPiece;
    const int tap = kk / g.cp, c = kk - tap * g.cp;
    const int ky = tap / g.kw, kx = tap - ky * g.kw;
    const bool k_ok = kk < g.k_real;
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int iy = ih0[i] + ky, ix = iw0[i] + kx;
      const bool ok = k_ok && (unsigned)iy < (unsigned)g.h && (unsigned)ix < (unsigned)g.w;
      const int8_t* src =
          ok ? xq + ((long long)(row_base[i] + iy) * g.w + ix) * g.cp + c : xq;
      const int row = tid / kPiecesPerRow + i * kRowStep;
      cp_async<kPiece>(smem_addr(a_s + row * kPitch + kq * kPiece), src, ok);
    }
    cp_async<16>(smem_addr(b_s + b_row * kPitch + b_piece * 16), b_ok ? b_src + k0 : wq, b_ok);
  };

  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  const int k_tiles = g.k_pad / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) load_stage(s, s * kBK);
    cp_async_commit();
  }
  // ldmatrix lane offsets: A 16 rows x 32 bytes as four 8x16-byte matrices
  // (rows 0-7 | 8-15) x (bytes 0-15 | 16-31); B two n8 tiles x the two k halves
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 16;
  const int b_nrow = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 16;

  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < k_tiles) load_stage(next % kStages, next * kBK);
    cp_async_commit();

    const int8_t* a_s = smem + (kt % kStages) * kStageBytes;
    const int8_t* b_s = a_s + kBM * kPitch;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(a[mi], smem_addr(a_s + (warp_m * 32 + mi * 16 + a_row) * kPitch + ks + a_col));
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        ldmatrix_x4(r, smem_addr(b_s + (warp_n * 32 + nj * 16 + b_nrow) * kPitch + ks + b_col));
        b[2 * nj][0] = r[0];
        b[2 * nj][1] = r[1];
        b[2 * nj + 1][0] = r[2];
        b[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
  }
  cp_async_wait<0>();

  // epilogue: accumulator (row gid | gid + 8, columns 2*tig, 2*tig + 1) of each m16n8 tile
  const int gid = lane >> 2, tig = lane & 3;
  float scale[4][2], shift[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = n0 + warp_n * 32 + ni * 8 + tig * 2 + e;
      scale[ni][e] = 0.f;
      shift[ni][e] = 0.f;
      if constexpr (!std::is_same<TOut, int32_t>::value) {
        if (co < g.cout) {
          scale[ni][e] = __fmul_rn(*sx, sw[co]);  // (s_x * s_w) first, as quantize.py:118
          if (bias != nullptr) shift[ni][e] = bias[co];
        }
      }
    }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m0 + warp_m * 32 + mi * 16 + gid + half * 8;
      if (m >= m_total) continue;
      const int img = static_cast<int>(m / ohw), pix = static_cast<int>(m % ohw);
      TOut* row_out = out + (long long)img * g.cout * ohw + pix;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = n0 + warp_n * 32 + ni * 8 + tig * 2 + e;
          if (co >= g.cout) continue;
          const int v = acc[mi][ni][half * 2 + e];
          if constexpr (std::is_same<TOut, int32_t>::value) {
            row_out[(long long)co * ohw] = v;
          } else {
            float y = __fmul_rn(__int2float_rn(v), scale[ni][e]);
            if (bias != nullptr) y = __fadd_rn(y, shift[ni][e]);
            store(row_out + (long long)co * ohw, y);
          }
        }
    }
}

template <typename T>
int launch_quantize(const T* x, const float* sx, int n_img, int c_in, int hw, int cp,
                    int8_t* xq, cudaStream_t stream) {
  if (cp == 4) {
    const long long pixels = (long long)n_img * hw;
    quantize_nhwc4_kernel<T><<<static_cast<unsigned>((pixels + kThreads - 1) / kThreads),
                               kThreads, 0, stream>>>(x, sx, c_in, hw, pixels, xq);
  } else {
    const dim3 grid((hw + kQTile - 1) / kQTile, (cp + kQTile - 1) / kQTile, n_img);
    quantize_nhwc_kernel<T><<<grid, kThreads, 0, stream>>>(x, sx, c_in, hw, cp, xq);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename TOut>
int launch_conv(const int8_t* xq, const int8_t* wq, const float* sw, const float* sx,
         const float* bias, TOut* out, int n_img, int h, int w, int cp, int cout, int kh,
         int kw, int stride, int pad, int oh, int ow, int k_pad, cudaStream_t stream) {
  const Geometry g{n_img, h, w, cp, cout, kh, kw, stride, pad, oh, ow, kh * kw * cp, k_pad};
  const long long m_total = (long long)n_img * oh * ow;
  const dim3 grid(static_cast<unsigned>((m_total + kBM - 1) / kBM), (cout + kBN - 1) / kBN);
  if (cp % 16 == 0) {
    int8_conv_kernel<16, TOut><<<grid, kThreads, 0, stream>>>(xq, wq, sw, sx, bias, out, g);
  } else {
    int8_conv_kernel<4, TOut><<<grid, kThreads, 0, stream>>>(xq, wq, sw, sx, bias, out, g);
  }
  return static_cast<int>(cudaGetLastError());
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

#define INT8_CONV_ENTRY(name, TOut)                                                           \
  extern "C" int name(const int8_t* xq, const int8_t* wq, const float* sw, const float* sx,   \
                      const float* bias, TOut* out, int n_img, int h, int w, int cp,          \
                      int cout, int kh, int kw, int stride, int pad, int oh, int ow,          \
                      int k_pad, void* stream) {                                              \
    return launch_conv(xq, wq, sw, sx, bias, out, n_img, h, w, cp, cout, kh, kw, stride, pad,  \
                       oh, ow, k_pad, (cudaStream_t)stream);                                  \
  }

INT8_CONV_ENTRY(int8_conv_f32, float)
INT8_CONV_ENTRY(int8_conv_bf16, __nv_bfloat16)
INT8_CONV_ENTRY(int8_conv_s32, int32_t)
