// The fused when2com communication step for Hopper (sm_90a).
//
// Replaces the TPU kernel multiagentperception_tpu/ops/pallas/comm_fusion.py
// (fused_comm_step -> _comm_kernel). Per batch element b:
//     logits = K Q'^T                          (N x N, keys x queries)
//     soft   = softmax over keys + diag_bias I (the pre-mask graph)
//     coef   = mode mask of soft: softmax | activated (soft > thres, else 0)
//              | argmax (one-hot, lowest key index on ties)
//     fused  = coef^T V                        (N x M, M = C*h*w)
//
// Bound on the H100: bytes. V is read once and fused written once
// (2 x 2 x 6 x 131,072 x 4 B = 12.6 MB at the flagship, ~3.8 us at
// 3.35 TB/s); the graph is ~37k FMAs per batch element and the fusion
// 2*N FLOPs per byte of V.
//
// Design: grid (tiles of M, B). Every block recomputes its batch element's
// N x N graph (one warp per (key, query) dot product over D, warp-shuffle
// sum; the softmax and mask by N threads), which needs no second launch or
// grid-wide sync but is not free: at the flagship (about 2 x SMs / B blocks
// per element) each block re-reads all of Q' and K, 2 x 6 x 1024 x 4 B =
// 48 KB (from L2 after the first block), against its 24 KB share of V, and
// waits on 36 dot products before it streams anything. Fewer, larger M
// tiles per block, or the graph computed once and shared, would cut that. Then
// each thread loads one 16-byte float4 of every agent's V row at a column,
// keeps the N of them in registers and writes the N fused float4s: each V
// byte is read once, each fused byte written once, with streaming (evict-
// first) loads and stores so K and Q' stay in L2 for the other blocks.
// Block (0, b) also writes coef and soft. N <= kMaxAgents (16).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxAgents = 16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

enum Mode { kSoftmax = 0, kActivated = 1, kArgmax = 2 };

__device__ __forceinline__ void axpy4(float4& acc, float c, const float4& v) {
  acc.x += c * v.x;
  acc.y += c * v.y;
  acc.z += c * v.z;
  acc.w += c * v.w;
}

__global__ void __launch_bounds__(kThreads)
comm_fusion_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float4* __restrict__ v, float4* __restrict__ fused,
                   float* __restrict__ coef_out, float* __restrict__ soft_out,
                   int n, int d, long long m4, int mode, float diag_bias,
                   float thres) {
  __shared__ float logits[kMaxAgents * kMaxAgents];  // [key][query]
  __shared__ float coef[kMaxAgents * kMaxAgents];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* qb = q + (size_t)b * n * d;
  const float* kb = k + (size_t)b * n * d;

  for (int p = warp; p < n * n; p += kWarps) {
    const float* kr = kb + (size_t)(p / n) * d;
    const float* qr = qb + (size_t)(p % n) * d;
    float s = 0.f;
    for (int i = lane; i < d; i += 32) s += kr[i] * qr[i];
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) logits[p] = s;
  }
  __syncthreads();

  if (threadIdx.x < n) {  // one thread per query column
    const int qq = threadIdx.x;
    float mx = -INFINITY;
    for (int kk = 0; kk < n; ++kk) mx = fmaxf(mx, logits[kk * n + qq]);
    float sum = 0.f;
    for (int kk = 0; kk < n; ++kk) {
      const float e = expf(logits[kk * n + qq] - mx);
      coef[kk * n + qq] = e;
      sum += e;
    }
    int first = 0;
    float best = -INFINITY;
    for (int kk = 0; kk < n; ++kk) {
      float s = coef[kk * n + qq] / sum;
      if (kk == qq) s += diag_bias;
      coef[kk * n + qq] = s;
      if (blockIdx.x == 0) soft_out[((size_t)b * n + kk) * n + qq] = s;
      if (s > best) {  // strict: ties keep the lowest key
        best = s;
        first = kk;
      }
    }
    for (int kk = 0; kk < n; ++kk) {
      float s = coef[kk * n + qq];
      if (mode == kActivated) s = s > thres ? s : 0.f;
      if (mode == kArgmax) s = kk == first ? 1.f : 0.f;
      coef[kk * n + qq] = s;
      if (blockIdx.x == 0) coef_out[((size_t)b * n + kk) * n + qq] = s;
    }
  }
  __syncthreads();

  const float4* vb = v + (size_t)b * n * m4;
  float4* fb = fused + (size_t)b * n * m4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < m4; j += stride) {
    float4 vals[kMaxAgents];
#pragma unroll
    for (int kk = 0; kk < kMaxAgents; ++kk)
      if (kk < n) vals[kk] = __ldcs(vb + kk * m4 + j);
#pragma unroll
    for (int qq = 0; qq < kMaxAgents; ++qq) {
      if (qq < n) {
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int kk = 0; kk < kMaxAgents; ++kk)
          if (kk < n) axpy4(acc, coef[kk * n + qq], vals[kk]);
        __stcs(fb + qq * m4 + j, acc);
      }
    }
  }
}

}  // namespace

// q, k: (B, N, D) f32; v, fused: (B, N, M) f32 with M % 4 == 0 and 16-byte
// aligned rows; coef, soft: (B, N, N) f32. mode: 0 softmax, 1 activated,
// 2 argmax. Returns cudaGetLastError().
extern "C" int comm_fusion_f32(const float* q, const float* k, const float* v,
                               float* fused, float* coef, float* soft, int B, int N,
                               int D, long long M, int mode, float diag_bias,
                               float thres, void* stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long m4 = M / 4;
  // about two blocks per SM over the whole batch; each block strides over M
  long long tiles = (m4 + kThreads - 1) / kThreads;
  long long per_b = (2LL * sms + B - 1) / B;
  if (per_b < 1) per_b = 1;
  const dim3 grid((unsigned)(tiles < per_b ? tiles : per_b), B);
  comm_fusion_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      q, k, reinterpret_cast<const float4*>(v), reinterpret_cast<float4*>(fused),
      coef, soft, N, D, m4, mode, diag_bias, thres);
  return (int)cudaGetLastError();
}
