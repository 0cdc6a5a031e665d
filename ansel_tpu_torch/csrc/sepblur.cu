// Dilated separable odd-length FIR with edge padding, for Hopper (sm_90a).
//
// Replaces: ansel_tpu/kernels/sepblur_pallas.py:sep_blur_pallas (the
// row-strip form _sep_blur_strip and its tiled fallback).  It computes
//   V[y, x]   = sum_i t_i * X[clamp(y + (i - r) d), x]
//   out[y, x] = sum_j t_j * V[y, clamp(x + (j - r) d)]
// per plane, each sum in tap order from the first tap, like the XLA chain
// of pixel/shifts.sep_filter and the plain twin (kernels/sepblur.py).
// Clamping each read coordinate is the Pallas kernel's edge padding.
//
// What bounds it: device memory, one read of X and one write of out (the
// config-2 Laplacian blur moves 24 MB in and 24 MB out per call, 14 us at
// 3.35 TB/s).
//
// Design: one kernel per call.  A block owns TH rows x TW columns of one
// plane.  It first computes V for its rows over the columns its taps read,
// each clamped to the frame, into shared memory, reading X through the
// L1/L2 caches; then each thread sums its output's taps from that strip.
// The strip is either contiguous, TW + 2m columns (m = r d, the reach),
// while the dilation d is below TW, or, from d = TW on, the n groups of TW
// columns x0 + t + (j - r) d that the taps read (n TW columns, 20 KB at
// n = 5 whatever d is), so any reach fits.  The vertical pass thus runs
// (TW + 2m) / TW or n times per output pixel.  The wrapper picks the form
// (kernels/sepblur.plan) and refuses only a tap count and dilation whose
// strip would pass 227 KB, which no caller of the port asks for.  Built
// with --fmad=false, so every product and sum rounds like the plain torch
// version.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int MAX_TAPS = 513;
constexpr int TW = 128;            // threads of a block = output columns
constexpr int TH = 8;              // output rows of a block
constexpr int MAX_SMEM = 232448;   // the most a block may have on sm_90

struct Taps {
  float t[MAX_TAPS];
};

__device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// V at strip column c: contiguous, column x0 - m + c; gathered (GATHER),
// column x0 + (c mod TW) + (c / TW - r) d
template <bool GATHER>
__global__ void sep_blur_kernel(const float* __restrict__ x,
                                float* __restrict__ out, int h, int w,
                                const Taps taps, int n, int d) {
  extern __shared__ float strip[];  // TH x sw
  const int r = (n - 1) / 2, m = r * d, sw = GATHER ? n * TW : TW + 2 * m;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const size_t plane = (size_t)h * w;
  const float* xp = x + blockIdx.z * plane;
  float* op = out + blockIdx.z * plane;
  const int rows = min(TH, h - y0);

  for (int ty = 0; ty < rows; ++ty) {
    const int y = y0 + ty;
    for (int c = threadIdx.x; c < sw; c += TW) {
      const int gx = clampi(GATHER ? x0 + (c % TW) + (c / TW - r) * d
                                   : x0 - m + c, w - 1);
      float v = taps.t[0] * __ldg(xp + (size_t)clampi(y - m, h - 1) * w + gx);
      for (int i = 1; i < n; ++i) {
        const int gy = clampi(y + (i - r) * d, h - 1);
        v = v + taps.t[i] * __ldg(xp + (size_t)gy * w + gx);
      }
      strip[ty * sw + c] = v;
    }
  }
  __syncthreads();

  const int xo = x0 + threadIdx.x;
  if (xo >= w) return;
  const int step = GATHER ? TW : d;  // strip columns between two taps
  for (int ty = 0; ty < rows; ++ty) {
    const float* row = strip + ty * sw + threadIdx.x;  // the first tap
    float acc = taps.t[0] * row[0];
    for (int j = 1; j < n; ++j) acc = acc + taps.t[j] * row[j * step];
    op[(size_t)(y0 + ty) * w + xo] = acc;
  }
}

}  // namespace

extern "C" {

void sep_blur_limits(int* max_taps, int* tile_w, int* tile_h,
                     int* max_smem) {
  *max_taps = MAX_TAPS;
  *tile_w = TW;
  *tile_h = TH;
  *max_smem = MAX_SMEM;
}

// x, out: (c, h, w) float32 on the device; taps: n floats in host memory
// (n odd, n <= MAX_TAPS); gather and smem: the strip's form and its bytes
// (kernels/sepblur.plan).  Launches on `stream`, returns the first error.
int sep_blur(const float* x, float* out, int c, int h, int w,
             const float* taps, int n, int d, int gather, int smem,
             void* stream) {
  if (n < 1 || n > MAX_TAPS || (n & 1) == 0 || d < 1 || h < 1 || w < 1)
    return (int)cudaErrorInvalidValue;
  const long long sw = gather ? (long long)n * TW
                              : TW + (long long)(n - 1) * d;
  if ((long long)TH * sw * (long long)sizeof(float) != smem || smem > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  Taps t;
  for (int i = 0; i < n; ++i) t.t[i] = taps[i];
  void (*fn)(const float*, float*, int, int, const Taps, int, int) =
      gather ? sep_blur_kernel<true> : sep_blur_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, c);
  fn<<<grid, TW, smem, (cudaStream_t)stream>>>(x, out, h, w, t, n, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
