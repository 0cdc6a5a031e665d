// One edge-aware a-trous scale for Hopper (sm_90a).
//
// Replaces: ansel_tpu/kernels/eaw_pallas.py:_coarse_pallas, behind
// eaw_dn_coarse_pallas (variant 0) and eaw_atrous_coarse_pallas (variant
// 1).  For each pixel of a (3, h, w) image it sums 25 B3 taps at spacing
// d, each read at clamped coordinates (the Pallas kernel's edge padding),
// weighted by the colour distance to the centre:
//   variant 0: w = k * fast_mexp2f(max(0, |drgb|^2 * c * 0.02 - 9)),
//              shared by the channels; coarse = num * (1 / max(den, 1e-12))
//   variant 1: w0 = k * dt_fast_expf(-(d0^2) * c), wc for channels 1-2
//              from d1^2 + d2^2; coarse = num / max(den, 1e-9)
// and writes coarse and detail = x - coarse.  Operand order follows the
// Pallas kernel, and the library is built with --fmad=false, so kernel
// and plain twin (kernels/eaw.py) round alike; fast_mexp2f and
// dt_fast_expf are the reference's bit tricks (pixel/fastmath.py).
//
// What bounds it: on config 2 (24 MP, 7 scales) the memory bound is 289
// MB read + 577 MB written per scale (0.26 ms at 3.35 TB/s) and the
// arithmetic ~17 float32 operations x 25 taps per pixel (about 0.3 ms);
// the two are close.
//
// Design: one thread per pixel, the 75 tap values read through the
// L1/L2 caches.  Neighbouring threads read neighbouring addresses at
// every tap, so each warp load is coalesced; a shared-memory tile for the
// small scales is later work.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BX = 32;
constexpr int BY = 8;

__device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// jnp.maximum: NaN in either operand gives NaN (fmaxf would drop it)
__device__ __forceinline__ float jmax(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

// fast_mexp2f (math.h:306-316): the float32 sum, then truncation
__device__ __forceinline__ float fast_mexp2f(float x) {
  const float k0f = 1065353216.0f + x * -8388608.0f;
  const int k = k0f >= 8388608.0f ? (int)k0f : 0;
  return __int_as_float(k);
}

// dt_fast_expf (math.h:254-267)
__device__ __forceinline__ float dt_fast_expf(float x) {
  const int k0 = (int)(1065353216.0f + x * 11401300.0f);
  return __int_as_float(k0 > 0 ? k0 : 0);
}

__global__ void eaw_kernel(const float* __restrict__ x,
                           float* __restrict__ coarse,
                           float* __restrict__ detail, int h, int w, int d,
                           float c, int variant) {
  const int px = blockIdx.x * BX + threadIdx.x;
  const int py = blockIdx.y * BY + threadIdx.y;
  if (px >= w || py >= h) return;
  const size_t plane = (size_t)h * w;
  const float* x0p = x;
  const float* x1p = x + plane;
  const float* x2p = x + 2 * plane;
  const size_t at = (size_t)py * w + px;
  const float x0 = x0p[at], x1 = x1p[at], x2 = x2p[at];
  const float b3[5] = {1.0f / 16.0f, 4.0f / 16.0f, 6.0f / 16.0f,
                       4.0f / 16.0f, 1.0f / 16.0f};
  float num0 = 0.0f, num1 = 0.0f, num2 = 0.0f;
  float den0 = 0.0f, den1 = 0.0f;  // variant 0 uses den0 only
#pragma unroll
  for (int iy = 0; iy < 5; ++iy) {
    const size_t row = (size_t)clampi(py + (iy - 2) * d, h - 1) * w;
#pragma unroll
    for (int ix = 0; ix < 5; ++ix) {
      const size_t q = row + clampi(px + (ix - 2) * d, w - 1);
      const float s0 = __ldg(x0p + q), s1 = __ldg(x1p + q),
                  s2 = __ldg(x2p + q);
      const float k = b3[iy] * b3[ix];
      const float e0 = s0 - x0, e1 = s1 - x1, e2 = s2 - x2;
      if (variant == 0) {
        const float dist2 = e0 * e0 + e1 * e1 + e2 * e2;
        const float wt = k * fast_mexp2f(jmax(0.0f, dist2 * c * 0.02f - 9.0f));
        num0 = num0 + wt * s0;
        num1 = num1 + wt * s1;
        num2 = num2 + wt * s2;
        den0 = den0 + wt;
      } else {
        const float w0 = k * dt_fast_expf(-(e0 * e0) * c);
        const float wc = k * dt_fast_expf(-(e1 * e1 + e2 * e2) * c);
        num0 = num0 + w0 * s0;
        num1 = num1 + wc * s1;
        num2 = num2 + wc * s2;
        den0 = den0 + w0;
        den1 = den1 + wc;
      }
    }
  }
  float c0, c1, c2;
  if (variant == 0) {
    const float inv = 1.0f / jmax(den0, 1e-12f);
    c0 = num0 * inv;
    c1 = num1 * inv;
    c2 = num2 * inv;
  } else {
    c0 = num0 / jmax(den0, 1e-9f);
    c1 = num1 / jmax(den1, 1e-9f);
    c2 = num2 / jmax(den1, 1e-9f);
  }
  coarse[at] = c0;
  coarse[plane + at] = c1;
  coarse[2 * plane + at] = c2;
  detail[at] = x0 - c0;
  detail[plane + at] = x1 - c1;
  detail[2 * plane + at] = x2 - c2;
}

}  // namespace

extern "C" {

// x, coarse, detail: (3, h, w) float32 on the device; d = 2^scale; c is
// inv_sigma2 (variant 0) or sharpen (variant 1).  Launches on `stream`,
// returns cudaGetLastError().
int eaw_coarse(const float* x, float* coarse, float* detail, int h, int w,
               int d, float c, int variant, void* stream) {
  if (variant != 0 && variant != 1) return (int)cudaErrorInvalidValue;
  dim3 block(BX, BY);
  dim3 grid((w + BX - 1) / BX, (h + BY - 1) / BY);
  eaw_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(x, coarse, detail, h,
                                                       w, d, c, variant);
  return (int)cudaGetLastError();
}

}  // extern "C"
