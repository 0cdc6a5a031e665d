// The lens warp for Hopper (sm_90a): distortion and TCA by bilinear gather.
//
// Replaces: ansel_tpu/kernels/warp_pallas.py:warp_bilinear (the two-pass
// Pallas resampler, driven by warp_model with lens's coordinate map).  On
// a GPU the gather is direct, so the kernel follows the JAX package's CPU
// form (ops/lens.py: coord, _sample_bilinear) operation for operation:
//   yn, xn = (y - cy) / rnorm, (x - cx) / rnorm;  r = sqrt(yn^2 + xn^2)
//   m      = the ptlens / poly3 / poly5 multiplier (or 1), / scale,
//            times the channel's TCA polynomial t0 + t1 r + t2 r^2 (R, B)
//   (sy, sx) = (cy + (y - cy) m, cx + (x - cx) m)
//   out    = the four corners of (clip(floor(s), 0, n - 2)) weighted by
//            clip(s - corner, 0, 1), summed in order
// Built with --fmad=false and true divisions, like its plain twin
// (kernels/warp.py).
//
// What bounds it: memory.  Three planes read and three written, 24 B per
// pixel (0.17 ms at 24 MP and 3.35 TB/s), against some 45 float32
// operations per channel-pixel.  The displacement is at most a few tens
// of pixels, so a warp's corner reads stay within rows the caches hold.
//
// Design: one thread per output pixel for all three channels; the map is
// evaluated in the kernel (no coordinate planes in device memory) and the
// sampler is a device function that later warps can reuse with their own
// maps.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int BX = 32;
constexpr int BY = 8;
constexpr int DIST_NONE = 0, DIST_POLY3 = 1, DIST_POLY5 = 3;
constexpr int MODIFY_TCA = 1, MODIFY_DISTORTION = 8;

// ops/lens.py:_sample_bilinear at (sy, sx) of an (h, w) plane
__device__ __forceinline__ float sample_bilinear(const float* __restrict__ p,
                                                 int h, int w, float sy,
                                                 float sx) {
  const float y0 = fminf(fmaxf(floorf(sy), 0.0f), (float)(h - 2));
  const float x0 = fminf(fmaxf(floorf(sx), 0.0f), (float)(w - 2));
  const float fy = fminf(fmaxf(sy - y0, 0.0f), 1.0f);
  const float fx = fminf(fmaxf(sx - x0, 0.0f), 1.0f);
  const float* q = p + (size_t)(int)y0 * w + (int)x0;
  return __ldg(q) * (1.0f - fy) * (1.0f - fx) + __ldg(q + 1) * (1.0f - fy) * fx +
         __ldg(q + w) * fy * (1.0f - fx) + __ldg(q + w + 1) * fy * fx;
}

struct LensMap {
  int model, flags;
  float cy, cx, rnorm;
};

// k: [a, b, c, scale, tca_r (3), tca_b (3)]
__global__ void lens_warp_kernel(const float* __restrict__ x,
                                 float* __restrict__ out, int h, int w,
                                 const float* __restrict__ k, LensMap lm) {
  const int px = blockIdx.x * BX + threadIdx.x;
  const int py = blockIdx.y * BY + threadIdx.y;
  if (px >= w || py >= h) return;
  const float a = k[0], b = k[1], c = k[2], scale = k[3];
  const float y = (float)py, xf = (float)px;
  const float yn = (y - lm.cy) / lm.rnorm;
  const float xn = (xf - lm.cx) / lm.rnorm;
  const float r = sqrtf(yn * yn + xn * xn);
  float m;
  if ((lm.flags & MODIFY_DISTORTION) && lm.model != DIST_NONE) {
    if (lm.model == DIST_POLY3) {
      m = 1.0f - a + a * r * r;
    } else if (lm.model == DIST_POLY5) {
      const float r2 = r * r;
      m = 1.0f + a * r2 + b * (r2 * r2);
    } else {  // ptlens
      m = a * (r * (r * r)) + b * (r * r) + c * r + (1.0f - a - b - c);
    }
  } else {
    m = 1.0f;
  }
  m = m / scale;
  const size_t plane = (size_t)h * w;
  const size_t o = (size_t)py * w + px;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float mc = m;
    if (ch != 1 && (lm.flags & MODIFY_TCA)) {
      const float* t = k + (ch == 0 ? 4 : 7);
      mc = m * (t[0] + t[1] * r + t[2] * r * r);
    }
    const float sy = lm.cy + (y - lm.cy) * mc;
    const float sx = lm.cx + (xf - lm.cx) * mc;
    out[ch * plane + o] = sample_bilinear(x + ch * plane, h, w, sy, sx);
  }
}

}  // namespace

extern "C" {

// x, out: (3, h, w) float32 on the device, h, w >= 2; k: the 10 packed
// coefficients on the device (kernels/warp.pack_consts).  Launches on
// `stream`, returns cudaGetLastError().
int lens_warp(const float* x, float* out, const float* k, int h, int w,
              int model, int flags, float cy, float cx, float rnorm,
              void* stream) {
  if (h < 2 || w < 2 || model < 0 || model > 3)
    return (int)cudaErrorInvalidValue;
  const LensMap lm = {model, flags, cy, cx, rnorm};
  const dim3 block(BX, BY);
  const dim3 grid((w + BX - 1) / BX, (h + BY - 1) / BY);
  lens_warp_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(x, out, h, w, k,
                                                               lm);
  return (int)cudaGetLastError();
}

}  // extern "C"
