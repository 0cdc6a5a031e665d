// The warps for Hopper (sm_90a): lens's distortion and TCA map, and
// clipping's crop / rotate / keystone map, each by bilinear gather.
//
// Replaces: ansel_tpu/kernels/warp_pallas.py:warp_bilinear (the two-pass
// Pallas resampler, driven by warp_model with lens's coordinate map, and
// through ops/_warpcommon.warp_static with clipping's).  On a GPU the
// gather is direct, so the kernel follows the JAX package's CPU form
// operation for operation.  Lens (ops/lens.py: coord, _sample_bilinear):
//   yn, xn = (y - cy) / rnorm, (x - cx) / rnorm;  r = sqrt(yn^2 + xn^2)
//   m      = the ptlens / poly3 / poly5 multiplier (or 1), / scale,
//            times the channel's TCA polynomial t0 + t1 r + t2 r^2 (R, B)
//   (sy, sx) = (cy + (y - cy) m, cx + (x - cx) m)
// Clipping (ops/clipping.py: _inverse_coords and the outside mask), with
// every constant sub-expression evaluated on the host in float64 and
// rounded to float32 once, as JAX rounds Python constants:
//   px, py = (cx' + x) + 0.5 - tpx, (cy' + y) + 0.5 - tpy
//   py /= 1 + px k_h;  px /= 1 + py k_v            (undo the shears)
//   sx, sy = m0 px + m1 py + tx, m2 px + m3 py + ty  (rotate back)
//   optional keystone: xx, yy = sx - kx, sy - ky;
//     div = (d xx - a yy) hh + (b yy - e xx) hg + ae - bd
//     sx, sy = (e xx - b yy) / div + kxa, -(d xx - a yy) / div + kya
//   (sy, sx) -= 0.5; zero where the source is outside the frame
// and both sample the four corners of (clip(floor(s), 0, n - 2)) weighted
// by clip(s - corner, 0, 1), summed in order.  Built with --fmad=false and
// true divisions, like the plain twins (kernels/warp.py).
//
// What bounds it: memory.  Three planes read and three written, 24 B per
// pixel (0.17 ms at 24 MP and 3.35 TB/s), against some 45 float32
// operations per channel-pixel for lens and about 30 per pixel for
// clipping's map.  The displacement of a crop or a small rotation is a
// shift plus a few pixels per row, so a warp's corner reads stay within
// rows the caches hold.
//
// Design: one thread per output pixel for all channels; the map is a
// functor evaluated in the kernel (no coordinate planes in device memory),
// and the sampler a device function the maps share.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <string.h>

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

// clipping's constants, as kernels/warp.CLIP_CONSTS orders them
struct ClipMap {
  float c_px, c_py, t_px, t_py, k_h, k_v, m0, m1, m2, m3, tx, ty;
  float ksp_x, ksp_y, a, b, d, e, hg, hh, ae, bd, kxa, kya;
  float out_oy, out_ox, in_oy, in_ox, w_m1, h_m1;
  int k_apply;
};
constexpr int CLIP_NCONSTS = 30;
static_assert(offsetof(ClipMap, k_apply) == CLIP_NCONSTS * sizeof(float),
              "ClipMap's constants must be contiguous floats");

// output pixel (y, x) of the buffer -> source (sy, sx) in the input
// buffer; false where the frame point falls outside the input frame
__device__ __forceinline__ bool clip_source(const ClipMap& k, int y, int x,
                                            float& sy, float& sx) {
  const float jj = (float)y + k.out_oy, ii = (float)x + k.out_ox;
  float px = (k.c_px + ii) + 0.5f, py = (k.c_py + jj) + 0.5f;
  px = px - k.t_px;
  py = py - k.t_py;
  py = py / (1.0f + px * k.k_h);
  px = px / (1.0f + py * k.k_v);
  float fx = k.m0 * px + k.m1 * py + k.tx;
  float fy = k.m2 * px + k.m3 * py + k.ty;
  if (k.k_apply) {
    const float xx = fx - k.ksp_x, yy = fy - k.ksp_y;
    const float div = (k.d * xx - k.a * yy) * k.hh +
                      (k.b * yy - k.e * xx) * k.hg + k.ae - k.bd;
    fx = (k.e * xx - k.b * yy) / div + k.kxa;
    fy = -(k.d * xx - k.a * yy) / div + k.kya;
  }
  fy = fy - 0.5f;
  fx = fx - 0.5f;
  sy = fy - k.in_oy;
  sx = fx - k.in_ox;
  return fx >= 0.0f && fx <= k.w_m1 && fy >= 0.0f && fy <= k.h_m1;
}

__global__ void clip_warp_kernel(const float* __restrict__ x,
                                 float* __restrict__ out, int c, int h, int w,
                                 int oh, int ow, const ClipMap k) {
  const int px = blockIdx.x * BX + threadIdx.x;
  const int py = blockIdx.y * BY + threadIdx.y;
  if (px >= ow || py >= oh) return;
  float sy, sx;
  const bool inside = clip_source(k, py, px, sy, sx);
  const size_t plane = (size_t)h * w, oplane = (size_t)oh * ow;
  const size_t o = (size_t)py * ow + px;
  for (int ch = 0; ch < c; ++ch)
    out[ch * oplane + o] =
        inside ? sample_bilinear(x + ch * plane, h, w, sy, sx) : 0.0f;
}

}  // namespace

extern "C" {

int clip_warp_nconsts() { return CLIP_NCONSTS; }

// x: (c, h, w), out: (c, oh, ow) float32 on the device, h, w >= 2;
// consts: the CLIP_NCONSTS float32 constants in host memory; k_apply: the
// keystone homography applies.  Launches on `stream`, returns
// cudaGetLastError().
int clip_warp(const float* x, float* out, int c, int h, int w, int oh,
              int ow, const float* consts, int k_apply, void* stream) {
  if (h < 2 || w < 2 || c < 1 || oh < 1 || ow < 1)
    return (int)cudaErrorInvalidValue;
  ClipMap k;
  memcpy(&k, consts, CLIP_NCONSTS * sizeof(float));
  k.k_apply = k_apply;
  const dim3 block(BX, BY);
  const dim3 grid((ow + BX - 1) / BX, (oh + BY - 1) / BY);
  clip_warp_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(x, out, c, h, w,
                                                               oh, ow, k);
  return (int)cudaGetLastError();
}

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
