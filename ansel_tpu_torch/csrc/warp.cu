// The warps for Hopper (sm_90a): lens's distortion and TCA map,
// clipping's crop / rotate / keystone map and ashift's homography, each
// by bilinear gather, and liquify's brush displacement over its stamps.
//
// Replaces: ansel_tpu/kernels/warp_pallas.py:warp_bilinear (the two-pass
// Pallas resampler, driven by warp_model with lens's and liquify's
// coordinate maps, and through ops/_warpcommon.warp_static with
// clipping's and ashift's).  On a GPU the gather is direct, so the kernel
// follows the JAX package's CPU form operation for operation.  Lens
// (ops/lens.py: coord, _sample_bilinear):
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
// Ashift (ops/ashift.py:161-184): the inverse homography m, rounded to 12
// digits on the host and then to float32,
//   den = m6 x + m7 y + m8, 1e-9 where |den| < 1e-9
//   sx = (m0 x + m1 y + m2) / den, sy = (m3 x + m4 y + m5) / den
//   zero where the source is outside [0, w - 1] x [0, h - 1]
// Liquify (ops/liquify.py:248-308, the per-pixel form every backend but
// the TPU runs): over the stamp-union window, the displacement
//   d(p) = -sum_k where(r_k(p) < 1, clip(poly_k(r_k), 0, 1), 0) . S_k(p)
// with r_k = |p - c_k| / R_k, poly_k a degree-8 polynomial in Horner
// form and S_k the stamp's vector or, for a radial stamp, its magnitude
// times (p - c_k) / R_k times +1 or -1; then src = p + d(p), sampled from
// the whole frame and written into a copy of it.
// All sample the four corners of (clip(floor(s), 0, n - 2)) weighted by
// clip(s - corner, 0, 1), summed in order.  Built with --fmad=false and
// true divisions, like the plain twins (kernels/warp.py).
//
// What bounds it: memory.  Three planes read and three written, 24 B per
// pixel (0.17 ms at 24 MP and 3.35 TB/s), against some 45 float32
// operations per channel-pixel for lens, about 30 per pixel for
// clipping's map and 20 for the homography.  Liquify adds about 40
// operations per pixel and stamp whose disc holds the pixel, which a
// real brush path keeps to a few dozen per pixel.  The displacement of a
// crop, a small rotation or a brush is a shift plus a few pixels per
// row, so a warp's corner reads stay within rows the caches hold.
//
// Design: one thread per output pixel for all channels; the map is a
// functor evaluated in the kernel (no coordinate planes in device memory),
// and the sampler a device function the maps share.  Liquify's kernel
// runs over the stamp-union window only, one 16 x 16 tile a block: the
// stamps pass through shared memory in chunks of 256, each with a flag
// (set by the thread that loads it) for whether its disc can reach the
// tile; the block skips the others together.  The skip is exact, since a
// stamp at r >= 1 adds -(+-0) to the sum, which leaves it as it is, and
// the flag is conservative: a disc grown by 1% of its radius and 2 px.

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

// ashift's inverse homography, as kernels/warp.HOMOGRAPHY_CONSTS orders
// it (row-major), with the source frame's last row and column
struct HomographyMap {
  float m[9];
  float w_m1, h_m1;
};
constexpr int HOMOGRAPHY_NCONSTS = 9;

__device__ __forceinline__ bool homography_source(const HomographyMap& k,
                                                  int y, int x, float& sy,
                                                  float& sx) {
  const float ys = (float)y, xs = (float)x;
  float den = k.m[6] * xs + k.m[7] * ys + k.m[8];
  den = fabsf(den) < 1e-9f ? 1e-9f : den;
  sx = (k.m[0] * xs + k.m[1] * ys + k.m[2]) / den;
  sy = (k.m[3] * xs + k.m[4] * ys + k.m[5]) / den;
  return sx >= 0.0f && sx <= k.w_m1 && sy >= 0.0f && sy <= k.h_m1;
}

struct ClipSource {
  ClipMap k;
  __device__ bool operator()(int y, int x, float& sy, float& sx) const {
    return clip_source(k, y, x, sy, sx);
  }
};
struct HomographySource {
  HomographyMap k;
  __device__ bool operator()(int y, int x, float& sy, float& sx) const {
    return homography_source(k, y, x, sy, sx);
  }
};

// a static map's warp of (c, h, w) onto (c, oh, ow), zero outside
template <class Map>
__global__ void map_warp_kernel(const float* __restrict__ x,
                                float* __restrict__ out, int c, int h, int w,
                                int oh, int ow, const Map map) {
  const int px = blockIdx.x * BX + threadIdx.x;
  const int py = blockIdx.y * BY + threadIdx.y;
  if (px >= ow || py >= oh) return;
  float sy, sx;
  const bool inside = map(py, px, sy, sx);
  const size_t plane = (size_t)h * w, oplane = (size_t)oh * ow;
  const size_t o = (size_t)py * ow + px;
  for (int ch = 0; ch < c; ++ch)
    out[ch * oplane + o] =
        inside ? sample_bilinear(x + ch * plane, h, w, sy, sx) : 0.0f;
}

template <class Map>
int launch_map(const float* x, float* out, int c, int h, int w, int oh,
               int ow, const Map& map, cudaStream_t stream) {
  const dim3 block(BX, BY);
  const dim3 grid((ow + BX - 1) / BX, (oh + BY - 1) / BY);
  map_warp_kernel<Map><<<grid, block, 0, stream>>>(x, out, c, h, w, oh, ow,
                                                   map);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- liquify
// one stamp: centre, radius, vector, magnitude, radial sign, falloff
// polynomial (highest power first), as kernels/warp.STAMP_FIELDS orders it
constexpr int STAMP = 16;
constexpr int S_PX = 0, S_PY = 1, S_R = 2, S_SX = 3, S_SY = 4, S_SMAG = 5,
              S_RADIAL = 6, S_POLY = 7, POLY_TERMS = 9;
constexpr int LT = 16;          // a block's tile: LT x LT pixels
constexpr int CHUNK = LT * LT;  // stamps staged per pass, one per thread

// one pixel's displacement: acc -= the stamp's term, in the order of
// liquify.py:_dmap (Horner's degree-8 polynomial from f = 0, the clip and
// the disc test as selects, the radial term ((f smag) dx / R) radial)
__device__ __forceinline__ void stamp_term(const float* s, float xx, float yy,
                                           float& ax, float& ay) {
  const float dx = xx - s[S_PX], dy = yy - s[S_PY];
  const float d = sqrtf(dx * dx + dy * dy) / s[S_R];
  float f = 0.0f;
#pragma unroll
  for (int k = 0; k < POLY_TERMS; ++k) f = f * d + s[S_POLY + k];
  f = d < 1.0f ? fminf(fmaxf(f, 0.0f), 1.0f) : 0.0f;
  float tx, ty;
  if (s[S_RADIAL] != 0.0f) {
    tx = f * s[S_SMAG] * dx / s[S_R] * s[S_RADIAL];
    ty = f * s[S_SMAG] * dy / s[S_R] * s[S_RADIAL];
  } else {
    tx = f * s[S_SX];
    ty = f * s[S_SY];
  }
  ax = ax - tx;
  ay = ay - ty;
}

// window (y0, x0, wh, ww) of out (a copy of x) <- x sampled at the
// displaced positions; stamps: (k, STAMP) float32
__global__ void __launch_bounds__(CHUNK)
liquify_kernel(const float* __restrict__ x, float* __restrict__ out, int c,
               int h, int w, int y0, int x0, int wh, int ww,
               const float* __restrict__ stamps, int k) {
  __shared__ float sst[CHUNK][STAMP + 1];
  __shared__ int keep[CHUNK];
  const int t = threadIdx.y * LT + threadIdx.x;
  const int ty0 = y0 + blockIdx.y * LT, tx0 = x0 + blockIdx.x * LT;
  const int py = ty0 + threadIdx.y, px = tx0 + threadIdx.x;
  const float yy = (float)py, xx = (float)px;
  // the tile's pixel centres span [tx0, tx1] x [ty0, ty1]
  const float tx1 = (float)(tx0 + LT - 1), ty1 = (float)(ty0 + LT - 1);
  float ax = 0.0f, ay = 0.0f;
  for (int base = 0; base < k; base += CHUNK) {
    const int n = min(CHUNK, k - base);
    if (t < n) {
      const float* src = stamps + (size_t)(base + t) * STAMP;
#pragma unroll
      for (int f = 0; f < STAMP; ++f) sst[t][f] = src[f];
      const float cx = sst[t][S_PX], cy = sst[t][S_PY];
      const float gx = fmaxf(fmaxf((float)tx0 - cx, cx - tx1), 0.0f);
      const float gy = fmaxf(fmaxf((float)ty0 - cy, cy - ty1), 0.0f);
      const float reach = sst[t][S_R] * 1.01f + 2.0f;
      keep[t] = gx * gx + gy * gy < reach * reach;
    }
    __syncthreads();
    for (int j = 0; j < n; ++j)
      if (keep[j]) stamp_term(sst[j], xx, yy, ax, ay);
    __syncthreads();
  }
  if (py >= y0 + wh || px >= x0 + ww) return;
  const float sx = xx + ax, sy = yy + ay;
  const size_t plane = (size_t)h * w, o = (size_t)py * w + px;
  for (int ch = 0; ch < c; ++ch)
    out[ch * plane + o] = sample_bilinear(x + ch * plane, h, w, sy, sx);
}

}  // namespace

extern "C" {

int clip_warp_nconsts() { return CLIP_NCONSTS; }
int homography_warp_nconsts() { return HOMOGRAPHY_NCONSTS; }
int liquify_stamp_floats() { return STAMP; }

// x: (c, h, w), out: (c, oh, ow) float32 on the device, h, w >= 2;
// consts: the CLIP_NCONSTS float32 constants in host memory; k_apply: the
// keystone homography applies.  Launches on `stream`, returns
// cudaGetLastError().
int clip_warp(const float* x, float* out, int c, int h, int w, int oh,
              int ow, const float* consts, int k_apply, void* stream) {
  if (h < 2 || w < 2 || c < 1 || oh < 1 || ow < 1)
    return (int)cudaErrorInvalidValue;
  ClipSource map;
  memcpy(&map.k, consts, CLIP_NCONSTS * sizeof(float));
  map.k.k_apply = k_apply;
  return launch_map(x, out, c, h, w, oh, ow, map, (cudaStream_t)stream);
}

// x: (c, h, w), out: (c, oh, ow) float32 on the device, h, w >= 2;
// consts: the 9 float32 entries of the inverse homography (row-major) in
// host memory.  Launches on `stream`, returns cudaGetLastError().
int homography_warp(const float* x, float* out, int c, int h, int w, int oh,
                    int ow, const float* consts, void* stream) {
  if (h < 2 || w < 2 || c < 1 || oh < 1 || ow < 1)
    return (int)cudaErrorInvalidValue;
  HomographySource map;
  memcpy(map.k.m, consts, HOMOGRAPHY_NCONSTS * sizeof(float));
  map.k.w_m1 = (float)(w - 1);
  map.k.h_m1 = (float)(h - 1);
  return launch_map(x, out, c, h, w, oh, ow, map, (cudaStream_t)stream);
}

// x, out: (c, h, w) float32 on the device, out a copy of x, h, w >= 2;
// the window (y0, x0, wh, ww) inside the frame; stamps: (k, STAMP)
// float32 on the device.  Launches on `stream`, returns
// cudaGetLastError().
int liquify_warp(const float* x, float* out, int c, int h, int w, int y0,
                 int x0, int wh, int ww, const float* stamps, int k,
                 void* stream) {
  if (h < 2 || w < 2 || c < 1 || wh < 1 || ww < 1 || k < 1 || y0 < 0 ||
      x0 < 0 || y0 + wh > h || x0 + ww > w)
    return (int)cudaErrorInvalidValue;
  const dim3 block(LT, LT);
  const dim3 grid((ww + LT - 1) / LT, (wh + LT - 1) / LT);
  liquify_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      x, out, c, h, w, y0, x0, wh, ww, stamps, k);
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
