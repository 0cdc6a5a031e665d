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
// the whole frame; outside the window the frame is copied.
// All sample the four corners of (clip(floor(s), 0, n - 2)) weighted by
// clip(s - corner, 0, 1), summed in order.  Built with --fmad=false and
// true divisions, like the plain twins (kernels/warp.py).
//
// What bounds it: memory and instruction issue, about equally.  Three
// planes read and three written, 24 B per pixel (0.17 ms at 24 MP and
// 3.35 TB/s), against some 45 float32 operations per channel-pixel for
// lens, about 30 per pixel for clipping's map and 20 for the homography,
// with true divisions and the sampler's clamps: some 130-200 instructions
// a pixel, 0.1-0.16 ms of issue at 24 MP.  Liquify adds about 40
// operations per pixel and stamp whose disc holds the pixel, which a
// real brush path keeps to a few per pixel.
//
// Design.  Lens: one thread per output pixel, for its three channels, in
// 32 x 8 blocks, each corner read straight from device memory.  Clipping,
// ashift and liquify: a block of 4 warps owns a 32 x 16 output tile, each
// thread a run of 4 pixels along x, so a row's stores are float4 where
// the output's rows are 16-byte aligned.  Pass 1 evaluates the map (a
// functor: no coordinate planes in device memory) at the thread's pixels,
// keeps each one's corners and weights in registers, and reduces the
// tile's source box: the rows and columns of every corner the sampler
// will read, clamped as it clamps them (warp reductions, then shared
// atomics).  When the box's C planes fit the staging budget (at most
// STAGE_FLOATS; the wrapper passes kernels/warp.TILE's), the block copies
// it into shared memory with cp.async (16 bytes a copy, the box widened
// to 4-column multiples, where the input's rows are 16-byte aligned; 4
// bytes otherwise; a warp's lanes take several rows at once, no division
// a copy) and pass 2 reads the four corners from there; otherwise the
// tile samples device memory directly, through the same corner and blend
// functions, and adds one to a device counter of direct tiles that the
// wrapper reads.  Either way each output value is the same float32
// operations on the same corner values.  The 24 KB budget holds a 45
// degree rotation of a tile (a 36 x 40 box of three planes) and the
// keystones clipping and ashift apply.  Registers are capped at 64 a
// thread, so an SM holds 8 blocks, whose copies and sampling overlap;
// the tiles are not made persistent.  Measured on an H100 (PERF.md, row
// 9), the same kernel with a budget of 0, every tile direct, runs
// clipping 12%, ashift 23% and liquify 3% slower.  Lens keeps the
// one-pixel direct gather because the tiled form measured slower there:
// its three positions a pixel, held across the barriers, halve the warps
// an SM holds.
// Liquify's kernel covers the whole frame with the same tiles and writes
// every output pixel, so the wrapper copies nothing: a tile outside the
// stamp-union window is a float4 copy; a tile in it first compacts, per
// chunk of 128 stamps (one a thread), those whose disc (grown by 1% of
// its radius and 2 px) can reach the tile's window pixels into a list in
// shared memory, a block prefix sum over the keep flags in the stamps'
// own order, and its pixels sum over that list alone.  The skip is exact,
// since a stamp at r >= 1 adds -(+-0) to the sum, which leaves it as it
// is.  Then the displaced positions' box is staged as above, or the tile
// is direct.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

namespace {

// A block's output tile is TW x TH: each thread owns a run of RUN
// pixels along x in one of its rows.  Lens: LX x LY blocks, a pixel a
// thread.
constexpr int TW = 32;
constexpr int WARPS = 4;
constexpr int NT = 32 * WARPS;       // threads a block
constexpr int RUN = 4;
constexpr int TPR = TW / RUN;        // threads a tile row
constexpr int TH = NT / TPR;
constexpr int MIN_BLOCKS = 8;        // blocks an SM holds, at least
constexpr int STAGE_FLOATS = 6144;   // the staging budget: 24 KB
constexpr int LX = 32, LY = 8;
constexpr unsigned FULL = 0xffffffffu;
constexpr int DIST_NONE = 0, DIST_POLY3 = 1, DIST_POLY5 = 3;
constexpr int MODIFY_TCA = 1, MODIFY_DISTORTION = 8;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ops/lens.py:_sample_bilinear at (sy, sx) of an (h, w) plane: the
// top-left corner (iy, ix) and the weights (fy, fx)
__device__ __forceinline__ void corner(int h, int w, float sy, float sx,
                                       int& iy, int& ix, float& fy,
                                       float& fx) {
  const float y0 = fminf(fmaxf(floorf(sy), 0.0f), (float)(h - 2));
  const float x0 = fminf(fmaxf(floorf(sx), 0.0f), (float)(w - 2));
  fy = fminf(fmaxf(sy - y0, 0.0f), 1.0f);
  fx = fminf(fmaxf(sx - x0, 0.0f), 1.0f);
  iy = (int)y0;
  ix = (int)x0;
}

// the four corners from q on (rows `stride` apart), summed in order;
// GLOBAL: q is in device memory, read through the read-only cache
template <bool GLOBAL>
__device__ __forceinline__ float load(const float* q) {
  if constexpr (GLOBAL)
    return __ldg(q);
  else
    return *q;
}

template <bool GLOBAL>
__device__ __forceinline__ float blend(const float* q, int stride, float fy,
                                       float fx) {
  return load<GLOBAL>(q) * (1.0f - fy) * (1.0f - fx) +
         load<GLOBAL>(q + 1) * (1.0f - fy) * fx +
         load<GLOBAL>(q + stride) * fy * (1.0f - fx) +
         load<GLOBAL>(q + stride + 1) * fy * fx;
}

// The tile's source box: rows [b[0], b[1]] and columns [b[2], b[3]] of
// every corner its pixels read.  Each thread folds its own corners in,
// then a warp reduction and one shared atomic per warp; `b` set to
// (INT_MAX, INT_MIN, INT_MAX, INT_MIN) before, and read after, a barrier.
__device__ __forceinline__ void reduce_box(int* b, int ylo, int yhi, int xlo,
                                           int xhi) {
  ylo = __reduce_min_sync(FULL, ylo);
  yhi = __reduce_max_sync(FULL, yhi);
  xlo = __reduce_min_sync(FULL, xlo);
  xhi = __reduce_max_sync(FULL, xhi);
  if ((threadIdx.x & 31) == 0) {
    atomicMin(b, ylo);
    atomicMax(b + 1, yhi);
    atomicMin(b + 2, xlo);
    atomicMax(b + 3, xhi);
  }
}

// A staged box: its first row and column, rows, row length (floats).
struct Box {
  int y0, x0, rows, cols;
};

// The box of `b` (after reduce_box and a barrier), its columns widened to
// multiples of 4 when `vec`; staged = it is empty or its c planes fit
// `budget` floats, and then copied into `stage` (the copies issued, not
// awaited).  An unstaged tile adds one to *direct.
__device__ __forceinline__ bool stage_box(const int* b,
                                          const float* __restrict__ x, int c,
                                          int h, int w, bool vec, int budget,
                                          float* stage, Box& box,
                                          int* __restrict__ direct) {
  if (b[0] > b[1]) {  // no pixel of the tile reads the source
    box = {0, 0, 0, 0};
    return true;
  }
  box.y0 = b[0];
  box.rows = b[1] - b[0] + 1;
  box.x0 = vec ? b[2] & ~3 : b[2];
  box.cols = (vec ? (b[3] + 4) & ~3 : b[3] + 1) - box.x0;
  if ((long long)c * box.rows * box.cols > budget) {
    if (threadIdx.x == 0) atomicAdd(direct, 1);
    return false;
  }
  // a warp's lanes take `rpw` rows of `per` copies each at once (one
  // division a block, none a copy), or one row in turns where a row
  // needs more copies than a warp has lanes
  const size_t plane = (size_t)h * w;
  const int per = vec ? box.cols / 4 : box.cols;  // copies a row
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rpw = per <= 32 ? 32 / per : 1;
  const int lr = per <= 32 ? lane / per : 0, lk = lane - lr * per;
  if (lr >= rpw) return true;
  for (int ch = 0; ch < c; ++ch) {
    const float* src0 = x + ch * plane + (size_t)box.y0 * w + box.x0;
    float* dst0 = stage + ch * box.rows * box.cols;
    for (int r = warp * rpw + lr; r < box.rows; r += WARPS * rpw) {
      const float* src = src0 + (size_t)r * w;
      float* dst = dst0 + r * box.cols;
      for (int k = lk; k < per; k += 32) {
        if (vec)
          cp_async16(dst + 4 * k, src + 4 * k);
        else
          cp_async4(dst + k, src + k);
      }
    }
  }
  return true;
}

// a thread's run of values of one output row: one float4 store where
// `vec4`, else a store per pixel inside the row
__device__ __forceinline__ void store_run(float* __restrict__ p,
                                          const float (&v)[RUN], bool vec4,
                                          int valid) {
  static_assert(RUN == 4, "a run is one float4");
  if (vec4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int i = 0; i < RUN; ++i)
    if (i < valid) p[i] = v[i];
}

struct LensMap {
  int model, flags;
  float cy, cx, rnorm;
};

// lens's warp of (3, h, w), a pixel a thread; k: [a, b, c, scale, tca_r
// (3), tca_b (3)] in device memory
__global__ void lens_warp_kernel(const float* __restrict__ x,
                                 float* __restrict__ out, int h, int w,
                                 const float* __restrict__ k, LensMap lm) {
  const int px = blockIdx.x * LX + threadIdx.x;
  const int py = blockIdx.y * LY + threadIdx.y;
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
    int iy, ix;
    float fy, fx;
    corner(h, w, lm.cy + (y - lm.cy) * mc, lm.cx + (xf - lm.cx) * mc, iy, ix,
           fy, fx);
    out[ch * plane + o] =
        blend<true>(x + ch * plane + (size_t)iy * w + ix, w, fy, fx);
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

// clipping's map: output pixel (y, x) of the buffer -> source (sy, sx) in
// the input buffer; false where the frame point falls outside the input
// frame
struct ClipSource {
  ClipMap k;
  __device__ bool operator()(int y, int x, float& sy, float& sx) const {
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
};

// ashift's inverse homography, as kernels/warp.HOMOGRAPHY_CONSTS orders
// it (row-major), with the source frame's last row and column
struct HomographyMap {
  float m[9];
  float w_m1, h_m1;
};
constexpr int HOMOGRAPHY_NCONSTS = 9;

struct HomographySource {
  HomographyMap k;
  __device__ bool operator()(int y, int x, float& sy, float& sx) const {
    const float ys = (float)y, xs = (float)x;
    float den = k.m[6] * xs + k.m[7] * ys + k.m[8];
    den = fabsf(den) < 1e-9f ? 1e-9f : den;
    sx = (k.m[0] * xs + k.m[1] * ys + k.m[2]) / den;
    sy = (k.m[3] * xs + k.m[4] * ys + k.m[5]) / den;
    return sx >= 0.0f && sx <= k.w_m1 && sy >= 0.0f && sy <= k.h_m1;
  }
};

// a static map's warp of (c, h, w) onto (c, oh, ow), zero outside the
// source frame; boxes staged up to `budget` <= STAGE_FLOATS floats
template <class Map>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
    map_warp_kernel(const float* __restrict__ x, float* __restrict__ out,
                    int c, int h, int w, int oh, int ow, const Map map,
                    int budget, int* __restrict__ direct) {
  __shared__ float4 stage4[STAGE_FLOATS / 4];  // 16-byte aligned: cp.async
  float* stage = reinterpret_cast<float*>(stage4);
  __shared__ int b[4];
  const int t = threadIdx.x;
  const int py = blockIdx.y * TH + t / TPR;
  const int px0 = blockIdx.x * TW + (t % TPR) * RUN;
  if (t == 0) {
    b[0] = b[2] = INT_MAX;
    b[1] = b[3] = INT_MIN;
  }
  // pass 1: the map at the thread's pixels, each one's corners and
  // weights kept in registers, and the box of every corner the tile reads
  int iy[RUN], ix[RUN];
  float fy[RUN], fx[RUN];
  bool in[RUN];
  int ylo = INT_MAX, yhi = INT_MIN, xlo = INT_MAX, xhi = INT_MIN;
#pragma unroll
  for (int i = 0; i < RUN; ++i) {
    float sy, sx;
    in[i] = py < oh && px0 + i < ow && map(py, px0 + i, sy, sx);
    if (!in[i]) continue;
    corner(h, w, sy, sx, iy[i], ix[i], fy[i], fx[i]);
    ylo = min(ylo, iy[i]);
    yhi = max(yhi, iy[i] + 1);
    xlo = min(xlo, ix[i]);
    xhi = max(xhi, ix[i] + 1);
  }
  __syncthreads();
  reduce_box(b, ylo, yhi, xlo, xhi);
  __syncthreads();
  const bool vec_in = w % 4 == 0 && ((uintptr_t)x & 15) == 0;
  Box box;
  const bool staged =
      stage_box(b, x, c, h, w, vec_in, budget, stage, box, direct);
  if (staged) cp_async_wait_all();
  __syncthreads();
  if (py >= oh) return;
  // pass 2: the corners read from the staged box, or from device memory
  const size_t plane = (size_t)h * w, oplane = (size_t)oh * ow;
  const bool vec4 = ow % 4 == 0 && ((uintptr_t)out & 15) == 0 &&
                    px0 + RUN <= ow;
  for (int ch = 0; ch < c; ++ch) {
    float v[RUN];
#pragma unroll
    for (int i = 0; i < RUN; ++i) {
      v[i] = 0.0f;
      if (!in[i]) continue;
      v[i] = staged ? blend<false>(stage +
                                       (ch * box.rows + iy[i] - box.y0) *
                                           box.cols +
                                       ix[i] - box.x0,
                                   box.cols, fy[i], fx[i])
                    : blend<true>(x + ch * plane + (size_t)iy[i] * w + ix[i],
                                  w, fy[i], fx[i]);
    }
    store_run(out + ch * oplane + (size_t)py * ow + px0, v, vec4, ow - px0);
  }
}

template <class Map>
int launch_map(const float* x, float* out, int c, int h, int w, int oh,
               int ow, const Map& map, int budget, int* direct,
               cudaStream_t stream) {
  const dim3 grid((ow + TW - 1) / TW, (oh + TH - 1) / TH);
  map_warp_kernel<Map><<<grid, NT, 0, stream>>>(x, out, c, h, w, oh, ow, map,
                                                budget, direct);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- liquify
// one stamp: centre, radius, vector, magnitude, radial sign, falloff
// polynomial (highest power first), as kernels/warp.STAMP_FIELDS orders it
constexpr int STAMP = 16;
constexpr int S_PX = 0, S_PY = 1, S_R = 2, S_SX = 3, S_SY = 4, S_SMAG = 5,
              S_RADIAL = 6, S_POLY = 7, POLY_TERMS = 9;
constexpr int CHUNK = NT;  // stamps tested per pass, one per thread
static_assert(CHUNK * STAMP <= STAGE_FLOATS,
              "a chunk's kept stamps fit the staging buffer");

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

// out (c, h, w) <- x, its window (y0, x0, wh, ww) resampled at the
// displaced positions; stamps: (k, STAMP) float32; boxes staged up to
// `budget` <= STAGE_FLOATS floats
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
    liquify_kernel(const float* __restrict__ x, float* __restrict__ out,
                   int c, int h, int w, int y0, int x0, int wh, int ww,
                   const float* __restrict__ stamps, int k, int budget,
                   int* __restrict__ direct) {
  // the kept stamps, then the staged box; 16-byte aligned for cp.async
  __shared__ float4 smem4[STAGE_FLOATS / 4];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ int b[4];
  __shared__ int kept_by_warp[WARPS];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int ty0 = blockIdx.y * TH, tx0 = blockIdx.x * TW;
  const int py = ty0 + t / TPR, px0 = tx0 + (t % TPR) * RUN;
  const int wy1 = y0 + wh, wx1 = x0 + ww;
  const size_t plane = (size_t)h * w;
  const bool vec4 = w % 4 == 0 && ((uintptr_t)x & 15) == 0 &&
                    ((uintptr_t)out & 15) == 0 && px0 + RUN <= w;
  const size_t o = (size_t)py * w + px0;
  if (ty0 >= wy1 || ty0 + TH <= y0 || tx0 >= wx1 || tx0 + TW <= x0) {
    // a tile outside the window: the frame's copy
    if (py >= h) return;
    for (int ch = 0; ch < c; ++ch) {
      if (vec4) {
        *reinterpret_cast<float4*>(out + ch * plane + o) =
            __ldg(reinterpret_cast<const float4*>(x + ch * plane + o));
      } else {
        for (int i = 0; i < RUN && px0 + i < w; ++i)
          out[ch * plane + o + i] = __ldg(x + ch * plane + o + i);
      }
    }
    return;
  }
  if (t == 0) {
    b[0] = b[2] = INT_MAX;
    b[1] = b[3] = INT_MIN;
  }
  // the tile's window pixels: centres in [cx0, cx1] x [cy0, cy1]
  const float cx0 = (float)max(tx0, x0), cx1 = (float)(min(tx0 + TW, wx1) - 1);
  const float cy0 = (float)max(ty0, y0), cy1 = (float)(min(ty0 + TH, wy1) - 1);
  const float yy = (float)py;
  float ax[RUN], ay[RUN];
#pragma unroll
  for (int i = 0; i < RUN; ++i) ax[i] = ay[i] = 0.0f;
  for (int base = 0; base < k; base += CHUNK) {
    bool keep = false;
    const float* src = stamps + (size_t)(base + t) * STAMP;
    if (base + t < k) {
      const float cx = src[S_PX], cy = src[S_PY];
      const float gx = fmaxf(fmaxf(cx0 - cx, cx - cx1), 0.0f);
      const float gy = fmaxf(fmaxf(cy0 - cy, cy - cy1), 0.0f);
      const float reach = src[S_R] * 1.01f + 2.0f;
      keep = gx * gx + gy * gy < reach * reach;
    }
    // the kept stamps' places in the list, in the stamps' order
    const unsigned mask = __ballot_sync(FULL, keep);
    if (lane == 0) kept_by_warp[warp] = __popc(mask);
    __syncthreads();
    int pos = __popc(mask & ((1u << lane) - 1u)), n = 0;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) {
      pos += i < warp ? kept_by_warp[i] : 0;
      n += kept_by_warp[i];
    }
    if (keep) {
#pragma unroll
      for (int f = 0; f < STAMP; ++f) smem[pos * STAMP + f] = src[f];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float* s = smem + j * STAMP;
#pragma unroll
      for (int i = 0; i < RUN; ++i)
        stamp_term(s, (float)(px0 + i), yy, ax[i], ay[i]);
    }
    __syncthreads();
  }
  bool in[RUN];
  int iy[RUN], ix[RUN];
  float fy[RUN], fx[RUN];
  int ylo = INT_MAX, yhi = INT_MIN, xlo = INT_MAX, xhi = INT_MIN;
#pragma unroll
  for (int i = 0; i < RUN; ++i) {
    const int px = px0 + i;
    in[i] = py >= y0 && py < wy1 && px >= x0 && px < wx1;
    if (!in[i]) continue;
    corner(h, w, yy + ay[i], (float)px + ax[i], iy[i], ix[i], fy[i], fx[i]);
    ylo = min(ylo, iy[i]);
    yhi = max(yhi, iy[i] + 1);
    xlo = min(xlo, ix[i]);
    xhi = max(xhi, ix[i] + 1);
  }
  reduce_box(b, ylo, yhi, xlo, xhi);
  __syncthreads();
  const bool vec_in = w % 4 == 0 && ((uintptr_t)x & 15) == 0;
  Box box;
  const bool staged =
      stage_box(b, x, c, h, w, vec_in, budget, smem, box, direct);
  if (staged) cp_async_wait_all();
  __syncthreads();
  if (py >= h) return;
  for (int ch = 0; ch < c; ++ch) {
    float v[RUN];
#pragma unroll
    for (int i = 0; i < RUN; ++i) {
      if (!in[i]) {
        v[i] = px0 + i < w ? __ldg(x + ch * plane + o + i) : 0.0f;
        continue;
      }
      v[i] = staged ? blend<false>(smem +
                                       (ch * box.rows + iy[i] - box.y0) *
                                           box.cols +
                                       ix[i] - box.x0,
                                   box.cols, fy[i], fx[i])
                    : blend<true>(x + ch * plane + (size_t)iy[i] * w + ix[i],
                                  w, fy[i], fx[i]);
    }
    store_run(out + ch * plane + o, v, vec4, w - px0);
  }
}

}  // namespace

extern "C" {

int clip_warp_nconsts() { return CLIP_NCONSTS; }
int homography_warp_nconsts() { return HOMOGRAPHY_NCONSTS; }
int liquify_stamp_floats() { return STAMP; }

// the staged maps' tile (rows, columns) and largest staging budget in
// floats
void warp_limits(int* tile_h, int* tile_w, int* stage_floats) {
  *tile_h = TH;
  *tile_w = TW;
  *stage_floats = STAGE_FLOATS;
}

// x: (c, h, w), out: (c, oh, ow) float32 on the device, h, w >= 2;
// consts: the CLIP_NCONSTS float32 constants in host memory; k_apply: the
// keystone homography applies; budget: the staging budget in floats, 0
// to STAGE_FLOATS (0: every tile that reads the source is direct);
// direct: one int on the device, to which each tile that samples device
// memory directly adds one.  Launches on `stream`, returns
// cudaGetLastError().
int clip_warp(const float* x, float* out, int c, int h, int w, int oh,
              int ow, const float* consts, int k_apply, int budget,
              int* direct, void* stream) {
  if (h < 2 || w < 2 || c < 1 || oh < 1 || ow < 1 || budget < 0 ||
      budget > STAGE_FLOATS)
    return (int)cudaErrorInvalidValue;
  ClipSource map;
  memcpy(&map.k, consts, CLIP_NCONSTS * sizeof(float));
  map.k.k_apply = k_apply;
  return launch_map(x, out, c, h, w, oh, ow, map, budget, direct,
                    (cudaStream_t)stream);
}

// x: (c, h, w), out: (c, h, w) float32 on the device, h, w >= 2;
// consts: the 9 float32 entries of the inverse homography (row-major) in
// host memory; budget and direct as for clip_warp.  Launches on
// `stream`, returns cudaGetLastError().
int homography_warp(const float* x, float* out, int c, int h, int w,
                    const float* consts, int budget, int* direct,
                    void* stream) {
  if (h < 2 || w < 2 || c < 1 || budget < 0 || budget > STAGE_FLOATS)
    return (int)cudaErrorInvalidValue;
  HomographySource map;
  memcpy(map.k.m, consts, HOMOGRAPHY_NCONSTS * sizeof(float));
  map.k.w_m1 = (float)(w - 1);
  map.k.h_m1 = (float)(h - 1);
  return launch_map(x, out, c, h, w, h, w, map, budget, direct,
                    (cudaStream_t)stream);
}

// x, out: (c, h, w) float32 on the device, h, w >= 2, out written whole;
// the window (y0, x0, wh, ww) inside the frame; stamps: (k, STAMP)
// float32 on the device; budget and direct as for clip_warp.  Launches
// on `stream`, returns cudaGetLastError().
int liquify_warp(const float* x, float* out, int c, int h, int w, int y0,
                 int x0, int wh, int ww, const float* stamps, int k,
                 int budget, int* direct, void* stream) {
  if (h < 2 || w < 2 || c < 1 || wh < 1 || ww < 1 || k < 1 || y0 < 0 ||
      x0 < 0 || y0 + wh > h || x0 + ww > w || budget < 0 ||
      budget > STAGE_FLOATS)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH);
  liquify_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      x, out, c, h, w, y0, x0, wh, ww, stamps, k, budget, direct);
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
  const dim3 block(LX, LY);
  const dim3 grid((w + LX - 1) / LX, (h + LY - 1) / LY);
  lens_warp_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      x, out, h, w, k, LensMap{model, flags, cy, cx, rnorm});
  return (int)cudaGetLastError();
}

}  // extern "C"
