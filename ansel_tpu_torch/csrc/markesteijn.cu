// X-Trans Markesteijn demosaic, 1 or 3 passes, for Hopper (sm_90a).
//
// Replaces: ansel_tpu/kernels/markesteijn_pallas.py:xtrans_markesteijn_pallas
// (its pallas_call runs _mark_tile once per haloed tile).  On an (h, w)
// X-Trans mosaic it computes, per pixel of the frame edge-padded by `pad`:
//   gmin, gmax  over the six hex neighbours
//   G[0..3]     the four directional greens, clipped to [gmin, gmax]
//   R, B[0..3]  solitary-green R/B, then R@B / B@R, then the 2x2-green fill
//   (3 passes)  two green recalculation sweeps, each with a fresh R/B set
//   drv[d]      the YPbPr second derivative along direction d % 4
//   cnt[d]      3x3 count of drv[d] <= 8 min_d drv[d](centre)
// and for each image pixel the 5x5 sum of cnt, the vote over the 4 (or 8)
// directions whose sum reaches 7/8 of the best, and max(., 0).  Every sum
// and product follows the Pallas kernel's operand order (its _green_dirs,
// _sg_rb, _rb_opposite, _g22_fill, _green_recalc, _vote) and the library is
// built with --fmad=false, so kernel and plain twin (kernels/markesteijn.py)
// round alike and take the same discrete decisions.
//
// Boundary and phase: like the Pallas kernel, every pixel takes its CFA
// class from its image coordinate (pad is a multiple of 6), and the pad
// carries edge-replicated mosaic values.  Reads that leave the padded
// frame are clamped to it; the result reaches at most 11 px, so no output
// pixel sees them.
//
// What bounds it: at 24 MP, 1 pass, the compulsory traffic of the mosaic
// read once and three planes written once (16 B/px, 0.115 ms at
// 3.35 TB/s), level with the float32 work of about 317 operations per
// pixel, each step counted at the sites that need it (0.114 ms at
// 67 TFLOP/s; 3 passes: about 698, 0.25 ms).  The Pallas kernel keeps a
// whole tile's direction buffers in VMEM.
//
// Design: a short sequence of full-frame passes over padded scratch planes
// that the wrapper allocates, one thread per pixel, neighbour reads through
// the L1/L2 caches: green, solitary-green, R@B/B@R, 2x2 fill (the last
// three again per recalculation sweep), derivatives, counts, vote.  Each
// pass writes fresh planes, since every update reads its input plane at
// neighbouring pixels.  The 22 scratch planes of 1 pass take 2.2 GB at
// 24 MP; the seven passes read and write about 103 planes of the padded
// frame, some 10 GB (3.0 ms at 3.35 TB/s), many times the bound.  A
// shared-memory tile that keeps the chain on chip is later work.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BX = 32;
constexpr int BY = 8;

struct Geo {
  signed char hex[9][8][2];  // (dy, dx) by class (row % 3) * 3 + col % 3
  signed char pair[9][4];    // hex 2i + hex 2i+1 != (0, 0)
  unsigned char pat[36];     // colour of (row % 6, col % 6)
  int sgrow, sgcol;
};

struct Frame {
  const float* x;  // the (h, w) mosaic
  int h, w, pad, hp, wp;
};

struct Set4 {
  float* p[4];
};

__device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// jnp.minimum / jnp.maximum: NaN in either operand gives NaN
__device__ __forceinline__ float jmin(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}
__device__ __forceinline__ float jmax(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}
__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return jmin(jmax(v, lo), hi);
}

// mosaic value at padded (y, x): the edge-extended frame
__device__ __forceinline__ float X(const Frame& f, int y, int x) {
  return __ldg(f.x + (size_t)clampi(y - f.pad, f.h - 1) * f.w +
               clampi(x - f.pad, f.w - 1));
}

// a scratch plane at padded (y, x), clamped to the padded frame
__device__ __forceinline__ float P(const float* p, const Frame& f, int y,
                                   int x) {
  return p[(size_t)clampi(y, f.hp - 1) * f.wp + clampi(x, f.wp - 1)];
}

__device__ __forceinline__ int color_at(const Geo& g, int y, int x) {
  return g.pat[(y % 6) * 6 + x % 6];
}

__device__ __forceinline__ bool row_sg(const Geo& g, int y) {
  return (y + 3 - g.sgrow) % 3 == 0;
}

__device__ __forceinline__ bool col_sg(const Geo& g, int x) {
  return (x + 3 - g.sgcol) % 3 == 0;
}

#define PIXEL                                            \
  const int x = blockIdx.x * BX + threadIdx.x;           \
  const int y = blockIdx.y * BY + threadIdx.y;           \
  if (x >= f.wp || y >= f.hp) return;                    \
  const size_t o = (size_t)y * f.wp + x;                 \
  const int cls = (y % 3) * 3 + x % 3;                   \
  const int color = color_at(g, y, x);

// gmin, gmax and the four directional greens (_green_dirs)
__global__ void mk_green(const __grid_constant__ Frame f,
                      const __grid_constant__ Geo g, float* gmin_p,
                      float* gmax_p, const __grid_constant__ Set4 G) {
  PIXEL
  const signed char(*hx)[2] = g.hex[cls];
  const float xc = X(f, y, x);
  float gv[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) gv[k] = X(f, y + hx[k][0], x + hx[k][1]);
  float gmin = gv[0], gmax = gv[0];
#pragma unroll
  for (int k = 1; k < 6; ++k) {
    gmin = jmin(gmin, gv[k]);
    gmax = jmax(gmax, gv[k]);
  }
  gmin_p[o] = gmin;
  gmax_p[o] = gmax;
  if (color == 1) {
#pragma unroll
    for (int d = 0; d < 4; ++d) G.p[d][o] = xc;
    return;
  }
  float col[4];
  {
    const float h0x2 = X(f, y + 2 * hx[0][0], x + 2 * hx[0][1]);
    const float h1x2 = X(f, y + 2 * hx[1][0], x + 2 * hx[1][1]);
    col[0] = 0.6796875f * (gv[1] + gv[0]) - 0.1796875f * (h1x2 + h0x2);
    const float f_mh2 = X(f, y - hx[2][0], x - hx[2][1]);
    col[1] = 0.87109375f * gv[3] + 0.13f * gv[2] + 0.359375f * (xc - f_mh2);
  }
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int k = 4 + c;
    const float g_mh2 = X(f, y - 2 * hx[k][0], x - 2 * hx[k][1]);
    const float f_p3 = X(f, y + 3 * hx[k][0], x + 3 * hx[k][1]);
    const float f_m3 = X(f, y - 3 * hx[k][0], x - 3 * hx[k][1]);
    col[2 + c] = 0.640625f * gv[k] + 0.359375f * g_mh2 +
                 0.12890625f * (2.0f * xc - f_p3 - f_m3);
  }
  const bool flip = row_sg(g, y);
#pragma unroll
  for (int d = 0; d < 4; ++d)
    G.p[d][o] = clip(flip ? col[d ^ 1] : col[d], gmin, gmax);
}

// the R/B planes of one set before the fills: the mosaic's own colour, with
// the solitary-green estimates (_sg_rb)
__global__ void mk_sg_rb(const __grid_constant__ Frame f,
                      const __grid_constant__ Geo g,
                      const __grid_constant__ Set4 G,
                      const __grid_constant__ Set4 R,
                      const __grid_constant__ Set4 B) {
  PIXEL
  const float xc = X(f, y, x);
  const bool sg = color == 1 && row_sg(g, y) && col_sg(g, x);
  if (!sg) {
    const float r = color == 0 ? xc : 0.0f, b = color == 2 ? xc : 0.0f;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      R.p[d][o] = r;
      B.p[d][o] = b;
    }
    return;
  }
  const bool right_red = g.pat[(y % 6) * 6 + (x + 1) % 6] == 0;
  const int GI[6] = {0, 1, 2, 2, 3, 3};
  float er[6], eb[6], diff[6];
#pragma unroll
  for (int d = 0; d < 6; ++d) {
    const bool axis_h = d % 2 == 0;
    const float* gd = G.p[GI[d]];
    const float gc = P(gd, f, y, x);
    float est[2];
    float df = 0.0f;
#pragma unroll
    for (int dist = 1; dist <= 2; ++dist) {
      const int dy = axis_h ? 0 : dist, dx = axis_h ? dist : 0;
      const float gp = P(gd, f, y + dy, x + dx), gm = P(gd, f, y - dy, x - dx);
      const float fp = X(f, y + dy, x + dx), fm = X(f, y - dy, x - dx);
      const float gterm = 2.0f * gc - gp - gm;
      est[dist - 1] = gterm + fp + fm;
      if (d > 1) {
        const float t = gp - gm - fp + fm;
        df = df + t * t + gterm * gterm;
      }
    }
    const bool base_is_red = axis_h ? right_red : !right_red;
    er[d] = base_is_red ? est[0] : est[1];
    eb[d] = base_is_red ? est[1] : est[0];
    diff[d] = df;
  }
  const int pick[4] = {0, 1, diff[2] < diff[3] ? 2 : 3,
                       diff[4] < diff[5] ? 4 : 5};
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    R.p[d][o] = er[pick[d]] / 2.0f;
    B.p[d][o] = eb[pick[d]] / 2.0f;
  }
}

// R at blue and B at red sites (_rb_opposite): Rin/Bin -> Rout/Bout
__global__ void mk_rb_opposite(const __grid_constant__ Frame f,
                            const __grid_constant__ Geo g,
                            const __grid_constant__ Set4 G,
                            const __grid_constant__ Set4 Rin,
                            const __grid_constant__ Set4 Bin,
                            const __grid_constant__ Set4 Rout,
                            const __grid_constant__ Set4 Bout) {
  PIXEL
  const bool rsg = row_sg(g, y);
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const float* gd = G.p[d];
    const float* rb[2] = {Rin.p[d], Bin.p[d]};
    float* out[2] = {Rout.p[d], Bout.p[d]};
    if (color == 1) {
      out[0][o] = rb[0][o];
      out[1][o] = rb[1][o];
      continue;
    }
    const float gc = gd[o];
    bool use_c = true;
    if (d <= 1) {
      float grad_c, grad_h;
      if (rsg) {
        grad_c = fabsf(gc - P(gd, f, y, x + 1)) + fabsf(gc - P(gd, f, y, x - 1));
        grad_h = fabsf(gc - P(gd, f, y + 3, x)) + fabsf(gc - P(gd, f, y - 3, x));
      } else {
        grad_c = fabsf(gc - P(gd, f, y + 1, x)) + fabsf(gc - P(gd, f, y - 1, x));
        grad_h = fabsf(gc - P(gd, f, y, x + 3)) + fabsf(gc - P(gd, f, y, x - 3));
      }
      const bool parity_ok = d % 2 == 0 ? rsg : !rsg;
      use_c = parity_ok || grad_c < 2.0f * grad_h;
    }
    int dy, dx;
    if (use_c) {
      dy = rsg ? 0 : 1;
      dx = rsg ? 1 : 0;
    } else {
      dy = rsg ? 3 : 0;
      dx = rsg ? 0 : 3;
    }
    const float gp = P(gd, f, y + dy, x + dx), gm = P(gd, f, y - dy, x - dx);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      // the plane of the colour this site lacks: R at blue, B at red
      const bool site = (c == 0) ? color == 2 : color == 0;
      if (!site) {
        out[c][o] = rb[c][o];
        continue;
      }
      const float pp = P(rb[c], f, y + dy, x + dx);
      const float pm = P(rb[c], f, y - dy, x - dx);
      out[c][o] = (pp + pm + 2.0f * gc - gp - gm) / 2.0f;
    }
  }
}

// R/B at the 2x2 greens (_g22_fill): Rin/Bin -> Rout/Bout
__global__ void mk_g22_fill(const __grid_constant__ Frame f,
                         const __grid_constant__ Geo g,
                         const __grid_constant__ Set4 G,
                         const __grid_constant__ Set4 Rin,
                         const __grid_constant__ Set4 Bin,
                         const __grid_constant__ Set4 Rout,
                         const __grid_constant__ Set4 Bout) {
  PIXEL
  const bool g22 = color == 1 && !row_sg(g, y) && !col_sg(g, x);
  const signed char(*hx)[2] = g.hex[cls];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* rb[2] = {Rin.p[i], Bin.p[i]};
    float* out[2] = {Rout.p[i], Bout.p[i]};
    if (!g22) {
      out[0][o] = rb[0][o];
      out[1][o] = rb[1][o];
      continue;
    }
    const int k = 2 * i;
    const float* gd = G.p[i];
    const float gc = gd[o];
    const float g_h0 = P(gd, f, y + hx[k][0], x + hx[k][1]);
    const float g_h1 = P(gd, f, y + hx[k + 1][0], x + hx[k + 1][1]);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float p_h0 = P(rb[c], f, y + hx[k][0], x + hx[k][1]);
      const float p_h1 = P(rb[c], f, y + hx[k + 1][0], x + hx[k + 1][1]);
      out[c][o] = g.pair[cls][i]
                      ? ((3.0f * gc - 2.0f * g_h0 - g_h1) + 2.0f * p_h0 + p_h1) / 3.0f
                      : ((2.0f * gc - g_h0 - g_h1) + p_h0 + p_h1) / 2.0f;
    }
  }
}

// one step of the green recalculation (_green_recalc): buffer i of Gout
// is buffer i of Gin, updated at non-green pixels on the rows `sense[i]`
// selects (1: the solitary-green rows, 0: the others) with hex direction
// dir[i]; dir[i] = 0 copies it
struct Recalc {
  int dir[4];
  int sense[4];
};

__global__ void mk_green_recalc(const __grid_constant__ Frame f,
                             const __grid_constant__ Geo g,
                             const float* gmin_p, const float* gmax_p,
                             const __grid_constant__ Set4 Gin,
                             const __grid_constant__ Set4 R,
                             const __grid_constant__ Set4 B,
                             const __grid_constant__ Set4 Gout,
                             const __grid_constant__ Recalc rc) {
  PIXEL
  const bool rsg = row_sg(g, y);
  const signed char(*hx)[2] = g.hex[cls];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* gi = Gin.p[i];
    const int d = rc.dir[i];
    if (d == 0 || color == 1 || rsg != (rc.sense[i] != 0)) {
      Gout.p[i][o] = gi[o];
      continue;
    }
    const int hy = hx[d][0], hxx = hx[d][1];
    const float g_h = P(gi, f, y + hy, x + hxx);
    const float g_m2h = P(gi, f, y - 2 * hy, x - 2 * hxx);
    // the neighbour's own colour plane: R at red sites, B elsewhere
    const int y1 = clampi(y + hy, f.hp - 1), x1 = clampi(x + hxx, f.wp - 1);
    const int y2 = clampi(y - 2 * hy, f.hp - 1),
              x2 = clampi(x - 2 * hxx, f.wp - 1);
    const float f_h = (color_at(g, y1, x1) == 0 ? R.p[i] : B.p[i])
        [(size_t)y1 * f.wp + x1];
    const float f_m2h = (color_at(g, y2, x2) == 0 ? R.p[i] : B.p[i])
        [(size_t)y2 * f.wp + x2];
    const float val = (g_m2h + 2.0f * g_h - f_m2h - 2.0f * f_h +
                       3.0f * X(f, y, x)) / 3.0f;
    Gout.p[i][o] = clip(val, gmin_p[o], gmax_p[o]);
  }
}

struct Set8 {
  const float* p[8];
};

__device__ __forceinline__ void ypbpr(const Set8& R, const Set8& G,
                                      const Set8& B, int d, const Frame& f,
                                      int y, int x, float* yuv) {
  const float r = P(R.p[d], f, y, x), gg = P(G.p[d], f, y, x),
              b = P(B.p[d], f, y, x);
  const float yy = 0.2627f * r + 0.6780f * gg + 0.0593f * b;
  yuv[0] = yy;
  yuv[1] = (b - yy) * 0.56433f;
  yuv[2] = (r - yy) * 0.67815f;
}

// drv[d]: the YPbPr second derivative along direction d % 4
template <int NDIR>
__global__ void mk_derivatives(const __grid_constant__ Frame f,
                            const __grid_constant__ Geo g,
                            const __grid_constant__ Set8 R,
                            const __grid_constant__ Set8 G,
                            const __grid_constant__ Set8 B, float* drv) {
  PIXEL
  const size_t plane = (size_t)f.hp * f.wp;
  const int DY[4] = {0, 1, 1, 1}, DX[4] = {1, 0, 1, -1};
#pragma unroll
  for (int d = 0; d < NDIR; ++d) {
    float c[3], p[3], m[3];
    ypbpr(R, G, B, d, f, y, x, c);
    ypbpr(R, G, B, d, f, y + DY[d % 4], x + DX[d % 4], p);
    ypbpr(R, G, B, d, f, y - DY[d % 4], x - DX[d % 4], m);
    float dd = 0.0f;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float t = 2.0f * c[ch] - p[ch] - m[ch];
      dd = dd + t * t;
    }
    drv[d * plane + o] = dd;
  }
}

// cnt[d]: 3x3 count of drv[d] <= 8 min_d drv[d](centre)
template <int NDIR>
__global__ void mk_homogeneity(const __grid_constant__ Frame f,
                            const __grid_constant__ Geo g, const float* drv,
                            float* cnt) {
  PIXEL
  const size_t plane = (size_t)f.hp * f.wp;
  float tr = drv[o];
#pragma unroll
  for (int d = 1; d < NDIR; ++d) tr = jmin(tr, drv[d * plane + o]);
  tr = tr * 8.0f;
#pragma unroll
  for (int d = 0; d < NDIR; ++d) {
    float c = 0.0f;
#pragma unroll
    for (int vv = -1; vv <= 1; ++vv)
#pragma unroll
      for (int hh = -1; hh <= 1; ++hh)
        c = c + (P(drv + d * plane, f, y + vv, x + hh) <= tr ? 1.0f : 0.0f);
    cnt[d * plane + o] = c;
  }
}

// the 5x5 sums, the vote and max(., 0), written to the (3, h, w) output
template <int NDIR>
__global__ void mk_vote(const __grid_constant__ Frame f,
                     const __grid_constant__ Set8 R,
                     const __grid_constant__ Set8 G,
                     const __grid_constant__ Set8 B, const float* cnt,
                     float* out) {
  const int ix = blockIdx.x * BX + threadIdx.x;
  const int iy = blockIdx.y * BY + threadIdx.y;
  if (ix >= f.w || iy >= f.h) return;
  const int y = iy + f.pad, x = ix + f.pad;
  const size_t plane = (size_t)f.hp * f.wp;
  const size_t o = (size_t)y * f.wp + x;
  float homo[NDIR];
  float maxval = 0.0f;
#pragma unroll
  for (int d = 0; d < NDIR; ++d) {
    float acc = 0.0f;
#pragma unroll
    for (int vv = -2; vv <= 2; ++vv)
#pragma unroll
      for (int hh = -2; hh <= 2; ++hh)
        acc = acc + P(cnt + d * plane, f, y + vv, x + hh);
    homo[d] = acc;
    maxval = d == 0 ? acc : jmax(maxval, acc);
  }
  const float thresh = maxval - maxval / 8.0f;
  float nr = 0.0f, ng = 0.0f, nb = 0.0f, den = 0.0f;
#pragma unroll
  for (int d = 0; d < NDIR; ++d) {
    const float sel = homo[d] >= thresh ? 1.0f : 0.0f;
    nr = nr + sel * R.p[d][o];
    ng = ng + sel * G.p[d][o];
    nb = nb + sel * B.p[d][o];
    den = den + sel;
  }
  den = jmax(den, 1.0f);
  const size_t q = (size_t)iy * f.w + ix;
  const size_t oplane = (size_t)f.h * f.w;
  out[q] = jmax(nr / den, 0.0f);
  out[oplane + q] = jmax(ng / den, 0.0f);
  out[2 * oplane + q] = jmax(nb / den, 0.0f);
}

Set4 set4(float* base, size_t plane, int first) {
  Set4 s;
  for (int i = 0; i < 4; ++i) s.p[i] = base + (first + i) * plane;
  return s;
}

}  // namespace

extern "C" {

// x: (h, w) float32 mosaic on the device; out: (3, h, w); scratch: 22
// (passes 1) or 54 (passes 3) planes of (h + 2 pad, w + 2 pad) float32;
// table: the host geometry of kernels/markesteijn.geometry_table (9 x 8 x 2
// hex offsets, sgrow, sgcol, 9 x 4 pair flags, 36 colours).  Launches on
// `stream`, returns the first launch error.
int markesteijn(const float* x, float* out, float* scratch, int h, int w,
                int passes, int pad, const int* table, void* stream) {
  if (h < 1 || w < 1 || (passes != 1 && passes != 3) || pad < 12 ||
      pad % 6 != 0)
    return (int)cudaErrorInvalidValue;
  Geo g;
  const int* t = table;
  for (int c = 0; c < 9; ++c)
    for (int k = 0; k < 8; ++k)
      for (int j = 0; j < 2; ++j) {
        const int v = *t++;
        if (v < -2 || v > 2) return (int)cudaErrorInvalidValue;
        g.hex[c][k][j] = (signed char)v;
      }
  g.sgrow = *t++;
  g.sgcol = *t++;
  for (int c = 0; c < 9; ++c)
    for (int i = 0; i < 4; ++i) g.pair[c][i] = (signed char)(*t++ != 0);
  for (int i = 0; i < 36; ++i) {
    const int v = *t++;
    if (v < 0 || v > 2) return (int)cudaErrorInvalidValue;
    g.pat[i] = (unsigned char)v;
  }
  if (g.sgrow < 0 || g.sgrow > 2 || g.sgcol < 0 || g.sgcol > 2)
    return (int)cudaErrorInvalidValue;

  const Frame f = {x, h, w, pad, h + 2 * pad, w + 2 * pad};
  const size_t plane = (size_t)f.hp * f.wp;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 block(BX, BY);
  const dim3 grid((f.wp + BX - 1) / BX, (f.hp + BY - 1) / BY);
  cudaError_t err;
#define CHECK                                                \
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  // planes: 0 gmin, 1 gmax, 2-5 G, 6-9 R, 10-13 B, 14-21 temporaries;
  // 3 passes: 22-25 and 26-29 G of the second set, 30-33 R, 34-37 B,
  // 38-45 derivatives, 46-53 counts
  float* gmin = scratch;
  float* gmax = scratch + plane;
  const Set4 G1 = set4(scratch, plane, 2), R1 = set4(scratch, plane, 6),
             B1 = set4(scratch, plane, 10), TR = set4(scratch, plane, 14),
             TB = set4(scratch, plane, 18);

  mk_green<<<grid, block, 0, st>>>(f, g, gmin, gmax, G1);
  CHECK
  // one R/B set for the greens Gs: solitary greens into (R, B), the
  // opposite colours into the temporaries, the 2x2 fill back into (R, B)
  auto one_set = [&](const Set4& Gs, const Set4& R, const Set4& B) {
    mk_sg_rb<<<grid, block, 0, st>>>(f, g, Gs, R, B);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    mk_rb_opposite<<<grid, block, 0, st>>>(f, g, Gs, R, B, TR, TB);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    mk_g22_fill<<<grid, block, 0, st>>>(f, g, Gs, TR, TB, R, B);
    return cudaGetLastError();
  };
  if ((err = one_set(G1, R1, B1)) != cudaSuccess) return (int)err;

  const dim3 grid_o((w + BX - 1) / BX, (h + BY - 1) / BY);
  Set8 R, G, B;
  for (int i = 0; i < 4; ++i) {
    R.p[i] = R1.p[i];
    G.p[i] = G1.p[i];
    B.p[i] = B1.p[i];
  }
  if (passes == 3) {
    const Set4 Ga = set4(scratch, plane, 22), Gb = set4(scratch, plane, 26),
               R2 = set4(scratch, plane, 30), B2 = set4(scratch, plane, 34);
    // d = 3 on buffers 0 (solitary-green rows) and 1, d = 4 on 2 and 3
    // (solitary-green rows); then d = 5 on 2 (solitary-green rows) and 3
    const Recalc first = {{3, 3, 4, 4}, {1, 0, 0, 1}};
    const Recalc second = {{0, 0, 5, 5}, {0, 0, 1, 0}};
    Set4 Gs = G1, Rs = R1, Bs = B1;
    for (int sweep = 0; sweep < 2; ++sweep) {
      mk_green_recalc<<<grid, block, 0, st>>>(f, g, gmin, gmax, Gs, Rs, Bs, Ga,
                                           first);
      CHECK
      mk_green_recalc<<<grid, block, 0, st>>>(f, g, gmin, gmax, Ga, Rs, Bs, Gb,
                                           second);
      CHECK
      if ((err = one_set(Gb, R2, B2)) != cudaSuccess) return (int)err;
      Gs = Gb;
      Rs = R2;
      Bs = B2;
    }
    for (int i = 0; i < 4; ++i) {
      R.p[4 + i] = R2.p[i];
      G.p[4 + i] = Gb.p[i];
      B.p[4 + i] = B2.p[i];
    }
    float* drv = scratch + 38 * plane;
    float* cnt = scratch + 46 * plane;
    mk_derivatives<8><<<grid, block, 0, st>>>(f, g, R, G, B, drv);
    CHECK
    mk_homogeneity<8><<<grid, block, 0, st>>>(f, g, drv, cnt);
    CHECK
    mk_vote<8><<<grid_o, block, 0, st>>>(f, R, G, B, cnt, out);
    CHECK
  } else {
    float* drv = scratch + 14 * plane;
    float* cnt = scratch + 18 * plane;
    mk_derivatives<4><<<grid, block, 0, st>>>(f, g, R, G, B, drv);
    CHECK
    mk_homogeneity<4><<<grid, block, 0, st>>>(f, g, drv, cnt);
    CHECK
    mk_vote<4><<<grid_o, block, 0, st>>>(f, R, G, B, cnt, out);
    CHECK
  }
#undef CHECK
  return (int)cudaSuccess;
}

}  // extern "C"
