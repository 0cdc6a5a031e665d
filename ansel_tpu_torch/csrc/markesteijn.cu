// X-Trans Markesteijn demosaic, 1 or 3 passes, for Hopper (sm_90a).
//
// Replaces: ansel_tpu/kernels/markesteijn_pallas.py:xtrans_markesteijn_pallas
// (its pallas_call runs _mark_tile once per haloed tile).  On an (h, w)
// X-Trans mosaic, edge-extended, it computes per pixel:
//   gmin, gmax  over the six hex neighbours
//   G[0..3]     the four directional greens, clipped to [gmin, gmax]
//   R, B[0..3]  solitary-green R/B, then R@B / B@R, then the 2x2-green fill
//   (3 passes)  two green recalculation sweeps, each with a fresh R/B set
//   drv[d]      the YPbPr second derivative along direction d % 4
//   cnt[d]      3x3 count of drv[d] <= 8 min_d drv[d](centre)
// and for each image pixel the 5x5 sum of cnt, the vote over the 4 (or 8)
// directions whose sum reaches 7/8 of the best, and max(., 0).  Every sum
// and product follows the Pallas kernel's operand order (its _green_dirs,
// _sg_rb, _rb_opposite, _g22_fill, _green_recalc, _vote) with IEEE
// divisions, and the library is built with --fmad=false, so kernel and
// plain twin (kernels/markesteijn.py) round alike and take the same
// discrete decisions; min/max keep NaN in one instruction (min.NaN.f32,
// max.NaN.f32), as jnp.minimum / jnp.maximum do.
//
// What bounds it: at 24 MP, 1 pass, about 317 float32 operations a pixel,
// each step counted at the sites that need it (0.23 ms issued alone at
// 33.5 T instructions/s, --fmad=false), against 16 B/px of compulsory
// traffic (0.115 ms at 3.35 TB/s); 3 passes about 698 (0.50 ms).
//
// Design: one launch.  A block owns a 32 x 32 output tile.  Before the
// vote, direction buffer d depends only on G[d], the mosaic and gmin/gmax
// (the 3-pass recalculation of buffer d reads only buffer d of the set
// before), so the direction chains need not meet until the vote: the
// block's two thread groups each run two of them (buffers g and g + 2)
// one after another on planes of their own, G[d] -> R, B[d] (-> the
// recalculated sets for 3 passes) -> drv[d] (and drv[4 + d]), each group
// behind its own named barrier, so one group's barrier waits overlap the
// other's work.  drv is kept over the tile and 3 px, and each thread keeps
// its own pixels' R, G, B per direction in registers (a shift register:
// each direction's values enter at the end); after the chains one group
// hands its values to the other through shared memory for the vote.
//
// Each step runs over the tile widened by the margin the host plan
// derives for that step and buffer from the stencils' reads, class by
// class (kernels/markesteijn.py:_needed_margins): every value an output
// needs is computed from values computed before it, and the mosaic is
// loaded once over the tile and the plan's halo (clamped source indices:
// the edge extension).  A step may read outside a plane at a site no
// output needs; guard bands keep those reads inside the block's shared
// memory, and their values are never used.  The steps that fill only
// some classes of site (the solitary-green estimates, R@B / B@R, the
// 2x2-green fill, the recalculation) visit only those classes, a warp at
// a time on sites of one class, and update R/B or G in place: for every
// X-Trans layout a step never reads a site it writes (the host checks
// the pattern), so the planes hold each set's values without copies.
// The planes a hex offset addresses share one row stride, so each
// class's eight offsets are one int each (in shared memory: neighbouring
// lanes of other classes read them without serialising), and a site's
// index serves every plane.  Each site's class, colour and solitary-green
// row flag sit in a byte plane.  gmin/gmax are recomputed where
// used rather than stored.  1 pass: 512 threads, ~103 KB, two blocks an
// SM; 3 passes: 1024 threads, ~210 KB, one.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int TH = 32, TW = 32;   // output tile of a block
constexpr int NT1 = 512, NT3 = 1024;
constexpr int MAX_SMEM = 232448;  // the most a block may have on sm_90
constexpr int MAX_STEPS = 14;
constexpr int CNT_M = 2, DRV_M = 3;
constexpr int SD = TW + 2 * DRV_M, SC = TW + 2 * CNT_M;  // their strides

struct Geo {
  signed char hex[9][8][2];  // (dy, dx) by class (row % 3) * 3 + col % 3
  signed char pair[9][4];    // hex 2i + hex 2i+1 != (0, 0)
  unsigned char pat[36];     // colour of (row % 6, col % 6)
  int sgrow, sgcol;
  int green;                 // bit c: class c is green
};

// the host plan (kernels/markesteijn.kernel_plan): the margins of the
// mosaic, G and R/B planes, the guard floats, and each step's margin per
// buffer
struct Plan {
  int mx, mg, mrb, guard;
  int step[MAX_STEPS][4];
};

__host__ __device__ constexpr int area(int m) {
  return (TH + 2 * m) * (TW + 2 * m);
}

// floats of a plane of margin m at the common row stride s
__host__ __device__ constexpr int rows(int m, int s) { return (TH + 2 * m) * s; }

__device__ __forceinline__ float jmin(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float jmax(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return jmin(jmax(v, lo), hi);
}

// the site byte: class in bits 0-3, colour in 4-5, solitary-green row in
// 6
__device__ __forceinline__ int cls_of(unsigned s) { return s & 15; }
__device__ __forceinline__ int color_of(unsigned s) { return (s >> 4) & 3; }
__device__ __forceinline__ bool rsg_of(unsigned s) { return (s >> 6) & 1; }

// The block's planes, X, G, R, B and the site bytes, share the row stride
// S = TW + 2 mx, and each pointer is at the tile's (0, 0): site (y, x) is
// index y S + x of all.  oy, ox: the tile origin's row and column mod 3.
struct Smem {
  const float* X;
  float *G, *R, *B;
  const unsigned char* site;
  const int* hex;           // [9][8]: dy S + dx
  const signed char* pair;  // [9][4]
  int S, oy, ox;
  int t, group;  // the thread's index in its group, and the group
  // classes (bit c for class c): the greens, the solitary greens, the 2x2
  // greens, the non-green sites on solitary-green rows and on the others
  int green, sg, g22, ng_rsg, ng_other;
};

// floor(i / w) for 0 <= i < 2^16 and 0 < w < 2^7, from w's reciprocal:
// (i + 0.5) / w lies at least 1 / (2 w) from an integer and its float
// product errs by far less
__device__ __forceinline__ int div_small(int i, float rw) {
  return (int)(((float)i + 0.5f) * rw);
}

// f(y0, x0, y1, x1) on every (y, x) of the tile widened by m, two sites a
// thread (index t of NT) at a time (a lone last site comes twice: f loads all it needs
// for both sites before it stores, so a site given twice is harmless and
// the second site's loads overlap the first's), in reading order across
// the block's threads
template <int NT, typename F>
__device__ __forceinline__ void for_sites(int t, int m, F&& f) {
  const int w = TW + 2 * m, n = (TH + 2 * m) * w;
  const float rw = __frcp_rn((float)w);
  for (int i = t; i < n; i += 2 * NT) {
    const int i1 = i + NT < n ? i + NT : i;
    const int r0 = div_small(i, rw), r1 = div_small(i1, rw);
    f(r0 - m, i - r0 * w - m, r1 - m, i1 - r1 * w - m);
  }
}

// f(y0, x0, y1, x1) on every (y, x) of the tile widened by m whose class
// is in `classes`, two sites of one class a thread at a time (as
// for_sites): the rectangle's sites fall into nine sub-grids by (row,
// column) mod 3, each one class; every chosen sub-grid is cut into the
// same number of chunks of 64 consecutive sites (enough for the largest),
// a lane taking sites j and j + 32 of a chunk, and each warp of the
// thread's group takes an equal run of consecutive chunks.  Every branch on the class is uniform
// in a warp.
template <int NT, typename F>
__device__ __forceinline__ void for_classes(const Smem& s, int m, int classes,
                                            F&& f) {
  static_assert(TH == TW, "a square rectangle");
  constexpr int NW = NT / 32;
  const int side = TW + 2 * m, lane = s.t & 31, warp = s.t >> 5;
  const int y3 = (s.oy + 3 - m % 3) % 3, x3 = (s.ox + 3 - m % 3) % 3;
  // the chosen sub-grids g = 3 ra + rb, 4 bits each
  unsigned long long list = 0;
  int count = 0;
#pragma unroll
  for (int g = 0; g < 9; ++g) {
    const int cls = (y3 + g / 3) % 3 * 3 + (x3 + g % 3) % 3;
    if (classes >> cls & 1) list |= (unsigned long long)g << (4 * count++);
  }
  const int c = (side + 2) / 3;  // the largest sub-grid is c x c
  const int per = (c * c + 63) / 64, total = count * per;
  const int lo = warp * total / NW, hi = (warp + 1) * total / NW;
  if (lo >= hi) return;
  int k = div_small(lo, __frcp_rn((float)per)), r = lo - k * per;
  int ra, rb, wb, n;
  float rw;
  auto grid = [&]() {  // the parameters of the k-th chosen sub-grid
    const int g = (int)(list >> (4 * k)) & 15;
    ra = (g * 11) >> 5;  // g / 3 for g < 9
    rb = g - 3 * ra;
    wb = (side - rb + 2) / 3;
    rw = __frcp_rn((float)wb);
    n = (side - ra + 2) / 3 * wb;
  };
  grid();
  for (int ci = lo; ci < hi; ++ci) {
    const int j0 = r * 64 + lane;
    if (j0 < n) {
      const int j1 = j0 + 32 < n ? j0 + 32 : j0;
      const int a0 = div_small(j0, rw), a1 = div_small(j1, rw);
      f(ra + 3 * a0 - m, rb + 3 * (j0 - a0 * wb) - m, ra + 3 * a1 - m,
        rb + 3 * (j1 - a1 * wb) - m);
    }
    if (++r == per && ci + 1 < hi) {
      r = 0;
      ++k;
      grid();
    }
  }
}

// a barrier for the NT threads of the calling thread's group (named
// barrier 1 + group; 0 is the block's)
template <int NT>
__device__ __forceinline__ void group_sync(const Smem& s) {
  asm volatile("bar.sync %0, %1;" :: "r"(1 + s.group), "r"(NT) : "memory");
}

// gmin, gmax over the six hex neighbours of site q (offsets hx)
__device__ __forceinline__ void green_range(const float* X, const int* hx,
                                            int q, float& gmin,
                                            float& gmax) {
  gmin = gmax = X[q + hx[0]];
#pragma unroll
  for (int k = 1; k < 6; ++k) {
    const float v = X[q + hx[k]];
    gmin = jmin(gmin, v);
    gmax = jmax(gmax, v);
  }
}

// R, B before a set's fills at a site that is no solitary green: the
// mosaic in the plane of its own colour, 0 in the other
struct RB {
  float r, b;
};
__device__ __forceinline__ RB rb_base(const Smem& s, int q) {
  const int color = color_of(s.site[q]);
  const float xc = s.X[q];
  return {color == 0 ? xc : 0.0f, color == 2 ? xc : 0.0f};
}

// G[d] (_green_dirs): the mosaic at greens, else the candidate of buffer
// d (d ^ 1 on solitary-green rows) clipped to [gmin, gmax]; with it the
// first set's R/B base (the host plan widens this step to that set's
// solitary-green step, whose estimates overwrite the base at solitary
// greens)
template <int NT>
__device__ __forceinline__ void step_green(const Smem& s, int d, int m) {
  for_classes<NT>(s, m, 511, [&](int y0, int x0, int y1, int x1) {
    const int q0 = y0 * s.S + x0, q1 = y1 * s.S + x1;
    const unsigned st = s.site[q0];  // the class is the pair's
    const RB b0 = rb_base(s, q0), b1 = rb_base(s, q1);
    float g0 = s.X[q0], g1 = s.X[q1];
    if (color_of(st) != 1) {
      const int* hx = s.hex + cls_of(st) * 8;
      const int c = rsg_of(st) ? (d ^ 1) : d;
      auto cand = [&](int q, float xc) {
        float gmin, gmax;
        green_range(s.X, hx, q, gmin, gmax);
        float col;
        if (c == 0) {
          const float h0x2 = s.X[q + 2 * hx[0]], h1x2 = s.X[q + 2 * hx[1]];
          col = 0.6796875f * (s.X[q + hx[1]] + s.X[q + hx[0]]) -
                0.1796875f * (h1x2 + h0x2);
        } else if (c == 1) {
          const float f_mh2 = s.X[q - hx[2]];
          col = 0.87109375f * s.X[q + hx[3]] + 0.13f * s.X[q + hx[2]] +
                0.359375f * (xc - f_mh2);
        } else {
          const int o = hx[c + 2];
          const float g_mh2 = s.X[q - 2 * o], f_p3 = s.X[q + 3 * o],
                      f_m3 = s.X[q - 3 * o];
          col = 0.640625f * s.X[q + o] + 0.359375f * g_mh2 +
                0.12890625f * (2.0f * xc - f_p3 - f_m3);
        }
        return clip(col, gmin, gmax);
      };
      g0 = cand(q0, g0);
      g1 = cand(q1, g1);
    }
    s.G[q0] = g0;
    s.R[q0] = b0.r;
    s.B[q0] = b0.b;
    s.G[q1] = g1;
    s.R[q1] = b1.r;
    s.B[q1] = b1.b;
  });
}

// one solitary-green estimate at site q along an axis (step o: 1 across,
// S down): (R, B) by the right neighbour's colour, and the squared
// differences that pick between axes
__device__ __forceinline__ void sg_estimate(const Smem& s, int q, int o,
                                            bool axis_h, bool right_red,
                                            bool diff, float& er, float& eb,
                                            float& df) {
  const float gc = s.G[q];
  float est[2];
  df = 0.0f;
#pragma unroll
  for (int dist = 1; dist <= 2; ++dist) {
    const float gp = s.G[q + dist * o], gm = s.G[q - dist * o];
    const float fp = s.X[q + dist * o], fm = s.X[q - dist * o];
    const float gterm = 2.0f * gc - gp - gm;
    est[dist - 1] = gterm + fp + fm;
    if (diff) {
      const float t = gp - gm - fp + fm;
      df = df + t * t + gterm * gterm;
    }
  }
  const bool base_is_red = axis_h ? right_red : !right_red;
  er = base_is_red ? est[0] : est[1];
  eb = base_is_red ? est[1] : est[0];
}

// R, B[d] before the fills (_sg_rb): the solitary-green estimates of
// buffer d at the solitary greens.  The rest is the base: the first set's
// the green step wrote; a later set finds it in place but at the 2x2
// greens, which the set before filled and which this step sets to 0 (the
// R@B / B@R fill reads them), since no step writes a plane at a site of
// its own colour and the other fills rewrite what they wrote
template <int NT>
__device__ __forceinline__ void step_sg(const Smem& s, int d, int m,
                                        bool later) {
  for_classes<NT>(s, m, later ? s.sg | s.g22 : s.sg, [&](int y0, int x0,
                                                         int y1, int x1) {
    const int q0 = y0 * s.S + x0, q1 = y1 * s.S + x1;
    RB v0, v1;
    if (!(s.sg >> cls_of(s.site[q0]) & 1)) {
      v0 = v1 = RB{0.0f, 0.0f};
    } else {
      auto est = [&](int q) {
        const bool right_red = color_of(s.site[q + 1]) == 0;
        float er, eb, df;
        if (d <= 1) {
          sg_estimate(s, q, d == 0 ? 1 : s.S, d == 0, right_red, false, er,
                      eb, df);
        } else {
          float er_v, eb_v, df_v;
          sg_estimate(s, q, 1, true, right_red, true, er, eb, df);
          sg_estimate(s, q, s.S, false, right_red, true, er_v, eb_v, df_v);
          if (!(df < df_v)) {
            er = er_v;
            eb = eb_v;
          }
        }
        return RB{er / 2.0f, eb / 2.0f};
      };
      v0 = est(q0);
      v1 = est(q1);
    }
    s.R[q0] = v0.r;
    s.B[q0] = v0.b;
    s.R[q1] = v1.r;
    s.B[q1] = v1.b;
  });
}

// R at blue and B at red sites of buffer d (_rb_opposite), in place: the
// plane a site lacks is read only at sites of the other colours (the
// host checks the pattern), which this step leaves alone
template <int NT>
__device__ __forceinline__ void step_opposite(const Smem& s, int d, int m) {
  for_classes<NT>(s, m, s.ng_rsg | s.ng_other, [&](int y0, int x0, int y1,
                                                  int x1) {
    const int S = s.S, q0 = y0 * S + x0, q1 = y1 * S + x1;
    const bool rsg = rsg_of(s.site[q0]);  // the pair's row class
    auto fill = [&](int q) {
      const float gc = s.G[q];
      bool use_c = true;
      if (d <= 1) {
        // across (1) and three rows (3 S) on solitary-green rows, else
        // down (S) and three columns (3)
        const int oc = rsg ? 1 : S, oh = rsg ? 3 * S : 3;
        const float grad_c =
            fabsf(gc - s.G[q + oc]) + fabsf(gc - s.G[q - oc]);
        const float grad_h =
            fabsf(gc - s.G[q + oh]) + fabsf(gc - s.G[q - oh]);
        const bool parity_ok = d % 2 == 0 ? rsg : !rsg;
        use_c = parity_ok || grad_c < 2.0f * grad_h;
      }
      const int o = use_c ? (rsg ? 1 : S) : (rsg ? 3 * S : 3);
      const float gp = s.G[q + o], gm = s.G[q - o];
      // the plane of the colour this site lacks: R at blue, B at red
      const float* lack = color_of(s.site[q]) == 2 ? s.R : s.B;
      return (lack[q + o] + lack[q - o] + 2.0f * gc - gp - gm) / 2.0f;
    };
    const float v0 = fill(q0), v1 = fill(q1);
    (color_of(s.site[q0]) == 2 ? s.R : s.B)[q0] = v0;
    (color_of(s.site[q1]) == 2 ? s.R : s.B)[q1] = v1;
  });
}

// R, B of buffer d at the 2x2 greens (_g22_fill), in place: their hex
// neighbours are no 2x2 greens (the host checks the pattern)
template <int NT>
__device__ __forceinline__ void step_g22(const Smem& s, int d, int m) {
  for_classes<NT>(s, m, s.g22, [&](int y0, int x0, int y1, int x1) {
    const int q0 = y0 * s.S + x0, q1 = y1 * s.S + x1;
    const int cls = cls_of(s.site[q0]);  // the pair's
    const int h0 = s.hex[cls * 8 + 2 * d], h1 = s.hex[cls * 8 + 2 * d + 1];
    const bool pair = s.pair[cls * 4 + d];
    auto fill = [&](int q) {
      const float gc = s.G[q];
      const float g_h0 = s.G[q + h0], g_h1 = s.G[q + h1];
      const float r0 = s.R[q + h0], r1 = s.R[q + h1];
      const float b0 = s.B[q + h0], b1 = s.B[q + h1];
      if (pair)
        return RB{((3.0f * gc - 2.0f * g_h0 - g_h1) + 2.0f * r0 + r1) / 3.0f,
                  ((3.0f * gc - 2.0f * g_h0 - g_h1) + 2.0f * b0 + b1) / 3.0f};
      return RB{((2.0f * gc - g_h0 - g_h1) + r0 + r1) / 2.0f,
                ((2.0f * gc - g_h0 - g_h1) + b0 + b1) / 2.0f};
    };
    const RB v0 = fill(q0), v1 = fill(q1);
    s.R[q0] = v0.r;
    s.B[q0] = v0.b;
    s.R[q1] = v1.r;
    s.B[q1] = v1.b;
  });
}

// one sweep of buffer d's green recalculation (_green_recalc), in place:
// G updated at the non-green sites, along hex direction first_hd on the
// rows `first_rows` selects (1: the solitary-green rows), and (buffers
// 2, 3) along second_hd on the others, from the set's final R, B.  Both
// steps read G only at greens, which neither writes (the host checks the
// pattern), so one pass does both.
template <int NT>
__device__ __forceinline__ void step_recalc(const Smem& s, int first_hd,
                                            int first_rows, int second_hd,
                                            int m) {
  const int first = first_rows ? s.ng_rsg : s.ng_other;
  const int classes = second_hd ? s.ng_rsg | s.ng_other : first;
  for_classes<NT>(s, m, classes, [&](int y0, int x0, int y1, int x1) {
    const int q0 = y0 * s.S + x0, q1 = y1 * s.S + x1;
    const int cls = cls_of(s.site[q0]);  // the pair's
    const int hd = (first >> cls & 1) ? first_hd : second_hd;
    const int* hx = s.hex + cls * 8;
    const int o = hx[hd];
    auto recalc = [&](int q) {
      const int qa = q + o, qb = q - 2 * o;
      const float g_h = s.G[qa], g_m2h = s.G[qb];
      // the neighbour's own colour plane: R at red sites, B elsewhere
      const float f_h = color_of(s.site[qa]) == 0 ? s.R[qa] : s.B[qa];
      const float f_m2h = color_of(s.site[qb]) == 0 ? s.R[qb] : s.B[qb];
      const float val =
          (g_m2h + 2.0f * g_h - f_m2h - 2.0f * f_h + 3.0f * s.X[q]) / 3.0f;
      float gmin, gmax;
      green_range(s.X, hx, q, gmin, gmax);
      return clip(val, gmin, gmax);
    };
    const float v0 = recalc(q0), v1 = recalc(q1);
    s.G[q0] = v0;
    s.G[q1] = v1;
  });
}

__device__ __forceinline__ void ypbpr(const Smem& s, int q, float* yuv) {
  const float r = s.R[q], gg = s.G[q], b = s.B[q];
  const float yy = 0.2627f * r + 0.6780f * gg + 0.0593f * b;
  yuv[0] = yy;
  yuv[1] = (b - yy) * 0.56433f;
  yuv[2] = (r - yy) * 0.67815f;
}

// drv of buffer d's final set (the YPbPr second derivative along
// direction d) over the tile and 3 px into drv (stride SD, at the tile's
// (0, 0)); then each thread's own pixels' R, G, B enter keep at its end
template <int NT, int NDIR, int PX>
__device__ __forceinline__ void step_drv(const Smem& s, float* drv, int d,
                                         float (&keep)[NDIR][3][PX]) {
  const int o = d == 0 ? 1 : (d == 1 ? s.S : (d == 2 ? s.S + 1 : s.S - 1));
  for_sites<NT>(s.t, DRV_M, [&](int y0, int x0, int y1, int x1) {
    auto deriv = [&](int q) {
      float c[3], p[3], n[3];
      ypbpr(s, q, c);
      ypbpr(s, q + o, p);
      ypbpr(s, q - o, n);
      float dd = 0.0f;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float t = 2.0f * c[ch] - p[ch] - n[ch];
        dd = dd + t * t;
      }
      return dd;
    };
    const float v0 = deriv(y0 * s.S + x0), v1 = deriv(y1 * s.S + x1);
    drv[y0 * SD + x0] = v0;
    drv[y1 * SD + x1] = v1;
  });
#pragma unroll
  for (int j = 0; j + 1 < NDIR; ++j)
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int k = 0; k < PX; ++k) keep[j][c][k] = keep[j + 1][c][k];
#pragma unroll
  for (int k = 0; k < PX; ++k) {
    const int i = s.t + k * NT;
    const int q = (i / TW) * s.S + i % TW;
    keep[NDIR - 1][0][k] = s.R[q];
    keep[NDIR - 1][1][k] = s.G[q];
    keep[NDIR - 1][2][k] = s.B[q];
  }
}

// one set of buffer d from its greens in s.G: R, B with the solitary-green
// estimates, the R@B / B@R fill, the 2x2-green fill; st: the set's first
// step in Plan.step
template <int NT>
__device__ __forceinline__ void one_set(const Smem& s, const Plan& pl, int d,
                                        int st) {
  step_sg<NT>(s, d, pl.step[st][d], st != 1);
  group_sync<NT>(s);
  step_opposite<NT>(s, d, pl.step[st + 1][d]);
  group_sync<NT>(s);
  step_g22<NT>(s, d, pl.step[st + 2][d]);
  group_sync<NT>(s);
}

template <int NDIR, int NT>
__global__ void __launch_bounds__(NT, NT == NT1 ? 2 : 1)
mark_tile(const float* __restrict__ xin, float* __restrict__ out, int h,
          int w, const __grid_constant__ Geo geo,
          const __grid_constant__ Plan pl) {
  extern __shared__ float smem[];
  constexpr int HT = NT / 2;        // threads of a group
  constexpr int PX = TH * TW / HT;  // own pixels of a thread
  constexpr int KD = NDIR / 2;      // directions a group keeps
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int S = TW + 2 * pl.mx;

  Smem s;
  s.S = S;
  s.oy = y0 % 3;
  s.ox = x0 % 3;
  s.group = threadIdx.x / HT;
  s.t = threadIdx.x % HT;
  s.green = geo.green;
  s.sg = s.g22 = s.ng_rsg = s.ng_other = 0;
  for (int c = 0; c < 9; ++c) {
    const bool rsg = c / 3 == geo.sgrow, csg = c % 3 == geo.sgcol;
    if (geo.green >> c & 1) {
      s.sg |= (rsg && csg) << c;
      s.g22 |= (!rsg && !csg) << c;
    } else {
      (rsg ? s.ng_rsg : s.ng_other) |= 1 << c;
    }
  }
  float* f = smem + pl.guard;
  float* const X = f + pl.mx * S + pl.mx;
  s.X = X;
  f += rows(pl.mx, S);
  // each group's G, R and B; after the chains the counts and the other
  // group's kept values reuse them
  float* const free0 = f;
  f += s.group * (rows(pl.mg, S) + 2 * rows(pl.mrb, S));
  s.G = f + pl.mg * S + pl.mx;
  f += rows(pl.mg, S);
  s.R = f + pl.mrb * S + pl.mx;
  f += rows(pl.mrb, S);
  s.B = f + pl.mrb * S + pl.mx;
  f = free0 + 2 * (rows(pl.mg, S) + 2 * rows(pl.mrb, S));
  float* const drv = f + DRV_M * SD + DRV_M;  // plane k at + k area(DRV_M)
  f += NDIR * area(DRV_M);
  unsigned char* const site = (unsigned char*)f + pl.mx * S + pl.mx;
  s.site = site;
  f += (rows(pl.mx, S) + 3) / 4 + pl.guard;
  int* const hexs = (int*)f;
  signed char* const pairs = (signed char*)(hexs + 9 * 8);
  s.hex = hexs;
  s.pair = pairs;

  for (int i = threadIdx.x; i < 9 * 8; i += NT)
    hexs[i] = geo.hex[i / 8][i % 8][0] * S + geo.hex[i / 8][i % 8][1];
  for (int i = threadIdx.x; i < 9 * 4; i += NT)
    pairs[i] = (&geo.pair[0][0])[i];
  // the mosaic, edge-extended, and each site's byte
  for_sites<NT>(threadIdx.x, pl.mx, [&](int ya, int xa, int yb, int xb) {
    for (int t = 0; t < 2; ++t) {
      const int y = t ? yb : ya, x = t ? xb : xa;
      const int gy = y0 + y, gx = x0 + x;
      const int r6 = ((gy % 6) + 6) % 6, c6 = ((gx % 6) + 6) % 6;
      const int r3 = r6 % 3, c3 = c6 % 3;
      site[y * S + x] = (unsigned char)((r3 * 3 + c3) |
                                        (geo.pat[r6 * 6 + c6] << 4) |
                                        ((r3 == geo.sgrow) << 6));
      const int sy = gy < 0 ? 0 : (gy >= h ? h - 1 : gy);
      const int sx = gx < 0 ? 0 : (gx >= w ? w - 1 : gx);
      X[y * S + x] = __ldg(xin + (size_t)sy * w + sx);
    }
  });
  __syncthreads();

  // The two groups run their direction chains side by side on their own
  // planes, group g buffers g and g + 2, each behind its own barrier.
  // Each thread keeps its own pixels' R, G, B per direction of its group,
  // in the order the chains finish: 1 pass buffers g, g + 2; 3 passes g,
  // g + 4, g + 2, g + 6.
  float keep[KD][3][PX];
#pragma unroll 1
  for (int k = 0; k < 2; ++k) {
    const int d = s.group + 2 * k;
    step_green<HT>(s, d, pl.step[0][d]);
    group_sync<HT>(s);
    one_set<HT>(s, pl, d, 1);
    step_drv<HT, KD, PX>(s, drv + d * area(DRV_M), d, keep);
    if (NDIR == 8) {
      // two recalculation sweeps, each with a fresh set; the last set's
      // drv goes to buffer 4 + d.  Buffer d's first step is along hex
      // direction (3, 3, 4, 4)[d] on the rows (1, 0, 0, 1)[d] selects, its
      // second (buffers 2, 3) along 5 on rows (1, 0)[d - 2]
      const int first = d < 2 ? 3 : 4, first_rows = d == 0 || d == 3;
      const int second = d < 2 ? 0 : 5;
#pragma unroll 1
      for (int sweep = 0; sweep < 2; ++sweep) {
        const int st = 4 + 5 * sweep;
        group_sync<HT>(s);
        const int ma = pl.step[st][d], mg = pl.step[st + 1][d];
        step_recalc<HT>(s, first, first_rows, second, ma > mg ? ma : mg);
        group_sync<HT>(s);
        one_set<HT>(s, pl, d, st + 2);
      }
      step_drv<HT, KD, PX>(s, drv + (4 + d) * area(DRV_M), d, keep);
    }
    group_sync<HT>(s);
  }
  __syncthreads();

  // group 1 hands its kept values to group 0, which votes: slot j of
  // group 1 for pixel i at other[(j * 3 + c) * TH * TW + i]
  float* const cnt = free0 + CNT_M * SC + CNT_M;  // plane k at + k area(CNT_M)
  float* const other = free0 + NDIR * area(CNT_M);
  if (s.group == 1) {
#pragma unroll
    for (int j = 0; j < KD; ++j)
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int k = 0; k < PX; ++k)
          other[(j * 3 + c) * TH * TW + s.t + k * HT] = keep[j][c][k];
  }
  // counts over the tile and 2 px: 3x3 of drv[k] <= 8 min_k drv[k]
  for_sites<NT>(threadIdx.x, CNT_M, [&](int ya, int xa, int yb, int xb) {
    for (int t = 0; t < 2; ++t) {
      const int y = t ? yb : ya, x = t ? xb : xa;
      const int q = y * SD + x;
      float tr = drv[q];
#pragma unroll
      for (int k = 1; k < NDIR; ++k) tr = jmin(tr, drv[k * area(DRV_M) + q]);
      tr = tr * 8.0f;
#pragma unroll
      for (int k = 0; k < NDIR; ++k) {
        const float* dk = drv + k * area(DRV_M) + q;
        float c = 0.0f;
#pragma unroll
        for (int vv = -1; vv <= 1; ++vv)
#pragma unroll
          for (int hh = -1; hh <= 1; ++hh)
            c = c + (dk[vv * SD + hh] <= tr ? 1.0f : 0.0f);
        cnt[k * area(CNT_M) + y * SC + x] = c;
      }
    }
  });
  __syncthreads();
  // the counts' 5-column sums over the tile's columns and 2 rows more
  // (counts are whole numbers up to 9 and their sums below 2^24, so any
  // order of the 5 x 5 sum gives the same float)
  float* const rsum = drv - DRV_M * SD - DRV_M;  // over drv, read for the last time
  for (int i = threadIdx.x; i < (TH + 2 * CNT_M) * TW; i += NT) {
    const int y = i / TW - CNT_M, x = i % TW;
#pragma unroll
    for (int k = 0; k < NDIR; ++k) {
      const float* ck = cnt + k * area(CNT_M) + y * SC + x;
      rsum[(k * (TH + 2 * CNT_M) + y + CNT_M) * TW + x] =
          ck[-2] + ck[-1] + ck[0] + ck[1] + ck[2];
    }
  }
  __syncthreads();
  if (s.group != 0) return;

  // the 5x5 sums, the vote and max(., 0) at each thread's own pixels
  const size_t plane = (size_t)h * w;
#pragma unroll
  for (int k = 0; k < PX; ++k) {
    const int i = s.t + k * HT;
    const int y = i / TW, x = i % TW;
    const int gy = y0 + y, gx = x0 + x;
    if (gy >= h || gx >= w) continue;
    float homo[NDIR];
    float maxval = 0.0f;
#pragma unroll
    for (int j = 0; j < NDIR; ++j) {
      const float* rj = rsum + (j * (TH + 2 * CNT_M) + y + CNT_M) * TW + x;
      const float acc = rj[-2 * TW] + rj[-TW] + rj[0] + rj[TW] + rj[2 * TW];
      homo[j] = acc;
      maxval = j == 0 ? acc : jmax(maxval, acc);
    }
    const float thresh = maxval - maxval / 8.0f;
    float nr = 0.0f, ng = 0.0f, nb = 0.0f, den = 0.0f;
#pragma unroll
    for (int j = 0; j < NDIR; ++j) {
      // direction j: buffer j % 4 of set j / 4, in group (j % 4) % 2 at
      // slot (j % 4) / 2 * (NDIR / 4) + j / 4
      const int slot = (j % 4) / 2 * (NDIR / 4) + j / 4;
      float v[3];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        v[c] = j % 2 == 0 ? keep[slot][c][k]
                          : other[(slot * 3 + c) * TH * TW + i];
      const float sel = homo[j] >= thresh ? 1.0f : 0.0f;
      nr = nr + sel * v[0];
      ng = ng + sel * v[1];
      nb = nb + sel * v[2];
      den = den + sel;
    }
    den = jmax(den, 1.0f);
    const size_t o = (size_t)gy * w + gx;
    out[o] = jmax(nr / den, 0.0f);
    out[plane + o] = jmax(ng / den, 0.0f);
    out[2 * plane + o] = jmax(nb / den, 0.0f);
  }
}

int shared_bytes(const Plan& pl, int ndir) {
  const int S = TW + 2 * pl.mx;
  const int floats = rows(pl.mx, S) +
                     2 * (rows(pl.mg, S) + 2 * rows(pl.mrb, S)) +
                     ndir * area(DRV_M);
  const int sites = (rows(pl.mx, S) + 3) / 4;
  const int geo = 9 * 8 * 4 + 9 * 4;
  return (4 * (2 * pl.guard + floats + sites) + geo + 15) / 16 * 16;
}

template <int NDIR, int NT>
int launch(const float* x, float* out, int h, int w, const Geo& g,
           const Plan& pl, int smem, cudaStream_t st) {
  const void* fn = (const void*)mark_tile<NDIR, NT>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH);
  mark_tile<NDIR, NT><<<grid, NT, smem, st>>>(x, out, h, w, g, pl);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The launch geometry the wrapper plans with (kernels/markesteijn.py
// checks it).
void markesteijn_limits(int* tile_h, int* tile_w, int* threads1,
                        int* threads3, int* max_smem) {
  *tile_h = TH;
  *tile_w = TW;
  *threads1 = NT1;
  *threads3 = NT3;
  *max_smem = MAX_SMEM;
}

// x: (h, w) float32 mosaic on the device; out: (3, h, w); table: the host
// geometry of kernels/markesteijn.geometry_table (9 x 8 x 2 hex offsets,
// sgrow, sgcol, 9 x 4 pair flags, 36 colours); plan: the host plan of
// kernels/markesteijn.kernel_plan (passes, threads, halo, the five plane
// margins, guard, shared bytes, then each step's margins for buffers
// 0-3).  The plan's sizes are checked against the geometry and this
// kernel's layout before the one launch on `stream`; returns the launch
// error.
int markesteijn(const float* x, float* out, int h, int w, int passes,
                const int* table, const int* plan, void* stream) {
  if (h < 1 || w < 1 || (passes != 1 && passes != 3))
    return (int)cudaErrorInvalidValue;
  Geo g;
  const int* t = table;
  int hex_max = 0;
  for (int c = 0; c < 9; ++c)
    for (int k = 0; k < 8; ++k)
      for (int j = 0; j < 2; ++j) {
        const int v = *t++;
        if (v < -2 || v > 2) return (int)cudaErrorInvalidValue;
        g.hex[c][k][j] = (signed char)v;
        hex_max = v > hex_max ? v : (-v > hex_max ? -v : hex_max);
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
  // the greens are a function of the class, as in every X-Trans layout
  g.green = 0;
  for (int i = 0; i < 36; ++i)
    if (g.pat[i] == 1) g.green |= 1 << ((i / 6) % 3 * 3 + i % 3);
  for (int i = 0; i < 36; ++i)
    if ((g.pat[i] == 1) != ((g.green >> ((i / 6) % 3 * 3 + i % 3)) & 1))
      return (int)cudaErrorInvalidValue;

  const int ndir = passes == 1 ? 4 : 8, nsteps = passes == 1 ? 4 : 14;
  if (plan[0] != passes || plan[1] != (passes == 1 ? NT1 : NT3))
    return (int)cudaErrorInvalidValue;
  Plan pl;
  pl.mx = plan[3];
  pl.mg = plan[4];
  pl.mrb = plan[5];
  pl.guard = plan[6];
  const int smem = plan[7];
  // every plane within the mosaic's margin, so the guard covers the
  // farthest read (3 px, or three hex steps) past any plane's edge
  const int reach = 3 * hex_max > 3 ? 3 * hex_max : 3;
  if (plan[2] != pl.mx || pl.mx > 64 || pl.mg < DRV_M + 1 ||
      pl.mg > pl.mx || pl.mrb < DRV_M + 1 || pl.mrb > pl.mx ||
      pl.guard < reach * (TW + 2 * pl.mx + 1))
    return (int)cudaErrorInvalidValue;
  // the plane each step writes: G (G, A) or R/B (S, O, F)
  const char kinds[] = "GSOFAGSOFAGSOF";
  for (int i = 0; i < MAX_STEPS; ++i)
    for (int d = 0; d < 4; ++d) {
      if (i >= nsteps) {
        pl.step[i][d] = 0;
        continue;
      }
      const int m = plan[8 + 4 * i + d];
      const int cap = kinds[i] == 'G' || kinds[i] == 'A' ? pl.mg : pl.mrb;
      if (m < 0 || m > cap) return (int)cudaErrorInvalidValue;
      pl.step[i][d] = m;
    }
  // the green step writes the first set's R/B base over its own rectangle
  for (int d = 0; d < 4; ++d)
    if (pl.step[0][d] < pl.step[1][d] || pl.step[0][d] > pl.mrb)
      return (int)cudaErrorInvalidValue;
  // the counts and group 1's kept values fit where the groups' planes were
  const int S = TW + 2 * pl.mx;
  if (ndir * area(CNT_M) + ndir / 2 * 3 * TH * TW >
          2 * (rows(pl.mg, S) + 2 * rows(pl.mrb, S)) ||
      smem != shared_bytes(pl, ndir) || smem > MAX_SMEM)
    return (int)cudaErrorInvalidValue;

  cudaStream_t st = (cudaStream_t)stream;
  return passes == 1 ? launch<4, NT1>(x, out, h, w, g, pl, smem, st)
                     : launch<8, NT3>(x, out, h, w, g, pl, smem, st);
}

}  // extern "C"
