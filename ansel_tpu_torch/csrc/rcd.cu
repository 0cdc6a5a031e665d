// RCD Bayer demosaic for Hopper (sm_90a).
//
// Replaces: ansel_tpu/kernels/rcd_pallas.py:rcd_demosaic_pallas, the
// Pallas TPU kernel.  It computes what that kernel computes: RCD on the
// mosaic normalised by `scaler` and edge-padded, cropped back, clamped at
// 0 and multiplied by `scaler`.  RCD reads at most 10 px away (hpf 3,
// stat +1, refine +1, then g at +-2 and p at +-3 in step 4.3), so any
// even edge pad of at least 10 gives the TPU kernel's 12/64 px halo
// result; the even pad keeps the CFA phase.
//
// What bounds it: device memory traffic.  The arithmetic is a few hundred
// flops per pixel against a 24 MP frame; the passes below each read and
// write whole planes.
//
// Design: one thread per pixel, one kernel per pass, full-frame
// intermediates in a scratch buffer of 8 padded planes.  A pass ends
// where the next step reads an intermediate at a neighbour:
//   1. pad + normalise            -> c
//   2. hpf v/h/p/q (squared), lpf -> hv, hh, hp, hq, lpf
//   3. v/h and p/q statistics     -> vh_dir, pq_dir
//   4. refine, green              -> vh_disc, pq_disc, g
//   5. chroma at R/B sites        -> r_nb, b_nb
//   6. chroma at G sites, crop, clamp, scale -> out (3, h, w)
// Reads are clamped to the padded frame; what that clamping corrupts stays
// inside the 10 px ring that the crop drops.  Expressions keep the Pallas
// kernel's operand order, and the library is built with --fmad=false, so
// the result rounds like the plain torch version (kernels/rcd.py).
// A single kernel with a shared-memory tile is later work.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr float EPS = 1e-5f;
constexpr float EPSSQ = 1e-10f;
constexpr int PAD = 12;
constexpr int BX = 32;
constexpr int BY = 8;

// jnp.maximum: NaN in either operand gives NaN (fmaxf would drop it)
__device__ __forceinline__ float jmax(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

struct Frame {
  int hp, wp;  // padded frame
  __device__ __forceinline__ float at(const float* p, int y, int x) const {
    y = y < 0 ? 0 : (y >= hp ? hp - 1 : y);
    x = x < 0 ? 0 : (x >= wp ? wp - 1 : x);
    return p[(size_t)y * wp + x];
  }
  __device__ __forceinline__ size_t idx(int y, int x) const {
    return (size_t)y * wp + x;
  }
};

// colour (0 R, 1 G, 2 B) at padded (y, x); cfa packs the 2x2 period as
// 2-bit ids in reading order
__device__ __forceinline__ int color_at(int cfa, int y, int x) {
  return (cfa >> (2 * (((y & 1) << 1) | (x & 1)))) & 3;
}

__global__ void pad_normalize(const float* __restrict__ x, float* __restrict__ c,
                              int h, int w, Frame f,
                              const float* __restrict__ scaler) {
  int px = blockIdx.x * BX + threadIdx.x;
  int py = blockIdx.y * BY + threadIdx.y;
  if (px >= f.wp || py >= f.hp) return;
  int sy = py - PAD, sx = px - PAD;
  sy = sy < 0 ? 0 : (sy >= h ? h - 1 : sy);
  sx = sx < 0 ? 0 : (sx >= w ? w - 1 : sx);
  c[f.idx(py, px)] = jmax(x[(size_t)sy * w + sx], 0.0f) / jmax(*scaler, 1e-9f);
}

// step 1 (high-pass filters) and step 2 (low-pass)
__global__ void filters(const float* __restrict__ c, float* __restrict__ hv,
                        float* __restrict__ hh, float* __restrict__ hpp,
                        float* __restrict__ hq, float* __restrict__ lpf, Frame f) {
  int x = blockIdx.x * BX + threadIdx.x;
  int y = blockIdx.y * BY + threadIdx.y;
  if (x >= f.wp || y >= f.hp) return;
#define C(dy, dx) f.at(c, y + (dy), x + (dx))
  float c0 = C(0, 0);
  float t;
  t = C(-3, 0) - C(-1, 0) - C(1, 0) + C(3, 0) - 3.0f * (C(-2, 0) + C(2, 0)) + 6.0f * c0;
  hv[f.idx(y, x)] = t * t;
  t = C(0, -3) - C(0, -1) - C(0, 1) + C(0, 3) - 3.0f * (C(0, -2) + C(0, 2)) + 6.0f * c0;
  hh[f.idx(y, x)] = t * t;
  t = C(-3, -3) - C(-1, -1) - C(1, 1) + C(3, 3) - 3.0f * (C(-2, -2) + C(2, 2)) + 6.0f * c0;
  hpp[f.idx(y, x)] = t * t;
  t = C(-3, 3) - C(-1, 1) - C(1, -1) + C(3, -3) - 3.0f * (C(-2, 2) + C(2, -2)) + 6.0f * c0;
  hq[f.idx(y, x)] = t * t;
  lpf[f.idx(y, x)] = (c0 + 0.5f * (C(-1, 0) + C(1, 0) + C(0, -1) + C(0, 1))) +
                     0.25f * (C(-1, -1) + C(-1, 1) + C(1, -1) + C(1, 1));
#undef C
}

// step 1 statistics (v/h) and step 4.1 (p/q)
__global__ void stats(const float* __restrict__ hv, const float* __restrict__ hh,
                      const float* __restrict__ hpp, const float* __restrict__ hq,
                      float* __restrict__ vh_dir, float* __restrict__ pq_dir, Frame f) {
  int x = blockIdx.x * BX + threadIdx.x;
  int y = blockIdx.y * BY + threadIdx.y;
  if (x >= f.wp || y >= f.hp) return;
  float v = jmax(EPSSQ, f.at(hv, y - 1, x) + f.at(hv, y, x) + f.at(hv, y + 1, x));
  float h = jmax(EPSSQ, f.at(hh, y, x - 1) + f.at(hh, y, x) + f.at(hh, y, x + 1));
  vh_dir[f.idx(y, x)] = v / (v + h);
  float p = jmax(EPSSQ, f.at(hpp, y - 1, x - 1) + f.at(hpp, y, x) + f.at(hpp, y + 1, x + 1));
  float q = jmax(EPSSQ, f.at(hq, y - 1, x + 1) + f.at(hq, y, x) + f.at(hq, y + 1, x - 1));
  pq_dir[f.idx(y, x)] = p / (p + q);
}

__device__ __forceinline__ float refine(const float* d, const Frame& f, int y, int x) {
  float d0 = f.at(d, y, x);
  float nbh = 0.25f * (f.at(d, y - 1, x - 1) + f.at(d, y - 1, x + 1) +
                       f.at(d, y + 1, x - 1) + f.at(d, y + 1, x + 1));
  return fabsf(0.5f - d0) < fabsf(0.5f - nbh) ? nbh : d0;
}

// refinement of both discriminators, step 3 (green at R/B sites)
__global__ void green(const float* __restrict__ c, const float* __restrict__ lpf,
                      const float* __restrict__ vh_dir, const float* __restrict__ pq_dir,
                      float* __restrict__ vh_disc, float* __restrict__ pq_disc,
                      float* __restrict__ g, Frame f, int cfa) {
  int x = blockIdx.x * BX + threadIdx.x;
  int y = blockIdx.y * BY + threadIdx.y;
  if (x >= f.wp || y >= f.hp) return;
  float vhd = refine(vh_dir, f, y, x);
  vh_disc[f.idx(y, x)] = vhd;
  pq_disc[f.idx(y, x)] = refine(pq_dir, f, y, x);
#define C(dy, dx) f.at(c, y + (dy), x + (dx))
#define L(dy, dx) f.at(lpf, y + (dy), x + (dx))
  float c0 = C(0, 0);
  if (color_at(cfa, y, x) == 1) {
    g[f.idx(y, x)] = c0;
    return;
  }
  float cn1 = C(-1, 0), cs1 = C(1, 0), cw1 = C(0, -1), ce1 = C(0, 1);
  float ns = fabsf(cn1 - cs1);
  float we = fabsf(cw1 - ce1);
  float n_g = EPS + ns + fabsf(c0 - C(-2, 0)) + fabsf(cn1 - C(-3, 0)) + fabsf(C(-2, 0) - C(-4, 0));
  float s_g = EPS + ns + fabsf(c0 - C(2, 0)) + fabsf(cs1 - C(3, 0)) + fabsf(C(2, 0) - C(4, 0));
  float w_g = EPS + we + fabsf(c0 - C(0, -2)) + fabsf(cw1 - C(0, -3)) + fabsf(C(0, -2) - C(0, -4));
  float e_g = EPS + we + fabsf(c0 - C(0, 2)) + fabsf(ce1 - C(0, 3)) + fabsf(C(0, 2) - C(0, 4));
  float l0 = L(0, 0);
  float two = l0 + l0;
  float n_e = cn1 * two / (EPS + l0 + L(-2, 0));
  float s_e = cs1 * two / (EPS + l0 + L(2, 0));
  float w_e = cw1 * two / (EPS + l0 + L(0, -2));
  float e_e = ce1 * two / (EPS + l0 + L(0, 2));
  float v_est = (s_g * n_e + n_g * s_e) / (n_g + s_g);
  float h_est = (w_g * e_e + e_g * w_e) / (e_g + w_g);
  g[f.idx(y, x)] = vhd * h_est + (1.0f - vhd) * v_est;
#undef C
#undef L
}

// step 4.2: the opposite chroma at R and B sites
__global__ void chroma_rb(const float* __restrict__ c, const float* __restrict__ g,
                          const float* __restrict__ pq_disc, float* __restrict__ r_nb,
                          float* __restrict__ b_nb, Frame f, int cfa) {
  int x = blockIdx.x * BX + threadIdx.x;
  int y = blockIdx.y * BY + threadIdx.y;
  if (x >= f.wp || y >= f.hp) return;
  int col = color_at(cfa, y, x);
  float c0 = f.at(c, y, x);
  size_t i = f.idx(y, x);
  if (col == 1) {
    r_nb[i] = 0.0f;
    b_nb[i] = 0.0f;
    return;
  }
#define C(dy, dx) f.at(c, y + (dy), x + (dx))
#define G(dy, dx) f.at(g, y + (dy), x + (dx))
  float g0 = G(0, 0);
  float nw = EPS + fabsf(C(-1, -1) - C(1, 1)) + fabsf(C(-1, -1) - C(-3, -3)) + fabsf(g0 - G(-2, -2));
  float ne = EPS + fabsf(C(-1, 1) - C(1, -1)) + fabsf(C(-1, 1) - C(-3, 3)) + fabsf(g0 - G(-2, 2));
  float sw = EPS + fabsf(C(-1, 1) - C(1, -1)) + fabsf(C(1, -1) - C(3, -3)) + fabsf(g0 - G(2, -2));
  float se = EPS + fabsf(C(-1, -1) - C(1, 1)) + fabsf(C(1, 1) - C(3, 3)) + fabsf(g0 - G(2, 2));
  float p_est = (nw * (C(1, 1) - G(1, 1)) + se * (C(-1, -1) - G(-1, -1))) / (nw + se);
  float q_est = (ne * (C(1, -1) - G(1, -1)) + sw * (C(-1, 1) - G(-1, 1))) / (ne + sw);
  float pqd = f.at(pq_disc, y, x);
  float opp = g0 + (pqd * q_est + (1.0f - pqd) * p_est);
#undef C
#undef G
  r_nb[i] = col == 0 ? c0 : opp;
  b_nb[i] = col == 2 ? c0 : opp;
}

// step 4.3 at one green site for one chroma plane p
__device__ __forceinline__ float at_green(const float* p, const float* g, float vhd,
                                          const Frame& f, int y, int x) {
#define P(dy, dx) f.at(p, y + (dy), x + (dx))
#define G(dy, dx) f.at(g, y + (dy), x + (dx))
  float g0 = G(0, 0);
  float n1 = EPS + fabsf(g0 - G(-2, 0));
  float s1 = EPS + fabsf(g0 - G(2, 0));
  float w1 = EPS + fabsf(g0 - G(0, -2));
  float e1 = EPS + fabsf(g0 - G(0, 2));
  float sn = fabsf(P(-1, 0) - P(1, 0));
  float ew = fabsf(P(0, -1) - P(0, 1));
  float ng = n1 + sn + fabsf(P(-1, 0) - P(-3, 0));
  float sg = s1 + sn + fabsf(P(1, 0) - P(3, 0));
  float wg = w1 + ew + fabsf(P(0, -1) - P(0, -3));
  float eg = e1 + ew + fabsf(P(0, 1) - P(0, 3));
  float v_e = (ng * (P(1, 0) - G(1, 0)) + sg * (P(-1, 0) - G(-1, 0))) / (ng + sg);
  float h_e = (eg * (P(0, -1) - G(0, -1)) + wg * (P(0, 1) - G(0, 1))) / (eg + wg);
#undef P
#undef G
  return g0 + (vhd * h_e + (1.0f - vhd) * v_e);
}

// step 4.3 (chroma at green sites), crop, clamp at 0 and undo the scaling
__global__ void finish(const float* __restrict__ g, const float* __restrict__ r_nb,
                       const float* __restrict__ b_nb, const float* __restrict__ vh_disc,
                       float* __restrict__ out, int h, int w, Frame f, int cfa,
                       const float* __restrict__ scaler) {
  int ox = blockIdx.x * BX + threadIdx.x;
  int oy = blockIdx.y * BY + threadIdx.y;
  if (ox >= w || oy >= h) return;
  int y = oy + PAD, x = ox + PAD;
  size_t i = f.idx(y, x);
  float r = r_nb[i], b = b_nb[i];
  if (color_at(cfa, y, x) == 1) {
    float vhd = vh_disc[i];
    r = at_green(r_nb, g, vhd, f, y, x);
    b = at_green(b_nb, g, vhd, f, y, x);
  }
  float s = *scaler;
  size_t plane = (size_t)h * w;
  size_t o = (size_t)oy * w + ox;
  out[o] = jmax(r, 0.0f) * s;
  out[plane + o] = jmax(g[i], 0.0f) * s;
  out[2 * plane + o] = jmax(b, 0.0f) * s;
}

}  // namespace

extern "C" {

// Number of float32 planes of (h + 2*PAD) x (w + 2*PAD) the scratch holds.
int rcd_scratch_planes() { return 8; }
int rcd_pad() { return PAD; }

// x: (h, w) mosaic; out: (3, h, w); scratch: rcd_scratch_planes() padded
// planes; cfa: 2-bit colour ids of the 2x2 period in reading order;
// scaler: one float on the device.  Launches on `stream`, returns
// cudaGetLastError().
int rcd_demosaic(const float* x, float* out, float* scratch, int h, int w,
                 int cfa, const float* scaler, void* stream) {
  Frame f{h + 2 * PAD, w + 2 * PAD};
  size_t n = (size_t)f.hp * f.wp;
  float* c = scratch;
  float* s1 = scratch + n;      // hv      -> vh_disc
  float* s2 = scratch + 2 * n;  // hh      -> pq_disc
  float* s3 = scratch + 3 * n;  // hp      -> g
  float* s4 = scratch + 4 * n;  // hq      -> r_nb
  float* lpf = scratch + 5 * n;
  float* s6 = scratch + 6 * n;  // vh_dir  -> b_nb
  float* pq_dir = scratch + 7 * n;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 block(BX, BY);
  dim3 grid_p((f.wp + BX - 1) / BX, (f.hp + BY - 1) / BY);
  dim3 grid_o((w + BX - 1) / BX, (h + BY - 1) / BY);
  pad_normalize<<<grid_p, block, 0, st>>>(x, c, h, w, f, scaler);
  filters<<<grid_p, block, 0, st>>>(c, s1, s2, s3, s4, lpf, f);
  stats<<<grid_p, block, 0, st>>>(s1, s2, s3, s4, s6, pq_dir, f);
  green<<<grid_p, block, 0, st>>>(c, lpf, s6, pq_dir, s1, s2, s3, f, cfa);
  chroma_rb<<<grid_p, block, 0, st>>>(c, s3, s2, s4, s6, f, cfa);
  finish<<<grid_o, block, 0, st>>>(s3, s4, s6, s1, out, h, w, f, cfa, scaler);
  return (int)cudaGetLastError();
}

}  // extern "C"
