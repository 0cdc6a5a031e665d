// RCD Bayer demosaic for Hopper (sm_90a).
//
// Replaces: ansel_tpu/kernels/rcd_pallas.py:rcd_demosaic_pallas, the
// Pallas TPU kernel.  It computes what that kernel computes: RCD on the
// mosaic normalised by `scaler` and edge-padded, cropped back, clamped at
// 0 and multiplied by `scaler`.  RCD reads at most 10 px away (hpf 3,
// stat +1, refine +1, then g at +-2 and p at +-3 in step 4.3), so the
// edge-extended mosaic within 10 px of a pixel decides it, as the TPU
// kernel's 12/64 px halo does.
//
// What bounds it: the float32 work, about 330 operations a pixel (0.24 ms
// at 24 MP issued alone at 33.5 T instructions/s, --fmad=false; its 9
// divisions' reciprocals take 0.05 ms of the special function units),
// against 16 B/px of compulsory traffic (0.115 ms at 3.35 TB/s).
//
// Design: one launch; a block owns a TH x TW output tile and runs the
// whole chain on it in shared memory.  It loads the mosaic over the tile
// and a 10-px halo once (clamped source indices: the edge extension,
// normalised on load), then computes each intermediate over the tile
// widened by what the later steps still read of it (the margins below),
// so no value on the tile's output pixels depends on anything outside the
// loaded halo:
//   c 10 | hv, hh, lpf 7 | vh_dir 6 | vh_disc, g, hp, hq 5 | pq_dir 4 |
//   pq_disc, r_nb, b_nb 3 | out 0
// Six planes hold these in turn (a plane is reused once what it held is
// read for the last time), 66 KB for a 32 x 48 tile, so three blocks of
// 512 threads share an SM.  A step's sites go to the threads in reading
// order, so a warp's 32 sites lie at consecutive addresses of the plane
// it writes; the steps that treat greens and the other sites apart
// (green, the chroma at R/B sites, the chroma at greens) take the sites
// by parity class instead, so the colour is uniform in a warp.  Every
// load of the mosaic a thread makes is issued before the first is used.
// Expressions keep the Pallas kernel's operand order with IEEE divisions,
// and the library is built with --fmad=false, so the result equals the
// plain torch version (kernels/rcd.py) bit for bit; max(., .) keeps NaN
// in one instruction (max.NaN.f32), as jnp.maximum does.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr float EPS = 1e-5f;
constexpr float EPSSQ = 1e-10f;
constexpr int TH = 32;     // output rows of a block
constexpr int TW = 48;     // output columns of a block
constexpr int NT = 512;    // threads of a block
constexpr int HALO = 10;   // RCD's reach

// plane margins, in the order of the planes in shared memory
constexpr int M0 = 10, M1 = 7, M2 = 7, M3 = 6, M4 = 5, M5 = 4;

__host__ __device__ constexpr int area(int m) {
  return (TH + 2 * m) * (TW + 2 * m);
}

constexpr int SMEM =
    4 * (area(M0) + area(M1) + area(M2) + area(M3) + area(M4) + area(M5));

// jnp.maximum: NaN in either operand gives NaN, one instruction
__device__ __forceinline__ float jmax(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// a plane of the tile widened by its margin m; (y, x) tile-relative
struct Plane {
  float* p;
  int m;
  __device__ __forceinline__ float& operator()(int y, int x) const {
    return p[(y + m) * (TW + 2 * m) + x + m];
  }
};

// colour (0 R, 1 G, 2 B) at image (y, x), y and x possibly negative; cfa
// packs the 2x2 period as 2-bit ids in reading order
__device__ __forceinline__ int color_at(int cfa, int y, int x) {
  return (cfa >> (2 * (((y & 1) << 1) | (x & 1)))) & 3;
}

// f(y, x) at every (y, x) of the tile widened by M, in reading order
// across the block's threads: a warp takes 32 consecutive sites, whose
// addresses in a plane of margin M are consecutive
template <int M, typename F>
__device__ __forceinline__ void for_rect(F&& f) {
  constexpr int W = TW + 2 * M, N = (TH + 2 * M) * W;
#pragma unroll 2
  for (int k = 0; k < (N + NT - 1) / NT; ++k) {
    const int i = threadIdx.x + k * NT;
    if (i < N) f(i / W - M, i % W - M);
  }
}

// f(y, x) at every (y, x) of the tile widened by M, a warp at a time on
// up to 32 sites of one parity class (row and column mod 2): the colour
// is uniform in a warp
template <int M, typename F>
__device__ __forceinline__ void for_parity(F&& f) {
  constexpr int H = TH + 2 * M, W = TW + 2 * M;
  constexpr int WB0 = (W + 1) / 2, WB1 = W / 2, HA0 = (H + 1) / 2, HA1 = H / 2;
  constexpr int N0 = HA0 * WB0, N1 = HA0 * WB1, N2 = HA1 * WB0, N3 = HA1 * WB1;
  constexpr int C0 = (N0 + 31) / 32, C1 = C0 + (N1 + 31) / 32,
                C2 = C1 + (N2 + 31) / 32, C3 = C2 + (N3 + 31) / 32;
  const int lane = threadIdx.x & 31;
  for (int ci = threadIdx.x >> 5; ci < C3; ci += NT / 32) {
    const int g = (ci >= C0) + (ci >= C1) + (ci >= C2);
    const int cs = g == 0 ? 0 : (g == 1 ? C0 : (g == 2 ? C1 : C2));
    const int n = g == 0 ? N0 : (g == 1 ? N1 : (g == 2 ? N2 : N3));
    const int ra = g >> 1, rb = g & 1;
    const int j = (ci - cs) * 32 + lane;
    if (j < n) {
      const int a = rb ? j / WB1 : j / WB0;
      const int b = j - a * (rb ? WB1 : WB0);
      f(ra + 2 * a - M, rb + 2 * b - M);
    }
  }
}

__device__ __forceinline__ float refine(const Plane& d, int y, int x) {
  const float d0 = d(y, x);
  const float nbh =
      0.25f * (d(y - 1, x - 1) + d(y - 1, x + 1) + d(y + 1, x - 1) +
               d(y + 1, x + 1));
  return fabsf(0.5f - d0) < fabsf(0.5f - nbh) ? nbh : d0;
}

// step 4.3 at one green site for one chroma plane p
__device__ __forceinline__ float at_green(const Plane& p, const Plane& g,
                                          float vhd, int y, int x) {
#define P(dy, dx) p(y + (dy), x + (dx))
#define G(dy, dx) g(y + (dy), x + (dx))
  const float g0 = G(0, 0);
  const float n1 = EPS + fabsf(g0 - G(-2, 0));
  const float s1 = EPS + fabsf(g0 - G(2, 0));
  const float w1 = EPS + fabsf(g0 - G(0, -2));
  const float e1 = EPS + fabsf(g0 - G(0, 2));
  const float sn = fabsf(P(-1, 0) - P(1, 0));
  const float ew = fabsf(P(0, -1) - P(0, 1));
  const float ng = n1 + sn + fabsf(P(-1, 0) - P(-3, 0));
  const float sg = s1 + sn + fabsf(P(1, 0) - P(3, 0));
  const float wg = w1 + ew + fabsf(P(0, -1) - P(0, -3));
  const float eg = e1 + ew + fabsf(P(0, 1) - P(0, 3));
  const float v_e = (ng * (P(1, 0) - G(1, 0)) + sg * (P(-1, 0) - G(-1, 0))) /
                    (ng + sg);
  const float h_e = (eg * (P(0, -1) - G(0, -1)) + wg * (P(0, 1) - G(0, 1))) /
                    (eg + wg);
#undef P
#undef G
  return g0 + (vhd * h_e + (1.0f - vhd) * v_e);
}

__global__ void __launch_bounds__(NT, 3)
rcd_tile(const float* __restrict__ xin, float* __restrict__ out, int h, int w,
         int cfa, const float* __restrict__ scaler) {
  extern __shared__ float smem[];
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const Plane c{smem, M0};
  const Plane p1{c.p + area(M0), M1};
  const Plane p2{p1.p + area(M1), M2};
  const Plane p3{p2.p + area(M2), M3};
  const Plane p4{p3.p + area(M3), M4};
  const Plane p5{p4.p + area(M4), M5};
  const float s = *scaler;
  const float inv = jmax(s, 1e-9f);

  // the edge-extended mosaic, normalised: every load of a thread issued
  // before the first is used
  {
    constexpr int W = TW + 2 * HALO, N = area(HALO), K = (N + NT - 1) / NT;
    float v[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = threadIdx.x + k * NT;
      int gy = y0 + i / W - HALO, gx = x0 + i % W - HALO;
      gy = gy < 0 ? 0 : (gy >= h ? h - 1 : gy);
      gx = gx < 0 ? 0 : (gx >= w ? w - 1 : gx);
      v[k] = i < N ? __ldg(xin + (size_t)gy * w + gx) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = threadIdx.x + k * NT;
      if (i < N) c.p[i] = jmax(v[k], 0.0f) / inv;
    }
  }
  __syncthreads();

#define C(dy, dx) c(y + (dy), x + (dx))
  // step 1: v/h high-pass filters, squared -> p1, p2
  for_rect<7>([&](int y, int x) {
    const float c0 = C(0, 0);
    float t = C(-3, 0) - C(-1, 0) - C(1, 0) + C(3, 0) -
              3.0f * (C(-2, 0) + C(2, 0)) + 6.0f * c0;
    p1(y, x) = t * t;
    t = C(0, -3) - C(0, -1) - C(0, 1) + C(0, 3) -
        3.0f * (C(0, -2) + C(0, 2)) + 6.0f * c0;
    p2(y, x) = t * t;
  });
  __syncthreads();

  // v/h statistics -> vh_dir in p3
  for_rect<6>([&](int y, int x) {
    const float v = jmax(EPSSQ, p1(y - 1, x) + p1(y, x) + p1(y + 1, x));
    const float hh = jmax(EPSSQ, p2(y, x - 1) + p2(y, x) + p2(y, x + 1));
    p3(y, x) = v / (v + hh);
  });
  __syncthreads();

  // refined vh_disc -> p1; step 2, the low-pass -> p2
  for_rect<5>([&](int y, int x) { p1(y, x) = refine(p3, y, x); });
  for_rect<7>([&](int y, int x) {
    p2(y, x) = (C(0, 0) + 0.5f * (C(-1, 0) + C(1, 0) + C(0, -1) + C(0, 1))) +
               0.25f * (C(-1, -1) + C(-1, 1) + C(1, -1) + C(1, 1));
  });
  __syncthreads();

  // step 3: green at R/B sites -> g in p3
  for_parity<5>([&](int y, int x) {
    const float c0 = C(0, 0);
    if (color_at(cfa, y0 + y, x0 + x) == 1) {
      p3(y, x) = c0;
      return;
    }
#define L(dy, dx) p2(y + (dy), x + (dx))
    const float cn1 = C(-1, 0), cs1 = C(1, 0), cw1 = C(0, -1), ce1 = C(0, 1);
    const float ns = fabsf(cn1 - cs1);
    const float we = fabsf(cw1 - ce1);
    const float n_g = EPS + ns + fabsf(c0 - C(-2, 0)) + fabsf(cn1 - C(-3, 0)) +
                      fabsf(C(-2, 0) - C(-4, 0));
    const float s_g = EPS + ns + fabsf(c0 - C(2, 0)) + fabsf(cs1 - C(3, 0)) +
                      fabsf(C(2, 0) - C(4, 0));
    const float w_g = EPS + we + fabsf(c0 - C(0, -2)) + fabsf(cw1 - C(0, -3)) +
                      fabsf(C(0, -2) - C(0, -4));
    const float e_g = EPS + we + fabsf(c0 - C(0, 2)) + fabsf(ce1 - C(0, 3)) +
                      fabsf(C(0, 2) - C(0, 4));
    const float l0 = L(0, 0);
    const float two = l0 + l0;
    const float n_e = cn1 * two / (EPS + l0 + L(-2, 0));
    const float s_e = cs1 * two / (EPS + l0 + L(2, 0));
    const float w_e = cw1 * two / (EPS + l0 + L(0, -2));
    const float e_e = ce1 * two / (EPS + l0 + L(0, 2));
#undef L
    const float v_est = (s_g * n_e + n_g * s_e) / (n_g + s_g);
    const float h_est = (w_g * e_e + e_g * w_e) / (e_g + w_g);
    const float vhd = p1(y, x);
    p3(y, x) = vhd * h_est + (1.0f - vhd) * v_est;
  });
  __syncthreads();

  // step 4.0: p/q high-pass filters, squared -> p2, p4
  for_rect<5>([&](int y, int x) {
    const float c0 = C(0, 0);
    float t = C(-3, -3) - C(-1, -1) - C(1, 1) + C(3, 3) -
              3.0f * (C(-2, -2) + C(2, 2)) + 6.0f * c0;
    p2(y, x) = t * t;
    t = C(-3, 3) - C(-1, 1) - C(1, -1) + C(3, -3) -
        3.0f * (C(-2, 2) + C(2, -2)) + 6.0f * c0;
    p4(y, x) = t * t;
  });
  __syncthreads();

  // step 4.1: p/q statistics -> pq_dir in p5
  for_rect<4>([&](int y, int x) {
    const float p = jmax(EPSSQ, p2(y - 1, x - 1) + p2(y, x) + p2(y + 1, x + 1));
    const float q = jmax(EPSSQ, p4(y - 1, x + 1) + p4(y, x) + p4(y + 1, x - 1));
    p5(y, x) = p / (p + q);
  });
  __syncthreads();

  // refined pq_disc -> p2
  for_rect<3>([&](int y, int x) { p2(y, x) = refine(p5, y, x); });
  __syncthreads();

  // step 4.2: the opposite chroma at R and B sites -> r_nb, b_nb in p4, p5
  for_parity<3>([&](int y, int x) {
    const int col = color_at(cfa, y0 + y, x0 + x);
    const float c0 = C(0, 0);
    if (col == 1) {
      p4(y, x) = 0.0f;
      p5(y, x) = 0.0f;
      return;
    }
#define G(dy, dx) p3(y + (dy), x + (dx))
    const float g0 = G(0, 0);
    const float nw = EPS + fabsf(C(-1, -1) - C(1, 1)) +
                     fabsf(C(-1, -1) - C(-3, -3)) + fabsf(g0 - G(-2, -2));
    const float ne = EPS + fabsf(C(-1, 1) - C(1, -1)) +
                     fabsf(C(-1, 1) - C(-3, 3)) + fabsf(g0 - G(-2, 2));
    const float sw = EPS + fabsf(C(-1, 1) - C(1, -1)) +
                     fabsf(C(1, -1) - C(3, -3)) + fabsf(g0 - G(2, -2));
    const float se = EPS + fabsf(C(-1, -1) - C(1, 1)) +
                     fabsf(C(1, 1) - C(3, 3)) + fabsf(g0 - G(2, 2));
    const float p_est = (nw * (C(1, 1) - G(1, 1)) + se * (C(-1, -1) - G(-1, -1))) /
                        (nw + se);
    const float q_est = (ne * (C(1, -1) - G(1, -1)) + sw * (C(-1, 1) - G(-1, 1))) /
                        (ne + sw);
#undef G
    const float pqd = p2(y, x);
    const float opp = g0 + (pqd * q_est + (1.0f - pqd) * p_est);
    p4(y, x) = col == 0 ? c0 : opp;
    p5(y, x) = col == 2 ? c0 : opp;
  });
#undef C
  __syncthreads();

  // step 4.3 (chroma at green sites), crop, clamp at 0 and undo the scaling
  const size_t plane = (size_t)h * w;
  for_parity<0>([&](int y, int x) {
    const int gy = y0 + y, gx = x0 + x;
    if (gy >= h || gx >= w) return;
    float r = p4(y, x), b = p5(y, x);
    if (color_at(cfa, gy, gx) == 1) {
      const float vhd = p1(y, x);
      r = at_green(p4, p3, vhd, y, x);
      b = at_green(p5, p3, vhd, y, x);
    }
    const size_t o = (size_t)gy * w + gx;
    out[o] = jmax(r, 0.0f) * s;
    out[plane + o] = jmax(p3(y, x), 0.0f) * s;
    out[2 * plane + o] = jmax(b, 0.0f) * s;
  });
}

}  // namespace

extern "C" {

// The launch geometry the wrapper plans with (kernels/rcd.py checks it).
void rcd_limits(int* tile_h, int* tile_w, int* threads, int* halo,
                int* smem) {
  *tile_h = TH;
  *tile_w = TW;
  *threads = NT;
  *halo = HALO;
  *smem = SMEM;
}

// x: (h, w) mosaic; out: (3, h, w); cfa: 2-bit colour ids of the 2x2
// period in reading order; scaler: one float on the device; smem: the
// shared bytes of a block, as planned.  One launch on `stream`; returns
// cudaGetLastError().
int rcd_demosaic(const float* x, float* out, int h, int w, int cfa,
                 const float* scaler, int smem, void* stream) {
  if (h < 1 || w < 1 || smem != SMEM) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      (const void*)rcd_tile, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH);
  rcd_tile<<<grid, NT, SMEM, (cudaStream_t)stream>>>(x, out, h, w, cfa,
                                                     scaler);
  return (int)cudaGetLastError();
}

}  // extern "C"
