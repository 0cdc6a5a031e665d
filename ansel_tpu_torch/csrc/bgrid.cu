// The bilateral-grid slice for Hopper (sm_90a): a trilinear read of the
// blurred (D, C, gh, gw) grid at every pixel.
//
// Replaces: ansel_tpu/kernels/bgrid_pallas.py:slice_grid.  Per output
// pixel (y, x) of the (Hp, Wp) = (gh ss, gw ss) frame and channel c:
//   col(k, q) = w0[x] G[k, c, q, i0[x]] + w1[x] G[k, c, q, i1[x]]
//               (the column upsample; the host builds the per-column taps
//               (i0, w0, i1, w1) with pixel/bilateralgrid.upsample_taps,
//               the JAX package's phase rule for ss <= 16 and its matrix
//               rows for ss > 16)
//   gy = clip((y + 0.5) / ss - 0.5, 0, gh - 1),  q = floor(gy)
//   P[k] = max(0, 1 - |gy - q|) col(k, q) + max(0, 1 - |gy - (q + 1)|) col(k, q + 1)
//   out  = (1 - f) P[b0] + f P[b0 + 1],  b0 = floor(z), f = z - b0,
// a bin outside [0, D - 1] contributing 0.  The Pallas kernel sums the
// same terms among others of weight exactly 0 (the rest of its slab rows
// and range bins, its 8-row DMA slack), which leave a float sum as it is;
// its tiles, slab DMA and slack are TPU matters and are gone.  Built with
// --fmad=false and a true division, like the plain twin
// (kernels/bgrid.py), so the two agree bit for bit.
//
// What bounds it: memory.  z is read once and C planes written once,
// 4 (1 + C) bytes per pixel (0.058 ms for C = 1 at 24 MP and 3.35 TB/s),
// against at most 22 + 22 C float32 operations per pixel.  The grid is at
// most ~14 MB (D = 32 at ss = 15 over 24 MP) and stays in the 50 MB L2.
//
// Design: one thread per output pixel for all channels, the column
// upsample folded in through the per-column taps (no (D, C, gh, Wp)
// intermediate in device memory); neighbouring threads share grid rows,
// which the caches serve.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int BX = 32;
constexpr int BY = 8;

__global__ void bgrid_slice_kernel(const float* __restrict__ grid,
                                   const float* __restrict__ z,
                                   const int2* __restrict__ taps_i,
                                   const float2* __restrict__ taps_w,
                                   float* __restrict__ out, int D, int C,
                                   int gh, int gw, int Hp, int Wp, int ss) {
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  if (x >= Wp || y >= Hp) return;

  // row hat weights of the two grid rows around gy
  const float gy =
      fminf(fmaxf(((float)y + 0.5f) / (float)ss - 0.5f, 0.0f), (float)(gh - 1));
  const float qa = floorf(gy);
  const float wa = fmaxf(0.0f, 1.0f - fabsf(gy - qa));
  const float wb = fmaxf(0.0f, 1.0f - fabsf(gy - (qa + 1.0f)));
  const int ia = (int)qa;
  const int ib = min(ia + 1, gh - 1);  // its weight is 0 at the last row

  // range triangle: bins b0 and b0 + 1
  const size_t o = (size_t)y * Wp + x;
  const float zz = z[o];
  const float b0 = floorf(zz);
  const float f = zz - b0;
  const float b1 = b0 + 1.0f;
  const bool v0 = b0 >= 0.0f && b0 <= (float)(D - 1);
  const bool v1 = b1 >= 0.0f && b1 <= (float)(D - 1);
  const int k0 = v0 ? (int)b0 : 0;
  const int k1 = v1 ? (int)b1 : 0;

  const int2 ci = taps_i[x];
  const float2 cw = taps_w[x];
  const size_t plane = (size_t)gh * gw;
  const size_t hw = (size_t)Hp * Wp;
  for (int c = 0; c < C; ++c) {
    float t0 = 0.0f, t1 = 0.0f;
    if (v0) {
      const float* g = grid + ((size_t)k0 * C + c) * plane;
      const float* ra = g + (size_t)ia * gw;
      const float* rb = g + (size_t)ib * gw;
      const float pa = cw.x * __ldg(ra + ci.x) + cw.y * __ldg(ra + ci.y);
      const float pb = cw.x * __ldg(rb + ci.x) + cw.y * __ldg(rb + ci.y);
      t0 = (1.0f - f) * (wa * pa + wb * pb);
    }
    if (v1) {
      const float* g = grid + ((size_t)k1 * C + c) * plane;
      const float* ra = g + (size_t)ia * gw;
      const float* rb = g + (size_t)ib * gw;
      const float pa = cw.x * __ldg(ra + ci.x) + cw.y * __ldg(ra + ci.y);
      const float pb = cw.x * __ldg(rb + ci.x) + cw.y * __ldg(rb + ci.y);
      t1 = f * (wa * pa + wb * pb);
    }
    out[c * hw + o] = t0 + t1;
  }
}

}  // namespace

extern "C" {

// grid: (D, C, gh, gw) float32; z: (Hp, Wp) float32 with Hp = gh ss and
// Wp = gw ss; taps_i / taps_w: Wp pairs (i0, i1) int32 and (w0, w1)
// float32; out: (C, Hp, Wp) float32; all on the device.  Launches on
// `stream`, returns cudaGetLastError().
int bgrid_slice(const float* grid, const float* z, const int* taps_i,
                const float* taps_w, float* out, int D, int C, int gh, int gw,
                int Hp, int Wp, int ss, void* stream) {
  if (D < 1 || C < 1 || gh < 1 || gw < 1 || ss < 1 || Hp != gh * ss ||
      Wp != gw * ss)
    return (int)cudaErrorInvalidValue;
  const dim3 block(BX, BY);
  const dim3 grid_dim((Wp + BX - 1) / BX, (Hp + BY - 1) / BY);
  bgrid_slice_kernel<<<grid_dim, block, 0, (cudaStream_t)stream>>>(
      grid, z, reinterpret_cast<const int2*>(taps_i),
      reinterpret_cast<const float2*>(taps_w), out, D, C, gh, gw, Hp, Wp, ss);
  return (int)cudaGetLastError();
}

}  // extern "C"
