// Deriche recursive Gaussian (orders 0-2) for Hopper (sm_90a).
//
// Replaces: ansel_tpu/kernels/iir_pallas.py:gaussian_iir_pallas (the
// pallas_call in _iir_vertical, whose _kernel runs the vertical recursion
// and which the horizontal axis reuses around an XLA transpose pair).
// Per line of an (n, h, w) float32 stack, optionally clamped first:
//   forward   y_i = (a0 x_i + a1 x_{i-1}) - b1 y_{i-1} - b2 y_{i-2},
//             primed with y_{-1} = y_{-2} = coefp x_0, x_{-1} = x_0;
//   backward  z_i = (a2 x_{i+1} + a3 x_{i+2}) - b1 z_{i+1} - b2 z_{i+2},
//             started at the end of the line edge-padded to a multiple of 8
//             (the Pallas kernel's row block) with z = coefn x_last;
//   out_i = y_i + z_i.
// Columns first (down each column), then rows, as the Pallas wrapper does.
// Operand order follows its _kernel term by term and the library is built
// with --fmad=false, so kernel and plain twin (kernels/iir.py) round alike.
//
// What bounds it: not the bytes (toneequal's (2, 1376, 2080) pair at
// 45 MP moves 46 MB per call, 14 us at 3.35 TB/s) but the recursion's
// latency: each line is a chain of dependent multiply-adds, and the pair
// has only 4160 (columns) or 2752 (rows) lines, about one warp per SM.
//
// Design: one thread per line, two launches (columns, then rows).  Each
// thread loads 8 inputs ahead into registers before it runs their 8 steps,
// so the loads of a block overlap instead of each waiting in turn.  In the
// column pass neighbouring threads read neighbouring addresses; in the row
// pass each thread walks its own row, and the L1 cache keeps each 128-byte
// line for the 32 values it serves.  Tiling the row pass through shared
// memory is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int RB = 8;      // the Pallas row block: the backward start's pad
constexpr int THREADS = 128;

struct Coef {
  float a0, a1, a2, a3, b1, b2, coefp, coefn;
};

// jnp.clip: NaN stays NaN
__device__ __forceinline__ float clip(float v, float lo, float hi) {
  if (v != v) return v;
  return v < lo ? lo : (v > hi ? hi : v);
}

// One line per thread: `len` values `step` apart; lines `lstride` apart,
// `lines` per plane; planes `pstride` apart.  Reads x, writes out (which
// must not alias x).
__global__ void iir_lines(const float* __restrict__ x, float* __restrict__ out,
                          int planes, int lines, int len, size_t step,
                          size_t lstride, size_t pstride, const Coef c,
                          float lo, float hi, int clamp) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= planes * lines) return;
  const size_t base = (size_t)(t / lines) * pstride + (size_t)(t % lines) * lstride;
  const float* xl = x + base;
  float* ol = out + base;
#define LOAD(i) (clamp ? clip(xl[(size_t)(i) * step], lo, hi) : xl[(size_t)(i) * step])

  // forward
  const float x0 = LOAD(0);
  float xprev = x0, y1 = c.coefp * x0, y2 = y1;
  for (int b = 0; b < len; b += RB) {
    float v[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) v[r] = b + r < len ? LOAD(b + r) : 0.0f;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (b + r < len) {
        const float f = c.a0 * v[r] + c.a1 * xprev;
        const float y = f - c.b1 * y1 - c.b2 * y2;
        ol[(size_t)(b + r) * step] = y;
        xprev = v[r];
        y2 = y1;
        y1 = y;
      }
    }
  }

  // backward, from the padded end; rows past the end repeat x_last
  const float xlast = LOAD(len - 1);
  float xn1 = xlast, xn2 = xlast, z1 = c.coefn * xlast, z2 = z1;
  const int padded = (len + RB - 1) / RB * RB;
  for (int b = padded - RB; b >= 0; b -= RB) {
    float v[RB], yf[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int i = b + r;
      v[r] = i < len ? LOAD(i) : xlast;
      yf[r] = i < len ? ol[(size_t)i * step] : 0.0f;
    }
#pragma unroll
    for (int r = RB - 1; r >= 0; --r) {
      const float f = c.a2 * xn1 + c.a3 * xn2;
      const float z = f - c.b1 * z1 - c.b2 * z2;
      if (b + r < len) ol[(size_t)(b + r) * step] = yf[r] + z;
      xn2 = xn1;
      xn1 = v[r];
      z2 = z1;
      z1 = z;
    }
  }
#undef LOAD
}

}  // namespace

extern "C" {

// x, tmp, out: (n, h, w) float32 on the device, distinct; coef: the eight
// float32 coefficients (a0, a1, a2, a3, b1, b2, coefp, coefn) in host
// memory; with clamp != 0 the input is first clamped to [lo, hi].  The
// column pass writes tmp, the row pass reads it and writes out.  Launches
// on `stream`, returns cudaGetLastError().
int gaussian_iir(const float* x, float* tmp, float* out, int n, int h, int w,
                 const float* coef, float lo, float hi, int clamp,
                 void* stream) {
  if (n < 1 || h < 1 || w < 1) return (int)cudaErrorInvalidValue;
  const Coef c = {coef[0], coef[1], coef[2], coef[3],
                  coef[4], coef[5], coef[6], coef[7]};
  const size_t plane = (size_t)h * w;
  cudaStream_t s = (cudaStream_t)stream;
  // columns: w lines of h values, w apart
  int threads = n * w;
  iir_lines<<<(threads + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      x, tmp, n, w, h, (size_t)w, 1, plane, c, lo, hi, clamp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // rows: h lines of w contiguous values
  threads = n * h;
  iir_lines<<<(threads + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      tmp, out, n, h, w, 1, (size_t)w, plane, c, lo, hi, 0);
  return (int)cudaGetLastError();
}

}  // extern "C"
