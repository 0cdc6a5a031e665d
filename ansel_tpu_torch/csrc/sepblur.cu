// Dilated separable odd-length FIR with edge padding, for Hopper (sm_90a).
//
// Replaces: ansel_tpu/kernels/sepblur_pallas.py:sep_blur_pallas (the
// row-strip form _sep_blur_strip and its tiled fallback).  It computes
//   V[y, x]   = sum_i t_i * X[clamp(y + (i - r) d), x]
//   out[y, x] = sum_j t_j * V[y, clamp(x + (j - r) d)]
// per plane, each sum in tap order from the first tap, like the XLA chain
// of pixel/shifts.sep_filter and the plain twin (kernels/sepblur.py).
// Clamping each read coordinate is the Pallas kernel's edge padding.
//
// What bounds it: device memory, one read of X and one write of out (the
// config-2 Laplacian blur moves 24 MB in and 24 MB out per call, 14 us at
// 3.35 TB/s).
//
// Design, below d = G = 256: one kernel.  A block owns TH output rows of
// one residue class mod d, y = r + (t TH + k) d for k < TH, so every
// vertical tap of those rows lands on a row of the same class: the
// vertical pass walks a window of TH + n - 1 input rows per column, one
// load per row, instead of n loads per output.  Each thread issues its
// column's window loads together (the tap count is a template parameter
// for the counts the port's callers use, so the window lives in registers
// and the taps are instruction operands), then writes V to a shared strip
// of SW = TW + 2m columns (m = r d), the least multiple of the block's
// 256 threads that holds 2m + G; after one barrier each thread sums its
// outputs' horizontal taps from the strip.  The wrapper
// (kernels/sepblur.plan) picks the rows per block: rows_of(n) for a
// template, up to TH for another tap count, fewer where its strip would
// pass 227 KB; it refuses only a strip that does not fit at one row.
//
// From d = G on, where a strip would recompute each V (n - 1) d / TW times
// more, two kernels pass through a scratch plane: V, one thread per value
// and n loads, then out, one thread per value and n loads of V, every load
// coalesced along x.  Any reach fits.  Built with --fmad=false, so every
// product and sum rounds like the plain torch version.

#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>

namespace {

constexpr int MAX_TAPS = 513;
constexpr int NT = 256;            // threads of a block
constexpr int TH = 16;             // output rows of a block (at most)
constexpr int G = 256;             // the dilation from which two passes run
constexpr int MAX_FIXED = 33;      // tap counts 3, 5, ..., 33 are templates
constexpr int MAX_SMEM = 232448;   // the most a block may have on sm_90

struct Taps {
  float t[MAX_TAPS];
};

__device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// rows of a block for a template of N taps: TH up to 9 taps, then 8 and
// 4, which keeps each window in 128 registers without spills and each
// strip below d = G within 227 KB
__host__ __device__ constexpr int rows_of(int n) {
  return n <= 9 ? TH : (n <= 25 ? TH / 2 : TH / 4);
}

// The block's residue class r, its first class index j0 and its row
// count (0: nothing to do); blockIdx.y = t * min(d, h) + r.
__device__ __forceinline__ int block_rows(int h, int d, int th, int* r,
                                          int* j0) {
  const int dd = min(d, h);
  const int t = blockIdx.y / dd;
  *r = blockIdx.y - t * dd;
  *j0 = t * th;
  const int nr = (h - 1 - *r) / d + 1;  // rows of class r
  return min(th, nr - *j0);
}

// The horizontal pass over the strip, shared by both strip kernels: the
// strip's column c holds V at clamp(x0 - r d + c).
template <int N>
__device__ __forceinline__ void horizontal(const float* __restrict__ vs,
                                           float* __restrict__ op,
                                           const Taps& taps, int n, int rows,
                                           int r, int j0, int d, int x0,
                                           int tw, int sw, int w) {
  for (int k = 0; k < rows; ++k) {
    float* orow = op + (size_t)(r + (j0 + k) * d) * w;
    for (int cx = threadIdx.x; cx < tw && x0 + cx < w; cx += NT) {
      const float* row = vs + k * sw + cx;  // the first tap
      float acc = taps.t[0] * row[0];
      if constexpr (N > 0) {
#pragma unroll
        for (int j = 1; j < N; ++j) acc = acc + taps.t[j] * row[j * d];
      } else {
        for (int j = 1; j < n; ++j) acc = acc + taps.t[j] * row[j * d];
      }
      orow[x0 + cx] = acc;
    }
  }
}

// N taps (a template): the vertical window in registers, rows_of(N) rows;
// up to 9 taps four blocks share an SM (64 registers), more taps two
template <int N>
__global__ void __launch_bounds__(NT, N <= 9 ? 4 : 2)
sep_fixed(const float* __restrict__ x, float* __restrict__ out, int h, int w,
          const Taps taps, int d, int tw, int sw) {
  extern __shared__ float vs[];  // rows x sw
  constexpr int R = (N - 1) / 2, ROWS = rows_of(N), WIN = ROWS + N - 1;
  int r, j0;
  const int rows = block_rows(h, d, ROWS, &r, &j0);
  if (rows <= 0) return;
  const int x0 = blockIdx.x * tw;
  const size_t plane = (size_t)h * w;
  const float* xp = x + blockIdx.z * plane;

  for (int c = threadIdx.x; c < sw; c += NT) {
    const float* col = xp + clampi(x0 - R * d + c, w - 1);
    float win[WIN];
#pragma unroll
    for (int q = 0; q < WIN; ++q) {
      const int gy = clampi(r + (j0 + q - R) * d, h - 1);
      win[q] = q < rows + N - 1 ? __ldg(col + (size_t)gy * w) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      if (k < rows) {
        float v = taps.t[0] * win[k];
#pragma unroll
        for (int i = 1; i < N; ++i) v = v + taps.t[i] * win[k + i];
        vs[k * sw + c] = v;
      }
    }
  }
  __syncthreads();
  horizontal<N>(vs, out + blockIdx.z * plane, taps, N, rows, r, j0, d, x0,
                tw, sw, w);
}

// any n: n loads per V, th rows (the plan's choice)
__global__ void __launch_bounds__(NT)
sep_any(const float* __restrict__ x, float* __restrict__ out, int h, int w,
        const Taps taps, int n, int d, int th, int tw, int sw) {
  extern __shared__ float vs[];  // th x sw
  const int R = (n - 1) / 2;
  int r, j0;
  const int rows = block_rows(h, d, th, &r, &j0);
  if (rows <= 0) return;
  const int x0 = blockIdx.x * tw;
  const size_t plane = (size_t)h * w;
  const float* xp = x + blockIdx.z * plane;

  for (int k = 0; k < rows; ++k) {
    for (int c = threadIdx.x; c < sw; c += NT) {
      const float* col = xp + clampi(x0 - R * d + c, w - 1);
      float v = 0.0f;
      for (int i = 0; i < n; ++i) {
        const int gy = clampi(r + (j0 + k + i - R) * d, h - 1);
        const float s = taps.t[i] * __ldg(col + (size_t)gy * w);
        v = i == 0 ? s : v + s;
      }
      vs[k * sw + c] = v;
    }
  }
  __syncthreads();
  horizontal<0>(vs, out + blockIdx.z * plane, taps, n, rows, r, j0, d, x0,
                tw, sw, w);
}

// Two passes (d >= G), one thread per value of row blockIdx.y of plane
// blockIdx.z: VERTICAL reads x at rows y + (i - r) d and writes V, else
// reads V at columns x + (j - r) d and writes out.
template <bool VERTICAL>
__global__ void __launch_bounds__(NT)
sep_pass(const float* __restrict__ in, float* __restrict__ out, int h, int w,
         const Taps taps, int n, int d) {
  const int xo = blockIdx.x * NT + threadIdx.x;
  if (xo >= w) return;
  const int y = blockIdx.y, R = (n - 1) / 2;
  const size_t plane = (size_t)h * w;
  const float* ip = in + blockIdx.z * plane;
  auto at = [&](int i) {
    return VERTICAL
               ? __ldg(ip + (size_t)clampi(y + (i - R) * d, h - 1) * w + xo)
               : __ldg(ip + (size_t)y * w + clampi(xo + (i - R) * d, w - 1));
  };
  float acc = taps.t[0] * at(0);
  for (int i = 1; i < n; ++i) acc = acc + taps.t[i] * at(i);
  out[blockIdx.z * plane + (size_t)y * w + xo] = acc;
}

// the strip's columns: the least multiple of NT that holds 2m + G
long long strip_width(int n, int d) {
  return ((long long)(n - 1) * d + G + NT - 1) / NT * NT;
}

typedef void (*FixedFn)(const float*, float*, int, int, const Taps, int, int,
                        int);

// the strip template for n taps, or nullptr
FixedFn pick_fixed(int n) {
  switch (n) {
    case 3: return sep_fixed<3>;
    case 5: return sep_fixed<5>;
    case 7: return sep_fixed<7>;
    case 9: return sep_fixed<9>;
    case 11: return sep_fixed<11>;
    case 13: return sep_fixed<13>;
    case 15: return sep_fixed<15>;
    case 17: return sep_fixed<17>;
    case 19: return sep_fixed<19>;
    case 21: return sep_fixed<21>;
    case 23: return sep_fixed<23>;
    case 25: return sep_fixed<25>;
    case 27: return sep_fixed<27>;
    case 29: return sep_fixed<29>;
    case 31: return sep_fixed<31>;
    case 33: return sep_fixed<33>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

void sep_blur_limits(int* max_taps, int* threads, int* tile_h, int* two_pass,
                     int* max_fixed, int* max_smem) {
  *max_taps = MAX_TAPS;
  *threads = NT;
  *tile_h = TH;
  *two_pass = G;
  *max_fixed = MAX_FIXED;
  *max_smem = MAX_SMEM;
}

// x, out: (c, h, w) float32 on the device; scratch: one more such tensor
// for the two passes (d >= G), else unused; taps: n floats in host memory
// (n odd, n <= MAX_TAPS); th and smem: the rows of a block and its shared
// bytes (kernels/sepblur.plan and smem_bytes), checked here.  Launches on
// `stream`, returns the first error.
int sep_blur(const float* x, float* out, float* scratch, int c, int h, int w,
             const float* taps, int n, int d, int th, int smem,
             void* stream) {
  if (n < 1 || n > MAX_TAPS || (n & 1) == 0 || d < 1 || h < 1 || w < 1 ||
      c < 1 || c > 65535 || th < 1 || th > TH)
    return (int)cudaErrorInvalidValue;
  const int hw = h > w ? h : w;
  if ((long long)(h + TH + n) * hw > INT_MAX)
    return (int)cudaErrorInvalidValue;
  // every tap past the frame clamps alike at any d >= max(h, w), so the
  // kernels index in int with d capped there
  const int dk = d < hw ? d : hw;
  Taps t;
  for (int i = 0; i < n; ++i) t.t[i] = taps[i];
  cudaStream_t st = (cudaStream_t)stream;

  if (d >= G) {
    if (smem != 0 || h > 65535 || scratch == nullptr)
      return (int)cudaErrorInvalidValue;
    dim3 grid((w + NT - 1) / NT, h, c);
    sep_pass<true><<<grid, NT, 0, st>>>(x, scratch, h, w, t, n, dk);
    sep_pass<false><<<grid, NT, 0, st>>>(scratch, out, h, w, t, n, dk);
    return (int)cudaGetLastError();
  }

  const long long sw = strip_width(n, d);
  const int tw = (int)(sw - (long long)(n - 1) * d);
  FixedFn fixed = pick_fixed(n);
  if (fixed != nullptr && th != rows_of(n)) fixed = nullptr;
  // a block holds at most th rows, and no more than a class has
  const long long per_class = ((long long)h + d - 1) / d;
  const long long rows = per_class < th ? per_class : th;
  if (rows * sw * (long long)sizeof(float) != smem || smem > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  const long long rows_y = (per_class + th - 1) / th * (d < h ? d : h);
  if (rows_y > 65535) return (int)cudaErrorInvalidValue;
  const void* fn = fixed != nullptr ? (const void*)fixed
                                    : (const void*)sep_any;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((w + tw - 1) / tw, (unsigned)rows_y, c);
  if (fixed != nullptr) {
    fixed<<<grid, NT, smem, st>>>(x, out, h, w, t, dk, tw, (int)sw);
  } else {
    sep_any<<<grid, NT, smem, st>>>(x, out, h, w, t, n, dk, th, tw, (int)sw);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
