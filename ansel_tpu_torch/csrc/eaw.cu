// One edge-aware a-trous scale for Hopper (sm_90a).
//
// Replaces: ansel_tpu/kernels/eaw_pallas.py:_coarse_pallas, behind
// eaw_dn_coarse_pallas (variant 0) and eaw_atrous_coarse_pallas (variant
// 1).  For each pixel of a (3, h, w) image it sums 25 B3 taps at spacing
// d, each read at clamped coordinates (the Pallas kernel's edge padding),
// weighted by the colour distance to the centre:
//   variant 0: w = k * fast_mexp2f(max(0, |drgb|^2 * c * 0.02 - 9)),
//              shared by the channels; coarse = num * (1 / max(den, 1e-12))
//   variant 1: w0 = k * dt_fast_expf(-(d0^2) * c), wc for channels 1-2
//              from d1^2 + d2^2; coarse = num / max(den, 1e-9)
// and writes coarse and detail = x - coarse.  Operand order follows the
// Pallas kernel, and the library is built with --fmad=false, so kernel
// and plain twin (kernels/eaw.py) round alike; fast_mexp2f and
// dt_fast_expf are the reference's bit tricks (pixel/fastmath.py).
//
// What bounds it: on config 2 (24 MP, 7 scales) the memory bound is 289
// MB read + 577 MB written per scale (0.26 ms at 3.35 TB/s); the
// arithmetic is about 24 float32 instructions per tap, 610 per pixel
// (0.44 ms at 33.5 T instructions/s without FMA), so the instruction
// issue is what a kernel runs into.
//
// Design: a block owns TH output rows of one residue class mod d, y = r +
// (t TH + k) d, and TW columns, so every vertical tap lands on a row of
// the same class: the block stages TH + 4 rows of its class, over the
// columns its taps read, in shared memory as (r, g, b, 0) float4s, one
// load per plane and entry, each thread walking one column down the rows
// with half its loads issued together.  The columns are contiguous, TW +
// 4d from x0 - 2d, below d = TW; from d = TW on only the five groups of
// TW columns at x0 + (ix - 2) d are staged, so any scale fits.  After one
// barrier each thread sums two pixels' 25 taps from the tile, one 16-byte
// shared load per tap, interleaved; the variant is a template parameter,
// so the tap loop has no branch, and max(., 0) keeps NaN in one
// instruction (max.NaN.f32).

#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>

namespace {

constexpr int NT = 256;            // threads of a block
constexpr int TW = 64;             // output columns of a block
constexpr int TH = 8;              // output rows of a block (one class)
constexpr int TROWS = TH + 4;      // staged rows
constexpr int MAX_SMEM = 232448;   // the most a block may have on sm_90

__device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// jnp.maximum(0, a): NaN stays NaN (fmaxf would drop it), one instruction
__device__ __forceinline__ float jmax0(float a) {
  float r;
  asm("max.NaN.f32 %0, %1, 0f00000000;" : "=f"(r) : "f"(a));
  return r;
}

// jnp.maximum(a, lo) for the denominators, NaN kept
__device__ __forceinline__ float jmax(float a, float lo) {
  return (a != a || lo != lo) ? a + lo : fmaxf(a, lo);
}

// fast_mexp2f (math.h:306-316): the float32 sum, then truncation
__device__ __forceinline__ float fast_mexp2f(float x) {
  const float k0f = 1065353216.0f + x * -8388608.0f;
  const int k = k0f >= 8388608.0f ? (int)k0f : 0;
  return __int_as_float(k);
}

// dt_fast_expf (math.h:254-267)
__device__ __forceinline__ float dt_fast_expf(float x) {
  const int k0 = (int)(1065353216.0f + x * 11401300.0f);
  return __int_as_float(k0 > 0 ? k0 : 0);
}

// the strip's global column at strip column c (clamped): contiguous, x0 -
// 2d + c; gathered, x0 + (c mod TW) + (c / TW - 2) d
template <bool GATHER>
__device__ __forceinline__ int strip_col(int c, int x0, int d, int w) {
  return GATHER ? clampi(x0 + (c % TW) + (c / TW - 2) * d, w - 1)
                : clampi(x0 - 2 * d + c, w - 1);
}

struct Acc {
  float num0 = 0.0f, num1 = 0.0f, num2 = 0.0f, den0 = 0.0f, den1 = 0.0f;
};

// one tap of one pixel, in the Pallas kernel's operand order
template <int VARIANT>
__device__ __forceinline__ void tap(Acc& a, float4 s, float4 ctr, float k,
                                    float c) {
  const float e0 = s.x - ctr.x, e1 = s.y - ctr.y, e2 = s.z - ctr.z;
  if (VARIANT == 0) {
    const float dist2 = e0 * e0 + e1 * e1 + e2 * e2;
    const float wt = k * fast_mexp2f(jmax0(dist2 * c * 0.02f - 9.0f));
    a.num0 = a.num0 + wt * s.x;
    a.num1 = a.num1 + wt * s.y;
    a.num2 = a.num2 + wt * s.z;
    a.den0 = a.den0 + wt;
  } else {
    const float w0 = k * dt_fast_expf(-(e0 * e0) * c);
    const float wc = k * dt_fast_expf(-(e1 * e1 + e2 * e2) * c);
    a.num0 = a.num0 + w0 * s.x;
    a.num1 = a.num1 + wc * s.y;
    a.num2 = a.num2 + wc * s.z;
    a.den0 = a.den0 + w0;
    a.den1 = a.den1 + wc;
  }
}

template <int VARIANT>
__device__ __forceinline__ void store(const Acc& a, float4 ctr, float* cp,
                                      float* dp, size_t at, size_t plane) {
  float c0, c1, c2;
  if (VARIANT == 0) {
    const float inv = 1.0f / jmax(a.den0, 1e-12f);
    c0 = a.num0 * inv;
    c1 = a.num1 * inv;
    c2 = a.num2 * inv;
  } else {
    c0 = a.num0 / jmax(a.den0, 1e-9f);
    c1 = a.num1 / jmax(a.den1, 1e-9f);
    c2 = a.num2 / jmax(a.den1, 1e-9f);
  }
  cp[at] = c0;
  cp[plane + at] = c1;
  cp[2 * plane + at] = c2;
  dp[at] = ctr.x - c0;
  dp[plane + at] = ctr.y - c1;
  dp[2 * plane + at] = ctr.z - c2;
}

template <int VARIANT, bool GATHER>
__global__ void __launch_bounds__(NT, 5)
eaw_tile(const float* __restrict__ x, float* __restrict__ coarse,
         float* __restrict__ detail, int h, int w, int d, float c, int sw) {
  extern __shared__ float4 tile[];  // TROWS x sw
  // the block's residue class r, first class index j0 and rows
  const int dd = min(d, h);
  const int t = blockIdx.y / dd;
  const int r = blockIdx.y - t * dd, j0 = t * TH;
  const int rows = min(TH, (h - 1 - r) / d + 1 - j0);
  if (rows <= 0) return;
  const int x0 = blockIdx.x * TW;
  const size_t plane = (size_t)h * w;

  for (int col = threadIdx.x; col < sw; col += NT) {
    const float* xc = x + strip_col<GATHER>(col, x0, d, w);
#pragma unroll
    for (int half = 0; half < TROWS; half += TROWS / 2) {  // 18 loads each
      float4 v[TROWS / 2];
#pragma unroll
      for (int i = 0; i < TROWS / 2; ++i) {
        const int q = half + i;
        const size_t at = (size_t)clampi(r + (j0 + q - 2) * d, h - 1) * w;
        if (q < rows + 4)
          v[i] = make_float4(__ldg(xc + at), __ldg(xc + plane + at),
                             __ldg(xc + 2 * plane + at), 0.0f);
      }
#pragma unroll
      for (int i = 0; i < TROWS / 2; ++i)
        if (half + i < rows + 4) tile[(half + i) * sw + col] = v[i];
    }
  }
  __syncthreads();

  const int cx = threadIdx.x % TW, k0 = threadIdx.x / TW;  // k0 < TH / 2
  if (x0 + cx >= w) return;
  const int step = GATHER ? TW : d;  // strip columns between two taps
  const bool two = k0 + TH / 2 < rows;
  if (k0 >= rows) return;
  const float4* p0 = tile + k0 * sw + cx;
  const float4* p1 = p0 + (TH / 2) * sw;
  const float4 ctr0 = p0[2 * sw + 2 * step];
  const float4 ctr1 = two ? p1[2 * sw + 2 * step] : ctr0;
  const float b3[5] = {1.0f / 16.0f, 4.0f / 16.0f, 6.0f / 16.0f,
                       4.0f / 16.0f, 1.0f / 16.0f};
  Acc a0, a1;
#pragma unroll
  for (int iy = 0; iy < 5; ++iy) {
#pragma unroll
    for (int ix = 0; ix < 5; ++ix) {
      const float k = b3[iy] * b3[ix];
      const int off = iy * sw + ix * step;
      tap<VARIANT>(a0, p0[off], ctr0, k, c);
      if (two) tap<VARIANT>(a1, p1[off], ctr1, k, c);
    }
  }
  const int y0 = r + (j0 + k0) * d;
  store<VARIANT>(a0, ctr0, coarse, detail, (size_t)y0 * w + x0 + cx, plane);
  if (two)
    store<VARIANT>(a1, ctr1, coarse, detail,
                   (size_t)(y0 + (TH / 2) * d) * w + x0 + cx, plane);
}

}  // namespace

extern "C" {

void eaw_limits(int* threads, int* tile_w, int* tile_h, int* max_smem) {
  *threads = NT;
  *tile_w = TW;
  *tile_h = TH;
  *max_smem = MAX_SMEM;
}

// x, coarse, detail: (3, h, w) float32 on the device; d = 2^scale; c is
// inv_sigma2 (variant 0) or sharpen (variant 1); smem: the tile's bytes
// (kernels/eaw.plan), checked here.  Launches on `stream`, returns
// cudaGetLastError().
int eaw_coarse(const float* x, float* coarse, float* detail, int h, int w,
               int d, float c, int variant, int smem, void* stream) {
  if ((variant != 0 && variant != 1) || h < 1 || w < 1 || d < 1)
    return (int)cudaErrorInvalidValue;
  const bool gather = d >= TW;
  const int sw = gather ? 5 * TW : TW + 4 * d;
  if ((long long)TROWS * sw * 16 != smem || smem > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  const long long rows_y =
      (((long long)h + d - 1) / d + TH - 1) / TH * (d < h ? d : h);
  const int hw = h > w ? h : w;
  if (rows_y > 65535 || (long long)(h + TROWS) * hw > INT_MAX)
    return (int)cudaErrorInvalidValue;
  // every tap past the frame clamps alike at any d >= max(h, w), so the
  // kernel indexes in int with d capped there (the tile keeps d's form)
  const int dk = d < hw ? d : hw;
  void (*fn)(const float*, float*, float*, int, int, int, float, int) =
      variant == 0 ? (gather ? eaw_tile<0, true> : eaw_tile<0, false>)
                   : (gather ? eaw_tile<1, true> : eaw_tile<1, false>);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((w + TW - 1) / TW, (unsigned)rows_y);
  fn<<<grid, NT, smem, (cudaStream_t)stream>>>(x, coarse, detail, h, w, dk,
                                               c, sw);
  return (int)cudaGetLastError();
}

}  // extern "C"
