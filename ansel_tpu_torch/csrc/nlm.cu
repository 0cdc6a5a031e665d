// Non-local means over a static offset lattice, for Hopper (sm_90a).
//
// Replaces: ansel_tpu/kernels/nlm_pallas.py:nlm_pallas (its rolled and
// dx-grouped forms).  On the edge-padded (3, h, w) image X, per offset o:
//   d2(q)  = n0 (X0[q] - X0[q+o])^2 + n1 (..)^2 + n2 (..)^2, both reads
//            clamped to the frame, for q on the tile and a ring of P
//   ssd(p) = box sum of d2 over (2P+1)^2: per column the rows in order,
//            then the columns in order
//   variant 0: w = dt_fast_mexp2f(ssd * sharp)
//   variant 1: w = dt_fast_mexp2f(max(0, (ssd + d2(p) cp) * inv1cw * sharp - 2))
//   acc += X[p+o] * w, wsum += w
// and out = acc * (1 / max(wsum, 1e-12)).  Operand order follows the
// Pallas kernel and the library is built with --fmad=false, so kernel and
// plain twin (kernels/nlm.py) round alike.
//
// What bounds it: arithmetic.  Config 2 runs 225 offsets on 24 MP, some
// 25 float32 operations per pixel and offset (about 1.35e11), against a
// few hundred MB of memory traffic.
//
// Design: a block of 32 x 8 threads owns a 32 x 32 output tile.  The
// centre values of the tile and its ring of P stay in shared memory for
// the whole lattice.  Per offset the block writes d2 of tile + ring to a
// shared plane (two planes alternate, so one barrier per offset
// suffices), reading the shifted pixels through the L1 cache; then each
// thread box-sums, weighs and accumulates its four pixels in registers.
// The offsets ride in the kernel's parameters, two int16 per int32.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int MAX_P = 8;
constexpr int MAX_OFFSETS = 900;
constexpr int BX = 32;   // threads in x = tile width
constexpr int BY = 8;    // threads in y
constexpr int TH = 32;   // tile height: 4 rows per thread
constexpr int RPT = TH / BY;

struct Offsets {
  int o[MAX_OFFSETS];  // (dy << 16) | (dx & 0xffff)
};

__device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

__device__ __forceinline__ float jmax(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

// dt_fast_mexp2f (math.h:290-301): integer arithmetic on the bits
__device__ __forceinline__ float dt_fast_mexp2f(float x) {
  const int k0 = 1065353216 + (int)(x * -8388608.0f);
  return __int_as_float(k0 >= 0x800000 ? k0 : 0);
}

__global__ void nlm_kernel(const float* __restrict__ x, float* __restrict__ out,
                           int h, int w, const Offsets offs, int n_off, int P,
                           float n0, float n1, float n2,
                           const float* __restrict__ sharp_p, float cp_norm,
                           float inv1cw, int variant) {
  extern __shared__ float smem[];
  const int RW = BX + 2 * P, RH = TH + 2 * P, RA = RW * RH;
  float* cen = smem;            // 3 x RH x RW centre values
  float* d2b = smem + 3 * RA;   // 2 x RH x RW d2 planes
  const size_t plane = (size_t)h * w;
  const int x0 = blockIdx.x * BX, y0 = blockIdx.y * TH;
  const int tid = threadIdx.y * BX + threadIdx.x;
  const float sharp = *sharp_p;

  for (int i = tid; i < RA; i += BX * BY) {
    const int gy = clampi(y0 - P + i / RW, h - 1);
    const int gx = clampi(x0 - P + i % RW, w - 1);
    const size_t q = (size_t)gy * w + gx;
    cen[i] = x[q];
    cen[RA + i] = x[plane + q];
    cen[2 * RA + i] = x[2 * plane + q];
  }

  float acc0[RPT], acc1[RPT], acc2[RPT], wsum[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) acc0[k] = acc1[k] = acc2[k] = wsum[k] = 0.0f;
  const int px = x0 + threadIdx.x;

  __syncthreads();
  for (int it = 0; it < n_off; ++it) {
    const int packed = offs.o[it];
    const int dy = packed >> 16;
    const int dx = (int)(short)(packed & 0xffff);
    // the planes alternate: the barrier of offset it - 1 has seen every
    // thread finish reading this plane at offset it - 2
    float* d2 = d2b + (it & 1) * RA;
    for (int i = tid; i < RA; i += BX * BY) {
      const int gy = clampi(y0 - P + i / RW + dy, h - 1);
      const int gx = clampi(x0 - P + i % RW + dx, w - 1);
      const size_t q = (size_t)gy * w + gx;
      const float e0 = cen[i] - __ldg(x + q);
      const float e1 = cen[RA + i] - __ldg(x + plane + q);
      const float e2 = cen[2 * RA + i] - __ldg(x + 2 * plane + q);
      d2[i] = n0 * (e0 * e0) + n1 * (e1 * e1) + n2 * (e2 * e2);
    }
    __syncthreads();
    if (px >= w) continue;
    const int sx = clampi(px + dx, w - 1);
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const int ly = threadIdx.y + k * BY;
      const int py = y0 + ly;
      if (py >= h) break;
      const float* col = d2 + ly * RW + threadIdx.x;
      float ssd = 0.0f;
      for (int b = 0; b <= 2 * P; ++b) {
        float r = col[b];
        for (int a = 1; a <= 2 * P; ++a) r = r + col[a * RW + b];
        ssd = b == 0 ? r : ssd + r;
      }
      float wt;
      if (variant == 0) {
        wt = dt_fast_mexp2f(ssd * sharp);
      } else {
        const float dis = (ssd + col[P * RW + P] * cp_norm) * inv1cw;
        wt = dt_fast_mexp2f(jmax(0.0f, dis * sharp - 2.0f));
      }
      const size_t q = (size_t)clampi(py + dy, h - 1) * w + sx;
      acc0[k] = acc0[k] + __ldg(x + q) * wt;
      acc1[k] = acc1[k] + __ldg(x + plane + q) * wt;
      acc2[k] = acc2[k] + __ldg(x + 2 * plane + q) * wt;
      wsum[k] = wsum[k] + wt;
    }
  }
  if (px >= w) return;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int py = y0 + threadIdx.y + k * BY;
    if (py >= h) break;
    const float inv = 1.0f / jmax(wsum[k], 1e-12f);
    const size_t q = (size_t)py * w + px;
    out[q] = acc0[k] * inv;
    out[plane + q] = acc1[k] * inv;
    out[2 * plane + q] = acc2[k] * inv;
  }
}

}  // namespace

extern "C" {

void nlm_limits(int* max_p, int* max_offsets) {
  *max_p = MAX_P;
  *max_offsets = MAX_OFFSETS;
}

// x, out: (3, h, w) float32 on the device; offsets: n_off packed (dy, dx)
// in host memory; sharp: one float on the device.  Launches on `stream`,
// returns cudaGetLastError().
int nlm(const float* x, float* out, int h, int w, const int* offsets,
        int n_off, int P, float n0, float n1, float n2, const float* sharp,
        float cp_norm, float inv1cw, int variant, void* stream) {
  if (n_off < 1 || n_off > MAX_OFFSETS || P < 0 || P > MAX_P)
    return (int)cudaErrorInvalidValue;
  Offsets offs;
  for (int i = 0; i < n_off; ++i) offs.o[i] = offsets[i];
  const size_t smem = (size_t)5 * (BX + 2 * P) * (TH + 2 * P) * sizeof(float);
  dim3 block(BX, BY);
  dim3 grid((w + BX - 1) / BX, (h + TH - 1) / TH);
  nlm_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      x, out, h, w, offs, n_off, P, n0, n1, n2, sharp, cp_norm, inv1cw,
      variant);
  return (int)cudaGetLastError();
}

}  // extern "C"
