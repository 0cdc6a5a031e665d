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
// and out = acc * (1 / max(wsum, 1e-12)).  The offsets are summed in the
// order given and every operation follows the plain twin (kernels/nlm.py),
// built with --fmad=false, so kernel and twin round alike.
//
// What bounds it on this card: instruction issue.  Config 2 runs 225
// offsets on 24 MP (5.4e9 pixel-offsets) at about 35 float32 operations
// each; built without FMA (to round like the twin) every multiply and add
// is one instruction, and the card issues 33.5e12 a second, against a few
// hundred MB of memory traffic.
//
// Design: a block of 8 warps owns a tile of 2 (32 - 2P) columns x 32 rows.
// Each lane owns one column and a strip of 8 rows; it keeps the centre
// values of its strip and of the P rows above and below in registers.
// Per offset it reads the shifted pixel of those 8 + 2P rows (one float4,
// three channels, from shared memory), forms d2, the vertical sums over
// 2P + 1 rows in order, takes the neighbouring columns' sums from the
// other lanes by warp shuffles (the P lanes at each edge of a warp only
// compute the ring columns), sums them in order, weighs, and accumulates
// the shifted value it already holds: at P = 1 about 45 instructions per
// pixel-offset (d2 16 with the ring rows, sums 6 with the shuffles, the
// weight 13, the accumulation 7, the 2 ring lanes of 32), with no barrier
// and no global read in the offset loop.  Two paths, chosen by the wrapper
// (kernels/nlm.plan):
//   resident: the block's whole search window, the tile plus a ring of
//     R + P (R the lattice's reach), edge-clamped, in shared memory for
//     the whole lattice: (32 + 2(R+P)) x (2 (32 - 2P) + 2(R+P)) x 16 B,
//     58 KB at config 2 (R = 7, P = 1);
//   streaming, for windows that do not fit: per offset the block stages
//     the shifted tile and ring ((32 + 2P) x (2 (32 - 2P) + 2P) x 16 B,
//     two buffers alternating, 67 KB at P = 1) with 2-D loops of coalesced
//     rows, one barrier per offset.
// The offsets ride in the kernel's parameters, two int16 per int32.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int MAX_P = 8;
constexpr int MAX_OFFSETS = 900;
constexpr int NWX = 2;             // warps across a tile
constexpr int NWY = 4;             // warps down a tile
constexpr int NT = 32 * NWX * NWY;
constexpr int KR = 8;              // rows per lane
constexpr int TH = KR * NWY;       // tile rows
constexpr int MAX_SMEM = 232448;   // the most a block may have on sm_90
constexpr unsigned FULL = 0xffffffffu;

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

// rows x cols pixels of X from (y, x) on, edge-clamped, as float4 rows
__device__ __forceinline__ void stage(float4* dst, const float* __restrict__ x,
                                      int h, int w, int y, int x0, int rows,
                                      int cols) {
  const size_t plane = (size_t)h * w;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < rows; i += NT / 32) {
    const float* row = x + (size_t)clampi(y + i, h - 1) * w;
    for (int j = lane; j < cols; j += 32) {
      const int gx = clampi(x0 + j, w - 1);
      dst[i * cols + j] =
          make_float4(row[gx], row[plane + gx], row[2 * plane + gx], 0.0f);
    }
  }
}

template <int P>
__host__ __device__ constexpr int tile_w() {
  return NWX * (32 - 2 * P);
}

template <int P, bool RESIDENT>
__global__ void __launch_bounds__(NT, P <= 2 ? 2 : 1)
    nlm_kernel(const float* __restrict__ x, float* __restrict__ out, int h,
               int w, const Offsets offs, int n_off, int reach, float n0,
               float n1, float n2, const float* __restrict__ sharp_p,
               float cp_norm, float inv1cw, int variant) {
  extern __shared__ float4 win[];
  constexpr int WO = 32 - 2 * P, TW = tile_w<P>(), NR = KR + 2 * P;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wx = warp % NWX, wy = warp / NWX;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int R = RESIDENT ? reach : 0;
  // the staged window starts at (y0 - P - R, x0 - P - R); this lane's
  // column is x0 - P + wx WO + lane, its first d2 row y0 - P + wy KR
  const int ww = TW + 2 * (P + R);
  const int col = wx * WO + lane, row = wy * KR;
  const float sharp = *sharp_p;

  // streaming: two buffers of the shifted tile and ring; the centre
  // window goes to the second, which offset 1 first overwrites
  constexpr int SW = TW + 2 * P, SA = (TH + 2 * P) * SW;
  float4* cwin = RESIDENT ? win : win + SA;
  stage(cwin, x, h, w, y0 - P - R, x0 - P - R, TH + 2 * (P + R), ww);
  __syncthreads();
  float c0[NR], c1[NR], c2[NR];
  {
    const float4* cen = cwin + (row + R) * ww + col + R;
#pragma unroll
    for (int a = 0; a < NR; ++a) {
      const float4 v = cen[a * ww];
      c0[a] = v.x;
      c1[a] = v.y;
      c2[a] = v.z;
    }
  }
  float acc0[KR], acc1[KR], acc2[KR], wsum[KR];
#pragma unroll
  for (int k = 0; k < KR; ++k) acc0[k] = acc1[k] = acc2[k] = wsum[k] = 0.0f;

  for (int it = 0; it < n_off; ++it) {
    const int packed = offs.o[it];
    const int dy = packed >> 16;
    const int dx = (int)(short)(packed & 0xffff);
    const float4* base;
    if (RESIDENT) {
      base = win + (row + R + dy) * ww + col + R + dx;
    } else {
      // the buffer written here was last read at offset it - 2, before
      // the barrier of offset it - 1
      float4* b = win + (it & 1) * SA;
      stage(b, x, h, w, y0 - P + dy, x0 - P + dx, TH + 2 * P, SW);
      __syncthreads();
      base = b + row * SW + col;
    }
    const int stride = RESIDENT ? ww : SW;
    float d2[NR], s0[KR], s1[KR], s2[KR];
#pragma unroll
    for (int a = 0; a < NR; ++a) {
      const float4 v = base[a * stride];
      const float e0 = c0[a] - v.x, e1 = c1[a] - v.y, e2 = c2[a] - v.z;
      d2[a] = n0 * (e0 * e0) + n1 * (e1 * e1) + n2 * (e2 * e2);
      if (a >= P && a < KR + P) {
        s0[a - P] = v.x;
        s1[a - P] = v.y;
        s2[a - P] = v.z;
      }
    }
#pragma unroll
    for (int k = 0; k < KR; ++k) {
      float r = d2[k];
#pragma unroll
      for (int a = 1; a <= 2 * P; ++a) r = r + d2[k + a];
      // the columns lane - P .. lane + P, in order
      float ssd = P == 0 ? r : __shfl_up_sync(FULL, r, P);
#pragma unroll
      for (int b = 1; b <= 2 * P; ++b) {
        const float t = b < P ? __shfl_up_sync(FULL, r, P - b)
                              : (b == P ? r : __shfl_down_sync(FULL, r, b - P));
        ssd = ssd + t;
      }
      float wt;
      if (variant == 0) {
        wt = dt_fast_mexp2f(ssd * sharp);
      } else {
        const float dis = (ssd + d2[k + P] * cp_norm) * inv1cw;
        wt = dt_fast_mexp2f(jmax(0.0f, dis * sharp - 2.0f));
      }
      acc0[k] = acc0[k] + s0[k] * wt;
      acc1[k] = acc1[k] + s1[k] * wt;
      acc2[k] = acc2[k] + s2[k] * wt;
      wsum[k] = wsum[k] + wt;
    }
  }
  const int px = x0 - P + col;
  if (lane < P || lane >= 32 - P || px >= w) return;
  const size_t plane = (size_t)h * w;
#pragma unroll
  for (int k = 0; k < KR; ++k) {
    const int py = y0 + row + k;
    if (py >= h) break;
    const float inv = 1.0f / jmax(wsum[k], 1e-12f);
    const size_t q = (size_t)py * w + px;
    out[q] = acc0[k] * inv;
    out[plane + q] = acc1[k] * inv;
    out[2 * plane + q] = acc2[k] * inv;
  }
}

// shared bytes of a path: the resident window, or the streaming path's
// two buffers of the shifted tile and ring
int smem_bytes(int P, int reach, bool resident) {
  const int tw = NWX * (32 - 2 * P);
  if (resident)
    return (TH + 2 * (P + reach)) * (tw + 2 * (P + reach)) * 16;
  return 2 * (TH + 2 * P) * (tw + 2 * P) * 16;
}

template <int P>
int launch(bool resident, const float* x, float* out, int h, int w,
           const Offsets& offs, int n_off, int reach, float n0, float n1,
           float n2, const float* sharp, float cp_norm, float inv1cw,
           int variant, int smem, cudaStream_t st) {
  const dim3 grid((w + tile_w<P>() - 1) / tile_w<P>(), (h + TH - 1) / TH);
  const void* fn = resident ? (const void*)nlm_kernel<P, true>
                            : (const void*)nlm_kernel<P, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (resident)
    nlm_kernel<P, true><<<grid, NT, smem, st>>>(x, out, h, w, offs, n_off,
                                                reach, n0, n1, n2, sharp,
                                                cp_norm, inv1cw, variant);
  else
    nlm_kernel<P, false><<<grid, NT, smem, st>>>(x, out, h, w, offs, n_off,
                                                 reach, n0, n1, n2, sharp,
                                                 cp_norm, inv1cw, variant);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

void nlm_limits(int* max_p, int* max_offsets, int* tile_h, int* warps_x,
                int* max_smem) {
  *max_p = MAX_P;
  *max_offsets = MAX_OFFSETS;
  *tile_h = TH;
  *warps_x = NWX;
  *max_smem = MAX_SMEM;
}

// x, out: (3, h, w) float32 on the device; offsets: n_off packed (dy, dx)
// in host memory; sharp: one float on the device; resident and smem: the
// path and its shared bytes (kernels/nlm.plan).  Launches on `stream`,
// returns the first error.
int nlm(const float* x, float* out, int h, int w, const int* offsets,
        int n_off, int P, float n0, float n1, float n2, const float* sharp,
        float cp_norm, float inv1cw, int variant, int resident, int smem,
        void* stream) {
  if (n_off < 1 || n_off > MAX_OFFSETS || P < 0 || P > MAX_P || h < 1 ||
      w < 1)
    return (int)cudaErrorInvalidValue;
  Offsets offs;
  int reach = 0;
  for (int i = 0; i < n_off; ++i) {
    offs.o[i] = offsets[i];
    const int dy = offsets[i] >> 16, dx = (int)(short)(offsets[i] & 0xffff);
    reach = dy > reach ? dy : (-dy > reach ? -dy : reach);
    reach = dx > reach ? dx : (-dx > reach ? -dx : reach);
  }
  if (smem != smem_bytes(P, reach, resident != 0) || smem > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool res = resident != 0;
  switch (P) {
    case 0: return launch<0>(res, x, out, h, w, offs, n_off, reach, n0, n1, n2, sharp, cp_norm, inv1cw, variant, smem, st);
    case 1: return launch<1>(res, x, out, h, w, offs, n_off, reach, n0, n1, n2, sharp, cp_norm, inv1cw, variant, smem, st);
    case 2: return launch<2>(res, x, out, h, w, offs, n_off, reach, n0, n1, n2, sharp, cp_norm, inv1cw, variant, smem, st);
    case 3: return launch<3>(res, x, out, h, w, offs, n_off, reach, n0, n1, n2, sharp, cp_norm, inv1cw, variant, smem, st);
    case 4: return launch<4>(res, x, out, h, w, offs, n_off, reach, n0, n1, n2, sharp, cp_norm, inv1cw, variant, smem, st);
    case 5: return launch<5>(res, x, out, h, w, offs, n_off, reach, n0, n1, n2, sharp, cp_norm, inv1cw, variant, smem, st);
    case 6: return launch<6>(res, x, out, h, w, offs, n_off, reach, n0, n1, n2, sharp, cp_norm, inv1cw, variant, smem, st);
    case 7: return launch<7>(res, x, out, h, w, offs, n_off, reach, n0, n1, n2, sharp, cp_norm, inv1cw, variant, smem, st);
    default: return launch<8>(res, x, out, h, w, offs, n_off, reach, n0, n1, n2, sharp, cp_norm, inv1cw, variant, smem, st);
  }
}

}  // extern "C"
