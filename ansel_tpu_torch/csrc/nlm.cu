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
// The offsets ride in the kernel's parameters, two int16 per int32, at
// most 900 a launch.  A longer lattice runs in chunks of at most 900
// offsets, launched in order: each chunk but the first loads the
// float32 sums (acc, wsum) its predecessor stored in a scratch of four
// planes, each but the last stores them there, and only the last
// normalises.  A float32 store and load is exact, so the sums add the
// offsets in the same order as one launch would, bit for bit.
//
// Patch radii above MAX_P (the register strips and shuffles above are
// templated on P) take nlm_wide_kernel: P at run time, a 32 x 32 tile a
// block, the offsets read from device memory (any count in one launch).
// Per offset the tile's d2 plane, (32 + 2P)^2 from (y0 - P, x0 - P), is
// never held whole: it streams through shared memory in 64 x 64 pieces,
// columns in chunks of 64 and, inside a chunk, rows in bands of 64 (one
// of each up to P 16).  Each thread keeps the column sums of eight rows
// r of one chunk column (rows r .. r + 2P, each begun at its own first
// row and added in row order as the bands pass), which go to shared
// memory at the chunk's end; then each pixel adds the chunk's columns of
// its row, in column order.  So the sums are the twin's, term for term,
// and shared memory (25 KB) does not grow with P: every patch radius
// runs, as the JAX package's XLA path takes every one.  Two barriers per
// band and two per chunk, (32 + 2P)^2 d2 evaluations and
// (2P + 1)(32 + 2P) / 8 + 4 (2P + 1) additions a thread per offset.

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
constexpr int MODE_LOAD = 1;       // start from the scratch's sums
constexpr int MODE_FINAL = 2;      // normalise into out (else store sums)
constexpr int WIDE_T = 32;         // nlm_wide_kernel's tile side
constexpr int WIDE_B = 64;         // its chunks' columns and bands' rows
constexpr int WIDE_NT = 256;

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
               float cp_norm, float inv1cw, int variant,
               float* __restrict__ sums, int mode) {
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
  const int px = x0 - P + col;
  const bool owner = lane >= P && lane < 32 - P && px < w;
  const size_t plane = (size_t)h * w;
  if ((mode & MODE_LOAD) && owner) {
    // a later chunk: continue the sums of the chunks before it
#pragma unroll
    for (int k = 0; k < KR; ++k) {
      const int py = y0 + row + k;
      if (py < h) {
        const size_t q = (size_t)py * w + px;
        acc0[k] = sums[q];
        acc1[k] = sums[plane + q];
        acc2[k] = sums[2 * plane + q];
        wsum[k] = sums[3 * plane + q];
      }
    }
  }

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
  if (!owner) return;
#pragma unroll
  for (int k = 0; k < KR; ++k) {
    const int py = y0 + row + k;
    if (py >= h) break;
    const size_t q = (size_t)py * w + px;
    if (mode & MODE_FINAL) {
      const float inv = 1.0f / jmax(wsum[k], 1e-12f);
      out[q] = acc0[k] * inv;
      out[plane + q] = acc1[k] * inv;
      out[2 * plane + q] = acc2[k] * inv;
    } else {
      sums[q] = acc0[k];
      sums[plane + q] = acc1[k];
      sums[2 * plane + q] = acc2[k];
      sums[3 * plane + q] = wsum[k];
    }
  }
}

// patch radius P at run time (P > MAX_P): see the header
__global__ void __launch_bounds__(WIDE_NT)
    nlm_wide_kernel(const float* __restrict__ x, float* __restrict__ out,
                    int h, int w, const int* __restrict__ offs, int n_off,
                    int P, float n0, float n1, float n2,
                    const float* __restrict__ sharp_p, float cp_norm,
                    float inv1cw, int variant) {
  __shared__ float band[WIDE_B][WIDE_B + 1];  // d2: band rows x chunk cols
  __shared__ float cs[WIDE_T][WIDE_B + 1];    // column sums: rows x chunk cols
  // the tile's d2 plane spans S x S from (y0 - P, x0 - P); its column
  // sums of rows r .. r + 2P and row sums of columns c .. c + 2P are
  // taken in chunks of WIDE_B columns and bands of WIDE_B rows
  const int S = WIDE_T + 2 * P, P2 = 2 * P;
  const int t = threadIdx.x, tx = t % WIDE_T, ty = t / WIDE_T;
  const int x0 = blockIdx.x * WIDE_T, y0 = blockIdx.y * WIDE_T;
  const size_t plane = (size_t)h * w;
  const float sharp = *sharp_p;
  constexpr int G = WIDE_NT / WIDE_T;     // row groups
  constexpr int ROWS = WIDE_T / G;        // pixels a thread: rows ty + G k
  // the column sums' threads: chunk column cc of rows cg + CG k
  constexpr int CG = WIDE_NT / WIDE_B, CROWS = WIDE_T / CG;
  const int cc = t % WIDE_B, cg = t / WIDE_B;
  float acc0[ROWS], acc1[ROWS], acc2[ROWS], wsum[ROWS];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) acc0[k] = acc1[k] = acc2[k] = wsum[k] = 0.0f;
  for (int it = 0; it < n_off; ++it) {
    const int packed = offs[it];
    const int dy = packed >> 16;
    const int dx = (int)(short)(packed & 0xffff);
    float ssd[ROWS] = {};
    for (int cb = 0; cb < S; cb += WIDE_B) {
      // chunk column cc: the sums of d2 rows r .. r + 2P for r = cg + CG k,
      // each from its first row on, the rows streamed in bands in order
      float col[CROWS] = {};
      const int nc = min(WIDE_B, S - cb);  // the chunk's columns
      for (int qb = 0; qb < S; qb += WIDE_B) {
        // the band's nq x nc patch distances, spread over every thread
        const int nq = min(WIDE_B, S - qb);
        for (int i = t; i < nq * nc; i += WIDE_NT) {
          const int r = i / nc, c = i % nc;
          const int qy = y0 - P + qb + r, qx = x0 - P + cb + c;
          const size_t a = (size_t)clampi(qy, h - 1) * w + clampi(qx, w - 1);
          const size_t b =
              (size_t)clampi(qy + dy, h - 1) * w + clampi(qx + dx, w - 1);
          const float e0 = x[a] - x[b], e1 = x[plane + a] - x[plane + b],
                      e2 = x[2 * plane + a] - x[2 * plane + b];
          band[r][c] = n0 * (e0 * e0) + n1 * (e1 * e1) + n2 * (e2 * e2);
        }
        __syncthreads();
        if (cc < nc) {
#pragma unroll
          for (int k = 0; k < CROWS; ++k) {
            const int r = cg + CG * k;
            const int lo = max(qb, r), hi = min(qb + nq - 1, r + P2);
            for (int q = lo; q <= hi; ++q) {
              const float v = band[q - qb][cc];
              col[k] = q == r ? v : col[k] + v;
            }
          }
        }
        __syncthreads();
      }
      if (cc < nc) {
#pragma unroll
        for (int k = 0; k < CROWS; ++k) cs[cg + CG * k][cc] = col[k];
      }
      __syncthreads();
      // pixel (ty + G k, tx): its columns tx .. tx + 2P that fall in
      // this chunk, in order
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        const int r = ty + G * k;
        const int lo = max(tx, cb), hi = min(cb + nc - 1, tx + P2);
        for (int c = lo; c <= hi; ++c) {
          const float v = cs[r][c - cb];
          ssd[k] = c == tx ? v : ssd[k] + v;
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const int py = y0 + ty + G * k, px = x0 + tx;
      float wt;
      if (variant == 0) {
        wt = dt_fast_mexp2f(ssd[k] * sharp);
      } else {
        // the pixel's own d2, as the plane above forms it
        const size_t a = (size_t)clampi(py, h - 1) * w + clampi(px, w - 1);
        const size_t b =
            (size_t)clampi(py + dy, h - 1) * w + clampi(px + dx, w - 1);
        const float e0 = x[a] - x[b], e1 = x[plane + a] - x[plane + b],
                    e2 = x[2 * plane + a] - x[2 * plane + b];
        const float d2 = n0 * (e0 * e0) + n1 * (e1 * e1) + n2 * (e2 * e2);
        const float dis = (ssd[k] + d2 * cp_norm) * inv1cw;
        wt = dt_fast_mexp2f(jmax(0.0f, dis * sharp - 2.0f));
      }
      const size_t q =
          (size_t)clampi(py + dy, h - 1) * w + clampi(px + dx, w - 1);
      acc0[k] = acc0[k] + x[q] * wt;
      acc1[k] = acc1[k] + x[plane + q] * wt;
      acc2[k] = acc2[k] + x[2 * plane + q] * wt;
      wsum[k] = wsum[k] + wt;
    }
  }
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int py = y0 + ty + G * k, px = x0 + tx;
    if (py >= h || px >= w) continue;
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
           int variant, int smem, float* sums, int mode, cudaStream_t st) {
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
                                                cp_norm, inv1cw, variant,
                                                sums, mode);
  else
    nlm_kernel<P, false><<<grid, NT, smem, st>>>(x, out, h, w, offs, n_off,
                                                 reach, n0, n1, n2, sharp,
                                                 cp_norm, inv1cw, variant,
                                                 sums, mode);
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
// in host memory, one chunk of the lattice; sharp: one float on the
// device; resident and smem: the path and its shared bytes
// (kernels/nlm.plan); sums: (4, h, w) float32 scratch on the device, read
// when mode has MODE_LOAD and written unless it has MODE_FINAL (may be
// null for a single chunk, mode MODE_FINAL).  Launches on `stream`,
// returns the first error.
int nlm(const float* x, float* out, int h, int w, const int* offsets,
        int n_off, int P, float n0, float n1, float n2, const float* sharp,
        float cp_norm, float inv1cw, int variant, int resident, int smem,
        float* sums, int mode, void* stream) {
  if (n_off < 1 || n_off > MAX_OFFSETS || P < 0 || P > MAX_P || h < 1 ||
      w < 1 || mode < 0 || mode > 3 || (mode != MODE_FINAL && !sums))
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
    case 0: return launch<0>(res, x, out, h, w, offs, n_off, reach, n0, n1, n2, sharp, cp_norm, inv1cw, variant, smem, sums, mode, st);
    case 1: return launch<1>(res, x, out, h, w, offs, n_off, reach, n0, n1, n2, sharp, cp_norm, inv1cw, variant, smem, sums, mode, st);
    case 2: return launch<2>(res, x, out, h, w, offs, n_off, reach, n0, n1, n2, sharp, cp_norm, inv1cw, variant, smem, sums, mode, st);
    case 3: return launch<3>(res, x, out, h, w, offs, n_off, reach, n0, n1, n2, sharp, cp_norm, inv1cw, variant, smem, sums, mode, st);
    case 4: return launch<4>(res, x, out, h, w, offs, n_off, reach, n0, n1, n2, sharp, cp_norm, inv1cw, variant, smem, sums, mode, st);
    case 5: return launch<5>(res, x, out, h, w, offs, n_off, reach, n0, n1, n2, sharp, cp_norm, inv1cw, variant, smem, sums, mode, st);
    case 6: return launch<6>(res, x, out, h, w, offs, n_off, reach, n0, n1, n2, sharp, cp_norm, inv1cw, variant, smem, sums, mode, st);
    case 7: return launch<7>(res, x, out, h, w, offs, n_off, reach, n0, n1, n2, sharp, cp_norm, inv1cw, variant, smem, sums, mode, st);
    default: return launch<8>(res, x, out, h, w, offs, n_off, reach, n0, n1, n2, sharp, cp_norm, inv1cw, variant, smem, sums, mode, st);
  }
}

// patch radius P > MAX_P (any): x, out as above; offsets: n_off packed
// (dy, dx) in device memory; one launch for the whole lattice.
int nlm_wide(const float* x, float* out, int h, int w, const int* offsets,
             int n_off, int P, float n0, float n1, float n2,
             const float* sharp, float cp_norm, float inv1cw, int variant,
             void* stream) {
  if (n_off < 1 || P < 0 || P > (1 << 20) || h < 1 || w < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((w + WIDE_T - 1) / WIDE_T, (h + WIDE_T - 1) / WIDE_T);
  nlm_wide_kernel<<<grid, WIDE_NT, 0, (cudaStream_t)stream>>>(
      x, out, h, w, offsets, n_off, P, n0, n1, n2, sharp, cp_norm, inv1cw,
      variant);
  return (int)cudaGetLastError();
}

}  // extern "C"
