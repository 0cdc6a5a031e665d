// The bilateral-grid slice for Hopper (sm_90a): a trilinear read of the
// blurred (D, C, gh, gw) grid at every pixel.
//
// Replaces: ansel_tpu/kernels/bgrid_pallas.py:slice_grid.  Per output
// pixel (y, x) of the (Hp, Wp) = (gh ss, gw ss) frame and channel c:
//   col(k, q) = w0[x] G[k, c, q, i0[x]] + w1[x] G[k, c, q, i1[x]]
//               (the column upsample; the host builds the per-column taps
//               (i0, w0, i1, w1) with pixel/bilateralgrid.upsample_taps,
//               the JAX package's phase rule for ss <= 16 and its matrix
//               rows for ss > 16; at ss = 1 the upsample is the identity
//               and col(k, q) = G[k, c, q, x])
//   gy = clip((y + 0.5) / ss - 0.5, 0, gh - 1),  q = floor(gy)
//   P[k] = max(0, 1 - |gy - q|) col(k, q) + max(0, 1 - |gy - (q + 1)|) col(k, q + 1)
//   out  = (1 - f) P[b0] + f P[b0 + 1],  b0 = floor(z), f = z - b0,
// a bin outside [0, D - 1] contributing 0 (NaN z gives 0).  The Pallas
// kernel sums the same terms among others of weight exactly 0, which
// leave a float sum as it is.  Built with --fmad=false, the row weights
// from a true division, like the plain twin (kernels/bgrid.py): the two
// agree bit for bit.
//
// What bounds it: memory.  z is read once and C planes written once,
// 4 (1 + C) bytes per pixel (0.058 ms for C = 1 at 24 MP and 3.35 TB/s),
// against 22 + 22 C float32 operations per pixel.  The grid is at most
// ~14 MB on the main path (D = 32 at ss = 15 over 24 MP), but a warp's
// gathers of it through the read-only cache scatter over its pixels'
// bins: the eight values a pixel reads a channel come from a slab in
// shared memory instead.
//
// Design:
// - A block of 8 warps owns a tile of 128 columns by `th` rows.  A lane
//   owns 4 columns 32 apart, so each access of a warp to z or to an
//   output plane is 32 adjacent floats, and walks the tile's rows (a warp
//   every 8th row) with the next row's z in flight.  (A lane owning 4
//   adjacent columns with 16-byte accesses measured slower on the card:
//   its warp's pixels span 4 times as many grid columns, so the slab
//   reads conflict more, and rows of a width that is not a multiple of 4
//   are not 16-byte aligned.)
// - The per-column taps are loaded once a tile, the per-row weights (the
//   division) once a row on the host (kernels/bgrid.row_table), the range
//   bins picked by selects: a dropped bin is a selected 0, so NaN and inf
//   in the grid behave as the twin's torch.where.
// - The staged path: the block first copies into shared memory every
//   value of the grid its tile reads, all D bins and C channels over the
//   grid rows from ia of its first row to ib of its last and the columns
//   from the least i0 to the largest i1 of its 128 columns (taken from the
//   tap table, kernels/bgrid.col_ranges), and then reads the slab with
//   broadcasts: each bin's plane lies (Q mod 32) | 1 banks past the one
//   before, so neighbouring bins of a warp's pixels fall on different
//   banks (kernels/bgrid.slice_plan picks the strides).
// - The slab must fit 48 KB: the plan takes the tallest tile of 64, 32,
//   16 or 8 rows whose slab does.  Where none does (small ss with many
//   bins: at ss = 1 each grid value serves at most two rows of pixels, so
//   a slab would copy D / 2 values for each one read), the direct path
//   reads the grid through the read-only cache with the same lanes,
//   selects and arithmetic, in 8-row tiles (the most blocks in flight).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int TW = 128;        // tile columns: 32 lanes x 4
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int PX = 4;          // columns a lane owns, 32 apart
constexpr int SLAB_BYTES = 48 * 1024;

// CT: the channel count as a constant (1 or 3), 0 for any other.
// STAGED: the slab in shared memory (plane_stride > 0), else the direct
// path.  rows: (ia, ib, wa bits, wb bits) per frame row; cols: (least
// i0, largest i1) per tile of 128 columns.
template <int CT, bool STAGED>
__global__ void __launch_bounds__(THREADS, CT == 1 ? 4 : 3)
    bgrid_slice_kernel(const float* __restrict__ grid,
                       const float* __restrict__ z,
                       const int2* __restrict__ taps_i,
                       const float2* __restrict__ taps_w,
                       const int4* __restrict__ rows,
                       const int2* __restrict__ cols, float* __restrict__ out,
                       int D, int C_, int gh, int gw, int Hp, int Wp, int th,
                       int slab_r, int slab_q, int plane_stride, int ident) {
  const int C = CT ? CT : C_;
  extern __shared__ float slab[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * th;
  const int y1 = min(y0 + th, Hp);
  // this lane's column p is xl + 32 p; the first nx lie in the frame
  const int xl = x0 + lane;
  const int nx = min(PX, (Wp - xl + 31) / 32);
  const size_t gplane = (size_t)gh * gw;

  // the slab's origin in the grid (0, 0 on the direct path)
  const int2 cr = STAGED ? cols[blockIdx.x] : make_int2(0, 0);
  const int rlo = STAGED ? rows[y0].x : 0, clo = cr.x;

  // this lane's column taps, relative to the slab
  int q0[PX], q1[PX];
  float w0[PX], w1[PX];
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const int x = min(xl + 32 * p, Wp - 1);
    const int2 ti = taps_i[x];
    const float2 tw = taps_w[x];
    q0[p] = ti.x - clo;
    q1[p] = ti.y - clo;
    w0[p] = tw.x;
    w1[p] = tw.y;
  }

  // z of this warp's next row is in flight while it computes one (the
  // first while the block stages its slab)
  float zn[PX];
  auto load_z = [&](int y) {
#pragma unroll
    for (int p = 0; p < PX; ++p)
      zn[p] = p < nx ? z[(size_t)y * Wp + xl + 32 * p] : 0.0f;
  };
  if (y0 + warp < y1) load_z(y0 + warp);

  if (STAGED) {
    const int rt = rows[y1 - 1].y - rlo + 1;
    const int qt = cr.y - clo + 1;
    if (rt > slab_r || qt > slab_q) __trap();  // the plan was not followed
    // lanes per slab row: the least power of two >= qt, at most 32
    int lq = 1;
    while (lq < qt && lq < 32) lq <<= 1;
    const int per_warp = 32 / lq;
    const int total = D * C * rt;
    const float inv_rt = 1.0f / (float)rt;
    const int q = lane % lq;
#pragma unroll 4
    for (int pr = warp * per_warp + lane / lq; pr < total;
         pr += WARPS * per_warp) {
      // pr / rt: total is below 2^14, where the float product is exact
      // enough
      const int pl = (int)(((float)pr + 0.5f) * inv_rt);
      const int r = pr - pl * rt;
      const float* src = grid + pl * gplane + (size_t)(rlo + r) * gw + clo;
      float* dst = slab + pl * plane_stride + r * slab_q;
      for (int qq = q; qq < qt; qq += lq) dst[qq] = __ldg(src + qq);
    }
    __syncthreads();
  }
  if (nx <= 0) return;  // no barrier follows

  const int rstride = STAGED ? slab_q : gw;
  const size_t hw = (size_t)Hp * Wp;
  const float dmax = (float)(D - 1);
#pragma unroll 1
  for (int y = y0 + warp; y < y1; y += WARPS) {
    float zz[PX];
#pragma unroll
    for (int p = 0; p < PX; ++p) zz[p] = zn[p];
    if (y + WARPS < y1) load_z(y + WARPS);
    const int4 rt = rows[y];
    const int ra = (rt.x - rlo) * rstride;
    const int rb = (rt.y - rlo) * rstride;
    const float wa = __int_as_float(rt.z);
    const float wb = __int_as_float(rt.w);
    const size_t o = (size_t)y * Wp + xl;

    float f[PX];
    int k0[PX], k1[PX];
    bool v0[PX], v1[PX];
#pragma unroll
    for (int p = 0; p < PX; ++p) {
      const float b0 = floorf(zz[p]);
      const float b1 = b0 + 1.0f;
      f[p] = zz[p] - b0;
      v0[p] = b0 >= 0.0f && b0 <= dmax;
      v1[p] = b1 >= 0.0f && b1 <= dmax;
      k0[p] = v0[p] ? (int)b0 : 0;
      k1[p] = v1[p] ? (int)b1 : 0;
    }

#pragma unroll
    for (int c = 0; c < C; ++c) {
      float res[PX];
#pragma unroll
      for (int p = 0; p < PX; ++p) {
        // the upsampled grid at rows ra, rb of bin k
        auto col = [&](int k, int r) {
          const float* g = STAGED ? slab + (k * C + c) * plane_stride + r
                                  : grid + (size_t)(k * C + c) * gplane + r;
          const float g0 = STAGED ? g[q0[p]] : __ldg(g + q0[p]);
          const float g1 = STAGED ? g[q1[p]] : __ldg(g + q1[p]);
          return ident ? g0 : w0[p] * g0 + w1[p] * g1;
        };
        const float t0 =
            (1.0f - f[p]) * (wa * col(k0[p], ra) + wb * col(k0[p], rb));
        const float t1 = f[p] * (wa * col(k1[p], ra) + wb * col(k1[p], rb));
        res[p] = (v0[p] ? t0 : 0.0f) + (v1[p] ? t1 : 0.0f);
      }
#pragma unroll
      for (int p = 0; p < PX; ++p)
        if (p < nx) out[c * hw + o + 32 * p] = res[p];
    }
  }
}

template <int CT>
cudaError_t launch(bool staged, dim3 g, size_t smem, cudaStream_t s,
                   const float* grid, const float* z, const int2* ti,
                   const float2* tw, const int4* rows, const int2* cols,
                   float* out, int D, int C, int gh, int gw, int Hp, int Wp,
                   int th, int slab_r, int slab_q, int plane_stride,
                   int ident) {
  if (staged)
    bgrid_slice_kernel<CT, true><<<g, THREADS, smem, s>>>(
        grid, z, ti, tw, rows, cols, out, D, C, gh, gw, Hp, Wp, th, slab_r,
        slab_q, plane_stride, ident);
  else
    bgrid_slice_kernel<CT, false><<<g, THREADS, 0, s>>>(
        grid, z, ti, tw, rows, cols, out, D, C, gh, gw, Hp, Wp, th, slab_r,
        slab_q, plane_stride, ident);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The launch shape kernels/bgrid.slice_plan assumes (the wrapper checks).
int bgrid_tile_cols() { return TW; }
int bgrid_threads() { return THREADS; }
int bgrid_slab_bytes() { return SLAB_BYTES; }

// grid: (D, C, gh, gw) float32; z: (Hp, Wp) float32 with Hp = gh ss and
// Wp = gw ss; taps_i / taps_w: Wp pairs (i0, i1) int32 and (w0, w1)
// float32; rows: Hp records (ia, ib, wa, wb) int32 (the weights' bits);
// cols: a (least i0, largest i1) int32 pair per tile of 128 columns; out:
// (C, Hp, Wp) float32; all on the device.  th: the tile's rows; slab_r,
// slab_q: the slab's rows and columns, plane_stride its floats per (bin,
// channel) plane, 0 for the direct path.  Launches on `stream`, returns
// cudaGetLastError().
int bgrid_slice(const float* grid, const float* z, const int* taps_i,
                const float* taps_w, const int* rows, const int* cols,
                float* out, int D, int C, int gh, int gw, int Hp, int Wp,
                int ss, int th, int slab_r, int slab_q, int plane_stride,
                void* stream) {
  if (D < 1 || C < 1 || gh < 1 || gw < 1 || ss < 1 || Hp != gh * ss ||
      Wp != gw * ss || th < 1 || th % WARPS != 0 || plane_stride < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)D * C * plane_stride * sizeof(float);
  const bool staged = plane_stride > 0;
  if (staged && (smem > SLAB_BYTES || slab_r < 1 || slab_q < 1 ||
                 slab_r * slab_q > plane_stride))
    return (int)cudaErrorInvalidValue;
  const dim3 g((Wp + TW - 1) / TW, (Hp + th - 1) / th);
  cudaStream_t s = (cudaStream_t)stream;
  const int2* ti = reinterpret_cast<const int2*>(taps_i);
  const float2* tw = reinterpret_cast<const float2*>(taps_w);
  const int4* rw = reinterpret_cast<const int4*>(rows);
  const int2* cl = reinterpret_cast<const int2*>(cols);
  const int ident = ss == 1;
  cudaError_t err;
  if (C == 1)
    err = launch<1>(staged, g, smem, s, grid, z, ti, tw, rw, cl, out, D, C,
                    gh, gw, Hp, Wp, th, slab_r, slab_q, plane_stride, ident);
  else if (C == 3)
    err = launch<3>(staged, g, smem, s, grid, z, ti, tw, rw, cl, out, D, C,
                    gh, gw, Hp, Wp, th, slab_r, slab_q, plane_stride, ident);
  else
    err = launch<0>(staged, g, smem, s, grid, z, ti, tw, rw, cl, out, D, C,
                    gh, gw, Hp, Wp, th, slab_r, slab_q, plane_stride, ident);
  return (int)err;
}

}  // extern "C"
