// One diffuse-or-sharpen iteration for Hopper (sm_90a).
//
// Replaces: ansel_tpu/kernels/diffuse_pallas.py:diffuse_iteration_pallas
// (its pallas_call runs _kernel once per haloed tile).  On a (3, h, w)
// float32 image it computes an S-scale B3 a-trous decompose (vertical pass,
// then horizontal; HF_s = cur - low), then per scale from the coarsest,
// per channel, the anisotropic PDE step
//   q       = (HF * (1 / (max(LF - 1e-8, 0) + 1e-8)))^2
//   energy  = max(vt + box9(q) * norm_reg_s - 1e-8, 0) + 1e-8
//   deriv_k = the isotropic Laplacian, or 0.5 a12 D + a22 V + a11 H
//             - 2 (a11 + a22) c with c2 = exp(-mag * aniso_k) (modes 1, 2)
//   LF'     = max(HF * strength_s + (sum_k ABCD_sk deriv_k) / energy + LF, 0)
// with the 3x3 stencils dilated by 2^s.  Every sum and product follows the
// Pallas _kernel's operand order, and the library is built with
// --fmad=false, so kernel and plain twin (kernels/diffuse.py) round alike;
// rsqrtf and expf are those torch calls on the card.
//
// Boundary: like the Pallas kernel, the image is edge-extended once by the
// iteration's reach m = 3 (2^S - 1) and every stage runs on that padded
// frame.  Reads that leave the padded frame are clamped to it, and a fused
// tile computes its halo from such reads: that changes only values that no
// output pixel depends on (the output's cone of dependence stays inside
// the padded frame), so the cropped output equals the twin's.
//
// What bounds it on this card: the float32 work is about 315 operations
// per channel-pixel (0.64 ms at 67 TFLOP/s at 45 MP, S = 5) against 1.09
// GB of compulsory traffic; but an iteration cannot keep its 93-px halo
// of 3 channels x 6 planes in 227 KB of shared memory, so it streams
// padded frames (581 MB each at 45 MP) through device memory between
// launches, and each launch's tile recomputes part of its halo.
//
// Design: the wrapper hands over a launch plan (kernels/diffuse.
// launch_plan) of decompose groups, fine to coarse, then PDE groups,
// coarse to fine; each launch is one block of 32 x 8 threads per 32 x 64
// tile and channel.  A block stages its inputs with asynchronous copies
// (cp.async, all in flight before it waits), then reads every stencil
// from shared memory.  Each group is a template, so dilations, region
// widths and buffer offsets are constants.
//   decompose group: stages the tile of the group's input plus the summed
//     reach of its scales (2 x 2^s each), then per scale runs the vertical
//     B3 pass into shared memory and the horizontal one into the next
//     scale's input; writes HF_s of the tile and the group's last low.
//     No intermediate frame: 3 frame passes per scale, and the fine
//     scales 0-2 (reach 14 px) share one launch: x read once, HF_0..HF_2
//     and low_2 written.
//   PDE group: stages the group's LF input and each HF_s with the halo the
//     rest of the group needs (2^(s+1) - 2^lo for scales s .. lo), then
//     per scale, coarse to fine on a shrinking tile, takes q once per
//     position (not once per tap) and the step per pixel; the coarse
//     scales (d = 8, 16) run alone, the fine ones (reach 7 px) together,
//     and the group that ends at scale 0 writes the cropped output.  When
//     all four modes are isotropic (config 3) a specialisation drops the
//     anisotropic branches.
// At S = 5 that is 6 launches (was 15) and about 22 frame passes (11 in
// the decompose, 11 in the PDE; was 45), ~12.8 GB per iteration.  Shared
// memory per block: 62 KB for the fine decompose, 37 and 66 KB for the
// coarse ones (d = 8, 16), 73 KB for the fine PDE, 46 and 74 KB for the
// coarse ones.  Scratch: two LF frames and S HF frames.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int BX = 32;  // threads of a block: BX x BY
constexpr int BY = 8;
constexpr int TH = 32;  // output tile of every launch, rows x columns
constexpr int TW = 64;
constexpr int MAX_SCALES = 5;
constexpr int MAX_SMEM = 232448;  // the most a block may have on sm_90
constexpr float FLT_MIN_ = 1e-8f;

struct Modes {
  int m[4];
};

// a (3, sh, sw) stack read at coordinates of the padded frame: value at
// (y, x) is plane[clamp(y - off), clamp(x - off)]
struct Src {
  const float* p;
  int sh, sw, off;
};

__device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// rows x cols of channel c from (y, x) on into dst, row-major, as
// asynchronous copies (cp.async): every copy of the tile is in flight
// before any thread waits (stage_wait), which a load-then-store loop at
// this occupancy cannot reach
__device__ __forceinline__ void stage(float* dst, const Src& s, int c, int y,
                                      int x, int rows, int cols) {
  const float* plane = s.p + (size_t)c * s.sh * s.sw;
  for (int i = threadIdx.y; i < rows; i += BY) {
    const float* row = plane + (size_t)clampi(y + i - s.off, s.sh - 1) * s.sw;
    for (int j = threadIdx.x; j < cols; j += BX)
      __pipeline_memcpy_async(dst + i * cols + j,
                              row + clampi(x + j - s.off, s.sw - 1),
                              sizeof(float));
  }
  __pipeline_commit();
}

// every stage of this thread has landed, then every thread's
__device__ __forceinline__ void stage_wait() {
  __pipeline_wait_prior(0);
  __syncthreads();
}

// jnp.maximum(a, 0): NaN stays NaN (fmaxf would drop it), one
// instruction
__device__ __forceinline__ float max0(float a) {
  float r;
  asm("max.NaN.f32 %0, %1, 0f00000000;" : "=f"(r) : "f"(a));
  return r;
}

// the row i and column j of position idx of a region `cols` wide, by a
// float reciprocal: (idx + 0.5) / cols stays at least 0.5 / cols from an
// integer, far above the product's rounding while rows x cols < 2^20
__device__ __forceinline__ void split(int idx, int cols, float inv_cols,
                                      int& i, int& j) {
  i = (int)(((float)idx + 0.5f) * inv_cols);
  j = idx - i * cols;
}

__constant__ float B3[5] = {1.0f / 16.0f, 4.0f / 16.0f, 6.0f / 16.0f,
                            4.0f / 16.0f, 1.0f / 16.0f};

// Scales S0 .. S0 + NS - 1 of the decompose on one tile and channel: HF_s
// of the tile into hf (scale-major (S, 3, hp, wp)), the last low into low.
// Shared: a (the scale's input, halo hc), r (its vertical pass), b (its
// low, the next input); a and b swap after each scale.  The group is a
// template, so every dilation and region width is a constant.
template <int S0, int NS>
__global__ void __launch_bounds__(BX* BY)
    decompose(Src cur, float* __restrict__ hf, float* __restrict__ low,
              int hp, int wp) {
  extern __shared__ float smem[];
  constexpr int HALO = 2 * ((1 << (S0 + NS)) - (1 << S0));
  constexpr int HN0 = HALO - (2 << S0);
  const int tx = threadIdx.x, ty = threadIdx.y, c = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const size_t plane = (size_t)hp * wp;
  float* a = smem;
  float* r = a + (TH + 2 * HALO) * (TW + 2 * HALO);
  float* b = r + (TH + 2 * HN0) * (TW + 2 * HALO);
  stage(a, cur, c, y0 - HALO, x0 - HALO, TH + 2 * HALO, TW + 2 * HALO);
  stage_wait();
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const int d = 1 << (S0 + k);
    const int hc = 2 * ((1 << (S0 + NS)) - (1 << (S0 + k)));
    const int hn = hc - 2 * d;
    const int aw = TW + 2 * hc, rh = TH + 2 * hn, bw = TW + 2 * hn;
    // r(y, x) = sum_t B3[t] a(y + (t - 2) d, x), rows of the new region
    for (int i = ty; i < rh; i += BY)
      for (int j = tx; j < aw; j += BX) {
        const float* col = a + i * aw + j;
        float acc = B3[0] * col[0];
#pragma unroll
        for (int t = 1; t < 5; ++t) acc = acc + B3[t] * col[t * d * aw];
        r[i * aw + j] = acc;
      }
    __syncthreads();
    float* hf_s = hf + ((size_t)(S0 + k) * 3 + c) * plane;
    const bool last = k == NS - 1;
    for (int i = ty; i < rh; i += BY)
      for (int j = tx; j < bw; j += BX) {
        const float* row = r + i * aw + j;
        float acc = B3[0] * row[0];
#pragma unroll
        for (int t = 1; t < 5; ++t) acc = acc + B3[t] * row[t * d];
        if (!last) b[i * bw + j] = acc;
        const int gy = y0 - hn + i, gx = x0 - hn + j;
        if (i >= hn && i < hn + TH && j >= hn && j < hn + TW && gy < hp &&
            gx < wp) {
          const size_t o = (size_t)gy * wp + gx;
          hf_s[o] = a[(i + 2 * d) * aw + j + 2 * d] - acc;
          if (last) low[c * plane + o] = acc;
        }
      }
    __syncthreads();
    float* t = a;
    a = b;
    b = t;
  }
}

// the stencil pieces of one plane's 3x3 neighbourhood v[row][col]
// (_conv_pieces): iso, and for the general form V, H, D and the gradient
struct Pieces {
  float iso, V, H, D, gx, gy;
};

__device__ __forceinline__ Pieces pieces(const float v[3][3], int mode_a,
                                         int mode_b, bool need_dir) {
  Pieces o = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  const bool all_iso = mode_a == 0 && mode_b == 0;
  if (all_iso && !need_dir) {
    float rowp[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) rowp[i] = 0.5f * (v[i][0] + v[i][2]) + v[i][1];
    o.iso = 0.5f * (rowp[0] + rowp[2]) + rowp[1] - 4.0f * v[1][1];
    return o;
  }
  const float l = v[1][0], r = v[1][2], u = v[0][1], dn = v[2][1];
  o.V = u + dn;
  o.H = l + r;
  o.D = (v[0][0] - v[0][2]) - (v[2][0] - v[2][2]);
  if (need_dir) {
    o.gx = (dn - u) * 0.5f;
    o.gy = (r - l) * 0.5f;
  }
  if (mode_a == 0 || mode_b == 0) {
    const float h0 = v[0][0] + v[0][2], h2 = v[2][0] + v[2][2];
    o.iso = 0.25f * (h0 + h2) + 0.5f * (o.V + o.H) - 3.0f * v[1][1];
  }
  return o;
}

struct Dir {
  float c_sq, s_sq, cs, mag;
};

// ops/diffuse._direction
__device__ __forceinline__ Dir direction(float gx, float gy) {
  const float m2 = gx * gx + gy * gy;
  const float zero = m2 != 0.0f ? 0.0f : 1.0f;
  const float inv = rsqrtf(m2 + zero);
  const float cx = gx * inv + zero;
  const float sy = gy * inv;
  return {cx * cx, sy * sy, cx * sy, m2 * inv};
}

// the energy's operand at one position: (HF / (max(LF - 1e-8, 0) + 1e-8))^2
__device__ __forceinline__ float qval(float lv, float hv) {
  const float t = hv * (1.0f / (max0(lv - FLT_MIN_) + FLT_MIN_));
  return t * t;
}

// one scale's coefficients (see diffuse_iteration's consts)
struct Coef {
  float vt, norm_reg, strength, abcd[4];
};

__device__ __forceinline__ Coef coef(const float* __restrict__ consts, int s,
                                     int scales) {
  Coef k = {consts[0], consts[5 + s], consts[5 + scales + s], {}};
#pragma unroll
  for (int i = 0; i < 4; ++i) k.abcd[i] = consts[5 + 2 * scales + 4 * s + i];
  return k;
}

// one PDE step of one pixel from the 3x3 dilated neighbourhoods of LF (l),
// HF (h) and q; ISO: all four modes isotropic (the branches fold away)
template <bool ISO>
__device__ __forceinline__ float pde_px(const float l[3][3],
                                        const float h[3][3],
                                        const float q[3][3], const Coef& k,
                                        const float* __restrict__ aniso,
                                        const Modes& md) {
  int mode[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) mode[i] = ISO ? 0 : md.m[i];

  // energy: q box-summed rows first (_box9)
  float rowq[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) rowq[i] = q[i][0] + q[i][1] + q[i][2];
  const float box = rowq[0] + rowq[1] + rowq[2];
  const float energy = max0(k.vt + box * k.norm_reg - FLT_MIN_) + FLT_MIN_;
  const float inv_energy = 1.0f / energy;

  const bool need_g = mode[0] != 0 || mode[2] != 0;
  const bool need_l = mode[1] != 0 || mode[3] != 0;
  const Pieces p_lf = pieces(l, mode[0], mode[1], need_g);
  const Pieces p_hf = pieces(h, mode[2], mode[3], need_l);
  Dir dg = {0.0f, 0.0f, 0.0f, 0.0f}, dl = dg;
  if (need_g) dg = direction(p_lf.gx, p_lf.gy);
  if (need_l) dl = direction(p_hf.gx, p_hf.gy);

  float update = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const Pieces& src = i < 2 ? p_lf : p_hf;
    const float cc = i < 2 ? l[1][1] : h[1][1];
    float deriv;
    if (mode[i] == 0) {
      deriv = src.iso;
    } else {
      const Dir& dr = (i % 2 == 0) ? dg : dl;
      const float c2 = expf(-dr.mag * aniso[i]);
      float a11, a22, a12;
      if (mode[i] == 1) {  // ISO_ISOPHOTE
        a11 = dr.c_sq + c2 * dr.s_sq;
        a22 = c2 * dr.c_sq + dr.s_sq;
        a12 = (c2 - 1.0f) * dr.cs;
      } else {             // ISO_GRADIENT
        a11 = c2 * dr.c_sq + dr.s_sq;
        a22 = dr.c_sq + c2 * dr.s_sq;
        a12 = (1.0f - c2) * dr.cs;
      }
      deriv = 0.5f * a12 * src.D + a22 * src.V + a11 * src.H -
              2.0f * (a11 + a22) * cc;
    }
    const float contrib = k.abcd[i] * deriv;
    update = i == 0 ? contrib : update + contrib;
  }
  const float acc = h[1][1] * k.strength + update * inv_energy;
  return max0(acc + l[1][1]);
}

// PDE scales S_HI down to S_LO (lo = 2^S_LO) on one tile and channel of
// the output grid (oh x ow at offset ooff in the padded frame).  Shared: L
// (the group's LF input, halo 2^(S_HI+1) - lo), HF_s for each scale (halo
// 2^(s+1) - lo), L2, and Q.  Scale s first takes q once per position of
// its input region into Q (as the twin takes it once per pixel), then
// computes LF' on the tile plus 2^s - lo into L2, and L and L2 swap; scale
// S_LO writes out.  The group is a template, so every dilation, region
// width and buffer offset is a constant: the 27 shared reads of a pixel
// share one address register.
template <int S_HI, int S_LO, bool ISO>
__global__ void __launch_bounds__(BX* BY)
    pde_group(const float* __restrict__ lf, const float* __restrict__ hf,
              float* __restrict__ out, int hp, int wp, int oh, int ow,
              int ooff, int scales, const float* __restrict__ consts,
              Modes md) {
  extern __shared__ float smem[];
  constexpr int LO = 1 << S_LO;
  constexpr int E_TOP = (2 << S_HI) - LO, G_TOP = (1 << S_HI) - LO;
  const int tid = threadIdx.y * BX + threadIdx.x, c = blockIdx.z;
  const int oy0 = blockIdx.y * TH, ox0 = blockIdx.x * TW;
  const int y0 = oy0 + ooff, x0 = ox0 + ooff;
  const size_t plane = (size_t)hp * wp;
  float* L = smem;
  float* p = L + (TH + 2 * E_TOP) * (TW + 2 * E_TOP);
  float* hs = p;  // HF_s of the scale at hand; the scales follow in order
  stage(L, Src{lf, hp, wp, 0}, c, y0 - E_TOP, x0 - E_TOP, TH + 2 * E_TOP,
        TW + 2 * E_TOP);
#pragma unroll
  for (int s = S_HI; s >= S_LO; --s) {
    const int e = (2 << s) - LO;
    stage(p, Src{hf + (size_t)s * 3 * plane, hp, wp, 0}, c, y0 - e, x0 - e,
          TH + 2 * e, TW + 2 * e);
    p += (TH + 2 * e) * (TW + 2 * e);
  }
  float* L2 = p;
  float* Q = L2 + (S_HI > S_LO ? (TH + 2 * G_TOP) * (TW + 2 * G_TOP) : 0);
  stage_wait();
#pragma unroll
  for (int s = S_HI; s >= S_LO; --s) {
    const int d = 1 << s, e = (2 << s) - LO, g = d - LO;
    const int iw = TW + 2 * e, n_in = (TH + 2 * e) * iw;
    const int rw = TW + 2 * g, n_out = (TH + 2 * g) * rw;
    const Coef k = coef(consts, s, scales);
    for (int i = tid; i < n_in; i += BX * BY) Q[i] = qval(L[i], hs[i]);
    __syncthreads();
    const float inv_rw = 1.0f / (float)rw;
    for (int o = tid; o < n_out; o += BX * BY) {
      int i, j;
      split(o, rw, inv_rw, i, j);
      const int at = i * iw + j;
      float l[3][3], h[3][3], q[3][3];
#pragma unroll
      for (int u = 0; u < 3; ++u)
#pragma unroll
        for (int v = 0; v < 3; ++v) {
          l[u][v] = L[at + u * d * iw + v * d];
          h[u][v] = hs[at + u * d * iw + v * d];
          q[u][v] = Q[at + u * d * iw + v * d];
        }
      const float val = pde_px<ISO>(l, h, q, k, consts + 1, md);
      if (s > S_LO) {
        L2[o] = val;
      } else {
        const int oy = oy0 + i, ox = ox0 + j;
        if (oy < oh && ox < ow)
          out[(size_t)c * oh * ow + (size_t)oy * ow + ox] = val;
      }
    }
    __syncthreads();
    float* t = L;
    L = L2;
    L2 = t;
    hs += n_in;
  }
}

int decompose_smem(int s0, int ns) {
  const int halo = 2 * ((1 << (s0 + ns)) - (1 << s0));
  const int hn = halo - (2 << s0);
  const int aw = TW + 2 * halo;
  int n = (TH + 2 * halo) * aw + (TH + 2 * hn) * aw;
  if (ns > 1) n += (TH + 2 * hn) * (TW + 2 * hn);
  return n * (int)sizeof(float);
}

int pde_smem(int s_hi, int s_lo) {
  const int lo = 1 << s_lo;
  const int e_top = (2 << s_hi) - lo, g_top = (1 << s_hi) - lo;
  int n = (TH + 2 * e_top) * (TW + 2 * e_top);
  for (int s = s_hi; s >= s_lo; --s) {
    const int e = (2 << s) - lo;
    n += (TH + 2 * e) * (TW + 2 * e);
  }
  if (s_hi > s_lo) n += (TH + 2 * g_top) * (TW + 2 * g_top);
  n += (TH + 2 * e_top) * (TW + 2 * e_top);  // Q
  return n * (int)sizeof(float);
}

typedef void (*DecomposeFn)(Src, float*, float*, int, int);
typedef void (*PdeFn)(const float*, const float*, float*, int, int, int, int,
                      int, int, const float*, Modes);

// the groups kernels/diffuse.launch_plan makes for S = 1 .. 5; any other
// is refused
DecomposeFn decompose_fn(int s0, int ns) {
  switch (s0 * 8 + ns) {
    case 0 * 8 + 1: return decompose<0, 1>;
    case 0 * 8 + 2: return decompose<0, 2>;
    case 0 * 8 + 3: return decompose<0, 3>;
    case 3 * 8 + 1: return decompose<3, 1>;
    case 4 * 8 + 1: return decompose<4, 1>;
  }
  return nullptr;
}

template <bool ISO>
PdeFn pde_fn(int s_hi, int s_lo) {
  switch (s_hi * 8 + s_lo) {
    case 0 * 8 + 0: return pde_group<0, 0, ISO>;
    case 1 * 8 + 0: return pde_group<1, 0, ISO>;
    case 2 * 8 + 0: return pde_group<2, 0, ISO>;
    case 3 * 8 + 3: return pde_group<3, 3, ISO>;
    case 4 * 8 + 4: return pde_group<4, 4, ISO>;
  }
  return nullptr;
}

cudaError_t allow_smem(const void* kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace

extern "C" {

void diffuse_limits(int* tile_h, int* tile_w, int* max_smem) {
  *tile_h = TH;
  *tile_w = TW;
  *max_smem = MAX_SMEM;
}

// x, out: (3, h, w) float32 on the device; lf: (2, 3, hp, wp) and hf:
// (scales, 3, hp, wp) scratch with hp = h + 2m, wp = w + 2m and m = 3
// (2^scales - 1); consts: 5 + 6 scales float32 on the device (see
// kernels/diffuse.pack_consts); modes: the four isotropy modes; plan:
// n_launch rows of (kind, first scale, scale count, shared bytes), kind 0
// a decompose group (scales first .. first + count - 1), kind 1 a PDE
// group (scales first down to first - count + 1), both in host memory.
// The decompose groups must cover the scales from 0 up, then the PDE
// groups from scales - 1 down to 0, each with the shared bytes its tile
// needs.  Launches on `stream`, returns the first error.
int diffuse_iteration(const float* x, float* out, float* lf, float* hf,
                      const float* consts, const int* modes, const int* plan,
                      int n_launch, int h, int w, int scales, int m,
                      void* stream) {
  if (scales < 1 || scales > MAX_SCALES || m != 3 * ((1 << scales) - 1) ||
      h < 1 || w < 1 || n_launch < 2)
    return (int)cudaErrorInvalidValue;
  Modes md;
  for (int k = 0; k < 4; ++k) {
    if (modes[k] < 0 || modes[k] > 2) return (int)cudaErrorInvalidValue;
    md.m[k] = modes[k];
  }
  // check the whole plan before the first launch
  int next_dec = 0, next_pde = scales - 1;
  for (int i = 0; i < n_launch; ++i) {
    const int* row = plan + 4 * i;
    const int kind = row[0], s = row[1], n = row[2], bytes = row[3];
    if (n < 1 || bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
    if (kind == 0) {
      if (s != next_dec || s + n > scales || !decompose_fn(s, n) ||
          bytes != decompose_smem(s, n))
        return (int)cudaErrorInvalidValue;
      next_dec += n;
    } else if (kind == 1) {
      if (next_dec != scales || s != next_pde || s - n + 1 < 0 ||
          !pde_fn<true>(s, s - n + 1) || bytes != pde_smem(s, s - n + 1))
        return (int)cudaErrorInvalidValue;
      next_pde -= n;
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  if (next_dec != scales || next_pde != -1) return (int)cudaErrorInvalidValue;

  cudaStream_t st = (cudaStream_t)stream;
  const int hp = h + 2 * m, wp = w + 2 * m;
  const size_t frame = (size_t)3 * hp * wp;
  const dim3 block(BX, BY);
  const dim3 grid_p((wp + TW - 1) / TW, (hp + TH - 1) / TH, 3);
  const dim3 grid_o((w + TW - 1) / TW, (h + TH - 1) / TH, 3);
  const bool iso = md.m[0] == 0 && md.m[1] == 0 && md.m[2] == 0 &&
                   md.m[3] == 0;
  int cur = 1;  // the lf frame that holds the latest low or LF
  cudaError_t err;
  for (int i = 0; i < n_launch; ++i) {
    const int kind = plan[4 * i], s = plan[4 * i + 1], n = plan[4 * i + 2];
    const int bytes = plan[4 * i + 3];
    float* dst = lf + (1 - cur) * frame;
    if (kind == 0) {
      const Src src = s == 0 ? Src{x, h, w, m} : Src{lf + cur * frame, hp, wp, 0};
      const DecomposeFn fn = decompose_fn(s, n);
      if ((err = allow_smem((const void*)fn, bytes)) != cudaSuccess)
        return (int)err;
      fn<<<grid_p, block, bytes, st>>>(src, hf, dst, hp, wp);
      cur = 1 - cur;
    } else {
      const int s_lo = s - n + 1;
      const PdeFn fn = iso ? pde_fn<true>(s, s_lo) : pde_fn<false>(s, s_lo);
      if ((err = allow_smem((const void*)fn, bytes)) != cudaSuccess)
        return (int)err;
      if (s_lo > 0) {
        fn<<<grid_p, block, bytes, st>>>(lf + cur * frame, hf, dst, hp, wp, hp,
                                         wp, 0, scales, consts, md);
        cur = 1 - cur;
      } else {
        fn<<<grid_o, block, bytes, st>>>(lf + cur * frame, hf, out, hp, wp, h,
                                         w, m, scales, consts, md);
      }
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
