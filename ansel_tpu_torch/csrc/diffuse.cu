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
// frame; reads that leave the padded frame are clamped to it, which only
// changes values that no output pixel depends on.
//
// What bounds it: at 45 MP (S = 5, isotropic) the float32 work, about 315
// operations per channel-pixel (0.64 ms at 67 TFLOP/s), against 1.09 GB of
// compulsory traffic (0.33 ms at 3.35 TB/s).  The Pallas kernel keeps a
// whole iteration of a tile in VMEM; here the 93-px halo around a tile,
// with 3 channels x 6 planes, does not fit in 227 KB of shared memory.
//
// Design: a sequence of full-frame passes over padded scratch planes that
// the wrapper allocates: per scale a vertical blur pass (x -> tmp) and a
// horizontal pass that writes LF and HF; then per scale, coarse to fine, a
// PDE pass, the last of which writes the cropped output.  One thread per
// pixel and channel, stencil reads through the L1/L2 caches.  Each pass
// reads and writes whole 3-plane frames: about 45 frame passes (26 GB) per
// iteration at S = 5, many times the bound.  Fusing the passes is later
// work.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int BX = 32;
constexpr int BY = 8;
constexpr int MAX_SCALES = 5;
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

__device__ __forceinline__ float at(const Src& s, int c, int y, int x) {
  const size_t plane = (size_t)s.sh * s.sw;
  return __ldg(s.p + c * plane + (size_t)clampi(y - s.off, s.sh - 1) * s.sw +
               clampi(x - s.off, s.sw - 1));
}

// jnp.maximum: NaN in either operand gives NaN (fmaxf would drop it)
__device__ __forceinline__ float jmax(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

__constant__ float B3[5] = {1.0f / 16.0f, 4.0f / 16.0f, 6.0f / 16.0f,
                            4.0f / 16.0f, 1.0f / 16.0f};

// tmp = vertical B3 pass of cur at spacing d, over the padded frame
__global__ void blur_v(Src cur, float* __restrict__ tmp, int hp, int wp,
                       int d) {
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  const int c = blockIdx.z;
  if (x >= wp || y >= hp) return;
  float acc = B3[0] * at(cur, c, y - 2 * d, x);
#pragma unroll
  for (int k = 1; k < 5; ++k) acc = acc + B3[k] * at(cur, c, y + (k - 2) * d, x);
  tmp[(size_t)c * hp * wp + (size_t)y * wp + x] = acc;
}

// low = horizontal B3 pass of tmp at spacing d; hf = cur - low
__global__ void blur_h(const float* __restrict__ tmp, Src cur,
                       float* __restrict__ low, float* __restrict__ hf, int hp,
                       int wp, int d) {
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  const int c = blockIdx.z;
  if (x >= wp || y >= hp) return;
  const Src t = {tmp, hp, wp, 0};
  float acc = B3[0] * at(t, c, y, x - 2 * d);
#pragma unroll
  for (int k = 1; k < 5; ++k) acc = acc + B3[k] * at(t, c, y, x + (k - 2) * d);
  const size_t o = (size_t)c * hp * wp + (size_t)y * wp + x;
  low[o] = acc;
  hf[o] = at(cur, c, y, x) - acc;
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

// one PDE step at scale s (spacing d) on the output grid oh x ow, which
// sits at offset ooff in the padded frame; lf and hf are padded frames
__global__ void pde(const float* __restrict__ lf, const float* __restrict__ hf,
                    float* __restrict__ out, int hp, int wp, int oh, int ow,
                    int ooff, int d, int s, int scales,
                    const float* __restrict__ consts, Modes md) {
  const int ox = blockIdx.x * BX + threadIdx.x;
  const int oy = blockIdx.y * BY + threadIdx.y;
  const int c = blockIdx.z;
  if (ox >= ow || oy >= oh) return;
  const int y = oy + ooff, x = ox + ooff;
  const Src L = {lf, hp, wp, 0}, Hs = {hf, hp, wp, 0};
  float l[3][3], h[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      l[i][j] = at(L, c, y + (i - 1) * d, x + (j - 1) * d);
      h[i][j] = at(Hs, c, y + (i - 1) * d, x + (j - 1) * d);
    }
  }
  // consts: [vt, aniso(4), norm_reg(S), strength(S), ABCD(S x 4)]
  const float vt = consts[0];
  const float norm_reg = consts[5 + s];
  const float strength = consts[5 + scales + s];
  const float* abcd = consts + 5 + 2 * scales + 4 * s;

  // energy: q once per tap, box-summed rows first (_box9)
  float rowq[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float q[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float t = h[i][j] * (1.0f / (jmax(l[i][j] - FLT_MIN_, 0.0f) + FLT_MIN_));
      q[j] = t * t;
    }
    rowq[i] = q[0] + q[1] + q[2];
  }
  const float box = rowq[0] + rowq[1] + rowq[2];
  const float energy = jmax(vt + box * norm_reg - FLT_MIN_, 0.0f) + FLT_MIN_;
  const float inv_energy = 1.0f / energy;

  const bool need_g = md.m[0] != 0 || md.m[2] != 0;
  const bool need_l = md.m[1] != 0 || md.m[3] != 0;
  const Pieces p_lf = pieces(l, md.m[0], md.m[1], need_g);
  const Pieces p_hf = pieces(h, md.m[2], md.m[3], need_l);
  Dir dg = {0.0f, 0.0f, 0.0f, 0.0f}, dl = dg;
  if (need_g) dg = direction(p_lf.gx, p_lf.gy);
  if (need_l) dl = direction(p_hf.gx, p_hf.gy);

  float update = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const Pieces& src = k < 2 ? p_lf : p_hf;
    const float cc = k < 2 ? l[1][1] : h[1][1];
    float deriv;
    if (md.m[k] == 0) {
      deriv = src.iso;
    } else {
      const Dir& dr = (k % 2 == 0) ? dg : dl;
      const float c2 = expf(-dr.mag * consts[1 + k]);
      float a11, a22, a12;
      if (md.m[k] == 1) {  // ISO_ISOPHOTE
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
    const float contrib = abcd[k] * deriv;
    update = k == 0 ? contrib : update + contrib;
  }
  const float acc = h[1][1] * strength + update * inv_energy;
  out[(size_t)c * oh * ow + (size_t)oy * ow + ox] = jmax(acc + l[1][1], 0.0f);
}

}  // namespace

extern "C" {

// x, out: (3, h, w) float32 on the device; tmp: (3, hp, wp), lf: (2, 3, hp,
// wp), hf: (scales, 3, hp, wp) scratch with hp = h + 2m, wp = w + 2m and
// m = 3 (2^scales - 1); consts: 5 + 6 scales float32 on the device (see
// kernels/diffuse.pack_consts); modes: the four isotropy modes in host
// memory.  Launches on `stream`, returns the first launch error.
int diffuse_iteration(const float* x, float* out, float* tmp, float* lf,
                      float* hf, const float* consts, const int* modes, int h,
                      int w, int scales, int m, void* stream) {
  if (scales < 1 || scales > MAX_SCALES || m != 3 * ((1 << scales) - 1) ||
      h < 1 || w < 1)
    return (int)cudaErrorInvalidValue;
  Modes md;
  for (int k = 0; k < 4; ++k) {
    if (modes[k] < 0 || modes[k] > 2) return (int)cudaErrorInvalidValue;
    md.m[k] = modes[k];
  }
  cudaStream_t st = (cudaStream_t)stream;
  const int hp = h + 2 * m, wp = w + 2 * m;
  const size_t frame = (size_t)3 * hp * wp;
  const dim3 block(BX, BY);
  const dim3 grid_p((wp + BX - 1) / BX, (hp + BY - 1) / BY, 3);
  cudaError_t err;

  // decompose: low_s into lf[s % 2], HF_s into hf[s]
  for (int s = 0; s < scales; ++s) {
    const int d = 1 << s;
    const Src cur = s == 0 ? Src{x, h, w, m}
                           : Src{lf + ((s - 1) % 2) * frame, hp, wp, 0};
    blur_v<<<grid_p, block, 0, st>>>(cur, tmp, hp, wp, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    blur_h<<<grid_p, block, 0, st>>>(tmp, cur, lf + (s % 2) * frame,
                                     hf + s * frame, hp, wp, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  // coarse to fine; the finest step writes the cropped output
  int in = (scales - 1) % 2;
  for (int s = scales - 1; s >= 0; --s) {
    const int d = 1 << s;
    if (s > 0) {
      pde<<<grid_p, block, 0, st>>>(lf + in * frame, hf + s * frame,
                                    lf + (1 - in) * frame, hp, wp, hp, wp, 0,
                                    d, s, scales, consts, md);
      in = 1 - in;
    } else {
      const dim3 grid_o((w + BX - 1) / BX, (h + BY - 1) / BY, 3);
      pde<<<grid_o, block, 0, st>>>(lf + in * frame, hf, out, hp, wp, h, w,
                                    m, d, s, scales, consts, md);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
