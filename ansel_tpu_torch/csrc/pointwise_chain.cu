// Fused per-pixel colour chain for Hopper (sm_90a).
//
// Replaces: ansel_tpu/kernels/pointwise.py:pallas_pointwise as the engine
// uses it (ansel_tpu/pipeline/engine.py:509-565): one pass over a
// (3, H, W) float32 image that runs every stage of a fused group.  The
// Pallas kernel takes an arbitrary traced Python function; here each
// stage body is written out once below and the group is a small program:
// per stage an opcode, an offset into a float32 consts buffer and up to
// eight static ints (kernels/pointwise.py packs it).  A stage that reads
// pixel positions (the Pallas kernel's with_pos: vignette, graduatednd)
// gets the pixel's row and column in the array, derived from the flat
// index and the array's width; the Pallas-safe atan_pos and atan2_full
// (ansel_tpu/kernels/pointwise.py:72,92) are device functions here.
//
// What bounds it: instruction issue.  3 planes are read and 3 written,
// 577 MB at 24 MP (0.17 ms at 3.35 TB/s), but config 1's AgX chain needs
// over a thousand float32 instructions per pixel (scripts/chain_count.py
// counts them; each multiply and add issues alone under --fmad=false).
//
// Design: the programs the configs build each have a kernel of their own
// (chain_fixed, below: no dispatch, consts as constant-bank operands);
// any other program runs the interpreter (chain): one
// thread per pixel in a grid-stride loop, the program and consts copied
// to shared memory at block start and a `switch` per stage, which never
// diverges inside a warp since every thread runs the same program.  In
// both a pixel's r, g, b stay in registers through the whole program and
// are stored once.
//
// Numbers: each body keeps the operand order of the JAX reference
// (ansel_tpu/ops/*.py), constants the reference writes as Python floats
// are rounded to float32 from their float64 value (K), and the library is
// built with --fmad=false.  jnp.maximum/minimum/clip propagate NaN where
// fmaxf/fminf drop it, so jmax/jmin below propagate it too.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

#include <tuple>
#include <utility>

namespace {

// opcodes and record layout: keep in step with kernels/pointwise.py
enum Opcode {
  OP_EXPOSURE = 1,
  OP_MATRIX = 2,
  OP_CHANNELMIXERRGB = 3,
  OP_FILMIC_AGX = 4,
  OP_COLOROUT = 5,
  OP_CONVERT_WORK_LAB = 6,
  OP_CONVERT_LAB_WORK = 7,
  OP_COLORBALANCERGB = 8,
  OP_RGBCURVE = 9,
  OP_RGBLEVELS = 10,
  OP_BASECURVE = 11,
  OP_TONECURVE = 12,
  OP_LEVELS = 13,
  OP_BASICADJ = 14,
  OP_COLORZONES = 15,
  OP_NEGADOCTOR = 16,
  OP_VIGNETTE = 17,
  OP_GRADUATEDND = 18,
  OP_VELVIA = 19,
  OP_VIBRANCE = 20,
  OP_COLORCONTRAST = 21,
  OP_COLORCORRECTION = 22,
  OP_COLISA = 23,
  OP_SPLITTONING = 24,
  OP_COLORIZE = 25,
  OP_COLORBALANCE = 26,
  OP_SPLITTONINGRGB = 27,
  OP_LOWLIGHT = 28,
  OP_PROFILE_GAMMA = 29,
  OP_COLORCHECKER = 30,
};
enum Trc { TRC_SRGB = 0, TRC_LINEAR = 1, TRC_GAMMA = 2 };
constexpr int MAX_STAGES = 16;
constexpr int STAGE_INTS = 8;
constexpr int RECORD = 2 + STAGE_INTS;  // opcode, const offset, static ints
constexpr int MAX_CONSTS = 1024;
constexpr int THREADS = 256;

#define K(v) ((float)(v))  // a Python float constant, rounded to float32

constexpr float NORM_MIN = 1.52587890625e-05f;
constexpr double YRG_RW = 0.21902143;
constexpr double YRG_GW = 0.54371398;
constexpr double CIE_Y_2006 = 1.05785528;
constexpr double PI = 3.141592653589793;     // math.pi
constexpr double SQRT2 = 1.4142135623730951;  // math.sqrt(2.0)

// NaN if either is NaN (max.NaN.f32, one instruction), else fmaxf/fminf;
// the host form is what the gcov build of scripts/chain_count.py runs
__device__ __forceinline__ float jmax(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return (a != a || b != b) ? a + b : fmaxf(a, b);
#endif
}
__device__ __forceinline__ float jmin(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return (a != a || b != b) ? a + b : fminf(a, b);
#endif
}
__device__ __forceinline__ float jclip(float x, float lo, float hi) {
  return jmin(jmax(x, lo), hi);
}
__device__ __forceinline__ float max3(const float* v) { return jmax(jmax(v[0], v[1]), v[2]); }
__device__ __forceinline__ float min3(const float* v) { return jmin(jmin(v[0], v[1]), v[2]); }

// (m0*x0 + m1*x1) + m2*x2 per row of a row-major 3x3
__device__ __forceinline__ void mat3(const float* M, const float* in, float* out) {
  float a = in[0], b = in[1], c = in[2];
  out[0] = M[0] * a + M[1] * b + M[2] * c;
  out[1] = M[3] * a + M[4] * b + M[5] * c;
  out[2] = M[6] * a + M[7] * b + M[8] * c;
}

// ---------------------------------------------------------------- exposure
__device__ __forceinline__ void exposure(float* v, const float* k) {
  for (int i = 0; i < 3; ++i) v[i] = (v[i] - k[0]) * k[1];
}

// ------------------------------------------------------- channelmixerrgb
// consts: MIX 0, saturation 9, lightness 12, grey 15, illum_lms 18,
// white_lms 21, cone 24, cone_inv 33, xyz_from_work 42, work_from_xyz 51,
// gamut 60, p_exp 61, uv_white 62, pipeline white XYZ 64
// ints: kind, version, clip, apply_grey, has_lumachroma, gamut_pow1, gamut_off
enum { ADAPT_LINEAR_BRADFORD = 0, ADAPT_CAT16 = 1, ADAPT_FULL_BRADFORD = 2, ADAPT_XYZ = 3 };
enum { CMX_V1 = 0, CMX_V3 = 2 };

__device__ void cmx_gamut(float* xyz, const float* k, bool clip, bool pow1) {
  float s = xyz[0] + xyz[1] + xyz[2];
  float Y = xyz[1];
  bool valid = (s > 0.0f) && (Y > 0.0f);
  float safe_s = valid ? s : 1.0f;
  float xx = xyz[0] / safe_s;
  float yy = valid ? xyz[1] / safe_s : 1.0f;
  float den = -2.0f * xx + 12.0f * yy + 3.0f;
  float u = 4.0f * xx / den;
  float v = 9.0f * yy / den;
  float uw = k[62], vw = k[63];
  float du = uw - u, dv = vw - v;
  float delta = Y * (du * du + dv * dv);
  float corr;
  if (pow1) {
    corr = delta;
  } else {
    float g = k[60];
    corr = g == 0.0f ? 0.0f : powf(jmax(delta, K(1e-12)), g);
  }
  float tu = corr * du + u;
  float tv = corr * dv + v;
  u = u > uw ? jmax(tu, uw) : jmin(tu, uw);
  v = v > vw ? jmax(tv, vw) : jmin(tv, vw);
  float xy_den = 6.0f * u - 16.0f * v + 12.0f;
  xx = 9.0f * u / xy_den;
  yy = 4.0f * v / xy_den;
  if (clip) {
    xx = jmax(xx, 0.0f);
    yy = jmax(yy, 0.0f);
  }
  yy = jmax(yy, NORM_MIN);
  float scale = xx + yy;
  if (scale >= 1.0f) {
    xx = xx / scale;
    yy = yy / scale;
  }
  if (valid) {
    xyz[0] = Y * xx / yy;
    xyz[1] = Y;
    xyz[2] = Y * (1.0f - xx - yy) / yy;
  } else {
    xyz[0] = xyz[1] = xyz[2] = 0.0f;
  }
}

__device__ void cmx_luma_chroma(float* in, const float* k, int version) {
  const float sqrt3 = sqrtf(3.0f);
  float norm = sqrtf(in[0] * in[0] + in[1] * in[1] + in[2] * in[2]);
  float avg = jmax((in[0] + in[1] + in[2]) / 3.0f, NORM_MIN);
  bool valid = (norm > 0.0f) && (avg > 0.0f);
  const float* li = k + 12;
  const float* sa = k + 9;
  float mix = li[0] * in[0] + li[1] * in[1] + li[2] * in[2];
  float norm_r = version == CMX_V3 ? norm / sqrt3 : norm;
  float safe_norm = valid ? norm_r : 1.0f;
  float ratios[3];
  for (int i = 0; i < 3; ++i) ratios[i] = in[i] / safe_norm;
  float coeff;
  if (version == CMX_V1) {
    float t[3];
    for (int i = 0; i < 3; ++i) t[i] = (1.0f - ratios[i]) * (1.0f - ratios[i]) * sa[i];
    coeff = t[0] + t[1] + t[2];
  } else {
    coeff = (ratios[0] * sa[0] + ratios[1] * sa[1] + ratios[2] * sa[2]) / 3.0f;
  }
  float adj[3];
  for (int i = 0; i < 3; ++i)
    adj[i] = jmax((1.0f - ratios[i]) * coeff + ratios[i], jmin(ratios[i], 0.0f));
  if (version == CMX_V3)
    norm_r = norm_r / (sqrtf(adj[0] * adj[0] + adj[1] * adj[1] + adj[2] * adj[2]) / sqrt3);
  norm_r = norm_r * jmax(1.0f + mix / avg, 0.0f);
  if (valid)
    for (int i = 0; i < 3; ++i) in[i] = adj[i] * norm_r;
}

__device__ __forceinline__ void channelmixerrgb(float* v, const float* k, const int* a) {
  int kind = a[0], version = a[1];
  bool clip = a[2], apply_grey = a[3], lumachroma = a[4], pow1 = a[5], gamut_off = a[6];
  bool cone_kind = kind == ADAPT_LINEAR_BRADFORD || kind == ADAPT_CAT16 ||
                   kind == ADAPT_FULL_BRADFORD;
  const float *MIX = k, *il = k + 18, *wl = k + 21, *cone = k + 24, *cone_inv = k + 33;
  const float *xfw = k + 42, *wfx = k + 51;
  if (clip)
    for (int i = 0; i < 3; ++i) v[i] = jmax(v[i], 0.0f);
  float xyz[3], t[3];
  mat3(xfw, v, xyz);
  float Y = xyz[1] > NORM_MIN ? xyz[1] + NORM_MIN : NORM_MIN;
  if (cone_kind) {
    float lms[3];
    mat3(cone, xyz, lms);
    for (int i = 0; i < 3; ++i) t[i] = lms[i] / Y / il[i];
    if (kind == ADAPT_FULL_BRADFORD && t[2] > 0.0f) t[2] = powf(t[2], k[61]);
    for (int i = 0; i < 3; ++i) t[i] = t[i] * wl[i] * Y;
    float mixed[3];
    mat3(MIX, t, mixed);
    mat3(cone_inv, mixed, xyz);
  } else if (kind == ADAPT_XYZ) {
    for (int i = 0; i < 3; ++i) t[i] = xyz[i] * (k[64 + i] / jmax(il[i], K(1e-9)));
    mat3(MIX, t, xyz);
  } else {
    float mixed[3];
    mat3(MIX, v, mixed);
    mat3(xfw, mixed, xyz);
  }
  if (!gamut_off) cmx_gamut(xyz, k, clip, pow1);
  if (!lumachroma && !apply_grey) {
    mat3(wfx, xyz, v);
    if (clip)
      for (int i = 0; i < 3; ++i) v[i] = jmax(v[i], 0.0f);
    return;
  }
  float base[3];
  if (cone_kind) {
    mat3(cone, xyz, base);
  } else if (kind == ADAPT_XYZ) {
    for (int i = 0; i < 3; ++i) base[i] = xyz[i];
  } else {
    mat3(wfx, xyz, base);
  }
  if (clip)
    for (int i = 0; i < 3; ++i) base[i] = jmax(base[i], 0.0f);
  if (lumachroma) cmx_luma_chroma(base, k, version);
  if (clip)
    for (int i = 0; i < 3; ++i) base[i] = jmax(base[i], 0.0f);
  if (apply_grey) {
    const float* gr = k + 15;
    float g = jmax(gr[0] * base[0] + gr[1] * base[1] + gr[2] * base[2], 0.0f);
    v[0] = v[1] = v[2] = g;
    return;
  }
  if (cone_kind) {
    mat3(cone_inv, base, xyz);
  } else if (kind == ADAPT_XYZ) {
    for (int i = 0; i < 3; ++i) xyz[i] = base[i];
  } else {
    mat3(xfw, base, xyz);
  }
  if (clip)
    for (int i = 0; i < 3; ++i) xyz[i] = jmax(xyz[i], 0.0f);
  mat3(wfx, xyz, v);
  if (clip)
    for (int i = 0; i < 3; ++i) v[i] = jmax(v[i], 0.0f);
}

// ------------------------------------------------------------ filmic AgX
// consts: M1 0, M2 3, M3 6, M4 9, M5 12, lat_min 15, lat_max 16,
// grey_source 17, black_source 18, dynamic_range 19, output_power 20,
// y4 21, display_black 22, display_white 23, beta_hue 24, inset 25,
// outset 34, input_m 43, output_m 52, work Y row 61, gamut folds 64
// (S, -0.4275...*S per output_m row)
// ints: toe curve type, shoulder curve type
enum { CURVE_POLY_4 = 0, CURVE_POLY_3 = 1, CURVE_RATIONAL = 2, CURVE_SIGMOID = 3 };

__device__ float log_tonemapping(float x, const float* k) {
  float xx = jmax(x, NORM_MIN);
  return jclip((log2f(xx / k[17]) - k[18]) / k[19], 0.0f, 1.0f);
}

__device__ float spline_eval(float x, const float* k, int toe_type, int shoulder_type) {
  const float *M1 = k, *M2 = k + 3, *M3 = k + 6, *M4 = k + 9, *M5 = k + 12;
  float lat_min = k[15], lat_max = k[16];
  if (x < lat_min) {
    if (toe_type == CURVE_SIGMOID) {
      if (M5[0] != 0.0f) return M3[2] + jmax(0.0f, M3[0] * powf(jmax(x, 0.0f), M4[0]));
      float ty = lat_min * M2[2] + M1[2];
      float u = M2[2] * (x - lat_min) / M1[0];
      return M1[0] * (u / powf(1.0f + powf(u, M2[0]), 1.0f / M2[0])) + ty;
    }
    if (toe_type == CURVE_POLY_4)
      return M1[0] + x * (M2[0] + x * (M3[0] + x * (M4[0] + x * M5[0])));
    if (toe_type == CURVE_POLY_3) return M1[0] + x * (M2[0] + x * (M3[0] + x * M4[0]));
    float xi = lat_min - x;
    float rat = xi * (xi * M2[0] + 1.0f);
    return M4[0] - M1[0] * rat / (rat + M3[0]);
  }
  if (x > lat_max) {
    if (shoulder_type == CURVE_SIGMOID) {
      if (M5[1] != 0.0f) return M4[2] - jmax(0.0f, M3[1] * powf(jmax(1.0f - x, 0.0f), M4[1]));
      float ty = lat_max * M2[2] + M1[2];
      float u = M2[2] * (x - lat_max) / M1[1];
      return M1[1] * (u / powf(1.0f + powf(u, M2[1]), 1.0f / M2[1])) + ty;
    }
    if (shoulder_type == CURVE_POLY_4)
      return M1[1] + x * (M2[1] + x * (M3[1] + x * (M4[1] + x * M5[1])));
    if (shoulder_type == CURVE_POLY_3) return M1[1] + x * (M2[1] + x * (M3[1] + x * M4[1]));
    float xi = x - lat_max;
    float rat = xi * (xi * M2[1] + 1.0f);
    return M4[1] + M1[1] * rat / (rat + M3[1]);
  }
  return M1[2] + x * M2[2];
}

// jnp.nan_to_num: NaN -> 0, +-inf -> +-FLT_MAX
__device__ __forceinline__ float nan_to_num(float x) {
  if (x != x) return 0.0f;
  if (isinf(x)) return x > 0.0f ? FLT_MAX : -FLT_MAX;
  return x;
}

__device__ void compress_negatives(float* rgb, const float* wy) {
  auto dotY = [wy](const float* v) { return wy[0] * v[0] + wy[1] * v[1] + wy[2] * v[2]; };
  float input_y = dotY(rgb);
  float max_rgb = max3(rgb), min_rgb = min3(rgb);
  float opp[3];
  for (int i = 0; i < 3; ++i) opp[i] = max_rgb - rgb[i];
  float y_comp = max3(opp) - dotY(opp) + input_y;
  float offset = jmax(-min_rgb, 0.0f);
  float sh[3];
  for (int i = 0; i < 3; ++i) sh[i] = rgb[i] + offset;
  float max_sh = max3(sh);
  float opp_sh[3];
  for (int i = 0; i < 3; ++i) opp_sh[i] = max_sh - sh[i];
  float y_new = dotY(sh) + max3(opp_sh) - dotY(opp_sh);
  float ratio = (y_new > y_comp && y_new > K(1e-6)) ? y_comp / y_new : 1.0f;
  for (int i = 0; i < 3; ++i) rgb[i] = sh[i] * ratio;
}

// sp.lms_to_yrg -> Y, r, g
__device__ void lms_to_yrg(const float* lms, float* yrg) {
  yrg[0] = K(0.68990272) * lms[0] + K(0.34832189) * lms[1];
  float a = lms[0] + lms[1] + lms[2];
  float inv_a = a == 0.0f ? 0.0f : 1.0f / a;
  float n0 = lms[0] * inv_a, n1 = lms[1] * inv_a, n2 = lms[2] * inv_a;
  yrg[1] = K(1.0877193) * n0 + K(-0.66666667) * n1 + K(0.02061856) * n2;
  yrg[2] = K(-0.0877193) * n0 + K(1.66666667) * n1 + K(-0.05154639) * n2;
}

// Y, c, cos_h, sin_h of work RGB (pipe_RGB_to_Ych_simd)
__device__ void rgb_to_ych(const float* rgb, const float* input_m, float* ych) {
  float lms[3], yrg[3];
  mat3(input_m, rgb, lms);
  lms_to_yrg(lms, yrg);
  float r = yrg[1] - K(YRG_RW);
  float g = yrg[2] - K(YRG_GW);
  float c = sqrtf(r * r + g * g);
  ych[0] = yrg[0];
  ych[1] = c;
  ych[2] = c != 0.0f ? r / jmax(c, K(1e-20)) : 1.0f;
  ych[3] = c != 0.0f ? g / jmax(c, K(1e-20)) : 0.0f;
}

__device__ void ych_to_rgb(float Y, float c, float cos_h, float sin_h, const float* output_m,
                           float* rgb) {
  float r = c * cos_h + K(YRG_RW);
  float g = c * sin_h + K(YRG_GW);
  float b = 1.0f - r - g;
  float lms[3];
  lms[0] = K(0.95) * r + K(0.38) * g + K(0.00) * b;
  lms[1] = K(0.05) * r + K(0.62) * g + K(0.03) * b;
  lms[2] = K(0.00) * r + K(0.00) * g + K(0.97) * b;
  float denom = K(0.68990272) * lms[0] + K(0.34832189) * lms[1];
  float a = denom == 0.0f ? 0.0f : Y / denom;
  for (int i = 0; i < 3; ++i) lms[i] = lms[i] * a;
  mat3(output_m, lms, rgb);
}

__device__ __forceinline__ float den_chroma(const float* m, float cos_h, float sin_h) {
  return m[0] * (K(0.979381443298969) * cos_h + K(0.391752577319588) * sin_h) +
         m[1] * (K(0.0206185567010309) * cos_h + K(0.608247422680412) * sin_h) -
         m[2] * (cos_h + sin_h);
}

// clip_chroma_white (filmicrgb.c:1797-1838) for one output-matrix row m
__device__ float clip_chroma_white(const float* m, float s, float tw, float Y, float cos_h,
                                   float sin_h) {
  float den_y = den_chroma(m, cos_h, sin_h);
  float den_t = tw * (K(0.68285981628866) * cos_h + K(0.482137060515464) * sin_h);
  auto raw = [&](float Yv) {
    float denominator = Yv * den_y - den_t;
    float numerator = K(-0.427506877216495) * (Yv * s - K(0.988237752433297) * tw);
    float Y_asym = den_t / (den_y == 0.0f ? K(1e30) : den_y);
    float val = numerator / (fabsf(denominator) < K(1e-20) ? K(1e-20) : denominator);
    return (den_y == 0.0f || Yv <= Y_asym) ? INFINITY : val;
  };
  const float eps = K(1e-3);
  float max_Y = K(CIE_Y_2006) * tw;
  float delta_Y = jmax(max_Y - Y, 0.0f);
  float v = delta_Y < eps ? delta_Y / (eps * max_Y) * raw(K(1.0 - 1e-3) * max_Y) : raw(Y);
  return v >= 0.0f ? v : INFINITY;
}

__device__ float clip_chroma_black(const float* m, float num, float cos_h, float sin_h) {
  float den = den_chroma(m, cos_h, sin_h);
  float v = num / (fabsf(den) < K(1e-20) ? K(1e-20) : den);
  return (den == 0.0f || v < 0.0f) ? INFINITY : v;
}

// gamut_check_Yrg + gamut_check_RGB (filmicrgb.c:1878-1962)
__device__ void gamut_map(float Y, float c, float cos_h, float sin_h, const float* k,
                          float* out) {
  const float *input_m = k + 43, *output_m = k + 52, *folds = k + 64;
  float db = k[22], dw = k[23];
  float r = c * cos_h + K(YRG_RW);
  float g = c * sin_h + K(YRG_GW);
  float safe_cos = fabsf(cos_h) > K(1e-9) ? cos_h : K(1e-9);
  float safe_sin = fabsf(sin_h) > K(1e-9) ? sin_h : K(1e-9);
  if (r < 0.0f) c = jmin(K(-YRG_RW) / safe_cos, c);
  if (g < 0.0f) c = jmin(K(-YRG_GW) / safe_sin, c);
  if (r + g > 1.0f) c = jmin(K(1.0 - YRG_RW - YRG_GW) / (safe_cos + safe_sin), c);
  float rgb_b[3];
  ych_to_rgb(Y, c, cos_h, sin_h, output_m, rgb_b);
  float offset = jmax(-min3(rgb_b), 0.0f);
  for (int i = 0; i < 3; ++i) rgb_b[i] = rgb_b[i] + offset;
  float ych_b[4];
  rgb_to_ych(rgb_b, input_m, ych_b);
  float Y2 = jclip((Y + ych_b[0]) / 2.0f, K(CIE_Y_2006) * db, K(CIE_Y_2006) * dw);
  float max_c = c;
  for (int row = 0; row < 3; ++row) {
    const float* m = output_m + 3 * row;
    max_c = jmin(max_c, clip_chroma_white(m, folds[2 * row], dw, Y2, cos_h, sin_h));
    max_c = jmin(max_c, clip_chroma_black(m, folds[2 * row + 1], cos_h, sin_h));
  }
  ych_to_rgb(Y2, max_c, cos_h, sin_h, output_m, out);
  for (int i = 0; i < 3; ++i) out[i] = jclip(out[i], 0.0f, dw);
}

__device__ __forceinline__ void filmic_agx(float* v, const float* k, const int* a) {
  const float *inset = k + 25, *outset = k + 34, *input_m = k + 43;
  float comp[3];
  for (int i = 0; i < 3; ++i) comp[i] = jclip(nan_to_num(v[i]), K(-1e6), K(1e6));
  compress_negatives(comp, k + 61);
  float ych0[4];
  rgb_to_ych(comp, input_m, ych0);
  float rendering[3];
  mat3(inset, comp, rendering);
  for (int i = 0; i < 3; ++i) {
    float sp = spline_eval(log_tonemapping(rendering[i], k), k, a[0], a[1]);
    rendering[i] = powf(jclip(sp, 0.0f, k[21]), k[20]);
  }
  float out_rgb[3];
  mat3(outset, rendering, out_rgb);
  float ychf[4];
  rgb_to_ych(out_rgb, input_m, ychf);
  float c0 = ych0[1], cos0 = ych0[2], sin0 = ych0[3];
  float chroma_final = jmin(c0, ychf[1]);
  float beta = k[24];
  float r_mix = beta * c0 * cos0 + (1.0f - beta) * chroma_final * ychf[2];
  float g_mix = beta * c0 * sin0 + (1.0f - beta) * chroma_final * ychf[3];
  float norm_mix = sqrtf(r_mix * r_mix + g_mix * g_mix);
  float ref_cos = norm_mix > K(1e-9) ? r_mix / jmax(norm_mix, K(1e-20)) : cos0;
  float ref_sin = norm_mix > K(1e-9) ? g_mix / jmax(norm_mix, K(1e-20)) : sin0;
  float Y_final = jclip(ychf[0], K(CIE_Y_2006) * k[22], K(CIE_Y_2006) * k[23]);
  gamut_map(Y_final, chroma_final, ref_cos, ref_sin, k, v);
}

// --------------------------------------------------------------- colorout
// consts: M 0, 1/gamma 9 (TRC_GAMMA only); ints: trc
__device__ __forceinline__ void colorout(float* v, const float* k, const int* a) {
  float y[3];
  mat3(k, v, y);
  for (int i = 0; i < 3; ++i) {
    float t = jclip(y[i], 0.0f, 1.0f);
    if (a[0] == TRC_SRGB) {
      float safe = jmax(t, K(1e-9));
      t = t <= K(0.0031308) ? K(12.92) * t : K(1.055) * powf(safe, K(1.0 / 2.4)) - K(0.055);
    } else if (a[0] == TRC_GAMMA) {
      t = powf(jmax(t, K(1e-9)), k[9]);
    }
    v[i] = t;
  }
}

// ------------------------------------------------- work RGB <-> Lab (D50)
// consts: matrix 0 (XYZ_FROM_WORK or WORK_FROM_XYZ), white XYZ 9
constexpr double LAB_EPS = 216.0 / 24389.0;
constexpr double LAB_KAPPA = 24389.0 / 27.0;

__device__ __forceinline__ void convert_work_lab(float* v, const float* k) {
  float xyz[3], f[3];
  mat3(k, v, xyz);
  for (int i = 0; i < 3; ++i) {
    float r = xyz[i] / k[9 + i];
    f[i] = r > K(LAB_EPS) ? powf(jmax(r, K(1e-12)), K(1.0 / 3.0))
                          : (K(LAB_KAPPA) * r + 16.0f) / 116.0f;
  }
  v[0] = 116.0f * f[1] - 16.0f;
  v[1] = 500.0f * (f[0] - f[1]);
  v[2] = 200.0f * (f[1] - f[2]);
}

__device__ __forceinline__ void convert_lab_work(float* v, const float* k) {
  float fy = (v[0] + 16.0f) / 116.0f;
  float f[3] = {fy + v[1] / 500.0f, fy, fy - v[2] / 200.0f};
  float xyz[3];
  for (int i = 0; i < 3; ++i) {
    float f3 = f[i] * f[i] * f[i];
    xyz[i] = (f3 > K(LAB_EPS) ? f3 : (116.0f * f[i] - 16.0f) / K(LAB_KAPPA)) * k[9 + i];
  }
  mat3(k, xyz, v);
}

// ------------------------------------------------- shared pieces of the
// grading stages (ansel_tpu/kernels/pointwise.py, ansel_tpu/pixel/curves.py,
// ansel_tpu/color/spaces.py)

// atan_pos: atan2(y, x) for y, x >= 0, the minimax odd polynomial in
// Horner form with the pi/2 fold (kernels/pointwise.py:atan_pos)
__device__ float atan_pos(float y, float x) {
  float big = jmax(jmax(x, y), K(1e-20));
  float small = jmin(x, y);
  float z = small / big;
  float s = z * z;
  float u = K(0.00282363896258175373077393);
  u = u * s + K(-0.0159569028764963150024414);
  u = u * s + K(0.0425049886107444763183594);
  u = u * s + K(-0.0748900920152664184570312);
  u = u * s + K(0.106347933411598205566406);
  u = u * s + K(-0.142027363181114196777344);
  u = u * s + K(0.199926957488059997558594);
  u = u * s + K(-0.333331018686294555664062);
  float theta = u * s * z + z;
  return y > x ? K(PI / 2.0) - theta : theta;
}

// atan2_full: the quadrant fold of atan_pos by the signs of x and y
__device__ float atan2_full(float y, float x) {
  float t = atan_pos(fabsf(y), fabsf(x));
  t = x < 0.0f ? K(PI) - t : t;
  return y < 0.0f ? -t : t;
}

// curves.eval_curve over n nodes at c (xs, then ys, then ms): each
// segment overwrites the one before where x >= its first node; linear
// past the outer nodes.  The node count is a run-time loop bound.
__device__ float eval_curve(float x, const float* c, int n) {
  const float *xs = c, *ys = c + n, *ms = c + 2 * n;
  float out = ys[0] + ms[0] * (x - xs[0]);
#pragma unroll 1
  for (int k = 0; k < n - 1; ++k) {
    float h = jmax(xs[k + 1] - xs[k], K(1e-9));
    float u = jclip((x - xs[k]) / h, 0.0f, 1.0f);
    float u2 = u * u;
    float u3 = u2 * u;
    float val = ys[k] * (2.0f * u3 - 3.0f * u2 + 1.0f) + ms[k] * h * (u3 - 2.0f * u2 + u) +
                ys[k + 1] * (-2.0f * u3 + 3.0f * u2) + ms[k + 1] * h * (u3 - u2);
    out = x >= xs[k] ? val : out;
  }
  return x > xs[n - 1] ? ys[n - 1] + ms[n - 1] * (x - xs[n - 1]) : out;
}

// rgbcurve.rgb_norm (preserve-colors norms); w: the work profile's Y row
enum { NORM_NONE = 0, NORM_LUMINANCE, NORM_MAX, NORM_AVERAGE, NORM_SUM, NORM_NORM, NORM_POWER };
__device__ float rgb_norm(const float* v, int kind, const float* w) {
  switch (kind) {
    case NORM_LUMINANCE: return w[0] * v[0] + w[1] * v[1] + w[2] * v[2];
    case NORM_AVERAGE: return (v[0] + v[1] + v[2]) / 3.0f;
    case NORM_SUM: return v[0] + v[1] + v[2];
    case NORM_NORM: return sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
    case NORM_POWER: {
      float a0 = fabsf(v[0]), a1 = fabsf(v[1]), a2 = fabsf(v[2]);
      return (a0 * a0 * a0 + a1 * a1 * a1 + a2 * a2 * a2) /
             jmax(a0 * a0 + a1 * a1 + a2 * a2, K(1e-12));
    }
    default: return max3(v);
  }
}

// spaces.yrg_to_lms and the grading RGB matrices
__device__ void yrg_to_lms(const float* yrg, float* lms) {
  float r = yrg[1], g = yrg[2];
  float b = 1.0f - r - g;
  lms[0] = K(0.95) * r + K(0.38) * g + K(0.00) * b;
  lms[1] = K(0.05) * r + K(0.62) * g + K(0.03) * b;
  lms[2] = K(0.00) * r + K(0.00) * g + K(0.97) * b;
  float denom = K(0.68990272) * lms[0] + K(0.34832189) * lms[1];
  float a = denom == 0.0f ? 0.0f : yrg[0] / denom;
  for (int i = 0; i < 3; ++i) lms[i] = lms[i] * a;
}
__device__ __forceinline__ void lms_to_grading(const float* lms, float* rgb) {
  rgb[0] = K(1.0877193) * lms[0] + K(-0.66666667) * lms[1] + K(0.02061856) * lms[2];
  rgb[1] = K(-0.0877193) * lms[0] + K(1.66666667) * lms[1] + K(-0.05154639) * lms[2];
  rgb[2] = K(0.0) * lms[0] + K(0.0) * lms[1] + K(1.03092784) * lms[2];
}
__device__ __forceinline__ void grading_to_lms(const float* rgb, float* lms) {
  lms[0] = K(0.95) * rgb[0] + K(0.38) * rgb[1] + K(0.00) * rgb[2];
  lms[1] = K(0.05) * rgb[0] + K(0.62) * rgb[1] + K(0.03) * rgb[2];
  lms[2] = K(0.00) * rgb[0] + K(0.00) * rgb[1] + K(0.97) * rgb[2];
}

// ------------------------------------------------------- colorbalancergb
// consts: in_mat 0, out_mat 9, global 18, shadows 21, highlights 24,
// midtones 27, midtones_Y 30, white_fulcrum 31, grey_fulcrum 32, contrast
// 33, shadows_weight 34, highlights_weight 35, midtones_weight 36,
// mask_grey_fulcrum 37, chroma_global 38, chroma 39, saturation_global 42,
// saturation 43, brilliance_global 46, brilliance 47, vibrance 50, hue_cos
// 51, hue_sin 52, gamut_f 53 (97 Fourier coefficients), L_white 150,
// JzAzBz inverse matrices JZ_AI 151 and JZ_MI 160; ints: the saturation
// formula
enum { SAT_JZAZBZ = 0, SAT_DTUCS = 1 };
constexpr int FOURIER_K = 48;
constexpr double JZ_B = 1.15, JZ_G = 0.66, JZ_C1 = 0.8359375, JZ_C2 = 18.8515625,
                 JZ_C3 = 18.6875, JZ_N = 0.159301758, JZ_P = 134.034375, JZ_D = -0.56,
                 JZ_D0 = 1.6295499532821566e-11;
constexpr double MASK_EXP = 0.4101205819200422;

// colorbalancergb._fourier_eval: the per-hue gamut series from the
// (cos h, sin h) recurrence
__device__ float fourier_eval(const float* coef, float cos_h, float sin_h) {
  float out = coef[0] + coef[1] * cos_h + coef[2] * sin_h;
  float ck = cos_h, sk = sin_h;
#pragma unroll 1
  for (int k = 2; k <= FOURIER_K; ++k) {
    float ck2 = ck * cos_h - sk * sin_h;
    float sk2 = sk * cos_h + ck * sin_h;
    ck = ck2;
    sk = sk2;
    out = out + coef[2 * k - 1] * ck + coef[2 * k] * sk;
  }
  return out;
}

// soft_clip (colorbalancergb.c:537-543)
__device__ __forceinline__ float soft_clip(float x, float soft, float hard) {
  float norm = jmax(hard - soft, K(1e-12));
  return x > soft ? soft + (1.0f - expf(-(x - soft) / norm)) * norm : x;
}

__device__ void xyz_to_jzazbz(const float* xyz, float* jab) {
  float X = xyz[0], Y = xyz[1], Z = xyz[2];
  float p[3], lms[3], pq[3], iab[3];
  p[0] = K(JZ_B) * X - K(JZ_B - 1.0) * Z;
  p[1] = K(JZ_G) * Y - K(JZ_G - 1.0) * X;
  p[2] = Z;
  lms[0] = K(0.41478972) * p[0] + K(0.579999) * p[1] + K(0.0146480) * p[2];
  lms[1] = K(-0.2015100) * p[0] + K(1.120649) * p[1] + K(0.0531008) * p[2];
  lms[2] = K(-0.0166008) * p[0] + K(0.264800) * p[1] + K(0.6684799) * p[2];
  for (int i = 0; i < 3; ++i) {
    float y = powf(jmax(lms[i] / 10000.0f, 0.0f), K(JZ_N));
    pq[i] = powf((K(JZ_C1) + K(JZ_C2) * y) / (1.0f + K(JZ_C3) * y), K(JZ_P));
  }
  iab[0] = K(0.5) * pq[0] + K(0.5) * pq[1] + K(0.0) * pq[2];
  iab[1] = K(3.524000) * pq[0] + K(-4.066708) * pq[1] + K(0.542708) * pq[2];
  iab[2] = K(0.199076) * pq[0] + K(1.096799) * pq[1] + K(-1.295875) * pq[2];
  jab[0] = jmax((K(1.0 + JZ_D) * iab[0]) / (1.0f + K(JZ_D) * iab[0]) - K(JZ_D0), 0.0f);
  jab[1] = iab[1];
  jab[2] = iab[2];
}

// ai, mi: JZ_AI and JZ_MI, row-major
__device__ void jzazbz_to_xyz(const float* jab, const float* ai, const float* mi, float* xyz) {
  float Iz = jab[0] + K(JZ_D0);
  Iz = jmax(Iz / (K(1.0 + JZ_D) - K(JZ_D) * Iz), 0.0f);
  float iab[3] = {Iz, jab[1], jab[2]}, pq[3], lms[3], p[3];
  mat3(ai, iab, pq);
  for (int i = 0; i < 3; ++i) {
    float y = powf(jmax(pq[i], 0.0f), K(1.0 / JZ_P));
    lms[i] = 10000.0f * powf(jmax((K(JZ_C1) - y) / (K(JZ_C3) * y - K(JZ_C2)), 0.0f),
                             K(1.0 / JZ_N));
  }
  mat3(mi, lms, p);
  float X = (p[0] + K(JZ_B - 1.0) * p[2]) / K(JZ_B);
  float Y = (p[1] + K(JZ_G - 1.0) * X) / K(JZ_G);
  xyz[0] = X;
  xyz[1] = Y;
  xyz[2] = p[2];
}

// colorbalancergb._saturation_jzazbz (colorbalancergb.c:764-840)
__device__ void cbrgb_saturation_jzazbz(float* xyz, const float* k, float boost_s,
                                        float boost_b) {
  float in[3] = {jmax(xyz[0], 0.0f), jmax(xyz[1], 0.0f), jmax(xyz[2], 0.0f)}, jab[3];
  xyz_to_jzazbz(in, jab);
  float Jz = jab[0];
  float Cz = sqrtf(jab[1] * jab[1] + jab[2] * jab[2]);
  float inv_cz = Cz > 0.0f ? 1.0f / jmax(Cz, K(1e-20)) : 0.0f;
  float cos_H = jab[1] * inv_cz;
  float sin_H = jab[2] * inv_cz;
  float T = atan_pos(Cz, Jz);
  float hyp = sqrtf(Jz * Jz + Cz * Cz);
  float inv_h = hyp > 0.0f ? 1.0f / jmax(hyp, K(1e-20)) : 0.0f;
  float sin_T = Cz * inv_h;
  float cos_T = hyp > 0.0f ? Jz * inv_h : 1.0f;
  float S0 = Jz * cos_T + Cz * sin_T;
  float O1 = S0 * jmin(jmax(T * boost_s, -T), K(PI / 2.0) - T);
  float S1 = jmax(S0 * (1.0f + boost_b), 0.0f);
  float Jz2 = jmax(S1 * cos_T - O1 * sin_T, 0.0f);
  float Cz2 = jmax(S1 * sin_T + O1 * cos_T, 0.0f);
  float max_sat_h = jmax(fourier_eval(k + 53, cos_H, sin_H), K(1e-6));
  float sat_px = Jz2 > 0.0f
                     ? soft_clip(Cz2 / jmax(Jz2, K(1e-20)), K(0.8) * max_sat_h, max_sat_h)
                     : max_sat_h;
  float max_C_at_sat = Jz2 * sat_px;
  float max_J_at_sat = sat_px > 0.0f ? Cz2 / jmax(sat_px, K(1e-20)) : Jz2;
  Jz2 = 0.5f * (Jz2 + max_J_at_sat);
  Cz2 = 0.5f * (Cz2 + max_C_at_sat);
  float Iz = Jz2 + K(JZ_D0);
  Iz = jmax(Iz / (K(1.0 + JZ_D) - K(JZ_D) * Iz), 0.0f);
  const float* ai = k + 151;
  float max_C = Cz2;
  for (int row = 0; row < 3; ++row) {
    float denom = ai[3 * row + 1] * cos_H + ai[3 * row + 2] * sin_H;
    float lms_test = Iz * ai[3 * row] + Cz2 * denom;
    float lim = -Iz * ai[3 * row] / (fabsf(denom) > K(1e-12) ? denom : K(1e-12));
    max_C = lms_test < 0.0f ? jmin(lim, max_C) : max_C;
  }
  float out[3] = {Jz2, max_C * cos_H, max_C * sin_H};
  jzazbz_to_xyz(out, ai, k + 160, xyz);
}

// colorbalancergb._saturation_dtucs (colorbalancergb.c:841-884)
__device__ void cbrgb_saturation_dtucs(float* xyz, const float* k, float boost_s,
                                       float boost_b) {
  const float L_white = k[150];
  float X = xyz[0], Y = jmax(xyz[1], 0.0f), Z = xyz[2];
  float ssum = jmax(X + Y + Z, K(1e-12));
  float xx = X / ssum, yy = Y / ssum;
  float uvd0 = K(-0.783941002840055) * xx + K(0.277512987809202) * yy + K(0.153836578598858);
  float uvd1 = K(0.745273540913283) * xx - K(0.205375866083878) * yy - K(0.165478376301988);
  float uvd2 = K(0.318707282433486) * xx + K(2.16743692732158) * yy + K(0.291320554395942);
  float U = uvd0 / uvd2, V = uvd1 / uvd2;
  float Us = K(1.39656225667) * U / (fabsf(U) + K(1.49217352929));
  float Vs = K(1.4513954287) * V / (fabsf(V) + K(1.52488637914));
  float Up = K(-1.124983854323892) * Us - K(0.980483721769325) * Vs;
  float Vp = K(1.86323315098672) * Us + K(1.971853092390862) * Vs;
  float M2 = Up * Up + Vp * Vp;
  float M = sqrtf(M2);
  float inv_m = M > 0.0f ? 1.0f / jmax(M, K(1e-20)) : 0.0f;
  float cos_H = M > 0.0f ? Up * inv_m : 1.0f;
  float sin_H = Vp * inv_m;
  float Yh = powf(jmax(Y, K(1e-12)), K(0.631651345306265));
  float L_star = K(2.098883786377) * Yh / (Yh + K(1.12426773749357));
  float J = L_star / L_white;
  float C = K(15.932993652962535) * powf(L_star, K(0.6523997524738018)) *
            powf(M2, K(0.6007557017508491)) / L_white;
  float B = J * (powf(C, K(1.33654221029386)) + 1.0f);
  float radius = sqrtf(C * C + B * B);
  float inv_r = radius > 0.0f ? 1.0f / jmax(radius, K(1e-20)) : 0.0f;
  float sin_T = C * inv_r;
  float cos_T = B * inv_r;
  float P = jmax(C, K(1e-30));
  float W = sin_T * C + cos_T * B;
  float a = jmax(1.0f + boost_s, 0.0f);
  float b = jmax(1.0f + boost_b, 0.0f);
  float max_a = sqrtf(P * P + W * W) / P;
  a = soft_clip(a, 0.5f * max_a, max_a);
  float P_p = (a - 1.0f) * P;
  float W_p = sqrtf(jmax(P * P * (1.0f - a * a), 0.0f) + W * W) * b;
  float C2 = jmax(cos_T * P_p + sin_T * W_p, 0.0f);
  float B2 = jmax(-sin_T * P_p + cos_T * W_p, 0.0f);
  float J2 = B2 / (powf(C2, K(1.33654221029386)) + 1.0f);
  float maxM2 = jmax(fourier_eval(k + 53, cos_H, sin_H), K(1e-12));
  float max_chroma = K(15.932993652962535) *
                     powf(jmax(J2 * L_white, K(1e-12)), K(0.6523997524738018)) *
                     powf(maxM2, K(0.6007557017508491)) / L_white;
  float B_bound = J2 * (powf(max_chroma, K(1.33654221029386)) + 1.0f);
  float S_bound = max_chroma / jmax(B_bound, K(1e-20));
  float S = B2 > 0.0f ? C2 / jmax(B2, K(1e-20)) : 0.0f;
  S = soft_clip(S, K(0.8) * S_bound, S_bound);
  float C3 = S * B2;
  float J3 = B2 / (powf(C3, K(1.33654221029386)) + 1.0f);
  float L3 = J3 * L_white;
  float M3 = powf(jmax(C3 * L_white / (K(15.932993652962535) *
                                       powf(jmax(L3, K(1e-12)), K(0.6523997524738018))),
                       0.0f),
                  K(0.8322850678616855));
  float Up3 = M3 * cos_H;
  float Vp3 = M3 * sin_H;
  float Us3 = K(-5.037522385190711) * Up3 - K(2.504856328185843) * Vp3;
  float Vs3 = K(4.760029407436461) * Up3 + K(2.874012963239247) * Vp3;
  float U3 = K(-1.49217352929) * Us3 / (fabsf(Us3) - K(1.39656225667));
  float V3 = K(-1.52488637914) * Vs3 / (fabsf(Vs3) - K(1.4513954287));
  float xyd0 = K(0.167171472114775) * U3 + K(0.141299802443708) * V3 - K(0.00801531300850582);
  float xyd1 = K(-0.150959086409163) * U3 - K(0.155185060382272) * V3 - K(0.00843312433578007);
  float xyd2 = K(0.940254742367256) * U3 + K(1.0) * V3 - K(0.0256325967652889);
  float xd = xyd0 / xyd2;
  float yd = xyd1 / xyd2;
  float Y3 = powf(jmax(K(1.12426773749357) * L3 / jmax(K(2.098883786377) - L3, K(1e-9)), 0.0f),
                  K(1.5831518565279648));
  float safe_y = jmax(yd, K(1e-9));
  xyz[0] = xd * Y3 / safe_y;
  xyz[1] = Y3;
  xyz[2] = (1.0f - xd - yd) * Y3 / safe_y;
}

__device__ __forceinline__ void colorbalancergb(float* v, const float* k, const int* a) {
  float rgb[3] = {jmax(v[0], 0.0f), jmax(v[1], 0.0f), jmax(v[2], 0.0f)}, lms[3], yrg[3];
  mat3(k, rgb, lms);
  lms_to_yrg(lms, yrg);
  float Y = jmax(yrg[0], 0.0f);
  // opacity masks (colorbalancergb.c:509-534)
  float mgf = k[37];
  float off = powf(jmax(Y, K(1e-12)), K(MASK_EXP)) - mgf;
  float off_n = off / mgf;
  float op_s = 1.0f / (1.0f + expf(off_n * k[34]));
  float op_h = 1.0f / (1.0f + expf(-off_n * k[35]));
  float cp_s = 1.0f - op_s, cp_h = 1.0f - op_h;
  float op_m = expf(-(off * off) * k[36] / 4.0f) * (cp_s * cp_s) * (cp_h * cp_h) * 8.0f;
  // hue rotation, chroma and vibrance in the Yrg chromaticity plane
  float r_c = yrg[1] - K(YRG_RW);
  float g_c = yrg[2] - K(YRG_GW);
  float hc = k[51], hs = k[52];
  float r_rot = hc * r_c - hs * g_c;
  float g_rot = hs * r_c + hc * g_c;
  float chroma_in = sqrtf(r_rot * r_rot + g_rot * g_rot);
  float inv_c = chroma_in > 0.0f ? 1.0f / jmax(chroma_in, K(1e-20)) : 0.0f;
  float cos_h = r_rot * inv_c;
  float sin_h = g_rot * inv_c;
  const float* ch = k + 39;
  float chroma_boost = k[38] + op_s * ch[0] + op_m * ch[1] + op_h * ch[2];
  float vib = k[50] * (1.0f - powf(jmax(chroma_in, 0.0f), fabsf(k[50])));
  float chroma_out = chroma_in * jmax(1.0f + chroma_boost + vib, 0.0f);
  float safe_cos = fabsf(cos_h) > K(1e-9) ? cos_h : K(1e-9);
  float safe_sin = fabsf(sin_h) > K(1e-9) ? sin_h : K(1e-9);
  float r_lim = K(-YRG_RW) / safe_cos;
  float g_lim = K(-YRG_GW) / safe_sin;
  float s_lim = K(1.0 - YRG_RW - YRG_GW) / (safe_cos + safe_sin);
  if (chroma_out * cos_h + K(YRG_RW) < 0.0f) chroma_out = jmin(r_lim, chroma_out);
  if (chroma_out * sin_h + K(YRG_GW) < 0.0f) chroma_out = jmin(g_lim, chroma_out);
  if ((chroma_out * cos_h + K(YRG_RW)) + (chroma_out * sin_h + K(YRG_GW)) > 1.0f)
    chroma_out = jmin(s_lim, chroma_out);
  yrg[0] = Y;
  yrg[1] = chroma_out * cos_h + K(YRG_RW);
  yrg[2] = chroma_out * sin_h + K(YRG_GW);
  // 4-way grading in grading RGB
  float grading[3];
  yrg_to_lms(yrg, lms);
  lms_to_grading(lms, grading);
  const float *gl = k + 18, *sh = k + 21, *hl = k + 24, *mt = k + 27;
  float wf = k[31];
  for (int i = 0; i < 3; ++i) {
    float g = grading[i] + gl[i];
    g = g * (cp_h * (cp_s + op_s * sh[i]) + op_h * hl[i]);
    float sgn = g > 0.0f ? 1.0f : (g < 0.0f ? -1.0f : g);
    grading[i] = sgn * powf(fabsf(g) / wf, mt[i]) * wf;
  }
  grading_to_lms(grading, lms);
  lms_to_yrg(lms, yrg);
  float Y2 = powf(jmax(yrg[0] / wf, 0.0f), k[30]) * wf;
  Y2 = k[32] * powf(jmax(Y2 / k[32], 0.0f), k[33]);
  yrg[0] = Y2;
  yrg_to_lms(yrg, lms);
  float xyz[3];
  xyz[0] = K(1.80794659) * lms[0] + K(-1.29971660) * lms[1] + K(0.34785879) * lms[2];
  xyz[1] = K(0.61783960) * lms[0] + K(0.39595453) * lms[1] + K(-0.04104687) * lms[2];
  xyz[2] = K(-0.12546960) * lms[0] + K(0.20478038) * lms[1] + K(1.74274183) * lms[2];
  const float *sat = k + 43, *bri = k + 47;
  float boost_b = k[46] + op_s * bri[0] + op_m * bri[1] + op_h * bri[2];
  float boost_s = k[42] + op_s * sat[0] + op_m * sat[1] + op_h * sat[2];
  if (a[0] == SAT_DTUCS)
    cbrgb_saturation_dtucs(xyz, k, boost_s, boost_b);
  else
    cbrgb_saturation_jzazbz(xyz, k, boost_s, boost_b);
  for (int i = 0; i < 3; ++i) xyz[i] = jmax(xyz[i], 0.0f);
  mat3(k + 9, xyz, v);
  for (int i = 0; i < 3; ++i) v[i] = jmax(v[i], 0.0f);
}

// -------------------------------------------------------------- rgbcurve
// consts: curves 0, 1, 2 (3 n_i each), the work Y row after them
// ints: autoscale, norm, n0, n1, n2
__device__ __forceinline__ void rgbcurve(float* v, const float* k, const int* a) {
  int n0 = a[2], n1 = a[3], n2 = a[4];
  const float *c1 = k + 3 * n0, *c2 = c1 + 3 * n1, *yw = c2 + 3 * n2;
  if (a[0] == 0 && a[1] != NORM_NONE) {  // SCALE_AUTOMATIC_RGB, a norm
    float ratio_src = jmax(rgb_norm(v, a[1], yw), K(1e-9));
    float f = eval_curve(ratio_src, k, n0) / ratio_src;
    for (int i = 0; i < 3; ++i) v[i] = v[i] * f;
  } else if (a[0] == 0) {
    for (int i = 0; i < 3; ++i) v[i] = eval_curve(v[i], k, n0);
  } else {
    v[0] = eval_curve(v[0], k, n0);
    v[1] = eval_curve(v[1], c1, n1);
    v[2] = eval_curve(v[2], c2, n2);
  }
}

// ------------------------------------------------------------- rgblevels
// consts: lo 0, hi 3, ig 6, work Y row 9; ints: autoscale, norm
__device__ __forceinline__ float levels_remap(float v, float lo, float hi, float ig) {
  return powf(jclip((v - lo) / (hi - lo), 0.0f, 1.0f), ig);
}
__device__ __forceinline__ void rgblevels(float* v, const float* k, const int* a) {
  const float *lo = k, *hi = k + 3, *ig = k + 6;
  if (a[0] == 1 && a[1] != 0) {  // LINKED, a norm
    float n = jmax(rgb_norm(v, a[1], k + 9), K(1e-6));
    float f = levels_remap(n, lo[0], hi[0], ig[0]) / n;
    for (int i = 0; i < 3; ++i) v[i] = v[i] * f;
  } else if (a[0] == 1) {
    for (int i = 0; i < 3; ++i) v[i] = levels_remap(v[i], lo[0], hi[0], ig[0]);
  } else {
    for (int i = 0; i < 3; ++i) v[i] = levels_remap(v[i], lo[i], hi[i], ig[i]);
  }
}

// ------------------------------------------------------------- basecurve
// consts: the curve (3 n), the work Y row; ints: norm, n
__device__ __forceinline__ void basecurve(float* v, const float* k, const int* a) {
  int n = a[1];
  if (a[0] != 0) {
    float nv = jmax(rgb_norm(v, a[0], k + 3 * n), K(1e-9));
    float f = eval_curve(nv, k, n) / nv;
    for (int i = 0; i < 3; ++i) v[i] = v[i] * f;
  } else {
    for (int i = 0; i < 3; ++i) v[i] = eval_curve(v[i], k, n);
  }
}

// ------------------------------------------------ tonecurve, levels (Lab)
// tonecurve consts: the L curve (3 n); ints: n
__device__ __forceinline__ void tonecurve(float* v, const float* k, const int* a) {
  float L_out = eval_curve(v[0] / 100.0f, k, a[0]) * 100.0f;
  float ratio = L_out / jmax(v[0], K(1e-6));
  v[0] = L_out;
  v[1] = v[1] * ratio;
  v[2] = v[2] * ratio;
}

// levels consts: lo 0, hi 1, inv_gamma 2
__device__ __forceinline__ void levels(float* v, const float* k) {
  float norm = jclip((v[0] - k[0]) / (k[1] - k[0]), 0.0f, 1.0f);
  float L_out = 100.0f * powf(norm, k[2]);
  float ratio = L_out / jmax(v[0], K(1e-6));
  v[0] = L_out;
  v[1] = v[1] * ratio;
  v[2] = v[2] * ratio;
}

// -------------------------------------------------------------- basicadj
// consts: black 0, scale 1, hlcomp 2, hlrange 3, gamma 4, contrast 5,
// grey 6, saturation 7, vibrance 8, work Y row 9
// ints: plain_contrast, norm, has_gamma, has_satvib, has_hl
__device__ __forceinline__ void basicadj(float* v, const float* k, const int* a) {
  const float* y = k + 9;
  for (int i = 0; i < 3; ++i) v[i] = (v[i] - k[0]) * k[1];
  if (a[4]) {
    float lum = y[0] * v[0] + y[1] * v[1] + y[2] * v[2];
    float ratio = 1.0f;
    if (lum > 0.0f) {  // hlcurve (basicadj.c:852-880)
      float val = lum + (k[3] - 1.0f);
      val = val == 0.0f ? K(1e-6) : val;
      float Yc = jmax(val / k[3] * k[2], K(-0.999999));
      ratio = log1pf(Yc) * (k[3] / (val * k[2]));
    }
    for (int i = 0; i < 3; ++i) v[i] = v[i] * ratio;
  }
  if (a[2])
    for (int i = 0; i < 3; ++i) v[i] = v[i] > 0.0f ? powf(jmax(v[i], 0.0f), k[4]) : v[i];
  if (a[0]) {
    float ig = 1.0f / k[6];
    for (int i = 0; i < 3; ++i)
      v[i] = v[i] > 0.0f ? powf(jmax(v[i] * ig, 0.0f), k[5]) * k[6] : v[i];
  }
  if (a[1] != 0) {
    float lum = y[0] * v[0] + y[1] * v[1] + y[2] * v[2];
    float ig = 1.0f / k[6];
    float clum = powf(jmax(lum * ig, 0.0f), k[5]) * k[6];
    float ratio = lum > 0.0f ? clum / jmax(lum, K(1e-12)) : 1.0f;
    for (int i = 0; i < 3; ++i) v[i] = v[i] * ratio;
  }
  if (a[3]) {
    float avg = (v[0] + v[1] + v[2]) / 3.0f;
    float d0 = avg - v[0], d1 = avg - v[1], d2 = avg - v[2];
    float delta = sqrtf(d0 * d0 + d1 * d1 + d2 * d2);
    float P = k[8] * (1.0f - powf(jmax(delta, 0.0f), fabsf(k[8])));
    for (int i = 0; i < 3; ++i) v[i] = avg + (k[7] + P) * (v[i] - avg);
  }
}

// ------------------------------------------------------------ colorzones
// consts: curves 0, 1, 2 (3 n_i each), mix; ints: select, n0, n1, n2
__device__ __forceinline__ void colorzones(float* v, const float* k, const int* a) {
  int n0 = a[1], n1 = a[2], n2 = a[3];
  const float *c1 = k + 3 * n0, *c2 = c1 + 3 * n1;
  float mix = c2[3 * n2];
  float L = v[0], A = v[1], B = v[2];
  float C = sqrtf(A * A + B * B);
  float h = atan2_full(B, A) / K(2.0 * PI) + 0.5f;
  float t = a[0] == 0   ? jclip(L / 100.0f, 0.0f, 1.0f)
            : a[0] == 1 ? jclip(C / K(128.0 * SQRT2), 0.0f, 1.0f)
                        : h;
  float sel_L = eval_curve(t, k, n0);
  float sel_C = eval_curve(t, c1, n1);
  float sel_h = eval_curve(t, c2, n2);
  float L2 = L + 100.0f * (sel_L - 0.5f) * 2.0f * mix * 0.5f;
  float C2 = C * jmax(powf(2.0f, 4.0f * (sel_C - 0.5f) * mix), 0.0f);
  float h2 = h + (sel_h - 0.5f) * K(60.0 / 360.0) * mix;
  float ang = (h2 - 0.5f) * 2.0f * K(PI);
  v[0] = jclip(L2, 0.0f, 100.0f);
  v[1] = C2 * cosf(ang);
  v[2] = C2 * sinf(ang);
}

// ------------------------------------------------------------ negadoctor
// consts: Dmin 0, wb_high 3, offset 6, black 9, exposure 10, gamma 11,
// soft_clip 12, soft_clip_comp 13
constexpr double NEGA_THRESHOLD = 2.3283064365386963e-10;
constexpr double LOG10_E = 2.302585092994046;
__device__ __forceinline__ void negadoctor(float* v, const float* k) {
  for (int i = 0; i < 3; ++i) {
    float density = -(logf(k[i]) - logf(jmax(v[i], K(NEGA_THRESHOLD)))) / K(LOG10_E);
    float corrected = k[3 + i] * density + k[6 + i];
    float print_linear = -(k[10] * expf(corrected * K(LOG10_E)) + k[9]);
    float pg = powf(jmax(print_linear, 0.0f), k[11]);
    float sc = k[12], comp = k[13];
    v[i] = pg > sc ? sc + (1.0f - expf(-(pg - sc) / comp)) * comp : pg;
  }
}

// --------------------------------------- vignette, graduatednd (with_pos)
// yy, xx: the pixel's row and column in the array, as floats
// vignette consts: scale 0, falloff 1, brightness 2, saturation 3, cx 4,
// cy 5, whratio 6, shape 7, half width 8, half height 9
__device__ __forceinline__ void vignette(float* v, const float* k, float yy, float xx) {
  float xs = (xx - k[8]) / k[8] - k[4];
  float ys = (yy - k[9]) / k[9] - k[5];
  float xw = xs / k[6];
  float d = sqrtf(xw * xw + ys * ys);
  d = powf(jmax(d, K(1e-9)), k[7]);
  float inner = k[0];
  float outer = inner + jmax(k[1], K(1e-4));
  float t = jclip((d - inner) / (outer - inner), 0.0f, 1.0f);
  t = t * t * (3.0f - 2.0f * t);
  float gain = 1.0f + k[2] * t;
  for (int i = 0; i < 3; ++i) v[i] = v[i] * gain;
  float mean = (v[0] + v[1] + v[2]) / 3.0f;
  float sat = 1.0f + k[3] * t;
  for (int i = 0; i < 3; ++i) v[i] = mean + (v[i] - mean) * sat;
}

// graduatednd consts: density 0, sinv 1, cosv 2, offset 3, hardness 4,
// color 5, color1 8, half width 11, half height 12, 1 / filter radius 13
__device__ __forceinline__ void graduatednd(float* v, const float* k, float yy, float xx) {
  float hardness = k[13] / (1.0f - (0.5f + k[4] * K(0.9) / 2.0f)) * 0.5f;
  float length =
      (k[1] * (-1.0f + xx / k[11]) - k[2] * (-1.0f + yy / k[12]) - 1.0f + k[3]) * hardness;
  float dens = k[0];
  float t = dens > 0.0f ? jclip(0.5f + length, 0.0f, 1.0f) : jclip(0.5f - length, 0.0f, 1.0f);
  float density = exp2f(fabsf(dens) * t);
  for (int i = 0; i < 3; ++i) v[i] = jmax(0.0f, v[i] / (k[5 + i] + k[8 + i] * density));
}

// ------------------------------------------------ the legacy look (19-30)
// ansel_tpu/ops/{velvia,vibrance,colorcontrast,colorcorrection,colisa,
// splittoning,colorize,colorbalance,splittoningrgb,lowlight,
// profile_gamma,colorchecker}.py, each in its reference's operand order

// velvia consts: strength 0, bias 1
__device__ __forceinline__ void velvia(float* v, const float* k) {
  float pmax = max3(v), pmin = min3(v);
  float plum = (pmax + pmin) * 0.5f;
  float psat = plum <= 0.5f ? (pmax - pmin) / (K(1e-5) + pmax + pmin)
                            : (pmax - pmin) / (K(1e-5) + jmax(2.0f - pmax - pmin, 0.0f));
  float bias = k[1];
  float pweight = jclip(((1.0f - 1.5f * psat) + (1.0f + fabsf(plum - 0.5f) * 2.0f) * (1.0f - bias)) /
                            (1.0f + (1.0f - bias)),
                        0.0f, 1.0f);
  float sat = k[0] * pweight;
  float total = (v[0] + v[1]) + v[2];
  for (int i = 0; i < 3; ++i) v[i] = jclip(v[i] + sat * (v[i] - (total - v[i]) * 0.5f), 0.0f, 1.0f);
}

// vibrance consts: amount 0
__device__ __forceinline__ void vibrance(float* v, const float* k) {
  float sw = sqrtf(v[1] * v[1] + v[2] * v[2]) / 256.0f;
  float ls = 1.0f - k[0] * sw * 0.25f;
  float ss = 1.0f + k[0] * sw;
  v[0] = v[0] * ls;
  v[1] = v[1] * ss;
  v[2] = v[2] * ss;
}

// colorcontrast consts: slope 0 (3), offset 3 (3); ints: unbound
__device__ __forceinline__ void colorcontrast(float* v, const float* k, const int* a) {
  for (int i = 0; i < 3; ++i) v[i] = v[i] * k[i] + k[3 + i];
  if (!a[0]) {
    v[1] = jclip(v[1], -128.0f, 128.0f);
    v[2] = jclip(v[2], -128.0f, 128.0f);
  }
}

// colorcorrection consts: a_scale 0, a_base 1, b_scale 2, b_base 3,
// saturation 4
__device__ __forceinline__ void colorcorrection(float* v, const float* k) {
  float A = k[4] * (v[1] + v[0] * k[0] + k[1]);
  float B = k[4] * (v[2] + v[0] * k[2] + k[3]);
  v[1] = A;
  v[2] = B;
}

// colisa consts: contrast 0, m1sq 1, scale 2, gamma 3, saturation 4;
// ints: linear contrast (the contrast slider at or below 0)
__device__ __forceinline__ void colisa(float* v, const float* k, const int* a) {
  float t = v[0] / 100.0f;
  float L;
  if (a[0]) {
    L = k[0] * (100.0f * t - 50.0f) + 50.0f;
  } else {
    float s = 2.0f * t - 1.0f;
    L = 50.0f * (k[2] * s / sqrtf(1.0f + k[1] * s * s) + 1.0f);
  }
  v[0] = 100.0f * powf(jmax(L / 100.0f, 0.0f), k[3]);
  v[1] = v[1] * k[4];
  v[2] = v[2] * k[4];
}

// Python's float % (torch.remainder): fmod, moved into the divisor's sign
__device__ __forceinline__ float py_mod(float a, float b) {
  float m = fmodf(a, b);
  return (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) ? m + b : m;
}

// ops/_hsl.hsl_to_rgb of one pixel
__device__ void hsl_to_rgb(float h, float s, float l, float* rgb) {
  float c = (1.0f - fabsf(2.0f * l - 1.0f)) * s;
  float hp = py_mod(h, 1.0f) * 6.0f;
  float xv = c * (1.0f - fabsf(py_mod(hp, 2.0f) - 1.0f));
  float m = l - c / 2.0f;
  float r, g, b;
  if (hp < 1.0f) {
    r = c, g = xv, b = 0.0f;
  } else if (hp < 2.0f) {
    r = xv, g = c, b = 0.0f;
  } else if (hp < 3.0f) {
    r = 0.0f, g = c, b = xv;
  } else if (hp < 4.0f) {
    r = 0.0f, g = xv, b = c;
  } else if (hp < 5.0f) {
    r = xv, g = 0.0f, b = c;
  } else {
    r = c, g = 0.0f, b = xv;
  }
  rgb[0] = r + m;
  rgb[1] = g + m;
  rgb[2] = b + m;
}

// splittoning consts: shadow hue 0, shadow saturation 1, highlight hue 2,
// highlight saturation 3, balance 4, compress 5
__device__ __forceinline__ void splittoning(float* v, const float* k) {
  float xc[3];
  for (int i = 0; i < 3; ++i) xc[i] = jclip(v[i], 0.0f, 1.0f);
  float l = (max3(xc) + min3(xc)) * 0.5f;
  float sh[3], hl[3];
  hsl_to_rgb(k[0], k[1], l, sh);
  hsl_to_rgb(k[2], k[3], l, hl);
  float ra_sh = jclip((k[4] - k[5] - l) * 2.0f, 0.0f, 1.0f);
  float ra_hl = jclip((l - (k[4] + k[5])) * 2.0f, 0.0f, 1.0f);
  for (int i = 0; i < 3; ++i) {
    float o = xc[i] * (1.0f - ra_sh) + sh[i] * ra_sh;
    o = o * (1.0f - ra_hl) + hl[i] * ra_hl;
    v[i] = jclip(o, 0.0f, 1.0f);
  }
}

// colorize consts: L target less half the mix 0, mix 1, a 2, b 3
__device__ __forceinline__ void colorize(float* v, const float* k) {
  v[0] = k[0] + v[0] * k[1];
  v[1] = 0.0f + k[2];
  v[2] = 0.0f + k[3];
}

// colorbalance consts: lift 0, gamma 3, gain 6 (per channel, the master
// folded in), saturation 9, saturation_out 10, contrast 11, grey 12, work
// Y row 13; ints: mode
enum { CB_LIFT_GAMMA_GAIN = 0, CB_SLOPE_OFFSET_POWER = 1 };
__device__ __forceinline__ void colorbalance(float* v, const float* k, const int* a) {
  const float* yw = k + 13;
  float lum = yw[0] * v[0] + yw[1] * v[1] + yw[2] * v[2];
  float o[3];
  for (int i = 0; i < 3; ++i) {
    float s = jmax(lum + k[9] * (v[i] - lum), 0.0f);
    float ig = 1.0f / jmax(k[3 + i], K(1e-6));
    float base = a[0] == CB_SLOPE_OFFSET_POWER ? s * k[6 + i] + (k[i] - 1.0f)
                                               : k[6 + i] * (s + (k[i] - 1.0f) * (1.0f - s));
    o[i] = powf(jmax(base, 0.0f), ig);
  }
  float grey = k[12];
  for (int i = 0; i < 3; ++i) o[i] = grey * powf(jmax(o[i] / grey, K(1e-9)), k[11]);
  lum = yw[0] * o[0] + yw[1] * o[1] + yw[2] * o[2];
  for (int i = 0; i < 3; ++i) v[i] = lum + k[10] * (o[i] - lum);
}

// splittoningrgb consts: dark matrix 0, bright matrix 9, dark key 18,
// bright key 19, work Y row 20
__device__ __forceinline__ void splittoningrgb(float* v, const float* k) {
  const float *dm = k, *bm = k + 9, *y = k + 20;
  float lum = jmax(y[0] * v[0] + y[1] * v[1] + y[2] * v[2], 0.0f);
  float dl = k[18], bl = k[19];
  float seg = jmax(bl - dl, NORM_MIN);
  float a_dark = jclip(1.0f - (dl - lum) / seg, 0.0f, 1.0f);
  float a_mid = jclip((lum - dl) / seg, 0.0f, 1.0f);
  float a_bright = jclip(1.0f - (lum - bl) / seg, 0.0f, 1.0f);
  bool below = lum <= dl, above = lum >= bl;
  float out[3];
  for (int r = 0; r < 3; ++r) {
    float acc = 0.0f;
    for (int c = 0; c < 3; ++c) {
      float id = r == c ? 1.0f : 0.0f;
      float d = dm[3 * r + c], b = bm[3 * r + c];
      float m = below   ? id + a_dark * (d - id)
                : above ? id + a_bright * (b - id)
                        : d + a_mid * (b - d);
      acc = c == 0 ? m * v[c] : acc + m * v[c];
    }
    out[r] = acc;
  }
  for (int i = 0; i < 3; ++i) v[i] = out[i];
}

// lowlight consts: the transition curve (3 n: xs, ys, ms), the scotopic
// white XYZ 3 n, the Lab white 3 n + 3; ints: n.  Lab <-> XYZ as
// ansel_tpu/color/transforms.py computes them (the cube root as
// exp(log(r) / 3))
__device__ __forceinline__ void lowlight(float* v, const float* k, const int* a) {
  const int n = a[0];
  const float *sw = k + 3 * n, *wt = sw + 3;
  float fy = (v[0] + 16.0f) / 116.0f;
  float f[3] = {fy + v[1] / 500.0f, fy, fy - v[2] / 200.0f};
  float xyz[3];
  for (int i = 0; i < 3; ++i) {
    float f3 = f[i] * f[i] * f[i];
    xyz[i] = (f3 > K(LAB_EPS) ? f3 : (116.0f * f[i] - 16.0f) / K(LAB_KAPPA)) * wt[i];
  }
  float denom = jmax(xyz[0], K(0.01));
  float V = xyz[1] * (K(1.33) * (1.0f + (xyz[1] + xyz[2]) / denom) - K(1.68));
  V = jclip(0.5f * V, 0.0f, 1.0f);
  float w = jclip(eval_curve(v[0] / 100.0f, k, n), 0.0f, 1.0f);
  for (int i = 0; i < 3; ++i) {
    float mixed = w * xyz[i] + (1.0f - w) * V * sw[i];
    float r = mixed / wt[i];
    float croot = expf(logf(jmax(r, K(1e-12))) * K(1.0 / 3.0));
    f[i] = r > K(LAB_EPS) ? croot : (K(LAB_KAPPA) * r + 16.0f) / 116.0f;
  }
  v[0] = 116.0f * f[1] - 16.0f;
  v[1] = 500.0f * (f[0] - f[1]);
  v[2] = 200.0f * (f[1] - f[2]);
}

// profile_gamma, log mode consts: grey 0, shadows 1, range 2; gamma mode
// consts: a 0, b 1, c 2, g 3, linear 4; ints: the branch (0 log, 1 a
// scale, 2 a pure power, 3 a power with a linear toe)
constexpr double PG_NOISE = 1.52587890625e-05;  // 2^-16
__device__ __forceinline__ void profile_gamma(float* v, const float* k, const int* a) {
  for (int i = 0; i < 3; ++i) {
    float x = v[i];
    switch (a[0]) {
      case 0: {
        float t = jmax(x / k[0], K(PG_NOISE));
        t = (log2f(t) - k[1]) / k[2];
        v[i] = jmax(t, K(PG_NOISE));
        break;
      }
      case 1: v[i] = x * k[2]; break;
      case 2: v[i] = powf(jmax(x, 0.0f), k[3]); break;
      default: {
        float toe = k[2] * x;
        float power = powf(jmax(k[0] * jmax(x, 0.0f) + k[1], 0.0f), k[3]);
        v[i] = x < k[4] ? toe : power;
      }
    }
  }
}

// colorchecker consts: coeff_L, coeff_a, coeff_b (N + 4 each: the N
// patches' weights, then offset, L, a, b), the N source patches (3 N);
// ints: N (at most 12 in a chain; the patch loop a run-time bound)
__device__ __forceinline__ void colorchecker(float* v, const float* k, const int* a) {
  const int N = a[0];
  const float *cl = k, *ca = k + (N + 4), *cb = k + 2 * (N + 4), *src = k + 3 * (N + 4);
  const float x0 = v[0], x1 = v[1], x2 = v[2];
  float oL = cl[N] + cl[N + 1] * x0 + cl[N + 2] * x1 + cl[N + 3] * x2;
  float oa = ca[N] + ca[N + 1] * x0 + ca[N + 2] * x1 + ca[N + 3] * x2;
  float ob = cb[N] + cb[N + 1] * x0 + cb[N + 2] * x1 + cb[N + 3] * x2;
  // the patch loop stays rolled; the channels are written out (no inner
  // loop), so scripts/chain_count.py weighs each line by its iterations
#pragma unroll 1
  for (int j = 0; j < N; ++j) {
    float d0 = x0 - src[3 * j], d1 = x1 - src[3 * j + 1], d2 = x2 - src[3 * j + 2];
    float r2 = d0 * d0 + d1 * d1 + d2 * d2;
    float phi = r2 * logf(jmax(r2, K(1e-8)));
    oL = oL + cl[j] * phi;
    oa = oa + ca[j] * phi;
    ob = ob + cb[j] * phi;
  }
  v[0] = oL;
  v[1] = oa;
  v[2] = ob;
}

// whether opcode OP reads the pixel's position
template <int OP>
constexpr bool reads_pos() {
  return OP == OP_VIGNETTE || OP == OP_GRADUATEDND;
}

// one stage's body on one pixel: k is the stage's consts, a its ints;
// yy, xx the pixel's row and column (read by the with_pos opcodes only)
template <int OP>
__device__ __forceinline__ void apply(float* v, const float* k, const int* a, float yy,
                                      float xx) {
  if constexpr (OP == OP_EXPOSURE) {
    exposure(v, k);
  } else if constexpr (OP == OP_MATRIX) {
    float t[3] = {v[0], v[1], v[2]};
    mat3(k, t, v);
  } else if constexpr (OP == OP_CHANNELMIXERRGB) {
    channelmixerrgb(v, k, a);
  } else if constexpr (OP == OP_FILMIC_AGX) {
    filmic_agx(v, k, a);
  } else if constexpr (OP == OP_COLOROUT) {
    colorout(v, k, a);
  } else if constexpr (OP == OP_CONVERT_WORK_LAB) {
    convert_work_lab(v, k);
  } else if constexpr (OP == OP_CONVERT_LAB_WORK) {
    convert_lab_work(v, k);
  } else if constexpr (OP == OP_COLORBALANCERGB) {
    colorbalancergb(v, k, a);
  } else if constexpr (OP == OP_RGBCURVE) {
    rgbcurve(v, k, a);
  } else if constexpr (OP == OP_RGBLEVELS) {
    rgblevels(v, k, a);
  } else if constexpr (OP == OP_BASECURVE) {
    basecurve(v, k, a);
  } else if constexpr (OP == OP_TONECURVE) {
    tonecurve(v, k, a);
  } else if constexpr (OP == OP_LEVELS) {
    levels(v, k);
  } else if constexpr (OP == OP_BASICADJ) {
    basicadj(v, k, a);
  } else if constexpr (OP == OP_COLORZONES) {
    colorzones(v, k, a);
  } else if constexpr (OP == OP_NEGADOCTOR) {
    negadoctor(v, k);
  } else if constexpr (OP == OP_VIGNETTE) {
    vignette(v, k, yy, xx);
  } else if constexpr (OP == OP_VELVIA) {
    velvia(v, k);
  } else if constexpr (OP == OP_VIBRANCE) {
    vibrance(v, k);
  } else if constexpr (OP == OP_COLORCONTRAST) {
    colorcontrast(v, k, a);
  } else if constexpr (OP == OP_COLORCORRECTION) {
    colorcorrection(v, k);
  } else if constexpr (OP == OP_COLISA) {
    colisa(v, k, a);
  } else if constexpr (OP == OP_SPLITTONING) {
    splittoning(v, k);
  } else if constexpr (OP == OP_COLORIZE) {
    colorize(v, k);
  } else if constexpr (OP == OP_COLORBALANCE) {
    colorbalance(v, k, a);
  } else if constexpr (OP == OP_SPLITTONINGRGB) {
    splittoningrgb(v, k);
  } else if constexpr (OP == OP_LOWLIGHT) {
    lowlight(v, k, a);
  } else if constexpr (OP == OP_PROFILE_GAMMA) {
    profile_gamma(v, k, a);
  } else if constexpr (OP == OP_COLORCHECKER) {
    colorchecker(v, k, a);
  } else {
    static_assert(OP == OP_GRADUATEDND, "unknown opcode");
    graduatednd(v, k, yy, xx);
  }
}

// The interpreter: any program, one pixel per thread; w is the array's
// width (a with_pos stage's row and column come from the flat index).
__global__ void __launch_bounds__(THREADS)
chain(const float* __restrict__ x, float* __restrict__ y, long long n, int w,
      const int* __restrict__ prog, int nstages, const float* __restrict__ consts,
      int nconsts) {
  __shared__ int sprog[MAX_STAGES * RECORD];
  __shared__ float sk[MAX_CONSTS];
  for (int i = threadIdx.x; i < nstages * RECORD; i += blockDim.x) sprog[i] = prog[i];
  for (int i = threadIdx.x; i < nconsts; i += blockDim.x) sk[i] = consts[i];
  __syncthreads();
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    float v[3] = {x[i], x[n + i], x[2 * n + i]};
    for (int s = 0; s < nstages; ++s) {
      const int* rec = sprog + s * RECORD;
      const float* k = sk + rec[1];
      const int* a = rec + 2;
      float yy = 0.0f, xx = 0.0f;
      if (rec[0] == OP_VIGNETTE || rec[0] == OP_GRADUATEDND) {
        long long r = i / w;
        yy = (float)r;
        xx = (float)(i - r * w);
      }
      switch (rec[0]) {
        case OP_EXPOSURE: apply<OP_EXPOSURE>(v, k, a, yy, xx); break;
        case OP_MATRIX: apply<OP_MATRIX>(v, k, a, yy, xx); break;
        case OP_CHANNELMIXERRGB: apply<OP_CHANNELMIXERRGB>(v, k, a, yy, xx); break;
        case OP_FILMIC_AGX: apply<OP_FILMIC_AGX>(v, k, a, yy, xx); break;
        case OP_COLOROUT: apply<OP_COLOROUT>(v, k, a, yy, xx); break;
        case OP_CONVERT_WORK_LAB: apply<OP_CONVERT_WORK_LAB>(v, k, a, yy, xx); break;
        case OP_CONVERT_LAB_WORK: apply<OP_CONVERT_LAB_WORK>(v, k, a, yy, xx); break;
        case OP_COLORBALANCERGB: apply<OP_COLORBALANCERGB>(v, k, a, yy, xx); break;
        case OP_RGBCURVE: apply<OP_RGBCURVE>(v, k, a, yy, xx); break;
        case OP_RGBLEVELS: apply<OP_RGBLEVELS>(v, k, a, yy, xx); break;
        case OP_BASECURVE: apply<OP_BASECURVE>(v, k, a, yy, xx); break;
        case OP_TONECURVE: apply<OP_TONECURVE>(v, k, a, yy, xx); break;
        case OP_LEVELS: apply<OP_LEVELS>(v, k, a, yy, xx); break;
        case OP_BASICADJ: apply<OP_BASICADJ>(v, k, a, yy, xx); break;
        case OP_COLORZONES: apply<OP_COLORZONES>(v, k, a, yy, xx); break;
        case OP_NEGADOCTOR: apply<OP_NEGADOCTOR>(v, k, a, yy, xx); break;
        case OP_VIGNETTE: apply<OP_VIGNETTE>(v, k, a, yy, xx); break;
        case OP_GRADUATEDND: apply<OP_GRADUATEDND>(v, k, a, yy, xx); break;
        case OP_VELVIA: apply<OP_VELVIA>(v, k, a, yy, xx); break;
        case OP_VIBRANCE: apply<OP_VIBRANCE>(v, k, a, yy, xx); break;
        case OP_COLORCONTRAST: apply<OP_COLORCONTRAST>(v, k, a, yy, xx); break;
        case OP_COLORCORRECTION: apply<OP_COLORCORRECTION>(v, k, a, yy, xx); break;
        case OP_COLISA: apply<OP_COLISA>(v, k, a, yy, xx); break;
        case OP_SPLITTONING: apply<OP_SPLITTONING>(v, k, a, yy, xx); break;
        case OP_COLORIZE: apply<OP_COLORIZE>(v, k, a, yy, xx); break;
        case OP_COLORBALANCE: apply<OP_COLORBALANCE>(v, k, a, yy, xx); break;
        case OP_SPLITTONINGRGB: apply<OP_SPLITTONINGRGB>(v, k, a, yy, xx); break;
        case OP_LOWLIGHT: apply<OP_LOWLIGHT>(v, k, a, yy, xx); break;
        case OP_PROFILE_GAMMA: apply<OP_PROFILE_GAMMA>(v, k, a, yy, xx); break;
        case OP_COLORCHECKER: apply<OP_COLORCHECKER>(v, k, a, yy, xx); break;
        default: break;  // the wrapper admits known opcodes only
      }
    }
    y[i] = v[0];
    y[n + i] = v[1];
    y[2 * n + i] = v[2];
  }
}

// ------------------------------------------------- specialised programs
// A program the configs build gets a kernel of its own: the opcode
// sequence and each stage's const offset are template parameters, so the
// stages are straight-line code with no dispatch, and the consts and ints
// travel by value in the kernel's parameters (a __grid_constant__ struct):
// each use is a constant-bank operand, not a shared-memory load.  The
// ints stay run-time values, uniform across the grid.  One thread per
// pixel: two or four pixels a thread, tried on the card, were slower
// (their data-dependent branches run one after the other, and a warp
// spans more pixels, so it diverges more often).  The forms of configs
// 1-9 fit in 32 registers, so 8 blocks of 256 fill an SM; a program with
// colorbalancergb or colorzones gets 64 (4 blocks) rather than spill.
// The consts may take 4 KB: kernel parameters may hold 32764 bytes since
// CUDA 12.1 on Volta and newer, and config 10's second chain needs 388.
constexpr int FIXED_CONSTS = 1024;

struct FixedArgs {
  const float* x;
  float* y;
  long long n;
  int w;  // the array's width: a with_pos stage's row and column
  int a[MAX_STAGES * STAGE_INTS];
  float k[FIXED_CONSTS];
};

template <int OP, int OFF>
struct Stage {
  static constexpr int op = OP, off = OFF;
};

template <class... S>
struct Prog {
  static constexpr int count = sizeof...(S);
  static constexpr int ops[count] = {S::op...};
  static constexpr int offs[count] = {S::off...};
  static constexpr bool pos = (reads_pos<S::op>() || ...);
  static constexpr int min_blocks =
      ((S::op == OP_COLORBALANCERGB || S::op == OP_COLORZONES) || ...) ? 4 : 8;
};

// stages I.. of P on one pixel
template <class P, int I>
__device__ __forceinline__ void run_from(float* v, const FixedArgs& p, float yy, float xx) {
  if constexpr (I < P::count) {
    apply<P::ops[I]>(v, p.k + P::offs[I], p.a + I * STAGE_INTS, yy, xx);
    run_from<P, I + 1>(v, p, yy, xx);
  }
}

template <class P>
__global__ void __launch_bounds__(THREADS, P::min_blocks)
chain_fixed(const __grid_constant__ FixedArgs p) {
  const long long n = p.n;
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  float v[3] = {p.x[i], p.x[n + i], p.x[2 * n + i]};
  float yy = 0.0f, xx = 0.0f;
  if constexpr (P::pos) {
    long long r = i / p.w;
    yy = (float)r;
    xx = (float)(i - r * p.w);
  }
  run_from<P, 0>(v, p, yy, xx);
  p.y[i] = v[0];
  p.y[n + i] = v[1];
  p.y[2 * n + i] = v[2];
}

// The specialised programs, in the order of kernels/pointwise.py's FIXED
// (the library reports them and the wrapper checks the two agree).
using Fixed = std::tuple<
    // config 1: exposure, colorin, channelmixerrgb, filmicrgb, colorout
    Prog<Stage<OP_EXPOSURE, 0>, Stage<OP_MATRIX, 2>, Stage<OP_CHANNELMIXERRGB, 11>,
         Stage<OP_FILMIC_AGX, 78>, Stage<OP_COLOROUT, 148>>,
    // configs 2 and 4: exposure, colorin, filmicrgb, colorout
    Prog<Stage<OP_EXPOSURE, 0>, Stage<OP_MATRIX, 2>, Stage<OP_FILMIC_AGX, 11>,
         Stage<OP_COLOROUT, 81>>,
    // config 3: exposure; colorin; filmicrgb + to Lab; from Lab + colorout
    // (also config 7's last)
    Prog<Stage<OP_EXPOSURE, 0>>,
    Prog<Stage<OP_MATRIX, 0>>,
    Prog<Stage<OP_FILMIC_AGX, 0>, Stage<OP_CONVERT_WORK_LAB, 70>>,
    Prog<Stage<OP_CONVERT_LAB_WORK, 0>, Stage<OP_COLOROUT, 12>>,
    // config 7: exposure, colorin, to Lab; from Lab, filmicrgb, to Lab
    Prog<Stage<OP_EXPOSURE, 0>, Stage<OP_MATRIX, 2>, Stage<OP_CONVERT_WORK_LAB, 11>>,
    Prog<Stage<OP_CONVERT_LAB_WORK, 0>, Stage<OP_FILMIC_AGX, 12>,
         Stage<OP_CONVERT_WORK_LAB, 82>>,
    // the default pipe without an exposure edit, with and without
    // channelmixerrgb: colorin, [channelmixerrgb,] filmicrgb, colorout
    Prog<Stage<OP_MATRIX, 0>, Stage<OP_CHANNELMIXERRGB, 9>, Stage<OP_FILMIC_AGX, 76>,
         Stage<OP_COLOROUT, 146>>,
    Prog<Stage<OP_MATRIX, 0>, Stage<OP_FILMIC_AGX, 9>, Stage<OP_COLOROUT, 79>>,
    // config 11: exposure, colorin, channelmixerrgb, colorbalance,
    // filmicrgb, to Lab, colisa, colorcontrast, from Lab, velvia, to Lab,
    // vibrance, from Lab, splittoning, colorout
    Prog<Stage<OP_EXPOSURE, 0>, Stage<OP_MATRIX, 2>, Stage<OP_CHANNELMIXERRGB, 11>,
         Stage<OP_COLORBALANCE, 78>, Stage<OP_FILMIC_AGX, 94>, Stage<OP_CONVERT_WORK_LAB, 164>,
         Stage<OP_COLISA, 176>, Stage<OP_COLORCONTRAST, 181>, Stage<OP_CONVERT_LAB_WORK, 187>,
         Stage<OP_VELVIA, 199>, Stage<OP_CONVERT_WORK_LAB, 201>, Stage<OP_VIBRANCE, 213>,
         Stage<OP_CONVERT_LAB_WORK, 214>, Stage<OP_SPLITTONING, 226>, Stage<OP_COLOROUT, 232>>,
    // config 12: exposure, colorin; filmicrgb alone after its highlight
    // reconstruction; to Lab before grain (then config 3's from Lab +
    // colorout)
    Prog<Stage<OP_EXPOSURE, 0>, Stage<OP_MATRIX, 2>>,
    Prog<Stage<OP_FILMIC_AGX, 0>>,
    Prog<Stage<OP_CONVERT_WORK_LAB, 0>>,
    // config 10: exposure, graduatednd, colorin, channelmixerrgb, to Lab;
    // from Lab, colorbalancergb, rgbcurve, filmicrgb, to Lab, tonecurve,
    // colorzones, from Lab, vignette, colorout
    Prog<Stage<OP_EXPOSURE, 0>, Stage<OP_GRADUATEDND, 2>, Stage<OP_MATRIX, 16>,
         Stage<OP_CHANNELMIXERRGB, 25>, Stage<OP_CONVERT_WORK_LAB, 92>>,
    Prog<Stage<OP_CONVERT_LAB_WORK, 0>, Stage<OP_COLORBALANCERGB, 12>, Stage<OP_RGBCURVE, 181>,
         Stage<OP_FILMIC_AGX, 211>, Stage<OP_CONVERT_WORK_LAB, 281>, Stage<OP_TONECURVE, 293>,
         Stage<OP_COLORZONES, 308>, Stage<OP_CONVERT_LAB_WORK, 357>, Stage<OP_VIGNETTE, 369>,
         Stage<OP_COLOROUT, 379>>>;
constexpr int NFIXED = (int)std::tuple_size<Fixed>::value;

template <class P>
int launch_fixed(const float* x, float* y, long long n, int w, const int* ints,
                 const float* consts, int nconsts, cudaStream_t stream) {
  FixedArgs p;
  p.x = x;
  p.y = y;
  p.n = n;
  p.w = w;
  for (int i = 0; i < MAX_STAGES * STAGE_INTS; ++i)
    p.a[i] = i < P::count * STAGE_INTS ? ints[i] : 0;
  for (int i = 0; i < FIXED_CONSTS; ++i) p.k[i] = i < nconsts ? consts[i] : 0.0f;
  long long blocks = (n + THREADS - 1) / THREADS;
  chain_fixed<P><<<(unsigned)blocks, THREADS, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <size_t... I>
int launch_fixed_id(int id, std::index_sequence<I...>, const float* x, float* y, long long n,
                    int w, const int* ints, const float* consts, int nconsts,
                    cudaStream_t stream) {
  int rc = (int)cudaErrorInvalidValue;
  ((id == (int)I ? (rc = launch_fixed<std::tuple_element_t<I, Fixed>>(x, y, n, w, ints, consts,
                                                                      nconsts, stream))
                 : 0),
   ...);
  return rc;
}

template <size_t... I>
int describe_fixed(int id, std::index_sequence<I...>, int* ops, int* offs) {
  int count = -1;
  auto one = [&](auto prog) {
    using P = decltype(prog);
    for (int s = 0; s < P::count; ++s) {
      ops[s] = P::ops[s];
      offs[s] = P::offs[s];
    }
    count = P::count;
  };
  ((id == (int)I ? (one(std::tuple_element_t<I, Fixed>{}), 0) : 0), ...);
  return count;
}

}  // namespace

extern "C" {

int pointwise_chain_record() { return RECORD; }
int pointwise_chain_max_stages() { return MAX_STAGES; }
int pointwise_chain_max_consts() { return MAX_CONSTS; }
int pointwise_chain_fixed_consts() { return FIXED_CONSTS; }
int pointwise_chain_fixed_count() { return NFIXED; }

// specialised program `id`'s opcodes and const offsets into ops and offs
// (MAX_STAGES each); -> its stage count, -1 for an unknown id
int pointwise_chain_fixed_program(int id, int* ops, int* offs) {
  return describe_fixed(id, std::make_index_sequence<NFIXED>{}, ops, offs);
}

// x, y: (3, n) float32 planes of an array w wide; prog: nstages * RECORD
// int32; consts: nconsts float32; all on the device.  Launches the
// interpreter on `stream`, returns cudaGetLastError().
int pointwise_chain(const float* x, float* y, long long n, int w, const int* prog, int nstages,
                    const float* consts, int nconsts, int num_sms, void* stream) {
  if (w < 1 || n % w != 0) return (int)cudaErrorInvalidValue;
  long long blocks = (n + THREADS - 1) / THREADS;
  long long cap = (long long)num_sms * 8;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  chain<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(x, y, n, w, prog, nstages,
                                                               consts, nconsts);
  return (int)cudaGetLastError();
}

// Specialised program `id` on x, y ((3, n) float32 planes of an array w
// wide, on the device); ints (its stages' STAGE_INTS each) and consts
// (nconsts <= FIXED_CONSTS) are host arrays, passed by value.  Returns
// cudaGetLastError().
int pointwise_chain_fixed(int id, const float* x, float* y, long long n, int w, const int* ints,
                          const float* consts, int nconsts, void* stream) {
  if (id < 0 || id >= NFIXED || nconsts > FIXED_CONSTS || n < 1 || w < 1 || n % w != 0)
    return (int)cudaErrorInvalidValue;
  return launch_fixed_id(id, std::make_index_sequence<NFIXED>{}, x, y, n, w, ints, consts,
                         nconsts, (cudaStream_t)stream);
}

}  // extern "C"
