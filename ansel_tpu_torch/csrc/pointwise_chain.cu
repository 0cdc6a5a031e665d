// Fused per-pixel colour chain for Hopper (sm_90a).
//
// Replaces: ansel_tpu/kernels/pointwise.py:pallas_pointwise as the engine
// uses it (ansel_tpu/pipeline/engine.py:509-565): one pass over a
// (3, H, W) float32 image that runs every stage of a fused group.  The
// Pallas kernel takes an arbitrary traced Python function; here each
// stage body is written out once below and the group is a small program:
// per stage an opcode, an offset into a float32 consts buffer and up to
// eight static ints (kernels/pointwise.py packs it).
//
// What bounds it: device memory.  3 planes are read and 3 written, 577 MB
// at 24 MP; the AgX stage is a few hundred flops per pixel, far below the
// card's fp32 rate.
//
// Design: one thread per pixel in a grid-stride loop; a pixel's r, g, b
// are three coalesced loads from the planes, stay in registers through
// the whole program and are stored once.  The program and consts are
// copied to shared memory at block start; every thread runs the same
// program, so the `switch` never diverges inside a warp.
//
// Numbers: each body keeps the operand order of the JAX reference
// (ansel_tpu/ops/*.py), constants the reference writes as Python floats
// are rounded to float32 from their float64 value (K), and the library is
// built with --fmad=false.  jnp.maximum/minimum/clip propagate NaN where
// fmaxf/fminf drop it, so jmax/jmin below propagate it too.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

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
};
enum Trc { TRC_SRGB = 0, TRC_LINEAR = 1, TRC_GAMMA = 2 };
constexpr int MAX_STAGES = 16;
constexpr int RECORD = 10;  // opcode, const offset, 8 static ints
constexpr int MAX_CONSTS = 1024;
constexpr int THREADS = 256;

#define K(v) ((float)(v))  // a Python float constant, rounded to float32

constexpr float NORM_MIN = 1.52587890625e-05f;
constexpr double YRG_RW = 0.21902143;
constexpr double YRG_GW = 0.54371398;
constexpr double CIE_Y_2006 = 1.05785528;

__device__ __forceinline__ float jmax(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}
__device__ __forceinline__ float jmin(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
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
__device__ void exposure(float* v, const float* k) {
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

__device__ void channelmixerrgb(float* v, const float* k, const int* a) {
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

__device__ void filmic_agx(float* v, const float* k, const int* a) {
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
__device__ void colorout(float* v, const float* k, const int* a) {
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

__device__ void convert_work_lab(float* v, const float* k) {
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

__device__ void convert_lab_work(float* v, const float* k) {
  float fy = (v[0] + 16.0f) / 116.0f;
  float f[3] = {fy + v[1] / 500.0f, fy, fy - v[2] / 200.0f};
  float xyz[3];
  for (int i = 0; i < 3; ++i) {
    float f3 = f[i] * f[i] * f[i];
    xyz[i] = (f3 > K(LAB_EPS) ? f3 : (116.0f * f[i] - 16.0f) / K(LAB_KAPPA)) * k[9 + i];
  }
  mat3(k, xyz, v);
}

__global__ void __launch_bounds__(THREADS)
chain(const float* __restrict__ x, float* __restrict__ y, long long n,
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
      switch (rec[0]) {
        case OP_EXPOSURE: exposure(v, k); break;
        case OP_MATRIX: {
          float t[3] = {v[0], v[1], v[2]};
          mat3(k, t, v);
          break;
        }
        case OP_CHANNELMIXERRGB: channelmixerrgb(v, k, a); break;
        case OP_FILMIC_AGX: filmic_agx(v, k, a); break;
        case OP_COLOROUT: colorout(v, k, a); break;
        case OP_CONVERT_WORK_LAB: convert_work_lab(v, k); break;
        case OP_CONVERT_LAB_WORK: convert_lab_work(v, k); break;
        default: break;  // the wrapper admits known opcodes only
      }
    }
    y[i] = v[0];
    y[n + i] = v[1];
    y[2 * n + i] = v[2];
  }
}

}  // namespace

extern "C" {

int pointwise_chain_record() { return RECORD; }
int pointwise_chain_max_stages() { return MAX_STAGES; }
int pointwise_chain_max_consts() { return MAX_CONSTS; }

// x, y: (3, n) float32 planes; prog: nstages * RECORD int32; consts:
// nconsts float32; all on the device.  Launches on `stream`, returns
// cudaGetLastError().
int pointwise_chain(const float* x, float* y, long long n, const int* prog, int nstages,
                    const float* consts, int nconsts, int num_sms, void* stream) {
  long long blocks = (n + THREADS - 1) / THREADS;
  long long cap = (long long)num_sms * 8;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  chain<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(x, y, n, prog, nstages, consts,
                                                               nconsts);
  return (int)cudaGetLastError();
}

}  // extern "C"
