// Deriche recursive Gaussian (orders 0-2) for Hopper (sm_90a).
//
// Replaces: ansel_tpu/kernels/iir_pallas.py:gaussian_iir_pallas (the
// pallas_call in _iir_vertical, whose _kernel runs the vertical recursion
// and which the horizontal axis reuses around an XLA transpose pair).
// Per line of an (n, h, w) float32 stack, optionally clamped first:
//   forward   y_i = (a0 x_i + a1 x_{i-1}) - b1 y_{i-1} - b2 y_{i-2},
//             primed with y_{-1} = y_{-2} = coefp x_0, x_{-1} = x_0;
//   backward  z_i = (a2 x_{i+1} + a3 x_{i+2}) - b1 z_{i+1} - b2 z_{i+2},
//             started at the end of the line edge-padded to a multiple of 8
//             (the Pallas kernel's row block) with z = coefn x_last and
//             x_last repeated past the end;
//   out_i = y_i + z_i.
// Columns first (down each column), then rows, as the Pallas wrapper does.
// Operand order follows its _kernel term by term and the library is built
// with --fmad=false, so kernel and plain twin (kernels/iir.py) agree bit
// for bit.
//
// What bounds it: not the bytes (toneequal's (2, 1376, 2080) pair at
// 45 MP moves 46 MB per call, 0.0137 ms at 3.35 TB/s) but the
// recursion's latency.  A step depends on the one before through a
// multiply and two subtractions (b1 y1, then f - that, then - b2 y2), ~12
// cycles without fused multiply-adds, and splitting a line would change
// its float32 rounding.  With the two directions on separate threads a
// pass takes one line's steps: (1376 + 2080) x 12 cycles at 1.98 GHz =
// 0.021 ms for the pair, the floor that kernels/iir.latency_floor_ms
// states.  The pair has only 4160 (columns) or 2752 (rows) lines, so
// each SM holds one or two warps, and nothing fills the chain's gaps but
// the warp's own copies and the step's other instructions.
//
// Design:
// - Forward and backward on different lanes.  The backward recursion
//   reads only x, so both run at once; a warp (one block) owns 16
//   adjacent lines, lanes 0-15 forward and 16-31 backward on the same
//   lines.  That halves each thread's chain and gives the pair 260 and
//   172 blocks (kernels/iir.launch_plan), so every SM works in both passes.
// - Both directions take the same instructions: step s of a lane is
//   position s forward or P - 1 - s backward (P the 8-padded length),
//   f = A u + B v with (A, B, u, v) = (a0, a1, x_s, x_{s-1}) forward and
//   (a2, a3, x_{i+1}, x_{i+2}) backward, picked by selects.
// - The combine in place.  For s < P / 2 each lane is the first to reach
//   its position and stores its own value; from P / 2 on, each reaches
//   positions its partner lane stored, loads the partner's value and
//   stores the sum (a float add commutes, so y + z either way).  The
//   output buffer is the scratch: no y or z array, and one barrier of the
//   warp between the halves.
// - Chunks of 32 steps staged in shared memory through a ring of four
//   cp.async stages, so chunk i + 3 is in flight while chunk i recurses;
//   results go back through shared memory the same way.  Where w is a
//   multiple of 4 (and the planes 16-byte aligned) the copies and stores
//   are 16 bytes: in the column pass 4 adjacent lines at a position, in
//   the row pass 4 positions of a line, each lane's chunk a row of 36
//   floats read as float4 without bank conflicts.  Otherwise they are 4
//   bytes, one step of all lanes (columns) or 32 steps of one lane (rows)
//   a warp instruction.
// - A step reads its chunk from registers (all 32 values loaded first),
//   so no shared load waits behind the store of the step before; stores
//   whose test differs between lanes are predicated instructions, not
//   branches (a divergent branch and its reconvergence a store cost more
//   than the store).
// - The column pass writes its y + z to the scratch plane (L2-resident at
//   this size), which the row pass reads.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int RB = 8;        // the Pallas row block: the backward start's pad
constexpr int LANES = 32;
constexpr int LINES = 16;    // lines a warp owns, in both directions
constexpr int K = 32;        // steps a chunk
constexpr int KP = K + 1;    // 4-byte form: a lane's row in a buffer
constexpr int RS = K + 4;    // 16-byte row pass: a lane's row in a buffer
constexpr int BUF = LANES * RS;  // floats of a chunk buffer, any form
constexpr int STAGES = 4;
// shared memory: the x ring, the partner ring, the results
constexpr int XS = 0, PS = STAGES * BUF, OS = 2 * STAGES * BUF;
constexpr int SMEM_BYTES = (2 * STAGES + 1) * BUF * (int)sizeof(float);

struct Coef {
  float a0, a1, a2, a3, b1, b2, coefp, coefn;
};

// jnp.clip: NaN stays NaN
__device__ __forceinline__ float clip(float v, float lo, float hi) {
  if (v != v) return v;
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// 16 bytes where ok, as one predicated copy (see store_if)
__device__ __forceinline__ void cp_async16_if(float* dst, const float* src,
                                              bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n"
      " @q cp.async.cg.shared.global [%0], [%1], 16;\n}\n" ::"r"(d),
      "l"(src), "r"((int)ok)
      : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// *p = v where ok, as one predicated store: a branch around each store
// costs the warp a divergence and a reconvergence, as the lanes' tests
// differ
__device__ __forceinline__ void store_if(float* p, float v, bool ok) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n"
      " @q st.global.f32 [%0], %1;\n}\n" ::"l"(p),
      "f"(v), "r"((int)ok)
      : "memory");
}

__device__ __forceinline__ void store4_if(float* p, float4 v, bool ok) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %5, 0;\n"
      " @q st.global.v4.f32 [%0], {%1, %2, %3, %4};\n}\n" ::"l"(p),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"((int)ok)
      : "memory");
}

// One pass over `lines` lines of `len` values.  COLS: the column pass,
// line l = plane l / w, column l % w, values w apart, so neighbouring
// lines are neighbouring addresses.  Else the row pass: line l starts at
// l * len and its values are contiguous.  A lane's step s is position s
// forward, P - 1 - s backward.
//
// VEC (w a multiple of 4, the arrays 16-byte aligned): 16-byte copies of
// 4 lines at a position (COLS; a buffer holds a step's 16 forward and 16
// backward lines in a row of 32 floats) or of 4 positions of a line (row
// pass; a buffer holds each lane's 32 positions in ascending order in a
// row of RS floats, read as float4, conflict-free).  Pieces outside the
// line are not copied; the positions past the end that the backward
// recursion reads get x_last in shared memory.  Else 4-byte copies with
// the positions clamped into the line, one step of all lanes (COLS) or 32
// steps of one lane (rows) per warp instruction, into rows of KP floats a
// lane.
template <bool COLS, bool CLAMP, bool VEC>
struct Pass {
  const float* x;
  float* out;
  int lane, first, lines, len, w, P, lmax;
  bool bwd, mine;    // backward lane; its line exists
  long long base;    // first value of this lane's line (the last line's
                     // past the end)
  bool qok;          // VEC COLS: the 4 lines this thread copies exist
  long long qbase;   // and the first value of the first of them
  float A, B, b1, b2, lo, hi, xe;
  float x1, x2, y1, y2;  // the recursion's state

  // row pass: first value of lane i's line
  __device__ long long row(int i) const {
    return (long long)(first + min(i & (LINES - 1), lmax)) * len;
  }

  // chunk s0 of src into the shared buffer at dst
  __device__ void fetch(const float* src, int dst, int s0) const {
    extern __shared__ float smem[];
    if (VEC && COLS) {
      // thread t: lines 4 (t % 4) on, forward (t % 8 < 4) or backward, at
      // steps t / 8 + 4 k
      const int q = lane & 7, jt = lane >> 3;
      const float* qs = src + qbase;
#pragma unroll
      for (int k = 0; k < K / 4; ++k) {
        const int j = jt + 4 * k;
        const int p = q >= 4 ? P - 1 - s0 - j : s0 + j;
        cp_async16_if(smem + dst + j * LANES + 4 * q, qs + (long long)p * w,
                      qok && p >= 0 && p < len);
      }
    } else if (VEC) {
      // thread t: positions 4 (t % 8) on of the chunks of lanes t / 8 + 4 k
      // (backward from k = 4 on)
      const int q = lane & 7, jt = lane >> 3;
      const int pf = s0 + 4 * q, pb = P - K - s0 + 4 * q;
#pragma unroll
      for (int k = 0; k < K / 4; ++k) {
        const int i = jt + 4 * k;
        const int p = k >= 4 ? pb : pf;
        cp_async16_if(smem + dst + i * RS + 4 * q, src + row(i) + p,
                      p >= 0 && p < len && (i & (LINES - 1)) <= lmax);
      }
    } else if (COLS) {
      // positions clamped into the line (past the end the backward
      // recursion reads x_last; what a forward step past it or an unused
      // tail reads is never kept)
      const float* line = src + base;
      const int p0 = bwd ? P - 1 - s0 : s0, d = bwd ? -1 : 1;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int p = min(max(p0 + d * j, 0), len - 1);
        cp_async4(smem + dst + lane * KP + j, line + (long long)p * w);
      }
    } else {
      const int pf = min(s0 + lane, len - 1);
      const int pb = max(min(P - 1 - s0 - lane, len - 1), 0);
#pragma unroll
      for (int i = 0; i < LANES; ++i)
        cp_async4(smem + dst + i * KP + lane,
                  src + row(i) + (i >= LINES ? pb : pf));
    }
  }

  // VEC: the positions past the end that the backward lanes read in the
  // chunk at step 0 (no piece copies them) get x_last
  __device__ void fill_end(int dst) const {
    extern __shared__ float smem[];
    if (!bwd) return;
    for (int j = 0; j < P - len; ++j)
      smem[dst + (COLS ? j * LANES + lane : lane * RS + K - 1 - j)] = xe;
  }

  // the chunk's n results from the results buffer to the output, where
  // inside the line
  __device__ void store(int s0, int n) const {
    extern __shared__ float smem[];
    if (VEC && COLS) {
      const int q = lane & 7, jt = lane >> 3;
      float* qs = out + qbase;
#pragma unroll
      for (int k = 0; k < K / 4; ++k) {
        const int j = jt + 4 * k;
        const int p = q >= 4 ? P - 1 - s0 - j : s0 + j;
        store4_if(qs + (long long)p * w,
                  *reinterpret_cast<const float4*>(smem + OS + j * LANES + 4 * q),
                  qok && j < n && p >= 0 && p < len);
      }
    } else if (VEC) {
      // forward: steps 4 q .. 4 q + 3; backward: K - 4 - 4 q .. K - 1 - 4 q
      const int q = lane & 7, jt = lane >> 3;
      const int pf = s0 + 4 * q, pb = P - K - s0 + 4 * q;
      const bool sf = 4 * q < n && pf < len;
      const bool sb = K - 4 * q <= n && pb >= 0 && pb < len;
#pragma unroll
      for (int k = 0; k < K / 4; ++k) {
        const int i = jt + 4 * k;
        store4_if(out + row(i) + (k >= 4 ? pb : pf),
                  *reinterpret_cast<const float4*>(smem + OS + i * RS + 4 * q),
                  (k >= 4 ? sb : sf) && (i & (LINES - 1)) <= lmax);
      }
    } else if (COLS) {
      float* line = out + base;
      const int p0 = bwd ? P - 1 - s0 : s0, d = bwd ? -1 : 1;
      // forward: s0 + j < len; backward: P - 1 - s0 - j < len
      const int jlo = bwd ? P - s0 - len : 0;
      const int jhi = !mine ? 0 : bwd ? n : min(n, len - s0);
#pragma unroll
      for (int j = 0; j < K; ++j)
        store_if(line + (long long)(p0 + d * j) * w, smem[OS + lane * KP + j],
                 j >= jlo && j < jhi);
    } else {
      const int pf = s0 + lane, pb = P - 1 - s0 - lane;
      const bool sf = lane < n && pf < len;
      const bool sb = lane < n && pb < len;
#pragma unroll
      for (int i = 0; i < LANES; ++i)
        store_if(out + row(i) + (i >= LINES ? pb : pf), smem[OS + i * KP + lane],
                 (i >= LINES ? sb : sf) && (i & (LINES - 1)) <= lmax);
    }
  }

  // step j's value in buffer b: this lane's
  __device__ float at(int b, int j) const {
    extern __shared__ float smem[];
    return smem[b + (VEC && COLS ? j * LANES + lane : lane * KP + j)];
  }

  // n steps of stage st into the results buffer (adding the partner's
  // values when ADD): the chunk's values into registers first, so no load
  // waits behind a store of a step before it
  template <bool ADD, bool FULL>
  __device__ void steps(int st, int n) {
    extern __shared__ float smem[];
    const int xb = XS + st * BUF, pb = PS + st * BUF;
    float xv[K], pw[K], ov[K];
    if (VEC && !COLS) {
      // a lane's row in ascending positions: backward steps read it from
      // the end
#pragma unroll
      for (int e = 0; e < K; e += 4) {
        const float4 v = *reinterpret_cast<const float4*>(smem + xb + lane * RS + e);
        xv[e] = v.x, xv[e + 1] = v.y, xv[e + 2] = v.z, xv[e + 3] = v.w;
        if (ADD) {
          const float4 u = *reinterpret_cast<const float4*>(smem + pb + lane * RS + e);
          pw[e] = u.x, pw[e + 1] = u.y, pw[e + 2] = u.z, pw[e + 3] = u.w;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        xv[j] = at(xb, j);
        if (ADD) pw[j] = at(pb, j);
      }
    }
    const bool rev = VEC && !COLS && bwd;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (FULL || j < n) {
        float cur = rev ? xv[K - 1 - j] : xv[j];
        if (CLAMP) cur = clip(cur, lo, hi);
        const float u = bwd ? x1 : cur;
        const float v = bwd ? x2 : x1;
        const float f = A * u + B * v;
        const float y = f - b1 * y1 - b2 * y2;
        x2 = x1;
        x1 = cur;
        y2 = y1;
        y1 = y;
        ov[j] = ADD ? y + (rev ? pw[K - 1 - j] : pw[j]) : y;
        if (!(VEC && !COLS))
          smem[OS + (VEC ? j * LANES + lane : lane * KP + j)] = ov[j];
      }
    }
    if (VEC && !COLS) {
      // back in ascending positions (what no step wrote is not stored)
#pragma unroll
      for (int e = 0; e < K; e += 4) {
        float4 v;
        v.x = rev ? ov[K - 1 - e] : ov[e];
        v.y = rev ? ov[K - 2 - e] : ov[e + 1];
        v.z = rev ? ov[K - 3 - e] : ov[e + 2];
        v.w = rev ? ov[K - 4 - e] : ov[e + 3];
        *reinterpret_cast<float4*>(smem + OS + lane * RS + e) = v;
      }
    }
  }

  // steps [s_begin, s_end) in chunks through the ring.  ADD (from P / 2
  // on): each position's value is added to the one its partner lane
  // stored before P / 2.
  template <bool ADD>
  __device__ void phase(int s_begin, int s_end) {
    const int nch = (s_end - s_begin + K - 1) / K;
    auto fetch_chunk = [&](int k) {
      const int st = k % STAGES;
      fetch(x, XS + st * BUF, s_begin + k * K);
      if (ADD) fetch(out, PS + st * BUF, s_begin + k * K);
    };
#pragma unroll
    for (int k = 0; k < STAGES - 1; ++k) {
      if (k < nch) fetch_chunk(k);
      cp_commit();
    }
#pragma unroll 1
    for (int ch = 0; ch < nch; ++ch) {
      if (ch + STAGES - 1 < nch) fetch_chunk(ch + STAGES - 1);
      cp_commit();
      cp_wait<STAGES - 1>();
      __syncwarp();
      const int s0 = s_begin + ch * K;
      const int n = min(K, s_end - s0);  // a multiple of 4
      // each lane fills and then reads only its own slots
      if (VEC && s0 == 0) fill_end(XS + (ch % STAGES) * BUF);
      if (n == K)
        steps<ADD, true>(ch % STAGES, n);
      else
        steps<ADD, false>(ch % STAGES, n);
      __syncwarp();
      store(s0, n);
      __syncwarp();
    }
    cp_wait<0>();
    // the stores before P / 2 are seen by the partner lanes' copies after,
    // which read through L2 (a fence at device scope, once a pass)
    __threadfence();
    __syncwarp();
  }
};

template <bool COLS, bool CLAMP, bool VEC>
__global__ void __launch_bounds__(LANES)
    iir_pass(const float* __restrict__ x, float* __restrict__ out, int lines,
             int len, int w, long long plane, const Coef c, float lo,
             float hi) {
  Pass<COLS, CLAMP, VEC> t;
  t.x = x;
  t.out = out;
  t.lane = threadIdx.x;
  t.bwd = t.lane >= LINES;
  t.first = blockIdx.x * LINES;
  t.lines = lines;
  t.len = len;
  t.w = w;
  t.P = (len + RB - 1) / RB * RB;
  t.lmax = lines - 1 - t.first;
  const int my = t.first + (t.lane & (LINES - 1));
  t.mine = my < lines;
  const int ml = min(my, lines - 1);
  t.base = COLS ? (long long)(ml / w) * plane + ml % w : (long long)ml * len;
  const int ql = t.first + 4 * (t.lane & 3);  // VEC COLS: lines of 4
  t.qok = ql < lines;
  const int qc = max(min(ql, lines - 4), 0);
  t.qbase = (long long)(qc / w) * plane + qc % w;
  t.A = t.bwd ? c.a2 : c.a0;
  t.B = t.bwd ? c.a3 : c.a1;
  t.b1 = c.b1;
  t.b2 = c.b2;
  t.lo = lo;
  t.hi = hi;
  // the state, primed by the edge value
  float xe = x[t.base + (long long)(t.bwd ? len - 1 : 0) * (COLS ? w : 1)];
  if (CLAMP) xe = clip(xe, lo, hi);
  t.xe = xe;
  t.x1 = t.x2 = xe;
  t.y1 = t.y2 = (t.bwd ? c.coefn : c.coefp) * xe;
  const int H = t.P / 2;
  t.template phase<false>(0, H);
  t.template phase<true>(H, t.P);
}

template <bool COLS, bool CLAMP>
cudaError_t launch(bool vec, const float* x, float* out, int lines, int len,
                   int w, long long plane, const Coef& c, float lo, float hi,
                   cudaStream_t s) {
  const int blocks = (lines + LINES - 1) / LINES;
  if (vec)
    iir_pass<COLS, CLAMP, true><<<blocks, LANES, SMEM_BYTES, s>>>(
        x, out, lines, len, w, plane, c, lo, hi);
  else
    iir_pass<COLS, CLAMP, false><<<blocks, LANES, SMEM_BYTES, s>>>(
        x, out, lines, len, w, plane, c, lo, hi);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shape of a pass's launch: lines a block owns, threads and shared bytes
// of a block (kernels/iir.launch_plan checks them against its own).
int iir_block_lines() { return LINES; }
int iir_block_threads() { return LANES; }
int iir_block_smem() { return SMEM_BYTES; }

// x, tmp, out: (n, h, w) float32 on the device, distinct; coef: the eight
// float32 coefficients (a0, a1, a2, a3, b1, b2, coefp, coefn) in host
// memory; with clamp != 0 the input is first clamped to [lo, hi].  The
// column pass writes tmp, the row pass reads it and writes out.  Launches
// on `stream`, returns cudaGetLastError().
int gaussian_iir(const float* x, float* tmp, float* out, int n, int h, int w,
                 const float* coef, float lo, float hi, int clamp,
                 void* stream) {
  if (n < 1 || h < 1 || w < 1) return (int)cudaErrorInvalidValue;
  const Coef c = {coef[0], coef[1], coef[2], coef[3],
                  coef[4], coef[5], coef[6], coef[7]};
  const long long plane = (long long)h * w;
  cudaStream_t s = (cudaStream_t)stream;
  // 16-byte copies where every row starts 16-byte aligned
  const bool vec = w % 4 == 0 && ((size_t)x | (size_t)tmp | (size_t)out) % 16 == 0;
  // columns: n * w lines of h values, w apart
  cudaError_t err =
      clamp ? launch<true, true>(vec, x, tmp, n * w, h, w, plane, c, lo, hi, s)
            : launch<true, false>(vec, x, tmp, n * w, h, w, plane, c, lo, hi, s);
  if (err != cudaSuccess) return (int)err;
  // rows: n * h lines of w contiguous values
  return (int)launch<false, false>(vec, tmp, out, n * h, w, w, plane, c, lo,
                                   hi, s);
}

}  // extern "C"
