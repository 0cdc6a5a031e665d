#!/usr/bin/env python3
"""The IIR kernel's two ways to add the forward and backward recursions,
timed against each other on one GPU.

    python3 scripts/iir_combine_ab.py

`csrc/iir.cu` adds them in place: before half the padded line each lane
stores its own value, after it each adds the value its partner lane
stored.  The other way writes y and z to separate buffers (the row pass
adding the column pass's two as it loads) and adds them in a trailing
elementwise pass.  This script builds that variant from `csrc/iir.cu` by
replacing the lines that differ (it stops if one is not found, so an
edit of the kernel that moves them shows here), checks it against the
twin bit for bit, and times on config 3's shape, (2, 1376, 2080) with
toneequal's sigma and clamp, both kernels and the variant's parts: its
two passes, and the trailing add as one `torch.add` (the same bytes a
hand-written elementwise kernel moves).  The variant holds two more
(n, h, w) buffers.  Needs a CUDA device.
"""

import ctypes
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ansel_tpu_torch.kernels import _build, iir  # noqa: E402
from ansel_tpu_torch.pixel.blur import _deriche_coeffs  # noqa: E402
from chip_smoke import card_line, median_ms  # noqa: E402

SHAPE, SIGMA, LO, HI = (2, 1376, 2080), 103.25, 0.0, 1.5

# (text in csrc/iir.cu, text of the variant, times it occurs)
EDITS = [
    ("  float* out;\n", "  float* out;\n  float* outz;\n  const float* xz;\n", 1),
    # backward lanes store to their own buffer
    ("      float* qs = out + qbase;",
     "      float* qs = (q >= 4 ? outz : out) + qbase;", 1),
    ("        store4_if(out + row(i) + (k >= 4 ? pb : pf),",
     "        store4_if((k >= 4 ? outz : out) + row(i) + (k >= 4 ? pb : pf),",
     1),
    ("      float* line = out + base;",
     "      float* line = (bwd ? outz : out) + base;", 1),
    ("        store_if(out + row(i) + (i >= LINES ? pb : pf),",
     "        store_if((i >= LINES ? outz : out) + row(i)"
     " + (i >= LINES ? pb : pf),", 1),
    # ADD now means: the input is x + xz
    ("        float cur = rev ? xv[K - 1 - j] : xv[j];",
     "        float cur = ADD ? (rev ? xv[K - 1 - j] : xv[j])"
     " + (rev ? pw[K - 1 - j] : pw[j]) : (rev ? xv[K - 1 - j] : xv[j]);", 1),
    ("        ov[j] = ADD ? y + (rev ? pw[K - 1 - j] : pw[j]) : y;",
     "        ov[j] = y;", 1),
    ("      if (ADD) fetch(out, PS + st * BUF, s_begin + k * K);",
     "      if (ADD) fetch(xz, PS + st * BUF, s_begin + k * K);", 1),
    ("  float xe = x[t.base + (long long)(t.bwd ? len - 1 : 0)"
     " * (COLS ? w : 1)];",
     "  const long long ei = t.base + (long long)(t.bwd ? len - 1 : 0)"
     " * (COLS ? w : 1);\n  float xe = xz ? x[ei] + xz[ei] : x[ei];", 1),
    # one phase over the whole padded line
    ("  t.template phase<false>(0, H);\n  t.template phase<true>(H, t.P);",
     "  (void)H;\n  if (xz)\n    t.template phase<true>(0, t.P);\n  else\n"
     "    t.template phase<false>(0, t.P);", 1),
    ("    iir_pass(const float* __restrict__ x, float* __restrict__ out,"
     " int lines,",
     "    iir_pass(const float* __restrict__ x, const float* xz,"
     " float* __restrict__ out, float* outz, int lines,", 1),
    ("  t.out = out;", "  t.out = out;\n  t.outz = outz;\n  t.xz = xz;", 1),
    ("cudaError_t launch(bool vec, const float* x, float* out, int lines,"
     " int len,",
     "cudaError_t launch(bool vec, const float* x, const float* xz,"
     " float* out, float* outz, int lines, int len,", 1),
    ("        x, out, lines, len, w, plane, c, lo, hi);",
     "        x, xz, out, outz, lines, len, w, plane, c, lo, hi);", 2),
    ("int gaussian_iir(const float* x, float* tmp, float* out, int n, int h,"
     " int w,",
     "int gaussian_iir(const float* x, float* tmp, float* tmpz, float* out,"
     " float* outz, int n, int h, int w,", 1),
    ("launch<true, true>(vec, x, tmp, n * w,",
     "launch<true, true>(vec, x, nullptr, tmp, tmpz, n * w,", 1),
    ("launch<true, false>(vec, x, tmp, n * w,",
     "launch<true, false>(vec, x, nullptr, tmp, tmpz, n * w,", 1),
    ("launch<false, false>(vec, tmp, out, n * h,",
     "launch<false, false>(vec, tmp, tmpz, out, outz, n * h,", 1),
]


def variant_library(tmp):
    src = open(os.path.join(ROOT, "ansel_tpu_torch", "csrc", "iir.cu")).read()
    for old, new, count in EDITS:
        if src.count(old) != count:
            raise SystemExit(f"iir_combine_ab: csrc/iir.cu no longer has "
                             f"{count} of {old!r}")
        src = src.replace(old, new)
    cu, so = os.path.join(tmp, "iir_trailing.cu"), os.path.join(tmp, "lib.so")
    with open(cu, "w") as f:
        f.write(src)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                   check=True)
    lib = ctypes.CDLL(so)
    p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gaussian_iir.argtypes = [p] * 5 + [i, i, i, p, fl, fl, i, p]
    lib.gaussian_iir.restype = ctypes.c_int
    return lib


def main():
    if not torch.cuda.is_available():
        raise SystemExit("iir_combine_ab: no CUDA device")
    card = card_line()
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.rand(SHAPE, generator=gen, device="cuda") * 2.0
    coef = _deriche_coeffs(SIGMA, 0)
    host_coef = (ctypes.c_float * 8)(*iir._f32(coef))
    ty, tz, oy, oz, out = (torch.empty_like(x) for _ in range(5))
    with tempfile.TemporaryDirectory() as tmp:
        lib = variant_library(tmp)

        def passes():
            rc = lib.gaussian_iir(
                x.data_ptr(), ty.data_ptr(), tz.data_ptr(), oy.data_ptr(),
                oz.data_ptr(), *SHAPE, host_coef, LO, HI, 1,
                torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"variant launch failed ({rc})")

        def trailing():
            passes()
            torch.add(oy, oz, out=out)

        trailing()
        want = iir.gaussian_iir_reference(x, coef, LO, HI)
        torch.cuda.synchronize()
        if not (torch.equal(out, want)
                and torch.equal(iir.gaussian_iir(x, coef, LO, HI), want)):
            raise AssertionError("a combine differs from the twin")
        times = [median_ms(fn) for fn in (
            lambda: iir.gaussian_iir(x, coef, LO, HI), trailing, passes,
            lambda: torch.add(oy, oz, out=out),
            lambda: iir.gaussian_iir(x, coef, LO, HI), trailing)]
    print(f"[combine] {SHAPE} sigma {SIGMA} clamp [{LO}, {HI}], both equal "
          f"to the twin bit for bit | ms in place {times[0]:.4f}, trailing "
          f"{times[1]:.4f} (its passes {times[2]:.4f}, its add "
          f"{times[3]:.4f}), in place {times[4]:.4f}, trailing "
          f"{times[5]:.4f} | {card}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
