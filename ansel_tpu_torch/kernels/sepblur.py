"""Dilated separable FIR with edge padding: the CUDA kernel
(`csrc/sepblur.cu`) and its plain twin.

Both compute what `ansel_tpu/kernels/sepblur_pallas.py:sep_blur_pallas`
computes on the TPU, float for float the XLA chain of
`pixel/shifts.sep_filter`:

    V[y, x]   = sum_i t_i * X[clamp(y + (i - r) d), x]      (tap order)
    out[y, x] = sum_j t_j * V[y, clamp(x + (j - r) d)]

over (C, H, W) or (H, W).  `sep_blur` launches the kernel for a CUDA
tensor and runs `sep_blur_reference` for a CPU tensor.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..pixel.shifts import PaddedView
from ._build import COUNT_LOCK

MAX_TAPS = 513    # keep in step with csrc/sepblur.cu, which checks them
# threads of a block, its output rows (at most), the dilation from which
# two passes run, the largest tap count with a template, and the shared
# memory a block may have on sm_90
THREADS, TILE_H, TWO_PASS, MAX_FIXED = 256, 16, 256, 33
MAX_SMEM = 232448

# launches of the CUDA kernel since the count was last set to 0: one per
# call, whether the call runs one kernel (the strip) or two (two passes)
LAUNCHES = 0


def sep_blur_reference(x: torch.Tensor, taps,
                       dilation: int = 1) -> torch.Tensor:
    """Plain torch: the two passes as shifted adds on edge-padded views."""
    taps = [float(t) for t in taps]
    r = (len(taps) - 1) // 2
    m = r * dilation
    pv = PaddedView(x, m)
    v = None
    for i, t in enumerate(taps):
        term = t * pv.at((i - r) * dilation, 0)
        v = term if v is None else v + term
    ph = PaddedView(v, m)
    out = None
    for j, t in enumerate(taps):
        term = t * ph.at(0, (j - r) * dilation)
        out = term if out is None else out + term
    return out


class Plan(NamedTuple):
    """One launch: two passes through a scratch plane, or one kernel over
    a shared strip of V; the output rows and columns of a block, the
    strip's columns, its shared bytes, and whether the tap count has a
    template (on the strip: its vertical window in registers)."""

    two_pass: bool
    rows: int
    cols: int
    strip: int
    smem: int
    fixed: bool


def plan(n: int, dilation: int) -> Plan:
    """The launch for n taps at `dilation`.  From a dilation of TWO_PASS
    on, two passes of one thread per value (a block a row of THREADS
    values).  Below it, a strip of V of the least multiple of THREADS
    columns that holds 2m + TWO_PASS (m = r d), of which a block writes
    the strip less 2m, over rows of one residue class: rows_of(n) for a
    template, else TILE_H, fewer if the strip would pass MAX_SMEM, and 0
    (refused) if one row does."""
    if dilation >= TWO_PASS:
        return Plan(True, 1, THREADS, 0, 0, n == 5)
    reach2 = (n - 1) * dilation
    strip = -(-(reach2 + TWO_PASS) // THREADS) * THREADS
    cols = strip - reach2
    fixed = 3 <= n <= MAX_FIXED
    rows = (rows_of(n) if fixed
            else min(TILE_H, MAX_SMEM // (4 * strip)))
    return Plan(False, rows, cols, strip, 4 * rows * strip, fixed)


def rows_of(n: int) -> int:
    """Rows of a block for a template of n taps (csrc/sepblur.cu
    rows_of): the longer the window, the fewer rows, so that it stays in
    registers and every strip below TWO_PASS fits."""
    return TILE_H if n <= 9 else TILE_H // 2 if n <= 25 else TILE_H // 4


def smem_bytes(launch: Plan, h: int, dilation: int) -> int:
    """The shared bytes of a launch over h rows: the strip for the rows
    of a block, and no more rows than a residue class has."""
    return 4 * launch.strip * min(launch.rows, -(-h // dilation))


def _lib():
    from . import _build

    lib = _build.load("sepblur")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.sep_blur.argtypes = [p, p, p, i, i, i, p, i, i, i, i, p]
        lib.sep_blur.restype = ctypes.c_int
        lib.sep_blur_limits.argtypes = [p] * 6
        lib.sep_blur_limits.restype = None
        got = [ctypes.c_int() for _ in range(6)]
        lib.sep_blur_limits(*[ctypes.byref(v) for v in got])
        if [v.value for v in got] != [MAX_TAPS, THREADS, TILE_H, TWO_PASS,
                                      MAX_FIXED, MAX_SMEM]:
            raise RuntimeError("csrc/sepblur.cu and kernels/sepblur.py "
                               "disagree on MAX_TAPS or the tile")
        lib._typed = True
    return lib


def sep_blur(x: torch.Tensor, taps, dilation: int = 1) -> torch.Tensor:
    """Edge-padded separable blur of a (C, H, W) or (H, W) float32 tensor.
    A CPU tensor runs the plain version; a CUDA tensor launches
    csrc/sepblur.cu."""
    if x.device.type == "cpu":
        return sep_blur_reference(x, taps, dilation)
    if x.device.type != "cuda":
        raise ValueError(f"sep_blur: unsupported device {x.device}")
    if (x.dtype != torch.float32 or x.dim() not in (2, 3)
            or not x.is_contiguous() or x.numel() == 0):
        raise ValueError("sep_blur: needs a contiguous non-empty 2-D or 3-D "
                         f"float32 tensor, got {x.dtype} {tuple(x.shape)}")
    taps = [float(t) for t in taps]
    if len(taps) % 2 != 1 or len(taps) > MAX_TAPS or dilation < 1:
        raise ValueError(f"sep_blur: needs an odd tap count <= {MAX_TAPS} "
                         f"and a dilation >= 1, got {len(taps)} taps at "
                         f"{dilation}")
    launch = plan(len(taps), dilation)
    if launch.rows == 0:
        raise ValueError(f"sep_blur: {len(taps)} taps at dilation "
                         f"{dilation} need {4 * launch.strip} B of shared "
                         f"memory for one row, over {MAX_SMEM}")
    global LAUNCHES
    lib = _lib()
    c = 1 if x.dim() == 2 else x.shape[0]
    h, w = x.shape[-2:]
    out = torch.empty_like(x)
    scratch = torch.empty_like(x) if launch.two_pass else None
    host_taps = (ctypes.c_float * len(taps))(*taps)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.sep_blur(x.data_ptr(), out.data_ptr(),
                          None if scratch is None else scratch.data_ptr(),
                          c, h, w, host_taps, len(taps), dilation,
                          launch.rows, smem_bytes(launch, h, dilation),
                          stream)
    if rc != 0:
        raise RuntimeError(f"sep_blur: CUDA launch failed ({rc})")
    with COUNT_LOCK:
        LAUNCHES += 1
    return out
