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

import torch

from ..pixel.shifts import PaddedView

MAX_TAPS = 513    # keep in step with csrc/sepblur.cu, which checks them
# a block's TILE_H rows x TILE_W columns; the shared memory a block may
# have on sm_90
TILE_W, TILE_H = 128, 8
MAX_SMEM = 232448

# launches of the CUDA kernel since the count was last set to 0
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


def plan(n: int, dilation: int):
    """(gather, shared bytes) of the kernel's launch for n taps: below
    a dilation of TILE_W the strip of V is contiguous, TILE_W + (n - 1) d
    columns; from TILE_W on it holds only the n groups of TILE_W columns
    that the taps read."""
    gather = dilation >= TILE_W
    cols = n * TILE_W if gather else TILE_W + (n - 1) * dilation
    return gather, 4 * TILE_H * cols


def _lib():
    from . import _build

    lib = _build.load("sepblur")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.sep_blur.argtypes = [p, p, i, i, i, p, i, i, i, i, p]
        lib.sep_blur.restype = ctypes.c_int
        lib.sep_blur_limits.argtypes = [p] * 4
        lib.sep_blur_limits.restype = None
        got = [ctypes.c_int() for _ in range(4)]
        lib.sep_blur_limits(*[ctypes.byref(v) for v in got])
        if [v.value for v in got] != [MAX_TAPS, TILE_W, TILE_H, MAX_SMEM]:
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
    gather, smem = plan(len(taps), dilation)
    if smem > MAX_SMEM:
        raise ValueError(f"sep_blur: {len(taps)} taps at dilation "
                         f"{dilation} need {smem} B of shared memory per "
                         f"block, over {MAX_SMEM}")
    global LAUNCHES
    lib = _lib()
    c = 1 if x.dim() == 2 else x.shape[0]
    h, w = x.shape[-2:]
    out = torch.empty_like(x)
    host_taps = (ctypes.c_float * len(taps))(*taps)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.sep_blur(x.data_ptr(), out.data_ptr(), c, h, w,
                          host_taps, len(taps), dilation, int(gather), smem,
                          stream)
    if rc != 0:
        raise RuntimeError(f"sep_blur: CUDA launch failed ({rc})")
    LAUNCHES += 1
    return out
