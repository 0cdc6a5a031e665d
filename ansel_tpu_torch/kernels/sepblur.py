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

MAX_TAPS = 513    # keep in step with csrc/sepblur.cu
MAX_REACH = 256   # r * d

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


def _lib():
    from . import _build

    lib = _build.load("sepblur")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.sep_blur.argtypes = [p, p, i, i, i, p, i, i, p]
        lib.sep_blur.restype = ctypes.c_int
        lib.sep_blur_max_taps.argtypes = []
        lib.sep_blur_max_taps.restype = ctypes.c_int
        if lib.sep_blur_max_taps() != MAX_TAPS:
            raise RuntimeError("csrc/sepblur.cu and kernels/sepblur.py "
                               "disagree on MAX_TAPS")
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
    r = (len(taps) - 1) // 2
    if len(taps) % 2 != 1 or len(taps) > MAX_TAPS:
        raise ValueError(f"sep_blur: needs an odd tap count <= {MAX_TAPS}, "
                         f"got {len(taps)}")
    if dilation < 1 or r * dilation > MAX_REACH:
        raise ValueError(f"sep_blur: reach r*d = {r}*{dilation} outside "
                         f"[0, {MAX_REACH}]")
    global LAUNCHES
    lib = _lib()
    c = 1 if x.dim() == 2 else x.shape[0]
    h, w = x.shape[-2:]
    out = torch.empty_like(x)
    host_taps = (ctypes.c_float * len(taps))(*taps)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.sep_blur(x.data_ptr(), out.data_ptr(), c, h, w,
                          host_taps, len(taps), dilation, stream)
    if rc != 0:
        raise RuntimeError(f"sep_blur: CUDA launch failed ({rc})")
    LAUNCHES += 1
    return out
