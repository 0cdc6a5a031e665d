"""Deriche recursive Gaussian: the CUDA kernel (`csrc/iir.cu`) and its plain
twin.

Both compute what `ansel_tpu/kernels/iir_pallas.py:gaussian_iir_pallas`
computes on the TPU (reference `src/pixel/gaussian.c:150-320`): an
optional clamp, then along each axis, down the columns first, the
second-order forward recursion

    y_i = (a0 x_i + a1 x_{i-1}) - b1 y_{i-1} - b2 y_{i-2},  primed coefp x_0

and the backward one

    z_i = (a2 x_{i+1} + a3 x_{i+2}) - b1 z_{i+1} - b2 z_{i+2}

added to it.  Like the Pallas kernel, the backward recursion starts at
the end of the axis edge-padded to a multiple of 8, primed with
coefn x_last: in float32 that is not quite the same as starting at the
last element.  The coefficients are float32 (`pixel/blur._deriche_coeffs`
gives them in float64, as the JAX package does, and both round them).

`gaussian_iir` launches the kernel for a CUDA tensor and runs
`gaussian_iir_reference` for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._build import COUNT_LOCK

RB = 8  # the Pallas kernel's row block: the backward start is padded to it

# launches of the CUDA kernel since the count was last set to 0
LAUNCHES = 0

# The kernel's launch shape (csrc/iir.cu, which the wrapper checks
# against these): a block is one warp owning LINES adjacent lines, lanes
# 0-15 forward and 16-31 backward; a ring of STAGES chunks of CHUNK steps
# for x and for the partner's values, and one for the results, each
# buffer at most a row of CHUNK + 4 floats a lane.
LINES, THREADS, CHUNK, STAGES = 16, 32, 32, 4
SMEM_BYTES = (2 * STAGES + 1) * THREADS * (CHUNK + 4) * 4

# one recursion step's dependent chain, a multiply and two subtractions
# (--fmad=false), in cycles, and the boost clock
STEP_CYCLES, CLOCK_HZ = 12, 1.98e9


def launch_plan(n: int, h: int, w: int):
    """The two launches of one call: (pass, lines, length, blocks, threads,
    shared bytes), the column pass (n * w lines of h values) then the row
    pass (n * h lines of w)."""
    return [(name, lines, length, -(-lines // LINES), THREADS, SMEM_BYTES)
            for name, lines, length in (("columns", n * w, h),
                                        ("rows", n * h, w))]


def block_lines(block: int, lines: int):
    """(line, backward) of each lane of `block`, None past the last line:
    the kernel's `first + (lane & 15)` and `lane >= 16`."""
    out = []
    for lane in range(THREADS):
        line = block * LINES + lane % LINES
        out.append((line, lane >= LINES) if line < lines else None)
    return out


def latency_floor_ms(h: int, w: int) -> float:
    """Least time of one call at any width: each pass waits for one line's
    chain of steps (the two directions run at once), padded to RB."""
    steps = -(-h // RB) * RB + -(-w // RB) * RB
    return steps * STEP_CYCLES / CLOCK_HZ * 1e3


def _f32(coef):
    return tuple(float(np.float32(c)) for c in coef)


def _forward_reference(v: torch.Tensor, coef) -> list:
    """The forward recursion down axis -2 of an (N, H, W) tensor: y, row
    by row."""
    a0, a1, _, _, b1, b2, coefp, _ = coef
    x0 = v[:, 0]
    xprev, y1 = x0, coefp * x0
    y2 = y1
    ys = []
    for i in range(v.shape[-2]):
        xr = v[:, i]
        f = a0 * xr + a1 * xprev
        y = f - b1 * y1 - b2 * y2
        ys.append(y)
        xprev, y2, y1 = xr, y1, y
    return ys


def _backward_reference(v: torch.Tensor, coef) -> list:
    """The backward recursion down axis -2 of an (N, H, W) tensor, from the
    end padded to a multiple of RB with x_last repeated: z, row by row.
    It reads only v, never the forward recursion's values, which is what
    lets the kernel run the two on different threads."""
    _, _, a2, a3, b1, b2, _, coefn = coef
    h = v.shape[-2]
    xlast = v[:, h - 1]
    xn1 = xn2 = xlast
    z1 = coefn * xlast
    z2 = z1
    zs = [None] * h
    for r in range(-(-h // RB) * RB - 1, -1, -1):
        f = a2 * xn1 + a3 * xn2
        z = f - b1 * z1 - b2 * z2
        if r < h:
            zs[r] = z
        xn2, xn1 = xn1, v[:, min(r, h - 1)]
        z2, z1 = z1, z
    return zs


def _vertical_reference(v: torch.Tensor, coef) -> torch.Tensor:
    """The recursion down axis -2 of an (N, H, W) tensor: y + z, row by
    row."""
    ys = _forward_reference(v, coef)
    zs = _backward_reference(v, coef)
    return torch.stack([y + z for y, z in zip(ys, zs)], dim=1)


def gaussian_iir_reference(x: torch.Tensor, coef, vmin=None,
                           vmax=None) -> torch.Tensor:
    """Plain torch: clamp, the vertical recursion, then the horizontal one
    on the transposed planes."""
    coef = _f32(coef)
    v = x.reshape((-1,) + tuple(x.shape[-2:]))
    if vmin is not None or vmax is not None:
        v = torch.clamp(v, vmin, vmax)
    v = _vertical_reference(v, coef)
    v = _vertical_reference(v.transpose(-1, -2), coef).transpose(-1, -2)
    return v.contiguous().reshape(x.shape)


def _lib():
    from . import _build

    lib = _build.load("iir")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.gaussian_iir.argtypes = [p, p, p, i, i, i, p, f, f, i, p]
        lib.gaussian_iir.restype = ctypes.c_int
        got = (lib.iir_block_lines(), lib.iir_block_threads(),
               lib.iir_block_smem())
        if got != (LINES, THREADS, SMEM_BYTES):
            raise RuntimeError(f"iir.cu launches {got}, the plan says "
                               f"{(LINES, THREADS, SMEM_BYTES)}")
        lib._typed = True
    return lib


def gaussian_iir(x: torch.Tensor, coef, vmin=None, vmax=None) -> torch.Tensor:
    """Deriche blur of an (..., H, W) float32 tensor with the eight
    coefficients (a0, a1, a2, a3, b1, b2, coefp, coefn).  A CPU tensor
    runs the plain version; a CUDA tensor launches csrc/iir.cu."""
    if x.device.type == "cpu":
        return gaussian_iir_reference(x, coef, vmin, vmax)
    if x.device.type != "cuda":
        raise ValueError(f"gaussian_iir: unsupported device {x.device}")
    if (x.dtype != torch.float32 or x.dim() < 2 or not x.is_contiguous()
            or x.numel() == 0):
        raise ValueError("gaussian_iir: needs a contiguous non-empty float32 "
                         f"tensor of 2 or more axes, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if len(coef) != 8:
        raise ValueError(f"gaussian_iir: needs 8 coefficients, got {len(coef)}")
    global LAUNCHES
    lib = _lib()
    h, w = x.shape[-2:]
    n = x.numel() // (h * w)
    clamp = vmin is not None or vmax is not None
    lo = -float("inf") if vmin is None else float(vmin)
    hi = float("inf") if vmax is None else float(vmax)
    tmp = torch.empty_like(x)
    out = torch.empty_like(x)
    host_coef = (ctypes.c_float * 8)(*_f32(coef))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gaussian_iir(x.data_ptr(), tmp.data_ptr(), out.data_ptr(),
                              n, h, w, host_coef, lo, hi, int(clamp), stream)
    if rc != 0:
        raise RuntimeError(f"gaussian_iir: CUDA launch failed ({rc})")
    with COUNT_LOCK:
        LAUNCHES += 1
    return out
