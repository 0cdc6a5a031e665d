"""One edge-aware a-trous scale: the CUDA kernel (`csrc/eaw.cu`) and its
plain twin.

Both compute what `ansel_tpu/kernels/eaw_pallas.py:_coarse_pallas`
computes on the TPU (reference `src/pixel/eaw.c`): a 25-tap B3 blur of a
(3, H, W) image at spacing d = 2^scale on the edge-padded frame, each tap
weighted by the colour distance to the centre pixel, accumulated in tap
order.  It returns the coarse image and the detail x - coarse.

  * variant 0, "dn" (eaw_dn_decompose + dn_weight, eaw.c:181-195): one
    weight shared across channels, w = k * fast_mexp2f(max(0, |drgb|^2
    * const * 0.02 - 9)); coarse = num * (1 / max(den, 1e-12)).
  * variant 1, "atrous" (eaw_decompose, eaw.c:29-42): w0 = k *
    dt_fast_expf(-(d0^2) * const) for channel 0 and one chroma weight
    wc = k * dt_fast_expf(-(d1^2 + d2^2) * const) for channels 1 and 2;
    coarse = num / max(den, 1e-9).

Like the Pallas kernel, the dn variant multiplies by the inverse where
the JAX package's XLA path divides.  `eaw_dn_coarse` and
`eaw_atrous_coarse` launch the kernel for a CUDA tensor and run
`eaw_coarse_reference` for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from ..pixel.fastmath import dt_fast_expf, fast_mexp2f
from ..pixel.shifts import PaddedView
from ._build import COUNT_LOCK

B3 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)
DN, ATROUS = 0, 1
# keep in step with csrc/eaw.cu, which checks them: threads of a block, its
# output columns and rows (of one residue class mod d), and the shared
# memory a block may have on sm_90
THREADS, TILE_W, TILE_H = 256, 64, 8
MAX_SMEM = 232448

# launches of the CUDA kernel since the count was last set to 0
LAUNCHES = 0


def eaw_coarse_reference(x: torch.Tensor, scale: int, const: float,
                         variant: int):
    """Plain torch: (3, H, W) -> (coarse, detail)."""
    d = 1 << scale
    pv = PaddedView(x, 2 * d)
    x0, x1, x2 = x[0], x[1], x[2]
    num = torch.zeros_like(x)
    den = torch.zeros_like(x0 if variant == DN else x)
    for iy in range(5):
        for ix in range(5):
            s = pv.at((iy - 2) * d, (ix - 2) * d)
            e0, e1, e2 = s[0] - x0, s[1] - x1, s[2] - x2
            k = B3[iy] * B3[ix]
            if variant == DN:
                dist2 = e0 * e0 + e1 * e1 + e2 * e2
                w = k * fast_mexp2f(
                    torch.clamp(dist2 * const * 0.02 - 9.0, min=0.0))
                num = num + w * s
                den = den + w
            else:
                w0 = k * dt_fast_expf(-(e0 * e0) * const)
                wc = k * dt_fast_expf(-(e1 * e1 + e2 * e2) * const)
                wgt = torch.stack([w0, wc, wc])
                num = num + wgt * s
                den = den + wgt
    if variant == DN:
        coarse = num * (1.0 / torch.clamp(den, min=1e-12))
    else:
        coarse = num / torch.clamp(den, min=1e-9)
    return coarse, x - coarse


def plan(scale: int):
    """(gather, shared bytes) of the launch at d = 2^scale: TILE_H + 4
    staged rows of (r, g, b, 0) float4s over TILE_W + 4d contiguous
    columns below d = TILE_W, over the five groups of TILE_W columns the
    taps read from there on."""
    d = 1 << scale
    gather = d >= TILE_W
    cols = 5 * TILE_W if gather else TILE_W + 4 * d
    return gather, 16 * (TILE_H + 4) * cols


def _lib():
    from . import _build

    lib = _build.load("eaw")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.eaw_coarse.argtypes = [p, p, p, i, i, i, ctypes.c_float, i, i, p]
        lib.eaw_coarse.restype = ctypes.c_int
        lib.eaw_limits.argtypes = [p] * 4
        lib.eaw_limits.restype = None
        got = [ctypes.c_int() for _ in range(4)]
        lib.eaw_limits(*[ctypes.byref(v) for v in got])
        if [v.value for v in got] != [THREADS, TILE_W, TILE_H, MAX_SMEM]:
            raise RuntimeError("csrc/eaw.cu and kernels/eaw.py disagree on "
                               "the tile")
        lib._typed = True
    return lib


def _coarse(x: torch.Tensor, scale: int, const, variant: int):
    if x.device.type == "cpu":
        return eaw_coarse_reference(x, scale, float(const), variant)
    if x.device.type != "cuda":
        raise ValueError(f"eaw: unsupported device {x.device}")
    if (x.dtype != torch.float32 or x.dim() != 3 or x.shape[0] != 3
            or not x.is_contiguous() or x.numel() == 0):
        raise ValueError("eaw: needs a contiguous non-empty (3, H, W) "
                         f"float32 tensor, got {x.dtype} {tuple(x.shape)}")
    if not 0 <= scale <= 24:
        raise ValueError(f"eaw: scale {scale} outside [0, 24]")
    _, smem = plan(scale)
    global LAUNCHES
    lib = _lib()
    _, h, w = x.shape
    coarse = torch.empty_like(x)
    detail = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.eaw_coarse(x.data_ptr(), coarse.data_ptr(),
                            detail.data_ptr(), h, w, 1 << scale,
                            float(const), variant, smem, stream)
    if rc != 0:
        raise RuntimeError(f"eaw: CUDA launch failed ({rc})")
    with COUNT_LOCK:
        LAUNCHES += 1
    return coarse, detail


def eaw_dn_coarse(x: torch.Tensor, scale: int, inv_sigma2):
    """(3, H, W) -> (coarse, detail), denoiseprofile weights."""
    return _coarse(x, scale, inv_sigma2, DN)


def eaw_atrous_coarse(x: torch.Tensor, scale: int, sharpen):
    """(3, H, W) -> (coarse, detail), atrous-equalizer weights."""
    return _coarse(x, scale, sharpen, ATROUS)
