"""The lens warp: the CUDA kernel (`csrc/warp.cu`) and its plain twin.

Both resample a (3, H, W) image at the source coordinates of lens's
closed-form map (`ansel_tpu/ops/lens.py` `coord`: the distortion
multiplier of the ptlens, poly3 or poly5 model, `/ scale`, and per R/B
channel the TCA polynomial), evaluated per output pixel.  On the TPU the
JAX package resamples with the two-pass Pallas warp
(`ansel_tpu/kernels/warp_pallas.py:warp_bilinear`, driven by
`warp_model`); on the CPU with a direct bilinear gather
(`ops/lens.py:_sample_bilinear`).  A GPU gathers directly, so the port
follows the CPU form operation for operation: corner (y0, x0) =
clip(floor(s), 0, n - 2), weights clip(s - y0, 0, 1), the four corner
terms summed in order.  Divisions are true divisions by tensors (a CUDA
tensor divided by a Python float is multiplied by its reciprocal), as in
the kernel.

`lens_warp` launches the kernel for a CUDA tensor and runs
`lens_warp_reference` for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

DIST_NONE = 0
DIST_POLY3 = 1
DIST_PTLENS = 2
DIST_POLY5 = 3

# modify flags (lensfun LF_MODIFY_*)
MODIFY_TCA = 1
MODIFY_VIGNETTING = 2
MODIFY_DISTORTION = 8

# launches of the CUDA kernel since the count was last set to 0
LAUNCHES = 0


def pack_consts(c) -> torch.Tensor:
    """[a, b, c, scale, tca_r (3), tca_b (3)] as one float32 tensor on the
    coefficients' device."""
    return torch.cat([c["a"].reshape(1), c["b"].reshape(1),
                      c["c"].reshape(1), c["scale"].reshape(1),
                      c["tca_r"].reshape(3), c["tca_b"].reshape(3)]
                     ).float().contiguous()


def lens_coords(k: torch.Tensor, model: int, flags: int, h: int, w: int,
                cy: float, cx: float, rnorm: float, ch: int):
    """Source (y, x) of every output pixel of channel `ch`, each (h, w)
    float32; `k` the packed coefficients."""
    dev = k.device
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    rn = torch.full((), rnorm, dtype=torch.float32, device=dev)
    yn = (yy - cy) / rn
    xn = (xx - cx) / rn
    r = torch.sqrt(yn * yn + xn * xn)
    a, b, c, scale = k[0], k[1], k[2], k[3]
    if (flags & MODIFY_DISTORTION) and model != DIST_NONE:
        if model == DIST_POLY3:
            m = 1.0 - a + a * r * r
        elif model == DIST_POLY5:
            r2 = r * r
            m = 1.0 + a * r2 + b * (r2 * r2)
        else:  # ptlens: ru = rd (a rd^3 + b rd^2 + c rd + 1 - a - b - c)
            m = a * (r * (r * r)) + b * (r * r) + c * r + (1.0 - a - b - c)
    else:
        m = torch.ones_like(r)
    m = m / scale
    if ch != 1 and flags & MODIFY_TCA:
        t = k[4:7] if ch == 0 else k[7:10]
        m = m * (t[0] + t[1] * r + t[2] * r * r)
    return cy + (yy - cy) * m, cx + (xx - cx) * m


def sample_bilinear(plane: torch.Tensor, ys: torch.Tensor,
                    xs: torch.Tensor) -> torch.Tensor:
    """(h, w) plane sampled at (ys, xs), each (h, w): ops/lens.py's
    _sample_bilinear."""
    h, w = plane.shape
    y0 = torch.clamp(torch.floor(ys), 0, h - 2)
    x0 = torch.clamp(torch.floor(xs), 0, w - 2)
    fy = torch.clamp(ys - y0, 0.0, 1.0)
    fx = torch.clamp(xs - x0, 0.0, 1.0)
    idx = y0.long() * w + x0.long()
    flat = plane.reshape(-1)
    return (flat[idx] * (1 - fy) * (1 - fx) + flat[idx + 1] * (1 - fy) * fx
            + flat[idx + w] * fy * (1 - fx) + flat[idx + w + 1] * fy * fx)


def lens_warp_reference(x: torch.Tensor, k: torch.Tensor, model: int,
                        flags: int, cy: float, cx: float,
                        rnorm: float) -> torch.Tensor:
    """Plain torch: (3, H, W) -> (3, H, W)."""
    _, h, w = x.shape
    out = []
    for ch in range(3):
        sy, sx = lens_coords(k, model, flags, h, w, cy, cx, rnorm, ch)
        out.append(sample_bilinear(x[ch], sy.expand(h, w), sx.expand(h, w)))
    return torch.stack(out)


def _lib():
    from . import _build

    lib = _build.load("warp")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.lens_warp.argtypes = [p, p, p, i, i, i, i, f, f, f, p]
        lib.lens_warp.restype = ctypes.c_int
        lib._typed = True
    return lib


def lens_warp(x: torch.Tensor, k: torch.Tensor, model: int, flags: int,
              cy: float, cx: float, rnorm: float) -> torch.Tensor:
    """Lens's distortion and TCA warp of a (3, H, W) float32 image, `k` the
    packed coefficients (`pack_consts`) and (cy, cx, rnorm) the centre and
    radius normalisation in pixels.  A CPU tensor runs the plain version;
    a CUDA tensor launches csrc/warp.cu."""
    if x.device.type == "cpu":
        return lens_warp_reference(x, k, model, flags, cy, cx, rnorm)
    if x.device.type != "cuda":
        raise ValueError(f"warp: unsupported device {x.device}")
    if (x.dtype != torch.float32 or x.dim() != 3 or x.shape[0] != 3
            or not x.is_contiguous() or min(x.shape[1:]) < 2):
        raise ValueError("warp: needs a contiguous (3, H, W) float32 tensor "
                         f"with H, W >= 2, got {x.dtype} {tuple(x.shape)}")
    if (k.device != x.device or k.dtype != torch.float32
            or k.numel() != 10 or not k.is_contiguous()):
        raise ValueError("warp: needs 10 packed float32 coefficients on the "
                         "image's device")
    if model not in (DIST_NONE, DIST_POLY3, DIST_PTLENS, DIST_POLY5):
        raise ValueError(f"warp: unknown distortion model {model}")
    global LAUNCHES
    lib = _lib()
    _, h, w = x.shape
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lens_warp(x.data_ptr(), out.data_ptr(), k.data_ptr(), h, w,
                           int(model), int(flags), cy, cx, rnorm, stream)
    if rc != 0:
        raise RuntimeError(f"warp: CUDA launch failed ({rc})")
    LAUNCHES += 1
    return out
