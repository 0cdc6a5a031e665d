"""The warps: the CUDA kernels (`csrc/warp.cu`) and their plain twins.

Each resamples a (C, H, W) image at per-pixel source coordinates from a
closed-form map evaluated per output pixel, with two maps:

* lens's (`ansel_tpu/ops/lens.py` `coord`: the distortion multiplier of
  the ptlens, poly3 or poly5 model, `/ scale`, and per R/B channel the
  TCA polynomial), on a (3, H, W) image;
* clipping's inverse map (`ansel_tpu/ops/clipping.py` `_inverse_coords`:
  translate, undo the keystone shears, rotate back, the optional
  projective keystone), with the outside mask folded in: an output
  pixel whose source lies outside the frame is 0.

On the TPU the JAX package resamples with the two-pass Pallas warp
(`ansel_tpu/kernels/warp_pallas.py:warp_bilinear`, driven by
`warp_model`); on the CPU with a direct bilinear gather
(`ops/lens.py:_sample_bilinear`).  A GPU gathers directly, so the port
follows the CPU form operation for operation: corner (y0, x0) =
clip(floor(s), 0, n - 2), weights clip(s - y0, 0, 1), the four corner
terms summed in order.  Divisions are true divisions by tensors (a CUDA
tensor divided by a Python float is multiplied by its reciprocal), as in
the kernel.  Clipping's constants are float32 values computed on the
host (`ops/clipping.clip_map`), as JAX rounds the float64 Python
constants of `_inverse_coords`.

`lens_warp` and `clip_warp` launch the kernel for a CUDA tensor and run
`lens_warp_reference` / `clip_warp_reference` for a CPU tensor.
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

# launches of the CUDA kernels (both maps) since the count was last set
# to 0
LAUNCHES = 0

# clipping's float32 constants, in the order of csrc/warp.cu's ClipMap
CLIP_CONSTS = ("c_px", "c_py", "t_px", "t_py", "k_h", "k_v", "m0", "m1",
               "m2", "m3", "tx", "ty", "ksp_x", "ksp_y", "a", "b", "d", "e",
               "hg", "hh", "ae", "bd", "kxa", "kya", "out_oy", "out_ox",
               "in_oy", "in_ox", "w_m1", "h_m1")


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


def clip_coords(k: torch.Tensor, k_apply: int, oh: int, ow: int, device):
    """Clipping's map on the (oh, ow) output buffer: -> (source y, source x
    in the input buffer, inside the frame), each (oh, ow); `k` the
    CLIP_CONSTS (float32), `k_apply` whether the keystone applies."""
    c = dict(zip(CLIP_CONSTS, k.tolist()))
    f32 = torch.float32

    def full(v):
        return torch.full((), v, dtype=f32, device=device)

    jj = torch.arange(oh, dtype=f32, device=device)[:, None] + c["out_oy"]
    ii = torch.arange(ow, dtype=f32, device=device)[None, :] + c["out_ox"]
    px = (c["c_px"] + ii) + 0.5
    py = (c["c_py"] + jj) + 0.5
    px = px - c["t_px"]
    py = py - c["t_py"]
    py = py / (1.0 + px * c["k_h"])
    px = px / (1.0 + py * c["k_v"])
    sx = c["m0"] * px + c["m1"] * py + c["tx"]
    sy = c["m2"] * px + c["m3"] * py + c["ty"]
    if k_apply:
        xx = sx - c["ksp_x"]
        yy = sy - c["ksp_y"]
        div = (c["d"] * xx - c["a"] * yy) * c["hh"] \
            + (c["b"] * yy - c["e"] * xx) * c["hg"] + full(c["ae"]) \
            - full(c["bd"])
        sx = (c["e"] * xx - c["b"] * yy) / div + c["kxa"]
        sy = -(c["d"] * xx - c["a"] * yy) / div + c["kya"]
    sy = (sy - 0.5).expand(oh, ow)
    sx = (sx - 0.5).expand(oh, ow)
    inside = (sx >= 0) & (sx <= c["w_m1"]) & (sy >= 0) & (sy <= c["h_m1"])
    return sy - c["in_oy"], sx - c["in_ox"], inside


def clip_warp_reference(x: torch.Tensor, k: torch.Tensor, k_apply: int,
                        oh: int, ow: int) -> torch.Tensor:
    """Plain torch: (C, H, W) -> (C, oh, ow)."""
    sy, sx, inside = clip_coords(k, k_apply, oh, ow, x.device)
    out = torch.stack([sample_bilinear(x[i], sy, sx)
                       for i in range(x.shape[0])])
    return torch.where(inside[None], out, torch.zeros((), device=x.device))


def _lib():
    from . import _build

    lib = _build.load("warp")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.lens_warp.argtypes = [p, p, p, i, i, i, i, f, f, f, p]
        lib.lens_warp.restype = ctypes.c_int
        lib.clip_warp.argtypes = [p, p, i, i, i, i, i, p, i, p]
        lib.clip_warp.restype = ctypes.c_int
        lib.clip_warp_nconsts.restype = ctypes.c_int
        if lib.clip_warp_nconsts() != len(CLIP_CONSTS):
            raise RuntimeError("csrc/warp.cu and kernels/warp.py disagree on "
                               "clipping's constants")
        lib._typed = True
    return lib


def clip_warp(x: torch.Tensor, k: torch.Tensor, k_apply: int, oh: int,
              ow: int) -> torch.Tensor:
    """Clipping's warp of a (C, H, W) float32 image onto a (C, oh, ow)
    buffer, zero outside the frame; `k` the CLIP_CONSTS, float32 on the
    host.  A CPU tensor runs the plain version; a CUDA tensor launches
    csrc/warp.cu."""
    k = k.detach().to("cpu", torch.float32).contiguous()
    if k.numel() != len(CLIP_CONSTS):
        raise ValueError(f"clip_warp: needs {len(CLIP_CONSTS)} constants, "
                         f"got {k.numel()}")
    if x.device.type == "cpu":
        return clip_warp_reference(x, k, k_apply, oh, ow)
    if x.device.type != "cuda":
        raise ValueError(f"warp: unsupported device {x.device}")
    if (x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous()
            or min(x.shape[1:]) < 2 or oh < 1 or ow < 1):
        raise ValueError("warp: needs a contiguous (C, H, W) float32 tensor "
                         f"with H, W >= 2, got {x.dtype} {tuple(x.shape)}")
    global LAUNCHES
    lib = _lib()
    c, h, w = x.shape
    out = torch.empty((c, oh, ow), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.clip_warp(x.data_ptr(), out.data_ptr(), c, h, w, oh, ow,
                           k.data_ptr(), int(bool(k_apply)), stream)
    if rc != 0:
        raise RuntimeError(f"warp: CUDA launch failed ({rc})")
    LAUNCHES += 1
    return out


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
