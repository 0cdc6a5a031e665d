"""Resizes and resamplers of `ansel_tpu/pixel/resample.py` and of
`jax.image.resize`.

`resize_bilinear` and `resize_lanczos3` equal `jax.image.resize(x, shape,
"bilinear" / "lanczos3")`.  JAX resamples with antialias=True: each
changed axis is a product with a weight matrix built by
`compute_weight_mat` (jax/_src/image/scale.py): half-pixel centres, the
kernel (triangle, or Lanczos of radius 3) widened by max(1/scale, 1), each
output column normalised to sum 1 and zeroed where the sample falls
outside the input.  The matrices are built in numpy float32 as JAX builds
them and applied with one `torch.einsum`, as JAX applies them (a plain
product that the JAX package leaves to XLA).  An axis whose size does not
change is left alone, as in JAX.

`resample_matrix` / `resample_coeffs` / `apply_resample` are the
reference's own resamplers (src/pixel/interpolation.c: bilinear, bicubic
Catmull-Rom a = -0.5, Mitchell-Netravali B = C = 1/3, the default), one
dense (n_out, n_in) matrix per axis built on the host and contracted in
float32, copied from the JAX package (initialscale, finalscale).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

_EPS32 = float(np.finfo(np.float32).eps)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))


def _lanczos3(x: np.ndarray) -> np.ndarray:
    """jax/_src/image/scale.py `_fill_lanczos_kernel(3., x)` in float32."""
    f32 = np.float32
    radius = f32(3.0)
    px = f32(np.pi) * x
    y = radius * np.sin(px) * np.sin(px / radius)
    den = np.where(x != 0, f32(np.pi ** 2) * (x * x), f32(1.0))
    out = np.where(x > f32(1e-3), y / den, f32(1.0))
    return np.where(x > radius, f32(0.0), out).astype(f32)


def weight_matrix(m: int, n: int, kernel=_triangle) -> np.ndarray:
    """(m, n) float32 weights taking an axis of m samples to n."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n / m))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(n, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(m, dtype=f32)[:, None]) \
        / kernel_scale
    w = kernel(x)
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * _EPS32),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= f32(m - 0.5))
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


@functools.lru_cache(maxsize=16)
def _weights_on(m: int, n: int, device: torch.device,
                kernel=_triangle) -> torch.Tensor:
    return torch.from_numpy(weight_matrix(m, n, kernel)).to(device)


def resize_lanczos3(x: torch.Tensor, shape) -> torch.Tensor:
    """`jax.image.resize(x, shape, "lanczos3")`: as `resize_bilinear`
    with the Lanczos kernel of radius 3."""
    return resize_bilinear(x, shape, _lanczos3)


def resize_bilinear(x: torch.Tensor, shape, kernel=_triangle) -> torch.Tensor:
    """Resize the last two axes of `x` (2-D or 3-D float32) to
    `shape[-2:]`; leading axes must keep their size."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != x.dim() or shape[:-2] != tuple(x.shape[:-2]):
        raise ValueError(f"resize {tuple(x.shape)} -> {shape}: only the "
                         "last two axes may change")
    (h, w), (oh, ow) = x.shape[-2:], shape[-2:]
    if (h, w) == (oh, ow):
        return x
    if h == oh:
        return torch.einsum("...hw,wv->...hv", x,
                            _weights_on(w, ow, x.device, kernel))
    if w == ow:
        return torch.einsum("...hw,hu->...uw", x,
                            _weights_on(h, oh, x.device, kernel))
    return torch.einsum("...hw,hu,wv->...uv", x,
                        _weights_on(h, oh, x.device, kernel),
                        _weights_on(w, ow, x.device, kernel))


# --- the reference's resamplers (initialscale, finalscale) -----------------

METHODS = ("bilinear", "bicubic", "mitchell")
DEFAULT = "mitchell"
_WIDTH = {"bilinear": 1, "bicubic": 2, "mitchell": 2}


def kernel_weight(method: str, t: np.ndarray) -> np.ndarray:
    """Tap weight at (vector of) offsets t, reference formulas."""
    a = np.abs(np.asarray(t, np.float64))
    if method == "bilinear":
        return np.maximum(1.0 - a, 0.0)
    if method == "bicubic":
        t2 = a * a
        r01 = ((3.0 * t2 - 5.0 * a) * a + 2.0) * 0.5
        r12 = (a * (5.0 * a - 8.0 - t2) + 4.0) * 0.5
        return np.where(a <= 1.0, r01, np.where(a < 2.0, r12, 0.0))
    if method == "mitchell":
        a2 = a * a
        a3 = a2 * a
        r01 = (7.0 / 6.0) * a3 - 2.0 * a2 + 8.0 / 9.0
        r12 = 2.0 * a2 - (7.0 / 18.0) * a3 - (10.0 / 3.0) * a + 16.0 / 9.0
        return np.where(a <= 1.0, r01, np.where(a < 2.0, r12, 0.0))
    raise ValueError(method)


def resample_matrix(method: str, n_out: int, n_in: int) -> np.ndarray:
    """(n_out, n_in) row-stochastic resampling matrix for one axis; tap
    indices clamp to the valid range and accumulate (the reference's
    BORDER_CLAMP and tap trimming)."""
    w = _WIDTH[method]
    scale = n_out / n_in
    M = np.zeros((n_out, n_in), np.float32)
    if n_out == n_in:
        np.fill_diagonal(M, 1.0)
        return M
    if scale >= 1.0:  # upsampling: taps at k(t - i), norm 1
        for o in range(n_out):
            t = o / scale
            f = math.floor(t) - w + 1
            idx = np.arange(f, f + 2 * w)
            wt = kernel_weight(method, t - idx)
            np.add.at(M[o], np.clip(idx, 0, n_in - 1), wt.astype(np.float32))
    else:  # downsampling: kernel in output units, renormalised
        ratio = scale
        for o in range(n_out):
            f = math.ceil((o - w) / ratio)
            t = f * ratio - o
            num = int((w - t) / ratio)
            idx = np.arange(f, f + num)
            wt = kernel_weight(method, t + np.arange(num) * ratio)
            s = wt.sum()
            if s > 0:
                wt = wt / s
            np.add.at(M[o], np.clip(idx, 0, n_in - 1), wt.astype(np.float32))
    return M


def resample_coeffs(method: str, in_h: int, in_w: int, out_h: int,
                    out_w: int) -> dict:
    """Host coefficients of `apply_resample`."""
    return {"rs_mh": resample_matrix(method, out_h, in_h),
            "rs_mw": resample_matrix(method, out_w, in_w)}


def apply_resample(x: torch.Tensor, mh: torch.Tensor,
                   mw: torch.Tensor) -> torch.Tensor:
    """(..., H, W) x (out_h, H) x (out_w, W) -> (..., out_h, out_w): the
    rows, then the columns, each a float32 product."""
    t = torch.einsum("oh,...hw->...ow", mh, x)
    return torch.einsum("pw,...ow->...op", mw, t)
