"""Bilinear resize equal to `jax.image.resize(x, shape, "bilinear")`.

JAX resamples with antialias=True: each changed axis is a product with a
weight matrix built by `compute_weight_mat` (jax/_src/image/scale.py):
half-pixel centres, the triangle kernel widened by max(1/scale, 1), each
output column normalised to sum 1 and zeroed where the sample falls
outside the input.  The matrices are built in numpy float32 as JAX builds
them and applied with one `torch.einsum`, as JAX applies them (a plain
product that the JAX package leaves to XLA).  An axis whose size does not
change is left alone, as in JAX.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_EPS32 = float(np.finfo(np.float32).eps)


def weight_matrix(m: int, n: int) -> np.ndarray:
    """(m, n) float32 weights taking an axis of m samples to n."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n / m))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(n, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(m, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * _EPS32),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= f32(m - 0.5))
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


@functools.lru_cache(maxsize=16)
def _weights_on(m: int, n: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(weight_matrix(m, n)).to(device)


def resize_bilinear(x: torch.Tensor, shape) -> torch.Tensor:
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
        return torch.einsum("...hw,wv->...hv", x, _weights_on(w, ow, x.device))
    if w == ow:
        return torch.einsum("...hw,hu->...uw", x, _weights_on(h, oh, x.device))
    return torch.einsum("...hw,hu,wv->...uv", x, _weights_on(h, oh, x.device),
                        _weights_on(w, ow, x.device))
