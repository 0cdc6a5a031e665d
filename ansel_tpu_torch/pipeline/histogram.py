"""Scopes backend: histogram, waveform, vectorscope
(`ansel_tpu/pipeline/histogram.py`).

Reference: `ansel/src/common/histogram.c` (256-bin per-channel histogram
collection over an ROI) and the darkroom scopes the GUI draws from it
(waveform: per-column intensity counts; vectorscope: chroma plane
density).  The JAX package counts through one-hot reductions, which at
24 MP would build a (24 M, 256) selection per channel; here each scope
counts its flattened bin indices with `torch.bincount` (integer counts,
returned as float32), with the JAX package's binning arithmetic:
int32 truncation toward zero of v * (bins - 1) + 0.5, then a clip.
"""

from __future__ import annotations

import torch


def _bin_index(v: torch.Tensor, bins: int) -> torch.Tensor:
    """clip(int32(v * (bins - 1) + 0.5), 0, bins - 1) as int64."""
    idx = (v * (bins - 1) + 0.5).to(torch.int32)
    return torch.clamp(idx, 0, bins - 1).long()


def _counts(idx: torch.Tensor, n: int) -> torch.Tensor:
    """(...,) indices in [0, n) -> (n,) float32 counts."""
    return torch.bincount(idx.reshape(-1), minlength=n).to(torch.float32)


def histogram_rgb(img, bins: int = 256):
    """(3, H, W) display RGB in [0,1] -> (3, bins) counts
    (histogram.c 256-bin collection)."""
    img = torch.as_tensor(img)
    idx = _bin_index(img, bins)
    return torch.stack([_counts(idx[c], bins) for c in range(3)])


def waveform(img, bins: int = 160, out_cols: int = 0):
    """(3, H, W) -> (3, bins, W') column-intensity density (the darkroom
    waveform scope): for each output column, the vertical distribution
    of channel values, bright on top."""
    img = torch.as_tensor(img)
    c, h, w = img.shape
    out_cols = out_cols or min(w, 360)
    # pool columns to the display width
    step = max(w // out_cols, 1)
    wc = (w // step) * step
    cols = wc // step
    # the mean of each column group, summed in column order and divided
    # by a 0-dim tensor, so that the card rounds as the CPU does
    groups = img[:, :, :wc].reshape(c, h, cols, step)
    total = groups[..., 0]
    for j in range(1, step):
        total = total + groups[..., j]
    pooled = total / torch.full((), float(step), dtype=img.dtype,
                                device=img.device)
    idx = _bin_index(pooled, bins)
    # one count per (channel, column, bin)
    col = torch.arange(cols, device=img.device)
    ch = torch.arange(c, device=img.device)[:, None, None]
    flat = (ch * cols + col) * bins + idx
    out = _counts(flat, c * cols * bins).reshape(c, cols, bins)
    return torch.flip(out.transpose(1, 2), dims=(1,))


def vectorscope(img, size: int = 128):
    """(3, H, W) -> (size, size) chroma-plane density around the neutral
    axis (CbCr-style projection of the scopes vectorscope)."""
    img = torch.as_tensor(img)
    r, g, b = img[0], img[1], img[2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 0.5 + (b - y) * 0.564
    cr = 0.5 + (r - y) * 0.713
    ib = _bin_index(cb, size)
    ir = _bin_index(cr, size)
    return _counts(ir * size + ib, size * size).reshape(size, size)


def stats(img):
    """Per-channel (mean, min, max, clipped-high fraction) — the
    overexposure indicators' numbers (histogram.c consumers)."""
    img = torch.as_tensor(img)
    flatc = img.reshape(img.shape[0], -1)
    return {
        "mean": torch.mean(flatc, dim=1),
        "min": torch.amin(flatc, dim=1),
        "max": torch.amax(flatc, dim=1),
        "clipped": torch.mean((flatc >= 1.0 - 1e-6).to(torch.float32),
                              dim=1),
    }
