"""Bilateral grid (`ansel_tpu/pixel/bilateralgrid.py`; reference
`src/pixel/bilateral.c`: splat, 5-tap blur, trilinear slice).

`grid_filter` pads the frame to whole ss x ss cells, splats the values
into a (D, C, gh, gw) grid of range bins with triangle weights, blurs it
with the reference's 5-tap kernel along each axis and slices it back at
every pixel.  The splat is plain torch, as in the JAX package: one
batched float32 contraction of the per-pixel bin weights against the
cell's values, both rounded through bfloat16 first as the JAX package
rounds them (a bf16 x bf16 product is exact in float32, so only the
summation order differs).  The slice is the hand-written kernel
(`kernels/bgrid.py`, `csrc/bgrid.cu`) on the card and its plain twin on
the CPU, in the arithmetic of the TPU's Pallas slice.

`upsample_axis` is the cell-centred bilinear upsample by an integer
factor: every output sample is w0 * g[i0] + w1 * g[i1], with the taps of
the JAX package's two forms (`upsample_taps`): its phase unroll for
ss <= 16 and the rows of its dense matrix for ss > 16.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..kernels import bgrid
from .shifts import pad_tail


def upsample_taps(n_in: int, ss: int):
    """The two taps of every output sample of an n_in -> n_in * ss
    upsample: (i0, i1) int64 and (w0, w1) float32 numpy arrays, so that
    out[j] = w0[j] * g[i0[j]] + w1[j] * g[i1[j]].

    ss <= 16 takes the JAX package's phase rule: phase r of cell n blends
    (g[n-1], g[n]) or (g[n], g[n+1]), edge-clamped, with the float32
    weights (1 - f_r, f_r).  ss > 16 takes the rows of its dense matrix,
    float32(1 - f) at i0 and float32(f) at i1, whose two entries merge
    into float32(float32(1 - f) + f) at the right edge (i0 == i1)."""
    n_out = n_in * ss
    j = np.arange(n_out)
    if ss == 1:
        return (j, j, np.ones(n_out, np.float32), np.zeros(n_out, np.float32))
    if ss > 16:
        pos = (j + 0.5) / ss - 0.5
        i0 = np.clip(np.floor(pos), 0, n_in - 1).astype(np.int64)
        i1 = np.clip(i0 + 1, 0, n_in - 1)
        f = np.clip(pos - i0, 0.0, 1.0)
        w0 = (1.0 - f).astype(np.float32)
        merged = (w0.astype(np.float64) + f).astype(np.float32)
        split = i1 != i0
        return (i0, i1, np.where(split, w0, merged),
                np.where(split, f.astype(np.float32), np.float32(0.0)))
    pos = (np.arange(ss) + 0.5) / ss - 0.5
    lead = np.floor(pos).astype(int) < 0          # phase blends g[n-1], g[n]
    f = (pos - np.floor(pos)).astype(np.float32)
    n, r = j // ss, j % ss
    i0 = np.where(lead[r], np.maximum(n - 1, 0), n).astype(np.int64)
    i1 = np.where(lead[r], n, np.minimum(n + 1, n_in - 1)).astype(np.int64)
    w0 = (np.float32(1.0) - f)[r]
    return i0, i1, w0, f[r]


@functools.lru_cache(maxsize=64)
def column_taps(n_in: int, ss: int, device: torch.device):
    """`upsample_taps` on `device` as the slice kernel reads them: pairs
    (i0, i1) int32 (n_in * ss, 2) and (w0, w1) float32 (n_in * ss, 2)."""
    i0, i1, w0, w1 = upsample_taps(n_in, ss)
    idx = np.stack([i0, i1], 1).astype(np.int32)
    wts = np.stack([w0, w1], 1).astype(np.float32)
    return torch.from_numpy(idx).to(device), torch.from_numpy(wts).to(device)


def upsample_axis(g: torch.Tensor, ss: int, axis: int) -> torch.Tensor:
    """Cell-centered bilinear upsample of `g` by the integer factor `ss`
    along `axis` (n -> n * ss): a two-tap gather, products then their sum
    in float32, as the JAX package's phase blends compute it."""
    if ss == 1:
        return g
    axis = axis % g.dim()
    idx, wts = column_taps(g.shape[axis], ss, g.device)
    shape = [1] * g.dim()
    shape[axis] = -1
    return (g.index_select(axis, idx[:, 0]) * wts[:, 0].reshape(shape)
            + g.index_select(axis, idx[:, 1]) * wts[:, 1].reshape(shape))


def _blur_axis(g: torch.Tensor, axis: int) -> torch.Tensor:
    """Reference 5-tap grid blur [1,4,6,4,1]/16 (bilateral.c blur pass),
    edge-padded, summed in tap order."""
    taps = (1 / 16, 4 / 16, 6 / 16, 4 / 16, 1 / 16)
    axis = axis % g.dim()
    n = g.shape[axis]
    first = g.narrow(axis, 0, 1)
    last = g.narrow(axis, n - 1, 1)
    gp = torch.cat([first, first, g, last, last], dim=axis)
    out = None
    for i, t in enumerate(taps):
        c = t * gp.narrow(axis, i, n)
        out = c if out is None else out + c
    return out


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    # a 0-dim tensor: on the card torch multiplies by the reciprocal of a
    # Python float divisor, where the JAX package divides
    return torch.full((), v, dtype=torch.float32, device=like.device)


def grid_filter(guide: torch.Tensor, values: torch.Tensor, sigma_s: float,
                sigma_r: float, lo: float, hi: float,
                detail: float = None) -> torch.Tensor:
    """Edge-aware smoothing of `values` (C, H, W) guided by `guide` (H, W).

    sigma_s: spatial cell size in pixels; sigma_r: range cell size in guide
    units; [lo, hi]: guide range.  With `detail`, the reference's
    dt_bilateral_slice_to_output detail-boost slicing (bilat):
    out = in + detail * (in - base)."""
    H, W = guide.shape
    C = values.shape[0]
    ss = max(int(round(sigma_s)), 1)
    D = int(np.clip(round((hi - lo) / max(sigma_r, 1e-6)) + 1, 4, 32))
    step = (hi - lo) / (D - 1)

    # pad to whole cells (edge), part of the result's semantics
    ph = (-H) % ss
    pw = (-W) % ss
    gp = pad_tail(torch.clamp(guide, lo, hi), ph, pw)
    vp = pad_tail(values, ph, pw)
    Hp, Wp = H + ph, W + pw
    gh, gw = Hp // ss, Wp // ss
    n_cells, p_cell = gh * gw, ss * ss

    def cells(x):
        return x.reshape(gh, ss, gw, ss).permute(0, 2, 1, 3) \
                .reshape(n_cells, p_cell)

    z = (gp - lo) / _scalar(step, gp)              # in [0, D-1]
    b0 = torch.floor(z)
    f = z - b0
    b0c = cells(b0).long()
    fc = cells(f)
    # triangle weights, 2 nonzero bins per pixel, rounded through bf16 as
    # in the JAX package: bf16(1 - f) at b0 and bf16(f) at b0 + 1, whose
    # weight for bin D is dropped.  Written (n, D, p) by two scatters (the
    # second overwrites the first's masked zero at b0 = D - 1) rather than
    # as a sum of one-hot planes: the same tensor, fewer passes over it.
    w0 = (1.0 - fc).to(torch.bfloat16).float()
    w1 = fc.to(torch.bfloat16).float()
    b1c = b0c + 1
    Fm = torch.zeros((n_cells, D, p_cell), dtype=torch.float32,
                     device=guide.device)
    Fm.scatter_(1, b1c.clamp(max=D - 1)[:, None],
                torch.where(b1c < D, w1, torch.zeros_like(w1))[:, None])
    Fm.scatter_(1, b0c[:, None], w0[:, None])
    vc = torch.stack([cells(vp[c]) for c in range(C)], dim=2)   # (n, p, C)
    vc = vc.to(torch.bfloat16).float()
    nums = torch.bmm(Fm, vc)                                    # (n, D, C)
    dens = Fm.sum(dim=2)                                        # (n, D)
    del Fm
    cnt = _scalar(float(p_cell), nums)
    nums = nums.reshape(gh, gw, D, C).permute(2, 3, 0, 1) / cnt
    dens = dens.reshape(gh, gw, D).permute(2, 0, 1) / cnt

    # grid blur: space (2 axes), then range
    for ax in (-2, -1):
        nums = _blur_axis(nums, ax)
        dens = _blur_axis(dens, ax)
    nums = _blur_axis(nums, 0)
    dens = _blur_axis(dens, 0)
    base_grid = nums / torch.clamp(dens[:, None], min=1e-8)   # (D, C, gh, gw)

    out = bgrid.slice_grid(base_grid.contiguous(), z.contiguous(),
                           ss)[:, :H, :W]
    if detail is not None:
        return values[:, :H, :W] + detail * (values[:, :H, :W] - out)
    return out


def bilateral_self(x: torch.Tensor, sigma_s: float, sigma_r: float,
                   lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    """Per-channel self-guided bilateral of (C, H, W): the channelwise
    approximation of iop/bilateral.cc's 5-D permutohedral filter."""
    return torch.stack([
        grid_filter(x[c], x[c:c + 1], sigma_s, sigma_r, lo, hi)[0]
        for c in range(x.shape[0])])
