"""Curve interpolators: cubic spline / Catmull-Rom / monotone Hermite,
sampled on the host into LUTs or evaluated per pixel.

Port of `ansel_tpu/pixel/curves.py` (reference `src/common/curve_tools.c`,
the three curve types tonecurve, rgbcurve, basecurve and colorzones use,
with darktable's unbounded convention: the curve continues linearly past
its outer nodes with the slope fitted there).  The numpy host half is
copied as it is; `eval_curve`, `eval_linear` and `apply_lut` are torch
with the reference's operand order, and the chain kernel's curve stages
(`csrc/pointwise_chain.cu`, `eval_curve`) repeat `eval_curve`'s.
"""

from __future__ import annotations

import numpy as np
import torch

CUBIC_SPLINE = 0
CATMULL_ROM = 1
MONOTONE_HERMITE = 2

LUT_SIZE = 4096


def _hermite(xs, ys, ms, t):
    """Evaluate piecewise-cubic Hermite with node slopes ms at positions t."""
    idx = np.clip(np.searchsorted(xs, t) - 1, 0, len(xs) - 2)
    h = xs[idx + 1] - xs[idx]
    h = np.where(h <= 0, 1e-9, h)
    u = (t - xs[idx]) / h
    h00 = 2 * u**3 - 3 * u**2 + 1
    h10 = u**3 - 2 * u**2 + u
    h01 = -2 * u**3 + 3 * u**2
    h11 = u**3 - u**2
    return (h00 * ys[idx] + h10 * h * ms[idx]
            + h01 * ys[idx + 1] + h11 * h * ms[idx + 1])


def _slopes_catmull(xs, ys):
    ms = np.zeros_like(ys)
    ms[1:-1] = (ys[2:] - ys[:-2]) / np.maximum(xs[2:] - xs[:-2], 1e-9)
    ms[0] = (ys[1] - ys[0]) / max(xs[1] - xs[0], 1e-9)
    ms[-1] = (ys[-1] - ys[-2]) / max(xs[-1] - xs[-2], 1e-9)
    return ms


def _slopes_monotone(xs, ys):
    """Fritsch-Carlson monotone cubic slopes (MONOTONE_HERMITE)."""
    d = (ys[1:] - ys[:-1]) / np.maximum(xs[1:] - xs[:-1], 1e-9)
    ms = np.zeros_like(ys)
    ms[1:-1] = (d[:-1] + d[1:]) / 2.0
    ms[0], ms[-1] = d[0], d[-1]
    for i in range(len(d)):
        if d[i] == 0.0:
            ms[i] = ms[i + 1] = 0.0
        else:
            a = ms[i] / d[i]
            b = ms[i + 1] / d[i]
            s = a * a + b * b
            if s > 9.0:
                tau = 3.0 / np.sqrt(s)
                ms[i] = tau * a * d[i]
                ms[i + 1] = tau * b * d[i]
    return ms


def _slopes_natural(xs, ys):
    """Natural cubic spline node slopes via the tridiagonal second-derivative
    solve (CUBIC_SPLINE)."""
    n = len(xs)
    if n == 2:
        m = (ys[1] - ys[0]) / max(xs[1] - xs[0], 1e-9)
        return np.array([m, m])
    h = np.maximum(np.diff(xs), 1e-9)
    A = np.zeros((n, n))
    rhs = np.zeros(n)
    A[0, 0] = A[-1, -1] = 1.0
    for i in range(1, n - 1):
        A[i, i - 1] = h[i - 1]
        A[i, i] = 2 * (h[i - 1] + h[i])
        A[i, i + 1] = h[i]
        rhs[i] = 3 * ((ys[i + 1] - ys[i]) / h[i] - (ys[i] - ys[i - 1]) / h[i - 1])
    c = np.linalg.solve(A, rhs)  # second-derivative/2 coefficients
    ms = np.zeros(n)
    for i in range(n - 1):
        ms[i] = (ys[i + 1] - ys[i]) / h[i] - h[i] * (2 * c[i] + c[i + 1]) / 3
    ms[-1] = (ys[-1] - ys[-2]) / h[-1] + h[-1] * (2 * c[-1] + c[-2]) / 3
    return ms


def _sorted_slopes(nodes_x, nodes_y, curve_type):
    xs = np.asarray(nodes_x, np.float64)
    ys = np.asarray(nodes_y, np.float64)
    order = np.argsort(xs)
    xs, ys = xs[order], ys[order]
    if curve_type == CATMULL_ROM:
        ms = _slopes_catmull(xs, ys)
    elif curve_type == MONOTONE_HERMITE:
        ms = _slopes_monotone(xs, ys)
    else:
        ms = _slopes_natural(xs, ys)
    return xs, ys, ms


def sample_curve(nodes_x, nodes_y, curve_type: int, lut_max: float = 1.0,
                 size: int = LUT_SIZE) -> np.ndarray:
    """Sample the curve into a LUT over [0, lut_max]; the curve extrapolates
    linearly beyond the outer nodes (dt's unbounded convention)."""
    xs, ys, ms = _sorted_slopes(nodes_x, nodes_y, curve_type)
    t = np.linspace(0.0, lut_max, size)
    out = _hermite(xs, ys, ms, np.clip(t, xs[0], xs[-1]))
    # linear extrapolation outside node range
    lo = t < xs[0]
    hi = t > xs[-1]
    out[lo] = ys[0] + ms[0] * (t[lo] - xs[0])
    out[hi] = ys[-1] + ms[-1] * (t[hi] - xs[-1])
    return out.astype(np.float32)


def curve_coeffs(nodes_x, nodes_y, curve_type: int):
    """-> (xs, ys, ms) float32 node arrays for eval_curve.  A stage's
    coefficient dict holds the tuple; moved to the device it is one (3, n)
    tensor whose rows are xs, ys, ms (row-major: the chain kernel reads
    the n xs, then the n ys, then the n ms)."""
    xs, ys, ms = _sorted_slopes(nodes_x, nodes_y, curve_type)
    return (xs.astype(np.float32), ys.astype(np.float32),
            ms.astype(np.float32))


def _nodes(v, x):
    """Node values as a float32 tensor on x's device (a device row of a
    stage's coefficients passes through)."""
    return torch.as_tensor(v, dtype=torch.float32, device=x.device)


def eval_curve(x: torch.Tensor, xs, ys, ms,
               unbounded_slope=None) -> torch.Tensor:
    """Piecewise-Hermite evaluation per pixel, gather-free: the segments
    unroll into masked selects, each overwriting the one before where
    x >= its first node, in the reference's order and operand order.
    Outside the node range: linear extrapolation with the edge slopes;
    `unbounded_slope` overrides the upper one."""
    xs, ys, ms = (_nodes(v, x) for v in (xs, ys, ms))
    n = len(xs)
    out = ys[0] + ms[0] * (x - xs[0])
    for k in range(n - 1):
        h = torch.clamp(xs[k + 1] - xs[k], min=1e-9)
        u = torch.clamp((x - xs[k]) / h, 0.0, 1.0)
        u2 = u * u
        u3 = u2 * u
        val = (ys[k] * (2 * u3 - 3 * u2 + 1)
               + ms[k] * h * (u3 - 2 * u2 + u)
               + ys[k + 1] * (-2 * u3 + 3 * u2)
               + ms[k + 1] * h * (u3 - u2))
        out = torch.where(x >= xs[k], val, out)
    hi_slope = ms[n - 1] if unbounded_slope is None else unbounded_slope
    return torch.where(x > xs[n - 1],
                       ys[n - 1] + hi_slope * (x - xs[n - 1]), out)


def eval_linear(x: torch.Tensor, xs, ys) -> torch.Tensor:
    """Piecewise-linear evaluation over sorted nodes, the same unrolled
    masked selects as eval_curve."""
    xs, ys = _nodes(xs, x), _nodes(ys, x)
    n = len(xs)
    out = ys[0] + 0.0 * x
    for k in range(n - 1):
        h = torch.clamp(xs[k + 1] - xs[k], min=1e-9)
        u = torch.clamp((x - xs[k]) / h, 0.0, 1.0)
        val = ys[k] * (1.0 - u) + ys[k + 1] * u
        out = torch.where(x >= xs[k], val, out)
    return out


def apply_lut(x: torch.Tensor, lut, lut_max: float = 1.0,
              unbounded_slope: float = None) -> torch.Tensor:
    """LUT application with linear in-bin interpolation; above lut_max
    extrapolate linearly with `unbounded_slope`."""
    lut = torch.as_tensor(lut, dtype=x.dtype, device=x.device)
    n = lut.shape[0]
    pos = torch.clamp(x / lut_max, 0.0, 1.0) * (n - 1)
    i0 = torch.clamp(pos.to(torch.int32), 0, n - 2).long()
    frac = pos - i0.to(x.dtype)
    v = lut[i0] * (1.0 - frac) + lut[i0 + 1] * frac
    if unbounded_slope is not None:
        v = torch.where(x > lut_max,
                        lut[-1] + (x - lut_max) * unbounded_slope, v)
    return v
