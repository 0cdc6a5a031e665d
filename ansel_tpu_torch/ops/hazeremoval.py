"""hazeremoval — dark-channel-prior dehazing (He et al.).

Reference: `ansel/src/iop/hazeremoval.c` (params v1 :91-95; dark channel
:313-331, transition map :335-354, ambient light :415-484, process
:492-620).  Copied from `ansel_tpu/ops/hazeremoval.py`: the windowed
minima and maxima are separable shifted selects over an edge-padded
plane; the ambient light's two quantiles are 18 rounds of value
bisection on the device (`_bisect_quantile`, whose count is compared in
float32 as the JAX package compares it, which rounds past 2^24 pixels);
the transition map is refined by `pixel/guided.guided_filter`.  Runs on
camera RGB before colorin.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.params import cfield, params
from ..pixel.guided import guided_filter
from ..pixel.shifts import PaddedView
from .base import Op, OpPlan, PlanContext, channel_mean, register

W1 = 6  # dark-channel / transition-map window
W2 = 9  # guided-filter window
EPS = 0.025  # guided-filter regularization (variance units)
BISECT_ROUNDS = 18


def _window_reduce(x: torch.Tensor, radius: int, fn) -> torch.Tensor:
    """Separable (2r+1)^2 running min or max of an (H, W) plane, edge
    padded: the rows' pass, then the columns'."""

    def axis_pass(v, axis):
        pv = PaddedView(v, radius)
        out = v
        for d in range(1, radius + 1):
            if axis == 0:
                out = fn(out, fn(pv.at(-d, 0), pv.at(d, 0)))
            else:
                out = fn(out, fn(pv.at(0, -d), pv.at(0, d)))
        return out

    return axis_pass(axis_pass(x, 0), 1)


def box_min(x, radius):
    return _window_reduce(x, radius, torch.minimum)


def box_max(x, radius):
    return _window_reduce(x, radius, torch.maximum)


def _bisect_quantile(v, target_count, lo, hi, mask=None,
                     iters: int = BISECT_ROUNDS):
    """Smallest t in [lo, hi] with count(v <= t [and mask]) >= target,
    to (hi - lo) / 2^iters: the quantile the reference takes by partial
    sort (hazeremoval.c:415-484).  All on the device: `target_count`,
    `lo` and `hi` are float32 0-dim tensors, and the count is compared
    as float32."""
    a, b = lo * 1.0, hi * 1.0
    for _ in range(iters):
        m = 0.5 * (a + b)
        le = v <= m
        if mask is not None:
            le = le & mask
        hit = torch.sum(le).to(torch.float32) >= target_count
        a, b = torch.where(hit, a, m), torch.where(hit, m, b)
    return b


def _f32(v, like):
    """A float32 scalar on `like`'s device, filled there."""
    return torch.full((), v, dtype=torch.float32, device=like.device)


@params(op="hazeremoval", version=1)
@dataclasses.dataclass
class HazeRemovalParams:
    strength: float = cfield("f", 0.2)
    distance: float = cfield("f", 0.2)


@register
class HazeRemoval(Op):
    name = "hazeremoval"
    input_colorspace = None  # camera RGB, pre-colorin

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p: HazeRemovalParams):
        return {"strength": np.float32(p.strength),
                "distance": np.float32(p.distance)}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        H, W = x.shape[-2:]
        size = H * W
        dark = box_min(torch.amin(x, dim=0), W1)

        # ambient light A0 (hazeremoval.c:415-484): quantiles by value
        # bisection
        crit_haze = _bisect_quantile(dark, _f32(size * 0.95 + 1.0, x),
                                     torch.amin(dark), torch.amax(dark))
        hazy = dark >= crit_haze
        n_hazy = torch.sum(hazy)
        sums = x[0] + x[1] + x[2]
        # the bright quantile among the hazy pixels
        crit_bright = _bisect_quantile(
            sums, n_hazy.to(torch.float32) * 0.95 + 1.0,
            torch.amin(sums), torch.amax(sums), mask=hazy)
        sel = hazy & (sums >= crit_bright)
        n_sel = torch.clamp(torch.sum(sel), min=1).to(torch.float32)
        A0 = torch.stack([torch.sum(torch.where(sel, x[i], 0.0)) / n_sel
                          for i in range(3)])
        distance_max = torch.where(
            crit_haze > 0,
            -1.125 * torch.log(torch.clamp(crit_haze, min=1e-30)),
            _f32(44.0, x))  # ~log(FLT_MAX)/2

        # transition map (hazeremoval.c:335-354), refined (:588-604)
        safe_A0 = torch.clamp(A0, min=1e-6)
        ratio = torch.amin(torch.stack([x[i] / safe_A0[i] for i in range(3)]),
                           dim=0)
        trans = box_max(1.0 - ratio * c["strength"], W1)
        trans = box_min(trans, W1)
        trans = guided_filter(channel_mean(x), trans, W2, EPS)

        t_min = torch.clamp(torch.exp(-c["distance"] * distance_max),
                            1.0 / 1024.0, 1.0)
        t = torch.maximum(trans, t_min)
        return torch.stack([(x[i] - A0[i]) / t + A0[i] for i in range(3)])
