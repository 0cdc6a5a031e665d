"""colormapping — transfer colour statistics from a source image
(histogram equalisation on L, Gaussian-cluster chroma mapping).

Reference: `ansel/src/iop/colormapping.c` (params :113-139, get_clusters
:277-295, get_cluster_mapping :300-330, process :453-585).  Copied from
`ansel_tpu/ops/colormapping.py`: `acquire_stats` (the GUI's acquire pass
as host numpy: histogram and k-means), the host pairing of clusters and
the composed L curve sampled at 129 knots; on the device the curve is a
chain of masked linear pieces, the correction is smoothed by
`pixel/guided.fast_guided_filter` at scaling 8 (a bilateral grid in the
reference), and a and b are remapped by Shepard-weighted clusters.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.params import cfield, params
from ..core.types import Colorspace
from ..pixel.guided import fast_guided_filter
from .base import Op, OpPlan, PlanContext, register

HISTN = 1 << 11
KNOTS = 129  # the device curve's resolution
MAXN = 5
FLAG_HAS_SOURCE = 1
FLAG_HAS_TARGET = 2


@params(op="colormapping", version=1)
@dataclasses.dataclass
class ColorMappingParams:
    flag: int = cfield("i", 0)
    n: int = cfield("i", 3)
    dominance: float = cfield("f", 100.0)
    equalization: float = cfield("f", 50.0)
    source_ihist: tuple = cfield(f"{HISTN}f", (0.0,) * HISTN)
    source_mean: tuple = cfield(f"{2 * MAXN}f", (0.0,) * (2 * MAXN))
    source_var: tuple = cfield(f"{2 * MAXN}f", (0.0,) * (2 * MAXN))
    source_weight: tuple = cfield(f"{MAXN}f", (0.0,) * MAXN)
    target_hist: tuple = cfield(f"{HISTN}i", (0,) * HISTN)
    target_mean: tuple = cfield(f"{2 * MAXN}f", (0.0,) * (2 * MAXN))
    target_var: tuple = cfield(f"{2 * MAXN}f", (0.0,) * (2 * MAXN))
    target_weight: tuple = cfield(f"{MAXN}f", (0.0,) * MAXN)


def acquire_stats(lab: np.ndarray, n: int = 3, seed: int = 0):
    """Host-side analog of the GUI acquire pass: -> (hist_lut, inverse_lut,
    means (n,2), vars (n,2), weights (n,)).  `lab` is (3, H, W)."""
    L = np.clip(lab[0].reshape(-1), 0.0, 100.0)
    hist, _ = np.histogram(L, bins=HISTN, range=(0.0, 100.0))
    cdf = np.cumsum(hist).astype(np.float64)
    cdf /= max(cdf[-1], 1.0)
    hist_lut = np.round(cdf * (HISTN - 1)).astype(np.int32)
    # inverse: L value whose cdf reaches k/HISTN
    inv = np.interp(np.arange(HISTN) / (HISTN - 1), cdf,
                    np.linspace(0.0, 100.0, HISTN)).astype(np.float32)
    ab = np.stack([lab[1].reshape(-1), lab[2].reshape(-1)], 1)
    rng = np.random.default_rng(seed)
    centers = ab[rng.choice(len(ab), n, replace=False)]
    for _ in range(10):  # lloyd iterations
        d = ((ab[:, None, :] - centers[None]) ** 2).sum(-1)
        assign = d.argmin(1)
        for k in range(n):
            sel = ab[assign == k]
            if len(sel):
                centers[k] = sel.mean(0)
    var = np.zeros((n, 2), np.float32)
    weight = np.zeros(n, np.float32)
    for k in range(n):
        sel = ab[assign == k]
        if len(sel):
            var[k] = sel.var(0)
            weight[k] = len(sel) / len(ab)
    order = np.argsort(-weight)
    return hist_lut, inv, centers[order].astype(np.float32), var[order], \
        weight[order]


@register
class ColorMapping(Op):
    name = "colormapping"
    input_colorspace = Colorspace.LAB

    def plan(self, ctx: PlanContext, spec_in, p: ColorMappingParams) -> OpPlan:
        active = (p.flag & FLAG_HAS_SOURCE) and (p.flag & FLAG_HAS_TARGET)
        n = max(1, min(int(p.n), MAXN))
        sigma = max(int(50.0 / max(ctx.scale, 1e-3)), 1)
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=(bool(active), n, min(sigma, 256),
                              p.equalization > 0.1))

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p: ColorMappingParams):
        active, n, _sigma, _eq = plan.static
        if not active:
            return {}
        tmean = np.asarray(p.target_mean, np.float64).reshape(MAXN, 2)[:n]
        smean = np.asarray(p.source_mean, np.float64).reshape(MAXN, 2)[:n]
        tvar = np.asarray(p.target_var, np.float64).reshape(MAXN, 2)[:n]
        svar = np.asarray(p.source_var, np.float64).reshape(MAXN, 2)[:n]
        twght = np.asarray(p.target_weight, np.float64)[:n]
        swght = np.asarray(p.source_weight, np.float64)[:n]
        dominance = p.dominance / 100.0
        # dominance-weighted best source cluster per target cluster
        mapio = np.zeros(n, int)
        for ki in range(n):
            dist = ((smean[:, 0] - tmean[ki, 0]) ** 2
                    + (smean[:, 1] - tmean[ki, 1]) ** 2) * (1.0 - dominance) \
                + 1e4 * (swght - twght[ki]) ** 2 * dominance
            mapio[ki] = int(dist.argmin())
        var_ratio = np.where(tvar > 0, svar[mapio] / np.maximum(tvar, 1e-12),
                             0.0)
        # the composed L curve source_ihist[target_hist[L]], sampled at
        # KNOTS uniform knots (smooth and monotone)
        th = np.clip(np.asarray(p.target_hist, np.int64), 0, HISTN - 1)
        lut = np.asarray(p.source_ihist, np.float32)[th]
        kidx = np.round(np.linspace(0, HISTN - 1, KNOTS)).astype(int)
        return {
            "lut": lut[kidx],
            "tmean": np.asarray(tmean, np.float32),
            "smean": np.asarray(smean[mapio], np.float32),
            "var_ratio": np.asarray(var_ratio, np.float32),
            "equalization": np.float32(p.equalization / 100.0),
        }

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        active, n, sigma, eq_smooth = plan.static
        if not active:
            return x
        L, a, b = x[0], x[1], x[2]
        # uniform-knot linear interpolation as masked pieces, in order
        lut = c["lut"]
        pos = torch.clamp(L / 100.0, 0.0, 1.0) * (KNOTS - 1)
        matched = torch.zeros_like(L) + lut[0]
        for k in range(KNOTS - 1):
            u = torch.clamp(pos - k, 0.0, 1.0)
            matched = torch.where(pos >= k,
                                  lut[k] * (1.0 - u) + lut[k + 1] * u,
                                  matched)
        eq = c["equalization"]
        corr = 0.5 * ((L * (1.0 - eq) + matched * eq) - L) + 50.0
        corr = torch.clamp(corr, 0.0, 100.0)
        if eq_smooth:
            # the sigma-50 correction surface is low-frequency: the guided
            # filter at an 8x downsample
            corr = fast_guided_filter(L, corr, sigma, 64.0, scaling=8)
        L_out = torch.clamp(2.0 * (corr - 50.0) + L, 0.0, 100.0)

        # Shepard weights to the target clusters (get_clusters)
        tm, vr, sm = c["tmean"], c["var_ratio"], c["smean"]
        d2 = [(a - tm[k, 0]) ** 2 + (b - tm[k, 1]) ** 2 for k in range(n)]
        w = [1.0 / torch.clamp(d, min=1e-6) for d in d2]
        tot = sum(w)
        w = [wk / tot for wk in w]
        a_out = sum(w[k] * ((a - tm[k, 0]) * vr[k, 0] + sm[k, 0])
                    for k in range(n))
        b_out = sum(w[k] * ((b - tm[k, 1]) * vr[k, 1] + sm[k, 1])
                    for k in range(n))
        return torch.stack([L_out, a_out, b_out])
