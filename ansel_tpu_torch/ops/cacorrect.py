"""cacorrect — automatic chromatic-aberration correction on Bayer raws.

Reference: `ansel/src/iop/cacorrect.c` (RawTherapee heritage): per-tile
R/B-vs-G shift diagnostics, a global polynomial shift model fitted by
least squares, and sub-pixel bilinear shift compensation of the R/B
mosaic sites.  The estimator is `ansel_tpu/ops/cacorrect.py`'s, copied
step for step:
  1. half-resolution channel planes (R, B, and G averaged at each site),
  2. per-tile displacement via one Lucas-Kanade step on a 32x32 tile
     grid,
  3. a weighted least-squares fit of a quadratic shift field (6 terms
     per axis per channel, a 6x6 solve on the device),
  4. sub-pixel correction of the half-res R/B planes as a hat-basis sum
     of shifted views, re-interleaved into the mosaic.
Shifts are clamped to the reference's +-4 px diagnostic range.  Bayer
only, as in the JAX package: X-Trans and multi-channel input pass
through.  Plain torch throughout, many small launches and no kernel of
its own (its launch count is in PERF.md).
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.params import cfield, params
from ..core.types import CFAPattern, Colorspace
from ..pixel.shifts import PaddedView
from .base import Op, OpPlan, PlanContext, register

TILE = 32  # half-res tile for the shift diagnostics
BSLIM = 4.0


@params(op="cacorrect", version=2)
@dataclasses.dataclass
class CACorrectParams:
    avoidshift: int = cfield("i", 0)
    iterations: int = cfield("i", 1)

    @classmethod
    def from_legacy(cls, version, raw):
        if version == 1:
            # cacorrect.c:152-165: v1 payload ignored, v2 defaults
            return cls(avoidshift=0, iterations=1)
        return None


def _halfres_planes(x, cfa: CFAPattern):
    """mosaic (H, W) -> half-res (R, G_at_R, B, G_at_B), each (H/2, W/2).
    G is the 4-neighbour cross average AT the R/B sites."""
    pvx = PaddedView(x, 1)
    gi = 0.25 * (pvx.at(-1, 0) + pvx.at(1, 0) + pvx.at(0, -1)
                 + pvx.at(0, 1))
    pos = {cfa.color_at(y, xx): (y, xx) for y in range(2) for xx in range(2)}

    def at(pos_yx, img):
        dy, dx = pos_yx
        return img[dy::2, dx::2]

    return (at(pos[0], x), at(pos[0], gi), at(pos[2], x), at(pos[2], gi))


def _tile_stats(G, C):
    """per-tile Lucas-Kanade displacement of C relative to G."""
    h, w = G.shape
    th, tw = h // TILE, w // TILE
    Gc = G[: th * TILE, : tw * TILE]
    Cc = C[: th * TILE, : tw * TILE]
    pv = PaddedView(Gc, 1)
    gx = 0.5 * (pv.at(0, 1) - pv.at(0, -1))
    gy = 0.5 * (pv.at(1, 0) - pv.at(-1, 0))
    diff = Cc - Gc

    def tsum(a):
        return a.reshape(th, TILE, tw, TILE).sum((1, 3))

    den_x = tsum(gx * gx) + 1e-9
    den_y = tsum(gy * gy) + 1e-9
    dx = torch.clamp(tsum(gx * diff) / den_x, -BSLIM, BSLIM)
    dy = torch.clamp(tsum(gy * diff) / den_y, -BSLIM, BSLIM)
    # weight by gradient energy (flat tiles carry no CA signal)
    wgt = tsum(gx * gx + gy * gy)
    return dx, dy, wgt


def _grid(h, w, device):
    """(X, Y), each (h, w): cell centres in [-0.5, 0.5)."""
    ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h - 0.5
    xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w - 0.5
    return torch.meshgrid(xs, ys, indexing="xy")


def _fit_quadratic(field, wgt, th, tw):
    """weighted LSQ fit shift(x, y) = a + bx + cy + dx^2 + exy + fy^2."""
    X, Y = _grid(th, tw, field.device)
    basis = torch.stack([torch.ones_like(X), X, Y, X * X, X * Y, Y * Y])
    B = basis.reshape(6, -1)
    w = wgt.reshape(-1)
    f = field.reshape(-1)
    A = (B * w[None]) @ B.T + 1e-6 * torch.eye(6, device=field.device)
    rhs = (B * w[None]) @ f
    # solve_ex: no host check of the factorisation, so no sync on the card
    return torch.linalg.solve_ex(A, rhs)[0]


def _hat_warp(C, dy, dx, lim: float):
    """Bilinear resample of C at (y+dy, x+dx), |d| <= lim, as a
    (2m+1)^2 hat-basis weighted sum of shifted views: exact linear
    interpolation (hat functions partition unity) with no gathers."""
    m = int(lim) + 1
    pv = PaddedView(C, m)
    wx = {k: torch.clamp(1.0 - torch.abs(dx - k), min=0.0)
          for k in range(-m, m + 1)}
    out = 0.0
    for j in range(-m, m + 1):
        wy = torch.clamp(1.0 - torch.abs(dy - j), min=0.0)
        row = 0.0
        for k in range(-m, m + 1):
            row = row + wx[k] * pv.at(j, k)
        out = out + wy * row
    return out


def _eval_quadratic(coef, h, w):
    X, Y = _grid(h, w, coef.device)
    return (coef[0] + coef[1] * X + coef[2] * Y + coef[3] * X * X
            + coef[4] * X * Y + coef[5] * Y * Y)


@register
class CACorrect(Op):
    name = "cacorrect"
    input_colorspace = Colorspace.RAW

    def enabled_by_default(self, meta):
        return False

    def plan(self, ctx: PlanContext, spec_in, p: CACorrectParams) -> OpPlan:
        bayer = spec_in.cfa is not CFAPattern.XTRANS and spec_in.channels == 1
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=(bool(bayer), max(int(p.iterations), 1)))

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        bayer, iterations = plan.static
        if not bayer:
            return x
        cfa = plan.spec_in.cfa
        out = x
        for _ in range(iterations):
            R, G_r, B, G_b = _halfres_planes(out, cfa)
            h, w = R.shape
            th, tw = h // TILE, w // TILE
            if th < 3 or tw < 3:
                return out
            coefs = {}
            for color, C, G in ((0, R, G_r), (2, B, G_b)):
                dx_t, dy_t, wgt = _tile_stats(G, C)
                # d estimates MINUS the physical shift (C(x) = G(x-s)
                # => C-G ~ -s*gradG => d = -s); resample C at x - d
                coefs[color] = (_fit_quadratic(dy_t, wgt, th, tw),
                                _fit_quadratic(dx_t, wgt, th, tw))

            corrected = {}
            for color, C in ((0, R), (2, B)):
                cy_, cx_ = coefs[color]
                sx = torch.clamp(_eval_quadratic(cx_, h, w), -BSLIM, BSLIM)
                sy = torch.clamp(_eval_quadratic(cy_, h, w), -BSLIM, BSLIM)
                corrected[color] = _hat_warp(C, -sy, -sx, BSLIM)

            # re-interleave via stack + reshape
            planes = {}
            for py in range(2):
                for px in range(2):
                    color = cfa.color_at(py, px)
                    planes[(py, px)] = (
                        corrected[color] if color in corrected
                        else out[py::2, px::2])
            row0 = torch.stack([planes[(0, 0)], planes[(0, 1)]],
                               dim=-1).reshape(h, 2 * w)
            row1 = torch.stack([planes[(1, 0)], planes[(1, 1)]],
                               dim=-1).reshape(h, 2 * w)
            out = torch.stack([row0, row1], dim=1).reshape(2 * h, 2 * w)
        return out
