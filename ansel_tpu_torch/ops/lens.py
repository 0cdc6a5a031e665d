"""lens — optical corrections: distortion warp, TCA, vignetting.

Reference: `src/iop/lens.cc` (lensfun bridge).  Params (v5 and the v2-v4
ladder), the database resolution, `plan` (with its host displacement
bound `max_disp`) and `coeffs` are copied from `ansel_tpu/ops/lens.py`.
`apply` returns its input when `max_disp <= 1`; otherwise one warp
(`kernels/warp.py`: distortion and TCA, all three channels), then the
vignetting gain in plain torch, which the JAX package also computes
outside its warp kernel.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.params import cfield, params
from ..kernels import warp as wp
from ..kernels.warp import (DIST_NONE, DIST_POLY3, DIST_POLY5, DIST_PTLENS,
                            MODIFY_DISTORTION, MODIFY_TCA, MODIFY_VIGNETTING)
from .base import Op, OpPlan, PlanContext, register

MODIFY_ALL = MODIFY_TCA | MODIFY_VIGNETTING | MODIFY_DISTORTION


@params(op="lens", version=5)
@dataclasses.dataclass
class LensParams:
    # serialized layout = reference dt_iop_lensfun_params_t v5; the model
    # coefficients below it are Python-only fields
    modify_flags: int = cfield("i", MODIFY_ALL)
    inverse: int = cfield("i", 0)
    scale: float = cfield("f", 1.0)
    crop: float = cfield("f", 1.0)
    focal: float = cfield("f", 50.0)
    aperture: float = cfield("f", 2.8)
    distance: float = cfield("f", 1000.0)
    target_geom: int = cfield("i", 1)  # LF_RECTILINEAR
    camera: str = cfield("s:128", "")
    lens: str = cfield("s:128", "")
    tca_override: int = cfield("i", 0)
    tca_r: float = cfield("f", 1.0)
    tca_b: float = cfield("f", 1.0)
    modified: int = cfield("i", 0)

    @classmethod
    def from_legacy(cls, version, raw):
        import struct

        # lens.cc version ladder: v2 (52-char names), v3 (128-char),
        # v4 (+modified); all old versions had tca R and B swapped
        def cut(b):
            return b.split(b"\x00")[0].decode("utf-8", "replace")

        if version == 2:
            v = struct.unpack("<2i5fi52s52si2f", raw[:148])
        elif version == 3:
            v = struct.unpack("<2i5fi128s128si2f", raw[:300])
        elif version == 4:
            v = struct.unpack("<2i5fi128s128si2fi", raw[:304])
        else:
            return None
        return cls(modify_flags=v[0], inverse=v[1], scale=v[2],
                   crop=v[3], focal=v[4], aperture=v[5], distance=v[6],
                   target_geom=v[7], camera=cut(v[8]), lens=cut(v[9]),
                   tca_override=v[10], tca_r=v[12], tca_b=v[11],
                   modified=1 if version < 4 else v[13])
    # --- Python-only correction coefficients (not serialized) ---
    distortion_model: int = dataclasses.field(default=DIST_PTLENS)
    dist_a: float = dataclasses.field(default=0.0)
    dist_b: float = dataclasses.field(default=0.0)
    dist_c: float = dataclasses.field(default=0.0)
    vig_k1: float = dataclasses.field(default=0.0)
    vig_k2: float = dataclasses.field(default=0.0)
    vig_k3: float = dataclasses.field(default=0.0)
    # TCA per-channel poly3 r/b terms (lensfun: rs = rd(b r^2 + c r + v);
    # the serialized tca_r/tca_b act as the v terms)
    tca_cr: float = dataclasses.field(default=0.0)
    tca_br: float = dataclasses.field(default=0.0)
    tca_cb: float = dataclasses.field(default=0.0)
    tca_bb: float = dataclasses.field(default=0.0)
    # r-normalization: 0 = half-diagonal (hand-entered coeffs), 1 =
    # half-short-side (lensfun convention, set by the database resolver)
    norm_short_side: int = dataclasses.field(default=0)


def _resolve_from_db(p: LensParams) -> LensParams:
    """Fill model coefficients from the lensfun database when the params
    carry a lens identity but no explicit coefficients; explicit ones
    always win."""
    explicit = any(abs(v) > 0.0 for v in (
        p.dist_a, p.dist_b, p.dist_c, p.vig_k1, p.vig_k2, p.vig_k3))
    if explicit or not (p.camera or p.lens):
        return p
    from ..io import lensfun as lfdb

    c = lfdb.resolve(p.camera, p.lens, p.focal, p.aperture,
                     p.distance, crop=p.crop)
    if not c.found_lens:
        return p
    upd = dict(norm_short_side=1)
    if c.have_distortion and (p.modify_flags & MODIFY_DISTORTION):
        model = {"ptlens": DIST_PTLENS, "poly3": DIST_POLY3,
                 "poly5": DIST_POLY5}[c.dist_model]
        if model == DIST_POLY3:
            upd.update(distortion_model=model, dist_a=c.dist[0])
        else:
            upd.update(distortion_model=model, dist_a=c.dist[0],
                       dist_b=c.dist[1], dist_c=c.dist[2])
    else:
        upd.update(distortion_model=DIST_NONE)
    if c.have_tca and (p.modify_flags & MODIFY_TCA) and not p.tca_override:
        upd.update(tca_r=c.tca_r[0], tca_cr=c.tca_r[1], tca_br=c.tca_r[2],
                   tca_b=c.tca_b[0], tca_cb=c.tca_b[1], tca_bb=c.tca_b[2])
    if c.have_vignetting and (p.modify_flags & MODIFY_VIGNETTING):
        upd.update(vig_k1=c.vig[0], vig_k2=c.vig[1], vig_k3=c.vig[2])
    return dataclasses.replace(p, **upd)


def _geometry(spec, short_side):
    """Centre and radius normalisation of the unpadded frame."""
    cy, cx = (spec.height - 1) / 2.0, (spec.width - 1) / 2.0
    rnorm = min(cy, cx) if short_side else math.sqrt(cx * cx + cy * cy)
    return cy, cx, rnorm


@register
class Lens(Op):
    name = "lens"
    input_colorspace = None  # camera RGB (after demosaic)

    def plan(self, ctx: PlanContext, spec_in, p: LensParams) -> OpPlan:
        # host-side displacement bound: the warp is skipped at max_disp <= 1
        p = _resolve_from_db(p)
        cy, cx, rnorm = _geometry(spec_in, p.norm_short_side)
        rmax = math.sqrt(cx * cx + cy * cy) / max(rnorm, 1e-6)
        r = np.linspace(0.0, rmax, 257)
        if (p.modify_flags & MODIFY_DISTORTION) \
                and p.distortion_model != DIST_NONE:
            if p.distortion_model == DIST_POLY3:
                mult = 1.0 - p.dist_a + p.dist_a * r * r
            elif p.distortion_model == DIST_POLY5:
                mult = 1.0 + p.dist_a * r**2 + p.dist_b * r**4
            else:
                mult = (p.dist_a * r**3 + p.dist_b * r**2 + p.dist_c * r
                        + (1.0 - p.dist_a - p.dist_b - p.dist_c))
        else:
            mult = np.ones_like(r)
        mult = mult / max(p.scale, 1e-3)
        if p.modify_flags & MODIFY_TCA:
            tcas = (p.tca_r + p.tca_cr * r + p.tca_br * r * r,
                    np.ones_like(r),
                    p.tca_b + p.tca_cb * r + p.tca_bb * r * r)
        else:
            tcas = (np.ones_like(r),)
        max_dev = max(float(np.max(np.abs(mult * t - 1.0) * r))
                      for t in tcas)
        max_disp = int(np.ceil(max_dev * rnorm)) + 1
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=(p.distortion_model, p.modify_flags,
                              max_disp, bool(p.norm_short_side)))

    def coeffs(self, ctx, plan, p: LensParams):
        p = _resolve_from_db(p)
        return {"a": p.dist_a, "b": p.dist_b, "c": p.dist_c,
                "scale": max(p.scale, 1e-3),
                "tca_r": [p.tca_r, p.tca_cr, p.tca_br],
                "tca_b": [p.tca_b, p.tca_cb, p.tca_bb],
                "vig": [p.vig_k1, p.vig_k2, p.vig_k3]}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        model, flags, max_disp, short_side = plan.static
        spec = plan.spec_in
        cy, cx, rnorm = _geometry(spec, short_side)
        res = x
        if max_disp > 1:
            res = wp.lens_warp(x, wp.pack_consts(c), model, flags, cy, cx,
                               rnorm)
        if flags & MODIFY_VIGNETTING:
            h, w = spec.pad_h, spec.pad_w
            k1, k2, k3 = c["vig"][0], c["vig"][1], c["vig"][2]
            yy = torch.arange(h, dtype=torch.float32, device=x.device)[:, None]
            xx = torch.arange(w, dtype=torch.float32, device=x.device)[None, :]
            dy, dx = yy - cy, xx - cx
            rn2 = torch.full((), rnorm * rnorm, dtype=torch.float32,
                             device=x.device)
            r2 = (dy * dy + dx * dx) / rn2
            gain = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
            res = res / torch.clamp(gain, min=1e-3)[None]
        return res
