"""rawprepare — sensor black/white normalization and sensor crop.

Reference: `ansel/src/iop/rawprepare.c` — process() subtracts the
per-CFA-position black level and divides by (white - black)
(rawprepare.c:439-530; position index BL(), rawprepare.c:385-390), crops the
masked borders, and resets processed_maximum to 1.0.  Planning is copied
from `ansel_tpu/ops/rawprepare.py`; the embedded DNG GainMap flat field
is not ported and raises at plan time.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch.nn.functional as F

from ..core.params import cfield, params
from ..core.types import Colorspace, DngGainMap, ImageSpec, RawMeta
from . import _bayer
from .base import Op, OpPlan, PlanContext, not_ported, register

FLAT_FIELD_OFF = 0       # rawprepare.c:69
FLAT_FIELD_EMBEDDED = 1  # rawprepare.c:70


def check_gain_maps(meta: RawMeta) -> Optional[Tuple[DngGainMap, ...]]:
    """The reference's check_gain_maps (rawprepare.c:765-810): exactly
    four maps, one per RGGB filter, full-coverage, pitch-2, same shape
    -> (maps ordered by filter index) or None."""
    if len(meta.gain_maps) != 4:
        return None
    by_filter: list = [None] * 4
    for g in meta.gain_maps:
        if (g.plane != 0 or g.planes != 1 or g.map_planes != 1
                or g.row_pitch != 2 or g.col_pitch != 2
                or g.map_points_v < 2 or g.map_points_h < 2
                or g.top > 1 or g.left > 1
                or g.bottom != meta.height or g.right != meta.width
                or len(g.map_gain) < g.map_points_v * g.map_points_h):
            return None
        by_filter[((g.top & 1) << 1) + (g.left & 1)] = g
    if any(g is None for g in by_filter):
        return None
    g0 = by_filter[0]
    for g in by_filter[1:]:
        if (g.map_points_h != g0.map_points_h
                or g.map_points_v != g0.map_points_v
                or g.map_spacing_h != g0.map_spacing_h
                or g.map_spacing_v != g0.map_spacing_v
                or g.map_origin_h != g0.map_origin_h
                or g.map_origin_v != g0.map_origin_v):
            return None
    return tuple(by_filter)


@params(op="rawprepare", version=2)
@dataclasses.dataclass
class RawPrepareParams:
    x: int = cfield("i", 0)               # crop left
    y: int = cfield("i", 0)               # crop top
    width: int = cfield("i", 0)           # crop right
    height: int = cfield("i", 0)          # crop bottom
    raw_black_level_separate: tuple = cfield("4H", (0, 0, 0, 0))
    raw_white_point: int = cfield("H", 65535)
    flat_field: int = cfield("i", 0)

    @classmethod
    def from_legacy(cls, version, raw):
        if version == 1:  # rawprepare.c:152-166 — v1 lacked flat_field
            import struct

            vals = struct.unpack("<4i4HH", raw[:26])
            return cls(
                x=vals[0], y=vals[1], width=vals[2], height=vals[3],
                raw_black_level_separate=vals[4:8], raw_white_point=vals[8],
            )
        return None


@register
class RawPrepare(Op):
    name = "rawprepare"
    input_colorspace = Colorspace.RAW
    mandatory = True

    def default_params(self, meta: RawMeta):
        return RawPrepareParams(
            x=meta.crop_x, y=meta.crop_y, width=meta.crop_right,
            height=meta.crop_bottom,
            raw_black_level_separate=tuple(int(b) for b in meta.black_levels),
            raw_white_point=int(meta.white_point),
        )

    def roi_in(self, plan: OpPlan, ctx: PlanContext, win):
        # crop-only geometry: input window = output window + crop offset
        si, so = plan.spec_in, plan.spec_out
        if tuple(win) == (0, 0, so.height, so.width):
            return (0, 0, si.height, si.width)
        cx, cy = plan.static[0], plan.static[1]
        return (win[0] + cy, win[1] + cx, win[2], win[3])

    def plan(self, ctx: PlanContext, spec_in: ImageSpec, p: RawPrepareParams) -> OpPlan:
        import dataclasses as _dc

        full_w = spec_in.full_w - p.x - p.width
        full_h = spec_in.full_h - p.y - p.height
        if spec_in.is_window:
            # windowed: output covers the same pixels, re-origined to the
            # cropped frame (engine already delivered win+crop upstream)
            spec_out = _dc.replace(
                spec_in, org_y=spec_in.org_y - p.y,
                org_x=spec_in.org_x - p.x, full_h=full_h, full_w=full_w)
        else:
            w = spec_in.width - p.x - p.width
            h = spec_in.height - p.y - p.height
            spec_out = spec_in.with_size(
                w, h, cfa=spec_in.cfa.shifted(p.y, p.x)
                if spec_in.cfa else None)
        ctx.processed_maximum = (1.0, 1.0, 1.0)
        gm_key = None
        if (p.flat_field == FLAT_FIELD_EMBEDDED and spec_in.cfa is not None
                and ctx.meta.xtrans is None):
            gm = check_gain_maps(ctx.meta)
            if gm is not None:
                raise not_ported(self.name, "the DNG GainMap flat field")
        return OpPlan(spec_in=spec_in, spec_out=spec_out,
                      static=(p.x, p.y, gm_key))

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p: RawPrepareParams):
        white = float(p.raw_white_point)
        sub = [float(b) for b in p.raw_black_level_separate]
        div = [white - s for s in sub]
        return {"sub": sub, "inv_div": [1.0 / d if d else 1.0 for d in div]}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        cx, cy, _ = plan.static
        so = plan.spec_out
        si = plan.spec_in
        # crop then edge-pad back to the new aligned shape (zero offset on
        # windowed pipes: the engine already delivered win + crop)
        oy = cy + so.org_y - si.org_y
        ox = cx + so.org_x - si.org_x
        cropped = x[oy: oy + so.height, ox: ox + so.width]
        y = F.pad(cropped[None], (0, so.pad_w - so.width,
                                  0, so.pad_h - so.height),
                  mode="replicate")[0]
        # position-indexed black/white normalize, relative to the new
        # origin: BL() uses (row + crop_y) & 1 with row in output coords
        py, px = cy + so.org_y, cx + so.org_x
        sub = _bayer.position_select(c["sub"], so.pad_h, so.pad_w, py, px)
        inv = _bayer.position_select(c["inv_div"], so.pad_h, so.pad_w,
                                     py, px)
        return (y - sub) * inv
