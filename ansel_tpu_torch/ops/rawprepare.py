"""rawprepare — sensor black/white normalization, sensor crop, and the
embedded DNG GainMap flat-field correction.

Reference: `ansel/src/iop/rawprepare.c` — process() subtracts the
per-CFA-position black level and divides by (white - black)
(rawprepare.c:439-530; position index BL(), rawprepare.c:385-390), crops the
masked borders, and resets processed_maximum to 1.0.  GainMap flat field:
check_gain_maps() validation rawprepare.c:765-810, bilinear map sampling
per Bayer filter rawprepare.c:564-603.  Planning and coefficients are
copied from `ansel_tpu/ops/rawprepare.py`: the bilinear upsample of the
small gain grid is two products per 2x2 parity class (interp-matrix @
map @ interp-matrix^T), interleaved back by stack and reshape, in plain
torch as the JAX package computes it outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.params import cfield, params
from ..core.types import Colorspace, DngGainMap, ImageSpec, RawMeta
from . import _bayer
from .base import Op, OpPlan, PlanContext, register

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


def _interp_matrix(coords: np.ndarray, npts: int, spacing: float,
                   origin: float, extent: int) -> np.ndarray:
    """(len(coords), npts) bilinear-sampling matrix for map coordinates
    y_map = clamp((coord/extent - origin)/spacing, 0, npts)
    (rawprepare.c:577-596 index/frac arithmetic)."""
    ym = np.clip((coords.astype(np.float64) / extent - origin) / spacing,
                 0.0, float(npts))
    i0 = np.minimum(ym.astype(np.int64), npts - 1)
    i1 = np.minimum(i0 + 1, npts - 1)
    frac = (ym - i0).astype(np.float32)
    m = np.zeros((len(coords), npts), np.float32)
    rows = np.arange(len(coords))
    np.add.at(m, (rows, i0), 1.0 - frac)
    np.add.at(m, (rows, i1), frac)
    return m


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
                gm_key = (gm[0].map_points_v, gm[0].map_points_h)
        return OpPlan(spec_in=spec_in, spec_out=spec_out,
                      static=(p.x, p.y, gm_key))

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p: RawPrepareParams):
        white = float(p.raw_white_point)
        sub = [float(b) for b in p.raw_black_level_separate]
        div = [white - s for s in sub]
        out = {"sub": sub, "inv_div": [1.0 / d if d else 1.0 for d in div]}
        cx, cy, gm_key = plan.static
        if gm_key is not None:
            gm = check_gain_maps(ctx.meta)
            mv, mh = gm_key
            out["gm_maps"] = np.stack([
                np.asarray(g.map_gain[: mv * mh], np.float32)
                .reshape(mv, mh) for g in gm])
            g0 = gm[0]
            so = plan.spec_out
            # sensor coords of each output row/col parity class
            # (rawprepare.c:578,592: coord = roi + crop-shift + j);
            # windowed pipes add the window origin
            for pj in range(2):
                out[f"gm_ay{pj}"] = _interp_matrix(
                    np.arange(pj, so.pad_h, 2) + cy + so.org_y, mv,
                    g0.map_spacing_v, g0.map_origin_v,
                    plan.spec_in.full_h)
            for pi in range(2):
                out[f"gm_ax{pi}"] = _interp_matrix(
                    np.arange(pi, so.pad_w, 2) + cx + so.org_x, mh,
                    g0.map_spacing_h, g0.map_origin_h,
                    plan.spec_in.full_w)
        return out

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        cx, cy, gm_key = plan.static
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
        y = (y - sub) * inv
        if gm_key is not None:
            # GainMap flat field (rawprepare.c:564-603): the per-filter gain
            # grid sampled bilinearly at every pixel, each 2x2 parity class
            # a (rows x mv) @ (mv x mh) @ (mh x cols) product, the classes
            # interleaved back by stack and reshape
            maps = c["gm_maps"]
            half_rows = []
            for pj in range(2):
                ay = c[f"gm_ay{pj}"]
                cols = []
                for pi in range(2):
                    f = (((pj + py) & 1) << 1) | ((pi + px) & 1)
                    cols.append(ay @ maps[f] @ c[f"gm_ax{pi}"].T)
                half_rows.append(torch.stack(cols, dim=-1)
                                 .reshape(cols[0].shape[0], -1))
            gain = torch.stack(half_rows, dim=1).reshape(so.pad_h, so.pad_w)
            y = y * gain
        return y
