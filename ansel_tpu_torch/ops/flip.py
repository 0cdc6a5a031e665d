"""flip — EXIF orientation.

Reference: `ansel/src/iop/flip.c` (params v2: one dt_image_orientation_t).
Orientation bits (src/common/image.h): bit0 = flip x, bit1 = flip y,
bit2 = swap x/y (transpose); ORIENTATION_NONE = 0, ORIENTATION_NULL = -1
(use the image's EXIF orientation).  The planner injects the op for a raw
whose orientation is neither 0 nor 1.  Planning is copied from
`ansel_tpu/ops/flip.py`; the apply is a transpose and flips of the valid
region, edge-padded back to the planned shape.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.params import cfield, params
from ..core.types import ImageSpec
from ..pixel.shifts import pad_tail
from .base import Op, OpPlan, PlanContext, register

ORIENTATION_NULL = -1
FLIP_X = 1
FLIP_Y = 2
SWAP_XY = 4

# EXIF orientation tag (1..8) -> dt orientation bits (flip.c legacy map)
EXIF_TO_ORIENTATION = {1: 0, 2: 1, 3: 3, 4: 2, 5: 4, 6: 6, 7: 7, 8: 5}


@params(op="flip", version=2)
@dataclasses.dataclass
class FlipParams:
    orientation: int = cfield("i", ORIENTATION_NULL)

    @classmethod
    def from_legacy(cls, version, raw):
        import struct

        # flip.c v1 {orientation}
        if version == 1:
            (o,) = struct.unpack("<i", raw[:4])
            return cls(orientation=o)
        return None


@register
class Flip(Op):
    name = "flip"
    input_colorspace = None

    def default_params(self, meta):
        return FlipParams(orientation=ORIENTATION_NULL)

    def enabled_by_default(self, meta):
        return meta.orientation not in (0, 1)

    def _orientation(self, ctx, p: FlipParams) -> int:
        if p.orientation == ORIENTATION_NULL:
            return EXIF_TO_ORIENTATION.get(ctx.meta.orientation, 0)
        return p.orientation

    def plan(self, ctx: PlanContext, spec_in: ImageSpec, p) -> OpPlan:
        o = self._orientation(ctx, p)
        if o & SWAP_XY:
            spec_out = spec_in.with_size(spec_in.height, spec_in.width)
        else:
            spec_out = spec_in
        return OpPlan(spec_in=spec_in, spec_out=spec_out, static=o)

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        o = plan.static
        if o == 0:
            return x
        si, so = plan.spec_in, plan.spec_out
        v = x[..., : si.height, : si.width]
        if o & SWAP_XY:
            v = v.transpose(-1, -2)
        if o & FLIP_X:
            v = torch.flip(v, dims=(-1,))
        if o & FLIP_Y:
            v = torch.flip(v, dims=(-2,))
        return pad_tail(v, so.pad_h - so.height,
                        so.pad_w - so.width).contiguous()
