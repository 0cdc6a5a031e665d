"""highlights — clipped-highlight reconstruction.

Reference: `ansel/src/iop/highlights/` — params struct common.h:428-446;
modes common.h:403-410.  Planning is copied from
`ansel_tpu/ops/highlights.py`.  Ported: CLIP (hard clamp at the
threshold, highlights/clip.c) and the guided LAPLACIAN on Bayer mosaics
(highlights/laplacian.c via kernels/highlights_laplacian.py) with its
noise salt.  LCH, INPAINT, HARMONIC and LAPLACIAN on X-Trans raise at
plan time.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.params import cfield, params
from ..core.types import CFAPattern, Colorspace, ImageSpec
from .base import Op, OpPlan, PlanContext, not_ported, register

MODE_CLIP = 0   # DT_IOP_HIGHLIGHTS_CLIP
MODE_LCH = 1
MODE_INPAINT = 2
MODE_LAPLACIAN = 3
MODE_HARMONIC = 4

_MODE_NAMES = {MODE_LCH: "LCH", MODE_INPAINT: "INPAINT",
               MODE_HARMONIC: "HARMONIC"}


@params(op="highlights", version=4)
@dataclasses.dataclass
class HighlightsParams:
    mode: int = cfield("i", MODE_CLIP)
    blendL: float = cfield("f", 1.0)   # unused (v1 leftovers)
    blendC: float = cfield("f", 0.0)
    blendh: float = cfield("f", 0.0)
    clip: float = cfield("f", 1.0)
    noise_level: float = cfield("f", 0.0)
    iterations: int = cfield("i", 30)
    scales: int = cfield("i", 8)
    reconstructing: float = cfield("f", 0.4)
    combine: float = cfield("f", 2.0)
    debugmode: int = cfield("i", 0)
    solid_color: float = cfield("f", 0.5)

    @classmethod
    def from_legacy(cls, version, raw):
        import struct

        if version == 1:  # highlights.c:163-184: {mode, blendL, blendC, blendh}
            mode, bl, bc, bh = struct.unpack("<i3f", raw[:16])
            return cls(mode=mode, blendL=bl, blendC=bc, blendh=bh, clip=1.0,
                       noise_level=0.0, iterations=1, scales=5,
                       reconstructing=0.4, combine=2.0, solid_color=0.0)
        if version == 2:  # highlights.c:185-209: v1 + {clip}
            mode, bl, bc, bh, clip = struct.unpack("<i4f", raw[:20])
            return cls(mode=mode, blendL=bl, blendC=bc, blendh=bh, clip=clip,
                       noise_level=0.0, iterations=1, scales=5,
                       reconstructing=0.4, combine=2.0, solid_color=0.0)
        if version == 3:  # highlights.c:210-220: v4 minus {solid_color}
            p = cls.codec.decode(raw[:44] + b"\0" * 4)
            p.solid_color = 0.0
            return p
        return None


@register
class Highlights(Op):
    name = "highlights"
    input_colorspace = Colorspace.RAW
    mandatory = True

    def plan(self, ctx: PlanContext, spec_in: ImageSpec, p) -> OpPlan:
        if p.mode in _MODE_NAMES:
            raise not_ported(self.name, f"mode {_MODE_NAMES[p.mode]}")
        if p.mode == MODE_LAPLACIAN:
            if spec_in.cfa is CFAPattern.XTRANS:
                raise not_ported(self.name, "mode LAPLACIAN on X-Trans")
        # reference clamps processed_maximum to the clip threshold
        pmax = tuple(m if m > 0 else 1.0 for m in ctx.processed_maximum)
        clipval = p.clip * min(pmax)
        ctx.processed_maximum = tuple(
            min(m, clipval) for m in ctx.processed_maximum
        )
        ctx.notes["highlights_clip"] = clipval
        # per-channel thresholds (highlights.c:385-389)
        ctx.notes["highlights_clips"] = tuple(
            0.995 * p.clip * m for m in pmax[:3])
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=(p.mode, max(int(p.scales), 1),
                              max(int(p.iterations), 1),
                              round(float(p.noise_level), 6),
                              round(float(p.solid_color), 6)))

    def roi_in(self, plan: OpPlan, ctx: PlanContext, win):
        # CLIP is a local mosaic op (6 preserves CFA window alignment);
        # the multiscale reconstruction needs the frame
        si, so = plan.spec_in, plan.spec_out
        if tuple(win) == (0, 0, so.height, so.width):
            return (0, 0, si.height, si.width)
        if plan.static[0] != MODE_CLIP:
            return None
        halo = 6
        y0 = max(0, win[0] - halo)
        x0 = max(0, win[1] - halo)
        y1 = min(si.height, win[0] + win[2] + halo)
        x1 = min(si.width, win[1] + win[3] + halo)
        return (y0, x0, y1 - y0, x1 - x0)

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p):
        return {"clip": ctx.notes["highlights_clip"],
                "clips": list(ctx.notes["highlights_clips"])}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        mode, scales_p, iters, noise_lv, solid = plan.static
        if mode == MODE_LAPLACIAN and plan.spec_in.cfa is not None:
            from ..kernels import highlights_laplacian as hl

            return hl.laplacian_reconstruct(
                x, c["clips"], plan.spec_in.cfa, scales_p, iters, noise_lv,
                solid, zoom=max(ctx.scale, 1e-6))
        return torch.minimum(x, c["clip"])
