"""vignette — elliptic brightness/saturation falloff.

Reference: `ansel/src/iop/vignette.c` (params v4, vignette.c:140-152), as
`ansel_tpu/ops/vignette.py` has it: inner radius `scale` and falloff
band in percent of half the diagonal, shape exponent, a centred ellipse
with its w/h ratio; brightness scales RGB, saturation pulls toward the
pixel's mean.  It reads each pixel's position in its array (the planned
frame's width and height baked in at plan time), so it is a chain stage
with `needs_pos` and a full-frame boundary of the ROI walk.
"""

from __future__ import annotations

import dataclasses

import torch

from ..color.transforms import fdiv
from ..core.params import cfield, params
from ..core.types import Colorspace
from ..kernels.pointwise import OP_VIGNETTE, positions
from .base import Op, OpPlan, PlanContext, PointwiseSpec, register

_CONSTS = ("scale", "falloff", "brightness", "saturation", "cx", "cy",
           "whratio", "shape")


@params(op="vignette", version=4)
@dataclasses.dataclass
class VignetteParams:
    scale: float = cfield("f", 80.0)
    falloff_scale: float = cfield("f", 50.0)
    brightness: float = cfield("f", -0.5)
    saturation: float = cfield("f", -0.5)
    center_x: float = cfield("f", 0.0)
    center_y: float = cfield("f", 0.0)
    autoratio: int = cfield("i", 0)
    whratio: float = cfield("f", 1.0)
    shape: float = cfield("f", 1.0)
    dithering: int = cfield("i", 0)
    unbound: int = cfield("i", 1)


    @classmethod
    def from_legacy(cls, version, raw):
        import struct

        # vignette.c version ladder (vignette.c:222-280)
        if version == 1:  # doubles-era params
            (scale, falloff, strength, _unif, bsratio, inv_f, inv_s,
             cx, cy) = struct.unpack("<5d2i2d", raw[:64])
            brightness = -(1.0 - max(bsratio, 0.0)) * strength / 100.0
            saturation = -(1.0 + min(bsratio, 0.0)) * strength / 100.0
            if inv_s:
                saturation *= -2.0
            if inv_f:
                brightness = -brightness
            return cls(scale=scale, falloff_scale=falloff,
                       brightness=brightness, saturation=saturation,
                       center_x=cx, center_y=cy, autoratio=1,
                       whratio=1.0, shape=1.0, dithering=0, unbound=0)
        if version == 2:
            v = struct.unpack("<6fi2f", raw[:36])
            return cls(scale=v[0], falloff_scale=v[1], brightness=v[2],
                       saturation=v[3], center_x=v[4], center_y=v[5],
                       autoratio=v[6], whratio=v[7], shape=v[8],
                       dithering=0, unbound=0)
        if version == 3:
            v = struct.unpack("<6fi2fi", raw[:40])
            return cls(scale=v[0], falloff_scale=v[1], brightness=v[2],
                       saturation=v[3], center_x=v[4], center_y=v[5],
                       autoratio=v[6], whratio=v[7], shape=v[8],
                       dithering=v[9], unbound=0)
        return None


@register
class Vignette(Op):
    name = "vignette"
    input_colorspace = Colorspace.WORK_RGB

    def coeffs(self, ctx, plan, p: VignetteParams):
        return {"scale": p.scale / 100.0, "falloff": p.falloff_scale / 100.0,
                "brightness": p.brightness, "saturation": p.saturation,
                "cx": p.center_x, "cy": p.center_y,
                "whratio": max(p.whratio, 1e-3), "shape": max(p.shape, 1e-3)}

    def _fn(self, plan):
        hw, hh = plan.spec_in.width / 2.0, plan.spec_in.height / 2.0

        def fn(x, c, yy, xx):
            xs = fdiv(xx - hw, hw) - c["cx"]
            ys = fdiv(yy - hh, hh) - c["cy"]
            return _pixel(x, c, xs, ys)

        return fn, (hw, hh)

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        return self._fn(plan)[0](x, c, *positions(x))

    def pointwise_spec(self, plan, ctx):
        fn, half = self._fn(plan)
        # after the consts: half the frame's width and height
        return PointwiseSpec(fn=fn, opcode=OP_VIGNETTE, consts=_CONSTS,
                             extra=half, needs_pos=True)


def _pixel(x, c, xs, ys):
    # ellipse: whratio <1 widens x, >1 widens y (reference semantics)
    wh = c["whratio"]
    d = torch.sqrt((xs / wh) ** 2 + ys**2)
    d = torch.clamp(d, min=1e-9) ** c["shape"]
    inner = c["scale"]
    outer = inner + torch.clamp(c["falloff"], min=1e-4)
    t = torch.clamp((d - inner) / (outer - inner), 0.0, 1.0)
    # smooth falloff
    t = t * t * (3.0 - 2.0 * t)
    gain = 1.0 + c["brightness"] * t
    out = x * gain[None]
    mean = fdiv(out[0] + out[1] + out[2], 3.0)
    sat = 1.0 + c["saturation"] * t
    return mean[None] + (out - mean[None]) * sat[None]
