"""dither — quantisation dithering before 8-bit output.

Reference: `ansel/src/iop/dither.c` (params v1).  As in
`ansel_tpu/ops/dither.py`, whose planning and coefficients are copied
here: every Floyd-Steinberg mode is a random dither of one output level's
amplitude (the level count the mode's bit depth gives), the random mode
scaled by the damping; the uniform draw is JAX's generator's
(`pixel/prng`, key 353), in the JAX package's order of float operations.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.params import cfield, params
from ..core.types import Colorspace
from ..pixel import prng
from .base import Op, OpPlan, PlanContext, register

DITHER_OFF = 0
DITHER_FS1BIT = 1
DITHER_FS4BIT_GRAY = 2
DITHER_FS8BIT = 3
DITHER_FS16BIT = 4
DITHER_FSAUTO = 5
DITHER_RANDOM = 6
DITHER_SEED = 353


@params(op="dither", version=1)
@dataclasses.dataclass
class DitherParams:
    dither_type: int = cfield("i", DITHER_FSAUTO)
    palette: int = cfield("i", 0)
    radius: float = cfield("f", 0.0)
    range: tuple = cfield("4f", (0.0, 0.0, 1.0, 1.0))
    damping: float = cfield("f", -200.0)


@register
class Dither(Op):
    name = "dither"
    input_colorspace = Colorspace.DISPLAY_RGB

    def plan(self, ctx: PlanContext, spec_in, p: DitherParams) -> OpPlan:
        levels = {DITHER_FS1BIT: 2, DITHER_FS4BIT_GRAY: 16}.get(
            p.dither_type, 256)
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=(p.dither_type, levels))

    def coeffs(self, ctx, plan, p):
        return {"damping": 10.0 ** (p.damping / 20.0)}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        dtype_, levels = plan.static
        if dtype_ == DITHER_OFF:
            return x
        amp = 1.0 / (levels - 1)
        u = prng.uniform(prng.PRNGKey(DITHER_SEED), x.shape, device=x.device)
        noise = (u - 0.5) * amp
        if dtype_ == DITHER_RANDOM:
            noise = noise * c["damping"] * (levels - 1)
        return torch.clamp(x + noise, 0.0, 1.0)
