"""censorize — anonymisation blur and pixelation.

Reference: `ansel/src/iop/censorize.c` (params v1, censorize.c:55-61): a
Gaussian blur, pixelation, a second Gaussian blur, then multiplicative
uniform noise.  As in `ansel_tpu/ops/censorize.py`, whose planning and
coefficients are copied here: the blurs are `pixel/blur.gaussian_blur`
(the sepblur kernel for sigma <= 4, the IIR kernel beyond); pixelation is
an antialiased linear downsample (`jax.image.resize(..., "linear")`,
`pixel/resample.resize_bilinear`) and a nearest upsample
(`pixel/resample.resize_nearest`); the noise is JAX's generator's uniform on [-0.5, 0.5)
(`pixel/prng`, key 1259).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.params import cfield, params
from ..core.types import Colorspace
from ..pixel import prng
from ..pixel.blur import gaussian_blur
from ..pixel.resample import resize_bilinear, resize_nearest
from .base import Op, OpPlan, PlanContext, register

CENSORIZE_SEED = 1259


@params(op="censorize", version=1)
@dataclasses.dataclass
class CensorizeParams:
    radius_1: float = cfield("f", 0.0)
    pixelate: float = cfield("f", 0.0)
    radius_2: float = cfield("f", 0.0)
    noise: float = cfield("f", 0.0)


@register
class Censorize(Op):
    name = "censorize"
    input_colorspace = Colorspace.WORK_RGB

    def plan(self, ctx: PlanContext, spec_in, p: CensorizeParams) -> OpPlan:
        cell = max(int(round(p.pixelate * ctx.scale)), 0)
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=(p.radius_1 * ctx.scale, cell,
                              p.radius_2 * ctx.scale, p.noise > 0.0))

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p: CensorizeParams):
        return {"noise": np.float32(p.noise)}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        r1, cell, r2, has_noise = plan.static
        out = x
        if r1 > 0.1:
            out = gaussian_blur(out, r1)
        if cell > 1:
            C, H, W = out.shape
            hs, ws = max(H // cell, 1), max(W // cell, 1)
            small = resize_bilinear(out, (C, hs, ws))
            out = resize_nearest(small, (C, H, W))
        if r2 > 0.1:
            out = gaussian_blur(out, r2)
        if has_noise:
            n = prng.uniform(prng.PRNGKey(CENSORIZE_SEED), out.shape, -0.5,
                             0.5, device=out.device)
            out = torch.clamp(out * (1.0 + n * c["noise"]), min=0.0)
        return out
