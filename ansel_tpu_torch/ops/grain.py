"""grain — simulated film grain on Lab L.

Reference: `ansel/src/iop/grain.c` (params v2, grain.c:94-103).  As in
`ansel_tpu/ops/grain.py`, whose planning, coefficients and v1 ladder are
copied here: a normal draw of JAX's generator (`pixel/prng`, key 773),
smoothed to the grain's coarseness by three box means
(`pixel/blur.fast_gaussian`) and renormalised to unit deviation, added to
L with a weight that favours the mid greys.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.params import cfield, params
from ..core.types import Colorspace
from ..pixel import prng
from ..pixel.blur import fast_gaussian
from .base import Op, OpPlan, PlanContext, register

GRAIN_SCALE_FACTOR = 213.2
GRAIN_SEED = 773


@params(op="grain", version=2)
@dataclasses.dataclass
class GrainParams:
    channel: int = cfield("i", 0)
    scale: float = cfield("f", 1600.0 / GRAIN_SCALE_FACTOR)
    strength: float = cfield("f", 25.0)
    midtones_bias: float = cfield("f", 100.0)

    @classmethod
    def from_legacy(cls, version, raw):
        import struct

        # grain.c v1 {channel, scale, strength}; midtones_bias = 0
        # reproduces the old output exactly (grain.c legacy_params)
        if version == 1:
            ch, sc, st = struct.unpack("<i2f", raw[:12])
            return cls(channel=ch, scale=sc, strength=st,
                       midtones_bias=0.0)
        return None


@register
class Grain(Op):
    name = "grain"
    input_colorspace = Colorspace.LAB

    def plan(self, ctx: PlanContext, spec_in, p: GrainParams) -> OpPlan:
        coarseness = max(p.scale * ctx.scale / 2.0, 0.5)
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=round(coarseness, 3))

    def coeffs(self, ctx, plan, p):
        return {"strength": p.strength / 100.0 * 25.0,  # ~L units
                "bias": p.midtones_bias / 100.0}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        coarseness = plan.static
        h, w = x.shape[-2:]
        noise = prng.normal(prng.PRNGKey(GRAIN_SEED), (h, w), x.device)
        if coarseness > 1.0:
            noise = fast_gaussian(noise, coarseness)
            # renormalise the deviation after smoothing (jnp.std: ddof 0)
            noise = noise / torch.clamp(torch.std(noise, correction=0),
                                        min=1e-6)
        L = x[0]
        # midtone weight: full at L = 50, tapered toward black and white
        mt = torch.exp(-((L - 50.0) ** 2) / (2.0 * 35.0 ** 2))
        weight = (1.0 - c["bias"]) + c["bias"] * mt
        return torch.stack([L + c["strength"] * weight * noise, x[1], x[2]])
