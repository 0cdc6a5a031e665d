"""toneequal — exposure-zone tone equalizer over a guided luminance mask.

Reference: `ansel/src/iop/toneequal.c` (params v2, toneequal.c:191-211).
Planning and coefficients are copied from `ansel_tpu/ops/toneequal.py`;
the pixels are torch:

  * the luminance estimator (all seven) with the exposure/contrast boost
    around the -4 EV fulcrum (src/pixel/luminance_mask.h:71-160);
  * the mask smoothed by one of the five detail filters: none, the
    guided filter or the exposure-independent guided filter (EIGF), each
    plain or with geomean blending (`pixel/guided.py`; the EIGF blurs
    through the IIR kernel on the device);
  * the per-pixel gain, a Gaussian radial-basis interpolation of the 8
    centre factors fitted to the 9 user EV sliders (toneequal.c:764-797),
    clamped to [0.25, 4], with optional EV quantization.  The JAX package
    sums the bands as an (8, H, W) reduction; here they add in centre
    order, which rounds differently by an ulp.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.params import cfield, params
from ..pixel.guided import eigf_surface_blur, fast_surface_blur
from .base import Op, OpPlan, PlanContext, register

CHANNELS = 9
PIXEL_CHAN = 8
CENTERS_PARAMS = np.linspace(-8.0, 0.0, CHANNELS)
CENTERS_OPS = np.linspace(-8.0, 0.0, PIXEL_CHAN)
CONTRAST_FULCRUM = 2.0**-4
MIN_FLOAT = 2.0**-16

# filters
TEQ_NONE, TEQ_AVG_GUIDED, TEQ_GUIDED, TEQ_AVG_EIGF, TEQ_EIGF = range(5)
# estimators
(NORM_MEAN, NORM_LIGHTNESS, NORM_VALUE, NORM_1, NORM_2, NORM_POWER,
 NORM_GEOMEAN) = range(7)


@params(op="toneequal", version=2)
@dataclasses.dataclass
class ToneEqualParams:
    noise: float = cfield("f", 0.0)
    ultra_deep_blacks: float = cfield("f", 0.0)
    deep_blacks: float = cfield("f", 0.0)
    blacks: float = cfield("f", 0.0)
    shadows: float = cfield("f", 0.0)
    midtones: float = cfield("f", 0.0)
    highlights: float = cfield("f", 0.0)
    whites: float = cfield("f", 0.0)
    speculars: float = cfield("f", 0.0)
    blending: float = cfield("f", 5.0)
    smoothing: float = cfield("f", math.sqrt(2.0))
    feathering: float = cfield("f", 1.0)
    quantization: float = cfield("f", 0.0)
    contrast_boost: float = cfield("f", 0.0)
    exposure_boost: float = cfield("f", 0.0)
    details: int = cfield("i", TEQ_EIGF)
    method: int = cfield("i", NORM_2)
    iterations: int = cfield("i", 1)

    @classmethod
    def from_legacy(cls, version, raw):
        import struct

        # toneequal.c v1: {9 zones, blending, feathering,
        # contrast_boost, exposure_boost, details, iterations, method}
        # -> quantization 0.01, smoothing sqrt(2)
        if version == 1:
            v = struct.unpack("<13f3i", raw[:64])
            return cls(noise=v[0], ultra_deep_blacks=v[1],
                       deep_blacks=v[2], blacks=v[3], shadows=v[4],
                       midtones=v[5], highlights=v[6], whites=v[7],
                       speculars=v[8], blending=v[9], feathering=v[10],
                       contrast_boost=v[11], exposure_boost=v[12],
                       details=v[13], iterations=v[14], method=v[15],
                       quantization=0.01, smoothing=math.sqrt(2.0))
        return None


def solve_factors(p: ToneEqualParams) -> np.ndarray:
    """RBF least-squares: 9 user EV gains -> 8 center factors."""
    gains = np.exp2([p.noise, p.ultra_deep_blacks, p.deep_blacks, p.blacks,
                     p.shadows, p.midtones, p.highlights, p.whites,
                     p.speculars])
    denom = 2.0 * p.smoothing * p.smoothing
    A = np.exp(-((CENTERS_PARAMS[:, None] - CENTERS_OPS[None, :]) ** 2)
               / denom)
    factors, *_ = np.linalg.lstsq(A, gains, rcond=None)
    return factors


def _estimate(x, method, eb, fulcrum, cb):
    """The luminance estimator of a (3, H, W) image, channel sums in
    channel order."""
    r, g, b = x[0], x[1], x[2]
    if method == NORM_MEAN:
        lum = (r + g + b) / 3.0
    elif method == NORM_LIGHTNESS:
        lum = 0.5 * (torch.maximum(torch.maximum(r, g), b)
                     + torch.minimum(torch.minimum(r, g), b))
    elif method == NORM_VALUE:
        lum = torch.maximum(torch.maximum(r, g), b)
    elif method == NORM_1:
        lum = r.abs() + g.abs() + b.abs()
    elif method == NORM_POWER:
        a = x.abs()
        cube = a * (a * a)
        sq = a * a
        lum = (cube[0] + cube[1] + cube[2]) / torch.clamp(
            sq[0] + sq[1] + sq[2], min=1e-12)
    elif method == NORM_GEOMEAN:
        # the cube root of a product of |RGB| (luminance_mask.h:184-199);
        # torch has no cbrt: the product is >= 0, so its 1/3 power
        lum = (r.abs() * g.abs() * b.abs()) ** (1.0 / 3.0)
    else:  # NORM_2
        lum = torch.sqrt(r * r + g * g + b * b)
    return torch.clamp((eb * lum - fulcrum) * cb + fulcrum, min=MIN_FLOAT)


@register
class ToneEqualizer(Op):
    name = "toneequal"
    input_colorspace = None  # order 24: runs on scene RGB before colorin

    def plan(self, ctx: PlanContext, spec_in, p: ToneEqualParams) -> OpPlan:
        radius = max(1, int(round(p.blending / 100.0
                                  * max(spec_in.width, spec_in.height)
                                  * ctx.scale)))
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=(p.details, p.method, min(p.iterations, 20),
                              radius))

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p: ToneEqualParams):
        return {
            "factors": solve_factors(p).astype(np.float32),
            "gauss_denom": np.float32(2.0 * p.smoothing * p.smoothing),
            "feathering": np.float32(1.0 / p.feathering),
            "exposure_boost": np.float32(2.0**p.exposure_boost),
            "contrast_boost": np.float32(2.0**p.contrast_boost),
            "quantization": np.float32(p.quantization),
        }

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        details, method, iterations, radius = plan.static
        boosted = details in (TEQ_GUIDED, TEQ_EIGF)
        lum = _estimate(x, method, c["exposure_boost"],
                        CONTRAST_FULCRUM if boosted else 0.0,
                        c["contrast_boost"] if boosted else 1.0)
        if details != TEQ_NONE:
            # toneequal.c:829-875: the fast (4x downsampled) surface blurs,
            # iterations inside, geomean blending on the last one only
            geomean = details in (TEQ_AVG_GUIDED, TEQ_AVG_EIGF)
            if details in (TEQ_AVG_EIGF, TEQ_EIGF):
                lum = eigf_surface_blur(lum, float(radius), c["feathering"],
                                        iterations, geomean)
            else:
                lum = fast_surface_blur(lum, radius, c["feathering"],
                                        iterations, geomean)
            lum = torch.clamp(lum, min=MIN_FLOAT)

        exposure = torch.clamp(torch.log2(lum), -8.0, 0.0)
        # optional mask quantization in EV steps (round half to even, as
        # jnp.round)
        q = c["quantization"]
        exposure = torch.where(
            q > 0.0, torch.round(exposure / torch.clamp(q, min=1e-6)) * q,
            exposure)
        # the Gaussian bands one centre at a time, summed in centre order
        # (no (8, H, W) temporaries)
        correction = None
        for k, centre in enumerate(CENTERS_OPS):
            band = torch.exp(-((exposure - float(centre)) ** 2)
                             / c["gauss_denom"]) * c["factors"][k]
            correction = band if correction is None else correction + band
        return x * torch.clamp(correction, 0.25, 4.0)[None]
