"""colorize — replace the chroma with a fixed hue and saturation.

Reference: `ansel/src/iop/colorize.c` (params v2 :83-90, process), as
`ansel_tpu/ops/colorize.py` has it: L out = L target - mix 50 + L in mix,
a and b the tint's Lab chroma (hue and saturation through HSL to linear
sRGB to Lab on the host).
"""

from __future__ import annotations

import colorsys
import dataclasses

import numpy as np
import torch

from ..color import matrices as cm
from ..core.params import cfield, params
from ..core.types import Colorspace
from ..kernels.pointwise import OP_COLORIZE
from .base import Op, OpPlan, PlanContext, PointwiseSpec, register


def _lab_from_srgb_linear(rgb):
    xyz = cm.profile_matrix("srgb", to_xyz=True,
                            dst_white_xy=cm.PIPE_WHITE_XY) @ np.asarray(rgb)
    wn = cm.PIPE_WHITE_XYZ
    r = xyz / wn
    eps, kappa = 216.0 / 24389.0, 24389.0 / 27.0
    f = np.where(r > eps, np.cbrt(np.maximum(r, 1e-12)),
                 (kappa * r + 16.0) / 116.0)
    return (116.0 * f[1] - 16.0, 500.0 * (f[0] - f[1]),
            200.0 * (f[1] - f[2]))


@params(op="colorize", version=2)
@dataclasses.dataclass
class ColorizeParams:
    hue: float = cfield("f", 0.0)
    saturation: float = cfield("f", 0.5)
    source_lightness_mix: float = cfield("f", 50.0)
    lightness: float = cfield("f", 50.0)
    version: int = cfield("i", 2)


    @classmethod
    def from_legacy(cls, version, raw):
        import struct

        # colorize.c v1 -> v2 keeps values, tags version=1 (old L mix)
        if version == 1:
            h, s, mix, l = struct.unpack("<4f", raw[:16])
            return cls(hue=h, saturation=s, source_lightness_mix=mix,
                       lightness=l, version=1)
        return None


@register
class Colorize(Op):
    name = "colorize"
    input_colorspace = Colorspace.LAB

    def coeffs(self, ctx, plan, p: ColorizeParams):
        rgb = colorsys.hls_to_rgb(p.hue, 0.5, p.saturation)
        _, a, b = _lab_from_srgb_linear(rgb)
        mix = p.source_lightness_mix / 100.0
        return {"a": np.float32(a), "b": np.float32(b),
                "Lmlmix": np.float32(p.lightness - mix * 100.0 / 2.0),
                "mix": np.float32(mix)}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        return _pixel(x, c)

    def pointwise_spec(self, plan, ctx):
        return PointwiseSpec(fn=_pixel, opcode=OP_COLORIZE,
                             consts=("Lmlmix", "mix", "a", "b"))


def _pixel(x, c):
    L = c["Lmlmix"] + x[0] * c["mix"]
    zero = torch.zeros_like(L)
    return torch.stack([L, zero + c["a"], zero + c["b"]])
