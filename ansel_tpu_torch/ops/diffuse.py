"""diffuse — anisotropic heat-transfer PDE on B-spline wavelet scales
("diffuse or sharpen").

Reference: `ansel/src/iop/diffuse.c` (params v2/v3, diffuse.c:76-108).
Planning and coefficients are copied from `ansel_tpu/ops/diffuse.py`.
Each iteration is one call of the diffuse kernel's wrapper
(`kernels/diffuse.py`: the CUDA kernel on the device, its plain twin on
the CPU), which computes what the TPU's Pallas kernel computes: the
a-trous decompose and the coarse-to-fine anisotropic update on the image
edge-padded once.  The inpainting threshold mask is plain torch after the
iterations, as in the JAX package.

Not ported, refused while planning: plans of more than MAX_SCALES (5)
wavelet scales, which the TPU runs through its XLA path (per-stage
padding, other border values); the port has no such path.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.params import cfield, params
from ..core.types import Colorspace
from ..kernels import diffuse as kernel
from .base import Op, OpPlan, PlanContext, not_ported, register

B_SPLINE_SIGMA = 1.0553651328015339
KAPPA = 0.25
MAX_NUM_SCALES = 10

ISO_ISOTROPE, ISO_ISOPHOTE, ISO_GRADIENT = 0, 1, 2


@params(op="diffuse", version=3)
@dataclasses.dataclass
class DiffuseParams:
    iterations: int = cfield("i", 1)
    sharpness: float = cfield("f", 0.0)
    radius: int = cfield("i", 8)
    regularization: float = cfield("f", 0.0)
    variance_threshold: float = cfield("f", 0.0)
    anisotropy_first: float = cfield("f", 0.0)
    anisotropy_second: float = cfield("f", 0.0)
    anisotropy_third: float = cfield("f", 0.0)
    anisotropy_fourth: float = cfield("f", 0.0)
    threshold: float = cfield("f", 0.0)
    first: float = cfield("f", 0.0)
    second: float = cfield("f", 0.0)
    third: float = cfield("f", 0.0)
    fourth: float = cfield("f", 0.0)
    radius_center: int = cfield("i", 0)

    @classmethod
    def from_legacy(cls, version, raw):
        import struct

        if version == 2:
            return cls.codec.decode(raw)  # same layout
        if version == 1:
            vals = struct.unpack("<ififf4ff4f", raw[:4 * 15])
            return cls(iterations=vals[0], sharpness=vals[1], radius=vals[2],
                       regularization=vals[3], variance_threshold=vals[4],
                       anisotropy_first=vals[5], anisotropy_second=vals[6],
                       anisotropy_third=vals[7], anisotropy_fourth=vals[8],
                       threshold=vals[9], first=vals[10], second=vals[11],
                       third=vals[12], fourth=vals[13])
        return None


def _num_scales(final_radius: float) -> int:
    s = 0
    radius = B_SPLINE_SIGMA
    while radius < final_radius:
        s += 1
        radius = math.sqrt(radius**2 + ((1 << s) * B_SPLINE_SIGMA) ** 2)
    return max(1, min(s + 1, MAX_NUM_SCALES))


def _equivalent_sigma(s: int) -> float:
    sig = B_SPLINE_SIGMA
    for i in range(1, s + 1):
        sig = math.sqrt(sig**2 + ((1 << i) * B_SPLINE_SIGMA) ** 2)
    return sig


def _isotropy_mode(a: float) -> int:
    if a == 0.0:
        return ISO_ISOTROPE
    return ISO_ISOPHOTE if a > 0.0 else ISO_GRADIENT


@register
class Diffuse(Op):
    name = "diffuse"
    input_colorspace = Colorspace.WORK_RGB

    def plan(self, ctx: PlanContext, spec_in, p: DiffuseParams) -> OpPlan:
        zoom = max(ctx.scale, 1e-3)
        final_radius = (p.radius + p.radius_center) * 2.0 / zoom
        scales = _num_scales(final_radius)
        if scales > kernel.MAX_SCALES:
            raise not_ported(self.name, f"{scales} wavelet scales (more than "
                             f"{kernel.MAX_SCALES}: the TPU's XLA path)")
        iterations = max(int(p.iterations), 1)
        modes = tuple(_isotropy_mode(a) for a in (
            p.anisotropy_first, p.anisotropy_second, p.anisotropy_third,
            p.anisotropy_fourth))
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=(scales, iterations, modes,
                              bool(p.threshold > 0.0)))

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p: DiffuseParams):
        scales, iterations, modes, _ = plan.static
        zoom = max(ctx.scale, 1e-3)
        regularization = 10.0**p.regularization - 1.0
        variance_threshold = 10.0**p.variance_threshold
        aniso = np.float32([p.anisotropy_first**2, p.anisotropy_second**2,
                            p.anisotropy_third**2, p.anisotropy_fourth**2])
        ABCD = np.zeros((scales, 4), np.float32)
        strength = np.zeros(scales, np.float32)
        norm_reg = np.zeros(scales, np.float32)
        radius = max(float(p.radius), 1e-6)
        for s in range(scales):
            real_radius = _equivalent_sigma(s) * zoom
            norm = math.exp(-((real_radius - p.radius_center) ** 2)
                            / radius**2)
            ABCD[s] = np.float32([p.first, p.second, p.third, p.fourth]) \
                * KAPPA * norm
            strength[s] = p.sharpness * norm + 1.0
            norm_reg[s] = regularization / 9.0 * real_radius**2
        return {
            "aniso": aniso, "ABCD": ABCD, "strength": strength,
            "norm_reg": norm_reg,
            "variance_threshold": np.float32(variance_threshold),
            "threshold": np.float32(p.threshold),
        }

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        scales, iterations, modes, has_mask = plan.static
        out = x.contiguous()
        for _ in range(iterations):
            out = kernel.diffuse_iteration(out, c, scales, modes)
        if has_mask:
            # inpainting-threshold mode: processed only where any channel
            # exceeds the threshold (the reference builds a hard mask)
            mask = torch.any(x > c["threshold"], dim=0, keepdim=True)
            out = torch.where(mask, out, x)
        return out
