"""diffuse — anisotropic heat-transfer PDE on B-spline wavelet scales
("diffuse or sharpen").

Reference: `ansel/src/iop/diffuse.c` (params v2/v3, diffuse.c:76-108).
Planning and coefficients are copied from `ansel_tpu/ops/diffuse.py`,
and so is its choice of path at each call:

  * at most `kernel.MAX_SCALES` (5) wavelet scales: each iteration is one
    call of the diffuse kernel's wrapper (`kernels/diffuse.py`: the CUDA
    kernel on the device, its plain twin on the CPU), which computes what
    the TPU's Pallas kernel computes, the a-trous decompose and the
    coarse-to-fine anisotropic update on the image edge-padded once;
  * more scales: the JAX package's XLA form (`one_iteration`,
    `_pde_step`), in torch here: the decompose through
    `pixel/wavelets.bspline_blur` (the sepblur kernel on the device,
    edge-padded at every blur) and each scale's PDE step on the nine
    shifts of its operands, taken as slices of one edge-padded copy per
    operand (`pixel/shifts.PaddedView`, re-padded at every step as the
    XLA form does).

The inpainting threshold mask is plain torch after the iterations, as in
the JAX package.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.params import cfield, params
from ..core.types import Colorspace
from ..kernels import diffuse as kernel
from ..pixel.shifts import PaddedView
from ..pixel.wavelets import bspline_blur
from .base import Op, OpPlan, PlanContext, register

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


def _shifts9(x, mult: int):
    """The dilated 3x3 neighbourhood as 9 views of one edge-padded copy
    (`_shifts9` of the JAX package: padded at every call)."""
    pv = PaddedView(x, mult)
    return [pv.at(ii * mult, jj * mult)
            for ii in (-1, 0, 1) for jj in (-1, 0, 1)]


def _direction(gx, gy):
    """-> (cos2, sin2, cos*sin, magnitude) with arg 0 where the magnitude
    is 0 (the JAX package's rsqrt form)."""
    m2 = gx * gx + gy * gy
    nonzero = (m2 != 0.0).to(gx.dtype)
    inv = torch.rsqrt(m2 + (1.0 - nonzero))
    cx = gx * inv + (1.0 - nonzero)
    sy = gy * inv
    return cx * cx, sy * sy, cx * sy, m2 * inv


def _kernel9(c2, cs, c_sq, s_sq, mode: int):
    """The 9 anisotropic Laplacian taps (diffuse.c:648-732); the
    isotrope's as Python floats."""
    if mode == ISO_ISOTROPE:
        return [0.25, 0.5, 0.25, 0.5, -3.0, 0.5, 0.25, 0.5, 0.25]
    if mode == ISO_ISOPHOTE:
        a11 = c_sq + c2 * s_sq
        a22 = c2 * c_sq + s_sq
        a12 = (c2 - 1.0) * cs
    else:  # gradient
        a11 = c2 * c_sq + s_sq
        a22 = c_sq + c2 * s_sq
        a12 = (1.0 - c2) * cs
    b11 = a12 * 0.5
    b13 = -b11
    b22 = -2.0 * (a11 + a22)
    return [b11, a22, b13, a11, b22, a11, b13, a22, b11]


def _pde_step(HF, LF, c, s: int, modes):
    """One scale's anisotropic update (the JAX package's `_pde_step`, in
    its operation order); each kernel's taps live only while its
    derivative is summed."""
    mult = 1 << s
    nHF = _shifts9(HF, mult)
    nLF = _shifts9(LF, mult)
    flt_min = 1e-8

    # 1/LF once, then shifted (elementwise commutes with shifts)
    rcp = 1.0 / (torch.clamp(LF - flt_min, min=0.0) + flt_min)
    nR = _shifts9(rcp, mult)
    energy = sum((h * r) ** 2 for h, r in zip(nHF, nR))
    del nR, rcp
    energy = torch.clamp(
        c["variance_threshold"] + energy * c["norm_reg"][s] - flt_min,
        min=0.0) + flt_min

    # gradients on LF, "laplacian direction" on HF (same stencil)
    gx_lf = (nLF[7] - nLF[1]) * 0.5
    gy_lf = (nLF[5] - nLF[3]) * 0.5
    gx_hf = (nHF[7] - nHF[1]) * 0.5
    gy_hf = (nHF[5] - nHF[3]) * 0.5
    c_sq_g, s_sq_g, cs_g, mag_g = _direction(gx_lf, gy_lf)
    c_sq_l, s_sq_l, cs_l, mag_l = _direction(gx_hf, gy_hf)
    del gx_lf, gy_lf, gx_hf, gy_hf
    aniso = c["aniso"]
    ABCD = c["ABCD"][s]
    update = torch.zeros_like(HF)
    for k, (mag, cs, c_sq, s_sq, src) in enumerate((
            (mag_g, cs_g, c_sq_g, s_sq_g, nLF),
            (mag_l, cs_l, c_sq_l, s_sq_l, nLF),
            (mag_g, cs_g, c_sq_g, s_sq_g, nHF),
            (mag_l, cs_l, c_sq_l, s_sq_l, nHF))):
        c2 = torch.exp(-mag * aniso[k])
        kern = _kernel9(c2, cs, c_sq, s_sq, modes[k])
        deriv = sum(kt * sv for kt, sv in zip(kern, src))
        update = update + ABCD[k] * deriv
        del c2, kern, deriv
    acc = HF * c["strength"][s] + update / energy
    return torch.clamp(acc + LF, min=0.0)


def _iteration_wide(img, c, scales: int, modes):
    """One iteration of the JAX package's XLA form (`one_iteration`): the
    decompose, then the coarse-to-fine update."""
    HF = []
    cur = img
    for s in range(scales):
        low = bspline_blur(cur, s)
        HF.append(cur - low)
        cur = low
    buf = cur
    for s in range(scales - 1, -1, -1):
        buf = _pde_step(HF[s], buf, c, s, modes)
        HF[s] = None
    return buf


@register
class Diffuse(Op):
    name = "diffuse"
    input_colorspace = Colorspace.WORK_RGB

    def plan(self, ctx: PlanContext, spec_in, p: DiffuseParams) -> OpPlan:
        zoom = max(ctx.scale, 1e-3)
        final_radius = (p.radius + p.radius_center) * 2.0 / zoom
        scales = _num_scales(final_radius)
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
            if scales <= kernel.MAX_SCALES:
                out = kernel.diffuse_iteration(out, c, scales, modes)
            else:
                out = _iteration_wide(out, c, scales, modes)
        if has_mask:
            # inpainting-threshold mode: processed only where any channel
            # exceeds the threshold (the reference builds a hard mask)
            mask = torch.any(x > c["threshold"], dim=0, keepdim=True)
            out = torch.where(mask, out, x)
        return out
