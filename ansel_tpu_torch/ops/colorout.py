"""colorout — working RGB -> output color profile (display-referred).

Reference: `ansel/src/iop/colorout.c` (params v5, colorout.c:107-112).
The matrix path with its transfer curve (sRGB, linear or a pure gamma)
rides the chain kernel; planning is copied from
`ansel_tpu/ops/colorout.py`.  DT_COLORSPACE_FILE renders through a custom
ICC output profile (`_apply_icc`, `ansel_tpu/ops/colorout.py:113-150`):
a matrix+TRC profile by its inverse matrix and a 40-node monotone Hermite
inverse of each TRC, a LUT profile through its B2A LUT.  The profile is
found and every curve fitted at plan time here (the JAX package does it
inside its traced `apply`, which its jit runs once), and the fits and the
CLUT are the stage's coefficients beside the JAX package's identity `M`.
That branch has no fused form in the JAX package, so it splits the chain
there.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..color import matrices as cm
from ..color.transforms import apply_matrix, gamma_encode, srgb_encode
from ..core.params import cfield, params
from ..core.types import Colorspace, ImageSpec
from ..kernels.pointwise import OP_COLOROUT, TRC_GAMMA, TRC_LINEAR, TRC_SRGB
from .base import Op, OpPlan, PlanContext, PointwiseSpec, register
from .colorin import (CS_ADOBERGB, CS_DISPLAY_P3, CS_LIN_REC709,
                      CS_LIN_REC2020, CS_PROPHOTO, CS_REC709, CS_SRGB,
                      _WORK_NAMES)

# transfer curves per output profile type
_TRC = {
    CS_SRGB: "srgb",
    CS_DISPLAY_P3: "srgb",
    CS_ADOBERGB: ("gamma", 563.0 / 256.0),  # AdobeRGB 2.19921875
    CS_REC709: ("gamma", 1.0 / 0.45),
    CS_LIN_REC709: "linear",
    CS_LIN_REC2020: "linear",
    CS_PROPHOTO: ("gamma", 1.8),
}


@params(op="colorout", version=5)
@dataclasses.dataclass
class ColoroutParams:
    type: int = cfield("i", CS_SRGB)
    filename: str = cfield("s:512", "")
    intent: int = cfield("i", 0)


    @classmethod
    def from_legacy(cls, version, raw):
        import struct

        def cut(b):
            return b.split(b"\x00")[0].decode("utf-8", "replace")

        # colorout.c ladder (:120-210): named-profile strings -> types
        names = {"sRGB": 0, "linear_rec709_rgb": 4, "linear_rgb": 4,
                 "linear_rec2020_rgb": 5, "adobergb": 1,
                 "X profile": -2}
        if version in (2, 3):
            v = struct.unpack("<100s100s2i", raw[:208])
            prof = cut(v[0])
            if prof in names:
                return cls(type=names[prof], intent=v[2])
            return cls(type=99, filename=prof, intent=v[2])
        if version == 4:
            v = struct.unpack("<i100si", raw[:108])
            return cls(type=v[0], filename=cut(v[1]), intent=v[2])
        return None


@register
class Colorout(Op):
    name = "colorout"
    input_colorspace = Colorspace.WORK_RGB
    mandatory = True

    def plan(self, ctx: PlanContext, spec_in: ImageSpec, p: ColoroutParams) -> OpPlan:
        if p.type == 0:  # DT_COLORSPACE_FILE: custom ICC output profile
            fname = p.filename
            if isinstance(fname, bytes):
                fname = fname.split(b"\0")[0].decode("utf-8", "ignore")
            fname = fname.strip("\0")
            return OpPlan(
                spec_in=spec_in,
                spec_out=spec_in.with_colorspace(Colorspace.DISPLAY_RGB),
                static=("icc", fname), aux=_load_output_icc(ctx, fname))
        trc = _TRC.get(p.type, "srgb")
        dst = _WORK_NAMES.get(p.type, "srgb")
        return OpPlan(
            spec_in=spec_in,
            spec_out=spec_in.with_colorspace(Colorspace.DISPLAY_RGB),
            static=(dst, trc),
        )

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p: ColoroutParams):
        dst, _ = plan.static
        if dst == "icc":
            from ..color import icc as icc_mod

            return {"M": np.eye(3, dtype=np.float32),
                    **icc_mod.to_output_coeffs(plan.aux)}
        work = ctx.notes.get("work_profile", cm.WORK_PROFILE)
        M = cm.rgb_to_rgb_matrix(work, dst)
        return {"M": M.astype(np.float32)}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        if plan.static[0] == "icc":
            return _apply_icc(x, c, plan.aux)
        return _colorout(x, c, plan.static[1])

    def pointwise_spec(self, plan, ctx):
        if plan.static[0] == "icc":
            return None  # inverse curves or a B2A LUT: not fused
        trc = plan.static[1]
        if trc == "srgb":
            code, extra = TRC_SRGB, ()
        elif trc == "linear":
            code, extra = TRC_LINEAR, ()
        else:
            code, extra = TRC_GAMMA, (float(np.float32(1.0 / trc[1])),)
        return PointwiseSpec(fn=lambda x, c: _colorout(x, c, trc),
                             opcode=OP_COLOROUT, consts=("M",),
                             ints=(code,), extra=extra)


def _colorout(x, c, trc):
    y = torch.clamp(apply_matrix(x, c["M"]), 0.0, 1.0)
    if trc == "srgb":
        return srgb_encode(y)
    if trc == "linear":
        return y
    return gamma_encode(y, trc[1])


def _load_output_icc(ctx, fname):
    """The output profile (`icc.find_profile`); a LUT profile must carry
    a B2A LUT."""
    from ..color import icc as icc_mod

    prof = icc_mod.find_profile(ctx.meta, fname, "out")
    if prof.kind != "matrix" and prof.b2a is None:
        raise ValueError("colorout: LUT output profile has no B2A tag")
    return prof


def _apply_icc(x, c, prof):
    """Work RGB -> XYZ D50 -> the profile's device values: its inverse
    matrix and inverse TRCs, or its B2A LUT."""
    from ..color import icc as icc_mod
    from ..pixel.curves import eval_curve

    xyz = apply_matrix(x, cm.XYZ_FROM_WORK.tolist())
    if prof.kind != "matrix":
        return torch.clamp(icc_mod.xyz_to_device_fn(prof, c)(xyz), 0.0, 1.0)
    lin = apply_matrix(xyz, np.linalg.inv(prof.to_xyz).tolist())
    lin = torch.clamp(lin, 0.0, 1.0)
    return torch.clamp(torch.stack([eval_curve(lin[ch], *c[f"inv{ch}"])
                                    for ch in range(3)]), 0.0, 1.0)
