"""colorin — input color profile: camera RGB -> working RGB.

Reference: `ansel/src/iop/colorin.c` (params v7, colorin.c:119-129).  The
matrix path (camera matrix to XYZ, then the working-profile matrix,
folded into one 3x3 at plan time) rides the chain kernel; planning is
copied from `ansel_tpu/ops/colorin.py`.  DT_COLORSPACE_FILE loads a
custom ICC profile (matrix+TRC or an A2B LUT, `color/icc.py`) found as
`_resolve_icc` searches for it: at plan time here, so a missing profile
fails before any pixel, and its fitted curves and CLUT are the stage's
coefficients beside the JAX package's identity `M`.  That branch has no
fused form in the JAX package, so it splits the chain there.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..color import matrices as cm
from ..color.transforms import apply_matrix
from ..core.params import cfield, params
from ..core.types import Colorspace, ImageSpec
from ..kernels.pointwise import OP_MATRIX
from .base import Op, OpPlan, PlanContext, PointwiseSpec, register

# dt_colorspaces_color_profile_type_t (src/common/colorspaces.h:90-130)
CS_FILE = 0
CS_SRGB = 1
CS_ADOBERGB = 2
CS_LIN_REC709 = 3
CS_LIN_REC2020 = 4
CS_STANDARD_MATRIX = 11
CS_ENHANCED_MATRIX = 12
CS_REC709 = 20
CS_PROPHOTO = 21
CS_DISPLAY_P3 = 27

_WORK_NAMES = {
    CS_LIN_REC2020: "rec2020",
    CS_LIN_REC709: "srgb",       # Rec709 primaries == sRGB primaries
    CS_PROPHOTO: "prophoto",
    CS_ADOBERGB: "adobergb",
    CS_SRGB: "srgb",
    CS_DISPLAY_P3: "displayp3",
}


@params(op="colorin", version=7)
@dataclasses.dataclass
class ColorinParams:
    type: int = cfield("i", CS_ENHANCED_MATRIX)
    filename: str = cfield("s:512", "")
    intent: int = cfield("i", 0)
    normalize: int = cfield("i", 0)
    blue_mapping: int = cfield("i", 0)
    type_work: int = cfield("i", CS_LIN_REC2020)
    filename_work: str = cfield("s:512", "")

    @classmethod
    def from_legacy(cls, version, raw):
        if version == 6:
            # colorin.c:455-482 — v6 layout == v7; migration only re-validates
            # the working-profile choice (invalid -> linear Rec2020)
            p = cls.codec.decode(raw)
            if p.type_work not in _WORK_NAMES:
                p.type_work = CS_LIN_REC2020
            return p
        return None


@register
class Colorin(Op):
    name = "colorin"
    input_colorspace = Colorspace.CAMERA_RGB
    mandatory = True

    def _resolve_icc(self, ctx, p):
        """DT_COLORSPACE_FILE: load the custom ICC named in params
        (colorspaces.c:2300-2661 LCMS path)."""
        from ..color import icc as icc_mod

        name = p.filename
        if isinstance(name, bytes):
            name = name.split(b"\0")[0].decode("utf-8", "ignore")
        name = (name or "").strip("\0")
        if not name:
            raise ValueError("colorin: type=FILE but no ICC filename")
        return icc_mod.find_profile(ctx.meta, name, "in")

    def plan(self, ctx: PlanContext, spec_in: ImageSpec, p: ColorinParams) -> OpPlan:
        work = _WORK_NAMES.get(p.type_work, "rec2020")
        ctx.notes["work_profile"] = work
        fname = p.filename if p.type == CS_FILE else ""
        if isinstance(fname, bytes):
            fname = fname.split(b"\0")[0].decode("utf-8", "ignore")
        return OpPlan(
            spec_in=spec_in,
            spec_out=spec_in.with_colorspace(Colorspace.WORK_RGB),
            static=(p.type, work, fname.strip("\0")),
            aux=(self._resolve_icc(ctx, p) if p.type == CS_FILE else None),
        )

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p: ColorinParams):
        meta = ctx.meta
        if p.type == CS_FILE:
            from ..color import icc as icc_mod

            return {"M": np.eye(3, dtype=np.float32),
                    **icc_mod.to_xyz_coeffs(plan.aux)}
        if meta.cam_to_xyz is not None and p.type in (
            CS_STANDARD_MATRIX, CS_ENHANCED_MATRIX
        ):
            cam2xyz = np.asarray(meta.cam_to_xyz, dtype=np.float64).reshape(3, 3)
            M = cm.normalized_cam_to_work(cam2xyz)
        else:
            # camera input already in a standard space (e.g. linear DNG)
            src = _WORK_NAMES.get(p.type, "srgb")
            M = cm.rgb_to_rgb_matrix(src, cm.WORK_PROFILE)
        return {"M": M.astype(np.float32)}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        if plan.static[0] == CS_FILE:
            from ..color import icc as icc_mod

            to_xyz = icc_mod.profile_to_xyz_fn(plan.aux, c)
            # ICC PCS is D50; the pipeline XYZ reference is D50 too
            return apply_matrix(to_xyz(x), cm.WORK_FROM_XYZ.tolist())
        return _colorin(x, c)

    def pointwise_spec(self, plan, ctx):
        if plan.static[0] == CS_FILE:
            return None  # curves and perhaps a CLUT: not fused
        return PointwiseSpec(fn=_colorin, opcode=OP_MATRIX, consts=("M",))


def _colorin(x, c):
    return apply_matrix(x, c["M"])
