"""colorin — input color profile: camera RGB -> working RGB.

Reference: `ansel/src/iop/colorin.c` (params v7, colorin.c:119-129).  The
matrix path (camera matrix to XYZ, then the working-profile matrix,
folded into one 3x3 at plan time) is ported; planning is copied from
`ansel_tpu/ops/colorin.py`.  Custom ICC input profiles
(DT_COLORSPACE_FILE) raise at plan time.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..color import matrices as cm
from ..color.transforms import apply_matrix
from ..core.params import cfield, params
from ..core.types import Colorspace, ImageSpec
from ..kernels.pointwise import OP_MATRIX
from .base import Op, OpPlan, PlanContext, PointwiseSpec, not_ported, register

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

    def plan(self, ctx: PlanContext, spec_in: ImageSpec, p: ColorinParams) -> OpPlan:
        if p.type == CS_FILE:
            raise not_ported(self.name, "a custom ICC input profile")
        work = _WORK_NAMES.get(p.type_work, "rec2020")
        ctx.notes["work_profile"] = work
        fname = p.filename if p.type == CS_FILE else ""
        if isinstance(fname, bytes):
            fname = fname.split(b"\0")[0].decode("utf-8", "ignore")
        return OpPlan(
            spec_in=spec_in,
            spec_out=spec_in.with_colorspace(Colorspace.WORK_RGB),
            static=(p.type, work, fname.strip("\0")),
        )

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p: ColorinParams):
        meta = ctx.meta
        if p.type == CS_FILE:
            return {"M": np.eye(3, dtype=np.float32)}  # ICC path in apply
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
        return _colorin(x, c)

    def pointwise_spec(self, plan, ctx):
        return PointwiseSpec(fn=_colorin, opcode=OP_MATRIX, consts=("M",))


def _colorin(x, c):
    return apply_matrix(x, c["M"])
