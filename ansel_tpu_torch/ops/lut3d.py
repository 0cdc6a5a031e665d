"""lut3d — 3D colour LUT application (.cube / .3dl / Hald CLUT / G'MIC
compressed keypoints).

Reference: `ansel/src/iop/lut3d.c`: params v3 (:100-108), tetrahedral
interpolation (data/kernels/lut3d.cl:23-95, src/common/lut3d.c:63), the
trilinear fallback and the application colour spaces (:85-89: sRGB,
Adobe RGB, gamma Rec709, linear Rec709/2020).  Planning, the params
ladder and the file search are copied from `ansel_tpu/ops/lut3d.py`: the
table is loaded once in `plan` (a missing or bad file is the identity,
as a missing lut folder is in the reference) and goes to the device as
the `clut` coefficient; the eight corner fetches are torch gathers.
`lut3d_sample` is also the ICC profiles' CLUT sampler (`color/icc.py`).

The JAX op has no fused form, so the stage splits the chain there, as
in the JAX engine.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..color import matrices as cm
from ..color.transforms import apply_matrix, fdiv, srgb_decode, srgb_encode
from ..core.params import cfield, params
from ..core.types import Colorspace
from .base import Op, OpPlan, PlanContext, register

CS_SRGB = 0
CS_ARGB = 1
CS_REC709 = 2
CS_LIN_REC709 = 3
CS_LIN_REC2020 = 4

INTERP_TETRAHEDRAL = 0
INTERP_TRILINEAR = 1
INTERP_PYRAMID = 2

# the Adobe RGB transfer's exponent and its inverse, as float32 (JAX's
# weak-typed exponents)
_ARGB_GAMMA = float(np.float32(2.19921875))
_ARGB_INV = float(np.float32(1.0 / 2.19921875))
_INV_045 = float(np.float32(1.0 / 0.45))


@params(op="lut3d", version=3)
@dataclasses.dataclass
class Lut3DParams:
    filepath: str = cfield("s:512", "")
    colorspace: int = cfield("i", CS_SRGB)
    interpolation: int = cfield("i", INTERP_TETRAHEDRAL)
    nb_keypoints: int = cfield("i", 0)
    # raw bytes: inline compressed-CLUT keypoints (lut3d.c:106 c_clut,
    # 2048 keypoints x 6 uchars), expanded by io/gmz.decompress_clut
    c_clut: bytes = cfield("raw:12288", b"")
    lutname: str = cfield("s:128", "")

    @classmethod
    def from_legacy(cls, version, raw):
        import struct

        def cut(b):
            return b.split(b"\x00")[0].decode("utf-8", "replace")

        # lut3d.c ladder: v1 {path[512], cs, interp};
        # v2 adds keypoints + c_clut (lutname appended in v3)
        if version == 1:
            v = struct.unpack("<512s2i", raw[:520])
            return cls(filepath=cut(v[0]), colorspace=v[1],
                       interpolation=v[2], nb_keypoints=0)
        if version == 2:
            v = struct.unpack("<512s3i12288s", raw[:12812])
            return cls(filepath=cut(v[0]), colorspace=v[1],
                       interpolation=v[2], nb_keypoints=v[3],
                       c_clut=v[4])
        return None


def _gamma709(x):
    return torch.where(x < 0.018, 4.5 * x,
                       1.099 * torch.clamp(x, min=1e-9) ** 0.45 - 0.099)


def _degamma709(x):
    return torch.where(x < 0.081, fdiv(x, 4.5),
                       fdiv(torch.clamp(x, min=1e-9) + 0.099, 1.099)
                       ** _INV_045)


def lut3d_sample(t: torch.Tensor, flat: torch.Tensor, level: int,
                 interp: int) -> torch.Tensor:
    """(3, H, W) code values in [0, 1] + (level^3, 3) LUT (index r + g*L +
    b*L^2) -> (3, H, W); trilinear or tetrahedral (lut3d.cl:23-95), with
    the JAX function's expressions: the truncating int32 cell, its clip
    to [0, L - 2], the eight corner gathers and all six tetrahedra
    before the nested select."""
    L = level
    d = t * (L - 1.0)
    i0 = torch.clamp(d.to(torch.int32), 0, L - 2)
    f = d - i0
    base = (i0[0] + i0[1] * L + i0[2] * (L * L)).long()
    h, w = base.shape

    def P(dr, dg, db):
        idx = (base + (dr + dg * L + db * L * L)).reshape(-1)
        return flat.index_select(0, idx).reshape(h, w, 3)

    r, g, b = f[0][..., None], f[1][..., None], f[2][..., None]
    c000, c111 = P(0, 0, 0), P(1, 1, 1)
    c100, c010, c001 = P(1, 0, 0), P(0, 1, 0), P(0, 0, 1)
    c110, c101, c011 = P(1, 1, 0), P(1, 0, 1), P(0, 1, 1)
    if interp == INTERP_TRILINEAR:
        c00 = c000 * (1 - r) + c100 * r
        c10 = c010 * (1 - r) + c110 * r
        c01 = c001 * (1 - r) + c101 * r
        c11 = c011 * (1 - r) + c111 * r
        out = (c00 * (1 - g) + c10 * g) * (1 - b) \
            + (c01 * (1 - g) + c11 * g) * b
    else:
        # tetrahedral (lut3d.cl:66-95); pyramid maps here too
        t1 = (1 - r) * c000 + (r - g) * c100 + (g - b) * c110 + b * c111
        t2 = (1 - r) * c000 + (r - b) * c100 + (b - g) * c101 + g * c111
        t3 = (1 - b) * c000 + (b - r) * c001 + (r - g) * c101 + g * c111
        t4 = (1 - b) * c000 + (b - g) * c001 + (g - r) * c011 + r * c111
        t5 = (1 - g) * c000 + (g - b) * c010 + (b - r) * c011 + r * c111
        t6 = (1 - g) * c000 + (g - r) * c010 + (r - b) * c110 + b * c111
        out = torch.where(
            r > g,
            torch.where(g > b, t1, torch.where(r > b, t2, t3)),
            torch.where(b > g, t4, torch.where(b > r, t5, t6)))
    return out.permute(2, 0, 1).contiguous()


def load_table(p: "Lut3DParams"):
    """(clut (level, level, level, 3) float32 or None, level, the path
    searched), as `ansel_tpu/ops/lut3d.py:126-168` resolves them."""
    path = p.filepath
    if isinstance(path, bytes):
        path = path.split(b"\0")[0].decode("utf-8", "replace")
    path = path.rstrip("\0")
    clut = None
    level = 0
    if p.nb_keypoints > 0:
        # compressed G'MIC CLUT: the keypoints travel inline in the params
        # blob (lut3d.c:245-276 via lut3dgmic.cpp); no file is read
        from ..io.gmz import clut_from_params

        c_raw = (p.c_clut if isinstance(p.c_clut, (bytes, bytearray))
                 else str(p.c_clut).encode("latin-1", "replace"))
        clut = clut_from_params(c_raw, p.nb_keypoints)
        if clut is not None:
            level = clut.shape[0]
    if clut is None and path:
        if not os.path.isabs(path):
            path = os.path.join(os.environ.get("ANSEL_TPU_LUT_ROOT", ""),
                                path)
        try:
            if path.lower().endswith(".gmz"):
                # a .gmz archive: the named LUT (or the first)
                from ..io.gmz import decompress_clut, read_gmz

                luts = read_gmz(path)
                want = (p.lutname or "").rstrip("\0")
                kp = next((k for n, k in luts if n == want),
                          luts[0][1] if luts else None)
                if kp is not None:
                    clut = decompress_clut(kp)
            else:
                from ..io.lut3d_file import load_lut3d

                clut = load_lut3d(path)
            if clut is not None:
                level = clut.shape[0]
        except (OSError, ValueError):
            clut = None  # a missing or bad file is the identity
    return clut, level, path


@register
class Lut3D(Op):
    name = "lut3d"
    input_colorspace = Colorspace.WORK_RGB

    def plan(self, ctx: PlanContext, spec_in, p: Lut3DParams) -> OpPlan:
        clut, level, path = load_table(p)
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=(p.colorspace, p.interpolation, level, path),
                      aux={"clut": clut})

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p: Lut3DParams):
        clut = plan.aux["clut"]
        if clut is None:
            return {}
        return {"clut": clut.reshape(-1, 3)}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        cs, interp, level, _path = plan.static
        if level == 0:
            return x
        # work RGB -> the application space, display-encoded where it is
        to_lin = {
            CS_SRGB: "srgb", CS_ARGB: "adobergb", CS_REC709: "srgb",
            CS_LIN_REC709: "srgb", CS_LIN_REC2020: "rec2020",
        }[cs]
        M = cm.rgb_to_rgb_matrix(cm.WORK_PROFILE, to_lin).tolist()
        Mi = cm.rgb_to_rgb_matrix(to_lin, cm.WORK_PROFILE).tolist()
        t = apply_matrix(x, M)
        if cs == CS_SRGB:
            t = srgb_encode(torch.clamp(t, 0.0, 1.0))
        elif cs == CS_ARGB:
            t = torch.clamp(t, min=1e-9) ** _ARGB_INV
        elif cs == CS_REC709:
            t = _gamma709(torch.clamp(t, 0.0, 1.0))
        t = torch.clamp(t, 0.0, 1.0)

        out = lut3d_sample(t, c["clut"], level, interp)

        if cs == CS_SRGB:
            out = srgb_decode(torch.clamp(out, 0.0, 1.0))
        elif cs == CS_ARGB:
            out = torch.clamp(out, min=0.0) ** _ARGB_GAMMA
        elif cs == CS_REC709:
            out = _degamma709(torch.clamp(out, 0.0, 1.0))
        return apply_matrix(out, Mi)
