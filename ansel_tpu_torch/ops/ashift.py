"""ashift — perspective and keystone correction (rotation, lens shift,
shear) by one homography.

Reference: `ansel/src/iop/ashift.c` (params :376-395, the homography
:759-970: rotation about the centre, shear, the vertical and horizontal
lens-shift projections with the focal-length-dependent ortho
correction, aspect, translation to positive coordinates), as
`ansel_tpu/ops/ashift.py` has it: the pipe transform is an inverse-
homography bilinear gather with the pixels whose source falls outside
the frame set to 0.  The host builds the homography in float64
(`_homography`, copied); its inverse, rounded to 12 digits and then to
float32, is the warp kernel's map (`_warpcommon.warp_homography`,
`kernels/warp.homography_warp`).  The automatic fit (line detection and
the Nelder-Mead solve) is `ops/ashift_fit.py`.

The plan records a crop from `cropmode` as the JAX package does, and,
as there, nothing applies it: the output frame is the input frame
(ROADMAP R11).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..core.params import cfield, params
from .base import Op, OpPlan, PlanContext, register


def _homography(angle, shift_v, shift_h, shear, f_length_kb, orthocorr,
                aspect, width, height) -> np.ndarray:
    """Forward homography (ashift.c:759-957), numpy double precision."""
    u, v = float(width), float(height)
    phi = math.pi * angle / 180.0
    cosi, sini = math.cos(phi), math.sin(phi)
    ascale = math.sqrt(max(aspect, 1e-6))
    horifac = 1.0 - orthocorr / 100.0
    vertifac = 1.0 - orthocorr / 100.0

    exppa_v = math.exp(shift_v)
    fdb_v = f_length_kb / (14.4 + (v / u - 1.0) * 7.2)
    alpha_v = max(-1.5, min(1.5, math.atan(
        fdb_v * (exppa_v - 1.0) / (exppa_v + 1.0))))
    rt_v = math.sin(0.5 * alpha_v)
    r_v = max(0.1, 2.0 * (horifac - 1.0) * rt_v * rt_v + 1.0)

    exppa_h = math.exp(shift_h)
    fdb_h = f_length_kb / (14.4 + (u / v - 1.0) * 7.2)
    alpha_h = max(-1.5, min(1.5, math.atan(
        fdb_h * (exppa_h - 1.0) / (exppa_h + 1.0))))
    rt_h = math.sin(0.5 * alpha_h)
    r_h = max(0.1, 2.0 * (vertifac - 1.0) * rt_h * rt_h + 1.0)

    swap = np.array([[0.0, 1, 0], [1, 0, 0], [0, 0, 1]])
    M = swap.copy()
    # rotation around the center (in swapped axes)
    rot = np.array([[cosi, -sini, -0.5 * v * cosi + 0.5 * u * sini + 0.5 * v],
                    [sini, cosi, -0.5 * v * sini - 0.5 * u * cosi + 0.5 * u],
                    [0.0, 0, 1]])
    M = rot @ M
    M = np.array([[1.0, shear, 0], [shear, 1, 0], [0, 0, 1]]) @ M
    M = np.array([[exppa_v, 0, 0],
                  [0.5 * (exppa_v - 1.0) * u / v,
                   2.0 * exppa_v / (exppa_v + 1.0),
                   -0.5 * (exppa_v - 1.0) * u / (exppa_v + 1.0)],
                  [(exppa_v - 1.0) / v, 0, 1]]) @ M
    M = np.array([[1.0, 0, 0], [0, r_v, 0.5 * u * (1.0 - r_v)],
                  [0, 0, 1]]) @ M
    M = swap @ M
    M = np.array([[exppa_h, 0, 0],
                  [0.5 * (exppa_h - 1.0) * v / u,
                   2.0 * exppa_h / (exppa_h + 1.0),
                   -0.5 * (exppa_h - 1.0) * v / (exppa_h + 1.0)],
                  [(exppa_h - 1.0) / u, 0, 1]]) @ M
    M = np.array([[1.0, 0, 0], [0, r_h, 0.5 * v * (1.0 - r_h)],
                  [0, 0, 1]]) @ M
    M = np.array([[ascale, 0, 0], [0, 1.0 / ascale, 0], [0, 0, 1]]) @ M

    # translate so the warped frame lands at positive coordinates
    umin, vmin = np.inf, np.inf
    for y in (0.0, v - 1.0):
        for x in (0.0, u - 1.0):
            po = M @ np.array([x, y, 1.0])
            umin = min(umin, po[0] / po[2])
            vmin = min(vmin, po[1] / po[2])
    M = np.array([[1.0, 0, -umin], [0, 1, -vmin], [0, 0, 1]]) @ M
    return M


@params(op="ashift", version=5)
@dataclasses.dataclass
class AshiftParams:
    rotation: float = cfield("f", 0.0)
    lensshift_v: float = cfield("f", 0.0)
    lensshift_h: float = cfield("f", 0.0)
    shear: float = cfield("f", 0.0)
    f_length: float = cfield("f", 28.0)
    crop_factor: float = cfield("f", 1.0)
    orthocorr: float = cfield("f", 100.0)
    aspect: float = cfield("f", 1.0)
    mode: int = cfield("i", 0)
    cropmode: int = cfield("i", 0)
    cl: float = cfield("f", 0.0)
    cr: float = cfield("f", 1.0)
    ct: float = cfield("f", 0.0)
    cb: float = cfield("f", 1.0)
    # GUI line-drawing memory (ashift.c:376-395: MAX_SAVED_LINES=50 drawn
    # lines + count + structure quad) — serialized but unused by the warp
    last_drawn_lines: tuple = cfield("200f", (0.0,) * 200)
    last_drawn_lines_count: int = cfield("i", 0)
    last_quad_lines: tuple = cfield("8f", (0.0,) * 8)

    @classmethod
    def from_legacy(cls, version, raw):
        import struct

        # ashift.c:560-660 version ladder
        if version == 1:  # {rotation, lensshift_v, lensshift_h, toggle}
            r, sv, sh = struct.unpack("<3f", raw[:12])
            return cls(rotation=r, lensshift_v=sv, lensshift_h=sh,
                       mode=0, cropmode=0)
        if version == 2:  # v1 + {f_length, crop_factor, orthocorr, aspect, mode}
            v = struct.unpack("<7fii", raw[:36])
            return cls(rotation=v[0], lensshift_v=v[1], lensshift_h=v[2],
                       f_length=v[3], crop_factor=v[4], orthocorr=v[5],
                       aspect=v[6], mode=v[7], cropmode=0)
        if version == 3:  # v2 + {cropmode, cl, cr, ct, cb}
            v = struct.unpack("<7fiii4f", raw[:56])
            return cls(rotation=v[0], lensshift_v=v[1], lensshift_h=v[2],
                       f_length=v[3], crop_factor=v[4], orthocorr=v[5],
                       aspect=v[6], mode=v[7], cropmode=v[9],
                       cl=v[10], cr=v[11], ct=v[12], cb=v[13])
        if version == 4:  # adds shear, drops nothing; toggle still present
            v = struct.unpack("<8f" + "ii" + "i4f", raw[:60])
            return cls(rotation=v[0], lensshift_v=v[1], lensshift_h=v[2],
                       shear=v[3], f_length=v[4], crop_factor=v[5],
                       orthocorr=v[6], aspect=v[7], mode=v[8],
                       cropmode=v[10], cl=v[11], cr=v[12], ct=v[13],
                       cb=v[14])
        return None


@register
class Ashift(Op):
    name = "ashift"
    input_colorspace = None  # geometric, camera RGB

    def enabled_by_default(self, meta):
        return False

    def plan(self, ctx: PlanContext, spec_in, p: AshiftParams) -> OpPlan:
        neutral = (p.rotation == 0.0 and p.lensshift_v == 0.0
                   and p.lensshift_h == 0.0 and p.shear == 0.0
                   and p.aspect == 1.0)
        if neutral:
            return OpPlan(spec_in=spec_in, spec_out=spec_in, static=None)
        M = _homography(p.rotation, p.lensshift_v, p.lensshift_h, p.shear,
                        p.f_length * p.crop_factor, p.orthocorr, p.aspect,
                        spec_in.width, spec_in.height)
        Minv = np.linalg.inv(M)
        crop = (p.cl, p.ct, p.cr, p.cb) if p.cropmode else None
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=(tuple(np.round(Minv, 12).reshape(-1)), crop))

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        if plan.static is None:
            return x
        from ._warpcommon import warp_homography

        return warp_homography(x.contiguous(),
                               homography_consts(plan.static[0]))


def homography_consts(minv) -> np.ndarray:
    """The plan's inverse homography (nine float64 entries, row-major) as
    the warp kernel's float32 constants, as JAX rounds them."""
    return np.asarray(minv, np.float64).astype(np.float32)
