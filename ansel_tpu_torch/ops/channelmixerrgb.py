"""channelmixerrgb — color calibration: CAT white balance + channel mixer.

Reference: `ansel/src/iop/channelmixerrgb.c` (params v3
channelmixerrgb.c:117-141).  Pipeline: work RGB -> XYZ -> cone LMS
(Bradford / CAT16 / raw XYZ / RGB passthrough, Y-normalized "downscale") ->
von-Kries adaptation from the scene illuminant to the pipeline white ->
3x3 MIX -> XYZ -> xyY-space gamut compression toward white
(gamut_mapping, channelmixerrgb.c:633-697) -> per-channel
saturation/lightness on RGB ratios (luma_chroma, channelmixerrgb.c:699-755)
-> optional grey projection -> work RGB.

Planning and coefficients are copied from `ansel_tpu/ops/channelmixerrgb.py`;
the per-pixel function is ported whole, for every adaptation kind, both
here in torch and as the CHANNELMIXERRGB stage of the chain kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..color import matrices as cm
from ..color.illuminants import illuminant_to_xy
from ..color.transforms import apply_matrix
from ..core.params import cfield, params
from ..core.types import Colorspace
from ..kernels.pointwise import OP_CHANNELMIXERRGB
from .base import Op, OpPlan, PlanContext, PointwiseSpec, register

NORM_MIN = 1.52587890625e-05
# jnp.sqrt(3.0) in the reference: the float32 square root of 3
SQRT3 = float(np.sqrt(np.float32(3.0)))

# dt_adaptation_t
ADAPT_LINEAR_BRADFORD = 0
ADAPT_CAT16 = 1
ADAPT_FULL_BRADFORD = 2
ADAPT_XYZ = 3
ADAPT_RGB = 4

V1, V2, V3 = 0, 1, 2


@params(op="channelmixerrgb", version=3)
@dataclasses.dataclass
class ChannelMixerRGBParams:
    red: tuple = cfield("4f", (1.0, 0.0, 0.0, 0.0))
    green: tuple = cfield("4f", (0.0, 1.0, 0.0, 0.0))
    blue: tuple = cfield("4f", (0.0, 0.0, 1.0, 0.0))
    saturation: tuple = cfield("4f", (0.0, 0.0, 0.0, 0.0))
    lightness: tuple = cfield("4f", (0.0, 0.0, 0.0, 0.0))
    grey: tuple = cfield("4f", (0.0, 0.0, 0.0, 0.0))
    normalize_R: int = cfield("i", 0)
    normalize_G: int = cfield("i", 0)
    normalize_B: int = cfield("i", 0)
    normalize_sat: int = cfield("i", 0)
    normalize_light: int = cfield("i", 0)
    normalize_grey: int = cfield("i", 1)
    illuminant: int = cfield("i", 2)       # DT_ILLUMINANT_D
    illum_fluo: int = cfield("i", 2)
    illum_led: int = cfield("i", 4)
    adaptation: int = cfield("i", 1)       # CAT16
    x: float = cfield("f", 1.0 / 3.0)
    y: float = cfield("f", 1.0 / 3.0)
    temperature: float = cfield("f", 5003.0)
    gamut: float = cfield("f", 1.0)
    clip: int = cfield("i", 1)
    version: int = cfield("i", V3)

    @classmethod
    def from_legacy(cls, version, raw):
        if version in (1, 2):
            # channelmixerrgb.c:323-384 — v1/v2 layout == v3 minus the
            # trailing `version` field; swap saturation R<->B into natural
            # order, tag as legacy saturation algorithm (V_1); v1 also
            # forces normalize_grey (commit_params always normalized then)
            p = cls.codec.decode(raw + b"\0" * 4)
            sat = list(p.saturation)
            sat[0], sat[2] = sat[2], sat[0]
            p.saturation = tuple(sat)
            p.version = V1
            if version == 1:
                p.normalize_grey = 1
            return p
        return None


def _cone_matrix(kind: int) -> np.ndarray:
    if kind in (ADAPT_LINEAR_BRADFORD, ADAPT_FULL_BRADFORD):
        return cm.BRADFORD
    if kind == ADAPT_CAT16:
        return cm.CAT16
    return np.eye(3)  # XYZ / RGB handled separately


@register
class ChannelMixerRGB(Op):
    name = "channelmixerrgb"
    input_colorspace = Colorspace.WORK_RGB

    def plan(self, ctx: PlanContext, spec_in, p: ChannelMixerRGBParams) -> OpPlan:
        apply_grey = any(g != 0.0 for g in p.grey[:3])
        # static structure flags: skip whole stages at trace time when the
        # params are neutral (the common default case)
        has_mix = (tuple(p.red[:3]), tuple(p.green[:3]), tuple(p.blue[:3])) \
            != ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0)) \
            or p.normalize_R or p.normalize_G or p.normalize_B
        has_lumachroma = (any(v != 0.0 for v in p.saturation[:3])
                          or any(v != 0.0 for v in p.lightness[:3])
                          or p.normalize_sat or p.normalize_light)
        gamut_pow1 = (p.gamut == 1.0)
        gamut_off = (p.gamut == 0.0)
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=(p.adaptation, p.version, bool(p.clip),
                              apply_grey, bool(has_mix),
                              bool(has_lumachroma), gamut_pow1, gamut_off))

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p: ChannelMixerRGBParams):
        norm_R = sum(p.red[:3]) if p.normalize_R else 1.0
        norm_G = sum(p.green[:3]) if p.normalize_G else 1.0
        norm_B = sum(p.blue[:3]) if p.normalize_B else 1.0
        norm_sat = sum(p.saturation[:3]) / 3.0 if p.normalize_sat else 0.0
        norm_light = sum(p.lightness[:3]) / 3.0 if p.normalize_light else 0.0
        norm_grey = sum(p.grey[:3])
        if not p.normalize_grey or norm_grey == 0.0:
            norm_grey = 1.0

        MIX = np.array([
            [c / norm_R for c in p.red[:3]],
            [c / norm_G for c in p.green[:3]],
            [c / norm_B for c in p.blue[:3]],
        ])
        saturation = np.array([-p.saturation[i] + norm_sat for i in range(3)])
        if p.version == V1:
            saturation = np.array([
                -p.saturation[2] + norm_sat,
                -p.saturation[1] + norm_sat,
                -p.saturation[0] + norm_sat,
            ])
        lightness = np.array([p.lightness[i] - norm_light for i in range(3)])
        grey = np.array([g / norm_grey for g in p.grey[:3]])

        x, y = illuminant_to_xy(p.illuminant, p.temperature, p.x, p.y,
                                p.illum_fluo)
        illum_XYZ = cm.xy_to_XYZ(x, y)
        cone = _cone_matrix(p.adaptation)
        illum_lms = cone @ (illum_XYZ / max(illum_XYZ[1], 1e-9))
        # hard D50 target — the reference pipeline white
        # (chromatic_adaptation.h bradford_adapt_D50 / CAT16_adapt_D50)
        white_XYZ = cm.PIPE_WHITE_XYZ
        white_lms = cone @ white_XYZ

        gamut = 0.0 if p.gamut == 0.0 else 1.0 / p.gamut
        # D50 uv — gamut compression pulls toward the pipeline white
        # (gamut_mapping, channelmixerrgb.c:633-700)
        xw, yw = cm.PIPE_WHITE_XY
        den = -2.0 * xw + 12.0 * yw + 3.0
        return {
            "MIX": MIX.astype(np.float32),
            "saturation": saturation.astype(np.float32),
            "lightness": lightness.astype(np.float32),
            "grey": grey.astype(np.float32),
            "illum_lms": illum_lms.astype(np.float32),
            "white_lms": white_lms.astype(np.float32),
            "cone": cone.astype(np.float32),
            "cone_inv": np.linalg.inv(cone).astype(np.float32),
            "xyz_from_work": cm.XYZ_FROM_WORK.astype(np.float32),
            "work_from_xyz": cm.WORK_FROM_XYZ.astype(np.float32),
            "gamut": np.float32(gamut),
            # full-Bradford blue nonlinearity: (white_S / illuminant_S)^0.0834
            # = (0.818155 / illum_S)^0.0834 with the D50 white
            # (reference channelmixerrgb.c:3051-3054)
            "p_exp": np.float32(
                (white_lms[2] / max(illum_lms[2], 1e-9)) ** 0.0834
            ),
            "uv_white": np.float32([4.0 * xw / den, 9.0 * yw / den]),
        }

    # consts the chain kernel reads, in order (64 floats)
    _CONST_ORDER = ("MIX", "saturation", "lightness", "grey", "illum_lms",
                    "white_lms", "cone", "cone_inv", "xyz_from_work",
                    "work_from_xyz", "gamut", "p_exp", "uv_white")

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        return self._pixel(x, c, plan.static)

    def pointwise_spec(self, plan, ctx):
        (kind, version, clip, apply_grey, _has_mix, has_lumachroma,
         gamut_pow1, gamut_off) = plan.static
        return PointwiseSpec(
            fn=lambda x, c: self._pixel(x, c, plan.static),
            opcode=OP_CHANNELMIXERRGB, consts=self._CONST_ORDER,
            ints=(kind, version, int(clip), int(apply_grey),
                  int(has_lumachroma), int(gamut_pow1), int(gamut_off)),
            extra=tuple(float(v) for v in cm.PIPE_WHITE_XYZ))

    def _pixel(self, x, c, static):
        (kind, version, clip, apply_grey, has_mix, has_lumachroma,
         gamut_pow1, gamut_off) = static
        if clip:
            x = torch.clamp(x, min=0.0)

        xyz = apply_matrix(x, c["xyz_from_work"])
        # _downscale_vector_simd guard (chromatic_adaptation.h:293-297)
        Y = torch.where(xyz[1] > NORM_MIN, xyz[1] + NORM_MIN, NORM_MIN)[None]

        il, wl = c["illum_lms"], c["white_lms"]
        if kind in (ADAPT_LINEAR_BRADFORD, ADAPT_FULL_BRADFORD, ADAPT_CAT16):
            lms = apply_matrix(xyz, c["cone"]) / Y
            t = [lms[i] / il[i] for i in range(3)]
            if kind == ADAPT_FULL_BRADFORD:
                # nonlinear S-cone response (bradford_adapt_D50)
                t[2] = torch.where(t[2] > 0, t[2] ** c["p_exp"], t[2])
            adapted = torch.stack([t[i] * wl[i] for i in range(3)])
            mixed = apply_matrix(adapted * Y, c["MIX"])
            xyz = apply_matrix(mixed, c["cone_inv"])
        elif kind == ADAPT_XYZ:
            w = cm.PIPE_WHITE_XYZ
            scaled = torch.stack([xyz[i] * (float(w[i])
                                            / torch.clamp(il[i], min=1e-9))
                                  for i in range(3)])
            xyz = apply_matrix(scaled, c["MIX"])
        else:  # ADAPT_RGB: mix happens in pipeline RGB
            mixed = apply_matrix(x, c["MIX"])
            xyz = apply_matrix(mixed, c["xyz_from_work"])

        # gamut compression in xyY/uv space (gamut_mapping)
        if not gamut_off:
            xyz = self._gamut(xyz, c, clip, gamut_pow1)

        if not has_lumachroma and not apply_grey:
            rgb = apply_matrix(xyz, c["work_from_xyz"])
            return torch.clamp(rgb, min=0.0) if clip else rgb

        # back to cone space (or RGB) for saturation/lightness
        if kind in (ADAPT_LINEAR_BRADFORD, ADAPT_FULL_BRADFORD, ADAPT_CAT16):
            base = apply_matrix(xyz, c["cone"])
        elif kind == ADAPT_XYZ:
            base = xyz
        else:
            base = apply_matrix(xyz, c["work_from_xyz"])
        if clip:
            base = torch.clamp(base, min=0.0)

        out = self._luma_chroma(base, c, version) if has_lumachroma else base
        if clip:
            out = torch.clamp(out, min=0.0)

        if apply_grey:
            gr = c["grey"]
            g = torch.clamp(gr[0] * out[0] + gr[1] * out[1] + gr[2] * out[2],
                            min=0.0)
            return torch.stack([g, g, g])

        if kind in (ADAPT_LINEAR_BRADFORD, ADAPT_FULL_BRADFORD, ADAPT_CAT16):
            xyz = apply_matrix(out, c["cone_inv"])
        elif kind == ADAPT_XYZ:
            xyz = out
        else:
            xyz = apply_matrix(out, c["xyz_from_work"])
        if clip:
            xyz = torch.clamp(xyz, min=0.0)
        rgb = apply_matrix(xyz, c["work_from_xyz"])
        return torch.clamp(rgb, min=0.0) if clip else rgb

    def _gamut(self, xyz, c, clip, gamut_pow1=False):
        s = xyz[0] + xyz[1] + xyz[2]
        Y = xyz[1]
        valid = (s > 0) & (Y > 0)
        safe_s = torch.where(valid, s, 1.0)
        xx = xyz[0] / safe_s
        yy = torch.where(valid, xyz[1] / safe_s, 1.0)
        den = -2.0 * xx + 12.0 * yy + 3.0
        u = 4.0 * xx / den
        v = 9.0 * yy / den
        uw, vw = c["uv_white"][0], c["uv_white"][1]
        du, dv = uw - u, vw - v
        delta = Y * (du * du + dv * dv)
        if gamut_pow1:
            corr = delta  # exponent 1: skip the pow (default gamut=1)
        else:
            corr = torch.where(c["gamut"] == 0.0, 0.0,
                               torch.clamp(delta, min=1e-12) ** c["gamut"])
        tu = corr * du + u
        tv = corr * dv + v
        u = torch.where(u > uw, torch.maximum(tu, uw), torch.minimum(tu, uw))
        v = torch.where(v > vw, torch.maximum(tv, vw), torch.minimum(tv, vw))
        xy_den = 6.0 * u - 16.0 * v + 12.0
        xx = 9.0 * u / xy_den
        yy = 4.0 * v / xy_den
        if clip:
            xx = torch.clamp(xx, min=0.0)
            yy = torch.clamp(yy, min=0.0)
        yy = torch.clamp(yy, min=NORM_MIN)
        scale = xx + yy
        sanitize = scale >= 1.0
        xx = torch.where(sanitize, xx / scale, xx)
        yy = torch.where(sanitize, yy / scale, yy)
        out = torch.stack([Y * xx / yy, Y, Y * (1.0 - xx - yy) / yy])
        return torch.where(valid[None], out, torch.zeros_like(out))

    def _luma_chroma(self, inp, c, version):
        norm = torch.sqrt(inp[0] ** 2 + inp[1] ** 2 + inp[2] ** 2)
        avg = torch.clamp((inp[0] + inp[1] + inp[2]) / 3.0, min=NORM_MIN)
        valid = (norm > 0) & (avg > 0)
        li, sa = c["lightness"], c["saturation"]
        mix = li[0] * inp[0] + li[1] * inp[1] + li[2] * inp[2]
        if version == V3:
            norm_r = norm / SQRT3
        else:
            norm_r = norm
        safe_norm = torch.where(valid, norm_r, 1.0)
        ratios = inp / safe_norm[None]
        if version == V1:
            coeff = sum((1.0 - ratios[i]) ** 2 * sa[i] for i in range(3))
        else:
            coeff = sum(ratios[i] * sa[i] for i in range(3)) / 3.0
        min_ratio = torch.clamp(ratios, max=0.0)
        adj = torch.maximum((1.0 - ratios) * coeff[None] + ratios, min_ratio)
        if version == V3:
            norm_r = norm_r / (torch.sqrt(adj[0] ** 2 + adj[1] ** 2
                                          + adj[2] ** 2) / SQRT3)
        norm_r = norm_r * torch.clamp(1.0 + mix / avg, min=0.0)
        out = adj * norm_r[None]
        return torch.where(valid[None], out, inp)
