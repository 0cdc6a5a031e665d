"""filmic (legacy, pre-filmicrgb) — Lab-domain filmic tone mapping for
old sidecars.

Reference: `ansel/src/iop/filmic.c` — params v4 (:105-122), commit
(:1182-1245: contrast floor at grey_display/grey_log, a gaussian
"concavity" desaturation window over the latitude), process (:407-520:
Lab -> ProPhoto RGB, optional global desaturation, log encoding, the
filmic S-curve (max-RGB preserve-colour or per channel), concavity
desaturation, output power, back to Lab).  Copied from
`ansel_tpu/ops/filmic.py`: the params map onto filmicrgb's spline
(`_mapped`, SPLINE_V1, latitude in EV as percent of the dynamic range),
and the per-pixel half is plain torch (the JAX package gives it no
pointwise stage).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..color import matrices as cm
from ..color.transforms import apply_matrix
from ..core.params import cfield, params
from ..core.types import Colorspace
from .base import Op, OpPlan, PlanContext, register
from .filmicrgb import (CURVE_POLY_4, CURVE_SIGMOID, SPLINE_V1,
                        FilmicParams, _spline_eval, compute_spline)

EPS = 2.0 ** -16


@params(op="filmic", version=4)
@dataclasses.dataclass
class FilmicLegacyParams:
    grey_point_source: float = cfield("f", 18.0)
    black_point_source: float = cfield("f", -8.65)
    white_point_source: float = cfield("f", 2.45)
    security_factor: float = cfield("f", 0.0)
    grey_point_target: float = cfield("f", 18.0)
    black_point_target: float = cfield("f", 0.0)
    white_point_target: float = cfield("f", 100.0)
    output_power: float = cfield("f", 2.2)
    latitude_stops: float = cfield("f", 2.0)
    contrast: float = cfield("f", 1.5)
    saturation: float = cfield("f", 100.0)
    global_saturation: float = cfield("f", 100.0)
    balance: float = cfield("f", 0.0)
    interpolator: int = cfield("i", 0)
    preserve_color: int = cfield("i", 0)


    @classmethod
    def from_legacy(cls, version, raw):
        import struct

        # filmic.c ladder (INTROSPECTION is v3 in ansel; the layout is
        # identical to the darktable-era v4 registered here)
        if version == 1:  # no preserve_color/global_saturation
            v = struct.unpack("<12fi", raw[:52])
            return cls(grey_point_source=v[0], black_point_source=v[1],
                       white_point_source=v[2], security_factor=v[3],
                       grey_point_target=v[4], black_point_target=v[5],
                       white_point_target=v[6], output_power=v[7],
                       latitude_stops=v[8], contrast=v[9],
                       saturation=v[10], balance=v[11],
                       interpolator=v[12], preserve_color=0,
                       global_saturation=100.0)
        if version == 2:  # + preserve_color, still no global_saturation
            v = struct.unpack("<12f2i", raw[:56])
            return cls(grey_point_source=v[0], black_point_source=v[1],
                       white_point_source=v[2], security_factor=v[3],
                       grey_point_target=v[4], black_point_target=v[5],
                       white_point_target=v[6], output_power=v[7],
                       latitude_stops=v[8], contrast=v[9],
                       saturation=v[10], balance=v[11],
                       interpolator=v[12], preserve_color=v[13],
                       global_saturation=100.0)
        if version == 3:  # ansel's current layout == v4 here
            return cls.codec.decode(raw)
        return None


@register
class FilmicLegacy(Op):
    name = "filmic"
    input_colorspace = Colorspace.LAB

    def plan(self, ctx: PlanContext, spec_in, p: FilmicLegacyParams) -> OpPlan:
        curve = CURVE_SIGMOID if p.interpolator == 0 else CURVE_POLY_4
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=(bool(p.preserve_color),
                              p.global_saturation != 100.0, curve))

    def _mapped(self, p: FilmicLegacyParams) -> FilmicParams:
        dr = max(p.white_point_source - p.black_point_source, 0.01)
        grey_log = abs(p.black_point_source) / dr
        grey_display = (max(p.grey_point_target, 0.01) / 100.0) \
            ** (1.0 / p.output_power)
        contrast = p.contrast
        if grey_log > 0 and contrast < grey_display / grey_log:
            contrast = 1.0001 * grey_display / grey_log
        # EV latitude -> percent of dynamic range (the v1->v2 migration)
        latitude = min(max(p.latitude_stops / dr * 100.0, 0.1), 99.0)
        curve = CURVE_SIGMOID if p.interpolator == 0 else CURVE_POLY_4
        return FilmicParams(
            grey_point_source=p.grey_point_source,
            black_point_source=p.black_point_source,
            white_point_source=p.white_point_source,
            grey_point_target=p.grey_point_target,
            black_point_target=p.black_point_target,
            white_point_target=p.white_point_target,
            output_power=p.output_power, latitude=latitude,
            contrast=contrast, balance=p.balance,
            custom_grey=1, spline_version=SPLINE_V1,
            shadows=curve, highlights=curve)

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p: FilmicLegacyParams):
        mp = self._mapped(p)
        s = compute_spline(mp)
        latitude = s.latitude_max - s.latitude_min
        center = (s.latitude_max + s.latitude_min) / 2.0
        sat = p.saturation / 100.0
        sigma = sat * sat * latitude * latitude
        return {
            "M1": np.float32(s.M1), "M2": np.float32(s.M2),
            "M3": np.float32(s.M3), "M4": np.float32(s.M4),
            "M5": np.float32(s.M5),
            "lat_min": np.float32(s.latitude_min),
            "lat_max": np.float32(s.latitude_max),
            "grey_source": np.float32(p.grey_point_source / 100.0),
            "black_source": np.float32(p.black_point_source),
            "dynamic_range": np.float32(p.white_point_source
                                        - p.black_point_source),
            "output_power": np.float32(p.output_power),
            "center": np.float32(center),
            "sigma": np.float32(sigma),
            "global_saturation": np.float32(p.global_saturation / 100.0),
        }

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        preserve, desaturate, curve = plan.static
        from ..color.transforms import lab_to_xyz, xyz_to_lab

        # D50 Lab + D50-native ProPhoto, like the reference's Lab pipe
        white = cm.PIPE_WHITE_XYZ
        xyz = lab_to_xyz(x, white)
        PP = cm.profile_matrix("prophoto", to_xyz=False,
                               dst_white_xy=cm.PIPE_WHITE_XY).tolist()
        PPI = cm.profile_matrix("prophoto", to_xyz=True,
                                dst_white_xy=cm.PIPE_WHITE_XY).tolist()
        Yrow = [float(v) for v in cm.profile_matrix(
            "prophoto", to_xyz=True, dst_white_xy=cm.PIPE_WHITE_XY)[1]]
        rgb = apply_matrix(xyz, PP)

        if desaturate:
            luma = xyz[1]
            gs = c["global_saturation"]
            rgb = torch.stack([luma + gs * (rgb[i] - luma) for i in range(3)])

        types = (curve, curve)

        def log_enc(v):
            t = v / c["grey_source"]
            t = torch.where(t > EPS,
                            (torch.log2(torch.clamp(t, min=EPS))
                             - c["black_source"]) / c["dynamic_range"],
                            torch.full_like(t, EPS))
            return torch.clamp(t, 0.0, 1.0)

        if preserve:
            mx = torch.clamp(torch.amax(rgb, dim=0), min=EPS)
            ratios = rgb / mx[None]
            ml = log_enc(mx)
            mo = _spline_eval(ml, types, c)
            concavity = torch.exp(-0.5 * (c["center"] - ml) ** 2
                                  / torch.clamp(c["sigma"], min=1e-9))
            rgb = ratios * mo[None]
            luma = mo
        else:
            enc = log_enc(rgb)
            # concavity indexed by the log-encoded luminance
            Ylog = Yrow[0] * enc[0] + Yrow[1] * enc[1] + Yrow[2] * enc[2]
            concavity = torch.exp(-0.5 * (c["center"]
                                          - torch.clamp(Ylog, 0.0, 1.0)) ** 2
                                  / torch.clamp(c["sigma"], min=1e-9))
            rgb = _spline_eval(enc, types, c)
            luma = Yrow[0] * rgb[0] + Yrow[1] * rgb[1] + Yrow[2] * rgb[2]

        rgb = luma[None] + concavity[None] * (rgb - luma[None])
        rgb = torch.clamp(rgb, 0.0, 1.0) ** c["output_power"]
        return xyz_to_lab(apply_matrix(rgb, PPI), white)
