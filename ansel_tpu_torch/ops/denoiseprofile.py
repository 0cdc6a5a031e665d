"""denoiseprofile — camera-calibrated Poisson-Gaussian denoising.

Reference: `ansel/src/iop/denoiseprofile.c` (params v11,
denoiseprofile.c:276-305).  Planning and coefficients are copied from
`ansel_tpu/ops/denoiseprofile.py`; the pixels are torch:

  * WB-adaptive generalized-Anscombe VST (precondition_v2 :924-940,
    precondition_Y0U0V0 :1030-1060);
  * per scale, the edge-aware a-trous decompose (`pixel/wavelets.py`, the
    EAW kernel on the device) with BayesShrink-style thresholds from the
    measured detail variance (:1222-1286), kept on the device;
  * soft-threshold synthesis, inverse VST backtransform_v2 (:1002-1027) /
    backtransform_Y0U0V0;
  * NLM mode (process_nlmeans :1560-1650) through `pixel/nlmeans.py` (the
    NLM kernel on the device).

Automatic noise profiles (a[1] <= 0, the module's defaults) look the
camera up in `io/noiseprofiles.py` by maker, model and ISO, else take
the generic a = 0.5e-4 with the JAX package's log line.

On a row-sharded pipe (`parallel/spatial.py`, which publishes
`shard_geom` in the plan's notes) the per-scale detail variance, a
whole-frame statistic, is each shard's sum of detail^2 over the rows it
owns, added over the mesh axis (`parallel/mesh.psum`), as the JAX
package rebuilds it (`ansel_tpu/ops/denoiseprofile.py:294-326`).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.params import cfield, params
from ..core.types import Colorspace
from ..pixel.nlmeans import nlmeans
from ..pixel.wavelets import eaw_dn_decompose, eaw_synthesize
from . import base as base_mod
from .base import Op, OpPlan, PlanContext, register

BANDS = 7
P_FULCRUM = 0.05
MODE_NLMEANS = 0
MODE_WAVELETS = 1
MODE_NLMEANS_AUTO = 3
MODE_WAVELETS_AUTO = 4
MODE_RGB = 0       # wavelet_color_mode
MODE_Y0U0V0 = 1

# force-curve channel slots (dt_denoise_profile_channel_t)
CH_ALL, CH_R, CH_G, CH_B, CH_Y0, CH_U0V0 = 0, 1, 2, 3, 4, 5
N_CH = 6


@params(op="denoiseprofile", version=11)
@dataclasses.dataclass
class DenoiseProfileParams:
    radius: float = cfield("f", 1.0)
    nbhood: float = cfield("f", 7.0)
    strength: float = cfield("f", 1.0)
    shadows: float = cfield("f", 1.0)
    bias: float = cfield("f", 0.0)
    scattering: float = cfield("f", 0.0)
    central_pixel_weight: float = cfield("f", 0.1)
    overshooting: float = cfield("f", 1.0)
    a: tuple = cfield("3f", (-1.0, -1.0, -1.0))
    b: tuple = cfield("3f", (0.001, 0.001, 0.001))
    mode: int = cfield("i", MODE_WAVELETS)
    x: tuple = cfield(f"{N_CH * BANDS}f", (0.0,) * (N_CH * BANDS))
    y: tuple = cfield(f"{N_CH * BANDS}f", (0.5,) * (N_CH * BANDS))
    wb_adaptive_anscombe: int = cfield("i", 1)
    fix_anscombe_and_nlmeans_norm: int = cfield("i", 1)
    use_new_vst: int = cfield("i", 1)
    wavelet_color_mode: int = cfield("i", MODE_Y0U0V0)

    @classmethod
    def from_legacy(cls, version, raw):
        if version == 10:
            # denoiseprofile.c legacy v10->v11: identical layout; v11 bakes
            # a 2.5x strength boost into the Y0U0V0 wavelet path, so old
            # strengths are divided to keep renders constant
            p = cls.codec.decode(raw)
            if (p.mode in (MODE_WAVELETS, MODE_WAVELETS_AUTO)
                    and p.wavelet_color_mode == MODE_Y0U0V0):
                p.strength /= 2.5
            return p
        return None


def _band_forces(xs, ys, ch: int) -> np.ndarray:
    """Evaluate the per-band force curve at the band positions. The
    reference samples a catmull-rom through the (x,y) nodes at band
    centers; with default uniform nodes this is the y values themselves."""
    x = np.asarray(xs[ch * BANDS: (ch + 1) * BANDS])
    y = np.asarray(ys[ch * BANDS: (ch + 1) * BANDS])
    t = np.linspace(0.0, 1.0, BANDS) if not np.any(x) else x
    pos = np.linspace(t[0], t[-1], BANDS)
    return np.interp(pos, t, y)


def _inverse_vst(out, c, pexp, bias):
    """backtransform_v2's closed form, before the wb and b terms."""
    denom = 4.0 / (torch.sqrt(c["a"]) * (2.0 - pexp))
    xx = torch.clamp(out, min=0.0)
    delta = xx * xx + bias
    z1 = (xx + torch.sqrt(torch.clamp(delta, min=0.0))) / denom
    return z1 ** (1.0 / (1.0 - pexp / 2.0))


@register
class DenoiseProfile(Op):
    name = "denoiseprofile"
    input_colorspace = Colorspace.CAMERA_RGB

    def plan(self, ctx: PlanContext, spec_in, p: DenoiseProfileParams) -> OpPlan:
        # number of visible scales at this zoom (process_wavelets,
        # denoiseprofile.c:1300-1316: largest filter support <= 20% of
        # the input buffer dimension, adjusted by the roi scale)
        in_scale = min(ctx.scale, 1.0)
        fh, fw = base_mod.full_dims(spec_in)  # piece dims, not window dims
        supp0 = min(2 * (2 << (BANDS - 1)) + 1, max(fh, fw) * 0.2)
        i0 = math.log2(max((supp0 - 1.0) * 0.5, 1.0 + 1e-6))
        max_scale = 0
        while max_scale < BANDS:
            supp = 2 * (2 << max_scale) + 1
            supp_in = supp * (1.0 / in_scale)
            i_in = math.log2((supp_in - 1) * 0.5) - 1.0
            if 1.0 - (i_in + 0.5) / i0 < 0.0:
                break
            max_scale += 1
        max_scale = max(max_scale, 1)
        color_mode = p.wavelet_color_mode if p.use_new_vst else MODE_RGB
        nlm = p.mode in (MODE_NLMEANS, MODE_NLMEANS_AUTO)
        P = max(0, int(-(-p.radius * min(ctx.scale, 2.0) // 1)))
        K = max(1, int(p.nbhood))
        # fast pipes skip every other search patch (denoiseprofile's
        # nlmeans core call; nlmeans.c:440 semantics shared)
        decimate = ctx.notes.get("pipe_type") in ("preview", "thumbnail")
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=(max_scale, color_mode, bool(p.use_new_vst),
                              nlm, P, K,
                              round(float(p.central_pixel_weight), 6),
                              round(float(p.scattering), 6), decimate))

    def roi_in(self, plan: OpPlan, ctx: PlanContext, win):
        """Finite stencil support: a-trous B3 at spacing 2^s compounds to
        2*(2^S - 1); NLM mode to patch + max scattered search offset."""
        si, so = plan.spec_in, plan.spec_out
        if tuple(win) == (0, 0, so.height, so.width):
            return (0, 0, si.height, si.width)
        (max_scale, _cm, _vst, nlm, P, K, _cpw, scattering,
         _dec) = plan.static
        if nlm:
            from ..pixel.nlmeans import _scatter

            m = 0
            for dy in range(-K, K + 1):
                for dx in range(-K, K + 1):
                    a, b = _scatter(ctx.scale, scattering, dy, dx)
                    m = max(m, abs(a), abs(b))
            halo = P + m
        else:
            halo = 2 * ((1 << max_scale) - 1)
        y0 = max(0, win[0] - halo)
        x0 = max(0, win[1] - halo)
        y1 = min(si.height, win[0] + win[2] + halo)
        x1 = min(si.width, win[1] + win[3] + halo)
        return (y0, x0, y1 - y0, x1 - x0)

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p: DenoiseProfileParams):
        max_scale, color_mode = plan.static[0], plan.static[1]
        in_scale = ctx.scale
        wbc = ctx.wb_coeffs
        wb_mean = sum(wbc[:3]) / 3.0
        if wb_mean != 0.0 and p.wb_adaptive_anscombe:
            wb = np.array(wbc[:3], np.float64)
        elif wb_mean == 0.0:
            wb = np.ones(3)
        else:
            wb = np.full(3, wb_mean)

        pexp = np.maximum(p.shadows + 0.1 * np.log(in_scale / wb), 0.0)
        compensate_p = P_FULCRUM / P_FULCRUM**p.shadows

        # Y0U0V0 matrices (set_up_conversion_matrices)
        toY = np.array([[1 / 3, 1 / 3, 1 / 3],
                        [0.5, 0.0, -0.5],
                        [0.25, -0.5, 0.25]])
        sum_invwb = (1 / wb).sum() * math.sqrt(3.0)
        toY[0] = sum_invwb / wb
        stddevU0 = math.sqrt(0.25 * wb[0] ** 2 + 0.25 * wb[2] ** 2)
        stddevV0 = math.sqrt(0.0625 * wb[0] ** 2 + 0.25 * wb[1] ** 2
                             + 0.0625 * wb[2] ** 2)
        toY[1] /= stddevU0
        toY[2] /= stddevV0
        try:
            toRGB = np.linalg.inv(toY)
        except np.linalg.LinAlgError:
            stddevY0 = math.sqrt((wb**2).mean())
            toY[0] = 1.0 / (3.0 * stddevY0)
            toRGB = np.linalg.inv(toY)

        compensate_strength = 1.0 if color_mode == MODE_RGB else 2.5
        s = p.strength * compensate_strength * in_scale
        toY = toY / s
        toRGB = toRGB * s
        wb_s = wb * s

        # noise profile: a <= 0 means "auto" -> look up the camera in the
        # noiseprofiles.json database (iso-interpolated), else a generic
        # fallback (noiseprofiles.c:dt_noiseprofile_get_matching)
        a1, b1 = p.a[1], p.b[1]
        if a1 <= 0:
            from ..io.noiseprofiles import find as np_find

            hit = np_find(ctx.meta.maker, ctx.meta.model, ctx.meta.iso)
            if hit is not None:
                a1, b1 = hit[0][1], hit[1][1]
            else:
                from ..core.log import log

                log("always", "denoiseprofile: no noise profile for "
                    f"'{ctx.meta.maker} {ctx.meta.model}' iso "
                    f"{ctx.meta.iso} — using GENERIC coefficients "
                    "(a=0.5e-4); profiled denoise quality degrades")
                a1 = 0.5e-4

        forces = np.stack([_band_forces(p.x, p.y, ch) for ch in range(N_CH)])
        # per-scale adjustment factors (variance_stabilizing_xform)
        offset_scale = BANDS - max_scale
        adjt = np.zeros((max_scale, 3), np.float64)
        for sc in range(max_scale):
            band_index = BANDS - (sc + offset_scale + 1)
            base = np.full(3, 8.0)
            if color_mode == MODE_RGB:
                f_all = forces[CH_ALL][band_index]
                base *= 4.0 * f_all * f_all
                for ci, ch in enumerate((CH_R, CH_G, CH_B)):
                    f = forces[ch][band_index]
                    base[ci] *= 4.0 * f * f
            else:
                fy = forces[CH_Y0][band_index]
                fuv = forces[CH_U0V0][band_index]
                base[0] *= 4.0 * fy * fy
                base[1] *= 4.0 * fuv * fuv
                base[2] *= 4.0 * fuv * fuv
            adjt[sc] = base

        P = plan.static[4]
        return {
            "wb": wb_s.astype(np.float32),
            "p": pexp.astype(np.float32),
            "a": np.float32(a1 * compensate_p),
            "b": np.float32(b1),
            "bias": np.float32(p.bias - 0.5 * math.log(in_scale)),
            "toY": toY.astype(np.float32),
            "toRGB": toRGB.astype(np.float32),
            "adjt": adjt.astype(np.float32),
            # nlmeans variant (process_nlmeans: norm = .045/(2P+1)^2)
            "nlm_norm": np.float32(0.045 / (2 * P + 1) ** 2),
            "central_pixel_weight": np.float32(p.central_pixel_weight),
            "scattering": np.float32(p.scattering),
        }

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        (max_scale, color_mode, use_new_vst, nlm, P, K,
         center_weight, scattering, decimate) = plan.static
        wb = c["wb"].reshape(3, 1, 1)
        pexp = c["p"].reshape(3, 1, 1)
        b = c["b"]
        expon = -pexp / 2.0 + 1.0
        sqrt_a = torch.sqrt(c["a"])

        if nlm or color_mode == MODE_RGB:
            # precondition_v2 (NLM mode runs on the RGB VST too)
            buf = 2.0 * torch.clamp(x / wb + b, min=0.0) ** expon \
                / ((-pexp + 2.0) * sqrt_a)
        else:
            tmp = torch.clamp(x + b, min=0.0) ** expon \
                * (2.0 / ((-pexp + 2.0) * sqrt_a))
            buf = torch.einsum("dc,chw->dhw", c["toY"], tmp)

        if nlm:
            out = nlmeans(buf, P, K, c["nlm_norm"], [1.0, 1.0, 1.0],
                          center_weight=center_weight,
                          scattering=scattering, scale=ctx.scale,
                          decimate=decimate)
            return wb * (_inverse_vst(out, c, pexp, c["bias"]) - b)

        # a row-sharded pipe: each shard sums the rows it owns (its window
        # starts at clip(i*Hs - halo, 0, H - Hw)) and the axis's psum
        # gives the whole frame's statistic (eaw.c's sum_sq), so every
        # shard denoises as the single pipe does
        shard = ctx.notes.get("shard_geom")
        rowmask = None
        npix = x.shape[1] * x.shape[2]
        if shard is not None:
            from ..parallel import mesh as mesh_mod

            Hs, hh = shard["Hs"], shard["halo"]
            Hf, Hw = shard["H"], shard["Hw"]
            i = mesh_mod.axis_index(shard["axis"])
            s_i = min(max(i * Hs - hh, 0), Hf - Hw)
            rows = torch.arange(x.shape[1], device=x.device) + s_i
            own = (rows >= i * Hs) & (rows < (i + 1) * Hs)
            rowmask = own.to(x.dtype)[None, :, None]
            npix = Hf * x.shape[2]
        out = torch.zeros_like(buf)
        cur = buf
        varf = math.sqrt(2.0 + 2.0 * 16.0 + 36.0) / 16.0
        for scale in range(max_scale):
            sigma_band = varf**scale
            coarse, detail, sum_sq = eaw_dn_decompose(
                cur, scale, 1.0 / (sigma_band * sigma_band))
            if rowmask is not None:
                # from the detail, not the kernel's sum over the window
                sum_sq = mesh_mod.psum(
                    torch.sum(detail * detail * rowmask, dim=(1, 2)),
                    shard["axis"])
            sb2 = sigma_band * sigma_band
            var_y = sum_sq / (npix - 1.0)
            std_x = torch.sqrt(torch.clamp(var_y - sb2, min=1e-6))
            thrs = c["adjt"][scale] * sb2 / std_x
            out = eaw_synthesize(out, detail, thrs)
            cur = coarse
        out = out + cur

        # backtransform_v2 / _Y0U0V0
        if color_mode != MODE_RGB:
            out = torch.einsum("dc,chw->dhw", c["toRGB"], out)
            # bias scaled by wb (backtransform_Y0U0V0 bias_wb,
            # denoiseprofile.c:1060-1063)
            return _inverse_vst(out, c, pexp, c["bias"] * wb) - b
        return wb * (_inverse_vst(out, c, pexp, c["bias"]) - b)
