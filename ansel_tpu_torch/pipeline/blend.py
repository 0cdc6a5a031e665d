"""Per-op mask and blend: `ansel_tpu/pipeline/blend.py` in torch.

Reference: `src/develop/blend.{c,h}` (params v11, blend.h:199-238; mode
enum blend.h:63-110), the per-colorspace loops in
`src/develop/blends/blendif_{lab,rgb_hsl,rgb_jzczhz,raw}.c`:

  * parametric ("blendif") masks: per-channel trapezoid factors with
    precomputed slopes (`prepare_parameters`), boost factors in EV,
    per-channel polarity bits (blendif >> 16);
  * the drawn base mask (`pipeline/masks.rasterize`), the raster
    side-band (an upstream stage's mask), the details refinement
    (`pixel/detail.py`), guided-filter feathering (`pixel/guided`: box
    means on sepblur up to r = 7), the Gaussian mask blur (`pixel/blur`:
    sepblur for sigma <= 4, the IIR kernel beyond) and the
    opacity-normalised contrast/brightness curve (blend.c:614-642);
  * ~35 blend modes applied with the per-pixel opacity.

`apply_blend` is the spatial path; `apply_blend_pointwise` is the plain
twin of the chain kernel's blend record (`kernels/pointwise.py`,
`csrc/pointwise_chain.cu`), for the blends `blend_fusable_pointwise`
admits.  Where the JAX package folds a uniform mask to a Python scalar at
trace time, the twin folds it the same way and the kernel receives the
float32 results from the host (`blend_record`).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..color import matrices as cm
from ..color import spaces as sp
from ..color import transforms as tr
from ..color.transforms import fdiv
from ..core.params import cfield, params
from ..kernels import pointwise as pw
from ..kernels.pointwise import atan2_full
from ..ops.base import PointwiseSpec

# blend colorspace ids (blend.h:54-61)
CS_NONE, CS_RAW, CS_LAB, CS_RGB_DISPLAY, CS_RGB_SCENE = range(5)

# mask modes (blend.h:112-120)
MASK_DISABLED = 0
MASK_ENABLED = 1
MASK_SHAPE = 2
MASK_PARAMETRIC = 4
MASK_RASTER = 8

COMBINE_INV = 0x01
COMBINE_INCL = 0x02
COMBINE_MASKS_POS = 0x04

BLENDIF_SIZE = 16
BLEND_REVERSE = 0x80000000
BLEND_MODE_MASK = 0xFF

# modes (blend.h:63-110)
(B_DISABLED, B_NORMAL_OB, B_LIGHTEN, B_DARKEN, B_MULTIPLY, B_AVERAGE, B_ADD,
 B_SUBTRACT, B_DIFFERENCE, B_SCREEN, B_OVERLAY, B_SOFTLIGHT, B_HARDLIGHT,
 B_VIVIDLIGHT, B_LINEARLIGHT, B_PINLIGHT, B_LIGHTNESS, B_CHROMATICITY,
 B_HUE, B_COLOR) = range(0x14)
B_COLORADJUST = 0x16
B_HSV_VALUE = 0x1C
B_HSV_COLOR = 0x1D
B_DIFFERENCE2 = 0x17
B_NORMAL2 = 0x18
B_BOUNDED = 0x19
B_LAB_LIGHTNESS = 0x1A
B_LAB_COLOR = 0x1B
B_LAB_L = 0x1E
B_LAB_A = 0x1F
B_LAB_B = 0x20
B_RGB_R = 0x21
B_RGB_G = 0x22
B_RGB_B = 0x23
B_SUBTRACT_INVERSE = 0x25
B_DIVIDE = 0x26
B_DIVIDE_INVERSE = 0x27
B_GEOMETRIC_MEAN = 0x28
B_HARMONIC_MEAN = 0x29


@params(op="_blend", version=11)
@dataclasses.dataclass
class BlendParams:
    """dt_develop_blend_params_t v11 (blend.h:199-238)."""

    mask_mode: int = cfield("I", MASK_DISABLED)
    blend_cst: int = cfield("i", CS_NONE)
    blend_mode: int = cfield("I", B_NORMAL2)
    blend_parameter: float = cfield("f", 0.0)
    opacity: float = cfield("f", 100.0)
    mask_combine: int = cfield("I", 0)
    mask_id: int = cfield("I", 0)
    blendif: int = cfield("I", 0)
    feathering_radius: float = cfield("f", 0.0)
    feathering_guide: int = cfield("I", 1)
    blur_radius: float = cfield("f", 0.0)
    contrast: float = cfield("f", 0.0)
    brightness: float = cfield("f", 0.0)
    details: float = cfield("f", 0.0)
    reserved: tuple = cfield("3I", (0, 0, 0))
    blendif_parameters: tuple = cfield(f"{4 * BLENDIF_SIZE}f",
                                       (0.0,) * (4 * BLENDIF_SIZE))
    blendif_boost_factors: tuple = cfield(f"{BLENDIF_SIZE}f",
                                          (0.0,) * BLENDIF_SIZE)
    raster_mask_source: str = cfield("s:20", "")
    raster_mask_instance: int = cfield("i", 0)
    raster_mask_id: int = cfield("i", 0)
    raster_mask_invert: int = cfield("i", 0)


def decode_blend_params(raw: bytes):
    """A v11 blob -> BlendParams; None for None or for any blob the codec
    cannot decode (an older blendop version, a short blob)."""
    if raw is None:
        return None
    try:
        return BlendParams.codec.decode(bytes(raw))
    except Exception:
        return None


def blend_is_active(bp: BlendParams) -> bool:
    return bp is not None and bp.mask_mode != MASK_DISABLED


def prepare_parameters(bp: BlendParams) -> np.ndarray:
    """-> (16, 6) trapezoid params with precomputed slopes
    (dt_develop_blendif_process_parameters, blend.c:202-236)."""
    out = np.zeros((BLENDIF_SIZE, 6), np.float32)
    for i in range(BLENDIF_SIZE):
        if not (bp.blendif & (1 << i)):
            continue
        offset = 0.0
        if bp.blend_cst == CS_LAB and i in (1, 2, 5, 6):
            offset = 0.5
        boost = 2.0 ** bp.blendif_boost_factors[i]
        p = [(bp.blendif_parameters[i * 4 + k] - offset) * boost
             for k in range(4)]
        s_up = 1.0 / max(0.001, p[1] - p[0])
        s_dn = 1.0 / max(0.001, p[3] - p[2])
        if (bp.blendif_parameters[i * 4] <= 0.0
                and bp.blendif_parameters[i * 4 + 1] <= 0.0):
            p[0], p[1] = -np.inf, -np.inf
        if (bp.blendif_parameters[i * 4 + 2] >= 1.0
                and bp.blendif_parameters[i * 4 + 3] >= 1.0):
            p[2], p[3] = np.inf, np.inf
        out[i] = (*p, s_up, s_dn)
    return out


def _factor(value, prm, invert):
    p0, p1, p2, p3, s_up, s_dn = (float(prm[k]) for k in range(6))
    f = torch.where(
        value <= p0, 0.0,
        torch.where(value < p1, (value - p0) * s_up,
                    torch.where(value <= p2, 1.0,
                                torch.where(value < p3,
                                            1.0 - (value - p2) * s_dn,
                                            0.0))))
    return 1.0 - f if invert else f


def _weights(y_weights):
    return [float(v) for v in np.asarray(y_weights).reshape(-1)[:3]]


# scene RGB -> the D65 XYZ that JzAzBz reads (blendif_rgb_jzczhz.c)
JZ_FROM_WORK = (cm.XYZ_D50_TO_D65 @ cm.XYZ_FROM_WORK)


def _scene_channels(rgb, y_weights, needed=None):
    """Channel values for CS_RGB_SCENE (blendif_rgb_jzczhz.c); with
    `needed` (a set of channel ids) the JzCzhz trio only when read."""
    w = _weights(y_weights)
    gray = w[0] * rgb[0] + w[1] * rgb[1] + w[2] * rgb[2]
    out = {0: gray, 1: rgb[0], 2: rgb[1], 3: rgb[2]}
    if needed is None or needed & {8, 9, 10}:
        xyz = tr.apply_matrix(torch.clamp(rgb, min=0.0),
                              JZ_FROM_WORK.tolist())
        jab = sp.xyz_to_jzazbz(xyz)
        out[8] = jab[0]
        out[9] = torch.sqrt(jab[1] * jab[1] + jab[2] * jab[2])
        out[10] = fdiv(atan2_full(jab[2], jab[1]), 2.0 * math.pi) + 0.5
    return out


def _lab_channels(lab):
    L = fdiv(lab[0], 100.0)
    a = fdiv(lab[1], 256.0)
    b = fdiv(lab[2], 256.0)
    C = fdiv(torch.sqrt(lab[1] * lab[1] + lab[2] * lab[2]),
             128.0 * math.sqrt(2.0))
    h = fdiv(atan2_full(lab[2], lab[1]), 2.0 * math.pi) + 0.5
    return {0: L, 1: a, 2: b, 8: C, 9: h}


def _contrast_curve(mask, bp: BlendParams, opacity: float):
    """The opacity-normalised sigmoid tone curve (blend.c:614-642) of a
    mask tensor."""
    e = math.exp(3.0 * bp.contrast)
    x = fdiv(mask, max(opacity, 1e-6))
    x = 2.0 * x - 1.0
    br = bp.brightness
    if br > 0.0:
        x = torch.clamp(fdiv(x + br, 1.0 - br), max=1.0)
    elif br < 0.0:
        x = torch.clamp(fdiv(x + br, 1.0 + br), min=-1.0)
    return torch.clamp(
        (x * e / (1.0 + (e - 1.0) * torch.abs(x))) / 2.0 + 0.5, 0.0, 1.0
    ) * opacity


def _curve_active(bp: BlendParams) -> bool:
    return abs(bp.contrast) >= 0.01 or abs(bp.brightness) >= 0.01


def compute_mask(a, b, bp: BlendParams, prm, cst: int, y_weights,
                 drawn=None, raster=None, rawdetail=None):
    """Drawn + parametric mask in [0, 1] with the opacity and the
    post-processing.  Combine semantics of blendif_rgb_hsl.c:236-340: the
    drawn mask is the base, the parametric factors form `temp`, and
    INCL/INV pick the composition."""
    opacity = min(max(bp.opacity / 100.0, 0.0), 1.0)
    incl = bool(bp.mask_combine & COMBINE_INCL)
    inv = bool(bp.mask_combine & COMBINE_INV)

    if bp.mask_mode & MASK_RASTER:
        # the raster side-band: an upstream stage's mask
        # (blend.c:_develop_blend_init_raster_mask:509-545); the engine
        # raises for a named source that is missing, an empty source
        # fills the mask (blend.c:540-543)
        if raster is None:
            fill = 0.0 if bp.raster_mask_invert else 1.0
            return torch.full_like(a[0], fill * opacity)
        mask = (1.0 - raster) if bp.raster_mask_invert else raster
        return mask * opacity

    if bp.mask_mode & MASK_SHAPE:
        if drawn is not None:
            base = drawn
            if bp.mask_combine & COMBINE_MASKS_POS:
                base = 1.0 - base
        else:
            base = torch.full_like(
                a[0], 0.0 if bp.mask_combine & COMBINE_MASKS_POS else 1.0)
    else:
        base = torch.full_like(a[0], 0.0 if incl else 1.0)

    parametric = bool(bp.mask_mode & MASK_PARAMETRIC)
    temp = torch.ones_like(a[0])
    if parametric:
        chans_in = (_lab_channels(a) if cst == CS_LAB
                    else _scene_channels(a, y_weights))
        chans_out = (_lab_channels(b) if cst == CS_LAB
                     else _scene_channels(b, y_weights))
        for i, val in chans_in.items():
            if bp.blendif & (1 << i):
                temp = temp * _factor(
                    val, prm[i], bool(bp.blendif & (1 << (16 + i))) ^ incl)
        for i, val in chans_out.items():
            j = i + 4
            if bp.blendif & (1 << j):
                temp = temp * _factor(
                    val, prm[j], bool(bp.blendif & (1 << (16 + j))) ^ incl)
        if incl:
            mask = ((1.0 - base) * temp if inv
                    else 1.0 - (1.0 - base) * temp)
        else:
            mask = (1.0 - base * temp) if inv else base * temp
    else:
        mask = (1.0 - base) if inv else base
    mask = mask * opacity

    # the details slider: refine by the demosaic stage's raw-detail mask
    # (blend.c:_refine_with_detail_mask:349-358)
    if abs(bp.details) > 1e-6 and rawdetail is not None:
        from ..pixel import detail as detail_mod

        want_detail = bp.details > 0.0
        thr = 0.005 * (bp.details ** 2 if want_detail
                       else 1.0 - abs(bp.details) ** 0.5)
        mask = mask * detail_mod.detail_mask(rawdetail, max(thr, 1e-6),
                                             detail=want_detail)

    # feathering (a guided filter on the blend input's luma), then blur
    if bp.feathering_radius > 0.1:
        from ..pixel.guided import guided_filter

        w = torch.as_tensor(np.asarray(y_weights, np.float32),
                            device=a.device).reshape(3, 1, 1)
        guide = torch.sum((a if cst != CS_LAB else fdiv(a, 100.0)) * w,
                          dim=0)
        r = max(1, int(bp.feathering_radius))
        mask = torch.clamp(guided_filter(guide, mask, r, 1e-4), 0.0, 1.0)
    if bp.blur_radius > 0.1:
        from ..pixel.blur import gaussian_blur

        mask = gaussian_blur(mask, bp.blur_radius)
    if _curve_active(bp):
        mask = _contrast_curve(mask, bp, opacity)
    return mask


def _luma(rgb, y_weights):
    w = _weights(y_weights)
    return w[0] * rgb[0] + w[1] * rgb[1] + w[2] * rgb[2]


def _mode_fn(mode: int, p: float, cst: int):
    """b-over-a blend value (before the local-opacity lerp)."""
    pw = 2.0 ** p
    where = torch.where

    def floor6(v):
        return torch.clamp(v, min=1e-6)

    table = {
        B_NORMAL2: lambda a, b: b * pw,
        B_NORMAL_OB: lambda a, b: b * pw,
        B_DISABLED: lambda a, b: b * pw,
        B_BOUNDED: lambda a, b: torch.clamp(b * pw, 0.0, 1.0),
        B_LIGHTEN: lambda a, b: torch.maximum(a, b * pw),
        B_DARKEN: lambda a, b: torch.minimum(a, b * pw),
        B_MULTIPLY: lambda a, b: a * b * pw,
        B_AVERAGE: lambda a, b: (a + b) / 2.0,
        B_ADD: lambda a, b: a + pw * b,
        B_SUBTRACT: lambda a, b: torch.clamp(a - pw * b, min=0.0),
        B_SUBTRACT_INVERSE: lambda a, b: torch.clamp(b - pw * a, min=0.0),
        B_DIFFERENCE: lambda a, b: torch.abs(a - b),
        B_DIFFERENCE2: lambda a, b: torch.abs(a - b),
        B_SCREEN: lambda a, b: 1.0 - (1.0 - a) * (1.0 - b * pw),
        B_DIVIDE: lambda a, b: a / floor6(pw * b),
        B_DIVIDE_INVERSE: lambda a, b: b / floor6(pw * a),
        B_GEOMETRIC_MEAN: lambda a, b: torch.sqrt(
            torch.clamp(a * b, min=0.0)),
        B_HARMONIC_MEAN: lambda a, b: 2.0 * a * b / floor6(a + b),
        B_OVERLAY: lambda a, b: where(
            a > 0.5, 1.0 - 2.0 * (1.0 - a) * (1.0 - b), 2.0 * a * b),
        B_HARDLIGHT: lambda a, b: where(
            b > 0.5, 1.0 - 2.0 * (1.0 - a) * (1.0 - b), 2.0 * a * b),
        B_SOFTLIGHT: lambda a, b: where(
            b > 0.5, 1.0 - (1.0 - a) * (1.0 - (b - 0.5)), a * (b + 0.5)),
        B_LINEARLIGHT: lambda a, b: a + 2.0 * b - 1.0,
        B_VIVIDLIGHT: lambda a, b: where(
            b > 0.5, a / floor6(2.0 * (1.0 - b)),
            1.0 - (1.0 - a) / floor6(2.0 * b)),
        B_PINLIGHT: lambda a, b: where(
            b > 0.5, torch.maximum(a, 2.0 * (b - 0.5)),
            torch.minimum(a, 2.0 * b)),
    }
    return table.get(mode)


def apply_blend(a, b, bp: BlendParams, prm, cst: int, y_weights,
                drawn=None, raster=None, rawdetail=None,
                return_mask=False):
    """a = the stage's input, b = its output, both (3, H, W) in the blend
    colorspace -> the blended result (and the final mask, for the raster
    side-band)."""
    mask2d = compute_mask(a, b, bp, prm, cst, y_weights, drawn=drawn,
                          raster=raster, rawdetail=rawdetail)
    out = _apply_blend_mode(a, b, bp, cst, y_weights, mask2d[None])
    return (out, mask2d) if return_mask else out


# ---- the hue family (blendif_rgb_hsl.c / blendif_lab.c) -----------------

def _mod1(x):
    return torch.remainder(x, 1.0)


def _rgb_to_hsl(rgb):
    r, g, b = rgb[0], rgb[1], rgb[2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    l = 0.5 * (mx + mn)
    d = mx - mn
    s = torch.where(d < 1e-9, 0.0,
                    torch.where(l > 0.5,
                                d / torch.clamp(2.0 - mx - mn, min=1e-9),
                                d / torch.clamp(mx + mn, min=1e-9)))
    dd = torch.clamp(d, min=1e-9)
    hr = torch.where(g < b, (g - b) / dd + 6.0, (g - b) / dd)
    hg = (b - r) / dd + 2.0
    hb = (r - g) / dd + 4.0
    h = fdiv(torch.where(mx == r, hr, torch.where(mx == g, hg, hb)), 6.0)
    h = torch.where(d < 1e-9, 0.0, h)
    return h, s, l


def _hsl_to_rgb(h, s, l):
    q = torch.where(l < 0.5, l * (1.0 + s), l + s - l * s)
    p = 2.0 * l - q

    def hue2rgb(t):
        t = _mod1(t + 1.0)
        return torch.where(
            t < 1.0 / 6.0, p + (q - p) * 6.0 * t,
            torch.where(t < 0.5, q,
                        torch.where(t < 2.0 / 3.0,
                                    p + (q - p) * (2.0 / 3.0 - t) * 6.0, p)))

    gray = s < 1e-9
    return torch.stack([torch.where(gray, l, hue2rgb(h + 1.0 / 3.0)),
                        torch.where(gray, l, hue2rgb(h)),
                        torch.where(gray, l, hue2rgb(h - 1.0 / 3.0))])


def _rgb_to_hsv(rgb):
    r, g, b = rgb[0], rgb[1], rgb[2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    d = mx - mn
    dd = torch.clamp(d, min=1e-9)
    hr = torch.remainder((g - b) / dd, 6.0)
    hg = (b - r) / dd + 2.0
    hb = (r - g) / dd + 4.0
    h = fdiv(torch.where(mx == r, hr, torch.where(mx == g, hg, hb)), 6.0)
    h = torch.where(d < 1e-9, 0.0, h)
    s = torch.where(mx < 1e-9, 0.0, d / torch.clamp(mx, min=1e-9))
    return h, s, mx


def _hsv_to_rgb(h, s, v):
    h = _mod1(h) * 6.0
    i = torch.clamp(torch.floor(h), max=5.0)
    f = h - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))

    def pick(c0, c1, c2, c3, c4, c5):
        out = c5
        for k, ck in ((4.0, c4), (3.0, c3), (2.0, c2), (1.0, c1),
                      (0.0, c0)):
            out = torch.where(i <= k, ck, out)
        return out

    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)])


def _hue_mix(ha, hb, op):
    """Hue along the shortest way round the circle
    (blendif_rgb_hsl.c:724-727); op = the per-pixel opacity."""
    d = torch.abs(ha - hb)
    s = torch.where(d > 0.5, -op * (1.0 - d) / torch.clamp(d, min=1e-9), op)
    return _mod1(ha * (1.0 - s) + hb * s + 1.0)


def _lab_to_lch01(lab):
    """Lab -> (L/100, C of ab/128, hue in [0, 1)) like dt_Lab_2_LCH."""
    L = fdiv(lab[0], 100.0)
    a_ = lab[1] / 128.0
    b_ = lab[2] / 128.0
    c = torch.sqrt(a_ * a_ + b_ * b_)
    h = _mod1(fdiv(atan2_full(b_, a_), 2.0 * math.pi) + 1.0)
    return L, c, h


def _lch01_to_lab(L, c, h):
    ang = 2.0 * math.pi * h
    return torch.stack([L * 100.0, torch.cos(ang) * c * 128.0,
                        torch.sin(ang) * c * 128.0])


def _blend_hue_family(a, b, mode, cst, mask):
    """HUE / COLOR / COLORADJUST / HSV_VALUE / HSV_COLOR: the opacity acts
    on the polar components, not as a final lerp (blendif_lab.c:874-977,
    blendif_rgb_hsl.c:707-858)."""
    op = mask[0] if isinstance(mask, torch.Tensor) and mask.dim() == 3 \
        else mask
    if cst == CS_LAB:
        La, Ca, Ha = _lab_to_lch01(a)
        Lb, Cb, Hb = _lab_to_lch01(b)
        if mode == B_HUE:
            return _lch01_to_lab(La, Ca, _hue_mix(Ha, Hb, op))
        if mode == B_COLOR:
            return _lch01_to_lab(La, Ca * (1 - op) + Cb * op,
                                 _hue_mix(Ha, Hb, op))
        if mode == B_COLORADJUST:
            return _lch01_to_lab(Lb, Ca * (1 - op) + Cb * op,
                                 _hue_mix(Ha, Hb, op))
        # the HSV modes are display-RGB only: the lightness mix here
        if mode == B_HSV_VALUE:
            return torch.stack([La * (1 - op) * 100.0 + Lb * op * 100.0,
                                a[1], a[2]])
        return torch.stack([a[0], b[1] * op + a[1] * (1 - op),
                            b[2] * op + a[2] * (1 - op)])
    if mode in (B_HSV_VALUE, B_HSV_COLOR):
        ha, sa, va = _rgb_to_hsv(a)
        hb, sb, vb = _rgb_to_hsv(b)
        if mode == B_HSV_VALUE:
            return _hsv_to_rgb(ha, sa, va * (1 - op) + vb * op)
        two_pi = 2 * math.pi
        xa = sa * torch.cos(two_pi * ha)
        ya = sa * torch.sin(two_pi * ha)
        xb = sb * torch.cos(two_pi * hb)
        yb = sb * torch.sin(two_pi * hb)
        xc = xa * (1 - op) + xb * op
        yc = ya * (1 - op) + yb * op
        h = _mod1(fdiv(atan2_full(yc, xc), two_pi) + 1.0)
        return _hsv_to_rgb(h, torch.sqrt(xc * xc + yc * yc), va)
    ha, sa, la = _rgb_to_hsl(torch.clamp(a, 0.0, 1.0))
    hb, sb, lb = _rgb_to_hsl(torch.clamp(b, 0.0, 1.0))
    h = _hue_mix(ha, hb, op)
    if mode == B_HUE:
        out = _hsl_to_rgb(h, sa, la)
    elif mode == B_COLOR:
        out = _hsl_to_rgb(h, sa * (1 - op) + sb * op, la)
    else:  # B_COLORADJUST: the lightness from the stage's output
        out = _hsl_to_rgb(h, sa * (1 - op) + sb * op, lb)
    return torch.clamp(out, 0.0, 1.0)


def apply_blend_raw(a, b, bp: BlendParams, drawn=None):
    """The RAW blend colorspace (blend.h:57, blendif_raw.c): a
    one-channel mosaic, the drawn mask and the global opacity only, the
    elementwise mode table."""
    opacity = min(max(bp.opacity / 100.0, 0.0), 1.0)
    if bp.mask_mode & MASK_SHAPE and drawn is not None:
        base = drawn
        if bp.mask_combine & COMBINE_MASKS_POS:
            base = 1.0 - base
    else:
        base = torch.ones_like(a)
    if bp.mask_combine & COMBINE_INV:
        base = 1.0 - base
    mask = base * opacity
    mode = bp.blend_mode & BLEND_MODE_MASK
    aa, bb = (b, a) if bp.blend_mode & BLEND_REVERSE else (a, b)
    fn = _mode_fn(mode, bp.blend_parameter, CS_RGB_SCENE)
    if fn is None:
        fn = _mode_fn(B_NORMAL2, bp.blend_parameter, CS_RGB_SCENE)
    return aa * (1.0 - mask) + fn(aa, bb) * mask


def blend_fusable_pointwise(bp: BlendParams, cst: int) -> bool:
    """True when the blend is per-pixel math alone (no drawn or raster
    mask, no feathering, blur or details refinement), so that it may ride
    the chain as a blend record, as the JAX package folds it into its
    fused Pallas chain."""
    if bp is None or bp.mask_mode == MASK_DISABLED:
        return False
    if cst not in (CS_LAB, CS_RGB_SCENE):
        return False
    if bp.mask_mode & (MASK_SHAPE | MASK_RASTER):
        return False
    if bp.feathering_radius > 0.1 or bp.blur_radius > 0.1:
        return False
    if abs(bp.details) > 1e-6:
        return False
    return True


def _channel_ids(bp: BlendParams, cst: int):
    """(ids the mask reads from the input, ids it reads from the output),
    each sorted."""
    ids = (0, 1, 2, 8, 9) if cst == CS_LAB else (0, 1, 2, 3, 8, 9, 10)
    need_in = [i for i in ids if bp.blendif & (1 << i)]
    need_out = [i for i in ids if bp.blendif & (1 << (i + 4))]
    return need_in, need_out


def _uniform_mask(bp: BlendParams) -> float:
    """The mask of a blend without parametric factors, folded on the host
    in float64 as the JAX package folds it at trace time."""
    opacity = min(max(bp.opacity / 100.0, 0.0), 1.0)
    incl = bool(bp.mask_combine & COMBINE_INCL)
    inv = bool(bp.mask_combine & COMBINE_INV)
    base = 0.0 if incl else 1.0
    mask = ((1.0 - base) if inv else base) * opacity
    if _curve_active(bp):
        e = math.exp(3.0 * bp.contrast)
        x = mask / max(opacity, 1e-6)
        x = 2.0 * x - 1.0
        br = bp.brightness
        if br > 0.0:
            x = min((x + br) / (1.0 - br), 1.0)
        elif br < 0.0:
            x = max((x + br) / (1.0 + br), -1.0)
        mask = min(max((x * e / (1.0 + (e - 1.0) * abs(x))) / 2.0 + 0.5,
                       0.0), 1.0) * opacity
    return mask


def apply_blend_pointwise(a, b, bp: BlendParams, prm, cst: int, y_weights):
    """apply_blend for the blends `blend_fusable_pointwise` admits, as the
    JAX package's fused chain computes it: every parameter is static, the
    trapezoid rows come from `prm`, and a mask without parametric factors
    is a Python float.  The plain twin of the chain kernel's blend
    record."""
    opacity = min(max(bp.opacity / 100.0, 0.0), 1.0)
    incl = bool(bp.mask_combine & COMBINE_INCL)
    inv = bool(bp.mask_combine & COMBINE_INV)
    base = 0.0 if incl else 1.0
    need_in, need_out = _channel_ids(bp, cst)
    if not (bp.mask_mode & MASK_PARAMETRIC and (need_in or need_out)):
        mask = _uniform_mask(bp)
        return _apply_blend_mode(a, b, bp, cst, y_weights, mask)

    temp = None
    for x, ids, offset in ((a, need_in, 0), (b, need_out, 4)):
        if not ids:
            continue
        chans = (_lab_channels(x) if cst == CS_LAB
                 else _scene_channels(x, y_weights, needed=set(ids)))
        for i in ids:
            j = i + offset
            f = _factor(chans[i], prm[j],
                        bool(bp.blendif & (1 << (16 + j))) ^ incl)
            temp = f if temp is None else temp * f
    if incl:
        mask = (1.0 - base) * temp if inv else 1.0 - (1.0 - base) * temp
    else:
        mask = (1.0 - base * temp) if inv else base * temp
    mask = mask * opacity
    if _curve_active(bp):
        mask = _contrast_curve(mask, bp, opacity)
    return _apply_blend_mode(a, b, bp, cst, y_weights, mask[None])


def _apply_blend_mode(a, b, bp: BlendParams, cst: int, y_weights, mask):
    mode = bp.blend_mode & BLEND_MODE_MASK
    if bp.blend_mode & BLEND_REVERSE:
        a, b = b, a
    p = bp.blend_parameter

    if mode in (B_HUE, B_COLOR, B_COLORADJUST, B_HSV_VALUE, B_HSV_COLOR):
        return _blend_hue_family(a, b, mode, cst, mask)

    # the channel-replace modes
    if mode in (B_RGB_R, B_RGB_G, B_RGB_B, B_LAB_L, B_LAB_A, B_LAB_B):
        ch = {B_RGB_R: 0, B_RGB_G: 1, B_RGB_B: 2,
              B_LAB_L: 0, B_LAB_A: 1, B_LAB_B: 2}[mode]
        blended = torch.stack([b[k] * (2.0 ** p) if k == ch else a[k]
                               for k in range(3)])
        return a * (1.0 - mask) + blended * mask
    if mode in (B_LIGHTNESS, B_LAB_LIGHTNESS):
        if cst == CS_LAB:
            blended = torch.stack([b[0], a[1], a[2]])
        else:
            la, lb = (_luma(v, y_weights) for v in (a, b))
            blended = a * (lb / torch.clamp(la, min=1e-6))[None]
        return a * (1.0 - mask) + blended * mask
    if mode in (B_CHROMATICITY, B_LAB_COLOR):
        if cst == CS_LAB:
            blended = torch.stack([a[0], b[1], b[2]])
        else:
            la, lb = (_luma(v, y_weights) for v in (a, b))
            blended = b * (la / torch.clamp(lb, min=1e-6))[None]
        return a * (1.0 - mask) + blended * mask

    fn = _mode_fn(mode, p, cst)
    if fn is None:
        fn = _mode_fn(B_NORMAL2, p, cst)
    return a * (1.0 - mask) + fn(a, b) * mask


# ---- the chain kernel's blend record -------------------------------------

# flags of a blend record's second int (csrc/pointwise_chain.cu blend())
BF_REVERSE, BF_LAB, BF_PARAMETRIC, BF_CURVE, BF_INCL, BF_INV = (
    1, 2, 4, 8, 16, 32)
BLEND_FIXED_CONSTS = 20   # the record's consts before its trapezoid rows


def blend_record(bp: BlendParams, cst: int, y_weights=None):
    """(ints, consts) of the chain kernel's blend record for
    `apply_blend_pointwise(a, b, bp, prepare_parameters(bp), cst, ...)`:

    ints: mode, flags (BF_*), the input channel ids the mask reads (a bit
      per id), the output ones, and each side's inverted factors;
    consts: [0, 1] the folded mask and 1 - mask of a uniform blend, else
      the opacity and max(opacity, 1e-6); [2] 2^p; [3:6] the luma
      weights; [6:10] the curve's e, e - 1, brightness and 1 -+
      brightness; [10] the base; [11:20] JZ_FROM_WORK; then the
      trapezoid rows of the channels read, inputs first, in id order."""
    if y_weights is None:
        y_weights = cm.WORK_Y
    opacity = min(max(bp.opacity / 100.0, 0.0), 1.0)
    incl = bool(bp.mask_combine & COMBINE_INCL)
    inv = bool(bp.mask_combine & COMBINE_INV)
    need_in, need_out = _channel_ids(bp, cst)
    parametric = bool(bp.mask_mode & MASK_PARAMETRIC
                      and (need_in or need_out))
    flags = ((BF_REVERSE if bp.blend_mode & BLEND_REVERSE else 0)
             | (BF_LAB if cst == CS_LAB else 0)
             | (BF_INCL if incl else 0) | (BF_INV if inv else 0))
    if parametric:
        flags |= BF_PARAMETRIC | (BF_CURVE if _curve_active(bp) else 0)
        m0, m1 = opacity, max(opacity, 1e-6)
    else:
        need_in, need_out = [], []
        m0 = _uniform_mask(bp)
        m1 = 1.0 - m0
    bits = [0, 0, 0, 0]
    prm = prepare_parameters(bp)
    rows = []
    for side, (ids, offset) in enumerate(((need_in, 0), (need_out, 4))):
        for i in ids:
            j = i + offset
            bits[side] |= 1 << i
            if bool(bp.blendif & (1 << (16 + j))) ^ incl:
                bits[2 + side] |= 1 << i
            rows += [float(v) for v in prm[j]]
    e = math.exp(3.0 * bp.contrast)
    br = bp.brightness
    br_div = (1.0 - br) if br > 0.0 else (1.0 + br) if br < 0.0 else 1.0
    consts = ([m0, m1, 2.0 ** bp.blend_parameter] + _weights(y_weights)
              + [e, e - 1.0, br, br_div, 0.0 if incl else 1.0]
              + [float(v) for v in JZ_FROM_WORK.reshape(-1)] + rows)
    ints = (bp.blend_mode & BLEND_MODE_MASK, flags) + tuple(bits)
    return ints, tuple(consts)


def blend_specs(bp: BlendParams, cst: int, y_weights=None):
    """(keep, blend): the two chain records that wrap a blended stage.
    The keep record holds the stage's input in registers; the blend
    record mixes the stage's output with it.  Their plain forms are the
    identity and `apply_blend_pointwise`."""
    if y_weights is None:
        y_weights = cm.WORK_Y
    prm = prepare_parameters(bp)
    ints, consts = blend_record(bp, cst, y_weights)

    def keep(x, c):
        return x

    def blend(a, b, c):
        return apply_blend_pointwise(a, b, bp, prm, cst, y_weights)

    return (PointwiseSpec(fn=keep, opcode=pw.OP_KEEP),
            PointwiseSpec(fn=blend, opcode=pw.OP_BLEND, ints=ints,
                          extra=consts, reads_kept=True))
