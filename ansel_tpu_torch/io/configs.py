"""The bench configurations the port runs (`bench.py:CONFIGS`: configs 1-5),
and the port's own configs 7-17, defined once for the chip smoke, the
profile script and the tests.

Each history is a tuple of (op, params) pairs, so that a test can build
the JAX package's `HistoryItem`s from the same pairs as the port's.
Config 13's items also carry blend parameters and instances
(`BLENDS13`) and its drawn forms (`FORMS13`), each as plain values that
`history` and `forms13` turn into either package's classes.
"""

from __future__ import annotations

import contextlib
import math
import struct

# frame of bench configs 1 and 2: a 24 MP Bayer raw
BENCH_H, BENCH_W = 4000, 6016
# frame of bench config 3: a 45 MP Bayer raw
BENCH3_H, BENCH3_W = 5504, 8256
# frame of bench config 4: a 24 MP X-Trans raw (padded to 6016 columns)
BENCH4_H, BENCH4_W = 4000, 6000

_A, _B = (4e-4,) * 3, (1e-5,) * 3
_HUE6 = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)


def _curves(*curves, maxnodes=20):
    """Up to three curves' (x, y) nodes -> the interleaved 3 x maxnodes x 2
    floats of a curve module's params (unused slots 0, a missing curve
    the identity)."""
    out = []
    for ch in range(3):
        nodes = curves[ch] if ch < len(curves) else ((0.0, 0.0), (1.0, 1.0))
        flat = [v for node in nodes for v in node]
        out += flat + [0.0] * (2 * maxnodes - len(flat))
    return tuple(out)


# liquify's node record (`ansel_tpu/ops/liquify.py:decode_nodes`, 76
# bytes, 100 of them): header, warp, bezier controls
LIQUIFY_NODES = 100
PATH_MOVE, PATH_CURVE = 1, 3
WARP_LINEAR, WARP_RADIAL_GROW, WARP_RADIAL_SHRINK = 0, 1, 2


def liquify_node(ptype, prev, nxt, point, strength, radius, warp_type,
                  control=(0.5, 0.5), ctrl1=0j, ctrl2=0j):
    head = struct.pack("<4i3bB", ptype, 0, 0, 0, prev, 0, nxt, 0)
    warp = struct.pack("<8fii", point.real, point.imag, strength.real,
                       strength.imag, radius.real, radius.imag, control[0],
                       control[1], warp_type, 0)
    return head + warp + struct.pack("<4f", ctrl1.real, ctrl1.imag,
                                     ctrl2.real, ctrl2.imag)


def liquify_nodes(h: int, w: int) -> bytes:
    """Config 11's liquify blob for an (h, w) frame: a retouch brush path
    (one PATH_MOVE and three PATH_CURVE nodes, linear warps of radius 150
    px and strength 40 px at 24 MP, across a stroke of about 1500 px),
    then a radial-grow and a radial-shrink single stamp; every length
    scales with w / 6016, so a small test frame holds the same
    geometry."""
    s = w / BENCH_W
    path = [complex(0.36 * w, 0.55 * h), complex(0.45 * w, 0.50 * h),
            complex(0.53 * w, 0.54 * h), complex(0.61 * w, 0.50 * h)]
    push, reach = complex(0.0, -40.0 * s), 150.0 * s
    blob = b""
    for k, pt in enumerate(path):
        nxt = k + 1 if k + 1 < len(path) else -1
        if k == 0:
            blob += liquify_node(PATH_MOVE, -1, nxt, pt, pt + push,
                                  pt + reach, WARP_LINEAR)
            continue
        d = pt - path[k - 1]
        bend = d * 0.15j
        blob += liquify_node(PATH_CURVE, k - 1, nxt, pt, pt + push,
                              pt + reach, WARP_LINEAR,
                              ctrl1=path[k - 1] + d / 3.0 + bend,
                              ctrl2=pt - d / 3.0 + bend)
    for pt, grow, r, warp_type in (
            (complex(0.25 * w, 0.35 * h), 60.0, 200.0, WARP_RADIAL_GROW),
            (complex(0.75 * w, 0.65 * h), 50.0, 180.0, WARP_RADIAL_SHRINK)):
        blob += liquify_node(PATH_MOVE, -1, -1, pt, pt + grow * s,
                              pt + r * s, warp_type, control=(0.3, 0.7))
    return blob + b"\0" * (76 * LIQUIFY_NODES - len(blob))


def checker_patches(n: int) -> dict:
    """colorchecker params with n patches: sources spread over Lab (L 20-90,
    a and b on a circle of radius 15-45), each target moved by a few
    units."""
    src = [(20.0 + 70.0 * (k % 6) / 5.0,
            (15.0 + 30.0 * (k % 4) / 3.0) * math.cos(2.0 * math.pi * k / n),
            (15.0 + 30.0 * (k % 4) / 3.0) * math.sin(2.0 * math.pi * k / n))
           for k in range(n)]
    tgt = [(L + 2.0 + (k % 3), a * 1.05 + 3.0 * math.sin(k),
            b * 0.95 - 2.0 * math.cos(k)) for k, (L, a, b) in enumerate(src)]
    pad = (0.0,) * (49 - n)
    return {"num_patches": n,
            **{f"{kind}_{ch}": tuple(p[i] for p in pts) + pad
               for kind, pts in (("source", src), ("target", tgt))
               for i, ch in enumerate("Lab")}}


HISTORIES = {
    # the default pipe
    1: (("exposure", {"exposure": 0.5}),
        ("channelmixerrgb", {}),
        ("filmicrgb", {})),
    # the high-ISO denoise stack: guided-Laplacian highlights, a wavelet
    # denoise pass and an NLM pass
    2: (("highlights", {"mode": 3, "clip": 1.0}),
        ("denoiseprofile", {"a": _A, "b": _B, "strength": 2.0}),
        ("denoiseprofile", {"a": _A, "b": _B, "strength": 1.0, "mode": 0}),
        ("exposure", {"exposure": 0.5}),
        ("filmicrgb", {})),
    # the heavy iterative stack: diffuse (4 iterations), toneequal with
    # its guided mask, local-Laplacian local contrast
    3: (("diffuse", {"iterations": 4, "first": 0.2, "second": 0.2,
                     "third": 0.2, "fourth": 0.2, "radius": 8}),
        ("toneequal", {"shadows": 0.5}),
        ("bilat", {"sigma_r": 100.0, "sigma_s": 100.0, "detail": 0.3}),
        ("exposure", {"exposure": 0.5}),
        ("filmicrgb", {})),
    # X-Trans Markesteijn and lens with TCA.  bench.py labels it 3-pass,
    # but 1024 | 2 lacks the X-Trans flag, so both packages plan
    # Markesteijn 1-pass
    4: (("demosaic", {"demosaicing_method": 1024 | 2}),
        ("lens", {"tca_r": 1.0005, "tca_b": 0.9995, "dist_a": -0.02}),
        ("exposure", {"exposure": 0.5}),
        ("filmicrgb", {})),
    # the bilateral-grid stack, the port's own history: bench.py has no
    # config 7 (its 5 is the library path and its 6 a sidecar the repo
    # lacks).  The surface-blur bilateral (radius 15, three grids of 32
    # range bins), shadows & highlights softened by the bilateral grid
    # (radius 100), local contrast in bilateral mode (bilat mode 0, every
    # pre-3.0 bilat v1 sidecar) and sharpen: five grid slices per image
    7: (("bilateral", {}),
        ("exposure", {"exposure": 0.5}),
        ("filmicrgb", {}),
        ("shadhi", {"shadhi_algo": 1}),
        ("bilat", {"mode": 0, "sigma_r": 20.0, "sigma_s": 50.0,
                   "detail": 0.25}),
        ("sharpen", {})),
    # the raw-cleanup develop of a high-ISO night frame, the port's own
    # history and the one the smoke exports through a sidecar and the CLI:
    # hot pixels, raw denoise (a hat wavelet on the four CFA planes), CA
    # correction on the mosaic and in RGB, NLM denoise, defringe, a bloom
    # glow, then exposure and filmicrgb
    8: (("hotpixels", {}),
        ("rawdenoise", {}),
        ("cacorrect", {}),
        ("cacorrectrgb", {}),
        ("nlmeans", {}),
        ("defringe", {}),
        ("bloom", {}),
        ("exposure", {"exposure": 0.5}),
        ("filmicrgb", {})),
    # a camera DNG exported from its sidecar as a batch user straightens
    # and crops a portrait frame: the DNG's GainMap flat field, the
    # orientation (the native decoder reads no EXIF orientation, so the
    # sidecar carries it), clipping's 2-degree rotation with a crop of
    # about 5% on each side, then exposure and filmicrgb
    9: (("rawprepare", {"flat_field": 1}),
        ("flip", {"orientation": 6}),
        ("clipping", {"angle": 2.0, "cx": 0.05, "cy": 0.05, "cw": 0.95,
                      "ch": 0.95}),
        ("exposure", {"exposure": 0.5}),
        ("filmicrgb", {})),
    # the port's own: the default pipe with a graded look, the modules a
    # photographer adds on top of it (config 1's three, then colour
    # balance rgb with chroma, vibrance, saturation and a 4-way grade, a
    # 5-node RGB S-curve, a 5-node L tone curve, colour zones' three
    # curves over hue, the contrast equaliser lifting the fine scales, a
    # -0.3 vignette and a 1 EV graduated ND): both position-reading ops
    # run inside the chains, atrous on the EAW kernel's atrous variant
    10: (("exposure", {"exposure": 0.5}),
         ("channelmixerrgb", {}),
         ("filmicrgb", {}),
         ("colorbalancergb", {
             "chroma_global": 0.2, "vibrance": 0.25,
             "saturation_global": 0.2, "contrast": 0.1,
             "shadows_Y": -0.05, "shadows_C": 0.05, "shadows_H": 220.0,
             "midtones_C": 0.02, "midtones_H": 30.0,
             "highlights_Y": 0.05, "highlights_C": 0.05,
             "highlights_H": 50.0, "global_C": 0.01, "global_H": 180.0}),
         ("rgbcurve", {"curve_nodes": _curves(
             ((0.0, 0.0), (0.1, 0.07), (0.35, 0.38), (0.7, 0.78),
              (1.0, 1.0))), "curve_num_nodes": (5, 2, 2)}),
         ("tonecurve", {"tonecurve": _curves(
             ((0.0, 0.0), (0.25, 0.22), (0.5, 0.52), (0.75, 0.78),
              (1.0, 1.0))), "tonecurve_nodes": (5, 3, 3)}),
         ("colorzones", {"curve": _curves(
             tuple(zip(_HUE6, (0.5, 0.55, 0.5, 0.45, 0.5, 0.5))),
             tuple(zip(_HUE6, (0.5, 0.6, 0.55, 0.45, 0.6, 0.5))),
             ((0.0, 0.5), (0.33, 0.55), (0.66, 0.45), (1.0, 0.5))),
             "curve_num_nodes": (6, 6, 4)}),
         ("atrous", {"y": (0.65, 0.62, 0.58, 0.55, 0.52, 0.5)
                     + (0.5,) * 12 + (0.05,) * 12}),
         ("vignette", {"brightness": -0.3, "saturation": -0.2}),
         ("graduatednd", {"density": 1.0, "hardness": 20.0,
                          "rotation": 10.0, "hue": 0.6,
                          "saturation": 0.2})),
    # the port's own: a pre-3.0 catalogue's look on config 1's develop,
    # straightened and retouched: perspective correction (a 1.5-degree
    # rotation and a vertical lens shift, crop mode on), a liquify brush
    # path and two radial stamps, then the legacy look (colour balance's
    # slope/offset/power with a warm gain and a cool lift, velvia,
    # vibrance, colour contrast, contrast/brightness/saturation and split
    # toning)
    11: (("exposure", {"exposure": 0.5}),
         ("channelmixerrgb", {}),
         ("filmicrgb", {}),
         ("ashift", {"rotation": 1.5, "lensshift_v": 0.25,
                     "f_length": 28.0, "crop_factor": 1.5, "cropmode": 1,
                     "cl": 0.03, "cr": 0.97, "ct": 0.03, "cb": 0.97}),
         ("liquify", {"nodes": liquify_nodes(BENCH_H, BENCH_W)}),
         ("colorbalance", {"mode": 1, "lift": (1.0, 0.99, 1.0, 1.012),
                           "gamma": (1.0, 1.0, 1.02, 1.0),
                           "gain": (1.0, 1.05, 1.0, 0.95),
                           "saturation": 1.05, "contrast": 1.1}),
         ("velvia", {"strength": 25.0}),
         ("vibrance", {"amount": 25.0}),
         ("colorcontrast", {"a_steepness": 1.2, "b_steepness": 1.2}),
         ("colisa", {"contrast": 0.2, "brightness": 0.05,
                     "saturation": 0.1}),
         ("splittoning", {"compress": 20.0})),
    # the port's own: a landscape photographer's export of a hazy,
    # back-lit scene with a blown sky, with film grain, to an 8-bit file:
    # +1 EV, haze removal at the module's defaults, filmicrgb (AgX) with
    # its highlight reconstruction planned and fired (the threshold 1 EV
    # under the white point instead of 3 EV over it: the clip mask
    # covers about 30% of the frame), grain at its defaults and dither
    # for the 8-bit output
    12: (("exposure", {"exposure": 1.0}),
         ("hazeremoval", {}),
         ("filmicrgb", {"reconstruct_threshold": -1.0}),
         ("grain", {}),
         ("dither", {"dither_type": 5})),
}

# the port's own: a portrait photographer's local edits on config 1's
# develop, as a darktable sidecar carries them: a raw denoise under a
# drawn gradient (the RAW blend colorspace), spot removal (two heals and
# a clone) and a wavelet retouch (a heal on the image, a blur on scale 2
# and a fill on the residual of 4 scales), a second exposure instance
# lifting the face under a feathered ellipse, the channel mixer under a
# parametric mask of the input's Jz and hz and the output's grey
# (contrast and brightness on the mask), colour balance rgb's grade in
# the COLOR mode, velvia under a group of drawn shapes with a wide mask
# blur, a tone curve in LAB_LIGHTNESS and colour zones in OVERLAY on the
# deepest shadows, vibrance
# under a luminance range refined by the details slider (its flat areas)
# with a narrow blur, and colour contrast through the ellipse's mask (the
# raster side-band).  Its floats are float32 values, as its sidecar
# carries them
HISTORIES[13] = (
    ("rawdenoise", {"threshold": 0.02}),
    ("spots", None),
    ("retouch", None),
    ("exposure", {"exposure": 0.5}),
    ("exposure", {"exposure": 0.7}),
    ("channelmixerrgb", {}),
    ("colorbalancergb", dict(HISTORIES[10][3][1])),
    ("filmicrgb", {}),
    ("velvia", {"strength": 40.0}),
    ("tonecurve", dict(HISTORIES[10][5][1])),
    ("colorzones", dict(HISTORIES[10][6][1])),
    ("vibrance", {"amount": 40.0}),
    ("colorcontrast", {"a_steepness": 1.4, "b_steepness": 1.4}),
)

# forms (mask ids 101-106 the blends', 201-203 spots', 301-303 retouch's),
# as (type, nodes, clone source) in normalised coordinates, so that they
# land inside any frame: a gradient, a feathered ellipse, a circle, a
# polygon and a brush stroke, and a group (circle and polygon in union,
# the stroke taken away)
CIRCLE, POLYGON, GROUP, GRADIENT, ELLIPSE, BRUSH = 1, 2, 4, 16, 32, 64
_SHOW_USE = 1 | 2
UNION, DIFFERENCE = 1 << 3, 1 << 5


def _poly(points, border):
    """Bezier path nodes through `points` with controls on the chord."""
    out = []
    n = len(points)
    for i, (x, y) in enumerate(points):
        px, py = points[i - 1]
        nx, ny = points[(i + 1) % n]
        out.append((x, y, x + (px - x) / 4.0, y + (py - y) / 4.0,
                    x + (nx - x) / 4.0, y + (ny - y) / 4.0, border, border,
                    0))
    return tuple(out)


FORMS13 = {
    101: (GRADIENT, ((0.5, 0.62, 0.0, 0.2, 0.0, 0.15, 1),), (0.0, 0.0)),
    102: (ELLIPSE, ((0.45, 0.4, 0.12, 0.18, 20.0, 0.05, 0),), (0.0, 0.0)),
    103: (CIRCLE, ((0.7, 0.3, 0.08, 0.04),), (0.0, 0.0)),
    104: (POLYGON, _poly(((0.22, 0.62), (0.38, 0.6), (0.41, 0.78),
                          (0.24, 0.8)), 0.02), (0.0, 0.0)),
    105: (BRUSH, tuple(n[:8] + (1.0, 0.5, 0) for n in _poly(
        ((0.25, 0.68), (0.31, 0.73), (0.36, 0.69)), 0.015)), (0.0, 0.0)),
    106: (GROUP, ((103, 106, _SHOW_USE | UNION, 1.0),
                  (104, 106, _SHOW_USE | UNION, 0.9),
                  (105, 106, _SHOW_USE | DIFFERENCE, 1.0)), (0.0, 0.0)),
    201: (CIRCLE, ((0.2, 0.2, 0.03, 0.01),), (0.25, 0.26)),
    202: (CIRCLE, ((0.8, 0.75, 0.025, 0.01),), (0.76, 0.7)),
    203: (ELLIPSE, ((0.6, 0.5, 0.04, 0.03, 0.0, 0.02, 0),), (0.65, 0.55)),
    301: (CIRCLE, ((0.35, 0.25, 0.03, 0.01),), (0.38, 0.3)),
    302: (POLYGON, _poly(((0.45, 0.75), (0.58, 0.78), (0.5, 0.88)), 0.02),
          (0.0, 0.0)),
    303: (CIRCLE, ((0.85, 0.2, 0.05, 0.02),), (0.0, 0.0)),
}

# blend modes, mask modes and colorspaces (pipeline/blend.py)
_NORMAL2, _OVERLAY, _COLOR, _LAB_LIGHTNESS = 0x18, 10, 19, 0x1A
_CS_RAW, _CS_LAB, _CS_SCENE = 1, 2, 4
_ENABLED, _SHAPE, _PARAMETRIC, _RASTER = 1, 2, 4, 8
# per item of HISTORIES[13] (by index): (multi_priority, blend params as
# keyword arguments of BlendParams, or None)
BLENDS13 = {
    0: (0, dict(mask_mode=_ENABLED | _SHAPE, blend_cst=_CS_RAW,
                blend_mode=_NORMAL2, mask_id=101)),
    4: (1, dict(mask_mode=_ENABLED | _SHAPE, blend_cst=_CS_SCENE,
                blend_mode=_NORMAL2, mask_id=102, feathering_radius=12.0)),
    5: (0, dict(mask_mode=_ENABLED | _PARAMETRIC, blend_cst=_CS_SCENE,
                blend_mode=_NORMAL2, opacity=90.0, contrast=0.2,
                brightness=0.1,
                # the input's Jz (8) and hz (10, inverted), the output's
                # grey (0 + 4)
                blendif=(1 << 8) | (1 << 10) | (1 << 4) | (1 << 26),
                blendif_parameters=tuple(
                    {4: (0.0, 0.0, 0.45, 0.9), 8: (0.0005, 0.003, 1.0, 1.0),
                     10: (0.35, 0.45, 0.7, 0.8)}.get(i, (0.0, 0.0, 1.0, 1.0))[k]
                    for i in range(16) for k in range(4)))),
    6: (0, dict(mask_mode=_ENABLED, blend_cst=_CS_SCENE, blend_mode=_COLOR,
                opacity=70.0)),
    8: (0, dict(mask_mode=_ENABLED | _SHAPE, blend_cst=_CS_SCENE,
                blend_mode=_NORMAL2, mask_id=106, blur_radius=6.0)),
    9: (0, dict(mask_mode=_ENABLED, blend_cst=_CS_LAB,
                blend_mode=_LAB_LIGHTNESS, opacity=50.0)),
    # OVERLAY on unscaled Lab (R13: L in 0-100, so 1 - 2 (1 - a) (1 - b)
    # reaches -1e4 where the input's L passes 0.5): under a mask of the
    # input's L below 0.5, where it takes 2 a b
    10: (0, dict(mask_mode=_ENABLED | _PARAMETRIC, blend_cst=_CS_LAB,
                 blend_mode=_OVERLAY, opacity=40.0, blendif=1,
                 blendif_parameters=(0.0, 0.0, 0.003, 0.005)
                 + (0.0, 0.0, 1.0, 1.0) * 15)),
    11: (0, dict(mask_mode=_ENABLED | _PARAMETRIC, blend_cst=_CS_LAB,
                 blend_mode=_NORMAL2, blendif=1, details=-0.5,
                 blur_radius=2.0,
                 blendif_parameters=(0.2, 0.4, 0.8, 0.95)
                 + (0.0, 0.0, 1.0, 1.0) * 15)),
    12: (0, dict(mask_mode=_ENABLED | _RASTER, blend_cst=_CS_LAB,
                 blend_mode=_NORMAL2, raster_mask_source="exposure",
                 raster_mask_instance=1)),
}


def spots_params13(params_cls):
    """spots' params: two heals (201, 202) and a clone (203)."""
    ids = (201, 202, 203) + (0,) * 61
    algos = (2, 2, 1) + (2,) * 61
    return params_cls(clone_id=ids, clone_algo=algos)


def retouch_params13(params_cls, pack_form):
    """retouch's params at 4 scales: a heal on the image (301), a blur of
    radius 6 on scale 2 (302) and a grey fill on the residual (303)."""
    recs = (pack_form(301, 0, 2)
            + pack_form(302, 2, 3, blur_radius=6.0)
            + pack_form(303, 5, 4, fill_mode=1,
                        fill_color=(0.18, 0.18, 0.18)))
    blob = recs + b"\0" * (len(params_cls().rt_forms) - len(recs))
    return params_cls(rt_forms=blob, num_scales=4)


def _f32(v):
    """v with every float rounded to float32, as a sidecar carries it (so
    that the history and its sidecar plan alike)."""
    import numpy as np

    if isinstance(v, float):
        return float(np.float32(v))
    if isinstance(v, (tuple, list)):
        return type(v)(_f32(e) for e in v)
    if isinstance(v, dict):
        return {k: _f32(e) for k, e in v.items()}
    return v


def forms13(form_cls) -> dict:
    """Config 13's forms as `form_cls` (either package's masks.Form)."""
    return {fid: form_cls(id=fid, type=t, name=f"form {fid}",
                          nodes=[_f32(tuple(n)) for n in nodes],
                          src=_f32(tuple(src)))
            for fid, (t, nodes, src) in FORMS13.items()}


def history13(item_cls, blend_cls, spots_cls, retouch_cls, pack_form):
    """Config 13's history as `item_cls` items, with `blend_cls` blend
    params and the spots and retouch params; floats rounded to float32 as
    its sidecar carries them."""
    out = []
    for i, (op, p) in enumerate(HISTORIES[13]):
        if op == "spots":
            p = spots_params13(spots_cls)
        elif op == "retouch":
            p = retouch_params13(retouch_cls, pack_form)
        else:
            p = _f32(dict(p))
        mp, kw = BLENDS13.get(i, (0, None))
        out.append(item_cls(op, p, multi_priority=mp,
                            blend_params=None if kw is None
                            else blend_cls(**_f32(kw))))
    return out


# every blend mode (blend.h:63-110) and mask class of the chain kernel's
# blend record, as (label, blend colorspace, BlendParams keyword
# arguments): each mode under a uniform 70% mask with blend_parameter
# 0.5 in Lab and in scene RGB (NORMAL2 and OVERLAY reversed too), then
# the mask classes under NORMAL2: the contrast/brightness curve on a
# uniform mask, the combine bits, a parametric factor of each channel of
# the input and of the output, the polarity bits, several channels with
# the curve.  The tests hold each against the JAX package; the card
# tests and the chip smoke launch each as a blend record.
BLEND_MODES = (0x18, 0x01, 0x00, 0x19, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07,
               0x25, 0x08, 0x17, 0x09, 0x26, 0x27, 0x28, 0x29, 0x0A, 0x0C,
               0x0B, 0x0E, 0x0D, 0x0F, 0x10, 0x1A, 0x11, 0x1B, 0x1E, 0x1F,
               0x20, 0x21, 0x22, 0x23, 0x12, 0x13, 0x16, 0x1C, 0x1D)
_TRAPEZOIDS = ((0.1, 0.3, 0.7, 0.9), (0.0, 0.0, 0.6, 0.8),
               (0.2, 0.4, 1.0, 1.0), (0.3, 0.45, 0.55, 0.7))


def _blendif(bits, flip=0):
    """blendif bits and parameters: each channel its trapezoid from
    _TRAPEZOIDS in turn (Jz's and Cz's scaled to their small range)."""
    prm = []
    for i in range(16):
        t = _TRAPEZOIDS[i % 4]
        if i in (8, 9, 12, 13):
            t = tuple(v * 0.01 if v < 1.0 else v for v in t)
        prm += t
    return dict(blendif=bits | (flip << 16), blendif_parameters=tuple(prm))


def blend_cases():
    out = []
    for cst, tag, in_ids in ((_CS_LAB, "lab", (0, 1, 2, 8, 9)),
                             (_CS_SCENE, "rgb", (0, 1, 2, 3, 8, 9, 10))):
        base = dict(blend_cst=cst, mask_mode=_ENABLED, opacity=70.0,
                    blend_parameter=0.5)
        for mode in BLEND_MODES:
            out.append((f"{tag}-mode-{mode:#04x}", cst,
                        dict(base, blend_mode=mode)))
        for mode in (0x18, 0x0A):
            out.append((f"{tag}-mode-{mode:#04x}-reverse", cst,
                        dict(base, blend_mode=mode | 0x80000000)))
        par = dict(base, blend_mode=_NORMAL2,
                   mask_mode=_ENABLED | _PARAMETRIC, opacity=85.0)
        out += [
            (f"{tag}-uniform-curve", cst,
             dict(base, blend_mode=_NORMAL2, contrast=0.4, brightness=0.3)),
            (f"{tag}-uniform-curve-dark", cst,
             dict(base, blend_mode=_NORMAL2, contrast=-0.3,
                  brightness=-0.4)),
            (f"{tag}-uniform-inv", cst,
             dict(base, blend_mode=_NORMAL2, mask_combine=1)),
            (f"{tag}-uniform-incl", cst,
             dict(base, blend_mode=_NORMAL2, mask_combine=2)),
        ]
        for i in in_ids:
            out.append((f"{tag}-in-{i}", cst, dict(par, **_blendif(1 << i))))
            out.append((f"{tag}-out-{i}", cst,
                        dict(par, **_blendif(1 << (i + 4)))))
        many = (1 << in_ids[0]) | (1 << in_ids[-1]) | (1 << (in_ids[1] + 4))
        for combine in (0, 1, 2, 3):
            out.append((f"{tag}-many-combine{combine}", cst,
                        dict(par, mask_combine=combine,
                             **_blendif(many, flip=1 << in_ids[-1]))))
        out.append((f"{tag}-many-curve", cst,
                    dict(par, contrast=0.5, brightness=-0.2,
                         **_blendif(many))))
    return tuple(out)


# the stage between a blend case's keep and blend records: a 3 x 3 mix
BLEND_CASE_MATRIX = ((0.9, 0.1, 0.05), (0.02, 1.1, -0.05), (0.0, 0.1, 0.95))


def blend_case_chain(cst, kw, device):
    """One case of `blend_cases()` as a chain of three records on
    `device`: keep, a matrix stage (BLEND_CASE_MATRIX), and the blend of
    the matrix's output over its input."""
    import torch

    from ..color.transforms import apply_matrix
    from ..kernels import pointwise as pw
    from ..ops.base import PointwiseSpec
    from ..pipeline import blend

    keep, rec = blend.blend_specs(blend.BlendParams(**kw), cst)
    mid = PointwiseSpec(fn=lambda x, c: apply_matrix(x, c["M"]),
                        opcode=pw.OP_MATRIX, consts=("M",))
    m = torch.tensor(BLEND_CASE_MATRIX, dtype=torch.float32, device=device)
    return pw.pack_chain([keep, mid, rec], [{}, {"M": m}, {}], device)


# the eleven grading ops of the chain kernel (opcodes 8-18), each with two
# parameter sets (the first config 10's where config 10 has it; the second
# takes another branch: the other saturation formula, per-channel curves,
# another norm, a negative density, ...), as (op, input space, params A,
# params B).  The tests hold each against the JAX package; the chip smoke
# launches each as a one-stage chain (`opcode_chain`).
_CB10 = dict(HISTORIES[10][3][1])
GRADING_CASES = (
    ("colorbalancergb", "rgb", _CB10,
     dict(_CB10, saturation_formula=0, brilliance_global=0.1,
          brilliance_shadows=-0.1, saturation_highlights=0.2,
          hue_angle=20.0)),
    ("rgbcurve", "rgb", dict(HISTORIES[10][4][1]),
     {"curve_autoscale": 1, "curve_num_nodes": (4, 3, 5),
      "curve_type": (0, 1, 2), "curve_nodes": _curves(
          ((0.0, 0.0), (0.3, 0.25), (0.6, 0.7), (1.0, 1.0)),
          ((0.0, 0.05), (0.5, 0.5), (1.0, 0.95)),
          ((0.0, 0.0), (0.2, 0.25), (0.4, 0.42), (0.7, 0.68),
           (1.0, 1.0)))}),
    ("rgblevels", "rgb",
     {"levels": (0.02, 0.4, 0.95) * 3},
     {"autoscale": 0, "levels": (0.0, 0.45, 1.0, 0.03, 0.5, 0.9, 0.01,
                                 0.55, 0.97)}),
    ("basecurve", "rgb",
     {"basecurve_nodes": (5, 0, 0), "basecurve": _curves(
         ((0.0, 0.0), (0.1, 0.12), (0.3, 0.4), (0.6, 0.75), (1.0, 1.0)))},
     {"basecurve_nodes": (4, 0, 0), "basecurve_type": (0, 2, 2),
      "preserve_colors": 0, "basecurve": _curves(
          ((0.0, 0.0), (0.25, 0.3), (0.6, 0.7), (1.0, 1.0)))}),
    ("tonecurve", "lab", dict(HISTORIES[10][5][1]),
     {"tonecurve_nodes": (4, 3, 3), "tonecurve_type": (1, 2, 2),
      "tonecurve": _curves(
          ((0.0, 0.02), (0.3, 0.25), (0.7, 0.75), (1.0, 0.98)))}),
    ("levels", "lab", {"levels": (0.05, 0.45, 0.95)},
     {"levels": (0.0, 0.6, 0.9)}),
    ("basicadj", "rgb",
     {"exposure": 0.3, "contrast": 0.2, "saturation": 0.2, "vibrance": 0.3,
      "hlcompr": 40.0, "brightness": 0.1},
     {"contrast": 0.2, "preserve_colors": 0, "black_point": 0.01,
      "brightness": -0.1}),
    ("colorzones", "lab", dict(HISTORIES[10][6][1]),
     dict(HISTORIES[10][6][1], channel=0, strength=50.0)),
    ("negadoctor", "rgb", {"Dmin": (0.9, 0.7, 0.5, 1.0)},
     {"film_stock": 0, "Dmin": (0.8, 0.8, 0.8, 1.0), "gamma": 3.0}),
    ("vignette", "rgb", dict(HISTORIES[10][8][1]),
     {"brightness": 0.3, "saturation": 0.4, "whratio": 1.5, "shape": 2.0,
      "center_x": 0.1, "center_y": -0.2, "falloff_scale": 30.0}),
    ("graduatednd", "rgb", dict(HISTORIES[10][9][1]),
     {"density": -1.5, "rotation": -30.0, "hardness": 70.0,
      "offset": 40.0}),
)


# the twelve legacy pointwise ops of the chain kernel (opcodes 19-30), as
# (op, input kind, parameter sets): "rgb" work RGB, "lab" Lab, "camera"
# camera RGB (profile_gamma runs before colorin).  The first set is
# config 11's where config 11 has the op; each other set takes another
# branch: colorbalance's three modes, colisa's sigmoid and linear
# contrast, profile_gamma's log, toe and pure power forms, colorchecker
# with 12 patches (in the chain) and 24 (alone, as the JAX package runs
# it), splittoningrgb's coinciding keys, colorcontrast's clamp.
_H11 = {op: p for op, p in HISTORIES[11]}
LEGACY_CASES = (
    ("velvia", "rgb", (_H11["velvia"], {"strength": 60.0, "bias": 0.3})),
    ("vibrance", "lab", (_H11["vibrance"], {"amount": -40.0})),
    ("colorcontrast", "lab",
     (_H11["colorcontrast"],
      {"a_steepness": 1.8, "a_offset": 10.0, "b_steepness": 0.7,
       "b_offset": -5.0, "unbound": 0})),
    ("colorcorrection", "lab",
     ({"hia": 10.0, "hib": 15.0, "loa": -8.0, "lob": -12.0,
       "saturation": 1.1},
      {"hia": -5.0, "hib": 20.0, "loa": 5.0, "lob": -20.0,
       "saturation": 0.8})),
    ("colisa", "lab",
     (_H11["colisa"],
      {"contrast": -0.3, "brightness": -0.2, "saturation": -0.4})),
    ("splittoning", "rgb",
     (_H11["splittoning"],
      {"shadow_hue": 0.6, "shadow_saturation": 0.8, "highlight_hue": 0.1,
       "highlight_saturation": 0.7, "balance": 0.35, "compress": 5.0})),
    ("colorize", "lab",
     ({"hue": 0.08, "saturation": 0.6, "source_lightness_mix": 60.0,
       "lightness": 45.0},
      {"hue": 0.55, "saturation": 0.3, "source_lightness_mix": 20.0,
       "lightness": 60.0})),
    ("colorbalance", "rgb",
     (_H11["colorbalance"],
      {"mode": 0, "lift": (1.0, 1.02, 1.0, 0.98),
       "gamma": (1.05, 1.0, 0.97, 1.0), "gain": (0.95, 1.0, 1.03, 1.0),
       "saturation_out": 1.1, "grey": 20.0, "contrast": 0.9},
      {"mode": 2, "lift": (0.98, 1.0, 1.0, 1.03),
       "gamma": (1.0, 1.1, 1.0, 0.9), "gain": (1.02, 1.0, 1.0, 1.0),
       "saturation": 0.9})),
    ("splittoningrgb", "rgb",
     ({"ev": (-3.0, 1.0), "temperature": (7000.0, 3500.0)},
      {"ev": (-2.0, -2.0), "temperature": (4500.0, 6500.0),
       "red": (0.9, 0.1, 0.0, 1.1, -0.1, 0.0),
       "normalize": (1, 1, 1, 0, 0, 0)})),
    ("lowlight", "lab",
     ({"blueness": 40.0,
       "transition_y": (1.0, 0.8, 0.6, 0.4, 0.2, 0.1)},
      {"blueness": 0.0,
       "transition_y": (0.2, 0.4, 0.6, 0.8, 0.9, 1.0)})),
    ("profile_gamma", "camera",
     ({"mode": 0}, {"mode": 1, "linear": 0.1, "gamma": 0.45},
      {"mode": 1, "linear": 0.0, "gamma": 0.5})),
    ("colorchecker", "lab", (checker_patches(12), checker_patches(24))),
)
# the stage of config 11's chain whose input each legacy op takes when it
# runs alone on config 11's arguments: its own where config 11 has it,
# else the first Lab stage (colisa's input), colour balance's (scene-
# referred work RGB) or colorin's (camera RGB after exposure, where
# profile_gamma sits)
LEGACY_AT = {"lowlight": "colisa", "colorcorrection": "colisa",
             "colorize": "colisa", "colorchecker": "colisa",
             "splittoningrgb": "colorbalance", "profile_gamma": "colorin"}


def legacy_jobs(x, chain, names):
    """(key, x, op, params) of each LEGACY_CASES op as it runs alone on
    config 11's arguments: `x` the input of config 11's chain, `chain`
    that chain and `names` its stages' names; the stage inputs come from
    the chain's plain twin stage by stage.  Keyed (11, op), profile_gamma
    (11, op, i) for each of its sets, colorchecker on its first (12
    patches, in the chain)."""
    inputs = {}
    for (fn, c, needs_pos), name in zip(chain.stages, names):
        inputs.setdefault(name, x)
        x = fn(x, c)
    jobs = []
    for name, _, sets in LEGACY_CASES:
        xin = inputs[LEGACY_AT.get(name, name)]
        if name == "profile_gamma":
            jobs += [((11, name, i), xin, name, prm)
                     for i, prm in enumerate(sets)]
        else:
            jobs.append(((11, name), xin, name, sets[0]))
    return jobs


def grading_jobs(chain_inputs):
    """(key, x, op, params) of each GRADING_CASES op as it runs alone on
    config 10's arguments: `chain_inputs` are the inputs of config 10's
    two chains, the RGB ops take the first (the demosaiced image), the
    Lab ops the second; the first parameter set, and for
    colorbalancergb both saturation formulas (dt UCS keyed
    (10, op, 1), JzAzBz (10, op, 0)); else keyed (10, op)."""
    jobs = []
    for name, kind, params, other in GRADING_CASES:
        x = chain_inputs[0] if kind == "rgb" else chain_inputs[1]
        if name == "colorbalancergb":
            jobs += [((10, name, 1), x, name, params),
                     ((10, name, 0), x, name, other)]
        else:
            jobs.append(((10, name), x, name, params))
    return jobs


def opcode_chain(meta, op_name, params, shape, device, colorspace=None):
    """One op of GRADING_CASES or LEGACY_CASES as a one-stage chain for a (3, H, W) array
    `shape`: the op planned on a frame of that size in its input space
    (or `colorspace`), its coefficients on `device`, packed by
    `pointwise.pack_chain`."""
    import dataclasses

    from ..core.types import Colorspace, ImageSpec
    from ..kernels import pointwise as pw
    from ..ops.base import PlanContext, get_op
    from ..pipeline.engine import coeffs_to_device

    op = get_op(op_name)
    p = dataclasses.replace(op.default_params(meta), **params)
    cs = colorspace or op.input_colorspace or Colorspace.CAMERA_RGB
    spec = ImageSpec(width=shape[2], height=shape[1], colorspace=cs)
    ctx = PlanContext(meta=meta)
    plan = op.plan(ctx, spec, p)
    c = coeffs_to_device([op.coeffs(ctx, plan, p)], device)[0]
    return pw.pack_chain([op.pointwise_spec(plan, ctx)], [c], device)


def colormapping_params(target_lab, source_lab, n: int = 3,
                        dominance: float = 40.0,
                        equalization: float = 60.0) -> dict:
    """colormapping's params with source and target set (flag 3), as the
    GUI's acquire fills them: the target's histogram and clusters from one
    (3, H, W) Lab image, the source's inverse histogram and clusters from
    another (`ops.colormapping.acquire_stats`)."""
    import numpy as np

    from ..ops.colormapping import HISTN, MAXN, acquire_stats

    h_t, _, m_t, v_t, w_t = acquire_stats(target_lab, n)
    _, inv_s, m_s, v_s, w_s = acquire_stats(source_lab, n)

    def pad(a, size):
        a = [float(v) for v in np.asarray(a, np.float64).reshape(-1)]
        return tuple(a) + (0.0,) * (size - len(a))

    return {"flag": 3, "n": n, "dominance": dominance,
            "equalization": equalization,
            "source_ihist": pad(inv_s, HISTN),
            "source_mean": pad(m_s, 2 * MAXN),
            "source_var": pad(v_s, 2 * MAXN),
            "source_weight": pad(w_s, MAXN),
            "target_hist": tuple(int(v) for v in h_t),
            "target_mean": pad(m_t, 2 * MAXN),
            "target_var": pad(v_t, 2 * MAXN),
            "target_weight": pad(w_t, MAXN)}


# the ops of the generator and the guided filters that config 12 does not
# run, each alone on its frame: (op, params); colormapping's statistics
# come from the frame (`colormapping_params`).  Censorize blurs at sigma 8
# (the IIR kernel) and 3 (sepblur, 25 taps); the Laplacian is config 2's
# with its salt
OPS12 = (
    ("censorize", {"radius_1": 8.0, "pixelate": 16.0, "radius_2": 3.0,
                   "noise": 0.2}),
    ("highlights", {"mode": 3, "clip": 1.0, "noise_level": 0.1}),
    ("tonemap", {}),
    ("globaltonemap", {"detail": 0.5}),
    ("colormapping", None),
    ("crystgrain", {}),
)


# config 14 (a look shared as a style, on config 1's develop): the
# style's items, in order, as (op, multi_priority); its fixtures are
# written by `write_fixtures14` and its history built by `history14`
STYLE14 = (("colorin", 0), ("lut3d", 0), ("lut3d", 1), ("drawlayer", 0),
           ("colorout", 0))
CUBE14_LEVEL = 33           # the .cube's levels
KEYPOINTS14 = 16            # the inline compressed CLUT's keypoints
LAYER14 = (1000, 1504)      # the painted layer (upsampled onto the frame)
B2A14_GRID = 9              # the output profile's B2A CLUT grid
# the layer's name is the absolute path of its .npz less the extension,
# in drawlayer's 64-byte field (a NUL at the end)
LAYER14_NAME = "stroke14"
LAYER14_NAME_MAX = 63


def _icc_tagged(tags, pcs=b"XYZ "):
    """ICC profile bytes from (signature, payload) tags, made as
    tests/test_icc.py makes them (the card machine has no copy of it)."""
    header = bytearray(128)
    header[16:20] = b"RGB "
    header[20:24] = pcs
    header[36:40] = b"acsp"
    table, payloads = b"", b""
    off = 132 + 12 * len(tags)
    for sig, payload in tags:
        table += struct.pack(">4sII", sig, off, len(payload))
        payloads += payload
        off += len(payload)
    prof = header + struct.pack(">I", len(tags)) + table + payloads
    prof[0:4] = struct.pack(">I", len(prof))
    return bytes(prof)


def _icc_xyz(v):
    return b"XYZ \0\0\0\0" + struct.pack(
        ">iii", *(int(round(x * 65536)) for x in v))


def icc_matrix_profile(gamma: float = 1.0) -> bytes:
    """A matrix+TRC profile: sRGB-like primaries in XYZ D50 and a pure
    gamma TRC (tests/test_icc.py's `make_matrix_icc`)."""
    curv = b"curv\0\0\0\0" + struct.pack(
        ">IH", 1, int(round(gamma * 256))) + b"\0\0"
    return _icc_tagged([
        (b"wtpt", _icc_xyz((0.9642, 1.0, 0.8249))),
        (b"rXYZ", _icc_xyz((0.4360, 0.2225, 0.0139))),
        (b"gXYZ", _icc_xyz((0.3851, 0.7169, 0.0971))),
        (b"bXYZ", _icc_xyz((0.1431, 0.0606, 0.7139))),
        (b"rTRC", curv), (b"gTRC", curv), (b"bTRC", curv),
    ])


def icc_b2a_profile(grid: int = B2A14_GRID) -> bytes:
    """A LUT profile with only an mft2 B2A0: linear curves and a CLUT that
    decodes PCSXYZ (x2), so the device values are the XYZ input
    (tests/test_icc.py's `make_b2a_icc`)."""
    import numpy as np

    head = b"mft2\0\0\0\0" + struct.pack(">BBBB", 3, 3, grid, 0)
    matrix = struct.pack(">9i", *(int(round(v * 65536)) for v in
                                  (1, 0, 0, 0, 1, 0, 0, 0, 1)))
    ent = struct.pack(">HH", 2, 2)
    curve = struct.pack(">2H", 0, 65535)
    g1 = np.linspace(0.0, 1.0, grid)
    rr, gg, bb = np.meshgrid(g1, g1, g1, indexing="ij")
    clut = np.clip(np.stack([rr, gg, bb], -1) * 2.0, 0.0, 1.0)
    clut16 = np.round(clut * 65535).astype(">u2").tobytes()
    payload = head + matrix + ent + curve * 3 + clut16 + curve * 3
    return _icc_tagged([(b"wtpt", _icc_xyz((0.9642, 1.0, 0.8249))),
                        (b"B2A0", payload)])


def cube14(seed: int, level: int = CUBE14_LEVEL):
    """A seeded look as a (level, level, level, 3) table in [0, 1],
    indexed [b][g][r]: the identity bent by a smooth seeded warp (a
    split tone and a gentle S on each channel)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    g = np.linspace(0.0, 1.0, level)
    b, gg, r = np.meshgrid(g, g, g, indexing="ij")
    rgb = np.stack([r, gg, b], -1)
    amp = rng.uniform(0.02, 0.06, 3)
    phase = rng.uniform(0.0, 2.0 * math.pi, 3)
    luma = rgb @ np.array([0.2126, 0.7152, 0.0722])
    out = rgb + amp * np.sin(2.0 * math.pi * rgb + phase) * 0.5 \
        + (luma[..., None] - 0.5) * rng.uniform(-0.04, 0.04, 3)
    return np.clip(out, 0.0, 1.0)


def write_cube(path: str, table) -> None:
    """A (level, level, level, 3) [b][g][r] table as a .cube file (red
    fastest)."""
    level = table.shape[0]
    rows = "\n".join(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}"
                     for v in table.reshape(-1, 3))
    with open(path, "w") as f:
        f.write(f"TITLE \"config 14\"\nLUT_3D_SIZE {level}\n{rows}\n")


def keypoints14(seed: int, n: int = KEYPOINTS14):
    """(n, 6) uint8 compressed-CLUT keypoints: the cube's eight corners
    kept, the rest seeded positions pushed toward warm highlights and
    cool shadows."""
    import numpy as np

    rng = np.random.default_rng(seed + 1)
    corners = [(r, g, b) for r in (0, 255) for g in (0, 255)
               for b in (0, 255)]
    kp = [c + c for c in corners]
    for pos in rng.integers(24, 232, (n - len(corners), 3)):
        lum = float(pos.mean()) / 255.0
        shift = np.array([12.0, 2.0, -12.0]) * (lum - 0.5) * 2.0
        out = np.clip(pos + shift + rng.normal(0.0, 3.0, 3), 0, 255)
        kp.append(tuple(int(v) for v in pos) + tuple(int(v) for v in out))
    return np.asarray(kp, np.uint8)


def stroke14(seed: int, shape=LAYER14):
    """A seeded soft-edged brush stroke as a premultiplied (H, W, 4)
    float32 RGBA layer: a wavy band across the frame, its alpha a
    Gaussian falloff from the band's centre line (at most 0.8)."""
    import numpy as np

    rng = np.random.default_rng(seed + 2)
    h, w = shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    amp, freq, phase = (rng.uniform(0.08, 0.15) * h,
                        rng.uniform(1.0, 2.0), rng.uniform(0, 2 * math.pi))
    centre = 0.55 * h + amp * np.sin(2 * math.pi * freq * xx / w + phase)
    width = rng.uniform(0.03, 0.05) * h
    alpha = 0.8 * np.exp(-0.5 * ((yy - centre) / width) ** 2)
    colour = rng.uniform(0.2, 0.9, 3)
    rgba = np.concatenate([alpha[..., None] * colour, alpha[..., None]], -1)
    return rgba.astype(np.float32)


def write_fixtures14(directory: str, seed: int = 0) -> dict:
    """Config 14's files in `directory`, made from `seed`: the input and
    output ICC profiles, the .cube and the painted layer's .npz.  ->
    their absolute paths ("layer" without its .npz, as drawlayer names
    it) and the inline keypoints ("keypoints")."""
    import os

    import numpy as np

    directory = os.path.abspath(directory)
    paths = {"icc_in": os.path.join(directory, "in14.icc"),
             "icc_out": os.path.join(directory, "out14.icc"),
             "cube": os.path.join(directory, "look14.cube"),
             "layer": os.path.join(directory, LAYER14_NAME)}
    if len(paths["layer"].encode()) > LAYER14_NAME_MAX:
        raise ValueError(f"config 14's layer path {paths['layer']!r} is "
                         f"longer than drawlayer's {LAYER14_NAME_MAX} "
                         "bytes: write the fixtures to a shorter directory")
    with open(paths["icc_in"], "wb") as f:
        f.write(icc_matrix_profile(1.0))
    with open(paths["icc_out"], "wb") as f:
        f.write(icc_b2a_profile())
    write_cube(paths["cube"], cube14(seed))
    np.savez_compressed(paths["layer"] + ".npz", rgba=stroke14(seed))
    return dict(paths, keypoints=keypoints14(seed))


def fixture_dir14() -> str:
    """A new directory for config 14's files whose layer path fits
    drawlayer's field: under the temporary directory, or else under the
    checkout's `build/` (the caller removes it)."""
    import os
    import tempfile

    root = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "build")
    for parent in (tempfile.gettempdir(), root):
        room = LAYER14_NAME_MAX - len(LAYER14_NAME) - 1 - len("c14_XXXXXXXX")
        if len(os.path.abspath(parent).encode()) + 1 <= room:
            os.makedirs(parent, exist_ok=True)
            return tempfile.mkdtemp(prefix="c14_", dir=parent)
    raise ValueError("no directory short enough for config 14's layer path")


def style14_items(fixtures: dict, item_cls, params_class) -> list:
    """Config 14's style as `item_cls` items with `params_class(op)`
    dataclass params (either package's classes): a matrix+TRC input
    profile, the .cube in sRGB (tetrahedral), the inline keypoints in
    linear Rec2020 (trilinear), the painted layer and the B2A output
    profile, every path absolute."""
    kp = fixtures["keypoints"]
    params = {
        ("colorin", 0): dict(type=0, filename=fixtures["icc_in"]),
        ("lut3d", 0): dict(filepath=fixtures["cube"], colorspace=0,
                           interpolation=0),
        ("lut3d", 1): dict(nb_keypoints=int(kp.shape[0]),
                           c_clut=kp.tobytes(), colorspace=4,
                           interpolation=1),
        ("drawlayer", 0): dict(layer_name=fixtures["layer"]),
        ("colorout", 0): dict(type=0, filename=fixtures["icc_out"]),
    }
    out = []
    for op, mp in STYLE14:
        cls = params_class(op)
        out.append(item_cls(op, cls(**params[(op, mp)]),
                            version=cls.op_version, multi_priority=mp))
    return out


def history14(directory: str, seed: int = 0, item_cls=None,
              params_class=None, styles=None) -> list:
    """Config 14's history: the fixtures written to `directory` from
    `seed`, the style written as a .dtstyle there with `styles`'
    write_style, read back with its parse_style and merged onto config
    1's history with its apply_style (the port's `HistoryItem`, params
    classes and `io/styles` by default; the JAX package's in its
    tests)."""
    import os

    if item_cls is None:
        from ..core.params import params_class
        from ..pipeline.engine import HistoryItem as item_cls
        from . import styles
    fixtures = write_fixtures14(directory, seed)
    path = os.path.join(os.path.abspath(directory), "config14.dtstyle")
    styles.write_style(path, styles.Style(
        name="config 14", description="a look: ICC in and out, two LUTs "
        "and a painted layer",
        items=style14_items(fixtures, item_cls, params_class)))
    return styles.apply_style(history(1, item_cls),
                              styles.parse_style(path))


# config 15, the port's own: a back-lit landscape on a low-ISO Bayer body,
# developed with the reconstruction and the demosaic such a sky calls
# for.  HARMONIC highlights at the module's defaults (clip 1.0, 8 scales,
# 30 iterations: the guided Laplacian's 360 blurs, then the dome core);
# RCD with the dual blend (0x2005, the JAX package's encoding, ROADMAP
# R1) at dual_thrs 0.20, green equilibration 3 (full and local average)
# and 2 passes of colour smoothing; then config 1's develop (one chain,
# program 0 of pointwise.FIXED)
HISTORY15_DEMOSAIC = {"demosaicing_method": 5 | 0x2000, "dual_thrs": 0.20,
                      "green_eq": 3, "color_smoothing": 2}
HISTORIES[15] = (("highlights", {"mode": 4}),
                 ("demosaic", HISTORY15_DEMOSAIC)) + HISTORIES[1]
# config 15's exposure: config 1's scene 2 EV brighter, every photosite
# clipped at the white level.  At 1000 x 1504 it puts 21% of the red, 41%
# of the green and 22% of the blue photosites at white, and 2.8% of the
# 2x2 cells have all four there (`clip_shares`; chip_smoke.py prints them
# at the full frame)
GAIN15 = 4.0


def mosaic15(raw, meta):
    """Config 15's mosaic from config 1's (`synth_raw(kind="gradients")`,
    seeded there): the light above black times GAIN15, clipped at the
    white level as a sensor clips it.  Works on numpy arrays and
    tensors alike."""
    import numpy as np

    black = float(meta.black_levels[0])
    white = float(meta.white_point)
    lifted = (raw - black) * GAIN15 + black
    if isinstance(raw, np.ndarray):
        return np.minimum(lifted, white).astype(np.float32)
    return lifted.clamp(max=white)


def clip_shares(raw, meta) -> dict:
    """Shares of a Bayer mosaic's photosites at the white level per
    channel (R, G, B by the CFA's colours) and of its 2x2 cells with all
    four photosites there: numpy floats."""
    import numpy as np

    at = np.asarray(raw) >= float(meta.white_point)
    h, w = at.shape
    at = at[:h - h % 2, :w - w % 2]
    sites = {c: [] for c in range(3)}
    for y in range(2):
        for x in range(2):
            sites[meta.cfa.color_at(y, x)].append(at[y::2, x::2])
    shares = {name: float(np.mean(sites[c])) for c, name in
              enumerate("RGB")}
    cells = at[0::2, 0::2] & at[0::2, 1::2] & at[1::2, 0::2] & at[1::2, 1::2]
    shares["all"] = float(np.mean(cells))
    return shares


# the port's own: a darktable-4.0-era scene-referred edit of a high-ISO
# 24 MP raw, exported for the web with a frame and a signature.  Config
# 1's mosaic with the Poisson-Gaussian noise of a Sony ILCE-7M3 at ISO
# 3200 (`mosaic16`, the camera's row of data/noiseprofiles.json, which
# `meta16` names, so denoiseprofile's default params, its automatic
# profile, find it); denoiseprofile in wavelets mode; exposure; diffuse as
# local contrast at a combined radius of 64 px (8 wavelet scales at scale
# 1, one iteration); colour equalizer and colour primaries edits (their
# CLUTs built on the host); filmic rgb colour science v5 (params version
# 4); a white border with a frame line, and the ansel.svg signature.  Its
# floats are float32 values, as its sidecar carries them, the CLUT ops'
# sigmas included (their defaults are float64 and would build other
# CLUTs than the sidecar's float32 copies)
COLOREQUAL16_NODES = 6
SENSOR16 = ("Sony", "ILCE-7M3", 3200.0)
NOISE16_SEED = 16


def _colorequal_curves16():
    """colorequal's 3 rings x 3 channels of periodic curves (hue,
    saturation, brightness), 6 nodes each: warmer, richer mid tones,
    slightly desaturated darks, brighter light blues."""
    gains = {  # (ring, channel): per-node offsets of y from 0.5
        (0, 1): (-0.04, -0.04, -0.03, -0.04, -0.05, -0.04),
        (1, 0): (0.02, 0.015, 0.0, -0.01, 0.0, 0.01),
        (1, 1): (0.08, 0.06, 0.03, 0.02, 0.04, 0.06),
        (2, 2): (0.0, 0.0, 0.02, 0.05, 0.04, 0.0),
    }
    curve = [0.0] * (3 * 3 * 20 * 2)
    counts = [0] * 9
    for ring in range(3):
        for ch in range(3):
            dy = gains.get((ring, ch), (0.0,) * COLOREQUAL16_NODES)
            base = (ring * 3 + ch) * 20 * 2
            for k in range(COLOREQUAL16_NODES):
                curve[base + 2 * k] = k / COLOREQUAL16_NODES
                curve[base + 2 * k + 1] = 0.5 + dy[k]
            counts[ring * 3 + ch] = COLOREQUAL16_NODES
    return tuple(curve), tuple(counts)


_CURVE16, _COUNTS16 = _colorequal_curves16()
HISTORIES[16] = _f32((
    ("denoiseprofile", {}),
    ("exposure", {"exposure": 0.7}),
    ("diffuse", {"iterations": 1, "radius": 48, "radius_center": 16,
                 "regularization": 1.0, "variance_threshold": 0.25,
                 "anisotropy_first": 1.0, "anisotropy_third": 1.0,
                 "first": -0.25, "third": -0.25}),
    ("colorequal", {"curve": _CURVE16, "curve_num_nodes": _COUNTS16,
                    "sigma_L": 35.0, "sigma_rho": 1.0, "sigma_theta": 0.4,
                    "neutral_protection": 0.1}),
    ("colorprimaries", {"sigma_rho": 0.70710678, "sigma_theta": 0.70710678,
                        "hue": (4.0, 0.0, -3.0, 0.0, 2.0, 0.0),
                        "saturation": (8.0, 0.0, 6.0, -4.0, 0.0, 5.0),
                        "brightness": (0.0, 0.0, -4.0, 0.0, 0.0, 3.0)}),
    ("filmicrgb", {"version": 4, "white_point_source": 5.0,
                   "black_point_source": -9.0, "contrast": 1.25,
                   "saturation": 10.0, "latitude": 15.0}),
    ("borders", {"color": (0.96, 0.96, 0.95), "size": 0.05,
                 "frame_size": 0.3, "frame_offset": 0.5,
                 "frame_color": (0.15, 0.15, 0.15)}),
    ("watermark", {"filename": "ansel.svg", "scale": 18.0, "alignment": 8,
                   "opacity": 60.0, "xoffset": -0.01, "yoffset": -0.01}),
))


def meta16(meta):
    """Config 16's RawMeta: `meta` (either package's) naming the camera
    and ISO of `SENSOR16`."""
    import dataclasses

    maker, model, iso = SENSOR16
    return dataclasses.replace(meta, maker=maker, model=model, iso=iso)


def mosaic16(raw, meta, seed: int = NOISE16_SEED):
    """Config 16's mosaic from config 1's (numpy, sensor units): each
    photosite gets Gaussian noise of variance a x + b of its CFA colour,
    x the light above black over the white level's range, (a, b) the
    ILCE-7M3's ISO 3200 coefficients (the Poisson-Gaussian model of
    denoiseprofile), from a numpy generator seeded with `seed`; clipped
    at 0."""
    import numpy as np

    from . import noiseprofiles

    a, b = noiseprofiles.find(*SENSOR16)
    black = float(meta.black_levels[0])
    span = float(meta.white_point) - black
    h, w = raw.shape
    color = np.zeros((h, w), np.int64)
    for y in range(2):
        for x in range(2):
            color[y::2, x::2] = meta.cfa.color_at(y, x)
    x = np.clip((raw - black) / span, 0.0, None)
    var = np.take(np.asarray(a), color) * x + np.take(np.asarray(b), color)
    rng = np.random.default_rng(seed)
    noisy = raw + np.sqrt(var) * span * rng.standard_normal((h, w))
    return np.maximum(noisy, 0.0).astype(np.float32)


# config 16's filmicrgb (colour science v5) as `opcode_chain` params,
# and each colour science v1-v4 with each of the six preserve methods:
# the cases `spline_jobs` runs on config 16's second chain input
FILMIC16 = dict(HISTORIES[16])["filmicrgb"]
SPLINE_CASES = tuple((v, m) for v in range(4) for m in range(6)) + ((4, 0),)
# filmicrgb v5 after +1 EV with its highlight reconstruction planned and
# fired at 24 MP (threshold 2^(5 - 2) x 0.1845, config 12's), so that its
# tone map runs as the spline's one-stage program
SPLINE_REC16 = (("exposure", {"exposure": 1.0}),
                ("filmicrgb", dict(FILMIC16, reconstruct_threshold=-2.0)))


def spline_jobs(x):
    """((16, "filmic-spline", version, method), x, "filmicrgb", params) of
    each of SPLINE_CASES: for `opcode_chain` on config 16's second chain
    input x."""
    return [((16, "filmic-spline", v, m), x, "filmicrgb",
             dict(FILMIC16, version=v, preserve_color=m))
            for v, m in SPLINE_CASES]


# each op ported beside config 16, alone on a 24 MP frame (chip_smoke.py
# [ops16]): (label, op, params); invert's X-Trans case on config 4's
# mosaic
_H16 = dict(HISTORIES[16])
OPS16 = (
    ("filmic", "filmic", {"preserve_color": 1, "saturation": 80.0}),
    ("channelmixer", "channelmixer",
     {"red": (0.0, 0.0, 0.0, 0.9, 0.1, 0.05, 0.0),
      "green": (0.0, 0.0, 0.0, 0.05, 1.1, 0.0, 0.0),
      "blue": (0.0, 0.0, 0.0, -0.05, 0.1, 0.95, 0.0)}),
    ("invert", "invert", {"color": (0.9, 1.0, 0.8, 0.95)}),
    ("invert-xtrans", "invert", {"color": (0.9, 1.0, 0.8, 0.95)}),
    ("relight", "relight", {"ev": 0.8, "center": 0.3, "width": 6.0}),
    ("blurs-lens", "blurs", {"type": 0, "radius": 8, "blades": 6,
                             "concavity": 1.5, "linearity": 0.8}),
    ("blurs-motion", "blurs", {"type": 1, "radius": 8, "angle": 0.6,
                               "curvature": 1.5, "offset": 0.2}),
    ("blurs-gaussian", "blurs", {"type": 2, "radius": 8}),
    ("colorequal", "colorequal", _H16["colorequal"]),
    ("colorprimaries", "colorprimaries", _H16["colorprimaries"]),
    ("borders", "borders", _H16["borders"]),
    ("watermark", "watermark", _H16["watermark"]),
)


# config 17: config 16's noisy mosaic (an ILCE-7M3 at ISO 3200) through
# rawdenoiseai's multi-scale net with its low-band anchor, then config 1's
# develop.  No published weights are in the repo: the model is
# `random_unet_ms` at the repo's widths (base 8, depth 2) from a seed,
# written to MODEL17 in a directory on the op's search path (`model17`)
MODEL17 = "config17.anselnn"
HISTORIES[17] = (("rawdenoiseai", {"custom_model": MODEL17}),) \
    + HISTORIES[1]


@contextlib.contextmanager
def model17(seed: int = 0, ops=None):
    """Config 17's model for the length of a `with` block:
    `random_unet_ms(seed=seed)` written as MODEL17 to a new temporary
    directory, which goes first on the rawdenoiseai module's
    MODEL_SEARCH_PATH (`ops`, the port's by default; a test passes the
    JAX package's).  The module's registry entry of MODEL17 is dropped at
    both ends of the block, so the file is read (once) inside it.  ->
    the model's path."""
    import os
    import shutil
    import tempfile

    from .anselnn import random_unet_ms, save_anselnn

    if ops is None:
        from ..ops import rawdenoiseai as ops
    directory = tempfile.mkdtemp(prefix="ansel_model17_")
    path = os.path.join(directory, MODEL17)
    m = random_unet_ms(base=8, depth=2, seed=seed)
    save_anselnn(path, m.cfg, m.tensors)
    ops.MODEL_REGISTRY.pop(MODEL17, None)
    ops.MODEL_SEARCH_PATH.insert(0, directory)
    try:
        yield path
    finally:
        ops.MODEL_SEARCH_PATH.remove(directory)
        ops.MODEL_REGISTRY.pop(MODEL17, None)
        shutil.rmtree(directory, ignore_errors=True)


# bench config 5 (`bench.py:60-62, 98-158`): a film roll of LIBRARY5
# images, even ones Bayer (BENCH_H x BENCH_W), odd ones X-Trans
# (BENCH4_H x BENCH4_W, `remosaic_xtrans`), each `synth_raw` of seed i
# saved with `save_raw` beside a sidecar holding config 1's history;
# imported, queried through a Collection on the folder and batch-exported
# to JPEG
LIBRARY5 = 24


def catalog5_frame(i: int, h: int = BENCH_H, w: int = BENCH_W,
                   hx: int = BENCH4_H, wx: int = BENCH4_W):
    """Image `i` of config 5's roll: -> (mosaic, meta), Bayer at (h, w)
    for even i, X-Trans at (hx, wx) for odd i."""
    from .synthetic import synth_raw

    if i % 2 == 0:
        raw, meta, _ = synth_raw(h=h, w=w, kind="gradients", seed=i)
        return raw, meta
    _, meta, scene = synth_raw(h=hx, w=wx, kind="gradients", seed=i)
    return remosaic_xtrans(meta, scene)


def catalog5_pixels(n: int = LIBRARY5) -> int:
    """Photosites of config 5's roll of `n` full-size images."""
    return ((n + 1) // 2) * BENCH_H * BENCH_W + (n // 2) * BENCH4_H * BENCH4_W


def write_catalog5(folder: str, n: int = LIBRARY5, **frames) -> list:
    """Config 5's roll of `n` images in `folder`, each img{i:03d}.npz
    (`save_raw`) with a sidecar of config 1's history; -> their paths.
    The gradients scene does not depend on `synth_raw`'s seed, so image i
    equals image i - 2: images 0 and 1 are made and saved, the others are
    copies of their files."""
    import os
    import shutil

    from .rawfile import save_raw
    from .xmp import write_xmp

    os.makedirs(folder, exist_ok=True)
    paths = []
    for i in range(n):
        path = os.path.join(folder, f"img{i:03d}.npz")
        if i < 2:
            save_raw(path, *catalog5_frame(i, **frames))
            write_xmp(path + ".xmp", history(1))
        else:
            shutil.copyfile(paths[i % 2], path)
            shutil.copyfile(paths[i % 2] + ".xmp", path + ".xmp")
        paths.append(path)
    return paths


# config 18, the multi-device paths at 24 MP (`parallel/`): (a) a batch
# of BATCH18 images of config 1's mosaic at the gains GAINS18 over a dp
# axis of DP18, (b) HISTORIES[18] (tests/test_spatial_shard.py's denoise
# stack: highlights clip, denoiseprofile wavelets, nlmeans with its
# luma and chroma weights at 50, which extrapolate the denoised delta
# 50-fold, exposure, filmicrgb) row-sharded over SP18 shards with one halo
# exchange, (c) config 1's history row-sharded over a (dp 2, sp 2) mesh.
# Config 2's own history is refused by the shifted-window scheme: its
# guided-Laplacian highlights demand the full frame
HISTORIES[18] = (
    ("highlights", {"mode": 0, "clip": 1.0}),
    ("denoiseprofile", {"a": (4e-4,) * 3, "b": (1e-5,) * 3,
                        "strength": 2.0}),
    ("nlmeans", {"strength": 50.0, "luma": 50.0, "chroma": 50.0}),
    ("exposure", {"exposure": 0.5}),
    ("filmicrgb", {}),
)
DP18, SP18 = 2, 4
BATCH18 = 4
GAINS18 = (1.00, 1.01, 1.02, 1.03)

# config 19, a Lightroom roll: config 5's images 0 (Bayer) and 1
# (X-Trans), each beside the Lightroom sidecar LIGHTROOM19
# (tests/test_lightroom.py's), imported into a library and crawled (the
# crawler imports the Lightroom histories, ratings and tags), exported
# with `batch_export` and uploaded with `store_piwigo`
LIGHTROOM19 = """<?xml version="1.0" encoding="UTF-8"?>
<x:xmpmeta xmlns:x="adobe:ns:meta/">
 <rdf:RDF xmlns:rdf="http://www.w3.org/1999/02/22-rdf-syntax-ns#">
  <rdf:Description rdf:about=""
    xmlns:crs="http://ns.adobe.com/camera-raw-settings/1.0/"
    xmlns:xmp="http://ns.adobe.com/xap/1.0/"
    xmlns:dc="http://purl.org/dc/elements/1.1/"
    xmp:Rating="4"
    xmp:Label="Red"
    crs:Exposure2012="+0.85"
    crs:Blacks2012="-50"
    crs:HasCrop="True"
    crs:CropTop="0.1" crs:CropLeft="0.05" crs:CropBottom="0.9"
    crs:CropRight="0.95" crs:CropAngle="2.5"
    crs:ImageWidth="6000" crs:ImageLength="4000"
    crs:Orientation="6"
    crs:GrainAmount="30"
    crs:GrainFrequency="60"
    crs:PostCropVignetteAmount="-40"
    crs:PostCropVignetteMidpoint="30"
    crs:PostCropVignetteStyle="1"
    crs:SaturationAdjustmentRed="25"
    crs:LuminanceAdjustmentBlue="-30"
    crs:SplitToningShadowHue="220"
    crs:SplitToningShadowSaturation="30"
    crs:SplitToningHighlightHue="40"
    crs:SplitToningHighlightSaturation="20"
    crs:SplitToningBalance="-25"
    crs:ParametricShadows="20"
    crs:ToneCurveName2012="Medium Contrast">
   <dc:subject><rdf:Bag><rdf:li>alps</rdf:li><rdf:li>ski</rdf:li></rdf:Bag></dc:subject>
   <crs:ToneCurvePV2012><rdf:Seq>
     <rdf:li>0, 0</rdf:li><rdf:li>128, 140</rdf:li><rdf:li>255, 255</rdf:li>
   </rdf:Seq></crs:ToneCurvePV2012>
  </rdf:Description>
 </rdf:RDF>
</x:xmpmeta>
"""
ROLL19 = 2
# how much older than the import the Lightroom sidecars are (seconds):
# the crawl after the import sees them newer than the library's record,
# and a second crawl with write-back sees the imported history newer
SIDECAR_AGE19 = 3600


def write_roll19(folder: str, **frames) -> list:
    """Config 19's roll in `folder`: images 0 and 1 of config 5's roll
    (`catalog5_frame`, Bayer and X-Trans) saved as img{i:03d}.npz, each
    with the Lightroom sidecar LIGHTROOM19 written SIDECAR_AGE19 seconds
    in the past; -> their paths."""
    import os
    import time

    from .rawfile import save_raw

    os.makedirs(folder, exist_ok=True)
    paths = []
    then = time.time() - SIDECAR_AGE19
    for i in range(ROLL19):
        path = os.path.join(folder, f"img{i:03d}.npz")
        save_raw(path, *catalog5_frame(i, **frames))
        with open(path + ".xmp", "w", encoding="utf-8") as f:
            f.write(LIGHTROOM19)
        os.utime(path + ".xmp", (then, then))
        paths.append(path)
    return paths


# each config's frame (height, width)
FRAMES = {1: (BENCH_H, BENCH_W), 2: (BENCH_H, BENCH_W),
          3: (BENCH3_H, BENCH3_W), 4: (BENCH4_H, BENCH4_W),
          7: (BENCH_H, BENCH_W), 8: (BENCH_H, BENCH_W),
          9: (BENCH_H, BENCH_W), 10: (BENCH_H, BENCH_W),
          11: (BENCH_H, BENCH_W), 12: (BENCH_H, BENCH_W),
          13: (BENCH_H, BENCH_W), 14: (BENCH_H, BENCH_W),
          15: (BENCH_H, BENCH_W), 16: (BENCH_H, BENCH_W),
          17: (BENCH_H, BENCH_W), 18: (BENCH_H, BENCH_W)}
# config 9's DNG: a 14-bit mosaic and a GainMap of 17 x 25 points per
# RGGB filter
DNG9_BITS = 14
DNG9_MAP_POINTS = (17, 25)
# configs whose raw is an X-Trans mosaic (`remosaic_xtrans`)
XTRANS_CONFIGS = (4,)

# Fuji X-Trans III 6x6 pattern (colour indices, row-major)
XTRANS6 = (1, 2, 0, 1, 0, 2,
           0, 1, 1, 2, 1, 1,
           2, 1, 1, 0, 1, 1,
           1, 0, 2, 1, 2, 0,
           2, 1, 1, 0, 1, 1,
           0, 1, 1, 2, 1, 1)


def history(config: int, item_cls=None) -> list:
    """Config `config`'s history as `item_cls(op, params)` items, each
    with its own params dict (the port's `HistoryItem` by default; config
    13 as the port's classes, with its blends)."""
    if config == 13 and item_cls is None:
        from ..ops import retouch, spots
        from ..pipeline.blend import BlendParams
        from ..pipeline.engine import HistoryItem

        return history13(HistoryItem, BlendParams, spots.SpotsParams,
                         retouch.RetouchParams, retouch.pack_form)
    if item_cls is None:
        from ..pipeline.engine import HistoryItem as item_cls
    return [item_cls(op, dict(p)) for op, p in HISTORIES[config]]


@contextlib.contextmanager
def history_files(config: int, seed: int = 0):
    """Config `config`'s port history (`history`) for the length of a
    `with` block.  Config 14's names files: they are written from `seed`
    to a new directory (`fixture_dir14`, `history14`) and removed when
    the block ends, so plan its pipe inside the block.  Config 17's names
    its model, written from `seed` for the block (`model17`)."""
    if config == 17:
        with model17(seed):
            yield history(17)
        return
    if config != 14:
        yield history(config)
        return
    import shutil

    directory = fixture_dir14()
    try:
        yield history14(directory, seed)
    finally:
        shutil.rmtree(directory, ignore_errors=True)


def forms(config: int) -> dict:
    """The port's `masks.Form`s of config `config` (none but for 13)."""
    if config != 13:
        return {}
    from ..pipeline.masks import Form

    return forms13(Form)


def remosaic_xtrans(meta, scene):
    """Re-sample `synth_raw`'s (3, H, W) scene through XTRANS6: -> (the
    (H, W) float32 X-Trans mosaic in sensor units, meta with the pattern),
    as bench.py's `_remosaic_xtrans`."""
    import dataclasses

    import numpy as np

    _, h, w = scene.shape
    meta = dataclasses.replace(meta, xtrans=XTRANS6)
    idx = np.asarray(XTRANS6).reshape(6, 6)
    sel = idx[np.arange(h)[:, None] % 6, np.arange(w)[None, :] % 6]
    lin = np.take_along_axis(np.asarray(scene), sel[None], axis=0)[0]
    wb = np.asarray(meta.wb_coeffs)[:3][sel]
    raw = (lin / np.maximum(wb, 1e-6)
           * (meta.white_point - meta.black_levels[0])
           + meta.black_levels[0]).astype(np.float32)
    return raw, meta


def mosaic9(raw):
    """`synth_raw`'s (H, W) mosaic quantised to DNG9_BITS: uint16."""
    import numpy as np

    top = (1 << DNG9_BITS) - 1
    return np.clip(np.rint(raw), 0, top).astype(np.uint16)


def gain_maps9(mv: int = DNG9_MAP_POINTS[0], mh: int = DNG9_MAP_POINTS[1]):
    """Config 9's four GainMaps, one per RGGB filter: a radial falloff
    from 0.8 at the centre to 1.25 at the corners, the two green
    filters' 2% apart, each (mv * mh,) float32 in row-major order."""
    import numpy as np

    y = np.linspace(-1.0, 1.0, mv)[:, None]
    x = np.linspace(-1.0, 1.0, mh)[None, :]
    r2 = (y * y + x * x) / 2.0
    base = 0.8 + 0.45 * r2
    return [(base * s).clip(0.8, 1.25).astype(np.float32).reshape(-1)
            for s in (1.0, 0.98, 1.02, 1.0)]


def gain_map_meta9(meta):
    """`meta` with config 9's GainMaps as its DNG's OpcodeList2 carries
    them (whole frame, one map per RGGB filter, pitch 2, spacing
    1 / (points - 1) from origin 0), for a run that starts from the
    mosaic rather than the DNG."""
    import dataclasses

    from ..core.types import DngGainMap

    mv, mh = DNG9_MAP_POINTS
    maps = tuple(DngGainMap(
        top=dy, left=dx, bottom=meta.height, right=meta.width, plane=0,
        planes=1, row_pitch=2, col_pitch=2, map_points_v=mv,
        map_points_h=mh, map_spacing_v=1.0 / (mv - 1),
        map_spacing_h=1.0 / (mh - 1), map_origin_v=0.0, map_origin_h=0.0,
        map_planes=1, map_gain=tuple(float(g) for g in gains))
        for (dy, dx), gains in zip(((0, 0), (0, 1), (1, 0), (1, 1)),
                                   gain_maps9(mv, mh)))
    return dataclasses.replace(meta, gain_maps=maps)
