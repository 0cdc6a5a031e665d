"""The bench configurations the port runs (`bench.py:CONFIGS`), and the
port's own configs 7-12, defined once for the chip smoke, the profile
script and the tests.

Each history is a tuple of (op, params) pairs, so that a test can build
the JAX package's `HistoryItem`s from the same pairs as the port's.
"""

from __future__ import annotations

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


# each config's frame (height, width)
FRAMES = {1: (BENCH_H, BENCH_W), 2: (BENCH_H, BENCH_W),
          3: (BENCH3_H, BENCH3_W), 4: (BENCH4_H, BENCH4_W),
          7: (BENCH_H, BENCH_W), 8: (BENCH_H, BENCH_W),
          9: (BENCH_H, BENCH_W), 10: (BENCH_H, BENCH_W),
          11: (BENCH_H, BENCH_W), 12: (BENCH_H, BENCH_W)}
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
    with its own params dict (the port's `HistoryItem` by default)."""
    if item_cls is None:
        from ..pipeline.engine import HistoryItem as item_cls
    return [item_cls(op, dict(p)) for op, p in HISTORIES[config]]


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
