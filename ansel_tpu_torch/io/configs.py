"""The bench configurations the port runs (`bench.py:CONFIGS`), and the
port's own configs 7, 8, 9 and 10, defined once for the chip smoke, the
profile script and the tests.

Each history is a tuple of (op, params) pairs, so that a test can build
the JAX package's `HistoryItem`s from the same pairs as the port's.
"""

from __future__ import annotations

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
    """One op of GRADING_CASES as a one-stage chain for a (3, H, W) array
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


# each config's frame (height, width)
FRAMES = {1: (BENCH_H, BENCH_W), 2: (BENCH_H, BENCH_W),
          3: (BENCH3_H, BENCH3_W), 4: (BENCH4_H, BENCH4_W),
          7: (BENCH_H, BENCH_W), 8: (BENCH_H, BENCH_W),
          9: (BENCH_H, BENCH_W), 10: (BENCH_H, BENCH_W)}
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
