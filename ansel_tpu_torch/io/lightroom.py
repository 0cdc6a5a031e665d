"""Lightroom XMP import: map `crs:` develop settings to native ops
(`ansel_tpu/io/lightroom.py`, copied: ElementTree, no JAX).

Reference: `ansel/src/develop/lightroom.c` (:473-700 attribute
parse, :257-344 lr2dt interpolation tables, :1240-1500 op synthesis:
clipping from the rotated crop box, flip from Orientation, exposure from
Exposure2012/Blacks2012, grain, post-crop vignette, tone curve from
ToneCurvePV2012 + the parametric zone sliders, colorzones from the 8
HSL adjustment channels, splittoning, plus rating/labels/tags/GPS).
"""

from __future__ import annotations

import dataclasses
import math
import re
import xml.etree.ElementTree as etree
from typing import Dict, List, Optional

NS_CRS = "http://ns.adobe.com/camera-raw-settings/1.0/"
NS_RDF = "http://www.w3.org/1999/02/22-rdf-syntax-ns#"
NS_XMP = "http://ns.adobe.com/xap/1.0/"
NS_DC = "http://purl.org/dc/elements/1.1/"


@dataclasses.dataclass
class LightroomImport:
    history: List = dataclasses.field(default_factory=list)
    rating: Optional[int] = None
    color_label: Optional[str] = None
    tags: List[str] = dataclasses.field(default_factory=list)


def _interp(table, value):
    ks = sorted(table)
    k = 0
    while k + 1 < len(ks) - 1 and ks[k + 1] < value:
        k += 1
    a, b = ks[k], ks[k + 1]
    return table[a] + (value - a) / (b - a) * (table[b] - table[a])


def _blacks(v):
    return _interp({-100: 0.020, -50: 0.005, 0: 0.0, 50: -0.005,
                    100: -0.010}, v)


def _vignette_gain(v):
    return _interp({-100: -1.0, -50: -0.7, 0: 0.0, 50: 0.5, 100: 1.0}, v)


def _vignette_midpoint(v):
    return _interp({0: 74.0, 4: 75.0, 25: 85.0, 50: 100.0, 100: 100.0}, v)


def _grain_amount(v):
    return _interp({0: 0.0, 25: 20.0, 50: 40.0, 100: 80.0}, v)


def _grain_frequency(v):
    return _interp({0: 100.0, 50: 100.0, 75: 400.0, 100: 800.0}, v) / 53.3


def _split_balance(v):
    return _interp({-100: 100.0, 0: 0.0, 100: 0.0}, v)


_FLIP = {  # EXIF orientation -> flip op code (dt flip bits)
    1: 0, 2: 1, 3: 3, 4: 2, 5: 4, 6: 6, 7: 7, 8: 5,
}


def _collect_attrs(root) -> Dict[str, str]:
    out = {}
    for desc in root.iter(f"{{{NS_RDF}}}Description"):
        for key, val in desc.attrib.items():
            if key.startswith(f"{{{NS_CRS}}}"):
                out[key.split("}")[1]] = val
            elif key.startswith(f"{{{NS_XMP}}}"):
                out["xmp:" + key.split("}")[1]] = val
        # element-form properties
        for child in desc:
            if child.tag.startswith(f"{{{NS_CRS}}}"):
                name = child.tag.split("}")[1]
                seq = child.find(f"{{{NS_RDF}}}Seq")
                if seq is not None:
                    out[name] = [li.text for li in
                                 seq.findall(f"{{{NS_RDF}}}li")]
                elif child.text and child.text.strip():
                    out[name] = child.text.strip()
    return out


def is_lightroom_xmp(text: str) -> bool:
    return "camera-raw-settings" in text and \
        "darktable:history" not in text


def parse_lightroom_xmp(path_or_text: str) -> LightroomImport:
    """LR sidecar -> native history items + library metadata."""
    from ..pipeline.engine import HistoryItem

    if "<" in path_or_text:
        text = path_or_text
    else:
        with open(path_or_text, "r", encoding="utf-8",
                  errors="replace") as f:
            text = f.read()
    root = etree.fromstring(text)
    a = _collect_attrs(root)
    out = LightroomImport()

    def f(name, default=0.0):
        try:
            return float(str(a.get(name, default)).replace("+", ""))
        except (TypeError, ValueError):
            return default

    # --- exposure (lightroom.c:499-516) ---
    exposure = f("Exposure2012")
    blacks = f("Blacks2012")
    if exposure != 0.0 or blacks != 0.0:
        out.history.append(HistoryItem("exposure", {
            "exposure": exposure, "black": _blacks(blacks)}))

    # --- crop + rotate -> clipping (lightroom.c:1247-1311) ---
    if str(a.get("HasCrop", "")).lower() == "true":
        iw, ih = f("ImageWidth", 1.0), f("ImageLength", 1.0)
        cx0 = (f("CropLeft") - 0.5) * iw
        cw0 = (f("CropRight") - 0.5) * iw
        cy0 = (f("CropTop") - 0.5) * ih
        ch0 = (f("CropBottom") - 0.5) * ih
        angle = f("CropAngle")
        ra = math.radians(angle)

        def rot(x, y, r):
            return (x * math.cos(r) + y * math.sin(r),
                    -x * math.sin(r) + y * math.cos(r))

        cx0, cy0 = rot(cx0, cy0, -ra)
        cw0, ch0 = rot(cw0, ch0, -ra)
        fa = abs(ra)
        new_w = iw * math.cos(fa) + ih * math.sin(fa)
        new_h = iw * math.sin(fa) + ih * math.cos(fa)
        out.history.append(HistoryItem("clipping", {
            "angle": angle,
            "cx": round(cx0 / new_w + 0.5, 5),
            "cw": round(cw0 / new_w + 0.5, 5),
            "cy": round(cy0 / new_h + 0.5, 5),
            "ch": round(ch0 / new_h + 0.5, 5),
            "crop_auto": 0}))

    # --- orientation -> flip ---
    orient = int(f("Orientation", 1))
    if orient in _FLIP and orient != 1:
        out.history.append(HistoryItem("flip",
                                       {"orientation": _FLIP[orient]}))

    # --- grain ---
    ga = f("GrainAmount")
    if ga:
        out.history.append(HistoryItem("grain", {
            "strength": _grain_amount(ga),
            "scale": _grain_frequency(f("GrainFrequency", 50.0))}))

    # --- post-crop vignette ---
    va = f("PostCropVignetteAmount")
    if va:
        style = int(f("PostCropVignetteStyle", 0))
        out.history.append(HistoryItem("vignette", {
            "brightness": _vignette_gain(va),
            "scale": _vignette_midpoint(f("PostCropVignetteMidpoint")),
            "falloff_scale": f("PostCropVignetteFeather", 50.0),
            "saturation": -0.3 if style == 1 else -0.2}))

    # --- tone curve (lightroom.c:1393-1459) ---
    curve_name = a.get("ToneCurveName2012", "Linear")
    pts = a.get("ToneCurvePV2012") or []
    ptc_vals = [f("ParametricShadows"), f("ParametricDarks"),
                f("ParametricLights"), f("ParametricHighlights")]
    splits = [f("ParametricShadowSplit", 0.25),
              f("ParametricMidtoneSplit", 0.5),
              f("ParametricHighlightSplit", 0.75)]
    custom = curve_name == "Custom" and pts
    if custom or any(v != 0 for v in ptc_vals):
        if custom:
            nodes = []
            for li in pts:
                m = re.match(r"\s*(-?\d+)\s*,\s*(-?\d+)", li or "")
                if m:
                    nodes.append((int(m.group(1)) / 255.0,
                                  int(m.group(2)) / 255.0))
        else:
            xs = [0.0, splits[0] / 2.0,
                  splits[1] - (splits[1] - splits[0]) / 2.0,
                  splits[1] + (splits[2] - splits[1]) / 2.0,
                  splits[2] + (1.0 - splits[2]) / 2.0, 1.0]
            ys = list(xs)
            for i in range(4):
                ys[i + 1] += ys[i + 1] * ptc_vals[i] / 100.0
            ys[1] = min(ys[1], ys[2])
            ys[4] = max(ys[4], ys[3])
            nodes = list(zip(xs, ys))
        from ..ops.tonecurve import MAXNODES

        flat = [0.0] * (3 * MAXNODES * 2)
        for i, (x, y) in enumerate(nodes[:MAXNODES]):
            flat[2 * i] = x
            flat[2 * i + 1] = y
        lin_ab = [0.0, 0.08, 0.3, 0.5, 0.7, 0.92, 1.0]
        for ch in (1, 2):
            base = ch * MAXNODES * 2
            for k, v in enumerate(lin_ab):
                flat[base + 2 * k] = v
                flat[base + 2 * k + 1] = v
        out.history.append(HistoryItem("tonecurve", {
            "tonecurve": tuple(flat),
            "tonecurve_nodes": (min(len(nodes), MAXNODES), 7, 7),
            "tonecurve_type": (0, 0, 0),  # CUBIC_SPLINE
            "tonecurve_autoscale_ab": 1}))

    # --- HSL adjustments -> colorzones (8 LR channels over hue) ---
    lr_channels = ("Red", "Orange", "Yellow", "Green", "Aqua", "Blue",
                   "Purple", "Magenta")
    hsl = {}
    for kind in ("Luminance", "Saturation", "Hue"):
        vals = [f(f"{kind}Adjustment{ch}") for ch in lr_channels]
        if any(vals):
            hsl[kind] = vals
    if hsl:
        from ..ops.colorzones import MAXNODES as CZ_MAX

        flat = []
        nodes_per = 8
        for kind in ("Luminance", "Saturation", "Hue"):
            vals = hsl.get(kind, [0.0] * 8)
            chan = [0.0] * (CZ_MAX * 2)
            for k in range(nodes_per):
                chan[2 * k] = k / (nodes_per - 1.0)
                chan[2 * k + 1] = 0.5 + (vals[k] / 100.0) * 0.5
            flat.extend(chan)
        out.history.append(HistoryItem("colorzones", {
            "channel": 2,  # select by hue
            "curve": tuple(flat),
            "curve_num_nodes": (nodes_per,) * 3,
            "curve_type": (1, 1, 1)}))

    # --- split toning ---
    if any(f(n) for n in ("SplitToningShadowSaturation",
                          "SplitToningHighlightSaturation")):
        out.history.append(HistoryItem("splittoning", {
            "shadow_hue": f("SplitToningShadowHue") / 360.0,
            "shadow_saturation": f("SplitToningShadowSaturation") / 100.0,
            "highlight_hue": f("SplitToningHighlightHue") / 360.0,
            "highlight_saturation":
                f("SplitToningHighlightSaturation") / 100.0,
            "balance": _split_balance(f("SplitToningBalance")) / 100.0,
            "compress": 50.0}))

    # --- library metadata ---
    if "xmp:Rating" in a:
        out.rating = int(float(a["xmp:Rating"]))
    if "xmp:Label" in a:
        out.color_label = a["xmp:Label"]
    for subj in root.iter(f"{{{NS_DC}}}subject"):
        for li in subj.iter(f"{{{NS_RDF}}}li"):
            if li.text:
                out.tags.append(li.text)
    return out
