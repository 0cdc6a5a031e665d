"""Bench config 3, the heavy iterative stack: the raw side, exposure,
tone equalizer, the input profile, diffuse or sharpen, filmic rgb (AgX),
local contrast in Lab and the sRGB output profile, in ansel's pipe
order."""

from __future__ import annotations

from . import colour, local, raw


def stages(cfg):
    hist = {op: p for op, p in cfg["history"]}
    cam, frame = cfg["camera"], cfg["frame"]
    return raw.raw_side(cam, hist) + [
        ("exposure", lambda x: colour.exposure(x, hist["exposure"])),
        ("toneequal", lambda x: local.toneequal(
            x, hist["toneequal"], frame["width"], frame["height"])),
        ("colorin", lambda x: colour.colorin(x, cam["cam_to_xyz"])),
        ("diffuse", lambda x: local.diffuse(x, hist["diffuse"])),
        ("filmicrgb", lambda x: colour.filmic_agx(x, hist["filmicrgb"])),
        ("to_lab", colour.work_to_lab),
        ("bilat", lambda x: local.bilat(x, hist["bilat"])),
        ("to_work", colour.lab_to_work),
        ("colorout", colour.colorout_srgb),
    ]
