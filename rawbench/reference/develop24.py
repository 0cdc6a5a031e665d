"""Bench config 1, the default scene-referred develop: the raw side,
exposure, the input profile, colour calibration, filmic rgb (AgX) and
the sRGB output profile, in ansel's pipe order."""

from __future__ import annotations

from . import colour, raw


def stages(cfg):
    hist = {op: p for op, p in cfg["history"]}
    cam = cfg["camera"]
    return raw.raw_side(cam, hist) + [
        ("exposure", lambda x: colour.exposure(x, hist["exposure"])),
        ("colorin", lambda x: colour.colorin(x, cam["cam_to_xyz"])),
        ("channelmixerrgb",
         lambda x: colour.channelmixerrgb(x, hist["channelmixerrgb"])),
        ("filmicrgb", lambda x: colour.filmic_agx(x, hist["filmicrgb"])),
        ("colorout", colour.colorout_srgb),
    ]
