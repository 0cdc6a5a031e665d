"""Synthetic raw generation — the fixture analog of the reference's
`tests/unittests/util/testimg.c` (gradients / grey ramps) extended to full
mosaic synthesis: render a known linear scene, apply camera matrix inverse,
inverse-WB, mosaic through the CFA, add black level + optional noise.
Lets every pipeline stage be validated against a known ground truth without
camera files (deterministic, seeded — testimg design rules,
tests/unittests/README.md:46-53).
"""

from __future__ import annotations

import numpy as np

from ..color import matrices as cm
from ..core.types import CFAPattern, RawMeta

# A plausible camera: slightly crossed channels, D65-normalized
DEFAULT_CAM_TO_XYZ = np.array(
    [
        [0.45, 0.35, 0.15],
        [0.20, 0.70, 0.10],
        [0.05, 0.25, 0.75],
    ]
)


def render_scene(h: int, w: int, kind: str = "gradients", seed: int = 7) -> np.ndarray:
    """(3, h, w) linear scene-referred RGB in [0, ~2] (work profile)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    if kind == "grey_ramp":
        g = np.exp2(xx * 10.0 - 8.0)  # -8EV .. +2EV around grey
        img = np.stack([g, g, g])
    elif kind == "noise":
        img = rng.gamma(2.0, 0.09, size=(3, h, w))
    else:  # gradients + color wheel + highlights
        r = 0.18 * np.exp2(4.0 * (xx - 0.5))
        g = 0.18 * np.exp2(4.0 * (yy - 0.5))
        b = 0.18 * np.exp2(2.0 * np.sin(xx * 9.3) * np.cos(yy * 7.1))
        img = np.stack([r, g, b])
        # a specular patch to exercise highlight handling
        img[:, : h // 8, : w // 8] = 8.0
    return img.astype(np.float32)


def synth_raw(
    h: int = 512,
    w: int = 768,
    cfa: CFAPattern = CFAPattern.RGGB,
    kind: str = "gradients",
    seed: int = 7,
    black: float = 256.0,
    white: float = 16383.0,
    wb=(2.0, 1.0, 1.6, 1.0),
    noise_sigma: float = 0.0,
):
    """-> (raw_uint16_as_float (h,w), RawMeta, scene_work_rgb (3,h,w))."""
    scene_work = render_scene(h, w, kind, seed)
    # work RGB -> camera RGB: invert the colorin transform
    cam_from_work = np.linalg.inv(cm.normalized_cam_to_work(DEFAULT_CAM_TO_XYZ))
    cam = np.einsum("dc,chw->dhw", cam_from_work, scene_work)
    # inverse white balance: divide by wb coeffs
    inv_wb = np.array([1.0 / wb[0], 1.0 / wb[1], 1.0 / wb[2]]).reshape(3, 1, 1)
    cam = cam * inv_wb
    # mosaic
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    color = np.zeros((h, w), np.int32)
    for y in range(2):
        for x in range(2):
            color[(ys % 2 == y) & (xs % 2 == x)] = cfa.color_at(y, x)
    mosaic = np.take_along_axis(
        cam, color[None].astype(np.int64), axis=0
    )[0]
    # sensor units
    raw = np.clip(mosaic, 0.0, None) * (white - black) + black
    if noise_sigma > 0:
        rng = np.random.default_rng(seed + 1)
        raw = raw + rng.normal(0.0, noise_sigma, raw.shape)
    raw = np.clip(raw, 0.0, 65535.0).astype(np.float32)
    meta = RawMeta(
        width=w, height=h, cfa=cfa,
        black_levels=(black,) * 4, white_point=white,
        wb_coeffs=tuple(wb),
        cam_to_xyz=tuple(DEFAULT_CAM_TO_XYZ.reshape(-1)),
        maker="synthetic", model="testimg",
    )
    return raw, meta, scene_work
