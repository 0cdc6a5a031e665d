"""The benchmark's inputs: raw mosaics made on the device from a seed.

A torch rewrite of the synthetic scene of `ansel_tpu_torch/io/synthetic`
(gradients, a colour wheel and a specular patch in the working space,
taken to camera RGB through the inverse input profile and the inverse
white balance, mosaicked through the CFA, in sensor units), made on the
device in a few large calls and varied per image: every image draws its
slopes, frequencies, the patch's place, a fine grating and the read
noise from the seed.  Every image has the configuration's frame, so
every seed gives the same work.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .reference import colormath, raw


def _draws(seed: int, k: int):
    rng = np.random.default_rng([seed % 2**64, k])
    u = rng.uniform
    return {
        "ar": u(3.0, 5.0), "ag": u(3.0, 5.0), "ab": u(1.5, 2.5),
        "cx": u(0.4, 0.6), "cy": u(0.4, 0.6),
        "fx": u(7.0, 12.0), "fy": u(5.0, 9.0),
        "px": u(0.0, 2 * math.pi), "py": u(0.0, 2 * math.pi),
        "patch": (u(0.0, 7 / 8), u(0.0, 7 / 8)),
        "period": u(3.0, 24.0), "angle": u(0.0, math.pi),
        "noise": u(2.0, 6.0),
        "torch_seed": int(rng.integers(2**62)),
    }


@torch.no_grad()
def mosaic(cfg: dict, seed: int, k: int, device) -> torch.Tensor:
    """Image `k` of the roll of `seed`: a (pad_height, pad_width) float32
    mosaic in sensor units, edge-padded past the frame as the program's
    `run_padded` takes it."""
    fr, cam = cfg["frame"], cfg["camera"]
    h, w = fr["height"], fr["width"]
    d = _draws(seed, k)
    gen = torch.Generator(device=device)
    gen.manual_seed(d["torch_seed"])
    yy = torch.linspace(0.0, 1.0, h, device=device)[:, None]
    xx = torch.linspace(0.0, 1.0, w, device=device)[None, :]
    r = 0.18 * torch.exp2(d["ar"] * (xx - d["cx"])).expand(h, w)
    g = 0.18 * torch.exp2(d["ag"] * (yy - d["cy"])).expand(h, w)
    b = 0.18 * torch.exp2(d["ab"] * torch.sin(xx * d["fx"] + d["px"])
                          * torch.cos(yy * d["fy"] + d["py"]))
    scene = torch.stack([r, g, b])
    # a fine grating over the frame, 20% deep
    ca, sa = math.cos(d["angle"]), math.sin(d["angle"])
    phase = (ca * torch.arange(w, device=device)[None, :]
             + sa * torch.arange(h, device=device)[:, None])
    scene = scene * (1.0 + 0.2 * torch.sin(phase * (2 * math.pi
                                                   / d["period"])))[None]
    # a specular patch an eighth of the frame, past the white level
    y0, x0 = int(d["patch"][0] * h), int(d["patch"][1] * w)
    scene[:, y0:y0 + h // 8, x0:x0 + w // 8] = 8.0

    cam_from_work = np.linalg.inv(colormath.cam_to_work(cam["cam_to_xyz"]))
    wb = [float(v) for v in cam["wb"][:3]]
    m = (cam_from_work / np.array(wb)[:, None]).astype(np.float32).tolist()
    colour = raw.cfa_plane(raw.site_colours(cam["cfa"]), h, w, device)
    out = torch.zeros((h, w), device=device)
    for c in range(3):
        row = m[c][0] * scene[0] + m[c][1] * scene[1] + m[c][2] * scene[2]
        out = torch.where(colour == c, row, out)
    black, white = float(cam["black"]), float(cam["white"])
    out = torch.clamp(out, min=0.0) * (white - black) + black
    out = out + d["noise"] * torch.randn((h, w), generator=gen,
                                         device=device)
    out = torch.clamp(out, 0.0, 65535.0)
    ph, pw = fr["pad_height"], fr["pad_width"]
    return F.pad(out[None, None], (0, pw - w, 0, ph - h),
                 mode="replicate")[0, 0].contiguous()


def roll(cfg: dict, seed: int, n: int, device) -> list:
    """The `n` distinct mosaics of a roll."""
    return [mosaic(cfg, seed, k, device) for k in range(n)]
