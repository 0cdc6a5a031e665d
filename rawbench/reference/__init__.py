"""The plain reference of each configuration: `reference/<config>.py`
gives `stages(cfg)`, the pipe as (name, fn) stages in the program's
order, each a plain torch function of its own parameters; `run` drives
them over a padded mosaic and crops the display image.

It imports nothing of the program under test: every coefficient is
worked out again here from the configuration's history and camera.
"""

from __future__ import annotations

import importlib

import torch


def stages(config: str, cfg: dict):
    return importlib.import_module(f"{__name__}.{config}").stages(cfg)


@torch.no_grad()
def run(config: str, cfg: dict, mosaic: torch.Tensor, round_to=None):
    """(pad_h, pad_w) float32 mosaic -> (3, height, width) display RGB.
    `round_to` (a torch dtype) rounds the image to that type after every
    stage, as a program that kept its intermediate images in it would."""
    x = mosaic
    for _, fn in stages(config, cfg):
        x = fn(x)
        if round_to is not None:
            x = x.to(round_to).to(torch.float32)
    h, w = cfg["frame"]["height"], cfg["frame"]["width"]
    return x[:, :h, :w]
