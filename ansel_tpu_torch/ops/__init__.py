"""Image operation modules ported from `ansel_tpu/ops` (see ops/base.py
for the protocol).  Only ported ops are registered."""

from . import (  # noqa: F401
    bilat,
    bilateral,
    channelmixerrgb,
    colorin,
    colorout,
    colorreconstruct,
    demosaic,
    denoiseprofile,
    diffuse,
    exposure,
    filmicrgb,
    highlights,
    highpass,
    lens,
    lowpass,
    monochrome,
    rawprepare,
    shadhi,
    sharpen,
    soften,
    temperature,
    toneequal,
)

from .base import all_ops

ALL_OPS = all_ops()
