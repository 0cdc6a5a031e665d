"""Image operation modules ported from `ansel_tpu/ops` (see ops/base.py
for the protocol).  Only ported ops are registered."""

from . import (  # noqa: F401
    bilat,
    bilateral,
    bloom,
    cacorrect,
    cacorrectrgb,
    channelmixerrgb,
    clipping,
    colorin,
    colorout,
    colorreconstruct,
    crop,
    defringe,
    demosaic,
    denoiseprofile,
    diffuse,
    exposure,
    filmicrgb,
    finalscale,
    flip,
    highlights,
    highpass,
    hotpixels,
    initialscale,
    lens,
    lowpass,
    monochrome,
    nlmeans,
    rawdenoise,
    rawprepare,
    restorescans,
    rotatepixels,
    scalepixels,
    shadhi,
    sharpen,
    soften,
    temperature,
    toneequal,
)

from .base import all_ops

ALL_OPS = all_ops()
