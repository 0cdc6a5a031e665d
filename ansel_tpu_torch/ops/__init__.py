"""Image operation modules ported from `ansel_tpu/ops` (see ops/base.py
for the protocol).  Only ported ops are registered."""

from . import (  # noqa: F401
    channelmixerrgb,
    colorin,
    colorout,
    demosaic,
    denoiseprofile,
    exposure,
    filmicrgb,
    highlights,
    rawprepare,
    temperature,
)

from .base import all_ops

ALL_OPS = all_ops()
