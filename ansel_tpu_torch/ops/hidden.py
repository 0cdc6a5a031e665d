"""Plumbing modules that appear in real sidecars' histories and whose
work is done elsewhere (`ansel_tpu/ops/hidden.py`).

  * gamma (reference `src/iop/gamma.c`): the display encoding, done here
    by colorout and `io/encode.py`, so the stage is an identity;
  * mask_manager (`src/develop/masks/mask_manager`): carries the drawn
    shapes' group list for the GUI and processes no pixels.

Their params decode, so that replaying a sidecar loses nothing; each
applies as an identity.
"""

from __future__ import annotations

import dataclasses

from ..core.params import cfield, params
from .base import Op, register


@params(op="gamma", version=1)
@dataclasses.dataclass
class GammaParams:
    gamma: float = cfield("f", 1.0)
    linear: float = cfield("f", 1.0)


@register
class Gamma(Op):
    name = "gamma"
    input_colorspace = None

    def enabled_by_default(self, meta):
        return False


@params(op="mask_manager", version=2)
@dataclasses.dataclass
class MaskManagerParams:
    dummy: int = cfield("i", 0)

    @classmethod
    def from_legacy(cls, version, raw):
        return cls()  # every version: 4 opaque bytes, no pixel semantics


@register
class MaskManager(Op):
    name = "mask_manager"
    input_colorspace = None

    def enabled_by_default(self, meta):
        return False
