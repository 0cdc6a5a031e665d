"""profile_gamma — unbreak an input profile (undo a log or gamma camera
response).

Reference: `ansel/src/iop/profile_gamma.c` (params v2 :78-87, log mode
:212-250, gamma mode :450-487), as `ansel_tpu/ops/profile_gamma.py` has
it: the gamma curve in closed form, with three static branches (an
identity scale, a pure power, a power with a linear toe).  It runs on
camera RGB, before colorin.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.params import cfield, params
from ..kernels.pointwise import OP_PROFILE_GAMMA
from .base import Op, OpPlan, PlanContext, PointwiseSpec, register

MODE_LOG = 0
MODE_GAMMA = 1
NOISE = 2.0 ** -16


@params(op="profile_gamma", version=2)
@dataclasses.dataclass
class ProfileGammaParams:
    mode: int = cfield("i", MODE_LOG)
    linear: float = cfield("f", 0.1)
    gamma: float = cfield("f", 0.45)
    dynamic_range: float = cfield("f", 10.0)
    grey_point: float = cfield("f", 18.0)
    shadows_range: float = cfield("f", -5.0)
    security_factor: float = cfield("f", 0.0)


    @classmethod
    def from_legacy(cls, version, raw):
        import struct

        # profile_gamma.c v1 {linear, gamma} -> mode GAMMA (= 0)
        if version == 1:
            lin, gam = struct.unpack("<2f", raw[:8])
            return cls(mode=0, linear=lin, gamma=gam)
        return None


@register
class ProfileGamma(Op):
    name = "profile_gamma"
    input_colorspace = None  # pre-colorin: camera RGB

    def plan(self, ctx: PlanContext, spec_in, p: ProfileGammaParams) -> OpPlan:
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=(p.mode, p.gamma == 1.0, p.linear == 0.0,
                              p.linear >= 1.0))

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p: ProfileGammaParams):
        if p.mode == MODE_LOG:
            return {
                "grey": np.float32(p.grey_point / 100.0),
                "shadows": np.float32(p.shadows_range),
                "range": np.float32(p.dynamic_range),
            }
        # linear-toe power curve constants (profile_gamma.c:462-470)
        lin, g0 = p.linear, p.gamma
        if g0 == 1.0 or lin >= 1.0:
            a = b = g = 0.0
            cc = 1.0
        elif lin == 0.0:
            a, b, cc, g = 1.0, 0.0, 1.0, g0
        else:
            g = g0 * (1.0 - lin) / (1.0 - g0 * lin)
            a = 1.0 / (1.0 + lin * (g - 1.0))
            b = lin * (g - 1.0) * a
            cc = (a * lin + b) ** g / lin
        return {"a": np.float32(a), "b": np.float32(b),
                "c": np.float32(cc), "g": np.float32(g),
                "linear": np.float32(lin)}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        return _pixel(x, c, plan.static)

    def pointwise_spec(self, plan, ctx):
        static = plan.static
        keys = (("grey", "shadows", "range") if static[0] == MODE_LOG
                else ("a", "b", "c", "g", "linear"))
        return PointwiseSpec(fn=lambda x, c: _pixel(x, c, static),
                             opcode=OP_PROFILE_GAMMA, consts=keys,
                             ints=_branch(static))


def _branch(static):
    """The chain stage's int: 0 log, 1 a scale (gamma 1 or a linear part
    of 1 or more), 2 a pure power (no linear part), 3 power with a toe."""
    mode, gamma_is_1, linear_is_0, linear_ge_1 = static
    if mode == MODE_LOG:
        return (0,)
    if gamma_is_1 or linear_ge_1:
        return (1,)
    return (2,) if linear_is_0 else (3,)


def _pixel(x, c, static):
    (branch,) = _branch(static)
    if branch == 0:
        t = torch.clamp(x / c["grey"], min=NOISE)
        t = (torch.log2(t) - c["shadows"]) / c["range"]
        return torch.clamp(t, min=NOISE)
    if branch == 1:
        return x * c["c"]
    safe = torch.clamp(x, min=0.0)
    if branch == 2:
        return safe ** c["g"]
    toe = c["c"] * x
    power = torch.clamp(c["a"] * safe + c["b"], min=0.0) ** c["g"]
    return torch.where(x < c["linear"], toe, power)
