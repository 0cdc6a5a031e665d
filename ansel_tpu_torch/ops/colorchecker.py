"""colorchecker — a Lab colour LUT by thin-plate-spline patch mapping.

Reference: `ansel/src/iop/colorchecker.c` (params v2 :109-118, up to 49
source -> target Lab patches; the kernel phi = r^2 log r^2 :472-483; the
bordered system [R P; P^T 0] :598-700; process :487-530), as
`ansel_tpu/ops/colorchecker.py` has it: the host solves the (N + 4)^2
system in float64, the pixel path is the affine part plus N distance
terms.  Up to 12 patches it is a chain stage (the patch loop a run-time
bound in the kernel); above 12 the JAX package runs it alone, and so
does the port (`pointwise_spec` None: the engine runs `apply`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.params import cfield, params
from ..core.types import Colorspace
from ..kernels.pointwise import OP_COLORCHECKER
from .base import Op, OpPlan, PlanContext, PointwiseSpec, register

MAX_PATCHES = 49
# the largest patch count that runs inside a chain, as the JAX package
# fuses it
CHAIN_PATCHES = 12


@params(op="colorchecker", version=2)
@dataclasses.dataclass
class ColorCheckerParams:
    source_L: tuple = cfield(f"{MAX_PATCHES}f", (0.0,) * MAX_PATCHES)
    source_a: tuple = cfield(f"{MAX_PATCHES}f", (0.0,) * MAX_PATCHES)
    source_b: tuple = cfield(f"{MAX_PATCHES}f", (0.0,) * MAX_PATCHES)
    target_L: tuple = cfield(f"{MAX_PATCHES}f", (0.0,) * MAX_PATCHES)
    target_a: tuple = cfield(f"{MAX_PATCHES}f", (0.0,) * MAX_PATCHES)
    target_b: tuple = cfield(f"{MAX_PATCHES}f", (0.0,) * MAX_PATCHES)
    num_patches: int = cfield("i", 0)


    # classic 24-patch targets of the v1 module (colorchecker.c:122-156)
    V1_SOURCE = (
        (39.19, 13.76, 14.29), (65.18, 19.00, 17.32),
        (49.46, -4.23, -22.95), (42.85, -13.33, 22.12),
        (55.18, 9.44, -24.94), (70.36, -32.77, -0.04),
        (62.92, 35.49, 57.10), (40.75, 11.41, -46.03),
        (52.10, 48.11, 16.89), (30.67, 21.19, -20.81),
        (73.08, -23.55, 56.97), (72.43, 17.48, 68.20),
        (30.97, 12.67, -46.30), (56.43, -40.66, 31.94),
        (43.40, 50.68, 28.84), (82.45, 2.41, 80.25),
        (51.98, 50.68, -14.84), (51.02, -27.63, -28.03),
        (95.97, -0.40, 1.24), (81.10, -0.83, -0.43),
        (66.81, -1.08, -0.70), (50.98, -0.19, -0.30),
        (35.72, -0.69, -1.11), (21.46, 0.06, -0.95))

    @classmethod
    def from_legacy(cls, version, raw):
        import struct

        # colorchecker.c v1 {target_L/a/b[24]} with the fixed v1 source
        if version == 1:
            v = struct.unpack("<72f", raw[:288])
            pad = (0.0,) * (MAX_PATCHES - 24)
            return cls(
                source_L=tuple(p[0] for p in cls.V1_SOURCE) + pad,
                source_a=tuple(p[1] for p in cls.V1_SOURCE) + pad,
                source_b=tuple(p[2] for p in cls.V1_SOURCE) + pad,
                target_L=tuple(v[0:24]) + pad,
                target_a=tuple(v[24:48]) + pad,
                target_b=tuple(v[48:72]) + pad,
                num_patches=24)
        return None


def _phi(r2):
    return r2 * np.log(np.maximum(r2, 1e-8))


def _solve(src: np.ndarray, tgt: np.ndarray) -> np.ndarray:
    """src (N,3), tgt (N,) -> coeffs (N+4,): [c_0..c_{N-1}, d0, dL, da, db]."""
    N = src.shape[0]
    if N == 0:
        return np.zeros(4)
    P = np.concatenate([np.ones((N, 1)), src], axis=1)  # (N, 4)
    if N < 4:
        # degenerate: affine-only least squares (colorchecker.c N<=4 cases)
        d, *_ = np.linalg.lstsq(P, tgt, rcond=None)
        return np.concatenate([np.zeros(N), d])
    r2 = ((src[:, None, :] - src[None, :, :]) ** 2).sum(-1)
    R = _phi(r2)
    A = np.zeros((N + 4, N + 4))
    A[:N, :N] = R + 1e-9 * np.eye(N)
    A[:N, N:] = P
    A[N:, :N] = P.T
    f = np.concatenate([tgt, np.zeros(4)])
    try:
        cd = np.linalg.solve(A, f)
    except np.linalg.LinAlgError:
        cd, *_ = np.linalg.lstsq(A, f, rcond=None)
    return cd


@register
class ColorChecker(Op):
    name = "colorchecker"
    input_colorspace = Colorspace.LAB

    def plan(self, ctx: PlanContext, spec_in, p: ColorCheckerParams) -> OpPlan:
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=(max(0, min(int(p.num_patches), MAX_PATCHES)),))

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p: ColorCheckerParams):
        (N,) = plan.static
        src = np.stack([np.asarray(p.source_L[:N]),
                        np.asarray(p.source_a[:N]),
                        np.asarray(p.source_b[:N])], axis=1).astype(np.float64)
        out = {}
        for name, tgt in (("L", p.target_L), ("a", p.target_a),
                          ("b", p.target_b)):
            out[f"coeff_{name}"] = _solve(
                src, np.asarray(tgt[:N], np.float64)).astype(np.float32)
        out["src"] = src.reshape(-1).astype(np.float32)
        return out

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        (N,) = plan.static
        if N == 0:
            return x
        return _pixel(x, c, N)

    def pointwise_spec(self, plan, ctx):
        (N,) = plan.static
        if N == 0 or N > CHAIN_PATCHES:
            return None
        return PointwiseSpec(fn=lambda x, c: _pixel(x, c, N),
                             opcode=OP_COLORCHECKER,
                             consts=("coeff_L", "coeff_a", "coeff_b", "src"),
                             ints=(N,))


def _pixel(x, c, N):
    cl, ca, cb = c["coeff_L"], c["coeff_a"], c["coeff_b"]
    src = c["src"]
    out = [cl[N] + cl[N + 1] * x[0] + cl[N + 2] * x[1] + cl[N + 3] * x[2],
           ca[N] + ca[N + 1] * x[0] + ca[N + 2] * x[1] + ca[N + 3] * x[2],
           cb[N] + cb[N + 1] * x[0] + cb[N + 2] * x[1] + cb[N + 3] * x[2]]
    for k in range(N):
        d0 = x[0] - src[3 * k]
        d1 = x[1] - src[3 * k + 1]
        d2 = x[2] - src[3 * k + 2]
        r2 = d0 * d0 + d1 * d1 + d2 * d2
        phi = r2 * torch.log(torch.clamp(r2, min=1e-8))
        out = [o + cc[k] * phi for o, cc in zip(out, (cl, ca, cb))]
    return torch.stack(out)
