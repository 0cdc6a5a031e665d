"""Color transforms over planar (3, H, W) float32 tensors.

Torch counterparts of `ansel_tpu/color/transforms.py`.  Ops declare their
working space and the planner inserts conversions only where spaces
change, like the reference (`ansel/src/develop/pixelpipe_cpu.c:54-77`).

Every product is written out in the reference's order
(m0*x0 + m1*x1) + m2*x2, so the plain path and the chain kernel
(`csrc/pointwise_chain.cu`) round the same way.
"""

from __future__ import annotations

import numpy as np
import torch


def apply_matrix(img: torch.Tensor, M) -> torch.Tensor:
    """(3,H,W) x (3,3) channel mix.  M is a (3,3) tensor or a nested
    list of Python floats (host constants, rounded to float32 on use)."""
    rows = []
    for r in range(3):
        acc = None
        for c in range(3):
            term = M[r][c] * img[c]
            acc = term if acc is None else acc + term
        rows.append(acc)
    return torch.stack(rows)


def fdiv(a, b) -> torch.Tensor:
    """a / b as one IEEE float32 division, as the chain kernel divides,
    where a or b is a Python float: on CUDA torch multiplies `t / float`
    by the float's reciprocal and computes `float / t` as the float
    times `reciprocal(t)`, which round otherwise by an ulp, and a long
    chain carries that ulp into its display output."""
    if not isinstance(a, torch.Tensor):
        a = torch.full((), a, dtype=b.dtype, device=b.device)
    if not isinstance(b, torch.Tensor):
        b = torch.full((), b, dtype=a.dtype, device=a.device)
    return a / b


def srgb_encode(x: torch.Tensor) -> torch.Tensor:
    """Linear -> sRGB transfer (IEC 61966-2-1)."""
    a = 0.055
    safe = torch.clamp(x, min=1e-9)
    return torch.where(x <= 0.0031308, 12.92 * x,
                       (1 + a) * safe ** (1.0 / 2.4) - a)


def srgb_decode(x: torch.Tensor) -> torch.Tensor:
    """sRGB -> linear transfer (IEC 61966-2-1)."""
    a = 0.055
    safe = torch.clamp(x, min=1e-9)
    return torch.where(x <= 0.04045, fdiv(x, 12.92),
                       fdiv(safe + a, 1 + a) ** 2.4)


def gamma_encode(x: torch.Tensor, g: float) -> torch.Tensor:
    return torch.clamp(x, min=1e-9) ** float(np.float32(1.0 / g))


# --- CIE Lab (pipeline white) -------------------------------------------------

LAB_EPS = 216.0 / 24389.0
LAB_KAPPA = 24389.0 / 27.0


def xyz_to_lab(xyz: torch.Tensor, white_XYZ) -> torch.Tensor:
    w = [float(v) for v in np.asarray(white_XYZ).reshape(-1)]
    r = torch.stack([xyz[i] / w[i] for i in range(3)])
    croot = torch.exp(torch.log(torch.clamp(r, min=1e-12)) * (1.0 / 3.0))
    f = torch.where(r > LAB_EPS, croot, (LAB_KAPPA * r + 16.0) / 116.0)
    L = 116.0 * f[1] - 16.0
    a = 500.0 * (f[0] - f[1])
    b = 200.0 * (f[1] - f[2])
    return torch.stack([L, a, b])


def lab_to_xyz(lab: torch.Tensor, white_XYZ) -> torch.Tensor:
    w = [float(v) for v in np.asarray(white_XYZ).reshape(-1)]
    fy = (lab[0] + 16.0) / 116.0
    fx = fy + lab[1] / 500.0
    fz = fy - lab[2] / 200.0
    f = torch.stack([fx, fy, fz])
    f3 = f * f * f
    r = torch.where(f3 > LAB_EPS, f3, (116.0 * f - 16.0) / LAB_KAPPA)
    return torch.stack([r[i] * w[i] for i in range(3)])
