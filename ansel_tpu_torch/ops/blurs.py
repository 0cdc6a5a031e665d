"""blurs — physically-plausible lens / motion / gaussian blur.

Reference: `ansel/src/iop/blurs.c` — params (:58-73), PSF
synthesis: lens diaphragm polygon (create_lens_kernel :177-208, the
StackExchange polygon-envelope formula), motion path as a rotated
2nd-order polynomial (create_motion_kernel :212-268, 8x oversampled),
gaussian (create_gauss_kernel :271-290); anti-aliased with a small blur
and convolved via FFT (process_fft :403-520, fftw there).

Copied from `ansel_tpu/ops/blurs.py`: the PSF is synthesised on the
host in numpy (params only), and the convolution is the edge-padded
linear FFT product of the JAX package (its XLA FFT) in `torch.fft`,
which is cuFFT on the card.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.params import cfield, params
from ..core.types import Colorspace
from ..pixel.shifts import pad2d
from .base import Op, OpPlan, PlanContext, register

BLUR_LENS = 0
BLUR_MOTION = 1
BLUR_GAUSSIAN = 2


def _lens_kernel(size: int, blades: int, concavity: float, linearity: float,
                 rotation: float) -> np.ndarray:
    eps = 1.0 / size
    radius = (size - 1) / 2.0 - 1.0
    i = np.arange(size)[:, None]
    j = np.arange(size)[None, :]
    x = (i - 1.0) / radius - 1.0
    y = (j - 1.0) / radius - 1.0
    r = np.hypot(x, y)
    k = np.clip(linearity, 0.0, 1.0 - 1e-6)
    n, m = float(blades), float(concavity)
    M = (math.cos((2.0 * math.asin(k) + math.pi * m) / (2.0 * n))
         / np.cos((2.0 * np.arcsin(k * np.cos(n * (np.arctan2(y, x)
                                                   + rotation)))
                   + math.pi * m) / (2.0 * n)))
    return (M >= r + eps).astype(np.float32)


def _motion_kernel(size: int, angle: float, curvature: float,
                   offset: float) -> np.ndarray:
    buf = np.zeros((size, size), np.float32)
    A, B = curvature / 2.0, 1.0
    C = -A * offset * offset + B * offset
    eps = 1.0 / size
    radius = (size - 1) / 2.0 - 1.0
    corr = -math.pi / 4.0 - angle
    ca, sa = math.cos(corr), math.sin(corr)
    t = np.arange(8 * size) / 8.0
    x = (t - 1.0) / radius - 1.0
    X = x - offset
    y = X * X * A + X * B + C
    rx = x * ca + y * (-sa)
    ry = x * sa + y * ca
    for d in (-eps, eps):
        xf = np.round((rx + 1.0) * radius + d).astype(int)
        yf = np.round((ry + 1.0) * radius + d).astype(int)
        ok = (xf > 0) & (xf < size - 1) & (yf > 0) & (yf < size - 1)
        buf[yf[ok], xf[ok]] = 1.0
    return buf


def _gauss_kernel(size: int) -> np.ndarray:
    sigma = (size - 1) / 4.0
    i = np.arange(size) - (size - 1) / 2.0
    g = np.exp(-(i * i) / (2.0 * sigma * sigma))
    return np.outer(g, g).astype(np.float32)


def _antialias(k: np.ndarray) -> np.ndarray:
    # small 3x3 binomial to soften the binary envelope (blurs.c applies a
    # 1px AA blur before the FFT)
    pad = np.pad(k, 1, mode="constant")
    out = sum(w * pad[1 + dy:1 + dy + k.shape[0], 1 + dx:1 + dx + k.shape[1]]
              for dy, wy in ((-1, 1), (0, 2), (1, 1))
              for dx, wx in ((-1, 1), (0, 2), (1, 1))
              for w in (wy * wx / 16.0,))
    return out


@params(op="blurs", version=1)
@dataclasses.dataclass
class BlursParams:
    type: int = cfield("i", BLUR_LENS)
    radius: int = cfield("i", 8)
    blades: int = cfield("i", 5)
    concavity: float = cfield("f", 1.0)
    linearity: float = cfield("f", 1.0)
    rotation: float = cfield("f", 0.0)
    angle: float = cfield("f", 0.0)
    curvature: float = cfield("f", 0.0)
    offset: float = cfield("f", 0.0)


@register
class Blurs(Op):
    name = "blurs"
    input_colorspace = Colorspace.WORK_RGB

    def plan(self, ctx: PlanContext, spec_in, p: BlursParams) -> OpPlan:
        size = 2 * max(int(round(p.radius * ctx.scale)), 2) + 1
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=(p.type, size))

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p: BlursParams):
        _type, size = plan.static
        if _type == BLUR_LENS:
            k = _lens_kernel(size, p.blades, p.concavity, p.linearity,
                             p.rotation)
        elif _type == BLUR_MOTION:
            k = _motion_kernel(size, p.angle, p.curvature, p.offset)
        else:
            k = _gauss_kernel(size)
        k = _antialias(k)
        s = k.sum()
        if s > 0:
            k = k / s
        return {"kernel": k}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        _type, size = plan.static
        k = c["kernel"]
        C, H, W = x.shape
        # linear FFT convolution with edge padding (blurs.c process_fft)
        ph, pw = H + size - 1, W + size - 1
        r = size // 2
        xp = pad2d(x, r, "edge")
        kp = torch.zeros((ph, pw), dtype=x.dtype, device=x.device)
        kp[:size, :size] = k
        # center the PSF so the output is not shifted
        kp = torch.roll(kp, (-r, -r), dims=(0, 1))
        Kf = torch.fft.rfft2(kp)
        Xf = torch.fft.rfft2(xp, dim=(-2, -1))
        del xp
        y = torch.fft.irfft2(Xf * Kf[None], s=(ph, pw), dim=(-2, -1))
        return y[:, r:r + H, r:r + W].to(x.dtype).contiguous()
