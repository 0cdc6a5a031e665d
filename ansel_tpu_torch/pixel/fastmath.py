"""Bit-exact ports of the reference's fast transcendental approximations
(`ansel_tpu/pixel/fastmath.py`; reference `src/math/math.h` dt_fast_expf
:254-267, dt_fast_mexp2f :290-301, fast_mexp2f :306-316).

They define the reference's denoise weights (eaw.c dn_weight :194,
eaw.c weight :35-36, nlmeans_core.c gh :86), so they must match bit for
bit: the float32 products and sums below are single-rounded operations,
`.to(torch.int32)` truncates toward zero and `.view(torch.float32)`
reinterprets the bits.  The CUDA kernels (csrc/eaw.cu, csrc/nlm.cu) write
the same three lines in C, built without FMA contraction.
"""

from __future__ import annotations

import torch

_I1 = 0x3F800000            # bits of 2^0
_I2_HALF = 0x3F000000       # bits of 2^-1
_I2_E = 0x402DF854          # bits of e^1


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def dt_fast_mexp2f(x) -> torch.Tensor:
    """2^-x for 0 < x < 126: k0 = i1 + trunc(x * (i2 - i1)) in integer
    arithmetic, zero below the denormal cut-off."""
    k0 = (_f32(x) * float(_I2_HALF - _I1)).to(torch.int32) + _I1
    return torch.where(k0 >= 0x800000, k0, 0).view(torch.float32)


def fast_mexp2f(x) -> torch.Tensor:
    """2^-x, the reduced-precision variant whose sum i1 + x * (i2 - i1)
    is taken in float32 (ulp 64 near 1.07e9); nlmeans.c and
    denoiseprofile.c weigh with it."""
    k0f = float(_I1) + _f32(x) * float(_I2_HALF - _I1)
    k = torch.where(k0f >= float(0x800000), k0f.to(torch.int32), 0)
    return k.view(torch.float32)


def dt_fast_expf(x) -> torch.Tensor:
    """e^x for x in [-100, 0]."""
    k0 = (float(_I1) + _f32(x) * float(_I2_E - _I1)).to(torch.int32)
    return torch.where(k0 > 0, k0, 0).view(torch.float32)
