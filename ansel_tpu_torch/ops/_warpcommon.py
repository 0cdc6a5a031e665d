"""The warps whose map has static coefficients (clipping's; ashift's is
the next).

In the JAX package `warp_static` (`ansel_tpu/ops/_warpcommon.py`) probes
the map on the host and runs the two-pass Pallas warp on the TPU, with
the global translation peeled off as an integer source offset, or a
direct gather elsewhere.  A GPU gathers directly, so the port keeps only
the direct form: the map's constants go to the warp kernel
(`kernels/warp.clip_warp`), which evaluates the map per output pixel,
samples bilinearly and zeroes the pixels whose source falls outside the
frame.  A CPU tensor runs the kernel's plain twin.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import warp


def warp_static(x: torch.Tensor, consts: np.ndarray, k_apply: int, oh: int,
                ow: int) -> torch.Tensor:
    """(C, H, W) -> (C, oh, ow): `x` sampled at clipping's inverse map,
    `consts` its float32 constants (`ops/clipping.clip_map`)."""
    k = torch.from_numpy(np.ascontiguousarray(consts, np.float32))
    return warp.clip_warp(x, k, k_apply, oh, ow)
