"""The warps whose map has static coefficients: clipping's and ashift's.

In the JAX package `warp_static` (`ansel_tpu/ops/_warpcommon.py`) probes
the map on the host and runs the two-pass Pallas warp on the TPU, with
the global translation peeled off as an integer source offset, or a
direct gather elsewhere.  A GPU gathers directly, so the port keeps only
the direct form: the map's float32 constants go to the warp kernel
(`kernels/warp.py`), which evaluates the map per output pixel, samples
bilinearly and zeroes the pixels whose source falls outside the frame.
A CPU tensor runs the kernel's plain twin.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import warp


def _consts(consts: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(consts, np.float32))


def warp_static(x: torch.Tensor, consts: np.ndarray, k_apply: int, oh: int,
                ow: int) -> torch.Tensor:
    """(C, H, W) -> (C, oh, ow): `x` sampled at clipping's inverse map,
    `consts` its float32 constants (`ops/clipping.clip_map`)."""
    return warp.clip_warp(x, _consts(consts), k_apply, oh, ow)


def warp_homography(x: torch.Tensor, consts: np.ndarray) -> torch.Tensor:
    """(C, H, W) -> (C, H, W): `x` sampled at ashift's inverse homography,
    `consts` its nine float32 entries (`ops/ashift.homography_consts`)."""
    return warp.homography_warp(x, _consts(consts))
