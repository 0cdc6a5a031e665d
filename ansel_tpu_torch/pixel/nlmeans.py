"""Non-local means denoising core (`ansel_tpu/pixel/nlmeans.py`; reference
`src/pixel/nlmeans_core.c`): a patch-SSD weighted average over a
(2K+1)^2 search lattice, optionally scattered (nlmeans_core.c:95-110) or
decimated, with the iop or the denoiseprofile weighting.

Every call goes to the NLM kernel's wrapper (`kernels/nlm.py`): the CUDA
kernel on the device, its plain twin on the CPU; both compute what the
TPU's Pallas kernel computes.
"""

from __future__ import annotations

import math

from ..kernels import nlm as nlm_kernel


def _scatter(scale: float, scattering: float, i1: int, i2: int):
    """reference scatter() (nlmeans_core.c:94-103): |i1|^3 lattice
    spreading, the scale factor multiplying the WHOLE expression
    (including the base offset), C int truncation."""
    if scattering <= 0.0 and scale == 1.0:
        return i1, i2

    def s(a, b):
        aa, ab = abs(a), abs(b)
        sg = (a > 0) - (a < 0)
        return int(scale * ((aa * aa * aa + 7.0 * aa * math.sqrt(ab))
                            * sg * scattering / 6.0 + a))

    return s(i1, i2), s(i2, i1)


def search_offsets(search_radius: int, scattering: float = 0.0,
                   scale: float = 1.0, decimate: bool = False):
    """The lattice in the reference's order; `decimate` skips every other
    patch (the fast-preview mode, nlmeans.c:440)."""
    offsets = []
    dec = 1 if decimate else 0
    for dy in range(-search_radius, search_radius + 1):
        for dx in range(-search_radius, search_radius + 1):
            if dec:
                dec += 1
                if dec & 1:
                    continue
            offsets.append(_scatter(scale, scattering, dy, dx))
    return offsets


def nlmeans(img, patch_radius: int, search_radius: int, sharpness, norm,
            center_weight: float = -1.0, scattering: float = 0.0,
            scale: float = 1.0, decimate: bool = False):
    """(3, H, W) -> (3, H, W) weighted patch average (not yet blended with
    the input; callers blend).  center_weight < 0 selects the iop
    weighting, >= 0 the denoiseprofile one."""
    offsets = search_offsets(search_radius, scattering, scale, decimate)
    img = img.contiguous()
    if center_weight >= 0.0:
        n = 2 * patch_radius + 1
        return nlm_kernel.nlm(img, offsets, patch_radius, norm, sharpness,
                              center_weight * n * n,
                              1.0 / (1.0 + center_weight), 1)
    return nlm_kernel.nlm(img, offsets, patch_radius, norm, sharpness, 0.0,
                          1.0, 0)
