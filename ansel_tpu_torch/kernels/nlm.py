"""Non-local means over a static offset lattice: the CUDA kernel
(`csrc/nlm.cu`) and its plain twin.

Both compute what `ansel_tpu/kernels/nlm_pallas.py:nlm_pallas` computes on
the TPU (reference `src/pixel/nlmeans_core.c`).  On the edge-padded image
X, for each offset o = (dy, dx):

    d2(q)  = sum_c norm_c * (X_c[q] - X_c[q + o])^2, q on the tile and a
             ring of P, both reads edge-padded
    ssd(p) = the (2P+1)^2 box sum of d2 around p, rows first, then columns
    variant 0 (iop nlmeans, :405):  w = dt_fast_mexp2f(ssd * sharp)
    variant 1 (denoiseprofile, :417-423):
        w = dt_fast_mexp2f(max(0, (ssd + d2(p) * cp_norm) * inv1cw * sharp - 2))
    acc += X[p + o] * w,  wsum += w

and returns acc * (1 / max(wsum, 1e-12)).  The JAX package's XLA path
instead edge-pads the d2 plane itself, so it differs from this on a ring
P px wide.  The offsets are summed in the order given; the Pallas kernel
groups them by dx, which changes the last bits of the sums only.

`nlm` launches the kernel for a CUDA tensor and runs `nlm_reference` for
a CPU tensor.  On the card it takes every lattice the planners emit: a
patch radius up to MAX_P with at most MAX_OFFSETS offsets is one launch;
more offsets run as chunks of at most MAX_OFFSETS, launched in order,
which carry their float32 sums in a (4, H, W) scratch and normalise once
(the same additions in the same order, so still bit-exact); a patch
radius above MAX_P (up to WIDE_MAX_P) runs the kernel's wide form, P at
run time, every offset in one launch.
"""

from __future__ import annotations

import ctypes

import torch

from ..pixel.fastmath import dt_fast_mexp2f
from ..pixel.shifts import pad2d

MAX_P = 8           # keep in step with csrc/nlm.cu, which checks them
MAX_OFFSETS = 900
WIDE_MAX_P = 96     # the wide form's patch radii (shared memory)
MODE_LOAD, MODE_FINAL = 1, 2
# the kernel's tile: 32 rows, and WARPS_X warps across, each 32 - 2P
# columns wide; a float4 per staged pixel; the shared memory a block may
# have on sm_90, and the most the resident path takes (two blocks per SM)
TILE_H, WARPS_X = 32, 2
PIXEL_BYTES = 16
MAX_SMEM = 232448
RESIDENT_MAX = MAX_SMEM // 2

# launches of the CUDA kernel since the count was last set to 0
LAUNCHES = 0


def _reach(offsets) -> int:
    return max((max(abs(a), abs(b)) for a, b in offsets), default=0)


def nlm_reference(img: torch.Tensor, offsets, P: int, norm, sharpness,
                  cp_norm: float, inv1cw: float, variant: int):
    """Plain torch: (3, H, W) -> the weighted patch average (3, H, W)."""
    _, h, w = img.shape
    hm = _reach(offsets) + P
    xp = pad2d(img, hm)
    n0, n1, n2 = (float(v) for v in norm)
    lo = hm - P

    def window(dy, dx):  # X[q + o] for q on the frame and a ring of P
        return xp[:, lo + dy: lo + dy + h + 2 * P,
                  lo + dx: lo + dx + w + 2 * P]

    c = window(0, 0)
    acc = torch.zeros_like(img)
    wsum = torch.zeros_like(img[0])
    for dy, dx in offsets:
        s = window(dy, dx)
        e = c - s
        d2 = n0 * (e[0] * e[0]) + n1 * (e[1] * e[1]) + n2 * (e[2] * e[2])
        r = None
        for a in range(2 * P + 1):
            t = d2[a:a + h, :]
            r = t if r is None else r + t
        ssd = None
        for b in range(2 * P + 1):
            t = r[:, b:b + w]
            ssd = t if ssd is None else ssd + t
        if variant == 0:
            wt = dt_fast_mexp2f(ssd * sharpness)
        else:
            dis = (ssd + d2[P:P + h, P:P + w] * cp_norm) * inv1cw
            wt = dt_fast_mexp2f(torch.clamp(dis * sharpness - 2.0, min=0.0))
        acc = acc + s[:, P:P + h, P:P + w] * wt
        wsum = wsum + wt
    return acc * (1.0 / torch.clamp(wsum, min=1e-12))


def tile_w(P: int) -> int:
    return WARPS_X * (32 - 2 * P)


def plan(P: int, reach: int):
    """(resident, shared bytes) of the kernel's launch: the whole search
    window (the tile plus a ring of reach + P) stays in shared memory when
    it takes at most RESIDENT_MAX bytes; otherwise the block streams the
    shifted tile and ring per offset through two buffers."""
    q = P + reach
    window = (TILE_H + 2 * q) * (tile_w(P) + 2 * q) * PIXEL_BYTES
    if window <= RESIDENT_MAX:
        return True, window
    return False, 2 * (TILE_H + 2 * P) * (tile_w(P) + 2 * P) * PIXEL_BYTES


def _pack(dy: int, dx: int) -> int:
    """(dy, dx) as two int16 in one signed int32, dy in the high half."""
    v = ((dy & 0xFFFF) << 16) | (dx & 0xFFFF)
    return v - (1 << 32) if v >= 1 << 31 else v


def _lib():
    from . import _build

    lib = _build.load("nlm")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.nlm.argtypes = [p, p, i, i, p, i, i, f, f, f, p, f, f, i, i, i,
                            p, i, p]
        lib.nlm.restype = ctypes.c_int
        lib.nlm_wide.argtypes = [p, p, i, i, p, i, i, f, f, f, p, f, f, i, p]
        lib.nlm_wide.restype = ctypes.c_int
        lib.nlm_limits.argtypes = [p] * 6
        lib.nlm_limits.restype = None
        got = [ctypes.c_int() for _ in range(6)]
        lib.nlm_limits(*[ctypes.byref(v) for v in got])
        if [v.value for v in got] != [MAX_P, MAX_OFFSETS, TILE_H, WARPS_X,
                                      MAX_SMEM, WIDE_MAX_P]:
            raise RuntimeError("csrc/nlm.cu and kernels/nlm.py disagree on "
                               "MAX_P, MAX_OFFSETS, WIDE_MAX_P or the tile")
        lib._typed = True
    return lib


def nlm(img: torch.Tensor, offsets, P: int, norm, sharpness, cp_norm: float,
        inv1cw: float, variant: int) -> torch.Tensor:
    """img (3, H, W) float32; offsets: sequence of (dy, dx); P: patch
    radius; norm: 3 per-channel SSD weights; sharpness: a float or a 0-dim
    tensor.  A CPU tensor runs the plain version; a CUDA tensor launches
    csrc/nlm.cu."""
    offsets = [(int(a), int(b)) for a, b in offsets]
    if img.device.type == "cpu":
        return nlm_reference(img, offsets, P, norm, sharpness, cp_norm,
                             inv1cw, variant)
    if img.device.type != "cuda":
        raise ValueError(f"nlm: unsupported device {img.device}")
    if (img.dtype != torch.float32 or img.dim() != 3 or img.shape[0] != 3
            or not img.is_contiguous() or img.numel() == 0):
        raise ValueError("nlm: needs a contiguous non-empty (3, H, W) "
                         f"float32 tensor, got {img.dtype} "
                         f"{tuple(img.shape)}")
    if not 0 <= P <= WIDE_MAX_P or variant not in (0, 1):
        raise ValueError(f"nlm: P = {P} outside [0, {WIDE_MAX_P}] or variant "
                         f"{variant} not 0/1")
    if not offsets or _reach(offsets) > 32767:
        raise ValueError(f"nlm: {len(offsets)} offsets of reach "
                         f"{_reach(offsets)}; the kernel takes at least one "
                         "of reach <= 32767")
    if isinstance(sharpness, torch.Tensor):
        sharp = sharpness.to(device=img.device, dtype=torch.float32)
        sharp = sharp.reshape(()).contiguous()
    else:
        sharp = torch.full((), float(sharpness), dtype=torch.float32,
                           device=img.device)
    global LAUNCHES
    lib = _lib()
    _, h, w = img.shape
    out = torch.empty_like(img)
    n0, n1, n2 = (float(v) for v in norm)
    packed = [_pack(a, b) for a, b in offsets]
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        if P > MAX_P:
            dev_offs = torch.tensor(packed, dtype=torch.int32).to(img.device)
            rc = lib.nlm_wide(img.data_ptr(), out.data_ptr(), h, w,
                              dev_offs.data_ptr(), len(offsets), P, n0, n1,
                              n2, sharp.data_ptr(), float(cp_norm),
                              float(inv1cw), variant, stream)
            launches = 1
        else:
            starts = range(0, len(offsets), MAX_OFFSETS)
            sums = (torch.empty((4, h, w), dtype=torch.float32,
                                device=img.device)
                    if len(starts) > 1 else None)
            rc, launches = 0, 0
            for n, i in enumerate(starts):
                chunk = packed[i:i + MAX_OFFSETS]
                mode = ((MODE_LOAD if n else 0)
                        | (MODE_FINAL if n == len(starts) - 1 else 0))
                resident, smem = plan(P, _reach(offsets[i:i + MAX_OFFSETS]))
                rc = lib.nlm(img.data_ptr(), out.data_ptr(), h, w,
                             (ctypes.c_int * len(chunk))(*chunk), len(chunk),
                             P, n0, n1, n2, sharp.data_ptr(), float(cp_norm),
                             float(inv1cw), variant, int(resident), smem,
                             None if sums is None else sums.data_ptr(), mode,
                             stream)
                if rc != 0:
                    break
                launches += 1
    if rc != 0:
        raise RuntimeError(f"nlm: CUDA launch failed ({rc})")
    LAUNCHES += launches
    return out
