"""Bilateral-grid slice: the CUDA kernel (`csrc/bgrid.cu`) and its plain
twin.

Both compute what `ansel_tpu/kernels/bgrid_pallas.py:slice_grid` computes
on the TPU: the trilinear read of a blurred (D, C, gh, gw) grid at every
pixel of an (Hp, Wp) frame, Hp = gh * ss and Wp = gw * ss, with the range
coordinate z in [0, D - 1]:

    G'[k, c, q, x] = w0[x] * G[k, c, q, i0[x]] + w1[x] * G[k, c, q, i1[x]]
                     (the column upsample, `bilateralgrid.upsample_taps`)
    gy = clip((y + 0.5) / ss - 0.5, 0, gh - 1),  q = floor(gy)
    P[k] = (1 - |gy - q|) * G'[k, c, q, x]
           + (1 - |gy - q - 1|) * G'[k, c, q + 1, x]
    out[c, y, x] = (1 - f) * P[b0] + f * P[b0 + 1],  b0 = floor(z), f = z - b0

each product and sum rounded in this order, a bin outside [0, D - 1]
contributing 0 (the weight for bin D is dropped, not clamped).  The
Pallas kernel sums the same two rows and two bins among terms of weight
exactly 0 (its tile's other slab rows and bins), which leave a float sum
unchanged.

`slice_grid` launches the kernel for a CUDA tensor and runs
`slice_grid_reference` for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

# launches of the CUDA kernel since the count was last set to 0
LAUNCHES = 0


def slice_grid_reference(base_grid: torch.Tensor, z: torch.Tensor,
                         ss: int) -> torch.Tensor:
    """Plain torch: the column upsample, then rows, then bins."""
    from ..pixel.bilateralgrid import upsample_axis

    D, C, gh, _ = base_grid.shape
    Hp, Wp = z.shape
    dev = z.device
    gx = upsample_axis(base_grid, ss, axis=3)               # (D, C, gh, Wp)
    rows = torch.arange(Hp, dtype=torch.float32, device=dev)
    # a 0-dim divisor: on the card torch multiplies by the reciprocal of a
    # Python float, where the kernel divides
    ss_t = torch.full((), float(ss), dtype=torch.float32, device=dev)
    gy = torch.clamp((rows + 0.5) / ss_t - 0.5, 0.0, float(gh - 1))
    qa = torch.floor(gy)
    wa = torch.clamp(1.0 - torch.abs(gy - qa), min=0.0)[:, None]
    wb = torch.clamp(1.0 - torch.abs(gy - (qa + 1.0)), min=0.0)[:, None]
    ia = qa.long()[:, None]
    ib = (ia + 1).clamp(max=gh - 1)
    b0 = torch.floor(z)
    f = z - b0
    b1 = b0 + 1.0
    v0 = (b0 >= 0.0) & (b0 <= D - 1)
    v1 = (b1 >= 0.0) & (b1 <= D - 1)
    k0 = b0.clamp(0, D - 1).long()
    k1 = b1.clamp(0, D - 1).long()
    col = torch.arange(Wp, device=dev)[None, :]
    out = []
    for c in range(C):
        g = gx[:, c].reshape(-1)

        def plane(k):
            pa = g[((k * gh) + ia) * Wp + col]
            pb = g[((k * gh) + ib) * Wp + col]
            return wa * pa + wb * pb

        t0 = torch.where(v0, (1.0 - f) * plane(k0), 0.0)
        t1 = torch.where(v1, f * plane(k1), 0.0)
        out.append(t0 + t1)
    return torch.stack(out)


def _lib():
    from . import _build

    lib = _build.load("bgrid")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.bgrid_slice.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
        lib.bgrid_slice.restype = ctypes.c_int
        lib._typed = True
    return lib


def slice_grid(base_grid: torch.Tensor, z: torch.Tensor,
               ss: int) -> torch.Tensor:
    """Trilinear slice of the blurred grid `base_grid` (D, C, gh, gw) at
    every pixel's (y / ss, x / ss, z) of `z` (gh * ss, gw * ss), both
    float32 -> (C, gh * ss, gw * ss) float32.  A CPU tensor runs the plain
    version; a CUDA tensor launches csrc/bgrid.cu."""
    ss = int(ss)
    if (base_grid.dim() != 4 or z.dim() != 2 or ss < 1
            or z.shape != (base_grid.shape[2] * ss, base_grid.shape[3] * ss)):
        raise ValueError("slice_grid: needs a (D, C, gh, gw) grid and a "
                         f"(gh * ss, gw * ss) z, got {tuple(base_grid.shape)}, "
                         f"{tuple(z.shape)}, ss = {ss}")
    if z.device != base_grid.device:
        raise ValueError("slice_grid: grid and z on different devices")
    if z.device.type == "cpu":
        return slice_grid_reference(base_grid, z, ss)
    if z.device.type != "cuda":
        raise ValueError(f"slice_grid: unsupported device {z.device}")
    if (base_grid.dtype != torch.float32 or z.dtype != torch.float32
            or not base_grid.is_contiguous() or not z.is_contiguous()
            or z.numel() == 0):
        raise ValueError("slice_grid: needs contiguous non-empty float32 "
                         f"tensors, got {base_grid.dtype}, {z.dtype}")
    from ..pixel.bilateralgrid import column_taps

    global LAUNCHES
    lib = _lib()
    D, C, gh, gw = base_grid.shape
    Hp, Wp = z.shape
    idx, wts = column_taps(gw, ss, z.device)
    out = torch.empty((C, Hp, Wp), dtype=torch.float32, device=z.device)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.bgrid_slice(base_grid.data_ptr(), z.data_ptr(),
                             idx.data_ptr(), wts.data_ptr(), out.data_ptr(),
                             D, C, gh, gw, Hp, Wp, ss, stream)
    if rc != 0:
        raise RuntimeError(f"slice_grid: CUDA launch failed ({rc})")
    LAUNCHES += 1
    return out
