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
import functools
from typing import NamedTuple

import numpy as np
import torch

from ._build import COUNT_LOCK

# launches of the CUDA kernel since the count was last set to 0
LAUNCHES = 0

# The kernel's launch shape (csrc/bgrid.cu, which the wrapper checks
# against these): a block of THREADS threads owns a tile of TILE_W
# columns by one of TILE_ROWS rows and may stage a slab of the grid of at
# most SLAB_BYTES in shared memory.
TILE_W = 128
THREADS = 256
TILE_ROWS = (64, 32, 16, 8)
SLAB_BYTES = 48 * 1024


class SlicePlan(NamedTuple):
    """One launch: the tile's rows; the slab's rows and columns and its
    floats per (bin, channel) plane (0 for the direct path, which reads
    the grid without a slab); its shared bytes."""
    rows: int
    slab_rows: int
    slab_cols: int
    plane_stride: int
    smem: int


@functools.lru_cache(maxsize=64)
def row_table(gh: int, ss: int) -> np.ndarray:
    """(ia, ib, wa, wb) of every frame row, int32 (Hp, 4) with the weights'
    float32 bits: the twin's row weights, rounded as it rounds them (a
    true division, then float32 operations in its order)."""
    f32 = np.float32
    y = np.arange(gh * ss, dtype=f32)
    gy = np.clip((y + f32(0.5)) / f32(ss) - f32(0.5), f32(0.0), f32(gh - 1))
    qa = np.floor(gy)
    wa = np.maximum(f32(1.0) - np.abs(gy - qa), f32(0.0))
    wb = np.maximum(f32(1.0) - np.abs(gy - (qa + f32(1.0))), f32(0.0))
    ia = qa.astype(np.int32)
    ib = np.minimum(ia + 1, gh - 1).astype(np.int32)
    return np.stack([ia, ib, wa.view(np.int32), wb.view(np.int32)], 1)


@functools.lru_cache(maxsize=64)
def col_ranges(gw: int, ss: int) -> np.ndarray:
    """(least i0, largest i1) over each tile of TILE_W columns, int32
    (tiles, 2), from the tap table itself (`upsample_taps`)."""
    from ..pixel.bilateralgrid import upsample_taps

    i0, i1, _, _ = upsample_taps(gw, ss)
    starts = np.arange(0, gw * ss, TILE_W)
    return np.stack([np.minimum.reduceat(i0, starts),
                     np.maximum.reduceat(i1, starts)], 1).astype(np.int32)


def _plane_stride(n: int, C: int, q: int) -> int:
    """Floats per (bin, channel) plane, at least n: the least whose bin
    step C * stride lies (q mod 32) | 1 banks on, so the planes of
    neighbouring bins start on other banks than a warp's q columns."""
    want = (q % 32) | 1
    for s in range(n, n + 32):
        if C * s % 32 == want:
            return s
    return n  # C even: no stride reaches an odd bank step


@functools.lru_cache(maxsize=256)
def slice_plan(D: int, C: int, gh: int, gw: int, ss: int) -> SlicePlan:
    """The tallest of TILE_ROWS whose slab of D * C planes (the grid rows
    from ia of a tile's first row to ib of its last, the columns from its
    least i0 to its largest i1, each the most over the frame's tiles)
    fits SLAB_BYTES; else the direct path at the shortest tile, which
    spreads the gathers over the most blocks."""
    rt = row_table(gh, ss)
    cr = col_ranges(gw, ss)
    q = int((cr[:, 1] - cr[:, 0]).max()) + 1
    hp = gh * ss
    for th in TILE_ROWS:
        first = np.arange(0, hp, th)
        last = np.minimum(first + th, hp) - 1
        r = int((rt[last, 1] - rt[first, 0]).max()) + 1
        stride = _plane_stride(r * q, C, q)
        smem = 4 * D * C * stride
        if smem <= SLAB_BYTES:
            return SlicePlan(th, r, q, stride, smem)
    return SlicePlan(TILE_ROWS[-1], 0, 0, 0, 0)


@functools.lru_cache(maxsize=64)
def _device_tables(gh: int, gw: int, ss: int, device: torch.device):
    return (torch.from_numpy(row_table(gh, ss)).to(device),
            torch.from_numpy(col_ranges(gw, ss)).to(device))


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
    # a dropped bin reads bin 0 (its term is masked): NaN z, which no
    # clamp makes an index, gives 0 as in the kernel
    k0 = torch.where(v0, b0, 0.0).long()
    k1 = torch.where(v1, b1, 0.0).long()
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
        lib.bgrid_slice.argtypes = [p] * 7 + [i] * 11 + [p]
        lib.bgrid_slice.restype = ctypes.c_int
        got = (lib.bgrid_tile_cols(), lib.bgrid_threads(),
               lib.bgrid_slab_bytes())
        if got != (TILE_W, THREADS, SLAB_BYTES):
            raise RuntimeError(f"bgrid.cu launches {got}, the plan says "
                               f"{(TILE_W, THREADS, SLAB_BYTES)}")
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
    rows, cols = _device_tables(gh, gw, ss, z.device)
    plan = slice_plan(D, C, gh, gw, ss)
    out = torch.empty((C, Hp, Wp), dtype=torch.float32, device=z.device)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.bgrid_slice(base_grid.data_ptr(), z.data_ptr(),
                             idx.data_ptr(), wts.data_ptr(), rows.data_ptr(),
                             cols.data_ptr(), out.data_ptr(), D, C, gh, gw,
                             Hp, Wp, ss, plan.rows, plan.slab_rows,
                             plan.slab_cols, plan.plane_stride, stream)
    if rc != 0:
        raise RuntimeError(f"slice_grid: CUDA launch failed ({rc})")
    with COUNT_LOCK:
        LAUNCHES += 1
    return out
