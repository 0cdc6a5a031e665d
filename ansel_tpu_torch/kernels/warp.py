"""The warps: the CUDA kernels (`csrc/warp.cu`) and their plain twins.

Each resamples a (C, H, W) image at per-pixel source coordinates from a
closed-form map evaluated per output pixel, with four maps:

* lens's (`ansel_tpu/ops/lens.py` `coord`: the distortion multiplier of
  the ptlens, poly3 or poly5 model, `/ scale`, and per R/B channel the
  TCA polynomial), on a (3, H, W) image;
* clipping's inverse map (`ansel_tpu/ops/clipping.py` `_inverse_coords`:
  translate, undo the keystone shears, rotate back, the optional
  projective keystone), with the outside mask folded in: an output
  pixel whose source lies outside the frame is 0;
* ashift's inverse homography (`ansel_tpu/ops/ashift.py` `apply`), its
  outside mask folded in likewise;
* liquify's brush displacement (`ansel_tpu/ops/liquify.py` `_dmap`): the
  sum over its stamps at each pixel of the stamp-union window, the
  window sampled from the whole frame, the rest of the frame copied.

On the TPU the JAX package resamples with the two-pass Pallas warp
(`ansel_tpu/kernels/warp_pallas.py:warp_bilinear`, driven by
`warp_model`, for liquify on a stride-8 grid of the map); on the CPU
with a direct bilinear gather of the exact map (`ops/lens.py:
_sample_bilinear`).  A GPU gathers directly, so the port follows the
CPU form operation for operation: corner (y0, x0) = clip(floor(s), 0,
n - 2), weights clip(s - y0, 0, 1), the four corner terms summed in
order.  Divisions are true divisions by tensors (a CUDA tensor divided
by a Python float is multiplied by its reciprocal), as in the kernel.
Clipping's and ashift's constants are float32 values computed on the
host (`ops/clipping.clip_map`, `ops/ashift.homography_consts`), as JAX
rounds the float64 Python constants of their maps.

`lens_warp`, `clip_warp`, `homography_warp` and `liquify_warp` launch
the kernel for a CUDA tensor and run their `*_reference` twins for a CPU
tensor.  Lens's kernel gathers each pixel's corners from device memory.
The other three stage each output tile's source box in shared memory
where it fits the staging budget (`TILE`) and sample device memory
directly where it does not; `tile_plan` is that decision on the host,
and `direct_tiles` reads how many tiles the kernel sent down the direct
path.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from ._build import COUNT_LOCK

DIST_NONE = 0
DIST_POLY3 = 1
DIST_PTLENS = 2
DIST_POLY5 = 3

# modify flags (lensfun LF_MODIFY_*)
MODIFY_TCA = 1
MODIFY_VIGNETTING = 2
MODIFY_DISTORTION = 8

# launches of the CUDA kernels (every map) since the count was last set
# to 0, and the same per map ("lens", "clip", "homography", "liquify")
LAUNCHES = 0
MAP_LAUNCHES = collections.Counter()

# the staged maps' output tile (rows, columns) and staging budget in
# floats, as the launches pass it (csrc/warp.cu's warp_limits: the tile
# and the largest budget, its shared buffer)
TILE = (16, 32, 6144)
# per staged map and device, an int32 counter on the device of the tiles
# that sampled device memory directly
_DIRECT = {}

# clipping's float32 constants, in the order of csrc/warp.cu's ClipMap
CLIP_CONSTS = ("c_px", "c_py", "t_px", "t_py", "k_h", "k_v", "m0", "m1",
               "m2", "m3", "tx", "ty", "ksp_x", "ksp_y", "a", "b", "d", "e",
               "hg", "hh", "ae", "bd", "kxa", "kya", "out_oy", "out_ox",
               "in_oy", "in_ox", "w_m1", "h_m1")


# ashift's inverse homography: its nine entries, row-major
HOMOGRAPHY_CONSTS = 9
# one liquify stamp in the kernel's buffer: centre, radius, vector,
# magnitude, radial sign (+1 grow, -1 shrink, 0 linear), then the nine
# coefficients of its falloff polynomial, highest power first
STAMP_FIELDS = ("px", "py", "R", "sx", "sy", "smag", "radial")
POLY_TERMS = 9
STAMP = len(STAMP_FIELDS) + POLY_TERMS


def pack_consts(c) -> torch.Tensor:
    """[a, b, c, scale, tca_r (3), tca_b (3)] as one float32 tensor on the
    coefficients' device."""
    return torch.cat([c["a"].reshape(1), c["b"].reshape(1),
                      c["c"].reshape(1), c["scale"].reshape(1),
                      c["tca_r"].reshape(3), c["tca_b"].reshape(3)]
                     ).float().contiguous()


def lens_coords(k: torch.Tensor, model: int, flags: int, h: int, w: int,
                cy: float, cx: float, rnorm: float, ch: int):
    """Source (y, x) of every output pixel of channel `ch`, each (h, w)
    float32; `k` the packed coefficients."""
    dev = k.device
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    rn = torch.full((), rnorm, dtype=torch.float32, device=dev)
    yn = (yy - cy) / rn
    xn = (xx - cx) / rn
    r = torch.sqrt(yn * yn + xn * xn)
    a, b, c, scale = k[0], k[1], k[2], k[3]
    if (flags & MODIFY_DISTORTION) and model != DIST_NONE:
        if model == DIST_POLY3:
            m = 1.0 - a + a * r * r
        elif model == DIST_POLY5:
            r2 = r * r
            m = 1.0 + a * r2 + b * (r2 * r2)
        else:  # ptlens: ru = rd (a rd^3 + b rd^2 + c rd + 1 - a - b - c)
            m = a * (r * (r * r)) + b * (r * r) + c * r + (1.0 - a - b - c)
    else:
        m = torch.ones_like(r)
    m = m / scale
    if ch != 1 and flags & MODIFY_TCA:
        t = k[4:7] if ch == 0 else k[7:10]
        m = m * (t[0] + t[1] * r + t[2] * r * r)
    return cy + (yy - cy) * m, cx + (xx - cx) * m


def sample_bilinear(plane: torch.Tensor, ys: torch.Tensor,
                    xs: torch.Tensor) -> torch.Tensor:
    """(h, w) plane sampled at (ys, xs), each (h, w): ops/lens.py's
    _sample_bilinear."""
    h, w = plane.shape
    y0 = torch.clamp(torch.floor(ys), 0, h - 2)
    x0 = torch.clamp(torch.floor(xs), 0, w - 2)
    fy = torch.clamp(ys - y0, 0.0, 1.0)
    fx = torch.clamp(xs - x0, 0.0, 1.0)
    idx = y0.long() * w + x0.long()
    flat = plane.reshape(-1)
    return (flat[idx] * (1 - fy) * (1 - fx) + flat[idx + 1] * (1 - fy) * fx
            + flat[idx + w] * fy * (1 - fx) + flat[idx + w + 1] * fy * fx)


def lens_warp_reference(x: torch.Tensor, k: torch.Tensor, model: int,
                        flags: int, cy: float, cx: float,
                        rnorm: float) -> torch.Tensor:
    """Plain torch: (3, H, W) -> (3, H, W)."""
    _, h, w = x.shape
    out = []
    for ch in range(3):
        sy, sx = lens_coords(k, model, flags, h, w, cy, cx, rnorm, ch)
        out.append(sample_bilinear(x[ch], sy.expand(h, w), sx.expand(h, w)))
    return torch.stack(out)


def clip_coords(k: torch.Tensor, k_apply: int, oh: int, ow: int, device):
    """Clipping's map on the (oh, ow) output buffer: -> (source y, source x
    in the input buffer, inside the frame), each (oh, ow); `k` the
    CLIP_CONSTS (float32), `k_apply` whether the keystone applies."""
    c = dict(zip(CLIP_CONSTS, k.tolist()))
    f32 = torch.float32

    def full(v):
        return torch.full((), v, dtype=f32, device=device)

    jj = torch.arange(oh, dtype=f32, device=device)[:, None] + c["out_oy"]
    ii = torch.arange(ow, dtype=f32, device=device)[None, :] + c["out_ox"]
    px = (c["c_px"] + ii) + 0.5
    py = (c["c_py"] + jj) + 0.5
    px = px - c["t_px"]
    py = py - c["t_py"]
    py = py / (1.0 + px * c["k_h"])
    px = px / (1.0 + py * c["k_v"])
    sx = c["m0"] * px + c["m1"] * py + c["tx"]
    sy = c["m2"] * px + c["m3"] * py + c["ty"]
    if k_apply:
        xx = sx - c["ksp_x"]
        yy = sy - c["ksp_y"]
        div = (c["d"] * xx - c["a"] * yy) * c["hh"] \
            + (c["b"] * yy - c["e"] * xx) * c["hg"] + full(c["ae"]) \
            - full(c["bd"])
        sx = (c["e"] * xx - c["b"] * yy) / div + c["kxa"]
        sy = -(c["d"] * xx - c["a"] * yy) / div + c["kya"]
    sy = (sy - 0.5).expand(oh, ow)
    sx = (sx - 0.5).expand(oh, ow)
    inside = (sx >= 0) & (sx <= c["w_m1"]) & (sy >= 0) & (sy <= c["h_m1"])
    return sy - c["in_oy"], sx - c["in_ox"], inside


def clip_warp_reference(x: torch.Tensor, k: torch.Tensor, k_apply: int,
                        oh: int, ow: int) -> torch.Tensor:
    """Plain torch: (C, H, W) -> (C, oh, ow)."""
    sy, sx, inside = clip_coords(k, k_apply, oh, ow, x.device)
    out = torch.stack([sample_bilinear(x[i], sy, sx)
                       for i in range(x.shape[0])])
    return torch.where(inside[None], out, torch.zeros((), device=x.device))


def homography_coords(k: torch.Tensor, h: int, w: int, device):
    """ashift's map on an (h, w) frame: -> (source y, source x, inside the
    frame), each (h, w); `k` the HOMOGRAPHY_CONSTS (float32)."""
    m = k.tolist()
    f32 = torch.float32
    ys = torch.arange(h, dtype=f32, device=device)[:, None]
    xs = torch.arange(w, dtype=f32, device=device)[None, :]
    den = m[6] * xs + m[7] * ys + m[8]
    den = torch.where(torch.abs(den) < 1e-9,
                      torch.full((), 1e-9, dtype=f32, device=device), den)
    sx = (m[0] * xs + m[1] * ys + m[2]) / den
    sy = (m[3] * xs + m[4] * ys + m[5]) / den
    inside = (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)
    return sy, sx, inside


def homography_warp_reference(x: torch.Tensor, k: torch.Tensor
                              ) -> torch.Tensor:
    """Plain torch: (C, H, W) -> (C, H, W)."""
    _, h, w = x.shape
    sy, sx, inside = homography_coords(k, h, w, x.device)
    out = torch.stack([sample_bilinear(x[i], sy, sx)
                       for i in range(x.shape[0])])
    return torch.where(inside[None], out, torch.zeros((), device=x.device))


def pack_stamps(c) -> torch.Tensor:
    """liquify's coefficient dict (each field (K,), poly (K, 9)) -> the
    (K, STAMP) float32 buffer the kernel reads, on the coefficients'
    device."""
    cols = [c[k].reshape(-1, 1) for k in STAMP_FIELDS] + [c["poly"]]
    return torch.cat(cols, dim=1).float().contiguous()


def liquify_displacement(stamps: torch.Tensor, win):
    """The stamps' summed displacement (dx, dy) at each pixel of the
    window (y0, y1, x0, x1), each (y1 - y0, x1 - x0), and the pixels'
    absolute (yy, xx): liquify.py's _dmap, stamp by stamp in order."""
    y0, y1, x0, x1 = win
    dev = stamps.device
    f32 = torch.float32
    xx = torch.arange(x1 - x0, dtype=f32, device=dev)[None, :] + x0
    yy = torch.arange(y1 - y0, dtype=f32, device=dev)[:, None] + y0
    xx, yy = xx.expand(y1 - y0, x1 - x0), yy.expand(y1 - y0, x1 - x0)
    ax = torch.zeros_like(xx)
    ay = torch.zeros_like(xx)
    zero = torch.zeros((), dtype=f32, device=dev)
    for s in stamps:
        px, py, R, sx, sy, smag, radial = s[:len(STAMP_FIELDS)]
        dx = xx - px
        dy = yy - py
        d = torch.sqrt(dx * dx + dy * dy) / R
        f = torch.zeros_like(d)
        for p in s[len(STAMP_FIELDS):]:
            f = f * d + p
        f = torch.where(d < 1.0, torch.clamp(f, 0.0, 1.0), zero)
        is_rad = radial != 0.0
        ax = ax - torch.where(is_rad, f * smag * dx / R * radial, f * sx)
        ay = ay - torch.where(is_rad, f * smag * dy / R * radial, f * sy)
    return ax, ay, yy, xx


def liquify_warp_reference(x: torch.Tensor, stamps: torch.Tensor,
                           win) -> torch.Tensor:
    """Plain torch: (C, H, W) -> (C, H, W), the window (y0, y1, x0, x1)
    resampled at the displaced positions, the rest a copy of x."""
    y0, y1, x0, x1 = win
    ax, ay, yy, xx = liquify_displacement(stamps, win)
    sx, sy = xx + ax, yy + ay
    out = x.clone()
    out[:, y0:y1, x0:x1] = torch.stack([sample_bilinear(x[i], sy, sx)
                                        for i in range(x.shape[0])])
    return out


def corners(sy: torch.Tensor, sx: torch.Tensor, h: int, w: int):
    """The top-left corners (row, column) the sampler reads at (sy, sx)
    of an (h, w) plane, int64: clip(floor(s), 0, n - 2), NaN as 0 (the
    kernel's fmaxf)."""
    def one(s, n):
        f = torch.nan_to_num(torch.floor(s), nan=0.0)
        return torch.clamp(f, 0, n - 2).long()
    return one(sy, h), one(sx, w)


def tile_plan(sets, valid: torch.Tensor, h: int, w: int, c: int,
              vec: bool):
    """The kernel's staging decision for each tile (`TILE`) of a staged
    map's output, whose pixel (y, x), where `valid` (oh, ow), samples c
    planes of (h, w) at each (sy, sx) of `sets` (each (oh, ow)): -> (y0,
    rows, x0, cols, staged), each (tiles down, tiles across).  The box
    holds every corner the tile's pixels read; its columns widen to
    multiples of 4 when `vec` (the input's rows 16-byte aligned); a tile
    that reads nothing has rows 0 and is staged; a box whose c planes
    exceed the budget is not (the tile samples device memory directly)."""
    th, tw, budget = TILE
    oh, ow = valid.shape
    nty, ntx = -(-oh // th), -(-ow // tw)
    big = 1 << 40

    def fold(v, fill, lo):
        p = torch.full((nty * th, ntx * tw), fill, dtype=torch.int64,
                       device=v.device)
        p[:oh, :ow] = torch.where(valid, v, torch.full_like(v, fill))
        p = p.reshape(nty, th, ntx, tw)
        return p.amin(dim=(1, 3)) if lo else p.amax(dim=(1, 3))

    parts = []
    for sy, sx in sets:
        iy, ix = corners(sy.expand(oh, ow), sx.expand(oh, ow), h, w)
        parts.append((fold(iy, big, True), fold(iy + 1, -big, False),
                      fold(ix, big, True), fold(ix + 1, -big, False)))
    ylo, yhi, xlo, xhi = (torch.stack(p).amin(0) if i % 2 == 0
                          else torch.stack(p).amax(0)
                          for i, p in enumerate(zip(*parts)))
    empty = ylo > yhi
    x0 = torch.bitwise_and(xlo, ~3) if vec else xlo
    cols = (torch.bitwise_and(xhi + 4, ~3) if vec else xhi + 1) - x0
    rows = yhi - ylo + 1
    staged = empty | (c * rows * cols <= budget)
    zero = torch.zeros_like(rows)
    return (torch.where(empty, zero, ylo), torch.where(empty, zero, rows),
            torch.where(empty, zero, x0), torch.where(empty, zero, cols),
            staged)


def liquify_positions(stamps: torch.Tensor, win, h: int, w: int):
    """liquify's source positions on the whole (h, w) frame: (sy, sx,
    in the window), the positions 0 outside it; `tile_plan`'s input."""
    y0, y1, x0, x1 = win
    ax, ay, yy, xx = liquify_displacement(stamps, win)
    sy = torch.zeros((h, w), dtype=torch.float32, device=stamps.device)
    sx = torch.zeros_like(sy)
    sy[y0:y1, x0:x1] = yy + ay
    sx[y0:y1, x0:x1] = xx + ax
    valid = torch.zeros((h, w), dtype=torch.bool, device=stamps.device)
    valid[y0:y1, x0:x1] = True
    return sy, sx, valid


def _direct(kind: str, device) -> torch.Tensor:
    with COUNT_LOCK:
        buf = _DIRECT.get((kind, device))
        if buf is None:
            buf = _DIRECT[(kind, device)] = torch.zeros(
                1, dtype=torch.int32, device=device)
    return buf


def direct_tiles() -> collections.Counter:
    """{map: tiles that sampled device memory directly} since
    reset_direct_tiles(); reads the device counters (a synchronisation)."""
    direct = collections.Counter()
    for (kind, _), buf in list(_DIRECT.items()):
        direct[kind] += int(buf.item())
    return direct


def reset_direct_tiles():
    with COUNT_LOCK:
        for buf in _DIRECT.values():
            buf.zero_()


def _lib():
    from . import _build

    lib = _build.load("warp")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.lens_warp.argtypes = [p, p, p, i, i, i, i, f, f, f, p]
        lib.lens_warp.restype = ctypes.c_int
        lib.clip_warp.argtypes = [p, p, i, i, i, i, i, p, i, i, p, p]
        lib.clip_warp.restype = ctypes.c_int
        lib.homography_warp.argtypes = [p, p, i, i, i, p, i, p, p]
        lib.homography_warp.restype = ctypes.c_int
        lib.liquify_warp.argtypes = [p, p, i, i, i, i, i, i, i, p, i, i, p,
                                     p]
        lib.liquify_warp.restype = ctypes.c_int
        for fn in ("clip_warp_nconsts", "homography_warp_nconsts",
                   "liquify_stamp_floats"):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = ctypes.c_int
        lib.warp_limits.argtypes = [p, p, p]
        lib.warp_limits.restype = None
        tile = [ctypes.c_int() for _ in range(3)]
        lib.warp_limits(*[ctypes.byref(v) for v in tile])
        if ((lib.clip_warp_nconsts(), lib.homography_warp_nconsts(),
             lib.liquify_stamp_floats()) != (len(CLIP_CONSTS),
                                             HOMOGRAPHY_CONSTS, STAMP)
                or tuple(v.value for v in tile) != TILE):
            raise RuntimeError("csrc/warp.cu and kernels/warp.py disagree on "
                               "the maps' constants or tiles")
        lib._typed = True
    return lib


def _check_image(x: torch.Tensor):
    if (x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous()
            or min(x.shape[1:]) < 2):
        raise ValueError("warp: needs a contiguous (C, H, W) float32 tensor "
                         f"with H, W >= 2, got {x.dtype} {tuple(x.shape)}")


def clip_warp(x: torch.Tensor, k: torch.Tensor, k_apply: int, oh: int,
              ow: int) -> torch.Tensor:
    """Clipping's warp of a (C, H, W) float32 image onto a (C, oh, ow)
    buffer, zero outside the frame; `k` the CLIP_CONSTS, float32 on the
    host.  A CPU tensor runs the plain version; a CUDA tensor launches
    csrc/warp.cu."""
    k = k.detach().to("cpu", torch.float32).contiguous()
    if k.numel() != len(CLIP_CONSTS):
        raise ValueError(f"clip_warp: needs {len(CLIP_CONSTS)} constants, "
                         f"got {k.numel()}")
    if x.device.type == "cpu":
        return clip_warp_reference(x, k, k_apply, oh, ow)
    if x.device.type != "cuda":
        raise ValueError(f"warp: unsupported device {x.device}")
    _check_image(x)
    if oh < 1 or ow < 1:
        raise ValueError(f"clip_warp: empty output {oh}x{ow}")
    global LAUNCHES
    lib = _lib()
    c, h, w = x.shape
    out = torch.empty((c, oh, ow), dtype=x.dtype, device=x.device)
    direct = _direct("clip", x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.clip_warp(x.data_ptr(), out.data_ptr(), c, h, w, oh, ow,
                           k.data_ptr(), int(bool(k_apply)), TILE[2],
                           direct.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"warp: CUDA launch failed ({rc})")
    with COUNT_LOCK:
        LAUNCHES += 1
        MAP_LAUNCHES["clip"] += 1
    return out


def homography_warp(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """ashift's warp of a (C, H, W) float32 image onto the same frame, zero
    where the source falls outside it; `k` the HOMOGRAPHY_CONSTS, float32
    on the host.  A CPU tensor runs the plain version; a CUDA tensor
    launches csrc/warp.cu."""
    k = k.detach().to("cpu", torch.float32).contiguous()
    if k.numel() != HOMOGRAPHY_CONSTS:
        raise ValueError(f"homography_warp: needs {HOMOGRAPHY_CONSTS} "
                         f"constants, got {k.numel()}")
    if x.device.type == "cpu":
        return homography_warp_reference(x, k)
    if x.device.type != "cuda":
        raise ValueError(f"warp: unsupported device {x.device}")
    _check_image(x)
    global LAUNCHES
    lib = _lib()
    c, h, w = x.shape
    out = torch.empty_like(x)
    direct = _direct("homography", x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.homography_warp(x.data_ptr(), out.data_ptr(), c, h, w,
                                 k.data_ptr(), TILE[2], direct.data_ptr(),
                                 stream)
    if rc != 0:
        raise RuntimeError(f"warp: CUDA launch failed ({rc})")
    with COUNT_LOCK:
        LAUNCHES += 1
        MAP_LAUNCHES["homography"] += 1
    return out


def liquify_warp(x: torch.Tensor, stamps: torch.Tensor,
                 win) -> torch.Tensor:
    """liquify's warp of a (C, H, W) float32 image: the window (y0, y1,
    x0, x1) resampled at each pixel displaced by the sum of the stamps
    (`pack_stamps`, (K, STAMP) float32 on the image's device), the rest a
    copy.  A CPU tensor runs the plain version; a CUDA tensor launches
    csrc/warp.cu once over the whole frame, which writes every pixel of
    the output."""
    y0, y1, x0, x1 = (int(v) for v in win)
    if x.device.type == "cpu":
        return liquify_warp_reference(x, stamps, (y0, y1, x0, x1))
    if x.device.type != "cuda":
        raise ValueError(f"warp: unsupported device {x.device}")
    _check_image(x)
    c, h, w = x.shape
    if not (0 <= y0 < y1 <= h and 0 <= x0 < x1 <= w):
        raise ValueError(f"liquify_warp: window {win} outside {h}x{w}")
    if (stamps.device != x.device or stamps.dtype != torch.float32
            or stamps.dim() != 2 or stamps.shape[1] != STAMP
            or stamps.shape[0] < 1 or not stamps.is_contiguous()):
        raise ValueError("liquify_warp: needs (K, 16) float32 stamps on the "
                         "image's device")
    global LAUNCHES
    lib = _lib()
    out = torch.empty_like(x)
    direct = _direct("liquify", x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.liquify_warp(x.data_ptr(), out.data_ptr(), c, h, w, y0, x0,
                              y1 - y0, x1 - x0, stamps.data_ptr(),
                              stamps.shape[0], TILE[2], direct.data_ptr(),
                              stream)
    if rc != 0:
        raise RuntimeError(f"warp: CUDA launch failed ({rc})")
    with COUNT_LOCK:
        LAUNCHES += 1
        MAP_LAUNCHES["liquify"] += 1
    return out


def lens_warp(x: torch.Tensor, k: torch.Tensor, model: int, flags: int,
              cy: float, cx: float, rnorm: float) -> torch.Tensor:
    """Lens's distortion and TCA warp of a (3, H, W) float32 image, `k` the
    packed coefficients (`pack_consts`) and (cy, cx, rnorm) the centre and
    radius normalisation in pixels.  A CPU tensor runs the plain version;
    a CUDA tensor launches csrc/warp.cu."""
    if x.device.type == "cpu":
        return lens_warp_reference(x, k, model, flags, cy, cx, rnorm)
    if x.device.type != "cuda":
        raise ValueError(f"warp: unsupported device {x.device}")
    if (x.dtype != torch.float32 or x.dim() != 3 or x.shape[0] != 3
            or not x.is_contiguous() or min(x.shape[1:]) < 2):
        raise ValueError("warp: needs a contiguous (3, H, W) float32 tensor "
                         f"with H, W >= 2, got {x.dtype} {tuple(x.shape)}")
    if (k.device != x.device or k.dtype != torch.float32
            or k.numel() != 10 or not k.is_contiguous()):
        raise ValueError("warp: needs 10 packed float32 coefficients on the "
                         "image's device")
    if model not in (DIST_NONE, DIST_POLY3, DIST_PTLENS, DIST_POLY5):
        raise ValueError(f"warp: unknown distortion model {model}")
    global LAUNCHES
    lib = _lib()
    _, h, w = x.shape
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lens_warp(x.data_ptr(), out.data_ptr(), k.data_ptr(), h, w,
                           int(model), int(flags), cy, cx, rnorm, stream)
    if rc != 0:
        raise RuntimeError(f"warp: CUDA launch failed ({rc})")
    with COUNT_LOCK:
        LAUNCHES += 1
        MAP_LAUNCHES["lens"] += 1
    return out
