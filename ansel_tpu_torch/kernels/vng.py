"""VNG demosaic: Bayer VNG4 and 3-colour X-Trans VNG
(`ansel_tpu/kernels/vng.py`).

Behavioural reference: `ansel/src/iop/demosaic/vng.c` (the dcraw
`terms`/`chood` tables :38-56; the per-class precompute :90-129; the
gradient sums, threshold and masked neighbour average :131-185; the
G1/G2 mix :195-199) and its bilinear pre-pass `lin_interpolate`
(`demosaic/basic.c:22-120`).

The host class tables are the JAX package's, in numpy and plain Python.
The JAX function computes every class's terms on the whole frame and
keeps each class's pixels with `where(pos == class, ...)`; XLA fuses that
into one pass.  Eager torch would compute every plane once per class (36
times for X-Trans) and hold the cross-class cache of difference planes at
once.  Here each class runs on its own lattice instead: the sites
(row + p i, col + p j) of the period p (2 for Bayer, 6 for X-Trans), read
as strided views `padded[m + row + dy :: p, m + col + dx :: p]` of the
edge-padded planes, and its results are written into the output planes
by the same strides.  Each pixel so sees the float32 operations of the
JAX function in its order, and the difference cache lives inside one
class.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.types import CFAPattern
from ..pixel.shifts import pad2d

# dcraw-heritage VNG term table: (y1, x1, y2, x2, weight, gradient bits)
_TERMS = [
    (-2, -2, 0, -1, 1, 0x01), (-2, -2, 0, 0, 2, 0x01),
    (-2, -1, -1, 0, 1, 0x01), (-2, -1, 0, -1, 1, 0x02),
    (-2, -1, 0, 0, 1, 0x03), (-2, -1, 0, 1, 2, 0x01),
    (-2, 0, 0, -1, 1, 0x06), (-2, 0, 0, 0, 2, 0x02),
    (-2, 0, 0, 1, 1, 0x03), (-2, 1, -1, 0, 1, 0x04),
    (-2, 1, 0, -1, 2, 0x04), (-2, 1, 0, 0, 1, 0x06),
    (-2, 1, 0, 1, 1, 0x02), (-2, 2, 0, 0, 2, 0x04),
    (-2, 2, 0, 1, 1, 0x04), (-1, -2, -1, 0, 1, 0x80),
    (-1, -2, 0, -1, 1, 0x01), (-1, -2, 1, -1, 1, 0x01),
    (-1, -2, 1, 0, 2, 0x01), (-1, -1, -1, 1, 1, 0x88),
    (-1, -1, 1, -2, 1, 0x40), (-1, -1, 1, -1, 1, 0x22),
    (-1, -1, 1, 0, 1, 0x33), (-1, -1, 1, 1, 2, 0x11),
    (-1, 0, -1, 2, 1, 0x08), (-1, 0, 0, -1, 1, 0x44),
    (-1, 0, 0, 1, 1, 0x11), (-1, 0, 1, -2, 2, 0x40),
    (-1, 0, 1, -1, 1, 0x66), (-1, 0, 1, 0, 2, 0x22),
    (-1, 0, 1, 1, 1, 0x33), (-1, 0, 1, 2, 2, 0x10),
    (-1, 1, 1, -1, 2, 0x44), (-1, 1, 1, 0, 1, 0x66),
    (-1, 1, 1, 1, 1, 0x22), (-1, 1, 1, 2, 1, 0x10),
    (-1, 2, 0, 1, 1, 0x04), (-1, 2, 1, 0, 2, 0x04),
    (-1, 2, 1, 1, 1, 0x04), (0, -2, 0, 0, 2, 0x80),
    (0, -1, 0, 1, 2, 0x88), (0, -1, 1, -2, 1, 0x40),
    (0, -1, 1, 0, 1, 0x11), (0, -1, 2, -2, 1, 0x40),
    (0, -1, 2, -1, 1, 0x20), (0, -1, 2, 0, 1, 0x30),
    (0, -1, 2, 1, 2, 0x10), (0, 0, 0, 2, 2, 0x08),
    (0, 0, 2, -2, 2, 0x40), (0, 0, 2, -1, 1, 0x60),
    (0, 0, 2, 0, 2, 0x20), (0, 0, 2, 1, 1, 0x30),
    (0, 0, 2, 2, 2, 0x10), (0, 1, 1, 0, 1, 0x44),
    (0, 1, 1, 2, 1, 0x10), (0, 1, 2, -1, 2, 0x40),
    (0, 1, 2, 0, 1, 0x60), (0, 1, 2, 1, 1, 0x20),
    (0, 1, 2, 2, 1, 0x10), (1, -2, 1, 0, 1, 0x80),
    (1, -1, 1, 1, 1, 0x88), (1, 0, 1, 2, 1, 0x08),
    (1, 0, 2, -1, 1, 0x40), (1, 0, 2, 1, 1, 0x10),
]
_CHOOD = [(-1, -1), (-1, 0), (-1, 1), (0, 1),
          (1, 1), (1, 0), (1, -1), (0, -1)]

# how far from an output pixel the mosaic decides it, Bayer and X-Trans
# alike: 1 for the bilinear fill, 2 for the terms' and the neighbour
# average's offsets
REACH = 3

# dcraw filters words, by the Bayer pattern's name
_FILTERS = {"RGGB": 0x94949494, "BGGR": 0x16161616, "GRBG": 0x61616161,
            "GBRG": 0x49494949}


def _fc(filters, row, col):
    return (filters >> ((((row << 1) & 14) + (col & 1)) << 1)) & 3


def _filters4(filters):
    # greens split into colours 1 and 3 (vng.c:66-73)
    if (filters & 3) == 1:
        return filters | 0x03030303
    return filters | 0x0C0C0C0C


def _tables(fc, period: int):
    """The vng.c:90-129 precompute for each (row % period, col % period)
    class: (row, col, terms, chood, centre colour) with terms =
    ((colour, (y1, x1), (y2, x2), weight, gradients), ...) and chood =
    (((y, x), pair), ...)."""
    classes = []
    for row in range(period):
        for col in range(period):
            terms = []
            for (y1, x1, y2, x2, wt, grads) in _TERMS:
                color = fc(row + y1, col + x1)
                if fc(row + y2, col + x2) != color:
                    continue
                diag = 2 if (fc(row, col + 1) == color
                             and fc(row + 1, col) == color) else 1
                if abs(y1 - y2) == diag and abs(x1 - x2) == diag:
                    continue
                gs = tuple(g for g in range(8) if grads & (1 << g))
                terms.append((color, (y1, x1), (y2, x2), wt, gs))
            center = fc(row, col)
            chood = tuple(((y, x), fc(row + y, col + x) != center
                           and fc(row + 2 * y, col + 2 * x) == center)
                          for (y, x) in _CHOOD)
            classes.append((row, col, tuple(terms), chood, center))
    return classes


@functools.lru_cache(maxsize=None)
def _class_tables(cfa: CFAPattern):
    """The four Bayer classes, greens split into colours 1 and 3."""
    f4 = _filters4(_FILTERS[cfa.name])
    return _tables(lambda r, c: _fc(f4, r, c), 2)


def _xtrans_fc(xtrans):
    pat = np.asarray(xtrans, dtype=np.int64).reshape(6, 6)
    return lambda r, c: int(pat[r % 6, c % 6])


@functools.lru_cache(maxsize=None)
def _xtrans_class_tables(xtrans: tuple):
    """The 36 classes of a 6x6 X-Trans pattern (vng.c:61-63: prow = pcol
    = 6, colours = 3)."""
    return _tables(_xtrans_fc(xtrans), 6)


class _Lattice:
    """Strided views of (..., H, W) planes padded by `margin` at the
    sites (row + p i, col + p j) of an (H, W) frame."""

    def __init__(self, h: int, w: int, row: int, col: int, p: int,
                 margin: int):
        self.row, self.col, self.p, self.m = row, col, p, margin
        self.nr = len(range(row, h, p))
        self.nc = len(range(col, w, p))

    def at(self, padded, dy: int, dx: int):
        y0 = self.m + self.row + dy
        x0 = self.m + self.col + dx
        p = self.p
        return padded[..., y0:y0 + p * (self.nr - 1) + 1:p,
                      x0:x0 + p * (self.nc - 1) + 1:p]

    def put(self, out, value):
        """Write `value` at this lattice's sites of `out` (..., H, W)."""
        out[..., self.row::self.p, self.col::self.p] = value


def _lin_interpolate(x: torch.Tensor, fc, colors: int, period: int):
    """The bilinear fill (basic.c:22-120): each missing colour the mean
    of its same-colour 3x3 neighbours weighted by adjacency, 1 << ((dy ==
    0) + (dx == 0)) (basic.c:86).  -> (colors, H, W)."""
    h, w = x.shape
    px = pad2d(x, 1)
    planes = torch.empty((colors, h, w), dtype=x.dtype, device=x.device)
    for row in range(period):
        for col in range(period):
            lat = _Lattice(h, w, row, col, period, 1)
            if lat.nr == 0 or lat.nc == 0:
                continue
            for c in range(colors):
                if fc(row, col) == c:
                    lat.put(planes[c], lat.at(px, 0, 0))
                    continue
                offs = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                        if (dy, dx) != (0, 0) and fc(row + dy, col + dx) == c]
                ws = [float(1 << ((dy == 0) + (dx == 0))) for dy, dx in offs]
                v = sum(wt * lat.at(px, dy, dx)
                        for wt, (dy, dx) in zip(ws, offs)) / sum(ws)
                lat.put(planes[c], v)
    return planes


def _vng(x: torch.Tensor, planes: torch.Tensor, classes, period: int):
    """The gradient, threshold and neighbour-average pass (vng.c:131-185)
    over every class's lattice: -> (colors, H, W), signed (the reference's
    vng_interpolate does not clamp)."""
    h, w = x.shape
    colors = planes.shape[0]
    pp = pad2d(planes, 2)
    out = torch.empty_like(planes)
    for (row, col, terms, chood, center) in classes:
        lat = _Lattice(h, w, row, col, period, 2)
        if lat.nr == 0 or lat.nc == 0:
            continue
        zero = torch.zeros((lat.nr, lat.nc), dtype=x.dtype, device=x.device)
        gv = [None] * 8
        diff_cache = {}
        for (color, o1, o2, wt, gs) in terms:
            key = (color, o1, o2)
            if key not in diff_cache:
                diff_cache[key] = torch.abs(lat.at(pp[color], *o1)
                                            - lat.at(pp[color], *o2))
            d = diff_cache[key] * float(wt)
            for g in gs:
                gv[g] = d if gv[g] is None else gv[g] + d
        del diff_cache
        gv = [v if v is not None else zero for v in gv]
        gmin = functools.reduce(torch.minimum, gv)
        gmax = functools.reduce(torch.maximum, gv)
        thold = gmin + gmax * 0.5
        csum = [zero] * colors
        cnum = zero
        for g, ((dy, dx), pair) in enumerate(chood):
            ok = (gv[g] <= thold).to(x.dtype)
            cnum = cnum + ok
            for c in range(colors):
                if c == center and pair:
                    contrib = 0.5 * (lat.at(pp[c], 0, 0)
                                     + lat.at(pp[c], 2 * dy, 2 * dx))
                else:
                    contrib = lat.at(pp[c], dy, dx)
                csum[c] = csum[c] + ok * contrib
        safe_num = torch.clamp(cnum, min=1.0)
        pixc = lat.at(pp[center], 0, 0)
        flat = gmax == 0.0
        for c in range(colors):
            if c == center:
                tot = pixc
            else:
                tot = pixc + (csum[c] - csum[center]) / safe_num
                tot = torch.where(flat, lat.at(pp[c], 0, 0), tot)
            lat.put(out[c], tot)
    return out


def lin_interpolate4(x: torch.Tensor, cfa: CFAPattern) -> torch.Tensor:
    """The Bayer bilinear fill in four colours (greens split):
    -> (4, H, W)."""
    f4 = _filters4(_FILTERS[cfa.name])
    return _lin_interpolate(x, lambda r, c: _fc(f4, r, c), 4, 2)


def vng4_demosaic(x: torch.Tensor, cfa: CFAPattern) -> torch.Tensor:
    """(H, W) Bayer mosaic -> (3, H, W) via VNG4, the two greens mixed at
    the end (vng.c:195-199), no clamp."""
    out4 = _vng(x, lin_interpolate4(x, cfa), _class_tables(cfa), 2)
    return torch.stack([out4[0], 0.5 * (out4[1] + out4[3]), out4[2]])


def xtrans_lin_interpolate(x: torch.Tensor, xtrans) -> torch.Tensor:
    """The bilinear fill over the 6x6 pattern in three colours (every 3x3
    window of an X-Trans mosaic holds all three): -> (3, H, W)."""
    return _lin_interpolate(x, _xtrans_fc(tuple(xtrans)), 3, 6)


def xtrans_vng_demosaic(x: torch.Tensor, xtrans) -> torch.Tensor:
    """(H, W) X-Trans mosaic -> (3, H, W) via 3-colour VNG
    (vng_interpolate with filters == 9), no green mixing and no clamp:
    method XTRANS | 0 alone and the low band of X-Trans dual."""
    xtrans = tuple(int(v) for v in xtrans)
    return _vng(x, xtrans_lin_interpolate(x, xtrans),
                _xtrans_class_tables(xtrans), 6)
