"""X-Trans Markesteijn demosaic, 1 or 3 passes: the CUDA kernel
(`csrc/markesteijn.cu`) and its plain twin.

Both compute what `ansel_tpu/kernels/markesteijn_pallas.py:
xtrans_markesteijn_pallas` computes on the TPU (reference
`src/iop/demosaic/markesteijn.c`): on an (H, W) X-Trans mosaic, the green
min/max over the hex ring, four directional greens, per direction the
solitary-green R/B, R@B / B@R and 2x2-green fills, for 3 passes two green
recalculation sweeps with a fresh R/B set each, then the YPbPr
derivatives, a 3x3 homogeneity count, its 5x5 sum and the vote over 4 or
8 directions.  Operation for operation in the Pallas kernel's order (not
that of the whole-image `ansel_tpu/kernels/markesteijn.py`, which fills
the 2x2 greens differently).

Like the Pallas kernel, both edge-pad the mosaic by `PAD` and take each
pixel's CFA class from its image coordinate, so the pad carries the wrong
colours as the TPU's does; the result reaches at most 11 px, well inside
the pad, so it is exactly a function of the edge-extended frame.  PAD is
a multiple of 6, so a padded coordinate has the image coordinate's phase.

`xtrans_markesteijn` launches the kernel for a CUDA tensor and runs
`xtrans_markesteijn_reference` for a CPU tensor.  The kernel is one
launch: a block owns a TILE_H x TILE_W output tile, and its two thread
groups run two of the four direction chains each in shared memory, each
step over the tile widened by the margin `kernel_plan` derives from the
stencils (`_needed_margins`), then the vote.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops._bayer import tile6, xtrans_period
from ._build import COUNT_LOCK

PAD = 24

# launch geometry of csrc/markesteijn.cu, which checks every planned size:
# the output tile of a block, its threads per pass count, the shared
# memory a block may have on sm_90
TILE_H = TILE_W = 32
THREADS = {1: 512, 3: 1024}
MAX_SMEM = 232448
# the steps of one direction chain, in the order the kernel runs them:
# G the greens (G1; for 3 passes G2, G3 from the recalculation's second
# step), A its first step, S the R/B planes with the solitary-green
# estimates, O the R@B / B@R fill, F the 2x2-green fill (the set's final
# R/B)
STEPS = {1: ("G1", "S1", "O1", "F1"),
         3: ("G1", "S1", "O1", "F1", "A2", "G2", "S2", "O2", "F2",
             "A3", "G3", "S3", "O3", "F3")}
# the recalculation of buffer i: first (hex direction, on solitary-green
# rows) = RECALC[0][i], then RECALC[1][i] (direction 0: a copy)
RECALC = (((3, 1), (3, 0), (4, 0), (4, 1)), ((0, 0), (0, 0), (5, 1), (5, 0)))
# the derivative's direction of buffer d
DIRS = ((0, 1), (1, 0), (1, 1), (1, -1))
# the vote reads the counts 2 px away, the counts the derivatives 1 px
# further
CNT_MARGIN, DRV_MARGIN = 2, 3

# launches of the CUDA kernel since the count was last set to 0
LAUNCHES = 0

# hex geometry (markesteijn.c:75-105), copied from
# ansel_tpu/kernels/markesteijn.py
ORTH = [1, 0, 0, 1, -1, 0, 0, -1, 1, 0, 0, 1]
PATT = [
    [0, 1, 0, -1, 2, 0, -1, 0, 1, 1, 1, -1, 0, 0, 0, 0],
    [0, 1, 0, -2, 1, 0, -2, 0, 1, 1, -2, -2, 1, -1, -1, 1],
]


def _color_at(pattern6, r, c):
    return pattern6[(r % 6) * 6 + (c % 6)]


def build_hex_tables(pattern6):
    """allhex[(r%3, c%3)][k] = (dy, dx); plus (sgrow, sgcol)
    (markesteijn.c:75-105)."""
    allhex = {}
    sgrow = sgcol = 0
    for row in range(3):
        for col in range(3):
            hexes = [(0, 0)] * 8
            ng = 0
            for d in range(0, 10, 2):
                g = 1 if _color_at(pattern6, row, col) == 1 else 0
                if _color_at(pattern6, row + ORTH[d],
                             col + ORTH[d + 2]) == 1:
                    ng = 0
                else:
                    ng += 1
                if ng == 4:
                    sgrow, sgcol = row, col
                if ng == g + 1:
                    for c in range(8):
                        v = ORTH[d] * PATT[g][c * 2] \
                            + ORTH[d + 1] * PATT[g][c * 2 + 1]
                        h = ORTH[d + 2] * PATT[g][c * 2] \
                            + ORTH[d + 3] * PATT[g][c * 2 + 1]
                        hexes[c ^ (g * 2 & d)] = (v, h)
            allhex[(row, col)] = hexes
    return allhex, sgrow, sgcol


def _pair_nonzero(hexes, k):
    """hex_pair_mask's static predicate: hex k + hex k+1 != (0, 0)."""
    return (hexes[k][0] + hexes[k + 1][0], hexes[k][1] + hexes[k + 1][1]) \
        != (0, 0)


def _sh(a, dy, dx):
    """a[y + dy, x + dx], wrapping at the padded frame's edge (the wrapped
    values stay in the pad that is cropped)."""
    if dy:
        a = torch.roll(a, -dy, 0)
    if dx:
        a = torch.roll(a, -dx, 1)
    return a


class _Geo:
    """Class and colour masks of the padded (hp, wp) frame."""

    def __init__(self, pattern6, hp, wp, device):
        self.allhex, sgrow, sgcol = build_hex_tables(pattern6)
        py = torch.arange(hp, device=device)[:, None]
        px = torch.arange(wp, device=device)[None, :]
        self.cls = {(a, b): (py % 3 == a) & (px % 3 == b)
                    for a in range(3) for b in range(3)}
        period = xtrans_period(pattern6, device)
        color = tile6(period, hp, wp)
        self.is_g, self.is_r, self.is_b = color == 1, color == 0, color == 2
        row_sg = ((py - sgrow) % 3 == 0).expand(hp, wp)
        col_sg = ((px - sgcol) % 3 == 0).expand(hp, wp)
        self.row_sg = row_sg
        self.sg = row_sg & col_sg & self.is_g
        self.g22 = (~row_sg) & (~col_sg) & self.is_g
        # colour of the right neighbour by its phase, for the sg chroma order
        self.right_red = tile6(torch.roll(period, -1, 1), hp, wp) == 0

    def hex_read(self, a, k, mult=1, neg=False):
        out = None
        for ccls, hexes in self.allhex.items():
            dy, dx = hexes[k]
            dy, dx = dy * mult, dx * mult
            if neg:
                dy, dx = -dy, -dx
            v = _sh(a, dy, dx)
            out = v if out is None else torch.where(self.cls[ccls], v, out)
        return out

    def hex_pair_mask(self, k):
        mask = torch.zeros_like(self.is_g)
        for ccls, hexes in self.allhex.items():
            if _pair_nonzero(hexes, k):
                mask = mask | self.cls[ccls]
        return mask


def _clip(v, lo, hi):
    return torch.minimum(torch.maximum(v, lo), hi)


def _green_dirs(geo, x, gmin, gmax):
    g_h0 = geo.hex_read(x, 0)
    g_h1 = geo.hex_read(x, 1)
    g_h0x2 = geo.hex_read(x, 0, mult=2)
    g_h1x2 = geo.hex_read(x, 1, mult=2)
    color0 = 0.6796875 * (g_h1 + g_h0) - 0.1796875 * (g_h1x2 + g_h0x2)
    g_h2 = geo.hex_read(x, 2)
    g_h3 = geo.hex_read(x, 3)
    f_mh2 = geo.hex_read(x, 2, neg=True)
    color1 = 0.87109375 * g_h3 + 0.13 * g_h2 + 0.359375 * (x - f_mh2)
    colors = [color0, color1]
    for c in range(2):
        g_h4c = geo.hex_read(x, 4 + c)
        g_mh4c2 = geo.hex_read(x, 4 + c, mult=2, neg=True)
        f_p3 = geo.hex_read(x, 4 + c, mult=3)
        f_m3 = geo.hex_read(x, 4 + c, mult=3, neg=True)
        colors.append(0.640625 * g_h4c + 0.359375 * g_mh4c2
                      + 0.12890625 * (2 * x - f_p3 - f_m3))
    G = []
    for d in range(4):
        cand = torch.where(geo.row_sg, colors[d ^ 1], colors[d])
        G.append(torch.where(geo.is_g, x, _clip(cand, gmin, gmax)))
    return G


def _sg_rb(geo, x, G, R, B):
    ests, diffs = {}, {}
    for d in range(6):
        axis_h = d % 2 == 0
        gd = G[(0, 1, 2, 2, 3, 3)[d]]
        near = far = None
        diff = 0.0
        for dist in (1, 2):
            dy, dx = (0, dist) if axis_h else (dist, 0)
            gp, gm = _sh(gd, dy, dx), _sh(gd, -dy, -dx)
            fp, fm = _sh(x, dy, dx), _sh(x, -dy, -dx)
            gterm = 2 * gd - gp - gm
            est = gterm + fp + fm
            if dist == 1:
                near = est
            else:
                far = est
            if d > 1:
                t = gp - gm - fp + fm
                diff = diff + t * t + gterm * gterm
        base_is_red = geo.right_red if axis_h else ~geo.right_red
        ests[d] = (torch.where(base_is_red, near, far),
                   torch.where(base_is_red, far, near))
        diffs[d] = diff

    def put(i, r_est, b_est):
        R[i] = torch.where(geo.sg, r_est / 2.0, R[i])
        B[i] = torch.where(geo.sg, b_est / 2.0, B[i])

    put(0, *ests[0])
    put(1, *ests[1])
    pick23 = diffs[2] < diffs[3]
    put(2, torch.where(pick23, ests[2][0], ests[3][0]),
        torch.where(pick23, ests[2][1], ests[3][1]))
    pick45 = diffs[4] < diffs[5]
    put(3, torch.where(pick45, ests[4][0], ests[5][0]),
        torch.where(pick45, ests[4][1], ests[5][1]))


def _rb_opposite(geo, G, R, B):
    row_sg = geo.row_sg
    for d in range(4):
        gd = G[d]

        def interp(plane, dy, dx):
            pp, pm = _sh(plane, dy, dx), _sh(plane, -dy, -dx)
            gp, gm = _sh(gd, dy, dx), _sh(gd, -dy, -dx)
            return (pp + pm + 2.0 * gd - gp - gm) / 2.0

        grad_c = torch.where(
            row_sg,
            (gd - _sh(gd, 0, 1)).abs() + (gd - _sh(gd, 0, -1)).abs(),
            (gd - _sh(gd, 1, 0)).abs() + (gd - _sh(gd, -1, 0)).abs())
        grad_h = torch.where(
            row_sg,
            (gd - _sh(gd, 3, 0)).abs() + (gd - _sh(gd, -3, 0)).abs(),
            (gd - _sh(gd, 0, 3)).abs() + (gd - _sh(gd, 0, -3)).abs())
        parity_ok = row_sg if d % 2 == 0 else ~row_sg
        use_c = None if d > 1 else parity_ok | (grad_c < 2.0 * grad_h)
        for planes, own in ((R, geo.is_r), (B, geo.is_b)):
            plane = planes[d]
            val = torch.where(row_sg, interp(plane, 0, 1), interp(plane, 1, 0))
            if use_c is not None:
                v_h = torch.where(row_sg, interp(plane, 3, 0),
                                  interp(plane, 0, 3))
                val = torch.where(use_c, val, v_h)
            site = (~geo.is_g) & (~own) & (~geo.sg)
            planes[d] = torch.where(site, val, plane)


def _three(x):
    # a tensor divisor: a CUDA tensor divided by a Python float is
    # multiplied by its reciprocal, which rounds differently
    return torch.full((), 3.0, dtype=x.dtype, device=x.device)


def _g22_fill(geo, G, R, B):
    three = _three(G[0])
    for i in range(4):
        k = 2 * i
        gd = G[i]
        pair = geo.hex_pair_mask(k)
        g_h0 = geo.hex_read(gd, k)
        g_h1 = geo.hex_read(gd, k + 1)
        for planes in (R, B):
            p = planes[i]
            p_h0 = geo.hex_read(p, k)
            p_h1 = geo.hex_read(p, k + 1)
            v_pair = ((3.0 * gd - 2.0 * g_h0 - g_h1) + 2.0 * p_h0 + p_h1) / three
            v_line = ((2.0 * gd - g_h0 - g_h1) + p_h0 + p_h1) / 2.0
            planes[i] = torch.where(geo.g22,
                                    torch.where(pair, v_pair, v_line), p)


def _one_set(geo, x, G):
    zero = torch.zeros_like(x)
    R = [torch.where(geo.is_r, x, zero) for _ in range(4)]
    B = [torch.where(geo.is_b, x, zero) for _ in range(4)]
    _sg_rb(geo, x, G, R, B)
    _rb_opposite(geo, G, R, B)
    _g22_fill(geo, G, R, B)
    return R, B


def _green_recalc(geo, x, G, R, B, gmin, gmax):
    """Buffers 0-3 by d = 3, 4 (d - 2 on rows off the solitary-green row,
    (d - 2) ^ 1 on it), then buffers 2-3 again by d = 5."""
    flip = geo.row_sg
    three = _three(x)
    newG = list(G)
    for d in range(3, 6):
        for bi, rows in ((d - 2, ~flip), ((d - 2) ^ 1, flip)):
            own = torch.where(geo.is_r, R[bi], B[bi])
            g_h = geo.hex_read(newG[bi], d)
            g_m2h = geo.hex_read(newG[bi], d, mult=2, neg=True)
            f_h = geo.hex_read(own, d)
            f_m2h = geo.hex_read(own, d, mult=2, neg=True)
            val = (g_m2h + 2.0 * g_h - f_m2h - 2.0 * f_h + 3.0 * x) / three
            val = _clip(val, gmin, gmax)
            newG[bi] = torch.where(rows & (~geo.is_g), val, newG[bi])
    return newG


def _derivative(G, R, B, d):
    """The YPbPr second derivative of buffer d along DIRS[d % 4]."""
    y = 0.2627 * R[d] + 0.6780 * G[d] + 0.0593 * B[d]
    u = (B[d] - y) * 0.56433
    v = (R[d] - y) * 0.67815
    dy, dx = DIRS[d % 4]
    dd = 0.0
    for ch in (y, u, v):
        t = 2 * ch - _sh(ch, dy, dx) - _sh(ch, -dy, -dx)
        dd = dd + t * t
    return dd


def _vote(x, G, R, B):
    ndir = len(G)
    drv = [_derivative(G, R, B, d) for d in range(ndir)]
    tr = functools.reduce(torch.minimum, drv) * 8.0
    homos = []
    for d in range(ndir):
        cnt = 0.0
        for vv in (-1, 0, 1):
            for hh in (-1, 0, 1):
                cnt = cnt + (_sh(drv[d], vv, hh) <= tr).to(x.dtype)
        acc = 0.0
        for vv in range(-2, 3):
            for hh in range(-2, 3):
                acc = acc + _sh(cnt, vv, hh)
        homos.append(acc)
    maxval = functools.reduce(torch.maximum, homos)
    thresh = maxval - maxval / 8.0
    num_r = num_g = num_b = den = 0.0
    for d in range(ndir):
        sel = (homos[d] >= thresh).to(x.dtype)
        num_r = num_r + sel * R[d]
        num_g = num_g + sel * G[d]
        num_b = num_b + sel * B[d]
        den = den + sel
    den = torch.clamp(den, min=1.0)
    return torch.stack([num_r / den, num_g / den, num_b / den])


def xtrans_markesteijn_reference(x: torch.Tensor, pattern6,
                                 passes: int = 1) -> torch.Tensor:
    """Plain torch: (H, W) X-Trans mosaic -> (3, H, W), max(., 0)."""
    h, w = x.shape
    xp = F.pad(x[None, None], (PAD, PAD, PAD, PAD), mode="replicate")[0, 0]
    geo = _Geo(tuple(pattern6), h + 2 * PAD, w + 2 * PAD, x.device)
    gvals = [geo.hex_read(xp, k) for k in range(6)]
    gmin = functools.reduce(torch.minimum, gvals)
    gmax = functools.reduce(torch.maximum, gvals)
    G = _green_dirs(geo, xp, gmin, gmax)
    R, B = _one_set(geo, xp, G)
    if passes == 3:
        G2, R2, B2 = G, R, B
        for _ in range(2):
            G2 = _green_recalc(geo, xp, G2, R2, B2, gmin, gmax)
            R2, B2 = _one_set(geo, xp, G2)
        G, R, B = G + G2, R + R2, B + B2
    out = _vote(xp, G, R, B)[:, PAD:PAD + h, PAD:PAD + w]
    return torch.clamp(out, min=0.0).contiguous()


def geometry_table(pattern6):
    """The kernel's geometry, 9 x 8 (dy, dx) hex offsets by class
    (row % 3) * 3 + col % 3, then sgrow, sgcol, the 9 x 4 hex-pair flags
    and the 36 colours: a list of ints."""
    allhex, sgrow, sgcol = build_hex_tables(pattern6)
    hexes = [allhex[(r, c)] for r in range(3) for c in range(3)]
    table = [v for hx in hexes for off in hx for v in off]
    table += [sgrow, sgcol]
    table += [int(_pair_nonzero(hx, 2 * i)) for hx in hexes for i in range(4)]
    return table + [int(c) for c in pattern6]


def _shift_or(dst, mask, dy, dx):
    """dst[y + dy, x + dx] |= mask[y, x], inside the array."""
    n, m = mask.shape
    dst[max(0, dy):n + min(0, dy), max(0, dx):m + min(0, dx)] |= \
        mask[max(0, -dy):n - max(0, dy), max(0, -dx):m - max(0, dx)]


def _needed_margins(pattern6, passes):
    """For each plane of a direction chain and each buffer d, how far
    outside an output tile the kernel must compute it: a backward walk of
    the chain's reads from the tile's outputs, class by class, over the
    36 phases a tile origin can have.  A step reads only the offsets its
    sites read (the union over data-dependent choices).  -> {(plane, d):
    margin}, with plane "X" the mosaic the block loads."""
    allhex, sgrow, sgcol = build_hex_tables(pattern6)
    pat = np.asarray(pattern6).reshape(6, 6)
    hexes = [allhex[(c // 3, c % 3)] for c in range(9)]
    t, pad = 6, 32
    n = t + 2 * pad
    sets = (1,) if passes == 1 else (1, 2, 3)
    final = (1,) if passes == 1 else (1, 3)
    box = [(a, b) for a in range(-1, 2) for b in range(-1, 2)]
    vote = [(a, b) for a in range(-2, 3) for b in range(-2, 3)]
    # the green candidates' reads (hex k, multiple) by candidate
    cand = {0: [(0, 1), (1, 1), (0, 2), (1, 2)], 1: [(3, 1), (2, 1), (2, -1)],
            2: [(4, 1), (4, -2), (4, 3), (4, -3)],
            3: [(5, 1), (5, -2), (5, 3), (5, -3)]}
    out = {}
    for oy in range(6):
        for ox in range(6):
            yy = (np.arange(n) - pad + oy)[:, None] % 6
            xx = (np.arange(n) - pad + ox)[None, :] % 6
            cls = np.broadcast_to((yy % 3) * 3 + xx % 3, (n, n))
            green = pat[yy, xx] == 1
            rsg = np.broadcast_to(yy % 3 == sgrow, (n, n))
            csg = np.broadcast_to(xx % 3 == sgcol, (n, n))
            sg, g22 = green & rsg & csg, green & ~rsg & ~csg
            for d in range(4):
                need = {}

                def get(plane):
                    return need.setdefault(plane, np.zeros((n, n), bool))

                def add(plane, mask, offs):
                    dst = get(plane)
                    for dy, dx in offs:
                        _shift_or(dst, mask, dy, dx)

                def add_hex(plane, mask, specs):
                    for c in range(9):
                        cm = mask & (cls == c)
                        if cm.any():
                            add(plane, cm, [(s * hexes[c][k][0],
                                             s * hexes[c][k][1])
                                            for k, s in specs])

                tile = np.zeros((n, n), bool)
                tile[pad:pad + t, pad:pad + t] = True
                cnt = get("C")
                for dy, dx in vote:
                    _shift_or(cnt, tile, dy, dx)
                dy, dx = DIRS[d]
                for k in final:
                    drv = get(f"D{k}")
                    for a, b in box:
                        _shift_or(drv, cnt, a, b)
                    add(f"F{k}", tile | drv, [(0, 0), (dy, dx), (-dy, -dx)])
                    add(f"G{k}", tile | drv, [(0, 0), (dy, dx), (-dy, -dx)])
                for k in reversed(sets):
                    fin = get(f"F{k}")
                    add(f"O{k}", fin, [(0, 0)])
                    add(f"G{k}", fin & g22, [(0, 0)])
                    for plane in (f"O{k}", f"G{k}"):
                        add_hex(plane, fin & g22, [(2 * d, 1), (2 * d + 1, 1)])
                    opp = get(f"O{k}")
                    add(f"S{k}", opp, [(0, 0)])
                    add(f"G{k}", opp & ~green, [(0, 0)])
                    for row_sg in (True, False):
                        m = opp & ~green & (rsg if row_sg else ~rsg)
                        offs = [(0, 1), (0, -1)] if row_sg else [(1, 0), (-1, 0)]
                        if d <= 1:
                            offs += [(3, 0), (-3, 0)] if row_sg \
                                else [(0, 3), (0, -3)]
                        add(f"G{k}", m, offs)
                        add(f"S{k}", m, offs)
                    srb = get(f"S{k}")
                    add("X", srb, [(0, 0)])
                    offs = []
                    if d != 1:
                        offs += [(0, 1), (0, -1), (0, 2), (0, -2)]
                    if d != 0:
                        offs += [(1, 0), (-1, 0), (2, 0), (-2, 0)]
                    add("X", srb & sg, offs)
                    add(f"G{k}", srb & sg, offs)
                    gk = get(f"G{k}")
                    if k == 1:
                        add("X", gk, [(0, 0)])
                        for row_sg in (True, False):
                            m = gk & ~green & (rsg if row_sg else ~rsg)
                            add_hex("X", m, [(j, 1) for j in range(6)]
                                    + cand[d ^ 1 if row_sg else d])
                        continue
                    for dst, src, (hd, sense) in (
                            (f"G{k}", f"A{k}", RECALC[1][d]),
                            (f"A{k}", f"G{k - 1}", RECALC[0][d])):
                        m = get(dst)
                        add(src, m, [(0, 0)])
                        if hd == 0:
                            continue
                        m = m & ~green & (rsg if sense else ~rsg)
                        add("X", m, [(0, 0)])
                        add_hex("X", m, [(j, 1) for j in range(6)])
                        for plane in (src, f"F{k - 1}"):
                            add_hex(plane, m, [(hd, 1), (hd, -2)])
                for plane, m in need.items():
                    ys, xs = np.nonzero(m)
                    far = max(pad - ys.min(), ys.max() - (pad + t - 1),
                              pad - xs.min(), xs.max() - (pad + t - 1), 0)
                    key = (plane, d)
                    out[key] = max(out.get(key, 0), int(far))
    return out


class Plan(NamedTuple):
    """One launch's geometry: threads of a block, the mosaic's halo, the
    margins of the shared planes (the mosaic, G, R/B), each step's margin
    per buffer (STEPS order), the guard floats before and after the
    planes, and the shared bytes of a block."""
    passes: int
    threads: int
    halo: int
    planes: tuple
    steps: tuple
    guard: int
    smem: int


def _area(m):
    return (TILE_H + 2 * m) * (TILE_W + 2 * m)


def in_place_ok(pattern6) -> bool:
    """Whether the kernel's in-place steps are exact for this pattern: the
    greens are a function of the class (row and column mod 3); a site
    without green never reads the plane it lacks (R at blue, B at red)
    at a site of its own colour (the R@B / B@R fill); a 2x2 green's hex
    neighbours are no 2x2 greens (their fill); and a non-green site's
    recalculation reads greens only.  True for every phase of the X-Trans
    layout."""
    pat = np.asarray(pattern6).reshape(6, 6)
    allhex, sgrow, sgcol = build_hex_tables(tuple(pattern6))

    def color(y, x):
        return pat[y % 6, x % 6]

    for y in range(6):
        for x in range(6):
            if (color(y, x) == 1) != (color(y % 3, x % 3) == 1):
                return False
            rsg, csg = y % 3 == sgrow, x % 3 == sgcol
            hx = allhex[(y % 3, x % 3)]
            if color(y, x) != 1:
                offs = [(0, 1), (3, 0)] if rsg else [(1, 0), (0, 3)]
                if any(color(y + s * dy, x + s * dx) == color(y, x)
                       for dy, dx in offs for s in (1, -1)):
                    return False
                if any(color(y + s * hx[k][0], x + s * hx[k][1]) != 1
                       for k in (3, 4, 5) for s in (1, -2)):
                    return False
            elif not rsg and not csg:
                for dy, dx in hx:
                    yy, xx = y + dy, x + dx
                    if color(yy, xx) == 1 and yy % 3 != sgrow \
                            and xx % 3 != sgcol:
                        return False
    return True


@functools.lru_cache(maxsize=None)
def kernel_plan(pattern6, passes: int) -> Plan:
    """The launch plan of csrc/markesteijn.cu for a pattern and pass count:
    the margins `_needed_margins` derives, the planes sized to the widest
    step that writes them (G: the greens and the recalculation; R/B: the
    green step's base, the solitary-green estimates and both fills, which
    update it in place),
    and the shared bytes: the guard, the float planes (the mosaic, then
    G, R and B for each of the block's two thread groups, which run their
    direction chains side by side, each of its margin's rows at the
    mosaic's row stride, so one offset addresses a hex neighbour in any
    of them; then NDIR derivative planes over the tile and 3 px; the
    counts and one group's kept values reuse the groups' planes), a byte
    per mosaic site (class, colour, solitary-green row flag) rounded up to
    whole floats, the guard, then the geometry (each class's hex offsets
    as ints, the pair flags).  A step may read outside a plane at sites no
    output needs; the guards keep such reads inside the block's memory."""
    pattern6 = tuple(int(c) for c in pattern6)
    need = _needed_margins(pattern6, passes)
    # the green step also writes the first set's R/B base, over at least
    # the solitary-green step's rectangle
    for d in range(4):
        need[("G1", d)] = max(need[("G1", d)], need[("S1", d)])
    steps = tuple(tuple(need[(s, d)] for d in range(4)) for s in STEPS[passes])
    by = dict(zip(STEPS[passes], steps))

    def widest(kind):
        return max(max(v) for s, v in by.items() if s[0] in kind)

    halo = max(need[("X", d)] for d in range(4))
    # R/B: the steps that update it, and the green step's base
    planes = (halo, widest("GA"), max(widest("SOF"), max(by["G1"])))
    ndir = 4 if passes == 1 else 8
    hex_max = max(abs(v) for hx in build_hex_tables(pattern6)[0].values()
                  for off in hx for v in off)
    reach = max(3, 3 * hex_max)  # the farthest offset a step reads
    stride = TILE_W + 2 * halo
    guard = reach * (stride + 1)

    def rows(m):
        return (TILE_H + 2 * m) * stride

    floats = (rows(planes[0]) + 2 * (rows(planes[1]) + 2 * rows(planes[2]))
              + ndir * _area(DRV_MARGIN))
    sites = -(-rows(halo) // 4)
    geo = 9 * 8 * 4 + 9 * 4
    smem = 4 * (2 * guard + floats + sites) + geo
    return Plan(passes, THREADS[passes], halo, planes, steps, guard,
                (smem + 15) // 16 * 16)


def launch_plan(h: int, w: int, pattern6, passes: int):
    """-> (blocks down, blocks across, Plan) for an (h, w) mosaic; block
    (i, j) writes output rows i TILE_H .. + TILE_H and columns j TILE_W ..
    + TILE_W that lie in the frame."""
    return -(-h // TILE_H), -(-w // TILE_W), kernel_plan(
        tuple(int(c) for c in pattern6), passes)


def _lib():
    from . import _build

    lib = _build.load("markesteijn")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.markesteijn.argtypes = [p, p, i, i, i, p, p, p]
        lib.markesteijn.restype = ctypes.c_int
        lib.markesteijn_limits.argtypes = [p] * 5
        lib.markesteijn_limits.restype = None
        got = [ctypes.c_int() for _ in range(5)]
        lib.markesteijn_limits(*[ctypes.byref(v) for v in got])
        if [v.value for v in got] != [TILE_H, TILE_W, THREADS[1],
                                      THREADS[3], MAX_SMEM]:
            raise RuntimeError("csrc/markesteijn.cu and kernels/markesteijn.py"
                               " disagree on the launch geometry")
        lib._typed = True
    return lib


def _plan_table(plan: Plan):
    """The plan as the kernel's int table: passes, threads, halo, the
    three plane margins, guard, shared bytes, then each step's margins
    for buffers 0-3."""
    vals = [plan.passes, plan.threads, plan.halo, *plan.planes, plan.guard,
            plan.smem] + [m for row in plan.steps for m in row]
    return (ctypes.c_int * len(vals))(*vals)


def xtrans_markesteijn(x: torch.Tensor, pattern6,
                       passes: int = 1) -> torch.Tensor:
    """Markesteijn on an (H, W) float32 X-Trans mosaic with the 36-colour
    pattern `pattern6`, 1 or 3 passes -> (3, H, W).  A CPU tensor runs the
    plain version; a CUDA tensor launches csrc/markesteijn.cu."""
    if x.device.type == "cpu":
        return xtrans_markesteijn_reference(x, pattern6, passes)
    if x.device.type != "cuda":
        raise ValueError(f"markesteijn: unsupported device {x.device}")
    if (x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous()
            or x.numel() == 0):
        raise ValueError("markesteijn: needs a contiguous non-empty (H, W) "
                         f"float32 tensor, got {x.dtype} {tuple(x.shape)}")
    if passes not in STEPS:
        raise ValueError(f"markesteijn: passes {passes} is not 1 or 3")
    pattern6 = tuple(int(c) for c in pattern6)
    if len(pattern6) != 36 or any(c not in (0, 1, 2) for c in pattern6) \
            or not in_place_ok(pattern6):
        raise ValueError(f"markesteijn: bad X-Trans pattern {pattern6}")
    global LAUNCHES
    lib = _lib()
    h, w = x.shape
    _, _, plan = launch_plan(h, w, pattern6, passes)
    out = torch.empty((3, h, w), dtype=x.dtype, device=x.device)
    table = geometry_table(pattern6)
    host_table = (ctypes.c_int * len(table))(*table)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.markesteijn(x.data_ptr(), out.data_ptr(), h, w, passes,
                             host_table, _plan_table(plan), stream)
    if rc != 0:
        raise RuntimeError(f"markesteijn: CUDA launch failed ({rc})")
    with COUNT_LOCK:
        LAUNCHES += 1
    return out
