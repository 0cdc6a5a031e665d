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
`xtrans_markesteijn_reference` for a CPU tensor.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..ops._bayer import tile6, xtrans_period

PAD = 24
# scratch planes of the padded frame: gmin/gmax, one G set, one R/B set
# and 8 planes of temporaries for 1 pass; a second G/R/B set, a G set
# between the two recalculation steps, 8 derivative and 8 count planes
# for 3 passes
PLANES = {1: 22, 3: 54}

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


def _vote(x, G, R, B):
    dirs = [(0, 1), (1, 0), (1, 1), (1, -1)]
    ndir = len(G)
    drv = []
    for d in range(ndir):
        y = 0.2627 * R[d] + 0.6780 * G[d] + 0.0593 * B[d]
        u = (B[d] - y) * 0.56433
        v = (R[d] - y) * 0.67815
        dy, dx = dirs[d % 4]
        dd = 0.0
        for ch in (y, u, v):
            t = 2 * ch - _sh(ch, dy, dx) - _sh(ch, -dy, -dx)
            dd = dd + t * t
        drv.append(dd)
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


def _lib():
    from . import _build

    lib = _build.load("markesteijn")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.markesteijn.argtypes = [p, p, p, i, i, i, i, p, p]
        lib.markesteijn.restype = ctypes.c_int
        lib._typed = True
    return lib


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
    if passes not in PLANES:
        raise ValueError(f"markesteijn: passes {passes} is not 1 or 3")
    pattern6 = tuple(int(c) for c in pattern6)
    if len(pattern6) != 36 or any(c not in (0, 1, 2) for c in pattern6):
        raise ValueError(f"markesteijn: bad X-Trans pattern {pattern6}")
    global LAUNCHES
    lib = _lib()
    h, w = x.shape
    scratch = torch.empty((PLANES[passes], h + 2 * PAD, w + 2 * PAD),
                          dtype=x.dtype, device=x.device)
    out = torch.empty((3, h, w), dtype=x.dtype, device=x.device)
    table = geometry_table(pattern6)
    host_table = (ctypes.c_int * len(table))(*table)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.markesteijn(x.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                             h, w, passes, PAD, host_table, stream)
    if rc != 0:
        raise RuntimeError(f"markesteijn: CUDA launch failed ({rc})")
    LAUNCHES += 1
    return out
