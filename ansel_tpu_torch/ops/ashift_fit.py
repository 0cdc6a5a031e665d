"""ashift auto-fit: line-segment detection + Nelder-Mead homography fit.

Reference: `ansel/src/iop/ashift.c` structural-analysis path —
`line_detect` (:1429-1601: LSD over the downscaled greyscale, border-line
rejection, vertical/horizontal classification by MAX_TANGENTIAL_DEVIATION,
weight = length*width*precision), `model_fitness` (:2039-2159: forward
homography applied to line endpoints, weighted squared scalar product
with the perpendicular axis), `nmsfit` (:2162-2345: logit-bounded
parameters, simplex solve, 4x-area sanity gate) and the fit-axis flag
algebra (:245-270).  The LSD detector itself
(`ansel/src/iop/ashift_lsd.c`, von Gioi et al.) is replaced by
a vectorized equivalent: gradient level-line angles are quantized into
22.5-degree orientation bins and line-support regions are connected
components per bin (two half-offset binnings catch boundary-straddling
regions); each region yields the same rectangle summary LSD produces
(weighted centroid + principal axis, endpoint projection, width, density
gate at LSD_DENSITY_TH).  The NFA test is replaced by the magnitude
threshold rho = quant/sin(ang_th) plus the density/length gates — a
documented deviation suited to batch numpy instead of pixel-ordered
region growing.

Everything here is host-side (numpy/scipy): in the reference this runs
GUI-side on the preview buffer, not in the pixelpipe.  A copy of
`ansel_tpu/ops/ashift_fit.py` (numpy and scipy only), pointed at the
port's `ops/ashift.py` and `utils/neldermead.py`; nothing on a pipe's
path calls it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np

from ..utils.neldermead import simplex
from .ashift import AshiftParams, _homography

# ashift.c:92-118
ROTATION_RANGE = 10.0
LENSSHIFT_RANGE = 1.0
SHEAR_RANGE = 0.2
MIN_LINE_LENGTH = 5.0
MAX_TANGENTIAL_DEVIATION = 30.0
LSD_QUANT = 2.0
LSD_ANG_TH = 22.5
LSD_DENSITY_TH = 0.7
MINIMUM_FITLINES = 2
NMS_EPSILON = 1e-3
NMS_SCALE = 1.0
NMS_ITERATIONS = 400
DEFAULT_F_LENGTH = 28.0

# fit-axis flags (ashift.c:245-270)
FIT_ROTATION = 1 << 0
FIT_LENS_VERT = 1 << 1
FIT_LENS_HOR = 1 << 2
FIT_SHEAR = 1 << 3
FIT_LINES_VERT = 1 << 4
FIT_LINES_HOR = 1 << 5
FIT_VERTICALLY = FIT_ROTATION | FIT_LENS_VERT | FIT_LINES_VERT
FIT_HORIZONTALLY = FIT_ROTATION | FIT_LENS_HOR | FIT_LINES_HOR
FIT_BOTH = (FIT_ROTATION | FIT_LENS_VERT | FIT_LENS_HOR
            | FIT_LINES_VERT | FIT_LINES_HOR)
FIT_BOTH_SHEAR = FIT_BOTH | FIT_SHEAR
FIT_ROTATION_BOTH_LINES = FIT_ROTATION | FIT_LINES_VERT | FIT_LINES_HOR

# line types (ashift.c:214-225)
LINE_IRRELEVANT = 0
LINE_RELEVANT = 1 << 0
LINE_DIRVERT = 1 << 1
LINE_SELECTED = 1 << 2
LINE_MASK = LINE_RELEVANT | LINE_DIRVERT | LINE_SELECTED
LINE_VERTICAL_SELECTED = LINE_RELEVANT | LINE_DIRVERT | LINE_SELECTED
LINE_HORIZONTAL_SELECTED = LINE_RELEVANT | LINE_SELECTED


@dataclasses.dataclass
class Line:
    """One detected segment, full-resolution coordinates."""
    p1: np.ndarray          # homogeneous (3,)
    p2: np.ndarray
    L: np.ndarray           # normalized connecting line (x^2+y^2=1)
    length: float
    width: float
    weight: float           # length * width * angle-precision
    type: int


def _vec3prodn(a, b):
    L = np.cross(a, b)
    n = math.hypot(L[0], L[1])
    return L / max(n, 1e-30)


def _rgb2grey256(rgb: np.ndarray) -> np.ndarray:
    """ashift.c:1254-1262 (0..256-scaled luma, double)."""
    return (0.3 * rgb[0] + 0.59 * rgb[1] + 0.11 * rgb[2]) * 256.0


def _downscale(g: np.ndarray, max_dim: int) -> Tuple[np.ndarray, float]:
    """Integer block-mean downscale (the reference detects on the
    already-downscaled preview buffer; headless we downscale here)."""
    h, w = g.shape
    f = max(1, int(math.ceil(max(h, w) / max_dim)))
    if f == 1:
        return g, 1.0
    hh, ww = (h // f) * f, (w // f) * f
    small = g[:hh, :ww].reshape(hh // f, f, ww // f, f).mean((1, 3))
    return small, 1.0 / f


def _region_lines(mask: np.ndarray, mag: np.ndarray,
                  min_pix: int) -> List[Tuple[float, ...]]:
    """Connected components of mask -> (x1,y1,x2,y2,width,npix) rects via
    magnitude-weighted centroid + principal axis (LSD's region2rect)."""
    from scipy import ndimage

    lbl, n = ndimage.label(mask, structure=np.ones((3, 3), dtype=int))
    if n == 0:
        return []
    flat = lbl.ravel()
    sel = flat > 0
    ids = flat[sel]
    h, w = mask.shape
    yy, xx = np.divmod(np.nonzero(sel)[0], w)
    wgt = mag.ravel()[sel]

    cnt = np.bincount(ids, minlength=n + 1)[1:]
    sw = np.bincount(ids, weights=wgt, minlength=n + 1)[1:]
    sx = np.bincount(ids, weights=wgt * xx, minlength=n + 1)[1:]
    sy = np.bincount(ids, weights=wgt * yy, minlength=n + 1)[1:]
    with np.errstate(invalid="ignore", divide="ignore"):
        cx = sx / sw
        cy = sy / sw
    dx = xx - cx[ids - 1]
    dy = yy - cy[ids - 1]
    ixx = np.bincount(ids, weights=wgt * dx * dx, minlength=n + 1)[1:]
    iyy = np.bincount(ids, weights=wgt * dy * dy, minlength=n + 1)[1:]
    ixy = np.bincount(ids, weights=wgt * dx * dy, minlength=n + 1)[1:]
    theta = 0.5 * np.arctan2(2.0 * ixy, ixx - iyy)

    # endpoint projection per region
    ct, st = np.cos(theta), np.sin(theta)
    t = dx * ct[ids - 1] + dy * st[ids - 1]
    s = -dx * st[ids - 1] + dy * ct[ids - 1]
    tmin = np.full(n, np.inf)
    tmax = np.full(n, -np.inf)
    smin = np.full(n, np.inf)
    smax = np.full(n, -np.inf)
    np.minimum.at(tmin, ids - 1, t)
    np.maximum.at(tmax, ids - 1, t)
    np.minimum.at(smin, ids - 1, s)
    np.maximum.at(smax, ids - 1, s)

    out = []
    for k in range(n):
        if cnt[k] < min_pix or sw[k] <= 0:
            continue
        length = tmax[k] - tmin[k]
        width = max(smax[k] - smin[k], 1.0)
        if length < 1.0:
            continue
        if cnt[k] / (length * width) < LSD_DENSITY_TH:
            continue
        x1 = cx[k] + tmin[k] * ct[k]
        y1 = cy[k] + tmin[k] * st[k]
        x2 = cx[k] + tmax[k] * ct[k]
        y2 = cy[k] + tmax[k] * st[k]
        out.append((x1, y1, x2, y2, width, cnt[k]))
    return out


def detect_lines(rgb: np.ndarray, is_raw: bool = False,
                 max_dim: int = 1200) -> List[Line]:
    """line_detect (ashift.c:1429-1601): segments classified into
    vertical/horizontal selected types, full-res coordinates.
    rgb: (3, H, W) float display-referred."""
    g = _rgb2grey256(np.asarray(rgb, dtype=np.float64))
    if is_raw:  # gamma_correct (ashift.c:1416-1426): perceptual boost
        g = 256.0 * (g / 256.0) ** (1.0 / 2.2)
    H, W = g.shape
    g, scale = _downscale(g, max_dim)
    h, w = g.shape

    # LSD 2x2 gradient; level-line angle = atan2(gx, -gy)
    gx = 0.5 * (g[:-1, 1:] + g[1:, 1:] - g[:-1, :-1] - g[1:, :-1])
    gy = 0.5 * (g[1:, :-1] + g[1:, 1:] - g[:-1, :-1] - g[:-1, 1:])
    mag = 0.5 * np.hypot(gx, gy)
    ang = np.arctan2(gx, -gy)  # level-line direction

    rho = LSD_QUANT / math.sin(math.radians(LSD_ANG_TH))
    strong = mag > rho
    nb = int(round(180.0 / LSD_ANG_TH))  # 8 bins of 22.5 deg
    frac = np.mod(ang / math.pi, 1.0) * nb  # [0, nb)

    cands: List[Tuple[float, ...]] = []
    accepted_a = 0
    for off in (0.0, 0.5):
        bins = np.floor(frac + off).astype(int) % nb
        batch: List[Tuple[float, ...]] = []
        for b in range(nb):
            batch += _region_lines(strong & (bins == b), mag,
                                   min_pix=max(5, int(MIN_LINE_LENGTH)))
        if off == 0.0:
            cands += batch
            accepted_a = len(batch)
        else:
            # keep only boundary-straddling regions the first binning
            # split: drop near-duplicates of an existing line
            for c in batch:
                mx, my = 0.5 * (c[0] + c[2]), 0.5 * (c[1] + c[3])
                aa = math.atan2(c[3] - c[1], c[2] - c[0]) % math.pi
                dup = False
                for e in cands[:accepted_a]:
                    ex, ey = 0.5 * (e[0] + e[2]), 0.5 * (e[1] + e[3])
                    ea = math.atan2(e[3] - e[1], e[2] - e[0]) % math.pi
                    da = min(abs(aa - ea), math.pi - abs(aa - ea))
                    if (abs(mx - ex) < 4 and abs(my - ey) < 4
                            and da < math.radians(6.0)):
                        dup = True
                        break
                if not dup:
                    cands.append(c)

    prec = LSD_ANG_TH / 180.0  # LSD rectangle angle-precision output
    lines: List[Line] = []
    for (x1, y1, x2, y2, wdt, _npix) in cands:
        # border-line rejection (ashift.c:1494-1500), downscaled coords
        if ((abs(x1 - x2) < 1 and max(x1, x2) < 2)
                or (abs(x1 - x2) < 1 and min(x1, x2) > w - 3)
                or (abs(y1 - y2) < 1 and max(y1, y2) < 2)
                or (abs(y1 - y2) < 1 and min(y1, y2) > h - 3)):
            continue
        px1, py1 = x1 / scale, y1 / scale
        px2, py2 = x2 / scale, y2 / scale
        p1 = np.array([px1, py1, 1.0])
        p2 = np.array([px2, py2, 1.0])
        length = math.hypot(px2 - px1, py2 - py1)
        width = wdt / scale
        weight = length * width * prec
        angle = math.degrees(math.atan2(py2 - py1, px2 - px1))
        vertical = abs(abs(angle) - 90.0) < MAX_TANGENTIAL_DEVIATION
        horizontal = (abs(abs(abs(angle) - 90.0) - 90.0)
                      < MAX_TANGENTIAL_DEVIATION)
        relevant = length > MIN_LINE_LENGTH / scale
        ltype = LINE_IRRELEVANT
        if vertical and relevant:
            ltype = LINE_VERTICAL_SELECTED
        elif horizontal and relevant:
            ltype = LINE_HORIZONTAL_SELECTED
        lines.append(Line(p1=p1, p2=p2, L=_vec3prodn(p1, p2),
                          length=length, width=width, weight=weight,
                          type=ltype))
    return lines


def _logit(x, lo, hi):
    eps = 1e-6
    p = min(max((x - lo) / (hi - lo), eps), 1.0 - eps)
    return 2.0 * math.atanh(2.0 * p - 1.0)


def _ilogit(L, lo, hi):
    return 0.5 * (1.0 + math.tanh(0.5 * L)) * (hi - lo) + lo


@dataclasses.dataclass
class _Fit:
    lines: List[Line]
    width: int
    height: int
    f_length_kb: float
    orthocorr: float
    aspect: float
    rotation: float
    lensshift_v: float
    lensshift_h: float
    shear: float
    linetype: int
    linemask: int
    params_count: int = 0


def model_fitness(params, fit: _Fit) -> float:
    """ashift.c:2039-2159."""
    pc = 0
    rotation, lensshift_v = fit.rotation, fit.lensshift_v
    lensshift_h, shear = fit.lensshift_h, fit.shear
    if math.isnan(rotation):
        rotation = _ilogit(params[pc], -ROTATION_RANGE, ROTATION_RANGE)
        pc += 1
    if math.isnan(lensshift_v):
        lensshift_v = _ilogit(params[pc], -LENSSHIFT_RANGE,
                              LENSSHIFT_RANGE)
        pc += 1
    if math.isnan(lensshift_h):
        lensshift_h = _ilogit(params[pc], -LENSSHIFT_RANGE,
                              LENSSHIFT_RANGE)
        pc += 1
    if math.isnan(shear):
        shear = _ilogit(params[pc], -SHEAR_RANGE, SHEAR_RANGE)
        pc += 1

    M = _homography(rotation, lensshift_v, lensshift_h, shear,
                    fit.f_length_kb, fit.orthocorr, fit.aspect,
                    fit.width, fit.height)
    Av = np.array([1.0, 0.0, 0.0])
    Ah = np.array([0.0, 1.0, 0.0])

    sumsq_v = sumsq_h = weight_v = weight_h = 0.0
    count_v = count_h = count = 0
    for ln in fit.lines:
        if (ln.type & fit.linemask) != fit.linetype:
            continue
        isvert = bool(ln.type & LINE_DIRVERT)
        A = Ah if isvert else Av
        P1 = M @ ln.p1
        P2 = M @ ln.p2
        L = _vec3prodn(P1, P2)
        s = float(L @ A)
        if isvert:
            sumsq_v += s * s * ln.weight
            weight_v += ln.weight
            count_v += 1
        else:
            sumsq_h += s * s * ln.weight
            weight_h += ln.weight
            count_h += 1
        count += 1

    v = sumsq_v / weight_v * count_v / count if weight_v > 0 and count else 0.0
    h = sumsq_h / weight_h * count_h / count if weight_h > 0 and count else 0.0
    return math.sqrt(1.0 - (1.0 - v) * (1.0 - h)) * 1.0e6


class FitError(RuntimeError):
    """NMS_NOT_ENOUGH_LINES / NMS_DID_NOT_CONVERGE / NMS_INSANE."""


def fit_params(p: AshiftParams, lines: List[Line], width: int,
               height: int, axis: int = FIT_BOTH) -> AshiftParams:
    """nmsfit (ashift.c:2162-2345): returns a new AshiftParams with the
    fitted rotation/lensshift/shear, raises FitError otherwise."""
    if axis == 0:
        return p
    generic = p.mode == 0  # ASHIFT_MODE_GENERIC
    fit = _Fit(
        lines=lines, width=width, height=height,
        f_length_kb=(DEFAULT_F_LENGTH if generic
                     else p.f_length * p.crop_factor),
        orthocorr=0.0 if generic else p.orthocorr,
        aspect=1.0 if generic else p.aspect,
        rotation=p.rotation, lensshift_v=p.lensshift_v,
        lensshift_h=p.lensshift_h, shear=p.shear,
        linetype=LINE_RELEVANT | LINE_SELECTED, linemask=LINE_MASK)

    params: List[float] = []
    if axis & FIT_ROTATION:
        params.append(_logit(fit.rotation, -ROTATION_RANGE,
                             ROTATION_RANGE))
        fit.rotation = math.nan
    if axis & FIT_LENS_VERT:
        params.append(_logit(fit.lensshift_v, -LENSSHIFT_RANGE,
                             LENSSHIFT_RANGE))
        fit.lensshift_v = math.nan
    if axis & FIT_LENS_HOR:
        params.append(_logit(fit.lensshift_h, -LENSSHIFT_RANGE,
                             LENSSHIFT_RANGE))
        fit.lensshift_h = math.nan
    if axis & FIT_SHEAR:
        params.append(_logit(fit.shear, -SHEAR_RANGE, SHEAR_RANGE))
        fit.shear = math.nan
    fit.params_count = len(params)

    enough = True
    if axis & FIT_LINES_VERT:
        fit.linetype |= LINE_DIRVERT
        enough = enough and sum(
            1 for ln in lines
            if ln.type == LINE_VERTICAL_SELECTED) >= MINIMUM_FITLINES
    if axis & FIT_LINES_HOR:
        enough = enough and sum(
            1 for ln in lines
            if ln.type == LINE_HORIZONTAL_SELECTED) >= MINIMUM_FITLINES
    if (axis & (FIT_LINES_VERT | FIT_LINES_HOR)) == (FIT_LINES_VERT
                                                     | FIT_LINES_HOR):
        fit.linetype = LINE_RELEVANT | LINE_SELECTED
        fit.linemask = LINE_RELEVANT | LINE_SELECTED
    if not enough:
        raise FitError("not enough lines")

    iters = simplex(lambda q: model_fitness(q, fit), params,
                    fit.params_count, NMS_EPSILON, NMS_SCALE,
                    NMS_ITERATIONS)
    if iters >= NMS_ITERATIONS:
        raise FitError("did not converge")

    pc = 0
    rot, sv, sh, she = (fit.rotation, fit.lensshift_v, fit.lensshift_h,
                        fit.shear)
    if math.isnan(rot):
        rot = _ilogit(params[pc], -ROTATION_RANGE, ROTATION_RANGE)
        pc += 1
    if math.isnan(sv):
        sv = _ilogit(params[pc], -LENSSHIFT_RANGE, LENSSHIFT_RANGE)
        pc += 1
    if math.isnan(sh):
        sh = _ilogit(params[pc], -LENSSHIFT_RANGE, LENSSHIFT_RANGE)
        pc += 1
    if math.isnan(she):
        she = _ilogit(params[pc], -SHEAR_RANGE, SHEAR_RANGE)
        pc += 1

    # 4x-area sanity gate (ashift.c:2310-2337)
    M = _homography(rot, sv, sh, she, fit.f_length_kb, fit.orthocorr,
                    fit.aspect, width, height)
    corners = np.array([[x, y, 1.0] for y in (0, height - 1)
                        for x in (0, width - 1)]).T
    po = M @ corners
    po = po[:2] / po[2]
    area = (po[0].max() - po[0].min()) * (po[1].max() - po[1].min())
    if area > 4.0 * width * height:
        raise FitError("degenerate (area growth > 4x)")

    return dataclasses.replace(p, rotation=rot, lensshift_v=sv,
                               lensshift_h=sh, shear=she)


def autofit(rgb: np.ndarray, p: Optional[AshiftParams] = None,
            axis: int = FIT_BOTH, is_raw: bool = False) -> AshiftParams:
    """do_fit (ashift.c:3083): detect structure, then fit the requested
    axes.  rgb: (3, H, W) display-referred image."""
    p = p or AshiftParams()
    H, W = rgb.shape[-2:]
    lines = detect_lines(rgb, is_raw=is_raw)
    if not lines:
        raise FitError("no lines detected")
    return fit_params(p, lines, W, H, axis=axis)
