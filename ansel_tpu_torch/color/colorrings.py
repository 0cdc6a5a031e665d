"""dt UCS 22 color rings + procedural CLUT builder (host-side numpy).

Transcribed from:
  * `ansel/src/common/colorspaces_inline_conversions.h` — dt UCS
    22 (:1261-1440: Y<->L*, xyY<->UCS UV/JCH, JCH<->HSB)
  * `ansel/src/pixel/colorequal_shared.c` — the color-rings
    geometry: ring brightness anchors (:138-150), periodic curve sampling
    (:152-172), reference-saturation search (:299-344), gray-cylinder
    basis (:441-490), Wendland C2 local field + CLUT fill (:492-625)
  * `ansel/src/common/colorspaces.c:421-440` — BT.2100 HLG
    transfer (odd-symmetric extension), the CLUT's code-value encoding.

The reference builds this CLUT host-side too (colorequal.c _build_clut);
only the 3-D LUT application runs in the pixelpipe.  Copied from
`ansel_tpu/color/colorrings.py` (numpy; no device code).
"""

from __future__ import annotations

import functools

import numpy as np

from . import matrices as cm

ANGLE_SHIFT = 20.0
HUE_SAMPLES = 64
NUM_RINGS = 3
LOCAL_FIELD_RINGS = NUM_RINGS + 1
CLUT_LEVEL = 64
RING_BRIGHTNESS = (0.15, 0.45, 0.75)  # dark, mid, light

# --- dt UCS 22 ---------------------------------------------------------------


def Y_to_L_star(Y):
    Y_hat = np.power(np.maximum(Y, 0.0), 0.631651345306265)
    return 2.098883786377 * Y_hat / (Y_hat + 1.12426773749357)


def L_star_to_Y(L_star):
    return np.power(1.12426773749357 * L_star / (2.098883786377 - L_star),
                    1.5831518565279648)


def xyY_to_UV(xyY):
    x, y = xyY[..., 0], xyY[..., 1]
    xf = np.array([-0.783941002840055, 0.745273540913283, 0.318707282433486])
    yf = np.array([0.277512987809202, -0.205375866083878, 2.16743692732158])
    of = np.array([0.153836578598858, -0.165478376301988, 0.291320554395942])
    UVD = (xf * x[..., None] + yf * y[..., None] + of)
    U = UVD[..., 0] / UVD[..., 2]
    V = UVD[..., 1] / UVD[..., 2]
    factors = (1.39656225667, 1.4513954287)
    halfv = (1.49217352929, 1.52488637914)
    Us = factors[0] * U / (np.abs(U) + halfv[0])
    Vs = factors[1] * V / (np.abs(V) + halfv[1])
    Up = -1.124983854323892 * Us - 0.980483721769325 * Vs
    Vp = 1.86323315098672 * Us + 1.971853092390862 * Vs
    return Up, Vp


def xyY_to_JCH(xyY, L_white):
    Up, Vp = xyY_to_UV(xyY)
    L_star = Y_to_L_star(xyY[..., 2])
    M2 = Up * Up + Vp * Vp
    J = L_star / L_white
    C = (15.932993652962535 * np.power(np.maximum(L_star, 1e-12),
                                       0.6523997524738018)
         * np.power(np.maximum(M2, 1e-24), 0.6007557017508491) / L_white)
    H = np.arctan2(Vp, Up)
    return np.stack([J, C, H], axis=-1)


def JCH_to_xyY(JCH, L_white):
    J, C, H = JCH[..., 0], JCH[..., 1], JCH[..., 2]
    L_star = J * L_white
    M = np.power(np.maximum(
        C * L_white / (15.932993652962535
                       * np.power(np.maximum(L_star, 1e-12),
                                  0.6523997524738018)), 0.0),
        0.8322850678616855)
    Up = M * np.cos(H)
    Vp = M * np.sin(H)
    Us = -5.037522385190711 * Up - 2.504856328185843 * Vp
    Vs = 4.760029407436461 * Up + 2.874012963239247 * Vp
    factors = (1.39656225667, 1.4513954287)
    halfv = (1.49217352929, 1.52488637914)
    U = -halfv[0] * Us / (np.abs(Us) - factors[0])
    V = -halfv[1] * Vs / (np.abs(Vs) - factors[1])
    Uf = np.array([0.167171472114775, -0.150959086409163, 0.940254742367256])
    Vf = np.array([0.141299802443708, -0.155185060382272, 1.0])
    of = np.array([-0.00801531300850582, -0.00843312433578007,
                   -0.0256325967652889])
    xyD = Uf * U[..., None] + Vf * V[..., None] + of
    x = xyD[..., 0] / xyD[..., 2]
    y = xyD[..., 1] / xyD[..., 2]
    return np.stack([x, y, L_star_to_Y(L_star)], axis=-1)


def JCH_to_HSB(JCH):
    B = JCH[..., 0] * (np.power(np.maximum(JCH[..., 1], 0.0),
                                1.33654221029386) + 1.0)
    S = np.where(B > 0, JCH[..., 1] / np.maximum(B, 1e-12), 0.0)
    return np.stack([JCH[..., 2], S, B], axis=-1)


def HSB_to_JCH(HSB):
    C = HSB[..., 1] * HSB[..., 2]
    J = HSB[..., 2] / (np.power(np.maximum(C, 0.0), 1.33654221029386) + 1.0)
    return np.stack([J, C, HSB[..., 0]], axis=-1)


def xyY_to_XYZ(xyY):
    x, y, Y = xyY[..., 0], xyY[..., 1], xyY[..., 2]
    sy = np.maximum(y, 1e-12)
    return np.stack([x * Y / sy, Y, (1 - x - y) * Y / sy], axis=-1)


def XYZ_to_xyY(XYZ):
    s = np.maximum(XYZ.sum(-1), 1e-12)
    return np.stack([XYZ[..., 0] / s, XYZ[..., 1] / s, XYZ[..., 1]], axis=-1)


# --- HLG Rec2020 profile (the CLUT's code-value space) ------------------------

_REC2020_D50 = cm.profile_matrix("rec2020", to_xyz=True,
                                 dst_white_xy=cm.WP_D50)
_REC2020_D50_INV = np.linalg.inv(_REC2020_D50)


def hlg_eotf(code):
    """code values -> linear (colorspaces.c _HLG_fct, odd-symmetric)."""
    A, B, C = 0.17883277, 0.28466892, 0.55991073
    s = np.sign(code)
    e = np.abs(code)
    lin = np.where(e <= 0.5, e * e / 3.0, (np.exp((e - C) / A) + B) / 12.0)
    return s * np.minimum(lin, 1.0)


def hlg_oetf(lin):
    """linear -> code values (inverse of hlg_eotf)."""
    A, B, C = 0.17883277, 0.28466892, 0.55991073
    s = np.sign(lin)
    e = np.abs(lin)
    code = np.where(e <= 1.0 / 12.0, np.sqrt(3.0 * e),
                    A * np.log(np.maximum(12.0 * e - B, 1e-12)) + C)
    return s * code


def xyz_d50_to_hlg_rec2020(XYZ_D50):
    lin = XYZ_D50 @ _REC2020_D50_INV.T
    return hlg_oetf(np.clip(lin, 0.0, None))


# --- color rings geometry ------------------------------------------------------


def graph_white():
    return float(Y_to_L_star(1.0))


def wrap_2pi(h):
    return np.mod(h, 2.0 * np.pi)


def wrap_pi(h):
    return wrap_2pi(h + np.pi) - np.pi


def curve_x_to_hue(x):
    return wrap_pi((360.0 * x + ANGLE_SHIFT) * np.pi / 180.0)


def hue_to_curve_x(hue):
    return wrap_2pi(hue - ANGLE_SHIFT * np.pi / 180.0) / (2.0 * np.pi)


def curve_periodic_sample(nodes_xy, x):
    """Periodic monotone-Hermite sample over period 1
    (curve_tools interpolate_val_V2_periodic semantics)."""
    from ..pixel.curves import MONOTONE_HERMITE, sample_curve

    nodes = sorted(nodes_xy)
    if len(nodes) < 2:
        return 0.5
    xs = np.array([n[0] for n in nodes])
    ys = np.array([n[1] for n in nodes])
    # periodic extension: wrap neighbours on both sides
    xs_ext = np.concatenate([xs[-2:] - 1.0, xs, xs[:2] + 1.0])
    ys_ext = np.concatenate([ys[-2:], ys, ys[:2]])
    from ..pixel.curves import _hermite, _slopes_monotone

    ms = _slopes_monotone(xs_ext, ys_ext)
    xq = np.mod(np.asarray(x, np.float64), 1.0)
    return _hermite(xs_ext, ys_ext, ms, xq)


def _hsb_to_srgb_preview(HSB, white):
    """dt UCS HSB -> sRGB D65 (unclamped), for the reference-saturation
    search (_dt_ucs_hsb_to_preview_rgb_unclamped)."""
    xyY = JCH_to_xyY(HSB_to_JCH(HSB), white)
    XYZ_D65 = xyY_to_XYZ(xyY)
    M = np.linalg.inv(cm.profile_matrix("srgb", to_xyz=True,
                                        dst_white_xy=cm.WP_D65))
    return XYZ_D65 @ M.T


@functools.lru_cache(maxsize=4)
def reference_saturations(white: float):
    """Binary-search max dt UCS saturation inside sRGB per ring
    (colorequal_shared.c:299-344)."""
    out = []
    for brightness in RING_BRIGHTNESS:
        low, high = 0.0, 1.0
        hues = curve_x_to_hue(np.arange(HUE_SAMPLES) / HUE_SAMPLES)
        for _ in range(18):
            cand = 0.5 * (low + high)
            HSB = np.stack([hues, np.full_like(hues, cand),
                            np.full_like(hues, brightness)], axis=-1)
            rgb = _hsb_to_srgb_preview(HSB, white)
            ok = np.all((rgb >= 0.0) & (rgb <= 1.0))
            if ok:
                low = cand
            else:
                high = cand
        out.append(low)
    return tuple(out)


def hsb_to_clut_rgb(HSB, white):
    """dt UCS HSB -> HLG Rec2020 code values (hsb_to_profile_rgb with the
    CLUT profile)."""
    xyY = JCH_to_xyY(HSB_to_JCH(HSB), white)
    XYZ_D65 = xyY_to_XYZ(xyY)
    XYZ_D50 = XYZ_D65 @ cm.XYZ_D65_TO_D50.T
    return xyz_d50_to_hlg_rec2020(XYZ_D50)


def brightness_to_axis_rgb(brightness, white):
    HSB = np.array([0.0, 0.0, np.clip(brightness, 0.0, 1.0)])
    rgb = hsb_to_clut_rgb(HSB, white)
    axis = np.clip(rgb.mean(), 0.0, 1.0)
    return np.full(3, axis)


def rgb_to_gray_cyl(rgb):
    """(..., 3) -> (L, rho, theta) in the gray-diagonal cylindrical basis."""
    eL = 0.5773502691896258
    eu = np.array([0.7071067811865475, -0.7071067811865475, 0.0])
    ev = np.array([0.4082482904638630, 0.4082482904638630,
                   -0.8164965809277260])
    L = rgb.sum(-1) * eL
    u = rgb @ eu
    v = rgb @ ev
    return L, np.hypot(u, v), np.arctan2(v, u)


def gray_basis_to_rgb(L, u, v):
    eL = 0.5773502691896258
    eu = np.array([0.7071067811865475, -0.7071067811865475, 0.0])
    ev = np.array([0.4082482904638630, 0.4082482904638630,
                   -0.8164965809277260])
    return (L[..., None] * eL + u[..., None] * eu + v[..., None] * ev)


def project_to_cube_shell(axis, rgb):
    """Vectorized project_to_cube_shell (colorequal_shared.c:381-399)."""
    vec = rgb - axis
    norm = np.linalg.norm(vec, axis=-1)
    dist = np.full(norm.shape, np.inf)
    for c in range(3):
        d = vec[..., c]
        bound = np.where(d > 0.0, 1.0, 0.0)
        cand = np.where(np.abs(d) < 1e-6, np.inf,
                        (bound - axis[..., c]) / np.where(
                            np.abs(d) < 1e-6, 1.0, d))
        cand = np.where(cand > 0.0, cand, np.inf)
        dist = np.minimum(dist, cand)
    dist = np.where(np.isfinite(dist), dist, 0.0)
    scale = np.where((norm >= 1e-6) & (dist < 1.0), dist, 1.0)
    out = axis + scale[..., None] * vec
    return np.clip(out, 0.0, 1.0)


def wendland_c2(d):
    t = np.clip(1.0 - d, 0.0, None)
    return np.where(d >= 1.0, 0.0, t**4 * (4.0 * d + 1.0))


def build_clut(params, level: int = CLUT_LEVEL) -> np.ndarray:
    """colorequal.c _build_clut, vectorized; params is the decoded op
    params dataclass.  -> (level^3, 3) float32, index r + g*L + b*L^2."""
    white = graph_white()
    refsat = reference_saturations(white)

    anchor_L = np.zeros((LOCAL_FIELD_RINGS, HUE_SAMPLES))
    anchor_rho = np.zeros_like(anchor_L)
    anchor_theta = np.zeros_like(anchor_L)
    delta_L = np.zeros_like(anchor_L)
    chroma_scale = np.ones_like(anchor_L)
    delta_theta = np.zeros_like(anchor_L)

    xq = np.arange(HUE_SAMPLES) / HUE_SAMPLES
    hues = curve_x_to_hue(xq)
    for ring in range(NUM_RINGS):
        brightness = RING_BRIGHTNESS[ring]
        ref_sat = refsat[ring]
        # per-channel periodic curves (hue / saturation / brightness)
        vals = []
        for ch in range(3):
            nodes = params.nodes(ring, ch)
            y = curve_periodic_sample(nodes, xq)
            if ch == 0:  # HUE: value = (y - 0.5) * 2 * pi... see below
                vals.append(y)
            else:
                vals.append(y)
        # _channel_value_from_y (colorequal.c:252-263): hue offset =
        # (y-0.5)*2*pi radians, sat/brightness gains = clamp(2*y, 0, 2)
        ones = np.ones_like(hues)
        hue_shift = (np.asarray(vals[0]) - 0.5) * 2.0 * np.pi * ones
        sat_gain = np.clip(np.asarray(vals[1]) * 2.0, 0.0, 2.0) * ones
        bright_gain = np.clip(np.asarray(vals[2]) * 2.0, 0.0, 2.0) * ones

        before_hsb = np.stack([hues, np.full_like(hues, ref_sat),
                               np.full_like(hues, brightness)], -1)
        after_hsb = np.stack([wrap_pi(hues + hue_shift),
                              np.clip(ref_sat * sat_gain, 0.0, 1.0),
                              np.clip(brightness * bright_gain, 0.0, 1.0)],
                             -1)
        neutral = brightness_to_axis_rgb(brightness, white)
        before_rgb = project_to_cube_shell(neutral,
                                           hsb_to_clut_rgb(before_hsb, white))
        after_rgb = project_to_cube_shell(neutral,
                                          hsb_to_clut_rgb(after_hsb, white))
        Lp, rhop, thetap = rgb_to_gray_cyl(before_rgb)
        La, rhoa, _ = rgb_to_gray_cyl(after_rgb)

        requested = sat_gain
        projected = np.where(rhop > 1e-6, rhoa / np.maximum(rhop, 1e-12), 1.0)
        effective = np.where(requested <= 1.0, requested,
                             np.minimum(requested, projected))
        anchor_L[ring] = Lp
        anchor_rho[ring] = rhop
        anchor_theta[ring] = thetap
        delta_L[ring] = La - Lp
        chroma_scale[ring] = effective
        delta_theta[ring] = wrap_pi(hue_shift)

    # achromatic locus ring
    v = np.arange(HUE_SAMPLES) / (HUE_SAMPLES - 1.0)
    anchor_L[NUM_RINGS] = v * 1.7320508075688772

    sigma_L = max(params.sigma_L * 0.01, 1e-6)
    sigma_rho = max(params.sigma_rho, 1e-6)
    sigma_theta = max(params.sigma_theta, 1e-6)
    rho0 = max(params.neutral_protection, 0.0) * sigma_rho

    ring_idx = np.repeat(np.arange(LOCAL_FIELD_RINGS), HUE_SAMPLES)
    anchors = dict(
        L=anchor_L.reshape(-1), rho=anchor_rho.reshape(-1),
        theta=anchor_theta.reshape(-1), delta_L=delta_L.reshape(-1),
        chroma_scale=chroma_scale.reshape(-1),
        delta_theta=delta_theta.reshape(-1),
        weight=np.where(ring_idx == LOCAL_FIELD_RINGS - 1,
                        1.0 / HUE_SAMPLES, 1.0))
    return fill_lut_sparse_local_field(anchors, sigma_L, sigma_rho,
                                       sigma_theta, rho0, level)


def fill_lut_sparse_local_field(anchors, sigma_L, sigma_rho, sigma_theta,
                                rho0, level: int = CLUT_LEVEL):
    """dt_colorrings_fill_lut_sparse_local_field
    (colorequal_shared.c:622-726), vectorized over the dense lattice.
    anchors: dict of 1-D arrays L/rho/theta/delta_L/chroma_scale/
    delta_theta/weight.  -> (level^3, 3) float32, idx r + g*L + b*L^2."""
    g1 = np.arange(level) / (level - 1.0)
    rr, gg, bb = np.meshgrid(g1, g1, g1, indexing="ij")  # index [r,g,b]
    lattice = np.stack([rr, gg, bb], axis=-1).reshape(-1, 3)
    Lx, rhox, thetax = rgb_to_gray_cyl(lattice)

    dL = (Lx[:, None] - anchors["L"]) / sigma_L
    dr = (rhox[:, None] - anchors["rho"]) / sigma_rho
    dh = wrap_pi(thetax[:, None] - anchors["theta"]) / sigma_theta
    d2 = dL * dL + dr * dr + dh * dh
    w = np.where(d2 >= 1.0, 0.0,
                 wendland_c2(np.sqrt(np.maximum(d2, 0.0)))
                 * anchors["weight"])
    sum_w = w.sum(-1)
    ok = (sum_w > np.finfo(np.float32).tiny) & (rhox > 1e-6)
    inv_w = 1.0 / np.maximum(sum_w, 1e-30)
    tgt_dL = (w @ anchors["delta_L"]) * inv_w
    scale = (w @ anchors["chroma_scale"]) * inv_w
    tgt_dth = (w @ anchors["delta_theta"]) * inv_w
    neutral_edit = ((np.abs(tgt_dL) <= 1e-6) & (np.abs(scale - 1.0) <= 1e-6)
                    & (np.abs(tgt_dth) <= 1e-6))
    ok = ok & ~neutral_edit

    t = np.clip(rhox / max(rho0, 1e-30), 0.0, 1.0)
    alpha = t * t * (3.0 - 2.0 * t)
    tL = Lx + alpha * tgt_dL
    trho = rhox * np.maximum(1.0 + alpha * (scale - 1.0), 0.0)
    tth = thetax + alpha * tgt_dth
    target = gray_basis_to_rgb(tL, trho * np.cos(tth), trho * np.sin(tth))
    axis = np.repeat((tL * 0.5773502691896258)[:, None], 3, axis=1)
    target = project_to_cube_shell(axis, target)
    disp = np.where(ok[:, None], target - lattice, 0.0)
    out = np.clip(lattice + disp, 0.0, 1.0)
    # reorder to LUT layout idx = r + g*L + b*L^2 (lattice is [r,g,b] C-order
    # = r*L^2 + g*L + b) -> transpose
    out = out.reshape(level, level, level, 3).transpose(2, 1, 0, 3)
    return out.reshape(-1, 3).astype(np.float32)


# --- colorprimaries anchors (iop/colorprimaries.c) -------------------------

_PRIM_CORNERS = np.array([
    [1.0, 0.0, 0.0],   # RED
    [1.0, 1.0, 0.0],   # YELLOW
    [0.0, 1.0, 0.0],   # GREEN
    [0.0, 1.0, 1.0],   # CYAN
    [0.0, 0.0, 1.0],   # BLUE
    [1.0, 0.0, 1.0],   # MAGENTA
])
_PRIM_EDGES = [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 0)]
_PRIM_AXIS_ANCHORS = 64
_SQRT3 = 1.7320508075688772


def rgb_to_ucs_hsb(rgb_code, white):
    """HLG Rec2020 code values -> dt UCS HSB
    (dt_colorrings_profile_rgb_to_dt_ucs_hsb with the CLUT profile)."""
    lin = hlg_eotf(np.clip(np.asarray(rgb_code, np.float64), 0.0, 1.0))
    XYZ_D50 = lin @ np.linalg.inv(_REC2020_D50_INV).T
    XYZ_D65 = XYZ_D50 @ np.linalg.inv(cm.XYZ_D65_TO_D50).T
    return JCH_to_HSB(xyY_to_JCH(XYZ_to_xyY(XYZ_D65), white))


def _hsb_distance(a, b):
    dh = wrap_pi(a[..., 0] - b[..., 0])
    return np.sqrt(dh * dh + (a[..., 1] - b[..., 1]) ** 2
                   + (a[..., 2] - b[..., 2]) ** 2)


def _anchor_from_source_rgb(source_rgb, hue_delta, sat_delta, bright_delta,
                            white):
    """_build_anchor_from_source_rgb (colorprimaries.c:323-378) -> anchor
    dict or None."""
    source_hsb = rgb_to_ucs_hsb(source_rgb, white)
    L, rho, theta = rgb_to_gray_cyl(np.asarray(source_rgb))
    if rho <= 1e-6:
        return None
    sb = np.clip(source_hsb[2], 0.0, 1.0)
    tb = np.clip(sb + bright_delta, 0.0, 1.0)
    sL, _, _ = rgb_to_gray_cyl(brightness_to_axis_rgb(sb, white))
    tL, _, _ = rgb_to_gray_cyl(brightness_to_axis_rgb(tb, white))
    scale = 1.0
    if source_hsb[1] > 1e-6:
        scale = max(source_hsb[1] + sat_delta, 0.0) / source_hsb[1]
    return dict(L=L, rho=rho, theta=theta, delta_L=tL - sL,
                chroma_scale=scale, delta_theta=float(wrap_pi(hue_delta)),
                weight=1.0)


def build_primaries_clut(p, level: int = CLUT_LEVEL) -> np.ndarray:
    """colorprimaries.c _build_clut: six edited gamut vertices + synthetic
    edge / radial / black-white midpoint anchors + a no-op axis ladder,
    spread by the sparse local field.  p: ColorPrimariesParams."""
    white = graph_white()
    coverage = np.clip(p.gamut_coverage * 0.01, 0.0, 1.0)
    anchors = []

    def base_rgb(node):
        corner = _PRIM_CORNERS[node]
        mu = corner.mean()
        return mu + coverage * (corner - mu)

    def node_deltas(node):
        return (p.hue[node] * np.pi / 180.0, p.saturation[node] * 0.01,
                p.brightness[node])

    def edge_deltas(edge):
        a, b = edge
        sa, sb_ = base_rgb(a), base_rgb(b)
        mid = 0.5 * (sa + sb_)
        ha = rgb_to_ucs_hsb(sa, white)
        hb = rgb_to_ucs_hsb(sb_, white)
        hm = rgb_to_ucs_hsb(mid, white)
        da, db = _hsb_distance(hm, ha), _hsb_distance(hm, hb)
        wa = wb = 0.5
        if da + db > 1e-6:
            wa, wb = db / (da + db), da / (da + db)
        aa = p.hue[a] * np.pi / 180.0
        ab = p.hue[b] * np.pi / 180.0
        hue = np.arctan2(wa * np.sin(aa) + wb * np.sin(ab),
                         wa * np.cos(aa) + wb * np.cos(ab))
        sat = (wa * p.saturation[a] + wb * p.saturation[b]) * 0.01
        bri = wa * p.brightness[a] + wb * p.brightness[b]
        return mid, hue, sat, bri

    def add(anchor):
        if anchor is not None:
            anchors.append(anchor)

    # vertex + edge anchors
    for node in range(6):
        add(_anchor_from_source_rgb(base_rgb(node), *node_deltas(node),
                                    white))
    for edge in _PRIM_EDGES:
        mid, hue, sat, bri = edge_deltas(edge)
        add(_anchor_from_source_rgb(mid, hue, sat, bri, white))

    # radial midpoints (halfway toward the gray axis, HSB-weighted)
    def radial(source_rgb, hue, sat, bri):
        L, rho, theta = rgb_to_gray_cyl(np.asarray(source_rgb))
        if rho <= 1e-6:
            return None
        halfway = gray_basis_to_rgb(
            np.asarray(L), np.asarray(0.5 * rho * np.cos(theta)),
            np.asarray(0.5 * rho * np.sin(theta)))
        axis_rgb = np.full(3, L / _SQRT3)
        sh = rgb_to_ucs_hsb(source_rgb, white)
        ah = rgb_to_ucs_hsb(axis_rgb, white)
        hh = rgb_to_ucs_hsb(halfway, white)
        ah = np.array([sh[0], ah[1], ah[2]])
        ds, da = _hsb_distance(hh, sh), _hsb_distance(hh, ah)
        ws = 0.5 if ds + da <= 1e-6 else da / (ds + da)
        return _anchor_from_source_rgb(halfway, ws * hue, ws * sat,
                                       ws * bri, white)

    for node in range(6):
        add(radial(base_rgb(node), *node_deltas(node)))
    for edge in _PRIM_EDGES:
        mid, hue, sat, bri = edge_deltas(edge)
        add(radial(mid, hue, sat, bri))

    # black/white midpoints
    for extreme in (np.zeros(3), np.ones(3)):
        for node in range(6):
            src = base_rgb(node)
            halfway = 0.5 * (src + extreme)
            sh = rgb_to_ucs_hsb(src, white)
            eh = rgb_to_ucs_hsb(extreme, white)
            hh = rgb_to_ucs_hsb(halfway, white)
            eh = np.array([sh[0], eh[1], eh[2]])
            ds, de = _hsb_distance(hh, sh), _hsb_distance(hh, eh)
            ws = 0.5 if ds + de <= 1e-6 else de / (ds + de)
            hue, sat, bri = node_deltas(node)
            add(_anchor_from_source_rgb(halfway, ws * hue, ws * sat,
                                        ws * bri, white))

    # no-op axis ladder
    for k in range(_PRIM_AXIS_ANCHORS):
        anchors.append(dict(
            L=k / (_PRIM_AXIS_ANCHORS - 1.0) * _SQRT3, rho=0.0, theta=0.0,
            delta_L=0.0, chroma_scale=1.0, delta_theta=0.0,
            weight=1.0 / _PRIM_AXIS_ANCHORS))

    packed = {key: np.array([a[key] for a in anchors])
              for key in ("L", "rho", "theta", "delta_L", "chroma_scale",
                          "delta_theta", "weight")}
    return fill_lut_sparse_local_field(
        packed, max(p.sigma_L * 0.01, 1e-6), max(p.sigma_rho, 1e-6),
        max(p.sigma_theta, 1e-6), max(p.neutral_protection, 1e-6), level)
