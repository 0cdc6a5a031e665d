"""clipping — legacy crop / rotate / keystone module (pre-2023 sidecars).

Reference: `ansel/src/iop/clipping.c` (params v5 clipping.c:104-130;
commit_params :1062-1228; geometry planning modify_roi_out :725-909; inverse
per-pixel map process/backtransform :468-478,990-1040; keystone quad matrix
keystone_get_matrix :406-437, keystone_backtransform :440-451).

Planning is copied from `ansel_tpu/ops/clipping.py`: the rotation matrix,
the flip flags from the cw/ch signs, the auto-crop scale search, the
keystone homography and the output window are computed on the host in
float64 from the params and the frame size, and `roi_in` inverse-maps a
requested output window to the input box it needs (the shrink source of
the backward ROI walk).  The apply is one warp (`_warpcommon.warp_static`
-> `kernels/warp.clip_warp`): the CUDA kernel evaluates the inverse map
per output pixel, samples bilinearly and zeroes what falls outside the
frame; a CPU tensor runs its plain twin.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..core.params import cfield, params
from .base import Op, OpPlan, PlanContext, register

FLAG_FLIP_H = 1
FLAG_FLIP_V = 2


@params(op="clipping", version=5)
@dataclasses.dataclass
class ClippingParams:
    angle: float = cfield("f", 0.0)
    cx: float = cfield("f", 0.0)
    cy: float = cfield("f", 0.0)
    cw: float = cfield("f", 1.0)   # negative = flip horizontal
    ch: float = cfield("f", 1.0)   # negative = flip vertical
    k_h: float = cfield("f", 0.0)
    k_v: float = cfield("f", 0.0)
    kxa: float = cfield("f", 0.2)
    kya: float = cfield("f", 0.2)
    kxb: float = cfield("f", 0.8)
    kyb: float = cfield("f", 0.2)
    kxc: float = cfield("f", 0.8)
    kyc: float = cfield("f", 0.8)
    kxd: float = cfield("f", 0.2)
    kyd: float = cfield("f", 0.8)
    k_type: int = cfield("i", -1)
    k_sym: int = cfield("i", 0)
    k_apply: int = cfield("i", 0)
    crop_auto: int = cfield("i", 1)
    ratio_n: int = cfield("i", -1)
    ratio_d: int = cfield("i", -1)


    @classmethod
    def from_legacy(cls, version, raw):
        import struct

        # clipping.c ladder (:214-330): v2 packed keystone direction
        # into bit 30 of k_h; v3 plain k_h/k_v; v4 adds quad + flags
        if version in (2, 3):
            a, cx, cy, cw, ch, k_h, k_v = struct.unpack("<7f", raw[:28])
            if version == 2:
                (u,) = struct.unpack("<I", struct.pack("<f", k_h))
                horizontal = bool(u & 0x40000000)
                (k,) = struct.unpack("<f",
                                     struct.pack("<I", u & ~0x40000000))
                k_h, k_v = (k, 0.0) if horizontal else (0.0, k)
            k_type = 0 if (k_h == 0 and k_v == 0) else 4
            return cls(angle=a, cx=cx, cy=cy, cw=cw, ch=ch, k_h=k_h,
                       k_v=k_v, k_type=k_type, k_sym=0, k_apply=0,
                       crop_auto=1, ratio_n=-2, ratio_d=-2)
        if version == 4:
            v = struct.unpack("<15f4i", raw[:76])
            return cls(angle=v[0], cx=v[1], cy=v[2], cw=v[3], ch=v[4],
                       k_h=v[5], k_v=v[6], kxa=v[7], kya=v[8],
                       kxb=v[9], kyb=v[10], kxc=v[11], kyc=v[12],
                       kxd=v[13], kyd=v[14], k_type=v[15], k_sym=v[16],
                       k_apply=v[17], crop_auto=v[18],
                       ratio_n=-2, ratio_d=-2)
        return None


def _keystone_matrix(k_space, kxa, kxb, kxc, kxd, kya, kyb, kyc, kyd):
    """clipping.c:406-437 — homography coefficients mapping the drawn quad
    (relative to its A corner) onto the axis-aligned k_space rectangle."""
    den1 = kxb * (kxc * kyd * kyd - kxd * kyc * kyd) + kyb * (
        kxd * kxd * kyc - kxc * kxd * kyd)
    a = -((kxb * (kyd * kyd - kyc * kyd) - kxc * kyd * kyd
           + kyb * (kxc * kyd - kxd * kyd) + kxd * kyc * kyd) * k_space[2]) / den1
    b = ((kxb * (kxd * kyd - kxd * kyc) - kxc * kxd * kyd + kxd * kxd * kyc
          + (kxc * kxd - kxd * kxd) * kyb) * k_space[2]) / den1
    den2 = kxb * kyb * (-kxc * kyd - kxd * kyc) + kxb * kxb * kyc * kyd \
        + kxc * kxd * kyb * kyb
    d = (kyb * (kxb * (kyd * k_space[3] - kyc * k_space[3])
                - kxc * kyd * k_space[3] + kxd * kyc * k_space[3])
         + kyb * kyb * (kxc * k_space[3] - kxd * k_space[3])) / den2
    e = -(kxb * (kxd * kyc * k_space[3] - kxc * kyd * k_space[3])
          + kxb * kxb * (kyd * k_space[3] - kyc * k_space[3])
          + kxb * kyb * (kxc * k_space[3] - kxd * k_space[3])) / den2
    den3 = kxb * kxb * (kxd * kyc * kyc * kyd - kxc * kyc * kyd * kyd) \
        + kxb * kyb * (kxc * kxc * kyd * kyd - kxd * kxd * kyc * kyc) \
        + kyb * kyb * (kxc * kxd * kxd * kyc - kxc * kxc * kxd * kyd)
    g = -(kyb * (kxb * (2.0 * kxc * kyd * kyd - 2.0 * kxc * kyc * kyd)
                 - kxc * kxc * kyd * kyd + 2.0 * kxc * kxd * kyc * kyd
                 - kxd * kxd * kyc * kyc)
          + kxb * kxb * (kyc * kyc * kyd - kyc * kyd * kyd)
          + kyb * kyb * (-2.0 * kxc * kxd * kyd + kxc * kxc * kyd
                         + kxd * kxd * kyc)) / den3
    h = (kxb * (-kxc * kxc * kyd * kyd + 2.0 * kxc * kxd * kyc * kyd
                - kxd * kxd * kyc * kyc)
         + kxb * kxb * (kxc * kyd * kyd - 2.0 * kxd * kyc * kyd
                        + kxd * kyc * kyc)
         + kxb * (2.0 * kxd * kxd - 2.0 * kxc * kxd) * kyb * kyc
         + (kxc * kxc * kxd - kxc * kxd * kxd) * kyb * kyb) / den3
    return a, b, d, e, g, h


def _transform(p, m, t_h, t_v):
    """forward warp clipping.c:483-488 (rotate then keystone shears)."""
    o0 = m[0] * p[0] + m[1] * p[1]
    o1 = m[2] * p[0] + m[3] * p[1]
    o1 = o1 * (1.0 + o0 * t_h)
    o0 = o0 * (1.0 + o1 * t_v)
    return o0, o1


def _plan_geometry(p: ClippingParams, W: int, H: int):
    """commit_params (:1062-1228) + modify_roi_out (:725-909), numpy."""
    angle = math.pi / 180.0 * p.angle
    flags = (FLAG_FLIP_V if p.ch < 0 else 0) | (FLAG_FLIP_H if p.cw < 0 else 0)
    cx = min(max(p.cx, 0.0), 0.9)
    cy = min(max(p.cy, 0.0), 0.9)
    cw = min(max(abs(p.cw), 0.1), 1.0)
    ch = min(max(abs(p.ch), 0.1), 1.0)

    ki_h = ki_v = 0.0
    k_apply = 0
    all_off = 1
    crop_auto = bool(p.crop_auto)
    kxa = kxd = kya = kyb = 0.0
    kxb = kxc = kyc = kyd = 0.6
    k_space = [0.2, 0.2, 0.6, 0.6]
    if p.k_type == 4:  # old single-axis keystoning
        if abs(p.k_h) >= 1e-4:
            all_off = 0
        ki_h = p.k_h if -1.0 <= p.k_h <= 1.0 else 0.0
        if abs(p.k_v) >= 1e-4:
            all_off = 0
        ki_v = p.k_v if -1.0 <= p.k_v <= 1.0 else 0.0
    elif p.k_type >= 0 and p.k_apply == 1:
        kxa, kxb, kxc, kxd = p.kxa, p.kxb, p.kxc, p.kxd
        kya, kyb, kyc, kyd = p.kya, p.kyb, p.kyc, p.kyd
        if p.k_type == 1:  # align horizontal point pairs (:1118-1146)
            a1 = (kxd - kxa) / (kyd - kya)
            b1 = kxa - a1 * kya
            a2 = (kxc - kxb) / (kyc - kyb)
            b2 = kxb - a2 * kyb
            if kya > kyb:
                kya = kyb
                kxa = a1 * kya + b1
            else:
                kyb = kya
                kxb = a2 * kyb + b2
            if kyc > kyd:
                kyd = kyc
                kxd = a1 * kyd + b1
            else:
                kyc = kyd
                kxc = a2 * kyc + b2
        elif p.k_type == 2:  # align vertical point pairs (:1147-1180)
            a1 = (kyb - kya) / (kxb - kxa)
            b1 = kya - a1 * kxa
            a2 = (kyc - kyd) / (kxc - kxd)
            b2 = kyd - a2 * kxd
            if kxa > kxd:
                kxa = kxd
                kya = a1 * kxa + b1
            else:
                kxd = kxa
                kyd = a2 * kxd + b2
            if kxc > kxb:
                kxb = kxc
                kyb = a1 * kxb + b1
            else:
                kxc = kxb
                kyc = a2 * kxc + b2
        k_space = [abs((kxa + kxd) / 2.0), abs((kya + kyb) / 2.0), 0.0, 0.0]
        k_space[2] = abs((kxb + kxc) / 2.0) - k_space[0]
        k_space[3] = abs((kyc + kyd) / 2.0) - k_space[1]
        kxb, kxc, kxd = kxb - kxa, kxc - kxa, kxd - kxa
        kyb, kyc, kyd = kyb - kya, kyc - kya, kyd - kya
        k_apply = 1
        all_off = 0
        crop_auto = False

    # --- modify_roi_out with the whole buffer (scale 1) ------------------
    rt = np.array([math.cos(angle), math.sin(angle),
                   -math.sin(angle), math.cos(angle)])
    if angle == 0.0:
        rt = np.array([1.0, 0.0, 0.0, 1.0])
    m = rt.copy()
    if flags & FLAG_FLIP_H:
        m[0], m[2] = -rt[0], -rt[2]
    if flags & FLAG_FLIP_V:
        m[1], m[3] = -rt[1], -rt[3]
    det = m[0] * m[3] - m[1] * m[2]
    inv_m = np.array([m[3], -m[1], -m[2], m[0]]) / det

    k_h = k_v = 0.0
    flip = 0
    enlarge_x = enlarge_y = 0.0
    if k_apply == 0 and crop_auto:
        # auto-crop: largest rect of the original aspect that fits inside
        # the rotated frame, testing both orientations (:769-812)
        inv_rt = np.array([rt[3], -rt[1], -rt[2], rt[0]]) / (
            rt[0] * rt[3] - rt[1] * rt[2])
        kc = 1.0 / min(W, H)
        k_h, k_v = ki_h * kc, ki_v * kc
        cropscale = -1.0
        oaabb = (-0.5 * W, -0.5 * H, 0.5 * W, 0.5 * H)
        tx, ty = W * 0.5, H * 0.5
        out_x = out_y = 0.0
        out_w, out_h = float(W), float(H)
        for fl in (0, 1):
            riw = H if fl else W
            rih = W if fl else H
            newcropscale = 1.0
            aabb = (-0.5 * riw, -0.5 * rih, 0.5 * riw, 0.5 * rih)
            for c in range(4):
                px = oaabb[0] if c in (0, 3) else oaabb[2]
                py = oaabb[1] if c in (0, 1) else oaabb[3]
                o0, o1 = _transform((px, py), inv_rt, k_h, k_v)
                for k, ov in enumerate((o0, o1)):
                    if abs(ov) > 0.001:
                        newcropscale = min(
                            newcropscale, aabb[(2 if ov > 0 else 0) + k] / ov)
            if newcropscale >= cropscale:
                cropscale = newcropscale
                flip = fl
                ach, acw = ch - cy, cw - cx
                if fl:
                    out_y = tx - (0.5 - cy) * cropscale * W
                    out_x = ty - (0.5 - cx) * cropscale * H
                    out_h = ach * cropscale * W
                    out_w = acw * cropscale * H
                else:
                    out_x = tx - (0.5 - cx) * cropscale * W
                    out_y = ty - (0.5 - cy) * cropscale * H
                    out_w = acw * cropscale * W
                    out_h = ach * cropscale * H
    else:
        # keystone / no-autocrop: bound the warped corners (:813-897)
        tx, ty = W * 0.5, H * 0.5
        corn = []
        km = _keystone_matrix(k_space, kxa, kxb, kxc, kxd,
                              kya, kyb, kyc, kyd) if k_apply else None
        for cxp, cyp in ((0.0, 0.0), (W, 0.0), (W, H), (0.0, H)):
            o = [cxp, cyp]
            if k_apply:
                o[0] /= W
                o[1] /= H
                a, b, d, e, g, h = km
                xx, yy = o[0] - kxa, o[1] - kya
                div = g * xx + h * yy + 1.0
                o[0] = (a * xx + b * yy) / div + k_space[0]
                o[1] = (d * xx + e * yy) / div + k_space[1]
                o[0] *= W
                o[1] *= H
            p0 = (o[0] - 0.5 * W, o[1] - 0.5 * H)
            o0, o1 = _transform(p0, inv_m, k_h, k_v)
            corn.append((o0 + 0.5 * W, o1 + 0.5 * H))
        xs = [c[0] for c in corn]
        ys = [c[1] for c in corn]
        new_x = max(min(xs), -float(W))
        new_y = max(min(ys), -float(H))
        new_sc_x = min(max(xs), 2.0 * W)
        new_sc_y = min(max(ys), 2.0 * H)
        if new_sc_x - new_x < W / 8.0:
            f = min(max((new_sc_x + new_x) / 2.0, W / 16.0),
                    W * 15.0 / 16.0 - 1.0)
            new_x, new_sc_x = f - W / 16.0, f + W / 16.0
        if new_sc_y - new_y < H / 8.0:
            f = min(max((new_sc_y + new_y) / 2.0, H / 16.0),
                    H * 15.0 / 16.0 - 1.0)
            new_y, new_sc_y = f - H / 16.0, f + H / 16.0
        new_sc_x -= new_x
        new_sc_y -= new_y
        new_x += cx * new_sc_x
        new_y += cy * new_sc_y
        new_sc_x *= cw - cx
        new_sc_y *= ch - cy
        enlarge_x = max(-new_x, 0.0)
        out_x = max(new_x, 0.0)
        enlarge_y = max(-new_y, 0.0)
        out_y = max(new_y, 0.0)
        out_w, out_h = new_sc_x, new_sc_y

    out_x = max(out_x, 0.0)
    out_y = max(out_y, 0.0)
    out_w = max(int(out_w), 1)
    out_h = max(int(out_h), 1)
    km_px = None
    if k_apply:
        km_px = _keystone_matrix(
            [k_space[0] * W, k_space[1] * H, k_space[2] * W, k_space[3] * H],
            kxa * W, kxb * W, kxc * W, kxd * W,
            kya * H, kyb * H, kyc * H, kyd * H)
    return dict(
        m=tuple(m), k_h=k_h, k_v=k_v, tx=tx, ty=ty,
        cix=out_x, ciy=out_y, enlarge_x=enlarge_x, enlarge_y=enlarge_y,
        flip=flip, out_w=out_w, out_h=out_h, k_apply=k_apply,
        km_px=km_px, kxa_px=kxa * W, kya_px=kya * H,
        ksp_px=(k_space[0] * W, k_space[1] * H),
        identity=(flags == 0 and angle == 0.0 and all_off
                  and out_w == W and out_h == H))


def _inverse_coords(g, jj, ii, xp=np):
    """Output frame coords -> source frame coords (inverse map,
    clipping.c:1015-1038 at scale 1, full buffer)."""
    px = g["cix"] - g["enlarge_x"] + ii + 0.5
    py = g["ciy"] - g["enlarge_y"] + jj + 0.5
    if g["flip"]:
        px, py = px - g["ty"], py - g["tx"]
    else:
        px, py = px - g["tx"], py - g["ty"]
    # backtransform (:468-473): undo keystone shears, rotate back
    py = py / (1.0 + px * g["k_h"])
    px = px / (1.0 + py * g["k_v"])
    m = g["m"]
    sx = m[0] * px + m[1] * py + g["tx"]
    sy = m[2] * px + m[3] * py + g["ty"]
    if g["k_apply"]:
        a, b, d, e, h_g, h_h = g["km_px"]
        xx = sx - g["ksp_px"][0]
        yy = sy - g["ksp_px"][1]
        div = (d * xx - a * yy) * h_h + (b * yy - e * xx) * h_g \
            + a * e - b * d
        sx = (e * xx - b * yy) / div + g["kxa_px"]
        sy = -(d * xx - a * yy) / div + g["kya_px"]
    return sy - 0.5, sx - 0.5


@register
class Clipping(Op):
    name = "clipping"
    input_colorspace = None  # geometric, any 3-channel space

    def enabled_by_default(self, meta):
        return False

    def plan(self, ctx: PlanContext, spec_in, p: ClippingParams) -> OpPlan:
        import dataclasses as _dc

        g = _plan_geometry(p, spec_in.full_w, spec_in.full_h)
        if g["identity"]:
            return OpPlan(spec_in=spec_in, spec_out=spec_in, static=None)
        key = tuple(sorted((k, v) for k, v in g.items()
                           if k not in ("out_w", "out_h")))
        win = ctx.notes.get("_win_out") if spec_in.is_window else None
        if win is not None and tuple(win) != (0, 0, g["out_h"],
                                              g["out_w"]):
            y0, x0, h, w = win
            spec_out = _dc.replace(
                spec_in, width=w, height=h, pad_w=0, pad_h=0,
                org_y=y0, org_x=x0, full_h=g["out_h"],
                full_w=g["out_w"], cfa=None)
        else:
            spec_out = _dc.replace(
                spec_in.with_size(g["out_w"], g["out_h"]),
                org_y=0, org_x=0, full_h=g["out_h"], full_w=g["out_w"])
        return OpPlan(spec_in=spec_in, spec_out=spec_out, static=key)

    def roi_in(self, plan: OpPlan, ctx: PlanContext, win):
        """Inverse-map the requested output window to the needed input
        bbox — THE shrink source of the backward-ROI walk: a history
        crop means upstream stages only compute the cropped region.
        The inverse map is projective (rotation + keystone), so corner
        images bound the bbox; +3 px bilinear/rounding margin."""
        import numpy as np

        si, so = plan.spec_in, plan.spec_out
        if plan.static is None:  # identity
            return tuple(win)
        g = dict(plan.static)
        W, H = si.full_w, si.full_h
        y0, x0, h, w = win
        jj = np.array([y0, y0, y0 + h, y0 + h], np.float64)
        ii = np.array([x0, x0 + w, x0, x0 + w], np.float64)
        sy, sx = _inverse_coords(g, jj, ii, np)
        m = 3
        ry0 = max(0, int(np.floor(sy.min())) - m)
        rx0 = max(0, int(np.floor(sx.min())) - m)
        ry1 = min(si.height + si.org_y, int(np.ceil(sy.max())) + m)
        rx1 = min(si.width + si.org_x, int(np.ceil(sx.max())) + m)
        # windows are relative to the stage's input spec frame origin
        ry0 -= si.org_y
        rx0 -= si.org_x
        ry1 -= si.org_y
        rx1 -= si.org_x
        ry0, rx0 = max(0, ry0), max(0, rx0)
        if ry1 <= ry0 or rx1 <= rx0:
            return None
        return (ry0, rx0, ry1 - ry0, rx1 - rx0)

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        if plan.static is None:
            return x
        from ._warpcommon import warp_static

        si, so = plan.spec_in, plan.spec_out
        cmap, k_apply = clip_map(dict(plan.static), si, so)
        return warp_static(x.contiguous(), cmap, k_apply, so.pad_h, so.pad_w)


def clip_map(g, si, so):
    """The constants of the inverse map on (so.pad_h, so.pad_w) output
    buffer pixels, as the JAX package's float32 evaluation of
    `_inverse_coords` rounds them: each Python (float64) sub-expression
    rounded to float32 once, in the order `kernels/warp.CLIP_CONSTS`
    names them; and whether the keystone homography applies."""
    a, b, d, e, h_g, h_h = g["km_px"] if g["k_apply"] else (0.0,) * 6
    ksp = g["ksp_px"] if g["k_apply"] else (0.0, 0.0)
    tpx, tpy = (g["ty"], g["tx"]) if g["flip"] else (g["tx"], g["ty"])
    vals = (g["cix"] - g["enlarge_x"], g["ciy"] - g["enlarge_y"], tpx, tpy,
            g["k_h"], g["k_v"], *g["m"], g["tx"], g["ty"], ksp[0], ksp[1],
            a, b, d, e, h_g, h_h, a * e, b * d,
            g["kxa_px"] if g["k_apply"] else 0.0,
            g["kya_px"] if g["k_apply"] else 0.0,
            so.org_y, so.org_x, si.org_y, si.org_x,
            si.full_w - 1, si.full_h - 1)
    return np.asarray(vals, np.float64).astype(np.float32), \
        int(bool(g["k_apply"]))
