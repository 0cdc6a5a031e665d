"""liquify — freeform warp (move, grow and shrink brushes along paths).

Reference: `ansel/src/iop/liquify.c` (params :86, 290-295: 100 path nodes
of {header, warp, bezier controls}; interpolate_paths :793-866, one warp
every 0.1 radius of arc length; mix_warps :725-762; the falloff bezier
build_lookup_table :878-912; stamps added subtractively into one
displacement map :1035-1075, sampled at src = pos + map :1082-1140), as
`ansel_tpu/ops/liquify.py` has it.  The host side is copied: the 76-byte
node records, the path interpolation, each stamp's falloff as a degree-8
polynomial fitted in float64, the plan's displacement bound and the
stamp-union window.  The device side is the warp kernel's liquify map
(`kernels/warp.liquify_warp`): the displacement summed over the stamps
at each pixel of the window, exactly per pixel (the JAX package's form
on every backend but the TPU, which evaluates it on a stride-8 grid),
then the shared bilinear sampler over the whole frame, pasted into a
copy of it.

The plan's static holds `hash(bytes(nodes))`, as the JAX package's does;
Python salts that hash per process, so it keys nothing beyond one.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from ..core.params import cfield, params
from .base import Op, OpPlan, PlanContext, register

MAX_NODES = 100
_NODE_SIZE = 76
PATH_INVALIDATED, PATH_MOVE, PATH_LINE, PATH_CURVE = 0, 1, 2, 3
WARP_LINEAR, WARP_RADIAL_GROW, WARP_RADIAL_SHRINK = 0, 1, 2
STATUS_INTERPOLATED = 2
STAMP_RELOCATION = 0.1
_INTERP_POINTS = 100


@params(op="liquify", version=1)
@dataclasses.dataclass
class LiquifyParams:
    nodes: bytes = cfield(f"raw:{MAX_NODES * _NODE_SIZE}",
                          b"\0" * (MAX_NODES * _NODE_SIZE))


@dataclasses.dataclass
class _Node:
    type: int
    prev: int
    next: int
    point: complex
    strength: complex
    radius: complex
    control1: float
    control2: float
    warp_type: int
    status: int
    ctrl1: complex
    ctrl2: complex


def decode_nodes(blob: bytes):
    out = []
    for k in range(MAX_NODES):
        rec = blob[k * _NODE_SIZE:(k + 1) * _NODE_SIZE]
        (ptype, _ntype, _sel, _hov, prev, _idx, nxt, _pad) = struct.unpack(
            "<4i3bB", rec[:20])
        (px, py, sx, sy, rx, ry, c1, c2, wtype, status) = struct.unpack(
            "<8fii", rec[20:60])
        (c1x, c1y, c2x, c2y) = struct.unpack("<4f", rec[60:76])
        out.append(_Node(ptype, prev, nxt, complex(px, py), complex(sx, sy),
                         complex(rx, ry), c1, c2, wtype, status,
                         complex(c1x, c1y), complex(c2x, c2y)))
    return out


def _bezier_points(p0, p1, p2, p3, n=_INTERP_POINTS):
    t = np.linspace(0.0, 1.0, n)
    mt = 1 - t
    return (mt**3 * p0 + 3 * mt**2 * t * p1 + 3 * mt * t**2 * p2
            + t**3 * p3)


def _mix_warps(w1: _Node, w2: _Node, pt: complex, t: float):
    """mix_warps (liquify.c:725-762) — interpolate radius/strength/controls."""
    c1 = w1.control1 * (1 - t) + w2.control1 * t
    c2 = w1.control2 * (1 - t) + w2.control2 * t
    radius = abs(w1.radius - w1.point) * (1 - t) + abs(
        w2.radius - w2.point) * t
    p1 = w1.strength - w1.point
    p2 = w2.strength - w2.point
    a1, a2 = np.angle(p1), np.angle(p2)
    invert = False
    if a1 > 0.0 and a2 < -np.pi / 2:
        invert = True
        a1, a2 = np.pi - a1, -np.pi - a2
    elif a1 < -np.pi / 2 and a2 > 0.0:
        invert = True
        a1, a2 = -np.pi - a1, np.pi - a2
    r = abs(p1) * (1 - t) + abs(p2) * t
    phi = a1 * (1 - t) + a2 * t
    if invert:
        phi = np.pi - phi
    strength = pt + r * np.exp(1j * phi)
    return _Node(0, -1, -1, pt, strength, pt + radius, c1, c2,
                 w1.warp_type, STATUS_INTERPOLATED, 0, 0)


def interpolate_paths(nodes):
    """interpolate_paths (liquify.c:793-866)."""
    warps = []
    for k, d in enumerate(nodes):
        if d.type == PATH_INVALIDATED:
            break
        if d.type == PATH_MOVE:
            if d.next == -1:
                warps.append(d)
            continue
        prev = nodes[d.prev]
        w1, w2 = prev, d
        if d.type == PATH_LINE:
            total = abs(w1.point - w2.point)
            arc = 0.0
            while arc < total:
                t = arc / total if total > 0 else 0.0
                pt = w1.point * (1 - t) + w2.point * t
                w = _mix_warps(w1, w2, pt, t)
                step = abs(w.radius - w.point) * STAMP_RELOCATION
                if step <= 1e-3:
                    break
                arc += step
                warps.append(w)
        elif d.type == PATH_CURVE:
            pts = _bezier_points(w1.point, d.ctrl1, d.ctrl2, w2.point)
            seg = np.abs(np.diff(pts))
            cum = np.concatenate([[0.0], np.cumsum(seg)])
            total = cum[-1]
            arc = 0.0
            while arc < total:
                t = arc / total if total > 0 else 0.0
                i = int(np.searchsorted(cum, arc, side="right"))
                i = min(max(i, 1), len(pts) - 1)
                tt = ((arc - cum[i - 1]) / max(cum[i] - cum[i - 1], 1e-9))
                pt = pts[i - 1] * (1 - tt) + pts[i] * tt
                w = _mix_warps(w1, w2, complex(pt), t)
                step = abs(w.radius - w.point) * STAMP_RELOCATION
                if step <= 1e-3:
                    break
                arc += step
                warps.append(w)
    return warps


def _falloff_poly(c1: float, c2: float, deg: int = 8) -> np.ndarray:
    """Least-squares polynomial of the x-reparameterized falloff bezier
    (build_lookup_table, liquify.c:878-912): f(0)=1, f(1)=0."""
    t = np.linspace(0.0, 1.0, 257)
    mt = 1 - t
    # x(t): bezier(0, c1, c2, 1); y(t): bezier(1, 1, 0, 0)
    x = 3 * mt**2 * t * c1 + 3 * mt * t**2 * c2 + t**3
    y = mt**3 + 3 * mt**2 * t
    xs = np.linspace(0.0, 1.0, 257)
    f = np.interp(xs, x, y)
    return np.polyfit(xs, f, deg)


@register
class Liquify(Op):
    name = "liquify"
    input_colorspace = None  # geometric, camera/work RGB

    def enabled_by_default(self, meta):
        return False

    def _warp_arrays(self, p: LiquifyParams):
        warps = interpolate_paths(decode_nodes(p.nodes))
        warps = [w for w in warps if abs(w.radius - w.point) >= 1.0]
        if not warps:
            return None
        px = np.array([w.point.real for w in warps], np.float32)
        py = np.array([w.point.imag for w in warps], np.float32)
        R = np.array([abs(w.radius - w.point) for w in warps], np.float32)
        # 0.5 strength factor + 0.1 relocation factor for interpolated
        # stamps (build_round_stamp, liquify.c:957-962)
        s = np.array([0.5 * (w.strength - w.point)
                      * (STAMP_RELOCATION
                         if w.status & STATUS_INTERPOLATED else 1.0)
                      for w in warps], np.complex64)
        poly = np.stack([_falloff_poly(w.control1, w.control2)
                         for w in warps]).astype(np.float32)  # (K, 9)
        radial = np.array(
            [0.0 if w.warp_type == WARP_LINEAR else
             (1.0 if w.warp_type == WARP_RADIAL_GROW else -1.0)
             for w in warps], np.float32)
        return {"px": px, "py": py, "R": R, "sx": s.real.astype(np.float32),
                "sy": s.imag.astype(np.float32), "poly": poly,
                "radial": radial, "smag": np.abs(s).astype(np.float32)}

    def plan(self, ctx: PlanContext, spec_in, p: LiquifyParams) -> OpPlan:
        c = self._warp_arrays(p)
        if c is None:
            return OpPlan(spec_in=spec_in, spec_out=spec_in, static=None)
        # measured displacement bounds: the stamp sum evaluated on a
        # coarse host grid over the stamp-union support (the falloffs
        # are smooth over R >= 1 px, so a stride-4 grid plus margin is a
        # sound upper bound — vastly tighter than the strength-sum worst
        # case, which disabled the Pallas warp for any real brush path)
        x0 = float((c["px"] - c["R"]).min())
        x1 = float((c["px"] + c["R"]).max())
        y0 = float((c["py"] - c["R"]).min())
        y1 = float((c["py"] + c["R"]).max())
        gx = np.arange(x0 - 2, x1 + 2, 4.0, dtype=np.float64)
        gy = np.arange(y0 - 2, y1 + 2, 4.0, dtype=np.float64)
        XX, YY = np.meshgrid(gx, gy)
        DX = np.zeros_like(XX)
        DY = np.zeros_like(YY)
        for k in range(len(c["R"])):
            dx = XX - c["px"][k]
            dy = YY - c["py"][k]
            d = np.sqrt(dx * dx + dy * dy) / c["R"][k]
            f = np.polyval(c["poly"][k], d)
            f = np.where(d < 1.0, np.clip(f, 0.0, 1.0), 0.0)
            if c["radial"][k] != 0.0:
                DX -= c["radial"][k] * f * c["smag"][k] * dx / c["R"][k]
                DY -= c["radial"][k] * f * c["smag"][k] * dy / c["R"][k]
            else:
                DX -= f * c["sx"][k]
                DY -= f * c["sy"][k]
        bound_x = float(np.abs(DX).max()) * 1.05 + 4.0
        bound_y = float(np.abs(DY).max()) * 1.05 + 4.0
        # stamp-union window: d == 0 outside it, so only this region is
        # warped and pasted back (identity elsewhere)
        H = spec_in.array_shape[-2]
        W = spec_in.array_shape[-1]
        win = (max(int(np.floor(y0)) - 2, 0), min(int(np.ceil(y1)) + 3, H),
               max(int(np.floor(x0)) - 2, 0), min(int(np.ceil(x1)) + 3, W))
        if win[1] - win[0] < 8 or win[3] - win[2] < 8:
            return OpPlan(spec_in=spec_in, spec_out=spec_in, static=None)
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=(len(c["R"]), hash(bytes(p.nodes)),
                              round(bound_y, 1), round(bound_x, 1), win))

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p: LiquifyParams):
        if plan.static is None:
            return None
        return self._warp_arrays(p)

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        if plan.static is None:
            return x
        from ..kernels import warp

        _k, _h, _bound_y, _bound_x, win = plan.static
        return warp.liquify_warp(x.contiguous(), warp.pack_stamps(c), win)
