"""highlights — clipped-highlight reconstruction.

Reference: `ansel/src/iop/highlights/` — params struct common.h:428-446;
modes common.h:403-410.  Planning is copied from
`ansel_tpu/ops/highlights.py`, and so is `apply` (:116-248): CLIP (the
hard clamp at the threshold, highlights/clip.c); LCH, the 2x2-cell
chroma-ratio rebuild (highlights/lch.c:316-410); INPAINT, the
directional ratio-decay inpainting (highlights/inpaint.c with lch.c's
interpolate_color) on Bayer and X-Trans; the guided LAPLACIAN
(highlights/laplacian.c via kernels/highlights_laplacian.py) with its
noise salt; and HARMONIC, the Laplacian pass and then the all-clip dome
core (kernels/highlights_harmonic.py).  As in the JAX package, LCH,
LAPLACIAN and HARMONIC reach their reconstruction on Bayer mosaics only:
on X-Trans they are the clamp min(x, clip).
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.params import cfield, params
from ..core.types import CFAPattern, Colorspace, ImageSpec
from . import _bayer
from .base import Op, OpPlan, PlanContext, register

MODE_CLIP = 0   # DT_IOP_HIGHLIGHTS_CLIP
MODE_LCH = 1
MODE_INPAINT = 2
MODE_LAPLACIAN = 3
MODE_HARMONIC = 4

SQRT3 = 3.0**0.5
SQRT12 = 12.0**0.5


@params(op="highlights", version=4)
@dataclasses.dataclass
class HighlightsParams:
    mode: int = cfield("i", MODE_CLIP)
    blendL: float = cfield("f", 1.0)   # unused (v1 leftovers)
    blendC: float = cfield("f", 0.0)
    blendh: float = cfield("f", 0.0)
    clip: float = cfield("f", 1.0)
    noise_level: float = cfield("f", 0.0)
    iterations: int = cfield("i", 30)
    scales: int = cfield("i", 8)
    reconstructing: float = cfield("f", 0.4)
    combine: float = cfield("f", 2.0)
    debugmode: int = cfield("i", 0)
    solid_color: float = cfield("f", 0.5)

    @classmethod
    def from_legacy(cls, version, raw):
        import struct

        if version == 1:  # highlights.c:163-184: {mode, blendL, blendC, blendh}
            mode, bl, bc, bh = struct.unpack("<i3f", raw[:16])
            return cls(mode=mode, blendL=bl, blendC=bc, blendh=bh, clip=1.0,
                       noise_level=0.0, iterations=1, scales=5,
                       reconstructing=0.4, combine=2.0, solid_color=0.0)
        if version == 2:  # highlights.c:185-209: v1 + {clip}
            mode, bl, bc, bh, clip = struct.unpack("<i4f", raw[:20])
            return cls(mode=mode, blendL=bl, blendC=bc, blendh=bh, clip=clip,
                       noise_level=0.0, iterations=1, scales=5,
                       reconstructing=0.4, combine=2.0, solid_color=0.0)
        if version == 3:  # highlights.c:210-220: v4 minus {solid_color}
            p = cls.codec.decode(raw[:44] + b"\0" * 4)
            p.solid_color = 0.0
            return p
        return None


@register
class Highlights(Op):
    name = "highlights"
    input_colorspace = Colorspace.RAW
    mandatory = True

    def plan(self, ctx: PlanContext, spec_in: ImageSpec, p) -> OpPlan:
        # reference clamps processed_maximum to the clip threshold
        pmax = tuple(m if m > 0 else 1.0 for m in ctx.processed_maximum)
        clipval = p.clip * min(pmax)
        ctx.processed_maximum = tuple(
            min(m, clipval) for m in ctx.processed_maximum
        )
        ctx.notes["highlights_clip"] = clipval
        # per-channel thresholds (highlights.c:385-389)
        ctx.notes["highlights_clips"] = tuple(
            0.995 * p.clip * m for m in pmax[:3])
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=(p.mode, max(int(p.scales), 1),
                              max(int(p.iterations), 1),
                              round(float(p.noise_level), 6),
                              round(float(p.solid_color), 6)))

    def roi_in(self, plan: OpPlan, ctx: PlanContext, win):
        # CLIP and LCH are local mosaic ops (<= 3x3 support; 6 keeps the
        # CFA window's alignment); the multiscale reconstructions and
        # INPAINT's sweeps need the frame
        si, so = plan.spec_in, plan.spec_out
        if tuple(win) == (0, 0, so.height, so.width):
            return (0, 0, si.height, si.width)
        if plan.static[0] not in (MODE_CLIP, MODE_LCH):
            return None
        halo = 6
        y0 = max(0, win[0] - halo)
        x0 = max(0, win[1] - halo)
        y1 = min(si.height, win[0] + win[2] + halo)
        x1 = min(si.width, win[1] + win[3] + halo)
        return (y0, x0, y1 - y0, x1 - x0)

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p):
        return {"clip": ctx.notes["highlights_clip"],
                "clips": list(ctx.notes["highlights_clips"])}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        mode, scales_p, iters, noise_lv, solid = plan.static
        spec = plan.spec_in
        is_mosaic = spec.cfa is not None
        bayer = is_mosaic and spec.cfa is not CFAPattern.XTRANS
        if mode == MODE_INPAINT and is_mosaic:
            return self._inpaint(x, c, spec, ctx)
        if mode in (MODE_LAPLACIAN, MODE_HARMONIC) and bayer:
            from ..kernels import highlights_laplacian as hl

            rec = hl.laplacian_reconstruct(
                x, c["clips"], spec.cfa, scales_p, iters, noise_lv,
                solid, zoom=max(ctx.scale, 1e-6))
            if mode == MODE_HARMONIC:
                # the segmentation path's all-clip core (highlights/
                # segmentation.c, dome.c, region.c steps 7-8)
                from ..kernels import highlights_harmonic as hh

                rec = hh.harmonic_dome_core(x, rec, c["clips"], spec.cfa)
            return rec
        if mode == MODE_LCH and bayer:
            return self._lch_bayer(x, c["clip"], spec)
        return torch.minimum(x, c["clip"])

    def _clip_map(self, clips, spec, ctx, h, w, device):
        """The per-pixel clip threshold clips[FC(j, i)]."""
        if spec.cfa is CFAPattern.XTRANS:
            masks = _bayer.xtrans_color_masks(ctx.meta.xtrans, h, w, device)
        else:
            masks = _bayer.color_masks(spec.cfa, h, w, device)
        return (masks[0] * clips[0] + masks[1] * clips[1]
                + masks[2] * clips[2])

    def _inpaint(self, x, c, spec, ctx):
        """process_inpaint_bayer/xtrans (highlights/inpaint.c:64-104 and
        interpolate_color, highlights/lch.c:206-300): four directional
        sweeps; along each, a running odd/even intensity ratio with
        exponential decay (ratio' = (3 ratio + r) / 4 at unclipped pairs)
        rebuilds a clipped sample from its neighbour in the sweep's
        direction; the four estimates are averaged.

        The ratio is the first-order recurrence r_k = a_k r_(k-1) + b_k
        from r = 1, which the JAX package evaluates with one
        `lax.associative_scan` per direction.  Here it is a log-depth
        doubling scan (`_linear_scan`): ceil(log2 n) rounds over shifted
        views, which combine in another order than JAX's tree, so the
        ratios agree to rounding.  As in the JAX function, the neighbour
        wraps round the frame (`roll`), and the border ring neither
        updates the ratio nor is written."""
        eps = 1e-5
        H, W = x.shape[-2:]
        dev = x.device
        clip0 = self._clip_map(c["clips"], spec, ctx, H, W, dev)
        rows = torch.arange(H, device=dev)[:, None]
        cols = torch.arange(W, device=dev)[None, :]
        interior = (rows > 0) & (rows < H - 1) & (cols > 0) & (cols < W - 1)

        def sweep(axis, direction):
            nxt = torch.roll(x, -direction, dims=axis)
            clip1 = torch.roll(clip0, -direction, dims=axis)
            odd = ((rows if axis == 0 else cols) & 1) == 1
            both_ok = ((x < clip0) & (x > eps) & (nxt < clip1) & (nxt > eps)
                       & interior)
            r = torch.where(odd, x / torch.clamp(nxt, min=eps),
                            nxt / torch.clamp(x, min=eps))
            a = torch.where(both_ok, 0.75, 1.0)
            b = torch.where(both_ok, 0.25 * r, 0.0)
            aa, bb = _linear_scan(a, b, axis, reverse=direction < 0)
            ratio = aa + bb  # from r = 1
            return torch.where(
                nxt >= clip1 - eps, torch.maximum(clip0, clip1),
                torch.where(odd, nxt * ratio,
                            nxt / torch.clamp(ratio, min=1e-12)))

        add = (sweep(1, 1) + sweep(1, -1) + sweep(0, 1)
               + sweep(0, -1)) * 0.25
        return torch.where((x >= clip0 - eps) & interior, add, x)

    def _lch_bayer(self, x, clip, spec):
        """process_lch_bayer (highlights/lch.c:316-410): per pixel, the
        2x2 cell anchored at it; where a channel clipped, the pixel is
        rebuilt from the cell's luminance and its chroma scaled by the
        ratio of the clamped cell's chroma."""
        from ..pixel.shifts import PaddedView

        h, w = spec.pad_h, spec.pad_w
        pv = PaddedView(x, 1)
        R = torch.zeros_like(x)
        B = torch.zeros_like(x)
        Gmin = torch.full_like(x, float("inf"))
        Gmax = torch.full_like(x, float("-inf"))
        clipped = torch.zeros_like(x, dtype=torch.bool)
        for jj in (0, 1):
            for ii in (0, 1):
                val = pv.at(jj, ii)
                masks = _bayer.color_masks(spec.cfa.shifted(jj, ii), h, w,
                                           x.device)
                clipped = clipped | (val > clip)
                R = torch.where(masks[0] > 0, val, R)
                B = torch.where(masks[2] > 0, val, B)
                is_g = masks[1] > 0
                Gmin = torch.where(is_g, torch.minimum(Gmin, val), Gmin)
                Gmax = torch.where(is_g, torch.maximum(Gmax, val), Gmax)

        Ro = torch.minimum(R, clip)
        Go = torch.minimum(Gmin, clip)
        Bo = torch.minimum(B, clip)
        L = (R + Gmax + B) / 3.0
        C = SQRT3 * (R - Gmax)
        Hh = 2.0 * B - Gmax - R
        Co = SQRT3 * (Ro - Go)
        Ho = 2.0 * Bo - Go - Ro
        denom = C * C + Hh * Hh
        ratio = torch.sqrt((Co * Co + Ho * Ho) / torch.clamp(denom, min=1e-12))
        do_scale = (R != Gmax) & (Gmax != B)
        C = torch.where(do_scale, C * ratio, C)
        Hh = torch.where(do_scale, Hh * ratio, Hh)
        rgb = [L - Hh / 6.0 + C / SQRT12,
               L - Hh / 6.0 - C / SQRT12,
               L + Hh / 3.0]
        masks0 = _bayer.color_masks(spec.cfa, h, w, x.device)
        own = masks0[0] * rgb[0] + masks0[1] * rgb[1] + masks0[2] * rgb[2]
        return torch.where(clipped, own, x)


def _linear_scan(a, b, axis: int, reverse: bool = False):
    """The prefix composition of the affine maps v -> a_k v + b_k along
    `axis` (from the far end when `reverse`): (A_k, B_k) with r_k = A_k
    r_init + B_k.  Hillis-Steele doubling: ceil(log2 n) rounds, round s
    composing each element with the one 2^s before it."""
    n = a.shape[axis]
    if reverse:
        a, b = a.flip(axis), b.flip(axis)
    s = 1
    while s < n:
        a_prev = a.narrow(axis, 0, n - s)
        b_prev = b.narrow(axis, 0, n - s)
        a_cur = a.narrow(axis, s, n - s)
        b_cur = b.narrow(axis, s, n - s)
        a = torch.cat([a.narrow(axis, 0, s), a_prev * a_cur], dim=axis)
        b = torch.cat([b.narrow(axis, 0, s), b_prev * a_cur + b_cur],
                      dim=axis)
        s *= 2
    if reverse:
        a, b = a.flip(axis), b.flip(axis)
    return a, b
