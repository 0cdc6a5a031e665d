"""retouch: clone, heal, blur and fill over drawn forms, on the image or
on a wavelet scale (`ansel_tpu/ops/retouch.py`).

Reference: `src/iop/retouch.c`: form records (:111-124: form id, wavelet
scale, algorithm, blur and fill settings), params (:137-156: 300 form
slots and the scale controls), process (:3500-3600: the B3 a-trous
decompose of dwt.c, each form's tool on its scale's layer, the
resynthesis).  Algorithms (:103-109): clone 1, heal 2 (`pixel/heal.py`),
blur 3, fill 4 (erase or a colour).

Scale 0 edits the image, 1..n that detail layer, num_scales + 1 the
residual.  The scale edits decompose only the union window of their
forms (plus the a-trous reach); each image edit runs over its form's
window (`ops/_maskwin.py`).
"""

from __future__ import annotations

import dataclasses
import struct

import torch

from ..core.params import cfield, params
from ..pixel.blur import gaussian_blur
from ..pixel.wavelets import atrous_decompose, atrous_reconstruct
from .base import Op, OpPlan, PlanContext, register

NO_FORMS = 300
ALGO_CLONE, ALGO_HEAL, ALGO_BLUR, ALGO_FILL = 1, 2, 3, 4
FILL_ERASE, FILL_COLOR = 0, 1
# formid, scale, algorithm, blur_type (4i), blur_radius (f),
# fill_mode (i), fill_color (3f), fill_brightness (f), distort_mode (i)
_FORM_FMT = "<4if i3ffi"
_FORM_SIZE = struct.calcsize(_FORM_FMT)  # 44 bytes


@params(op="retouch", version=3)
@dataclasses.dataclass
class RetouchParams:
    rt_forms: bytes = cfield(f"raw:{NO_FORMS * _FORM_SIZE}",
                             b"\0" * (NO_FORMS * _FORM_SIZE))
    algorithm: int = cfield("i", ALGO_HEAL)
    num_scales: int = cfield("i", 0)
    curr_scale: int = cfield("i", 0)
    merge_from_scale: int = cfield("i", 0)
    preview_levels: tuple = cfield("3f", (-3.0, 0.0, 3.0))
    blur_type: int = cfield("i", 0)
    blur_radius: float = cfield("f", 10.0)
    fill_mode: int = cfield("i", FILL_ERASE)
    fill_color: tuple = cfield("3f", (0.0, 0.0, 0.0))
    fill_brightness: float = cfield("f", 0.0)
    max_heal_iter: int = cfield("i", 2000)

    @classmethod
    def from_legacy(cls, version, raw):
        # retouch.c's legacy_params ladder (v3 is current, retouch.c:79)
        if version == 2:
            # v2 = v3 without the trailing max_heal_iter
            p = cls.codec.decode(raw + b"\0" * 4)
            p.max_heal_iter = 2000
            return p
        if version == 1:
            # v1 forms are 40 bytes (no distort_mode): each record grows,
            # distort_mode 1 (the legacy pre-distortion behaviour)
            forms = b"".join(
                raw[k * 40:(k + 1) * 40] + struct.pack("<i", 1)
                for k in range(NO_FORMS))
            tail = raw[NO_FORMS * 40:NO_FORMS * 40 + 56]
            p = cls.codec.decode(forms + tail + b"\0" * 4)
            p.max_heal_iter = 2000
            return p
        return None


def pack_form(formid: int, scale: int = 0, algorithm: int = ALGO_HEAL,
              blur_type: int = 0, blur_radius: float = 10.0,
              fill_mode: int = FILL_ERASE, fill_color=(0.0, 0.0, 0.0),
              fill_brightness: float = 0.0) -> bytes:
    """One rt_forms record (for configs and tests)."""
    return struct.pack(_FORM_FMT, formid, scale, algorithm, blur_type,
                       blur_radius, fill_mode, *fill_color,
                       fill_brightness, 2)


def _decode_forms(blob: bytes):
    out = []
    for k in range(NO_FORMS):
        rec = blob[k * _FORM_SIZE:(k + 1) * _FORM_SIZE]
        if len(rec) < _FORM_SIZE:
            break
        vals = struct.unpack(_FORM_FMT, rec)
        if vals[0]:
            out.append(vals)
    return out


def _tool(rec):
    """tool(layer, src, mask) -> the edited layer for record `rec`; src
    is the clone source (clone and heal read it)."""
    algo, bradius, fmode, fill = rec[3], rec[4], rec[5], rec[6]

    def tool(layer, src, mask):
        if algo == ALGO_CLONE:
            return layer * (1.0 - mask)[None] + src * mask[None]
        if algo == ALGO_HEAL:
            from ..pixel.heal import heal

            return heal(layer, src, mask)
        if algo == ALGO_BLUR:
            blurred = gaussian_blur(layer, max(bradius, 0.5))
            return layer * (1.0 - mask)[None] + blurred * mask[None]
        # fill: erase (0 on a detail layer) or the fill colour
        if fmode == FILL_ERASE:
            target = torch.zeros_like(layer)
        else:
            target = torch.tensor(fill, dtype=layer.dtype,
                                  device=layer.device).reshape(3, 1, 1)
            target = target.expand(layer.shape)
        return layer * (1.0 - mask)[None] + target * mask[None]

    return tool


@register
class Retouch(Op):
    name = "retouch"
    input_colorspace = None

    def enabled_by_default(self, meta):
        return False

    def plan(self, ctx: PlanContext, spec_in, p: RetouchParams) -> OpPlan:
        from ..pipeline import masks as mk
        from . import _maskwin

        forms = ctx.notes.get("forms", {})
        num_scales = max(int(p.num_scales), 0)
        recs = []
        blob = p.rt_forms if isinstance(p.rt_forms, bytes) else bytes(
            p.rt_forms)
        boxes = []
        for vals in _decode_forms(blob):
            (fid, scale, algo, _btype, bradius, fmode, fr, fg, fb,
             fbright, _dm) = vals
            form = forms.get(fid)
            if form is None or not form.nodes:
                continue
            if algo in (ALGO_CLONE, ALGO_HEAL):
                cx = float(form.nodes[0][0])
                cy = float(form.nodes[0][1])
                dy = int(round((float(form.src[1]) - cy) * spec_in.height))
                dx = int(round((float(form.src[0]) - cx) * spec_in.width))
            else:  # blur and fill read no clone source
                dy = dx = 0
            brad = float(bradius) * ctx.scale
            # the form's window for the image (scale 0) tools
            win = _maskwin.plan_window(form, forms, spec_in, dy, dx,
                                       margin=16 + int(brad * 3))
            recs.append((mk.form_signature(form, forms), fid, scale, algo,
                         brad, fmode,
                         (fr + fbright, fg + fbright, fb + fbright),
                         dy, dx, win))
            if scale != 0:
                box = mk.form_bbox(form, forms, spec_in.height,
                                   spec_in.width)
                if box is None:
                    boxes = None
                    break
                y0, y1, x0, x1 = box
                boxes.append((min(y0, y0 + dy), max(y1, y1 + dy),
                              min(x0, x0 + dx), max(x1, x1 + dx),
                              int(brad * 3)))
        # the union window of the scale edits: every scale > 0 form's box
        # (and its clone source's) plus the a-trous reach, so that the
        # window's detail layers equal the whole image's under the masks
        wv_win = None
        if num_scales > 0 and boxes:
            halo = 2 * (2 ** min(num_scales, 12)) + 16
            y0 = min(b[0] - b[4] for b in boxes) - halo
            y1 = max(b[1] + b[4] for b in boxes) + halo
            x0 = min(b[2] - b[4] for b in boxes) - halo
            x1 = max(b[3] + b[4] for b in boxes) + halo
            H, W = spec_in.array_shape[-2], spec_in.array_shape[-1]
            y0, x0 = max(y0, 0), max(x0, 0)
            y1, x1 = min(y1, H), min(x1, W)
            if (y1 - y0 >= 2 and x1 - x0 >= 2
                    and (y1 - y0) * (x1 - x0)
                    <= _maskwin.MAX_AREA_FRAC * H * W):
                wv_win = (y0, y1, x0, x1)
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=(num_scales, tuple(recs), wv_win))

    def _apply_image_domain(self, out, rec, forms, spec):
        """One image (scale 0) tool, over its window where it has one."""
        from ..pipeline import masks as mk
        from . import _maskwin

        form = forms.get(rec[1])
        win, dy, dx = rec[9], rec[7], rec[8]
        if win is not None:
            return _maskwin.apply_windowed(out, form, forms, spec, win,
                                           _tool(rec), dy, dx)
        H, W = out.shape[-2:]
        m = mk.rasterize(form, forms, H, W, norm_h=spec.height,
                         norm_w=spec.width, device=out.device)
        src = torch.roll(out, (-dy, -dx), dims=(-2, -1))
        return _tool(rec)(out, src, m)

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        from ..pipeline import masks as mk

        num_scales, recs, wv_win = plan.static
        if not recs:
            return x
        forms = ctx.notes.get("forms", {})
        spec = plan.spec_in

        if num_scales <= 0:
            out = x
            for rec in recs:
                if rec[2] == 0:
                    out = self._apply_image_domain(out, rec, forms, spec)
            return out

        # the scale edits decompose only their union window
        # (reconstruct(decompose(x)) == x, so pasting it back changes
        # only the pixels under the edited masks)
        if wv_win is not None:
            y0, y1, x0, x1 = wv_win
            xw = x[:, y0:y1, x0:x1]
            origin = (y0, x0)
        else:
            xw = x
            origin = (0, 0)

        def mask_of(rec):
            return mk.rasterize(forms.get(rec[1]), forms, xw.shape[-2],
                                xw.shape[-1], norm_h=spec.height,
                                norm_w=spec.width, origin=origin,
                                device=x.device)

        def edit(layer, rec):
            src = torch.roll(layer, (-rec[7], -rec[8]), dims=(-2, -1))
            return _tool(rec)(layer, src, mask_of(rec))

        details, residual = atrous_decompose(xw, num_scales)
        out_layers = list(details)
        for rec in recs:
            scale = rec[2]
            if scale == 0:
                continue  # applied below, on the reconstruction
            if 1 <= scale <= num_scales:
                out_layers[scale - 1] = edit(out_layers[scale - 1], rec)
            else:  # the residual
                residual = edit(residual, rec)
        out_w = atrous_reconstruct(out_layers, residual)
        if wv_win is not None:
            out = x.clone()
            out[:, y0:y1, x0:x1] = out_w
        else:
            out = out_w
        for rec in recs:
            if rec[2] == 0:
                out = self._apply_image_domain(out, rec, forms, spec)
        return out
