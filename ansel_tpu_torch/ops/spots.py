"""spots: clone-stamp spot removal over drawn forms
(`ansel_tpu/ops/spots.py`).

Reference: `src/iop/spots.c`: params (:69-73: up to 64 clone form ids
and each one's algorithm), process: for each clone form, composite the
region at the form's source offset into the destination under the
form's mask.  The source position travels in the XMP mask_src blob
(`masks.Form.src`).  clone_algo 1 = clone (a direct composite), 2 = heal
(the default: the Poisson seamless clone of `pixel/heal.py`).  Each form
runs over its window (`ops/_maskwin.py`) where it has one.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.params import cfield, params
from .base import Op, OpPlan, PlanContext, register


@params(op="spots", version=2)
@dataclasses.dataclass
class SpotsParams:
    clone_id: tuple = cfield("64i", (0,) * 64)
    clone_algo: tuple = cfield("64i", (2,) * 64)


def clone_or_heal(algo: int):
    """tool(dst, src, mask) for clone_algo `algo`."""
    def tool(dst, src, m):
        if algo == 2:  # heal (the default)
            from ..pixel.heal import heal

            return heal(dst, src, m)
        return dst * (1.0 - m)[None] + src * m[None]

    return tool


@register
class Spots(Op):
    name = "spots"
    input_colorspace = None  # a geometric clone, any space

    def enabled_by_default(self, meta):
        return False

    def plan(self, ctx: PlanContext, spec_in, p: SpotsParams) -> OpPlan:
        from ..pipeline import masks as mk
        from . import _maskwin

        forms = ctx.notes.get("forms", {})
        clones = []
        for fid in p.clone_id:
            if not fid:
                continue
            form = forms.get(fid)
            if form is None or not form.nodes:
                continue
            # the destination's centre: the first node's position (a
            # circle's or ellipse's centre; a path's first anchor)
            cx, cy = float(form.nodes[0][0]), float(form.nodes[0][1])
            dx = int(round((float(form.src[0]) - cx) * spec_in.width))
            dy = int(round((float(form.src[1]) - cy) * spec_in.height))
            algo = p.clone_algo[list(p.clone_id).index(fid)]
            win = _maskwin.plan_window(form, forms, spec_in, dy, dx)
            clones.append((mk.form_signature(form, forms), fid, dy, dx,
                           int(algo), win))
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=tuple(clones))

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        from ..pipeline import masks as mk
        from . import _maskwin

        if not plan.static:
            return x
        forms = ctx.notes.get("forms", {})
        H, W = x.shape[-2:]
        spec = plan.spec_in
        out = x
        for (_sig, fid, dy, dx, algo, win) in plan.static:
            form = forms.get(fid)
            if form is None:
                continue
            tool = clone_or_heal(algo)
            if win is not None:
                out = _maskwin.apply_windowed(out, form, forms, spec, win,
                                              tool, dy, dx)
            else:
                m = mk.rasterize(form, forms, H, W, norm_h=spec.height,
                                 norm_w=spec.width, device=x.device)
                src = torch.roll(out, (-dy, -dx), dims=(-2, -1))
                out = tool(out, src, m)
        return out
