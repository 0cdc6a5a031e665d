"""drawlayer — a painted raster layer composited over the image.

Reference: `ansel/src/iop/drawlayer.c` + `drawlayer/common.h` (params v1
:14-21: stroke_commit_hash, a 64-char layer name, a 256-char work
profile, a sidecar timestamp, the layer order).  The reference's strokes
live in a layer cache rendered by an interactive brush engine; the
headless subset, copied from `ansel_tpu/ops/drawlayer.py`, resolves the
layer name to a premultiplied RGBA raster next to the sidecar
(`<layer_name>.npz` with an `rgba` array, HWC or CHW) and composites it
source-over in work RGB.  A named layer that cannot be found raises
ValueError at plan time, as in the JAX package (whose planner catches
nothing around `plan`).

Any other image file is read through PIL as `convert("RGBA")`,
premultiplied, as the JAX package reads it; a file PIL cannot read is a
missing layer there and here.  Where PIL is not installed, the port
reads an 8-bit RGB or RGBA PNG (`io/lut3d_file.read_png8`) and takes any
other file for a missing layer.  A layer of another size is resized
with `jax.image.resize`'s bilinear weights
(`pixel/resample.resize_bilinear`: antialiased when it shrinks).  The op
has no fused form.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..core.params import cfield, params
from ..core.types import Colorspace
from .base import Op, OpPlan, PlanContext, register


@params(op="drawlayer", version=1)
@dataclasses.dataclass
class DrawLayerParams:
    stroke_commit_hash: int = cfield("I", 0)
    layer_name: str = cfield("s:64", "")
    work_profile: str = cfield("s:256", "")
    sidecar_timestamp: int = cfield("q", 0)
    layer_order: int = cfield("i", -1)


def _load_layer(name: str, search_dir: str):
    """-> (4, H, W) premultiplied RGBA float32, or None."""
    if not name:
        return None
    for cand in (os.path.join(search_dir or ".", name + ".npz"),
                 os.path.join(search_dir or ".", name)):
        if not os.path.exists(cand):
            continue
        if cand.endswith(".npz"):
            data = np.load(cand)
            rgba = np.asarray(data["rgba"], np.float32)
            if rgba.shape[-1] == 4:
                rgba = rgba.transpose(2, 0, 1)
            return rgba
        from ..io.lut3d_file import pil_image, read_png8

        Image = pil_image()
        if Image is not None:
            # whatever PIL fails on is a missing layer, as in the JAX
            # package
            try:
                img = np.asarray(Image.open(cand).convert("RGBA"))
            except Exception:
                return None
        else:
            try:
                img = read_png8(cand)
            except (ValueError, NotImplementedError):
                return None
            if img.shape[-1] == 3:  # PIL's convert("RGBA"): opaque
                img = np.concatenate(
                    [img, np.full(img.shape[:2] + (1,), 255, np.uint8)], -1)
        rgba = (np.asarray(img, np.float32) / 255.0).transpose(2, 0, 1)
        rgba[:3] *= rgba[3:4]  # premultiply
        return rgba
    return None


@register
class DrawLayer(Op):
    name = "drawlayer"
    input_colorspace = Colorspace.WORK_RGB

    def enabled_by_default(self, meta):
        return False

    def plan(self, ctx: PlanContext, spec_in, p: DrawLayerParams) -> OpPlan:
        search = getattr(ctx.meta, "sidecar_dir", "") or ""
        layer = _load_layer(p.layer_name, search)
        if layer is None:
            if p.layer_name:
                raise ValueError(
                    f"drawlayer: layer '{p.layer_name}' not found in "
                    f"'{search}' (export the painted layer as "
                    f"{p.layer_name}.npz next to the sidecar)")
            return OpPlan(spec_in=spec_in, spec_out=spec_in, static=None)
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=("layer", p.layer_name,
                              layer.shape[1], layer.shape[2]),
                      aux=layer)

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p: DrawLayerParams):
        if plan.static is None:
            return None
        return {"rgba": plan.aux}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        if plan.static is None:
            return x
        rgba = c["rgba"]
        h, w = x.shape[1], x.shape[2]
        if tuple(rgba.shape[1:]) != (h, w):
            from ..pixel.resample import resize_bilinear

            rgba = resize_bilinear(rgba, (4, h, w))
        color, alpha = rgba[:3], rgba[3:4]
        # source-over with the premultiplied layer colour
        return color + x * (1.0 - alpha)
