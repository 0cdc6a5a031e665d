"""Op protocol and registry — the counterpart of the reference's IOP plugin
vtable (`ansel/src/iop/iop_api.h:78-316`), as in `ansel_tpu/ops/base.py`.

Each op contributes
  * host-side **planning** (`plan`): static geometry/colorspace resolution;
  * host-side **coefficients** (`coeffs`): numbers derived from params
    (numpy arrays and Python floats; the engine moves them to the device);
  * a device **apply** (plain torch, or a hand-written kernel);
  * optionally a **pointwise spec**: the same per-pixel function in two
    forms, a plain torch `fn` and an opcode for the chain kernel
    (`kernels/pointwise.py`, `csrc/pointwise_chain.cu`).

Branches of an op that this package has not ported raise
NotImplementedError from `plan`, so an unsupported history fails before
any pixel is touched.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..core.types import Colorspace, ImageSpec, RawMeta


# The 88 ops `ansel_tpu` registers (`ansel_tpu.ops.base.all_ops()`,
# pinned by tests/test_torch_coverage.py).  The planner refuses an item of
# one of these that the port has not registered yet, and skips any other
# name into `Pipeline.unsupported`, as the JAX package skips every name it
# does not register (a module of a newer darktable).
REFERENCE_OPS = frozenset({
    "ashift", "atrous", "basecurve", "basicadj", "bilat", "bilateral",
    "bloom", "blurs", "borders", "cacorrect", "cacorrectrgb", "censorize",
    "channelmixer", "channelmixerrgb", "clipping", "colisa", "colorbalance",
    "colorbalancergb", "colorchecker", "colorcontrast", "colorcorrection",
    "colorequal", "colorin", "colorize", "colormapping", "colorout",
    "colorprimaries", "colorreconstruct", "colorzones", "crop", "crystgrain",
    "defringe", "demosaic", "denoiseprofile", "diffuse", "dither",
    "drawlayer", "exposure", "filmic", "filmicrgb", "finalscale", "flip",
    "gamma", "globaltonemap", "graduatednd", "grain", "hazeremoval",
    "highlights", "highpass", "hotpixels", "initialscale", "invert", "lens",
    "levels", "liquify", "lowlight", "lowpass", "lut3d", "mask_manager",
    "monochrome", "negadoctor", "nlmeans", "profile_gamma", "rawdenoise",
    "rawdenoiseai", "rawprepare", "relight", "restorescans", "retouch",
    "rgbcurve", "rgblevels", "rotatepixels", "scalepixels", "shadhi",
    "sharpen", "soften", "splittoning", "splittoningrgb", "spots",
    "temperature", "tonecurve", "toneequal", "tonemap", "velvia", "vibrance",
    "vignette", "watermark", "zonesystem",
})


def not_ported(op: str, branch: str):
    """The error every unported branch raises at plan time."""
    return NotImplementedError(
        f"{op}: {branch} is not ported to ansel_tpu_torch yet")


@dataclasses.dataclass
class PlanContext:
    """Pipeline-global planning state threaded through ops (the
    reference's `dt_dev_pixelpipe_iop_t` contract fields)."""

    meta: RawMeta
    scale: float = 1.0
    processed_maximum: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    wb_coeffs: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    notes: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class OpPlan:
    """Static, hashable result of planning one op instance."""

    spec_in: ImageSpec
    spec_out: ImageSpec
    static: Any = None
    enabled: bool = True
    aux: Any = None


class Op:
    """Base op. Subclasses set `name` and override what they need."""

    name: str = ""
    input_colorspace: Optional[Colorspace] = None
    mandatory: bool = False

    # --- host side ---------------------------------------------------------
    def default_params(self, meta: RawMeta):
        from ..core.params import params_class

        return params_class(self.name)()

    def enabled_by_default(self, meta: RawMeta) -> bool:
        return self.mandatory

    def plan(self, ctx: PlanContext, spec_in: ImageSpec, p) -> OpPlan:
        return OpPlan(spec_in=spec_in, spec_out=spec_in)

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p):
        """-> dict of np arrays / python floats (or None)."""
        return None

    # --- device side -------------------------------------------------------
    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        return x

    def pointwise_spec(self, plan: OpPlan, ctx: PlanContext):
        """Fusion hook: a PointwiseSpec when apply is a pure per-pixel
        function on a (3, H, W) tensor; None to opt out."""
        return None

    # --- backward ROI planning (reference modify_roi_in) -------------------
    window_halo: Optional[int] = None

    def roi_in(self, plan: OpPlan, ctx: PlanContext, win):
        """Input window (y0, x0, h, w) of spec_in needed for output window
        `win`; None demands the whole frame.  Declared stencils
        (window_halo) and pointwise stages that take no pixel position
        window; anything else is a full-frame boundary."""
        si, so = plan.spec_in, plan.spec_out
        if tuple(win) == (0, 0, so.height, so.width):
            return (0, 0, si.height, si.width)
        halo = self.window_halo
        if halo is None:
            pw = self.pointwise_spec(plan, ctx)
            if pw is not None and not pw.needs_pos:
                halo = 0
        if halo is None:
            return None
        if (si.height, si.width) != (so.height, so.width):
            return None
        y0 = max(0, win[0] - halo)
        x0 = max(0, win[1] - halo)
        y1 = min(si.height, win[0] + win[2] + halo)
        x1 = min(si.width, win[1] + win[3] + halo)
        return (y0, x0, y1 - y0, x1 - x0)


@dataclasses.dataclass(frozen=True)
class PointwiseSpec:
    """One per-pixel stage in two forms.

    fn(x, c) -> x: the plain torch version on a (3, H, W) tensor, with
      `c` the stage's coefficient dict of device tensors; fn(x, c, yy, xx)
      where `needs_pos` is set, yy and xx each pixel's float32 row and
      column in x.
    opcode, ints: the chain kernel's stage (csrc/pointwise_chain.cu) and
      its static integers (at most eight).
    consts: names of coefficient entries the kernel reads, in order, each
      flattened row-major to float32.
    extra: host constants the kernel reads after them (matrices baked in
      at plan time, float64 folds the reference computes in Python).
    needs_pos: the stage reads each pixel's position in its array (the
      Pallas kernel's `with_pos`), so it is a full-frame boundary of the
      ROI walk; the chain kernel derives the positions from the flat
      index and the array's width."""

    fn: Any
    opcode: int
    consts: tuple = ()
    ints: tuple = ()
    extra: tuple = ()
    needs_pos: bool = False


_OPS: Dict[str, Op] = {}


def register(op_cls):
    """Class decorator: instantiate and register an op implementation."""
    inst = op_cls()
    assert inst.name, f"{op_cls} missing name"
    _OPS[inst.name] = inst
    return op_cls


def get_op(name: str) -> Optional[Op]:
    return _OPS.get(name)


def all_ops() -> Dict[str, Op]:
    return dict(_OPS)


def full_dims(spec: ImageSpec):
    """(full_h, full_w) of the frame this spec belongs to: size-adaptive
    planning (wavelet scale counts) uses the whole frame's dims, so a
    windowed pipe plans the same algorithm as the full one."""
    return (spec.full_h or spec.height, spec.full_w or spec.width)


def pad_to(img: np.ndarray, spec: ImageSpec) -> np.ndarray:
    """Edge-replicate pad a host image up to the spec's padded shape."""
    if img.ndim == 2:
        h, w = img.shape
        return np.pad(img, ((0, spec.pad_h - h), (0, spec.pad_w - w)), mode="edge")
    _, h, w = img.shape
    return np.pad(img, ((0, 0), (0, spec.pad_h - h), (0, spec.pad_w - w)), mode="edge")


def channel_mean(x):
    """The mean of a (3, H, W) tensor's planes as XLA computes
    `jnp.mean(x, axis=0)`: their sum times float32(1/3)."""
    return (x[0] + x[1] + x[2]) * (1.0 / 3.0)
