"""Pipeline engine: history stack -> planned stages -> one run on one device.

Port of `ansel_tpu/pipeline/engine.py`.  The host half is copied:
`resolve_history` merges the user history with the mandatory modules and
sorts by iop-order, `Pipeline` plans each op (inserting `_convert`
stages), runs the backward ROI walk and re-plans windowed stages.  The
device half differs: there is no tracing or jit.  `CompiledPipe` moves
the coefficients to the device once, groups consecutive per-pixel stages
into chains (`kernels/pointwise.py`) and then runs the stages eagerly.
On CUDA a chain is one launch of the chain kernel; on the CPU it runs
the stages' plain functions in order.

A history item's blend parameters are decoded and planned as the JAX
package plans them: an undecodable blob, `mask_mode == MASK_DISABLED` or
a stage that changes the array's shape plans as no blend.  An active
blend rides the stage's chain as a keep and a blend record
(`pipeline/blend.blend_specs`) exactly where the JAX engine fuses it:
a per-pixel mask (`blend_fusable_pointwise`) in Lab or scene RGB on a
stage whose mask no later stage reads as its raster source.  Every other
blended stage runs the spatial path (`run_steps`): the RAW blend
colorspace through `apply_blend_raw`, drawn masks rasterised at the
stage's window origin from the pipe's `forms`, the raster side-band of
earlier stages' masks and the demosaic stage's raw-detail plane for the
details slider.  `CompiledPipe` keeps what a pipe built (its device
coefficients and packed steps) in `_PIPE_CACHE`, keyed by
`Pipeline.signature()` (which holds each blend's blob and form
geometry), and reports each build or reuse to the supervisor
(`core/supervisor.py`) as the JAX package reports its compile cache.

An export scale below 1 injects `initialscale` (everything after the
camera-RGB stage runs at the export size), any other scale but 1
`finalscale`, as the JAX package plans them.  A history item whose op
the JAX package does not register either (a module of a newer darktable)
is skipped into `Pipeline.unsupported`, as there.

The PREVIEW and THUMBNAIL pipes rewrite a `demosaic` item given as a
dict or None to PPG (method 0), plan no backward ROI, and let filmicrgb,
denoiseprofile and nlmeans take their fast branches, as the JAX package
does (`ansel_tpu/pipeline/engine.py:229-238, 249, 323`).

The multi-device pipes (`parallel/`) plan a window of a larger frame
(`spec_in`, as the JAX package does), or a band of the output rows whose
stage windows start on a multiple of `row_align` rows, and run it from
the rows of its input window alone (`run_steps(x_spec=)`).  A band plans
with `exact_window`, which the ops read from `ctx.notes`: there a stage
whose window would compute other values than the whole frame's on the
band's rows (a whole-frame statistic, a stencil wider than the windowed
pipe's halo) asks for the window that computes the same values, or the
whole frame.  A plain `out_window` keeps the JAX package's windows.

The JAX engine takes the raw-detail plane at demosaic and keeps each
raster mask at its source stage's frame; neither follows a later change
of frame, and a blend that reads one on another frame fails there on a
broadcast (ROADMAP R14).  The port refuses such a history while planning
(`_refuse_moved_side_planes`), naming the blended stage and the stage
that changed the frame.

Not ported: every op of the JAX package's registry
(`ops.base.REFERENCE_OPS`) not registered in `ansel_tpu_torch.ops`.
Each raises NotImplementedError while planning.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..color import matrices as cm
from ..color import transforms as tr
from ..core import conf as conf_mod
from ..core import params as params_mod
from ..core import supervisor as sup
from ..core.order import sort_key
from ..core.types import CFAPattern, Colorspace, ImageSpec, RawMeta
from ..kernels import pointwise as pw
from ..ops import base as ops_base
from ..ops.base import PlanContext, PointwiseSpec, not_ported
from . import blend as blend_mod
from . import masks as masks_mod


@dataclasses.dataclass
class HistoryItem:
    """One history entry — reference `dt_dev_history_item_t`
    (src/develop/dev_history.h:50-74), minus GUI fields."""

    op: str
    params: Any = None          # dataclass, dict, or raw bytes
    version: Optional[int] = None
    enabled: bool = True
    iop_order: Optional[float] = None
    multi_priority: int = 0
    blend_params: Any = None


def _resolve_params(item: HistoryItem, meta: RawMeta):
    op = ops_base.get_op(item.op)
    if isinstance(item.params, (bytes, bytearray)):
        return params_mod.decode_blob(item.op, item.version or 1, bytes(item.params))
    if isinstance(item.params, dict):
        cls = params_mod.params_class(item.op, item.version)
        base = op.default_params(meta) if op else cls()
        return dataclasses.replace(base, **item.params)
    if item.params is None and op is not None:
        return op.default_params(meta)
    return item.params


def resolve_history(meta: RawMeta, history: List[HistoryItem],
                    order_version: int = None):
    """Merge history with mandatory modules and order the stack
    (reference dt_dev_read_history_ext's default-module injection +
    iop-order sort); order_version defaults to v30."""
    from ..core import order as order_mod

    version = (order_version if order_version is not None
               else order_mod.ORDER_V30)
    items = list(history)
    present = {h.op for h in items}
    for name, op in ops_base.all_ops().items():
        if name not in present and op.enabled_by_default(meta):
            items.append(HistoryItem(op=name, enabled=True))
    items.sort(key=lambda h: sort_key(h.op, h.iop_order,
                                      h.multi_priority, version))
    return items


@dataclasses.dataclass
class PlannedOp:
    name: str
    op: ops_base.Op
    plan: ops_base.OpPlan
    params: Any
    multi_priority: int = 0    # instance id (the raster side-band's key)
    blend: Any = None          # BlendParams when active
    blend_static: Any = None   # the blend blob (and form geometry): keys the cache
    blend_form: Any = None     # masks.Form when the blend uses a drawn mask


class _ConvertOp(ops_base.Op):
    """Synthetic colorspace-conversion stage, inserted by the planner where
    an op's declared input space differs from the pipeline's current one
    (reference src/develop/pixelpipe_cpu.c:54-77)."""

    name = "_convert"

    def plan_pair(self, spec_in, dst: Colorspace):
        return ops_base.OpPlan(
            spec_in=spec_in,
            spec_out=dataclasses.replace(spec_in, colorspace=dst),
            static=(spec_in.colorspace, dst),
        )

    def apply(self, x, c, plan, ctx):
        src, dst = plan.static
        white = cm.PIPE_WHITE_XYZ  # D50 Lab, like the reference
        if (src, dst) == (Colorspace.WORK_RGB, Colorspace.LAB):
            xyz = tr.apply_matrix(x, cm.XYZ_FROM_WORK.tolist())
            return tr.xyz_to_lab(xyz, white)
        if (src, dst) == (Colorspace.LAB, Colorspace.WORK_RGB):
            xyz = tr.lab_to_xyz(x, white)
            return tr.apply_matrix(xyz, cm.WORK_FROM_XYZ.tolist())
        raise ValueError(f"no conversion {src} -> {dst}")

    def pointwise_spec(self, plan, ctx):
        """The fused form (cube root as a power, as in the reference's
        fused chain)."""
        src, dst = plan.static
        white = [float(v) for v in cm.PIPE_WHITE_XYZ]

        if (src, dst) == (Colorspace.WORK_RGB, Colorspace.LAB):
            M = cm.XYZ_FROM_WORK.tolist()

            def fn(b, c):
                xyz = tr.apply_matrix(b, M)
                f = []
                for i in range(3):
                    r = tr.fdiv(xyz[i], white[i])
                    f.append(torch.where(
                        r > tr.LAB_EPS, torch.clamp(r, min=1e-12) ** (1.0 / 3.0),
                        tr.fdiv(tr.LAB_KAPPA * r + 16.0, 116.0)))
                return torch.stack([116.0 * f[1] - 16.0,
                                    500.0 * (f[0] - f[1]),
                                    200.0 * (f[1] - f[2])])

            opcode = pw.OP_CONVERT_WORK_LAB
        elif (src, dst) == (Colorspace.LAB, Colorspace.WORK_RGB):
            M = cm.WORK_FROM_XYZ.tolist()

            def fn(b, c):
                fy = tr.fdiv(b[0] + 16.0, 116.0)
                fx = fy + tr.fdiv(b[1], 500.0)
                fz = fy - tr.fdiv(b[2], 200.0)
                out = []
                for i, fc in enumerate((fx, fy, fz)):
                    f3 = fc * fc * fc
                    out.append(torch.where(f3 > tr.LAB_EPS, f3,
                                           tr.fdiv(116.0 * fc - 16.0,
                                                   tr.LAB_KAPPA))
                               * white[i])
                return tr.apply_matrix(torch.stack(out), M)

            opcode = pw.OP_CONVERT_LAB_WORK
        else:
            return None
        extra = tuple(float(v) for row in M for v in row) + tuple(white)
        return PointwiseSpec(fn=fn, opcode=opcode, extra=extra)


def _same_window(a: ImageSpec, b: ImageSpec) -> bool:
    return (a.org_y == b.org_y and a.org_x == b.org_x
            and a.pad_h == b.pad_h and a.pad_w == b.pad_w
            and a.height == b.height and a.width == b.width)


def _rewindow(x, spec_from: ImageSpec, spec_to: ImageSpec):
    """Slice the producing stage's buffer down to the consuming stage's
    (possibly smaller) planned window, re-padding to lane shape.
    Identical windows are a no-op."""
    if _same_window(spec_from, spec_to):
        return x
    y0 = spec_to.org_y - spec_from.org_y
    x0 = spec_to.org_x - spec_from.org_x
    assert y0 >= 0 and x0 >= 0, (spec_from, spec_to)
    # slice as much real data as the source buffer holds, then edge-pad
    y1 = min(y0 + spec_to.pad_h, spec_from.pad_h)
    x1 = min(x0 + spec_to.pad_w, spec_from.pad_w)
    cut = x[..., y0:y1, x0:x1]
    py = spec_to.pad_h - (y1 - y0)
    px = spec_to.pad_w - (x1 - x0)
    if py or px:
        batch = cut[None] if cut.dim() == 2 else cut
        cut = F.pad(batch, (0, px, 0, py), mode="replicate")
        cut = cut[0] if x.dim() == 2 else cut
    return cut.contiguous()


_CONVERT = _ConvertOp()
_CONVERTIBLE = {
    (Colorspace.WORK_RGB, Colorspace.LAB),
    (Colorspace.LAB, Colorspace.WORK_RGB),
}


class PipeType:
    """The reference's four pipe kinds (dev_pixelpipe.h
    DT_DEV_PIXELPIPE_*): FULL, PREVIEW (the downscaled navigator),
    THUMBNAIL (library mipmaps), EXPORT.  PREVIEW and THUMBNAIL trade
    demosaic quality for speed as in the reference (PPG)."""

    FULL = "full"
    PREVIEW = "preview"
    THUMBNAIL = "thumbnail"
    EXPORT = "export"


def _check_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def coeffs_to_device(coeffs, device) -> List[Optional[dict]]:
    """Host coefficients (per stage: None or a dict of numpy arrays,
    Python floats, lists and dicts) -> float32 tensors on `device`."""
    dev = _check_device(device)
    out = []
    for c in coeffs:
        if c is None:
            out.append(None)
            continue
        out.append({k: _to_device(v, dev) for k, v in c.items()})
    return out


def _to_device(v, dev):
    """One coefficient as a float32 tensor; a list of arrays of unlike
    shapes (crystgrain's kernel banks) as a list of them, a dict of named
    arrays (rawdenoiseai's weights) as a dict of them."""
    if isinstance(v, dict):
        return {k: _to_device(e, dev) for k, e in v.items()}
    try:
        host = np.asarray(v, dtype=np.float32)
    except ValueError:
        return [_to_device(e, dev) for e in v]
    return torch.as_tensor(host, device=dev)


class Pipeline:
    """A planned pipe for one (image, history) on one device: the CUDA
    card unless `device` names another; a missing card raises
    RuntimeError rather than falling back to the CPU."""

    def __init__(self, meta: RawMeta, history: List[HistoryItem], *,
                 device="cuda", scale: float = 1.0, forms=None,
                 order_version=None, pipe_type: str = PipeType.EXPORT,
                 out_window: Optional[Tuple[int, int, int, int]] = None,
                 roi: bool = True, spec_in: Optional[ImageSpec] = None,
                 row_align: int = 1, exact_window: bool = False):
        self.device = _check_device(device)
        self.row_align = row_align
        fast = pipe_type in (PipeType.PREVIEW, PipeType.THUMBNAIL)
        if fast:
            # the fast-demosaic override: only an item whose params are a
            # dict or None; a decoded blob keeps its method
            history = [
                (dataclasses.replace(
                    h, params=dict(h.params or {}, demosaicing_method=0))
                 if h.op == "demosaic"
                 and isinstance(h.params, (dict, type(None)))
                 else h)
                for h in history]
        self.pipe_type = pipe_type
        self.meta = meta
        self.ctx = PlanContext(meta=meta, scale=scale)
        self.stages: List[PlannedOp] = []
        self.unsupported: List[str] = []
        self.forms = forms or {}  # drawn-mask forms {id: masks.Form}
        self.ctx.notes["forms"] = self.forms  # spots and retouch read them
        self.ctx.notes["pipe_type"] = pipe_type
        if exact_window:
            self.ctx.notes["exact_window"] = True

        # spec_in override: a window of a larger frame (org and full dims
        # set), which the row-sharded pipe (parallel/spatial.py) plans for
        # each shard, so size-adaptive planning (wavelet scale counts)
        # matches the full frame's
        spec = spec_in if spec_in is not None else ImageSpec(
            width=meta.width, height=meta.height, colorspace=Colorspace.RAW,
            channels=1,
            cfa=CFAPattern.XTRANS if meta.xtrans else meta.cfa,
        )
        self.spec_in = spec
        history = list(history)
        ops_present = {h.op for h in history}
        if scale < 1.0 - 1e-9 and "initialscale" not in ops_present:
            # downscale early: everything after the camera-RGB stage runs
            # at the export size (doc/resizing-scaling.md)
            history.append(HistoryItem("initialscale"))
        elif abs(scale - 1.0) > 1e-9 and "finalscale" not in ops_present:
            history.append(HistoryItem("finalscale"))
        for item in resolve_history(meta, history, order_version):
            if not item.enabled:
                continue
            op = ops_base.get_op(item.op)
            if op is None:
                if item.op in ops_base.REFERENCE_OPS:
                    raise not_ported(item.op, "this module")
                self.unsupported.append(item.op)
                continue
            p = _resolve_params(item, meta)
            need = op.input_colorspace
            if need is not None and need is not spec.colorspace:
                if (spec.colorspace, need) in _CONVERTIBLE:
                    cplan = _CONVERT.plan_pair(spec, need)
                    self.stages.append(
                        PlannedOp("_convert", _CONVERT, cplan, None))
                    spec = cplan.spec_out
                else:
                    # colorspace contract violation -> auto-disable, like the
                    # reference's format propagation (dev_pixelpipe.c:1158)
                    self.unsupported.append(f"{item.op} (colorspace skip)")
                    continue
            plan = op.plan(self.ctx, spec, p)
            stage = PlannedOp(item.op, op, plan, p,
                              multi_priority=item.multi_priority)
            # blending (reference dt_develop_blend_process) only for an
            # active blend on a geometry-preserving stage, as the JAX
            # package plans it; an undecodable blob is no blend
            if item.blend_params is not None:
                bp = (item.blend_params
                      if isinstance(item.blend_params, blend_mod.BlendParams)
                      else blend_mod.decode_blend_params(item.blend_params))
                if (blend_mod.blend_is_active(bp) and plan.spec_in.array_shape
                        == plan.spec_out.array_shape):
                    stage.blend = bp
                    # the whole blob keys the pipe cache, and with a drawn
                    # mask the form's geometry
                    blend_sig = bp.codec.encode(bp)
                    if bp.mask_mode & blend_mod.MASK_SHAPE:
                        stage.blend_form = self.forms.get(bp.mask_id)
                        blend_sig = (blend_sig, masks_mod.form_signature(
                            stage.blend_form, self.forms))
                    stage.blend_static = blend_sig
            self.stages.append(stage)
            spec = plan.spec_out
        self.spec_out = spec

        # Backward ROI planning (reference modify_roi_in walk,
        # dev_pixelpipe.c:564-643), then re-plan the windowed suffix; the
        # fast pipes plan none
        self.windowed = False
        if roi and not fast:
            wins = self._backward_windows(out_window)
            if wins is not None:
                self._replan_windowed(wins)
                self.windowed = True
                self.spec_out = self.stages[-1].plan.spec_out
        self._refuse_moved_side_planes()

    # --- R14: side planes on another frame ----------------------------------
    def _refuse_moved_side_planes(self):
        """Raise ValueError where a blend would read the raw-detail plane or
        a raster mask on another frame than its own (ROADMAP R14): a
        details-refined blend whose input frame differs from demosaic's
        output, or a raster consumer whose input frame differs from its
        source stage's output.  The JAX package fails on both at run time
        (a broadcast of the two arrays), so the frame is the array's
        (height, width)."""
        names = [s.name for s in self.stages]
        demosaic = names.index("demosaic") if "demosaic" in names else None
        for k, s in enumerate(self.stages):
            bp = s.blend
            if bp is None:
                continue
            here = s.plan.spec_in.array_shape[-2:]
            if abs(bp.details) > 1e-6 and demosaic is not None \
                    and demosaic < k:
                ref = self.stages[demosaic].plan.spec_out.array_shape[-2:]
                if here != ref:
                    raise ValueError(
                        f"stage '{s.name}': its details slider reads the "
                        f"raw-detail plane of demosaic's frame {ref}, but "
                        f"'{self._frame_changer(demosaic, k, ref)}' changed "
                        f"the frame to {here} before it; the plane is not "
                        "carried through a change of frame (R14)")
            src = (_raster_source_name(bp)
                   if bp.mask_mode & blend_mod.MASK_RASTER else "")
            sources = [i for i in range(k) if names[i] == src
                       and self.stages[i].blend is not None]
            if not sources:
                continue  # an empty source fills; a missing one raises later
            i = next((i for i in sources if self.stages[i].multi_priority
                      == bp.raster_mask_instance), sources[0])
            ref = self.stages[i].plan.spec_out.array_shape[-2:]
            if here != ref:
                raise ValueError(
                    f"stage '{s.name}': its raster mask comes from "
                    f"'{src}' on the frame {ref}, but "
                    f"'{self._frame_changer(i, k, ref)}' changed the frame "
                    f"to {here} before it; the mask is not carried through "
                    "a change of frame (R14)")

    def _frame_changer(self, i, k, ref) -> str:
        """The first stage strictly between i and k that changes the
        array's frame, or else the first whose input window differs from
        `ref`."""
        between = self.stages[i + 1:k]
        for t in between:
            if t.plan.spec_in.array_shape[-2:] \
                    != t.plan.spec_out.array_shape[-2:]:
                return t.name
        return next((t.name for t in between
                     if t.plan.spec_in.array_shape[-2:] != ref),
                    "the backward ROI window")

    # --- backward ROI -------------------------------------------------------
    def _backward_windows(self, out_window):
        """Per-stage (win_in, win_out) windows, walking the planned pipe
        backward; None if every window is the full frame (no-op).  Each
        input window's first row is rounded down to a multiple of
        `row_align` (1 by default; the row-sharded pipe's 24, a multiple
        of the 8-row padding and the CFA periods, makes a window that
        reaches the frame's last row hold the whole-frame pipe's own pad
        rows, so it computes what that pipe computes there)."""
        n = len(self.stages)
        if n == 0:
            return None
        so_last = self.stages[-1].plan.spec_out
        win = (tuple(out_window) if out_window is not None
               else (0, 0, so_last.height, so_last.width))
        wins = [None] * n
        any_proper = False
        for i in reversed(range(n)):
            s = self.stages[i]
            so = s.plan.spec_out
            si = s.plan.spec_in
            full_out = (0, 0, so.height, so.width)
            full_in = (0, 0, si.height, si.width)
            win_out = tuple(win)
            r, use_out = self._blend_roi(s, win_out, full_out)
            if r is None:
                # boundary: this stage computes the full frame; the
                # engine slices between it and its windowed consumer
                wins[i] = (full_in, full_out)
                win = full_in
            else:
                a = self.row_align
                if a > 1 and r[0] % a:
                    r = (r[0] // a * a, r[1], r[2] + r[0] % a, r[3])
                if tuple(r) != full_in:
                    any_proper = True
                wins[i] = (tuple(r), use_out)
                win = r
        return wins if any_proper else None

    def _blend_roi(self, s: PlannedOp, win_out, full_out):
        """(input window, the output window the stage computes) for
        `win_out`, as the JAX package's blend-aware walk gives them: drawn
        masks rasterise at the window's origin and parametric ones are
        per pixel, so a blended stage windows; feathering and blur grow
        the window it computes by their reach, and a raster source or the
        details slider (whose producers' buffers hold another window)
        make it a full-frame boundary."""
        so = s.plan.spec_out
        bp = s.blend
        if win_out == full_out or bp is None:
            return s.op.roi_in(s.plan, self.ctx, win_out), win_out
        if bp.mask_mode & blend_mod.MASK_RASTER or abs(bp.details) > 1e-6:
            return None, win_out
        grow = 0
        if bp.feathering_radius > 0.1:
            grow += max(1, int(bp.feathering_radius))
        if bp.blur_radius > 0.1:
            grow += int(3.0 * bp.blur_radius + 1.0)
        y0 = max(0, win_out[0] - grow)
        x0 = max(0, win_out[1] - grow)
        y1 = min(so.height, win_out[0] + win_out[2] + grow)
        x1 = min(so.width, win_out[1] + win_out[3] + grow)
        gwin = (y0, x0, y1 - y0, x1 - x0)
        r = s.op.roi_in(s.plan, self.ctx, gwin)
        return r, (gwin if r is not None else win_out)

    @staticmethod
    def _window_spec(spec: ImageSpec, win) -> ImageSpec:
        y0, x0, h, w = win
        if (y0, x0, h, w) == (0, 0, spec.height, spec.width):
            return spec
        return dataclasses.replace(
            spec, width=w, height=h, pad_w=0, pad_h=0,
            org_y=spec.org_y + y0, org_x=spec.org_x + x0,
            full_h=spec.full_h or spec.height,
            full_w=spec.full_w or spec.width,
            cfa=spec.cfa.shifted(y0, x0) if spec.cfa else None)

    def _replan_windowed(self, wins):
        """Second planning pass with windowed specs (side effects like
        processed_maximum replay in order)."""
        ctx = PlanContext(meta=self.meta, scale=self.ctx.scale)
        ctx.notes.update(self.ctx.notes)
        new_stages: List[PlannedOp] = []
        for s, (win_in, win_out) in zip(self.stages, wins):
            spec_in = self._window_spec(s.plan.spec_in, win_in)
            ctx.notes["_win_out"] = win_out
            if s.name == "_convert":
                plan = _CONVERT.plan_pair(spec_in, s.plan.static[1])
            else:
                plan = s.op.plan(ctx, spec_in, s.params)
            new_stages.append(PlannedOp(
                s.name, s.op, plan, s.params, multi_priority=s.multi_priority,
                blend=s.blend, blend_static=s.blend_static,
                blend_form=s.blend_form))
        ctx.notes.pop("_win_out", None)
        self.stages = new_stages
        self.ctx = ctx

    # --- static signature: the key of the pipe cache -------------------------
    def signature(self) -> Tuple:
        sig = [self.spec_in.array_shape]
        for s in self.stages:
            si, so = s.plan.spec_in, s.plan.spec_out
            sig.append((s.name, s.multi_priority,
                        si.array_shape, so.array_shape,
                        (si.org_y, si.org_x, so.org_y, so.org_x),
                        s.plan.static, s.blend_static))
        return tuple(sig)

    def coeffs(self) -> List[Any]:
        """Host coefficients per stage (numpy / Python floats)."""
        ctx = PlanContext(meta=self.meta, scale=self.ctx.scale)
        out = []
        for s in self.stages:
            # replay planning side effects (running processed_maximum)
            s.op.plan(ctx, s.plan.spec_in, s.params)
            out.append(s.op.coeffs(ctx, s.plan, s.params))
        return out

    # --- the run ------------------------------------------------------------
    @staticmethod
    def _fusable(s: PlannedOp) -> bool:
        """Geometry-preserving 3-channel stage."""
        return (s.plan.spec_in.array_shape == s.plan.spec_out.array_shape
                and len(s.plan.spec_in.array_shape) == 3)

    def _raster_sources(self):
        """The names of the stages whose masks a later stage reads as its
        raster source (`ansel_tpu/pipeline/engine.py:471-487`)."""
        out = set()
        for s in self.stages:
            if s.blend is not None and s.blend.mask_mode & blend_mod.MASK_RASTER:
                src = _raster_source_name(s.blend)
                if src:
                    out.add(src)
        return out

    @staticmethod
    def _blend_cst(s: PlannedOp) -> int:
        return (blend_mod.CS_LAB if s.plan.spec_out.colorspace is Colorspace.LAB
                else blend_mod.CS_RGB_SCENE)

    def _chain_spec(self, s: PlannedOp, raster_sources=None):
        """The stage's PointwiseSpec if the chain kernel can run it, else
        None.  A blended stage joins a chain where the JAX engine fuses it:
        a per-pixel mask in Lab or scene RGB, not read by a later stage as
        its raster source (`raster_sources`, by default this pipe's)."""
        if not self._fusable(s):
            return None
        if s.blend is not None:
            if raster_sources is None:
                raster_sources = self._raster_sources()
            if (s.plan.spec_out.colorspace is Colorspace.RAW
                    or s.name in raster_sources
                    or not blend_mod.blend_fusable_pointwise(
                        s.blend, self._blend_cst(s))):
                return None
        return s.op.pointwise_spec(s.plan, self.ctx)

    def _chain_records(self, s: PlannedOp, raster_sources):
        """The chain records that run the stage: its spec, or keep, its
        spec and blend for a blended stage; None where it cannot ride a
        chain."""
        spec = self._chain_spec(s, raster_sources)
        if spec is None or s.blend is None:
            return None if spec is None else [spec]
        keep, blend = blend_mod.blend_specs(s.blend, self._blend_cst(s))
        return [keep, spec, blend]

    def schedule(self, coeffs, start: int = 0, end: Optional[int] = None):
        """Stages [start, end) as run steps, given their device coefficients:
        ("stage", i, i + 1, c) runs one op; ("blend", i, i + 1, c) one op
        and its blend on the spatial path; ("chain", i, j, Chain) runs
        stages i..j-1 as one chain (at most pointwise.MAX_STAGES records
        and MAX_CONSTS consts, and split where the ROI walk hands the next
        stage a smaller window than its producer's, after a full-frame
        boundary)."""
        end = len(self.stages) if end is None else end
        sources = self._raster_sources()
        steps = []
        i = start
        while i < end:
            specs = self._chain_records(self.stages[i], sources)
            c = coeffs[i - start]
            if specs is None:
                kind = "stage" if self.stages[i].blend is None else "blend"
                steps.append((kind, i, i + 1, c))
                i += 1
                continue
            cs = _stage_coeffs(specs, c)
            nconsts = _consts_of(specs, cs)
            j = i + 1
            while j < end and _same_window(self.stages[j - 1].plan.spec_out,
                                           self.stages[j].plan.spec_in):
                sp = self._chain_records(self.stages[j], sources)
                if sp is None:
                    break
                c = _stage_coeffs(sp, coeffs[j - start])
                n = _consts_of(sp, c)
                if len(specs) + len(sp) > pw.MAX_STAGES \
                        or nconsts + n > pw.MAX_CONSTS:
                    break
                specs += sp
                cs += c
                nconsts += n
                j += 1
            steps.append(("chain", i, j, pw.pack_chain(specs, cs,
                                                       self.device)))
            i = j
        return steps

    def run_steps(self, x: torch.Tensor, steps, carry=None,
                  x_spec: Optional[ImageSpec] = None) -> torch.Tensor:
        """Run a schedule on `x`, the input of its first stage.  `carry`
        (a dict, filled in place) holds what later stages of the same run
        read: the raster side-band ("masks", keyed by (name,
        multi_priority) and (name, None)) and the demosaic stage's
        raw-detail plane ("rawdetail").  `x_spec` is the window `x` holds
        where it is not the first stage's producer's (a row-sharded pipe
        hands each device the rows of its input window only)."""
        if not steps:
            return x
        carry = {} if carry is None else carry
        masks = carry.setdefault("masks", {})
        needs_detail = any(s.blend is not None and abs(s.blend.details) > 1e-6
                           for s in self.stages)
        start = steps[0][1]
        cur_spec = x_spec or (self.stages[start - 1].plan.spec_out
                              if start > 0 else self.spec_in)
        for kind, i, j, arg in steps:
            s = self.stages[i]
            x = _rewindow(x, cur_spec, s.plan.spec_in)
            if kind == "chain":
                x = pw.pointwise_chain(x.contiguous(), arg)
            elif kind == "blend":
                x = self._run_blended(x, s, arg, masks,
                                      carry.get("rawdetail"))
            else:
                x = s.op.apply(x, arg, s.plan, self.ctx)
            if s.name == "demosaic" and needs_detail:
                from ..pixel import detail as detail_mod

                wb = [max(float(v), 1e-6)
                      for v in self.ctx.meta.wb_coeffs[:3]]
                carry["rawdetail"] = detail_mod.rawdetail_mask(x, wb)
            cur_spec = self.stages[j - 1].plan.spec_out
        return x

    def _run_blended(self, x, s: PlannedOp, c, masks, rawdetail):
        """One stage and its blend on the spatial path
        (`ansel_tpu/pipeline/engine.py:623-700`)."""
        y = s.op.apply(x, c, s.plan, self.ctx)
        bp = s.blend
        drawn = None
        if s.blend_form is not None:
            # normalised shape coordinates refer to the whole frame; a
            # windowed stage rasterises at its window's origin
            spec = s.plan.spec_out
            drawn = masks_mod.rasterize(
                s.blend_form, self.forms, spec.array_shape[-2],
                spec.array_shape[-1], norm_h=spec.full_h or spec.height,
                norm_w=spec.full_w or spec.width,
                origin=(spec.org_y, spec.org_x), device=x.device)
        if s.plan.spec_out.colorspace is Colorspace.RAW:
            return blend_mod.apply_blend_raw(x, y, bp, drawn=drawn)
        raster = None
        if bp.mask_mode & blend_mod.MASK_RASTER:
            src = _raster_source_name(bp)
            if src:
                raster = masks.get((src, bp.raster_mask_instance),
                                   masks.get((src, None)))
                sup.event("raster_mask", "read",
                          f"{src}|{bp.raster_mask_instance}",
                          links={"consumer": s.name})
                if raster is None:
                    # a named source that cannot be resolved is an error
                    # (dt_dev_get_raster_mask); an empty one fills the mask
                    raise RuntimeError(
                        f"stage '{s.name}': raster mask source '{src}' "
                        f"(instance {bp.raster_mask_instance}) has no mask "
                        "upstream: enable a mask on the source module or "
                        "drop the raster blend")
        out, m = blend_mod.apply_blend(
            x, y, bp, blend_mod.prepare_parameters(bp), self._blend_cst(s),
            cm.WORK_Y, drawn=drawn, raster=raster, rawdetail=rawdetail,
            return_mask=True)
        sup.event("raster_mask", "create", f"{s.name}|{s.multi_priority}",
                  links={"stage": s.name})
        masks[(s.name, s.multi_priority)] = m
        masks.setdefault((s.name, None), m)
        return out

    def trace_fn(self, start: int = 0, end: Optional[int] = None):
        """run(x, coeffs, carry=None) over stages[start:end], coeffs being
        the device coefficients of those stages (the reference's entry of
        that name); a `carry` dict handed from one call to the next holds
        the raster side-band and the raw-detail plane across them, as the
        JAX package's segmented run carries them."""

        def run(x, coeffs, carry=None):
            return self.run_steps(x, self.schedule(coeffs, start, end),
                                  carry)

        return run


def _raster_source_name(bp) -> str:
    """A blend's raster source as a str ('' for none)."""
    src = bp.raster_mask_source
    if isinstance(src, bytes):
        src = src.split(b"\0")[0].decode("utf-8", "ignore")
    return (src or "").strip("\0")


def _stage_coeffs(specs, c) -> list:
    """A stage's coefficients for each of its chain records (the keep and
    blend records read none)."""
    return [{} if sp.opcode in (pw.OP_KEEP, pw.OP_BLEND) else c
            for sp in specs]


def _consts_of(specs, coeffs) -> int:
    """The consts the records take in a packed chain."""
    n = 0
    for sp, c in zip(specs, coeffs):
        n += sum(torch.as_tensor(c[k]).numel() for k in sp.consts) \
            + len(sp.extra)
    return n


def _fingerprint(coeffs) -> Tuple:
    """The host coefficients as `coeffs_to_device` will move them: per
    stage None or its (name, shape, float32 bytes) entries."""
    out = []
    for c in coeffs:
        if c is None:
            out.append(None)
            continue
        out.append(tuple((k, _host_print(c[k])) for k in sorted(c)))
    return tuple(out)


def _host_print(v):
    """(shape, float32 bytes) of one coefficient, or a tuple of them for
    a list of arrays of unlike shapes or a dict of named arrays."""
    if isinstance(v, dict):
        return tuple((k, _host_print(v[k])) for k in sorted(v))
    try:
        host = np.asarray(v, dtype=np.float32)
    except ValueError:
        return tuple(_host_print(e) for e in v)
    return host.shape, host.tobytes()


# (signature, device) -> (coefficient fingerprint, device coeffs, steps)
_PIPE_CACHE: Dict[Tuple, Tuple] = {}


class CompiledPipe:
    """A pipe ready to run: coefficients on the device and chains packed,
    once.  A pipe whose signature, device and coefficients equal an
    earlier one's reuses what that one built (conf `pipe.compile_cache`);
    the supervisor sees "create" for a new signature, "read" for a reuse
    and "update" where the coefficients changed."""

    def __init__(self, pipe: Pipeline):
        self.pipe = pipe
        self.device = pipe.device
        sig = pipe.signature()
        sig_key = hash(sig) & 0xFFFFFFFFFFFF
        key = (sig, str(self.device))
        use_cache = conf_mod.get_bool("pipe.compile_cache", True)
        host = pipe.coeffs()
        fp = _fingerprint(host)
        hit = _PIPE_CACHE.get(key) if use_cache else None
        if hit is not None and hit[0] == fp:
            sup.event("pipe", "read", sig_key, stages=len(pipe.stages))
            _, self.coeffs, self.steps = hit
            return
        sup.event("pipe", "create" if hit is None else "update", sig_key,
                  stages=len(pipe.stages))
        self.coeffs = coeffs_to_device(host, self.device)
        self.steps = pipe.schedule(self.coeffs)
        if use_cache:
            _PIPE_CACHE[key] = (fp, self.coeffs, self.steps)

    def fused_groups(self) -> List[List[str]]:
        """Stage names of each chain, in run order."""
        return [[s.name for s in self.pipe.stages[i:j]]
                for kind, i, j, _ in self.steps if kind == "chain"]

    def __call__(self, raw: np.ndarray) -> torch.Tensor:
        """raw: (H, W) float32 mosaic in sensor units (or padded already)."""
        spec = self.pipe.spec_in
        raw = np.asarray(raw, np.float32)
        if raw.shape != spec.array_shape:
            raw = ops_base.pad_to(raw, spec)
        return self.run_padded(torch.from_numpy(np.ascontiguousarray(raw))
                               .to(self.device))

    def run_padded(self, raw_dev: torch.Tensor) -> torch.Tensor:
        """Run on a padded mosaic already on the device; the result stays
        there."""
        return self.pipe.run_steps(raw_dev, self.steps)

    def output_array(self, raw: np.ndarray) -> np.ndarray:
        """Run and crop to the logical output size -> (3, H, W) float32."""
        y = self(raw).cpu().numpy()
        so = self.pipe.spec_out
        if y.ndim == 3:
            return y[:, : so.height, : so.width]
        return y[: so.height, : so.width]


def compile_pipeline(meta: RawMeta, history: List[HistoryItem], *,
                     device="cuda", scale: float = 1.0, forms=None,
                     order_version=None,
                     pipe_type: str = PipeType.EXPORT) -> CompiledPipe:
    return CompiledPipe(Pipeline(meta, history, device=device, scale=scale,
                                 forms=forms, order_version=order_version,
                                 pipe_type=pipe_type))
