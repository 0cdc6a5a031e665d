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

A history item's blend parameters are decoded as the JAX package does:
an undecodable blob, `mask_mode == MASK_DISABLED` or a stage that changes
the array's shape plans as no blend.  `CompiledPipe` keeps what a pipe
built (its device coefficients and packed steps) in `_PIPE_CACHE`, keyed
by `Pipeline.signature()`, and reports each build or reuse to the
supervisor (`core/supervisor.py`) as the JAX package reports its
compile cache.

An export scale below 1 injects `initialscale` (everything after the
camera-RGB stage runs at the export size), any other scale but 1
`finalscale`, as the JAX package plans them.  A history item whose op
the JAX package does not register either (a module of a newer darktable)
is skipped into `Pipeline.unsupported`, as there.

Not ported: active blends, drawn and raster masks, PREVIEW/THUMBNAIL
pipes (their PPG override), and every op of the JAX package's registry
(`ops.base.REFERENCE_OPS`) not registered in `ansel_tpu_torch.ops`.  Each
raises NotImplementedError while planning.
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
    multi_priority: int = 0


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
    DT_DEV_PIXELPIPE_*).  PREVIEW and THUMBNAIL are not ported."""

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
    Python floats and lists) -> float32 tensors on `device`."""
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
    shapes (crystgrain's kernel banks) as a list of them."""
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
                 device="cuda", scale: float = 1.0,
                 order_version=None, pipe_type: str = PipeType.EXPORT,
                 out_window: Optional[Tuple[int, int, int, int]] = None,
                 roi: bool = True):
        self.device = _check_device(device)
        if pipe_type in (PipeType.PREVIEW, PipeType.THUMBNAIL):
            raise not_ported("pipeline", f"the {pipe_type} pipe "
                             "(its fast-demosaic override)")
        self.pipe_type = pipe_type
        self.meta = meta
        self.ctx = PlanContext(meta=meta, scale=scale)
        self.stages: List[PlannedOp] = []
        self.unsupported: List[str] = []
        self.ctx.notes["pipe_type"] = pipe_type

        spec = ImageSpec(
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
            # blending (reference dt_develop_blend_process) only for an
            # active blend on a geometry-preserving stage, as the JAX
            # package plans it; an undecodable blob is no blend
            if item.blend_params is not None:
                bp = (item.blend_params
                      if isinstance(item.blend_params, blend_mod.BlendParams)
                      else blend_mod.decode_blend_params(item.blend_params))
                if (blend_mod.blend_is_active(bp) and plan.spec_in.array_shape
                        == plan.spec_out.array_shape):
                    raise not_ported(item.op, "blending and masks")
            self.stages.append(PlannedOp(item.op, op, plan, p,
                                         multi_priority=item.multi_priority))
            spec = plan.spec_out
        self.spec_out = spec

        # Backward ROI planning (reference modify_roi_in walk,
        # dev_pixelpipe.c:564-643), then re-plan the windowed suffix.
        self.windowed = False
        if roi:
            wins = self._backward_windows(out_window)
            if wins is not None:
                self._replan_windowed(wins)
                self.windowed = True
                self.spec_out = self.stages[-1].plan.spec_out

    # --- backward ROI -------------------------------------------------------
    def _backward_windows(self, out_window):
        """Per-stage (win_in, win_out) windows, walking the planned pipe
        backward; None if every window is the full frame (no-op)."""
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
            r = s.op.roi_in(s.plan, self.ctx, win_out)
            if r is None:
                # boundary: this stage computes the full frame; the
                # engine slices between it and its windowed consumer
                wins[i] = (full_in, full_out)
                win = full_in
            else:
                if tuple(r) != full_in:
                    any_proper = True
                wins[i] = (tuple(r), win_out)
                win = r
        return wins if any_proper else None

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
            new_stages.append(PlannedOp(s.name, s.op, plan, s.params,
                                        multi_priority=s.multi_priority))
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
                        s.plan.static))
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

    def _chain_spec(self, s: PlannedOp):
        """The stage's PointwiseSpec if the chain kernel can run it, else
        None."""
        if not self._fusable(s):
            return None
        return s.op.pointwise_spec(s.plan, self.ctx)

    def schedule(self, coeffs, start: int = 0, end: Optional[int] = None):
        """Stages [start, end) as run steps, given their device coefficients:
        ("stage", i, i + 1, c) runs one op; ("chain", i, j, Chain) runs
        stages i..j-1 as one chain (at most pointwise.MAX_STAGES long, and
        split where the ROI walk hands the next stage a smaller window
        than its producer's, after a full-frame boundary)."""
        end = len(self.stages) if end is None else end
        steps = []
        i = start
        while i < end:
            spec = self._chain_spec(self.stages[i])
            if spec is None:
                steps.append(("stage", i, i + 1, coeffs[i - start]))
                i += 1
                continue
            specs = [spec]
            j = i + 1
            while j < end and len(specs) < pw.MAX_STAGES \
                    and _same_window(self.stages[j - 1].plan.spec_out,
                                     self.stages[j].plan.spec_in):
                sp = self._chain_spec(self.stages[j])
                if sp is None:
                    break
                specs.append(sp)
                j += 1
            chain = pw.pack_chain(specs, coeffs[i - start:j - start],
                                  self.device)
            steps.append(("chain", i, j, chain))
            i = j
        return steps

    def run_steps(self, x: torch.Tensor, steps) -> torch.Tensor:
        """Run a schedule on `x`, the input of its first stage."""
        if not steps:
            return x
        start = steps[0][1]
        cur_spec = (self.stages[start - 1].plan.spec_out if start > 0
                    else self.spec_in)
        for kind, i, j, arg in steps:
            s = self.stages[i]
            x = _rewindow(x, cur_spec, s.plan.spec_in)
            if kind == "chain":
                x = pw.pointwise_chain(x.contiguous(), arg)
            else:
                x = s.op.apply(x, arg, s.plan, self.ctx)
            cur_spec = self.stages[j - 1].plan.spec_out
        return x

    def trace_fn(self, start: int = 0, end: Optional[int] = None):
        """run(x, coeffs) over stages[start:end], coeffs being the device
        coefficients of those stages (the reference's entry of that name)."""

        def run(x, coeffs):
            return self.run_steps(x, self.schedule(coeffs, start, end))

        return run


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
    a list of arrays of unlike shapes."""
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
                     device="cuda", scale: float = 1.0,
                     order_version=None,
                     pipe_type: str = PipeType.EXPORT) -> CompiledPipe:
    return CompiledPipe(Pipeline(meta, history, device=device, scale=scale,
                                 order_version=order_version,
                                 pipe_type=pipe_type))
