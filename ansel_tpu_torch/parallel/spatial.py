"""Spatial (single-image) sharding: row shards with one explicit halo
exchange (`ansel_tpu/parallel/spatial.py`) — the blueprint's mapping of
the reference's tiling engine (`ansel/src/develop/tiling.c:241-680`
computes per-module overlap and processes overlapping tiles; here the
overlap is copied between neighbour shards, and each shard's body is the
single-device program, kernels included).

Design, as in the JAX package (the "shifted window" scheme):

  * The image rows are split into n equal shards of Hs rows.  Every
    shard runs ONE planned program over a window of Hs + 2*halo real
    image rows; boundary shards do not pad, their window shifts inward
    (shard 0 takes rows [0, Hs+2h), shard n-1 the last Hs+2h rows), and
    the output crop offset (0 / h / 2h, from the shard's index)
    compensates.  At true image edges the ops apply their own boundary
    handling; at interior cut edges the window-edge padding corrupts
    only rows inside the halo, which the crop drops.  The halo is the
    pipe's own backward-ROI growth (`Pipeline._backward_windows`).
  * One exchange of 2*halo rows each way (`mesh.ppermute`), not one per
    stage: the backward-ROI walk already compounds every stage's
    support.
  * CFA phase: window origins stay congruent modulo the pattern period
    (2 for Bayer, 6 for X-Trans), so the one planned program sees the
    same mosaic phase on every shard.
  * denoiseprofile's per-scale variance, a whole-frame statistic, is
    summed over each shard's owned rows and added over the axis
    (`mesh.psum`), from the geometry published in the plan's notes.

Not spatially shardable (ValueError): pipes where the backward-ROI walk
hits a full-frame stage (which it names), size-changing pipes, drawn-mask
blends, an indivisible height, a halo over half a shard.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.types import CFAPattern, Colorspace, ImageSpec, RawMeta
from ..pipeline.engine import CompiledPipe, HistoryItem, Pipeline
from .batch import _compiled_per_device, _on
from .mesh import Mesh, axis_index, ppermute, run_shards


def _cfa_period(meta: RawMeta) -> int:
    return 6 if meta.xtrans else 2


def required_halo(meta: RawMeta, history: List[HistoryItem],
                  shard_h: int) -> int:
    """Row halo one shard needs, from the pipe's own backward-ROI walk
    (an interior output strip of shard_h rows -> input window growth).
    Raises ValueError when the pipe cannot be row-sharded."""
    probe = Pipeline(meta, history, roi=False, device="cpu")
    if probe.unsupported:
        raise ValueError(f"unsupported ops: {probe.unsupported}")
    si, so = probe.spec_in, probe.spec_out
    if (si.height, si.width) != (so.height, so.width):
        raise ValueError(
            "spatial sharding needs a size-preserving pipe "
            f"(in {si.height}x{si.width} vs out {so.height}x{so.width})")
    for s in probe.stages:
        if s.blend is not None and s.blend_form is not None:
            raise ValueError(
                f"stage '{s.name}' blends with a drawn mask "
                "(org-aware raster) — not row-shardable")
    H, W = so.height, so.width
    y0 = max((H // 2 // shard_h) * shard_h, shard_h)
    if y0 + shard_h > H:
        raise ValueError(f"shard_h {shard_h} too large for height {H}")
    wins = probe._backward_windows((y0, 0, shard_h, W))
    if wins is None:
        return 0
    iy0, _ix0, ih, _iw = wins[0][0]
    if (iy0, ih) == (0, probe.spec_in.height) and ih > 3 * shard_h:
        # the walk hit a full-frame stage: name it for the error
        culprit = None
        win = (y0, 0, shard_h, W)
        for s in reversed(probe.stages):
            r = s.op.roi_in(s.plan, probe.ctx, win)
            if r is None:
                culprit = s.name
                break
            win = r
        raise ValueError(
            f"stage '{culprit or '?'}' demands the full frame — "
            "not row-shardable (use spatial_sharded_pipe)")
    top = y0 - iy0
    bottom = (iy0 + ih) - (y0 + shard_h)
    return max(top, bottom, 0)


class SpatialPipeline:
    """One image, rows sharded over the mesh axis `axis`, the full
    single-device body (kernels included) on each shard, with one halo
    exchange."""

    def __init__(self, meta: RawMeta, history: List[HistoryItem],
                 mesh: Mesh, axis: str = "sp", halo: Optional[int] = None):
        self.mesh = mesh
        self.axis = axis
        self.devices = mesh.axis_devices(axis)
        n = len(self.devices)
        self.n = n
        H, W = meta.height, meta.width
        per = _cfa_period(meta)
        if H % (n * per):
            raise ValueError(
                f"height {H} must divide into {n} shards of a multiple "
                f"of the CFA period {per} rows (pad the input first)")
        Hs = H // n
        self.shard_h = Hs

        h = required_halo(meta, history, Hs) if halo is None else halo
        h = -(-h // per) * per  # CFA-phase-aligned halo
        # the window must have no pad rows (pad_h == height): edge-
        # replicated pad rows carry the wrong CFA parity (a copy of an odd
        # row at an even position), which poisons plane-split stages near
        # the bottom of every shard.  Bump the halo until Hs + 2h is a
        # multiple of 8.
        for _ in range(5):
            if (Hs + 2 * h) % 8 == 0:
                break
            h += per
        else:
            raise ValueError(
                f"cannot align the window: shard height {Hs} mod 8 "
                f"unreachable with CFA period {per} halo steps — pad the "
                "image to a shard height that is a multiple of "
                f"{4 if per == 2 else 12}")
        if 2 * h > Hs:
            raise ValueError(
                f"halo {h} needs more than half a shard ({Hs} rows); "
                "use fewer devices or spatial_sharded_pipe")
        self.halo = h
        self.height, self.width = H, W

        # ONE plan for every shard: a window of Hs + 2h real rows, a true
        # window of the frame (org at shard 1's window origin, full dims
        # the frame's), so size-adaptive planning (wavelet scale counts)
        # matches the full pipe; org = 0 mod the CFA period keeps the
        # mosaic phase.  Shards on one device share its pipe.
        org = Hs - h if n > 1 else 0
        wspec = ImageSpec(
            width=W, height=Hs + 2 * h, colorspace=Colorspace.RAW,
            channels=1,
            cfa=CFAPattern.XTRANS if meta.xtrans else meta.cfa,
            org_y=org, full_h=H, full_w=W)
        # ops with whole-frame statistics (denoiseprofile's per-scale
        # variance) rebuild the full frame's value with a masked psum over
        # the axis, from the geometry published after planning
        geom = dict(axis=axis, n=n, Hs=Hs, halo=h, H=H, Hw=Hs + 2 * h)

        def plan(device):
            p = Pipeline(meta, history, roi=False, spec_in=wspec,
                         device=device)
            p.ctx.notes["shard_geom"] = geom
            return p

        self.compiled = _compiled_per_device(self.devices, plan)
        self.pipe = self.compiled[str(self.devices[0])].pipe

    def _body(self, x: torch.Tensor, pipe: CompiledPipe) -> torch.Tensor:
        """x: (Hs, W) this shard's rows -> its (C, Hs, W) output rows."""
        n, Hs, h, H = self.n, self.shard_h, self.halo, self.height
        Hw = Hs + 2 * h
        i = axis_index(self.axis)
        if h > 0:
            up = [(k, k + 1) for k in range(n - 1)]
            dn = [(k, k - 1) for k in range(1, n)]
            from_prev = ppermute(x[-2 * h:], self.axis, up)
            from_next = ppermute(x[:2 * h], self.axis, dn)
            buf = torch.cat([from_prev, x, from_next])
            # buf covers image rows [i*Hs - 2h, (i+1)*Hs + 2h)
            start = min(max(i * Hs - h, 0), H - Hw)   # window origin
            woff = start - (i * Hs - 2 * h)           # 2h / h / 0
            win = buf[woff:woff + Hw]
        else:
            start = i * Hs
            win = x
        # pad to the window spec (edge, like ops_base.pad_to)
        spec_in, spec_out = pipe.pipe.spec_in, pipe.pipe.spec_out
        ph, pw = spec_in.pad_h - Hw, spec_in.pad_w - self.width
        if ph or pw:
            win = F.pad(win[None, None], (0, pw, 0, ph), mode="replicate")[0, 0]
        y = pipe.run_padded(win.contiguous())
        y = y[..., :Hw, :spec_out.width]
        if h > 0:
            keep = i * Hs - start                     # 0 / h / 2h
            y = y[..., keep:keep + Hs, :]
        return y.contiguous()

    def __call__(self, raw) -> torch.Tensor:
        """raw: (H, W) mosaic in sensor units (numpy or a tensor) -> the
        (C, H, W) output on the mesh's first device."""
        H, W, Hs = self.height, self.width, self.shard_h
        if tuple(raw.shape) != (H, W):
            raise ValueError(f"raw {tuple(raw.shape)}: the pipe takes "
                             f"({H}, {W})")
        if not isinstance(raw, torch.Tensor):
            raw = np.asarray(raw, np.float32)
        args = [(_on(raw[i * Hs:(i + 1) * Hs], d), self.compiled[str(d)])
                for i, d in enumerate(self.devices)]
        outs = run_shards(self.mesh, self.axis, self._body, args)
        first = self.devices[0]
        return torch.cat([o.to(first) for o in outs], dim=-2)
