"""Multi-device execution: batch-export sharding and spatial sharding
(`ansel_tpu/parallel/batch.py`).

The reference's batch parallelism is one export job per image on a
serialized queue (`ansel/src/control/jobs.h:52-60`,
DT_JOB_QUEUE_USER_EXPORT); its out-of-memory strategy is halo tiling
(src/develop/tiling.c).  On the mesh of `parallel/mesh.py`:

  * batch axis -> `BatchPipeline`: each device of the mesh's "dp" axis
    runs the full single-device pipe, kernels included, over its slice
    of a batch, one image after another (the JAX package's `lax.map`
    inside `shard_map`).
  * spatial axis -> `spatial_sharded_pipe`: one image's mosaic
    row-sharded over every device of the mesh; each device computes its
    band of the output rows through the pipe's own backward-ROI walk
    (`Pipeline(out_window=..., exact_window=True)`) from the input
    window that walk gives, which the call ships to it from the whole
    mosaic it holds; a stage that reads a whole-frame statistic makes
    that window the whole frame, so each band repeats the work up to
    it.  JAX partitions its graph with GSPMD and switches fusion off,
    since Pallas cannot be auto-partitioned; the port has no partitioner
    and keeps its kernels.

Neither holds a collective, so the devices' pipes are enqueued from the
caller's thread, each on its shard's stream (`mesh.map_shards`).

The JAX package's segmented compile (`pipe.max_stages_per_jit`) is a
TPU compile workaround with no counterpart here: each device runs the
whole pipe per image.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..core.types import RawMeta
from ..ops import base as ops_base
from ..pipeline.engine import CompiledPipe, HistoryItem, Pipeline
from .mesh import AXES, Mesh, make_mesh, map_shards

# the first row of each stage's window on a band: a multiple of the
# 8-row padding (a window that reaches the frame's last row then holds
# the whole-frame pipe's own pad rows, not replicated ones of the wrong
# CFA parity) and of the CFA periods 2 and 6
ROW_ALIGN = 24

__all__ = ["BatchPipeline", "Mesh", "make_mesh", "spatial_sharded_pipe"]


def _compiled_per_device(devices, make) -> dict:
    """{str(device): CompiledPipe of make(device)}, one a device: shards
    on one device share it (its run holds no state)."""
    out = {}
    for d in devices:
        if str(d) not in out:
            out[str(d)] = CompiledPipe(make(d))
    return out


def _host_rows(raw, spec):
    """A mosaic as a float32 array padded to `spec`'s shape, or the
    tensor as given."""
    if isinstance(raw, torch.Tensor):
        return raw
    raw = np.asarray(raw, np.float32)
    if raw.shape[-2:] != spec.array_shape:
        raw = ops_base.pad_to(raw, spec)
    return np.ascontiguousarray(raw)


def _on(part, dev) -> torch.Tensor:
    if isinstance(part, torch.Tensor):
        return part.to(dev)
    return torch.from_numpy(np.ascontiguousarray(part)).to(dev)


class BatchPipeline:
    """Batch export over the mesh's "dp" axis: each device runs the full
    single-device pipe on its slice of the batch, one image after
    another.  The mesh's "sp" axis must be 1, as in the JAX package
    (use `spatial_sharded_pipe` for one image over several devices)."""

    def __init__(self, meta: RawMeta, history: List[HistoryItem],
                 mesh: Mesh, forms=None):
        if mesh.shape.get("sp", 1) != 1:
            raise ValueError("BatchPipeline shards over dp only; build the "
                             "mesh with spatial=1")
        self.mesh = mesh
        self.devices = mesh.axis_devices("dp")
        self.compiled = _compiled_per_device(
            self.devices,
            lambda d: Pipeline(meta, history, forms=forms, device=d))
        self.pipe = self.compiled[str(self.devices[0])].pipe

    def __call__(self, raw_batch) -> torch.Tensor:
        """raw_batch: (B, H, W) mosaics in sensor units (numpy, padded or
        not, or a tensor of padded mosaics on any device); B a multiple
        of the dp axis's size.  -> (B, C, pad_h, pad_w) on the mesh's
        first device, image b equal to the single-device pipe's run of
        mosaic b."""
        x = _host_rows(raw_batch, self.pipe.spec_in)
        dp = len(self.devices)
        if x.shape[0] % dp:
            raise ValueError(f"a batch of {x.shape[0]} does not split over "
                             f"{dp} devices")
        b = x.shape[0] // dp
        args = [(_on(x[k * b:(k + 1) * b], d), self.compiled[str(d)])
                for k, d in enumerate(self.devices)]

        def per_device(xs, pipe):
            return torch.stack([pipe.run_padded(xs[j].contiguous())
                                for j in range(xs.shape[0])])

        outs = map_shards(self.mesh, "dp", per_device, args)
        first = self.devices[0]
        return torch.cat([o.to(first) for o in outs])


def spatial_sharded_pipe(meta: RawMeta, history: List[HistoryItem],
                         mesh: Mesh):
    """A single-image pipe with the mosaic row-sharded over all the
    mesh's devices (dp x sp, row-major): the big-image path.  Device k
    plans the pipe for its band of the output rows (`out_window`,
    `exact_window`); the backward-ROI walk gives the input window that
    band needs, which `call` ships to the device.  Under `exact_window` a
    stage that reads a whole-frame statistic (denoiseprofile's wavelets,
    full green equilibration) computes the whole frame on every band, and
    each demosaic method's window covers its own reach.  Any pipe,
    size-changing and full-frame ones included: each band computes what
    the unsharded pipe computes on its rows.  -> (call,
    pipe): `call(raw)` returns the output's logical frame (C, Ho, Wo) on
    the mesh's first device, its rows concatenated from the devices'
    bands; `pipe` is the unsharded Pipeline."""
    devices = mesh.axis_devices(AXES)
    n = len(devices)
    pipe = Pipeline(meta, history, device=devices[0])
    spec = pipe.spec_in
    Ho, Wo = pipe.spec_out.height, pipe.spec_out.width
    if Ho < n:
        raise ValueError(f"{Ho} output rows do not split over {n} devices")
    bands = [((k * Ho) // n, ((k + 1) * Ho) // n) for k in range(n)]
    shards = []
    for d, (y0, y1) in zip(devices, bands):
        shard = CompiledPipe(Pipeline(meta, history, device=d,
                                      out_window=(y0, 0, y1 - y0, Wo),
                                      row_align=ROW_ALIGN,
                                      exact_window=True))
        s0 = shard.pipe.stages[0].plan.spec_in if shard.pipe.stages \
            else shard.pipe.spec_in
        lo = s0.org_y
        hi = min(s0.org_y + s0.pad_h, spec.pad_h)
        x_spec = dataclasses.replace(spec, org_y=lo, height=hi - lo,
                                     pad_h=hi - lo)
        shards.append((shard, x_spec, y0, y1))

    def body(x, shard, x_spec, y0, y1):
        y = shard.pipe.run_steps(x, shard.steps, x_spec=x_spec)
        so = shard.pipe.spec_out
        r0, c0 = y0 - so.org_y, -so.org_x
        return y[..., r0:r0 + (y1 - y0), c0:c0 + Wo].contiguous()

    def call(raw):
        x = _host_rows(raw, spec)
        args = []
        for d, sh in zip(devices, shards):
            lo = sh[1].org_y
            args.append((_on(x[lo:lo + sh[1].pad_h], d),) + sh)
        outs = map_shards(mesh, AXES, body, args)
        return torch.cat([o.to(devices[0]) for o in outs], dim=-2)

    return call, pipe
