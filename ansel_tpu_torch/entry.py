"""The entry point of the port, the counterpart of `entry()` in the
repository's `__graft_entry__.py`.

    fn, (raw_padded, coeffs) = entry()          # on the CUDA card
    out = fn(raw_padded, coeffs)                 # (3, H, W_padded) display RGB

The flagship pipe at 256 x 384: a synthetic gradients raw and the
history exposure +0.5, filmicrgb, with the mandatory modules the planner
adds.  `fn(raw_padded, coeffs)` runs `Pipeline.run_steps(raw_padded,
pipe.schedule(coeffs))` on the device the arguments live on, `coeffs`
being the pipe's device coefficients.  `entry(device="cpu")` builds it
on the CPU, where every kernel runs its plain twin.

`dryrun_multichip(n_devices)` runs the JAX package's four multi-device
phases (`__graft_entry__.py:47-162`) on an n-device mesh of the port
(`parallel/`): a batch of RCD pipes over dp, one PPG image row-sharded
over (dp, sp) with each band planned on its own rows, the denoiseprofile
pipe over sp with its halo exchange and sharded statistic, and the
longest history with forms over dp.  On a device kind with fewer cards than
`n_devices` it runs on a virtual mesh, which it names.
"""

from __future__ import annotations

import torch

from .io.synthetic import synth_raw
from .ops.base import pad_to
from .pipeline.engine import HistoryItem, Pipeline, coeffs_to_device


def _build(h: int, w: int, demosaic_method=None):
    raw, meta, _ = synth_raw(h=h, w=w, kind="gradients")
    history = [
        HistoryItem("exposure", {"exposure": 0.5}),
        HistoryItem("filmicrgb", {}),
    ]
    if demosaic_method is not None:
        history.append(HistoryItem("demosaic",
                                   {"demosaicing_method": demosaic_method}))
    return raw, meta, history


def entry(device="cuda"):
    """-> (fn, (raw_padded, coeffs)), both arguments on `device`."""
    raw, meta, history = _build(256, 384)
    pipe = Pipeline(meta, history, device=device)
    coeffs = coeffs_to_device(pipe.coeffs(), pipe.device)
    raw_padded = torch.from_numpy(pad_to(raw, pipe.spec_in)).to(pipe.device)
    return pipe.trace_fn(), (raw_padded, coeffs)


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """The four multi-device phases on a mesh of `n_devices` devices of
    `device`'s kind, each checked; raises on a failure.

    (1) `BatchPipeline` of the RCD flagship at 128 x 256 over dp, each
    image equal to the single pipe's; (2) `spatial_sharded_pipe` of the
    PPG pipe at 64 x 128 over (dp, sp = 2), within 1e-5 of the single
    pipe (PPG's shifts wrap round the frame, so its top and bottom bands
    demosaic the whole frame: ROADMAP R18);
    (2b, n >= 4) a `SpatialPipeline` of the denoiseprofile pipe at 768 x
    128 over sp = 2, its per-scale statistic summed over the shards,
    within 1/255 of the single pipe; (3) config 13's history with its
    forms (`io/configs.history(13)`, `forms(13)`: blends, drawn masks,
    spots and retouch), the longest history with forms the repository
    builds, at 128 x 192 over dp: equal on every shard, and within the
    JAX package's gate (atol 6e-3, mean < 1e-4) of the single pipe.  The
    JAX package's phase 3 reads darktable's benchmark sidecar from a
    reference checkout the repository does not hold."""
    import numpy as np

    from .io import configs
    from .parallel.batch import (BatchPipeline, make_mesh,
                                 spatial_sharded_pipe)
    from .parallel.mesh import virtual_devices
    from .parallel.spatial import SpatialPipeline
    from .pipeline.engine import CompiledPipe

    dev = torch.device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if dev.type == "cuda" and dev.index is None and cards >= n_devices:
        devices = None                      # the machine's own cards
    else:
        devices = virtual_devices(n_devices, dev)
        if dev.type == "cuda":
            print(f"dryrun_multichip: {cards} CUDA card(s) for "
                  f"{n_devices} shards: a virtual mesh "
                  f"{[str(d) for d in devices]}", flush=True)

    def mesh_of(n, spatial=1):
        return make_mesh(n, spatial=spatial, devices=devices)

    def single(meta, history, forms=None):
        return CompiledPipe(Pipeline(meta, history, forms=forms,
                                     device=devices[0] if devices else dev))

    # --- 1. the batch path: the RCD flagship, one pipe a device over dp
    raw, meta, history = _build(128, 256, demosaic_method=5)  # RCD
    bp = BatchPipeline(meta, history, mesh_of(n_devices))
    batch = np.stack([raw * (1.0 + 0.01 * i) for i in range(n_devices)])
    out = bp(batch)
    one = single(meta, history)
    assert bool(torch.isfinite(out).all())
    for i in range(n_devices):
        assert torch.equal(out[i], one(batch[i])), f"batch image {i}"

    # --- 2. one image row-sharded over (dp, sp), each device its band
    spatial = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    raw2, meta2, history2 = _build(64, 128, demosaic_method=0)  # PPG
    call, pipe2 = spatial_sharded_pipe(meta2, history2,
                                       mesh_of(n_devices, spatial))
    out2 = call(raw2)
    ref2 = CompiledPipe(pipe2)(raw2)[:, :meta2.height, :meta2.width]
    err2 = (out2 - ref2).abs().max().item()
    assert err2 <= 1e-5, f"spatial_sharded_pipe: max {err2}"

    # --- 2b. the shifted-window scheme: the denoiseprofile pipe over sp,
    # its halo exchanged once, its per-scale variance summed over shards
    if n_devices >= 4:
        rawS, metaS, _ = synth_raw(h=768, w=128, kind="gradients")
        histS = [HistoryItem("denoiseprofile",
                             {"a": (4e-4,) * 3, "b": (1e-5,) * 3,
                              "strength": 2.0}),
                 HistoryItem("exposure", {"exposure": 0.5}),
                 HistoryItem("filmicrgb", {})]
        sp = SpatialPipeline(metaS, histS, mesh_of(n_devices, 2), axis="sp")
        outS = sp(rawS).cpu().numpy()
        refS = single(metaS, histS).output_array(rawS)
        errS = float(np.abs(outS - refS).max())
        assert errS < 1.0 / 255.0, f"SpatialPipeline: max {errS}"

    # --- 3. the longest history with forms over dp, against the single
    # pipe and equal across shards
    raw3, meta3, _ = synth_raw(h=128, w=192, kind="gradients")
    hist3, forms3 = configs.history(13), configs.forms(13)
    bp3 = BatchPipeline(meta3, hist3, mesh_of(n_devices), forms=forms3)
    out_mesh = bp3(np.stack([raw3] * n_devices)).cpu().numpy()
    out_one = single(meta3, hist3, forms3)(raw3).cpu().numpy()
    assert np.isfinite(out_mesh).all() and out_mesh.shape[0] == n_devices
    for i in range(n_devices):
        np.testing.assert_allclose(out_mesh[i], out_one, atol=6e-3, rtol=0)
        assert float(np.abs(out_mesh[i] - out_one).mean()) < 1e-4
        np.testing.assert_array_equal(out_mesh[i], out_mesh[0])


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print(tuple(out.shape), out.dtype, out.device)
