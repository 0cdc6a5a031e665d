#!/usr/bin/env python3
"""Where config 18's multi-device paths spend their time, on the card.

    python3 scripts/mesh_profile.py [--repeats 5]

Config 18 (the port's multi-device paths, `parallel/`) at 24 MP on the
machine's cards, or on an explicit virtual mesh where it has fewer cards
than shards: (a) `BatchPipeline` over dp 2 of four images of config 1's
mosaic, (b) `SpatialPipeline` over sp 4 of config 18's denoise stack on
config 2's noisy mosaic, (c) `spatial_sharded_pipe` over (dp 2, sp 2) of
config 1's history.  For each path and for the single pipe it prints the
wall ms of a call (mean of `--repeats` after a warm-up, device-resident
input) and, from one call under torch.profiler, the device kernels' ms
summed against the profiled wall ms.  For (c) it also times the four
bands' pipes enqueued one after another from this thread on one
stream, without the mesh (their input windows cut from the frame): the
work of (c) without its shards' streams and the concatenation of the
bands.  It prints the card's name and power limit first.
"""

import argparse
import dataclasses
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from ansel_tpu_torch.io import configs  # noqa: E402
from ansel_tpu_torch.io.synthetic import synth_raw  # noqa: E402
from ansel_tpu_torch.kernels import _build  # noqa: E402
from ansel_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from ansel_tpu_torch.parallel.batch import (BatchPipeline, ROW_ALIGN,  # noqa: E402
                                            make_mesh, spatial_sharded_pipe)
from ansel_tpu_torch.parallel.spatial import SpatialPipeline  # noqa: E402
from ansel_tpu_torch.pipeline.engine import CompiledPipe, Pipeline  # noqa: E402

NOISE_SIGMA = 200.0   # chip_smoke.py's high-ISO mosaic


def card_mesh(n, spatial=1):
    if torch.cuda.device_count() >= n:
        return make_mesh(n, spatial=spatial)
    return make_mesh(n, spatial=spatial,
                     devices=mesh_mod.virtual_devices(n, "cuda"))


def wall_ms(fn, repeats):
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(repeats):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / repeats * 1e3


def device_ms(fn):
    """(profiled wall ms, device kernels' ms) of one call."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    dev = 0.0
    for e in prof.key_averages():
        dev += getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    return wall, dev / 1e3


def report(name, fn, repeats):
    ms = wall_ms(fn, repeats)
    wall, dev = device_ms(fn)
    print(f"[mesh] {name}: {ms:.2f} ms a call; profiled {wall:.2f} ms "
          f"wall, {dev:.2f} ms of device kernels", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("mesh_profile: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[card] {card}, {torch.cuda.device_count()} card(s)", flush=True)
    _build.build_all()
    h, w = configs.BENCH_H, configs.BENCH_W
    raw, meta, _ = synth_raw(h=h, w=w, kind="gradients")
    raw_dev = torch.from_numpy(raw).cuda()
    hist1 = configs.history(1)

    one = CompiledPipe(Pipeline(meta, hist1))
    report("config 1, the single pipe, one image",
           lambda: one.run_padded(raw_dev), args.repeats)
    bp = BatchPipeline(meta, hist1, card_mesh(configs.DP18))
    batch = torch.stack([raw_dev * g for g in configs.GAINS18])
    report(f"(a) BatchPipeline dp {configs.DP18}, {configs.BATCH18} images",
           lambda: bp(batch), args.repeats)

    call, pipe = spatial_sharded_pipe(meta, hist1, card_mesh(4, spatial=2))
    report("(c) spatial_sharded_pipe (dp 2, sp 2), one image",
           lambda: call(raw_dev), args.repeats)
    spec = pipe.spec_in
    bands = []
    for k in range(4):
        y0, y1 = (k * h) // 4, ((k + 1) * h) // 4
        band = CompiledPipe(Pipeline(meta, hist1, out_window=(y0, 0,
                                                              y1 - y0, w),
                                     row_align=ROW_ALIGN))
        s0 = band.pipe.stages[0].plan.spec_in
        lo, hi = s0.org_y, min(s0.org_y + s0.pad_h, spec.pad_h)
        x_spec = dataclasses.replace(spec, org_y=lo, height=hi - lo,
                                     pad_h=hi - lo)
        bands.append((band, x_spec, lo, hi))

    def four_bands():
        for band, x_spec, lo, hi in bands:
            band.pipe.run_steps(raw_dev[lo:hi].clone(), band.steps,
                                x_spec=x_spec)

    report("(c)'s four bands from this thread, no mesh", four_bands,
           args.repeats)

    noisy = (raw_dev + NOISE_SIGMA * torch.randn(
        raw_dev.shape, generator=torch.Generator("cuda").manual_seed(8),
        device="cuda")).clamp_(0.0, 65535.0)
    hist18 = configs.history(18)
    single18 = CompiledPipe(Pipeline(meta, hist18))
    report("config 18's denoise stack, the single pipe",
           lambda: single18.run_padded(noisy), args.repeats)
    sp = SpatialPipeline(meta, hist18, card_mesh(configs.SP18,
                                                 configs.SP18), axis="sp")
    report(f"(b) SpatialPipeline sp {configs.SP18}, halo {sp.halo}",
           lambda: sp(noisy), args.repeats)


if __name__ == "__main__":
    main()
