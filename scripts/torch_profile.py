#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port's pipe, on one GPU.

    python3 scripts/torch_profile.py [--config 1|2|3|4|7|8|9|10|11|12]
                                     [--images 3]

Plans bench config 1, 2 (4000 x 6016), 3 (5504 x 8256), 4 (an X-Trans
4000 x 6000 mosaic) or the port's config 7 (the bilateral-grid stack,
4000 x 6016), 8 (the raw-cleanup export, 4000 x 6016) or 9 (the DNG
export's flat field, flip and clipping: its 14-bit mosaic and GainMaps
without the file, 4000 x 6016), 10 (the graded look: the grading ops
in two chains, atrous on the EAW kernel, 4000 x 6016) or 11 (the legacy
look, straightened and retouched: ashift's and liquify's warps, one
chain of 15 stages, 4000 x 6016) or 12 (the hazy landscape: hazeremoval,
filmicrgb's highlight reconstruction, grain and dither, 4000 x 6016)
through
`compile_pipeline`, warms up, then runs `run_padded` on a device-resident raw `--images`
times without the profiler and `--images` times under torch.profiler.
Prints one line per group of device kernels (ms per image and launches
per image) and the `TOP` device kernels by name, the device busy share
of the profiled loop (kernel time over wall time), the host's enqueue
time per image and img/s of both loops, for each step of one image
the host's time and the device span between CUDA events around it, and
each step's device kernel launches (one profiler window a step).
Needs a CUDA device.
"""

import argparse
import os
import re
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import ansel_tpu_torch as port  # noqa: E402
from ansel_tpu_torch.io.configs import (  # noqa: E402
    FRAMES, HISTORIES, XTRANS_CONFIGS, gain_map_meta9, history, mosaic9,
    remosaic_xtrans)
from ansel_tpu_torch.io.synthetic import synth_raw  # noqa: E402
from ansel_tpu_torch.kernels import _build  # noqa: E402
from ansel_tpu_torch.ops.base import pad_to  # noqa: E402

# device kernel name -> group; anything else is a torch operation
GROUPS = {
    r"sep_(fixed|any|pass)<[\w, ]+>": "sepblur kernel",
    r"eaw_tile<\d, \w+>": "EAW kernel",
    r"nlm_kernel<\d+, \w+>": "NLM kernel", "nlm_wide_kernel": "NLM kernel",
    "chain": "chain kernel",
    r"chain_fixed<.+>": "chain kernel",
    "rcd_tile": "RCD kernel",
    r"iir_pass<\w+, \w+, \w+>": "IIR kernel",
    r"decompose<\d, \d>": "diffuse kernels",
    r"pde_group<\d, \d, \w+>": "diffuse kernels",
    r"mark_tile<\d+, \d+>": "Markesteijn kernel",
    "lens_warp_kernel": "warp kernel", r"map_warp_kernel<.+>": "warp kernel",
    "liquify_kernel": "warp kernel",
    r"bgrid_slice_kernel<\d, \w+>": "bgrid kernel",
}
# device kernels listed by name, the slowest first
TOP = 12


def group_of(name):
    for key, group in GROUPS.items():
        if re.search(rf"(^|::|\s){key}\(", name):
            return group
    if "gemm" in name.lower() or "gemv" in name.lower():
        return "torch matmul (resize, grid splat)"
    if "scatter" in name.lower():
        return "torch scatter (grid splat)"
    if "reduce" in name.lower():
        return "torch reductions"
    return "torch elementwise, copies, pads"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, choices=sorted(HISTORIES), default=2)
    ap.add_argument("--images", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    _build.build_all()
    H, W = FRAMES[args.config]
    raw, meta, scene = synth_raw(h=H, w=W, kind="gradients")
    if args.config in XTRANS_CONFIGS:
        raw, meta = remosaic_xtrans(meta, scene)
    if args.config == 9:  # the DNG's 14-bit mosaic and its GainMaps
        raw = mosaic9(raw).astype(np.float32)
        meta = gain_map_meta9(meta)
    t = time.perf_counter()
    pipe = port.compile_pipeline(meta, history(args.config), device="cuda")
    plan_s = time.perf_counter() - t
    raw_dev = torch.from_numpy(pad_to(raw, pipe.pipe.spec_in)).cuda()
    for _ in range(2):
        pipe.run_padded(raw_dev)
    torch.cuda.synchronize()

    n = args.images
    t = time.perf_counter()
    for _ in range(n):
        pipe.run_padded(raw_dev)
    bare_enqueue = time.perf_counter() - t
    torch.cuda.synchronize()
    bare = time.perf_counter() - t

    # the host's time in each step of one image, nothing synchronised
    # between steps (where the enqueue waits), and the device span of each
    # step between CUDA events recorded around it
    p, cur, marks = pipe.pipe, raw_dev, []
    for step in pipe.steps:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        a.record()
        cur = p.run_steps(cur, [step])
        b.record()
        names = "+".join(s.name for s in p.stages[step[1]:step[2]])
        marks.append((names, time.perf_counter() - t, a, b))
    torch.cuda.synchronize()
    steps = [f"{names} {host * 1e3:.1f}/{a.elapsed_time(b):.2f}"
             for names, host, a, b in marks]

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t = time.perf_counter()
        for _ in range(n):
            pipe.run_padded(raw_dev)
        enqueue = time.perf_counter() - t
        torch.cuda.synchronize()
        wall = time.perf_counter() - t

    ms, count, by_name = defaultdict(float), defaultdict(int), {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = ev.cuda_time_total
        if dev_us <= 0 or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        g = group_of(ev.key)
        ms[g] += dev_us / 1e3 / n
        count[g] += ev.count / n
        by_name[ev.key] = (dev_us / 1e3 / n, ev.count / n)
    busy = sum(ms.values()) * n / 1e3 / wall
    print(f"[card] {card} | config {args.config} {H}x{W}, {n} images, "
          f"plan {plan_s:.2f} s", flush=True)
    for g in sorted(ms, key=ms.get, reverse=True):
        print(f"[device] {g}: {ms[g]:.3f} ms/img, {count[g]:.0f} "
              f"launches/img", flush=True)
    for name in sorted(by_name, key=lambda k: by_name[k][0],
                       reverse=True)[:TOP]:
        print(f"[kernel] {by_name[name][0]:.3f} ms/img, "
              f"{by_name[name][1]:.0f} launches/img: {name[:140]}",
              flush=True)
    print(f"[loop] under the profiler: {n / wall:.3f} img/s, "
          f"{wall / n * 1e3:.1f} ms/img wall, host enqueue "
          f"{enqueue / n * 1e3:.1f} ms/img, device busy {100 * busy:.1f}%",
          flush=True)
    print(f"[bare] the same loop before it, without the profiler: "
          f"{n / bare:.3f} img/s, {bare / n * 1e3:.1f} ms/img wall, host "
          f"enqueue {bare_enqueue / n * 1e3:.1f} ms/img", flush=True)
    print(f"[steps] host ms / device span ms per step of one image: "
          f"{'; '.join(steps)}", flush=True)

    # device kernel launches of each step, one profiler window a step
    cur, launches = raw_dev, []
    for step in pipe.steps:
        with profile(activities=[ProfilerActivity.CUDA]) as one:
            cur = p.run_steps(cur, [step])
            torch.cuda.synchronize()
        k = sum(ev.count for ev in one.key_averages()
                if ev.device_type == torch.autograd.DeviceType.CUDA)
        names = "+".join(s.name for s in p.stages[step[1]:step[2]])
        launches.append(f"{names} {k}")
    print(f"[launches] device kernels per step of one image: "
          f"{'; '.join(launches)}", flush=True)


if __name__ == "__main__":
    main()
