#!/usr/bin/env python3
"""What building a config's pipe costs on one GPU, and what reusing a
build of the same signature could save.

    python3 scripts/pipe_build_time.py [--config 8] [--repeats 20]

Times `compile_pipeline` of the config's history on the card with conf
`pipe.compile_cache` off and on (after one warm build, so that every
build with it on repeats a signature already seen), in the order off,
on, on, off; then the parts of one build: planning (`Pipeline`), the
host coefficients (`Pipeline.coeffs`), their upload
(`coeffs_to_device`) and the chains' packing (`Pipeline.schedule`),
the last two being what a reuse of an earlier build skips; and one
`run_padded` of the frame for scale.  Each build is followed by a
synchronize.  Prints medians in ms, after the card's name and power
limit.  Needs a CUDA device; builds the kernels for the `run_padded`.
"""

import argparse
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import ansel_tpu_torch as port  # noqa: E402
from ansel_tpu_torch.core import conf  # noqa: E402
from ansel_tpu_torch.io.configs import FRAMES, history  # noqa: E402
from ansel_tpu_torch.io.synthetic import synth_raw  # noqa: E402
from ansel_tpu_torch.kernels import _build  # noqa: E402
from ansel_tpu_torch.ops.base import pad_to  # noqa: E402
from ansel_tpu_torch.pipeline import engine  # noqa: E402


def median_ms(fn, repeats):
    times = []
    for _ in range(repeats):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("pipe_build_time: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(f"[card] torch {torch.__version__} | {card}", flush=True)
    h, w = FRAMES[args.config]
    raw, meta, _ = synth_raw(h=h, w=w, kind="gradients")
    hist = history(args.config, port.HistoryItem)

    def build():
        return port.compile_pipeline(meta, hist)

    def with_cache(on):
        conf.set("pipe.compile_cache", on)
        return median_ms(build, args.repeats)

    build()
    off = [with_cache(False)]
    on = [with_cache(True), with_cache(True)]
    off.append(with_cache(False))
    conf.set("pipe.compile_cache", True)

    pipe = engine.Pipeline(meta, hist)
    host = pipe.coeffs()
    dev = engine.coeffs_to_device(host, pipe.device)
    parts = {
        "plan": median_ms(lambda: engine.Pipeline(meta, hist), args.repeats),
        "coeffs": median_ms(pipe.coeffs, args.repeats),
        "upload": median_ms(lambda: engine.coeffs_to_device(
            host, pipe.device), args.repeats),
        "schedule": median_ms(lambda: pipe.schedule(dev), args.repeats),
    }
    _build.build_all()
    cp = port.compile_pipeline(meta, hist)
    raw_dev = torch.from_numpy(pad_to(raw, cp.pipe.spec_in)).cuda()
    cp.run_padded(raw_dev)
    run = median_ms(lambda: cp.run_padded(raw_dev), 3)
    print(f"[build] config {args.config} {h}x{w}, {len(pipe.stages)} stages, "
          f"median of {args.repeats}: compile_pipeline with "
          f"pipe.compile_cache off {off[0]:.3f} / {off[1]:.3f} ms, on "
          f"(a repeated signature) {on[0]:.3f} / {on[1]:.3f} ms | parts: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items())
          + f" | run_padded {run:.2f} ms (median of 3)", flush=True)


if __name__ == "__main__":
    main()
