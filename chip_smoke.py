#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`ansel_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Drives bench config 1 (a 24 MP Bayer raw through exposure +0.5,
channelmixerrgb and filmicrgb) through `compile_pipeline` and
`output_array`, the entry points a user calls, after building both CUDA
kernels from `ansel_tpu_torch/csrc/` and holding each against its plain
torch version on the card.  One line per phase; the line before the last
is the kernels' JSON record, the last line the device record.  Any
failure raises, so the script then exits non-zero without the last line.
It needs a CUDA device and imports neither JAX nor `ansel_tpu`.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import ansel_tpu_torch as port
from ansel_tpu_torch.io.encode import write_image
from ansel_tpu_torch.io.synthetic import synth_raw
from ansel_tpu_torch.kernels import _build
from ansel_tpu_torch.kernels import pointwise as pw
from ansel_tpu_torch.kernels import rcd

H, W = 4000, 6016  # bench config 1 (bench.py:22-26)
HISTORY = [
    port.HistoryItem("exposure", {"exposure": 0.5}),
    port.HistoryItem("channelmixerrgb", {}),
    port.HistoryItem("filmicrgb", {}),
]
REPEATS = 10

# RCD: the kernel does the plain version's float32 operations in the same
# order (built with --fmad=false; division and sqrt are IEEE), so the two
# agree to rounding of the final `* scaler`; 1e-6 * scaler leaves room
# for that and is ten times tighter than the first bound set for it.
RCD_TOL = 1e-6
# chain: powf/log2f/expf in the kernel and torch's pow/log2 on the card
# may differ by an ulp, and the filmic spline and gamut map amplify that
# on steep parts of the curve; display values are in [0, 1].
CHAIN_MAX_TOL, CHAIN_MEAN_TOL = 1e-4, 1e-6
# the whole pipe against the plain functions composed: one display code
PIPE_TOL = 1.0 / 255.0


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def median_ms(fn):
    """Median over REPEATS of one call, timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPEATS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def expect(ok, what):
    if not ok:
        raise AssertionError(what)


def compare(a, b):
    """(max, mean) abs difference of two finite tensors."""
    expect(bool(torch.isfinite(a).all() and torch.isfinite(b).all()),
           "non-finite values")
    d = (a - b).abs()
    return d.max().item(), d.mean().item()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    card = card_line()
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{card}", flush=True)

    t0 = time.perf_counter()
    build_s = _build.build_all()
    print(f"[build] nvcc built and loaded {', '.join(_build.KERNELS)} in "
          f"{build_s:.1f} s", flush=True)

    raw, meta, _ = synth_raw(h=H, w=W, kind="gradients")
    pipe = port.compile_pipeline(meta, HISTORY, device="cuda")
    stages = [s.name for s in pipe.pipe.stages]
    expect(stages[3] == "demosaic" and pipe.fused_groups() == [stages[4:]],
           f"unexpected plan {stages}, chains {pipe.fused_groups()}")
    expect(raw.shape == pipe.pipe.spec_in.array_shape, "raw needs padding")
    raw_dev = torch.from_numpy(raw).cuda()
    mosaic = pipe.pipe.trace_fn(0, 3)(raw_dev, pipe.coeffs[0:3])
    cfa = pipe.pipe.stages[3].plan.spec_in.cfa
    scaler = pipe.coeffs[3]["scaler"]
    s = float(scaler)

    # -- RCD kernel vs plain: config-1 mosaic and a flat one
    flat = torch.full_like(mosaic, 0.3 * s)
    errs, rcd_err = [], 0.0
    for name, m in (("config-1", mosaic), ("flat", flat)):
        mx, mean = compare(rcd.rcd_demosaic(m, cfa, scaler),
                           rcd.rcd_demosaic_reference(m, cfa, scaler))
        expect(mx <= RCD_TOL * s, f"rcd {name}: max {mx} > {RCD_TOL} x {s}")
        rcd_err = max(rcd_err, mx)
        errs.append(f"{name} max {mx:.3g} mean {mean:.3g}")
    rcd_ms = median_ms(lambda: rcd.rcd_demosaic(mosaic, cfa, scaler))
    rcd_plain_ms = median_ms(
        lambda: rcd.rcd_demosaic_reference(mosaic, cfa, scaler))
    print(f"[rcd] {H}x{W} kernel vs plain: {'; '.join(errs)} "
          f"(tol {RCD_TOL:g} x scaler {s:.4g}) | kernel {rcd_ms:.3f} ms, "
          f"plain {rcd_plain_ms:.3f} ms", flush=True)

    # -- chain kernel vs plain on the demosaic output
    rgb = rcd.rcd_demosaic(mosaic, cfa, scaler)
    chain = next(a for kind, _, _, a in pipe.steps if kind == "chain")
    ch_max, ch_mean = compare(pw.pointwise_chain(rgb, chain),
                              pw.pointwise_chain_reference(rgb, chain))
    expect(ch_max <= CHAIN_MAX_TOL and ch_mean <= CHAIN_MEAN_TOL,
           f"chain: max {ch_max}, mean {ch_mean}")
    ch_ms = median_ms(lambda: pw.pointwise_chain(rgb, chain))
    ch_plain_ms = median_ms(lambda: pw.pointwise_chain_reference(rgb, chain))
    print(f"[chain] 3x{H}x{W} {'+'.join(stages[4:])} kernel vs plain: max "
          f"{ch_max:.3g} mean {ch_mean:.3g} (tol {CHAIN_MAX_TOL:g} / "
          f"{CHAIN_MEAN_TOL:g}) | kernel {ch_ms:.3f} ms, plain "
          f"{ch_plain_ms:.3f} ms", flush=True)

    # -- the full pipe through the user's entry point, launches counted
    rcd.LAUNCHES = 0
    pw.LAUNCHES = 0
    out = pipe.output_array(raw)
    launches = {"rcd": rcd.LAUNCHES, "chain": pw.LAUNCHES}
    expect(launches == {"rcd": 1, "chain": 1}, f"launches {launches}")
    expect(out.shape == (3, H, W), f"output shape {out.shape}")
    expect(bool(np.isfinite(out).all()) and out.min() >= 0.0
           and out.max() <= 1.0, "output not finite or outside [0, 1]")
    plain = pw.pointwise_chain_reference(
        rcd.rcd_demosaic_reference(mosaic, cfa, scaler), chain)
    so = pipe.pipe.spec_out
    pipe_err = float(np.abs(out - plain[:, :so.height, :so.width]
                            .cpu().numpy()).max())
    expect(pipe_err <= PIPE_TOL, f"pipe vs plain: max {pipe_err}")
    for _ in range(2):
        pipe.run_padded(raw_dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(REPEATS):
        pipe.run_padded(raw_dev)
    torch.cuda.synchronize()
    per_img = (time.perf_counter() - t) / REPEATS
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "config1.png")
        write_image(png, out, bpp=16, icc=None)
        png_bytes = os.path.getsize(png)
    expect(png_bytes > 0, "empty PNG")
    print(f"[pipe] config 1 {H}x{W}: {len(stages)} stages, chains "
          f"{pipe.fused_groups()}, launches {launches}, vs plain max "
          f"{pipe_err:.3g} (tol 1/255), range [{out.min():.3g}, "
          f"{out.max():.3g}] | {1.0 / per_img:.2f} img/s, "
          f"{H * W / per_img / 1e6:.1f} MP/s ({per_img * 1e3:.1f} ms/img, "
          f"device-resident input) on {card} | 16-bit PNG {png_bytes} B | "
          f"total {time.perf_counter() - t0:.0f} s", flush=True)

    kernels = [
        {"name": "rcd_demosaic", "route": "cuda",
         "source": "ansel_tpu_torch/csrc/rcd.cu",
         "replaces": "ansel_tpu/kernels/rcd_pallas.py:189",
         "launches": launches["rcd"], "max_abs_err": rcd_err,
         "ms": rcd_ms, "plain_ms": rcd_plain_ms},
        {"name": "pointwise_chain", "route": "cuda",
         "source": "ansel_tpu_torch/csrc/pointwise_chain.cu",
         "replaces": "ansel_tpu/kernels/pointwise.py:30",
         "launches": launches["chain"], "max_abs_err": ch_max,
         "ms": ch_ms, "plain_ms": ch_plain_ms},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
