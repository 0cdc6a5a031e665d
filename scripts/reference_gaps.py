#!/usr/bin/env python3
"""Where two of the smoke's gaps to a reference come from, on the card.

    python3 scripts/reference_gaps.py [--device cuda] [--small]

(b) Config 18's shifted-window `SpatialPipeline` (sp 4, the denoise
stack on config 2's noisy mosaic at 24 MP, as `chip_smoke.py`'s
`[pipe18]` runs it) against the single pipe.  denoiseprofile's per-scale
variance is, on the single pipe, the EAW kernel's sum of detail² over
the frame; on the shards, each shard's `torch.sum` over the rows it owns,
added over the axis.  The script records the shards' per-scale sums,
then runs the single pipe again with its sums replaced by those
(`denoiseprofile.eaw_dn_decompose` wrapped): if the statistic's
summation order is the whole gap, that run equals the sharded one.
Before that, each op of the stack alone (with the mandatory modules the
planner adds, RCD among them) over the same mesh: its gap to the single
pipe, where it lies, and its gap on the rows more than `EDGE` from the
frame's top and bottom.

Config 19, a Lightroom roll at 24 MP (as `[pipe19]` builds it): each
image's export from the written-back sidecar against a single pipe of
the parsed Lightroom history (dict params, Python floats), and against a
single pipe of the same history with each item's params put through its
params class's struct (float32 fields, as the library stores them).
It also prints, field by field, the largest difference between the
parsed params and the sidecar's.

`--small` runs both at the CPU tests' sizes (704 x 256 over sp 2; the
roll at 64 x 96 and 60 x 96), `--device cpu` on the CPU.  It prints the
card's name and power limit first.
"""

import argparse
import dataclasses
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from ansel_tpu_torch.core.params import decode_blob, params_class  # noqa: E402
from ansel_tpu_torch.io import configs, lightroom  # noqa: E402
from ansel_tpu_torch.io.rawfile import load_raw  # noqa: E402
from ansel_tpu_torch.io.synthetic import synth_raw  # noqa: E402
from ansel_tpu_torch.io.xmp import parse_xmp  # noqa: E402
from ansel_tpu_torch.library.crawler import crawl  # noqa: E402
from ansel_tpu_torch.library.db import Library  # noqa: E402
from ansel_tpu_torch.ops import denoiseprofile  # noqa: E402
from ansel_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from ansel_tpu_torch.parallel.batch import make_mesh  # noqa: E402
from ansel_tpu_torch.parallel.spatial import SpatialPipeline  # noqa: E402
from ansel_tpu_torch.pipeline.engine import (CompiledPipe,  # noqa: E402
                                             HistoryItem, Pipeline)
from ansel_tpu_torch.pipeline.export import export_image  # noqa: E402

NOISE_SIGMA = 200.0   # chip_smoke.py's high-ISO mosaic
EDGE = 8              # rows at the frame's top and bottom set apart


def _gap(got, want):
    """(max, (channel, row, column) of the max, max off the frame's
    top and bottom EDGE rows)."""
    d = (got - want).abs()
    at = tuple(int(v) for v in np.unravel_index(int(d.argmax()),
                                                tuple(d.shape)))
    return d.max().item(), at, d[:, EDGE:-EDGE].max().item()


def sharded_statistic(dev, h, w, sp):
    raw, meta, _ = synth_raw(h=h, w=w, kind="gradients")
    x = torch.from_numpy(raw).to(dev)
    gen = torch.Generator(device=dev).manual_seed(8)
    noisy = (x + NOISE_SIGMA * torch.randn(x.shape, generator=gen,
                                           device=dev)).clamp_(0.0, 65535.0)
    hist = configs.history(18)
    devices = [dev] * sp
    if dev.type == "cuda":
        devices = mesh_mod.virtual_devices(sp, "cuda")
    mesh = make_mesh(sp, spatial=sp, devices=devices)
    by_op(meta, hist, mesh, noisy, dev)
    geometry = SpatialPipeline(meta, hist, mesh, axis="sp")
    colour_transform_rows(noisy, h, sp, geometry.shard_h, geometry.halo)
    fed_statistic(meta, hist, mesh, noisy, dev, "")
    real_einsum = torch.einsum
    torch.einsum = per_pixel_einsum(real_einsum)
    try:
        fed_statistic(meta, hist, mesh, noisy, dev, " (colour transforms "
                      "per pixel)")
    finally:
        torch.einsum = real_einsum


def per_pixel_einsum(real_einsum):
    """torch.einsum with "dc,chw->dhw" (denoiseprofile's colour
    transforms) as three multiply-adds a pixel: the same operations on
    every pixel for any shape, where a device's matrix product picks its
    kernel by the shape."""
    def einsum(eq, *ops):
        if eq != "dc,chw->dhw":
            return real_einsum(eq, *ops)
        m, x = ops
        m = torch.as_tensor(m, dtype=x.dtype, device=x.device)
        return torch.stack([m[d, 0] * x[0] + m[d, 1] * x[1] + m[d, 2] * x[2]
                            for d in range(m.shape[0])])
    return einsum


def colour_transform_rows(x, h, shards, hs, halo):
    """A 3 x 3 colour transform ("dc,chw->dhw") of the frame against the
    same transform of each shard's window, as einsum and per pixel."""
    gen = torch.Generator(device=x.device).manual_seed(1)
    m = torch.rand(3, 3, generator=gen, device=x.device)
    img = torch.stack([x, 0.5 * x, 0.25 * x]) / 65535.0
    hw = hs + 2 * halo
    for name, fn in (("einsum", torch.einsum),
                     ("per pixel", per_pixel_einsum(torch.einsum))):
        whole = fn("dc,chw->dhw", m, img)
        worst = 0.0
        for i in range(shards):
            lo = min(max(i * hs - halo, 0), h - hw)
            part = fn("dc,chw->dhw", m, img[:, lo:lo + hw].contiguous())
            worst = max(worst,
                        (part - whole[:, lo:lo + hw]).abs().max().item())
        print(f"[gaps] (b) a 3 x 3 colour transform {name}: {shards} "
              f"windows' rows against the frame's max {worst:.3g}",
              flush=True)


def fed_statistic(meta, hist, mesh, noisy, dev, how):
    spp = SpatialPipeline(meta, hist, mesh, axis="sp")
    single = CompiledPipe(Pipeline(meta, hist, device=dev))

    sharded_sums, single_sums = [], []
    real_psum, real_dec = mesh_mod.psum, denoiseprofile.eaw_dn_decompose

    def psum(t, axis):
        out = real_psum(t, axis)
        if mesh_mod.axis_index(axis) == 0:
            sharded_sums.append(out.double().cpu())
        return out

    mesh_mod.psum = psum
    try:
        got = spp(noisy)
    finally:
        mesh_mod.psum = real_psum
    so = single.pipe.spec_out
    want = single.run_padded(noisy)[:, :so.height, :so.width]

    def recording(*a):
        coarse, detail, s = real_dec(*a)
        single_sums.append(s.double().cpu())
        return coarse, detail, s

    fed = iter(list(sharded_sums))

    def feeding(*a):
        coarse, detail, _ = real_dec(*a)
        return coarse, detail, next(fed).to(detail.device, torch.float32)

    try:
        denoiseprofile.eaw_dn_decompose = recording
        again = single.run_padded(noisy)[:, :so.height, :so.width]
        denoiseprofile.eaw_dn_decompose = feeding
        fed_out = single.run_padded(noisy)[:, :so.height, :so.width]
    finally:
        denoiseprofile.eaw_dn_decompose = real_dec
    rel = [float(((a - b).abs() / b.abs()).max())
           for a, b in zip(sharded_sums, single_sums)]
    print(f"[gaps] (b){how} SpatialPipeline sp {len(spp.devices)} at {spp.height}x{spp.width}, shard_h {spp.shard_h}, halo "
          f"{spp.halo}, {len(sharded_sums)} scales: the shards' per-scale "
          f"sums against the single pipe's, largest relative difference by "
          f"scale {[f'{r:.3g}' for r in rel]}", flush=True)
    mx, at, inner = _gap(got, want)
    fmx, fat, finner = _gap(got, fed_out)
    print(f"[gaps] (b){how} sharded vs single pipe max {mx:.6g} at (channel, "
          f"row, column) {at}, {inner:.6g} off the frame's top and bottom "
          f"{EDGE} rows; single vs single again max "
          f"{(again - want).abs().max().item():.3g}; sharded vs the single "
          f"pipe fed the shards' sums max {fmx:.6g} at {fat}, {finner:.6g} "
          f"off those rows", flush=True)


def by_op(meta, hist, mesh, noisy, dev):
    """Each op of `hist` alone, sharded over `mesh` against the single
    pipe."""
    for item in hist:
        one = [item]
        spp = SpatialPipeline(meta, one, mesh, axis="sp")
        single = CompiledPipe(Pipeline(meta, one, device=dev))
        so = single.pipe.spec_out
        mx, at, inner = _gap(spp(noisy),
                             single.run_padded(noisy)[:, :so.height,
                                                      :so.width])
        print(f"[gaps] (b) {item.op} alone (halo {spp.halo}): sharded vs "
              f"single max {mx:.6g} at {at}, {inner:.6g} off the frame's "
              f"top and bottom {EDGE} rows", flush=True)


def float32_history(history):
    """The items with their params put through the class's struct."""
    out = []
    for it in history:
        cls = params_class(it.op)
        blob = cls.codec.encode(cls(**it.params))
        out.append(dataclasses.replace(it, params=blob,
                                       version=cls.op_version))
    return out


def lightroom_roll(dev, frames):
    parsed = lightroom.parse_lightroom_xmp(configs.LIGHTROOM19).history
    with tempfile.TemporaryDirectory(prefix="ansel_gaps19_") as root:
        paths = configs.write_roll19(os.path.join(root, "film"), **frames)
        lib = Library(os.path.join(root, "library.db"))
        ids = lib.import_film_roll(os.path.dirname(paths[0]))
        crawl(lib)
        crawl(lib, write_back=True)
        lib.close()
        back = parse_xmp(paths[0] + ".xmp").history
        worst = []
        for p, b in zip(parsed, back):
            pd = params_class(p.op)(**p.params)
            bd = decode_blob(b.op, b.version, b.params)
            fields = []
            for f in dataclasses.fields(pd):
                u = np.asarray(getattr(pd, f.name), np.float64)
                v = np.asarray(getattr(bd, f.name), np.float64)
                if u.shape != v.shape:
                    fields.append((f.name, "shape"))
                elif not np.array_equal(u, v):
                    fields.append((f.name, float(np.abs(u - v).max())))
            worst.append((p.op, b.version, fields))
        print(f"[gaps] config 19, {len(ids)} images: parsed vs written-back "
              f"params, field by field (op, version, fields that differ "
              f"with their largest difference): {worst}", flush=True)
        rounded = float32_history(parsed)
        for path in paths:
            raw, meta = load_raw(path)
            got = export_image(raw, meta, xmp_path=path + ".xmp",
                               device=dev)
            want = CompiledPipe(Pipeline(meta, parsed, device=dev)) \
                .output_array(raw)
            want32 = CompiledPipe(Pipeline(meta, rounded, device=dev)) \
                .output_array(raw)
            print(f"[gaps] config 19 {os.path.basename(path)} "
                  f"({meta.height}x{meta.width}): the export vs the parsed "
                  f"history max {float(np.abs(got - want).max()):.6g}, vs "
                  f"its float32 params max "
                  f"{float(np.abs(got - want32).max()):.6g}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("reference_gaps: no CUDA device")
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        print(f"[card] {card}", flush=True)
        dev = torch.device("cuda", 0)
    if args.small:
        sharded_statistic(dev, 704, 256, 2)
        lightroom_roll(dev, dict(h=64, w=96, hx=60, wx=96))
    else:
        sharded_statistic(dev, configs.BENCH_H, configs.BENCH_W,
                          configs.SP18)
        lightroom_roll(dev, {})


if __name__ == "__main__":
    main()
