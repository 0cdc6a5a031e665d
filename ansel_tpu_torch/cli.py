"""ansel_tpu_torch CLI — headless export on the CUDA card (the `ansel-cli`
analog, reference src/apps/ansel-cli/main.c; a port of
`ansel_tpu/cli.py`).

Raw input: camera raws (DNG/TIFF, CR2, CR3, NEF, ARW, RAF, RW2, ORF,
PEF, through the native decoder `io/dng.py`), .npz bundles written by
`ansel_tpu_torch.io.rawfile.save_raw`, or `synth:WxH` synthetic raws.
`--width`/`--height` bound the export size (a smaller export injects
initialscale).  The pipe runs on the CUDA card unless `--device cpu` is
given; a missing card raises.

Usage:
  python -m ansel_tpu_torch.cli <raw.dng|raw.npz|synth:6016x4000>
      [sidecar.xmp] <out.png|out.jpg|out.pdf|...> [--width W] [--height H]
      [--bpp 8|16] [--no-icc] [--quality Q] [--device cuda|cpu]
      [-d perf|nan|supervisor] [-v]
  python -m ansel_tpu_torch.cli --devtest
  python -m ansel_tpu_torch.cli --generate-cache --library library.db
      [--min-mip 0] [--max-mip 2] [--min-imgid N] [--max-imgid N]
      [--cache-dir DIR] [--device cuda|cpu]
  python -m ansel_tpu_torch.cli --ingest-lensfun <dir-or-tarball> [dest]

`--generate-cache` renders thumbnails on the card unless `--device cpu`
is given; `--ingest-lensfun` only reads and copies XML on the host.  An
8-bit JPEG/PNG needs PIL, and so does an embedded ICC profile (`--no-icc`
writes a 16-bit PNG or TIFF, or a PDF, without it).
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def _generate_cache(argv):
    """`ansel-generate-cache` analog (reference
    src/apps/ansel-generate-cache/main.c:61-140; `ansel_tpu/cli.py:21-65`):
    pre-render mipmap levels for a library's images into the
    disk-backed thumbnail store, through the THUMBNAIL pipe on `--device`
    (the CUDA card by default)."""
    ap = argparse.ArgumentParser(prog="ansel-tpu-torch-cli --generate-cache")
    ap.add_argument("--library", required=True)
    ap.add_argument("--min-mip", type=int, default=0)
    ap.add_argument("--max-mip", type=int, default=2)
    ap.add_argument("--min-imgid", type=int, default=0)
    ap.add_argument("--max-imgid", type=int, default=1 << 31)
    ap.add_argument("--cache-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the renders (default: the card)")
    args = ap.parse_args(argv)

    from .library.db import Library
    from .library.mipmap import LEVEL_SIZES, MipmapCache

    lib = Library(args.library)
    mc = MipmapCache(cache_dir=args.cache_dir, device=args.device)
    lo = max(0, args.min_mip)
    hi = min(args.max_mip, len(LEVEL_SIZES) - 1)
    n = 0
    for imgid in lib.images():
        if not (args.min_imgid <= imgid <= args.max_imgid):
            continue
        path = lib.image_path(imgid)
        xmp = lib.xmp_path(imgid)
        if not os.path.exists(path):
            print(f"image {imgid}: missing file {path}, skipped",
                  file=sys.stderr)
            continue
        # large-to-small like the reference (:116)
        for level in range(hi, lo - 1, -1):
            mc.get(path, level,
                   xmp_path=xmp if os.path.exists(xmp) else None)
            n += 1
        print(f"image {imgid}: levels {lo}..{hi} cached")
    print(f"generated {n} thumbnails "
          f"(hits {mc.hits}, misses {mc.misses})")
    return 0


def _ingest_lensfun(argv):
    """Maintenance mode: install a full upstream lensfun database so lens
    correction uses measured calibrations instead of the bundled
    approximate snapshot (`io/lensfun.ingest_db`)."""
    from .io.lensfun import ingest_db

    src = argv[0] if argv else ""
    if not src:
        print("usage: ansel-tpu-torch-cli --ingest-lensfun "
              "<dir-or-tarball> [dest]", file=sys.stderr)
        return 2
    ncam, nlens = ingest_db(src, argv[1] if len(argv) > 1 else None)
    print(f"ingested lensfun db: {ncam} cameras, {nlens} lenses")
    return 0


def _devtest():
    """`ansel-cltest` analog (src/apps/ansel-cltest): the card's
    diagnostic.  The torch and CUDA versions, each device's name, then one
    launch of the chain kernel (`kernels/pointwise`) on config 1's chain,
    held against its plain twin; 1 on a mismatch or without a card."""
    import torch

    from .io import configs
    from .io.synthetic import synth_raw
    from .kernels import pointwise as pw
    from .pipeline.engine import compile_pipeline

    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if not torch.cuda.is_available():
        print("no CUDA device")
        return 1
    for i in range(torch.cuda.device_count()):
        print(f"  device {i}: {torch.cuda.get_device_name(i)}")
    t0 = time.perf_counter()
    _, meta, _ = synth_raw(h=64, w=128)
    pipe = compile_pipeline(meta, configs.history(1), device="cuda")
    chain = next(a for kind, _, _, a in pipe.steps if kind == "chain")
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand((3, 64, 128), generator=gen, device="cuda")
    before = pw.LAUNCHES
    got = pw.pointwise_chain(x, chain)
    launched = pw.LAUNCHES - before
    err = (got - pw.pointwise_chain_reference(x, chain)).abs().max().item()
    ok = launched == 1 and err <= 1e-4
    form = (f"program {chain.fixed}" if chain.fixed >= 0
            else "interpreter")
    print(f"chain kernel ({form}): {launched} launch, max error "
          f"{err:.3g} vs its twin (tol 1e-4), "
          f"{time.perf_counter() - t0:.2f} s: {'OK' if ok else 'FAILED'}")
    return 0 if ok else 1


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "--generate-cache":
        return _generate_cache(argv[1:])
    if argv and argv[0] == "--devtest":
        return _devtest()
    if argv and argv[0] == "--ingest-lensfun":
        return _ingest_lensfun(argv[1:])

    ap = argparse.ArgumentParser(prog="ansel-tpu-torch-cli")
    ap.add_argument("input")
    ap.add_argument("xmp", nargs="?", default=None)
    ap.add_argument("output")
    ap.add_argument("--width", type=int, default=0)
    ap.add_argument("--height", type=int, default=0)
    ap.add_argument("--quality", type=int, default=92)
    ap.add_argument("--bpp", type=int, default=8, choices=(8, 16))
    ap.add_argument("--no-icc", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the pipe (default: the CUDA card)")
    ap.add_argument("-d", "--debug", action="append", default=[],
                    choices=("perf", "nan", "supervisor"),
                    help="per-stage timing / NaN scan / lifecycle "
                         "registry (reference -d flags)")
    ap.add_argument("--verbose", "-v", action="store_true")
    args = ap.parse_args(argv)

    from .core import crash
    from .io.rawfile import load_raw
    from .io.synthetic import synth_raw
    from .pipeline.export import ExportSettings, export_image

    crash.install()
    crash.breadcrumb("image", args.input)
    t0 = time.perf_counter()
    if args.input.startswith("synth:"):
        w, h = (int(v) for v in args.input[6:].split("x"))
        raw, meta, _ = synth_raw(h=h, w=w)
    elif args.input.lower().endswith((".dng", ".tif", ".tiff")):
        from .io.dng import load_dng

        raw, meta = load_dng(args.input)
    else:
        raw, meta = load_raw(args.input)
    if args.verbose:
        print(f"[load] {meta.width}x{meta.height} {meta.cfa} "
              f"{time.perf_counter() - t0:.2f}s", file=sys.stderr)

    xmp = args.xmp if args.xmp and args.xmp.lower().endswith(".xmp") else None
    settings = ExportSettings(max_width=args.width, max_height=args.height,
                              quality=args.quality, bpp=args.bpp,
                              embed_icc=not args.no_icc)
    if "perf" in args.debug or "nan" in args.debug:
        from .io.xmp import parse_xmp
        from .pipeline.engine import Pipeline
        from .pipeline.export import compute_export_scale
        from .pipeline.profiling import nan_report, run_stages

        doc = parse_xmp(xmp) if xmp else None
        pipe = Pipeline(meta, doc.history if doc else [],
                        device=args.device,
                        scale=compute_export_scale(meta, settings),
                        forms=doc.masks if doc else None,
                        order_version=doc.iop_order_version if doc else None)
        reps = run_stages(pipe, raw, nan_scan="nan" in args.debug)
        bad = nan_report(reps)
        if bad:
            print(f"[nan] {bad}", file=sys.stderr)
    if "supervisor" in args.debug:
        from .core import conf as conf_mod
        from .core import supervisor as sup_mod

        conf_mod.set("debug.supervisor", True)
        sup_mod._ENABLED = True
    t0 = time.perf_counter()
    crash.breadcrumb("pipe", "export")
    out = export_image(raw, meta, xmp_path=xmp, output_path=args.output,
                       settings=settings, device=args.device)
    crash.breadcrumb("pipe", None)
    if "supervisor" in args.debug:
        from .core import supervisor as sup_mod

        bad = sup_mod.anomalies()
        print(f"[supervisor] {len(sup_mod.ring())} events, "
              f"{len(bad)} anomalies", file=sys.stderr)
        for r in bad[:20]:
            print(f"[supervisor] {r}", file=sys.stderr)
    if args.verbose:
        print(f"[export] {out.shape[2]}x{out.shape[1]} -> {args.output} "
              f"{time.perf_counter() - t0:.2f}s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
