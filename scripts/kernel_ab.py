#!/usr/bin/env python3
"""Times the RCD, Markesteijn, diffuse-iteration, NLM, sepblur, EAW,
chain, IIR, grid-slice and warp kernels of this checkout against those
of another checkout, on one GPU, in turns.

    python3 scripts/kernel_ab.py --other DIR

DIR holds another tree of the repo's `ansel_tpu_torch/`, such as `git
archive` of an earlier commit unpacked into a git-ignored directory; that
package is imported as `other_port` and builds its kernels under
DIR/build.  The arguments are captured from this checkout's pipes on
synth_raw mosaics: the mosaics that configs 1 and 3 hand RCD ((4000,
6016) and (5504, 8320)) and that config 4 hands Markesteijn ((4000,
6016) X-Trans, timed at 1 and 3 passes); those that config 3's pipe
hands its first diffuse
iteration ((3, 5504, 8320), S = 5, isotropic), its first blur ((5504,
8320), 5 taps, d = 1), its IIR pair ((2, 1376, 2080), toneequal's
guided mask) and its four chains; that config 2's pipe hands NLM
((3, 4000, 6016), 225 offsets, P = 1, variant 1), its first sepblur ((4,
1000, 1504), 5 taps, d = 1; also timed at d = 32 and 512) and its EAW
scales 0, 3 and 6 ((3, 4000, 6016)); the five grid slices of config 7
(bilateral's three at 32 bins, ss 15, on (4005, 6030); shadhi's three
channels at 4 bins, ss 100, on (4000, 6100); bilat's 6 bins, ss 50, on
(4000, 6050)); the chains of configs 1, 2, 4
and 7 ((3, 4000, 6016); this tree runs each through its specialised
program); and the warp's four maps: config 4's lens map on its
demosaiced (3, 4000, 6016), config 9's clipping map on its flipped
window, config 11's ashift homography on (3, 4000, 6016) and its liquify
stamps over the ashift output; the last three also with this tree's
staging budget set to 0 (`warp.TILE`), every tile that reads the source
gathering from device memory, which times staging against the same tiles
without it.  It first prints what `nvcc -Xptxas -v`
reports (registers, shared memory, spills) for both trees' rcd.cu,
markesteijn.cu, diffuse.cu, nlm.cu, sepblur.cu, eaw.cu,
pointwise_chain.cu, iir.cu, bgrid.cu and warp.cu.  Then each kernel's output is
held bit for bit against the other tree's and timed in the order other,
this, this, other (each the median of REPEATS calls, device time between
CUDA events behind a spin kernel, as chip_smoke.py times its kernels),
and each device kernel that one call of either tree launches is listed
in launch order with its time (torch.profiler).  Before the kernels, the
pipes of configs 1, 2, 3, 4 and 7 of both trees run through `run_padded`
on the same raw in the same order (img/s, and the peak device memory
of one image of each; this tree's launch counts checked against
chip_smoke.py's; configs 9 and 11 from their histories on synth_raw
mosaics).  Needs a CUDA device.
"""

import argparse
import importlib
import importlib.util
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import ansel_tpu_torch as port  # noqa: E402
from ansel_tpu_torch.io import configs  # noqa: E402
from ansel_tpu_torch.io.synthetic import synth_raw  # noqa: E402
from ansel_tpu_torch.kernels import (  # noqa: E402
    _build, bgrid, diffuse, eaw, iir, markesteijn, nlm, rcd, sepblur, warp)
from ansel_tpu_torch.kernels import pointwise as pw  # noqa: E402
from ansel_tpu_torch.ops.base import pad_to  # noqa: E402
from chip_smoke import (  # noqa: E402
    LAUNCHES1, LAUNCHES2, LAUNCHES3, LAUNCHES4, LAUNCHES7, LAUNCHES9,
    LAUNCHES11, PIPE2_REPEATS, PIPE3_REPEATS, PIPE4_REPEATS, PIPE7_REPEATS,
    PIPE9_REPEATS, REPEATS, card_line, median_ms, pipe_peak, read_launches,
    reset_launches, swapped, time_pipe)

# each config's launch counts per image and run_padded repeats per turn,
# as chip_smoke.py runs them
PIPES = {1: (LAUNCHES1, REPEATS), 2: (LAUNCHES2, PIPE2_REPEATS),
         3: (LAUNCHES3, PIPE3_REPEATS), 4: (LAUNCHES4, PIPE4_REPEATS),
         7: (LAUNCHES7, PIPE7_REPEATS), 9: (LAUNCHES9, PIPE9_REPEATS),
         11: (LAUNCHES11, REPEATS)}


SOURCES = ("rcd", "markesteijn", "diffuse", "nlm", "sepblur", "eaw",
           "pointwise_chain", "iir", "bgrid", "warp")


def other_kernels(root):
    """The RCD, Markesteijn, diffuse, NLM, sepblur, EAW, chain, IIR,
    grid-slice and warp wrapper modules of the tree at `root`."""
    init = os.path.join(root, "ansel_tpu_torch", "__init__.py")
    spec = importlib.util.spec_from_file_location(
        "other_port", init, submodule_search_locations=[os.path.dirname(init)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["other_port"] = mod
    spec.loader.exec_module(mod)
    return [importlib.import_module(f"other_port.kernels.{name}")
            for name in ("rcd", "markesteijn", "diffuse", "nlm", "sepblur",
                         "eaw", "pointwise", "iir", "bgrid", "warp")]


def ptxas(trees):
    """`nvcc -Xptxas -v` lines of each of SOURCES for each (label, root)
    tree, one nvcc per source, all started together."""
    def run(label, root, name, tmp):
        src = os.path.join(root, "ansel_tpu_torch", "csrc", f"{name}.cu")
        proc = subprocess.run(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             os.path.join(tmp, f"{label}-{name}.so"), src],
            capture_output=True, text=True, check=True)
        return [f"[ptxas {label}] {name}: {ln.strip()}"
                for ln in proc.stderr.splitlines()
                if "Compiling entry" in ln or "Used" in ln or "spill" in ln]

    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor() as pool:
        jobs = [pool.submit(run, label, root, name, tmp)
                for label, root in trees for name in SOURCES]
        return [line for job in jobs for line in job.result()]


def all_direct(fn):
    """fn with the warp's staging budget 0: every tile direct."""
    def run(*args):
        with swapped([(warp, "TILE", warp.TILE[:2] + (0,))]):
            return fn(*args)
    return run


def launch_times(fn):
    """(kernel name, device us) of each kernel one call of fn launches,
    in launch order (the name up to its template arguments)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: e.time_range.start)

    def short(name):  # "void (anonymous namespace)::pde_group<4, 4, true>(..."
        name = name.replace("(anonymous namespace)::", "").split("(")[0]
        return name.split("<")[0].split()[-1]

    return [(short(e.name), e.time_range.elapsed_us()) for e in kernels]


def captured(n, entries):
    """Every call's arguments of each (module, name) in config n's pipe,
    a list per entry in the order given."""
    h, w = configs.FRAMES[n]
    raw, meta, scene = synth_raw(h=h, w=w, kind="gradients")
    if n in configs.XTRANS_CONFIGS:
        raw, meta = configs.remosaic_xtrans(meta, scene)
    pipe = port.compile_pipeline(meta, configs.history(n))
    raw_dev = torch.from_numpy(pad_to(raw, pipe.pipe.spec_in)).cuda()
    calls = [[] for _ in entries]

    def keep(i, real):
        return lambda *a: calls[i].append(a) or real(*a)

    with swapped([(mod, name, keep(i, getattr(mod, name)))
                  for i, (mod, name) in enumerate(entries)]):
        pipe.run_padded(raw_dev)
    torch.cuda.synchronize()
    return calls


def pipe_ab(card, other):
    """Each config's pipe of both trees through run_padded on the same
    device-resident raw, img/s in the order other, this, this, other;
    this tree's launch counts checked against chip_smoke.py's."""
    for n, (launches, repeats) in PIPES.items():
        h, w = configs.FRAMES[n]
        raw, meta, scene = synth_raw(h=h, w=w, kind="gradients")
        if n in configs.XTRANS_CONFIGS:
            raw, meta = configs.remosaic_xtrans(meta, scene)
        this = port.compile_pipeline(meta, configs.history(n))
        that = other.compile_pipeline(
            meta, configs.history(n, item_cls=other.HistoryItem))
        raw_dev = torch.from_numpy(pad_to(raw, this.pipe.spec_in)).cuda()
        reset_launches()
        this.run_padded(raw_dev)
        got = read_launches()
        if got != launches:
            raise AssertionError(f"config {n} launches {got}")
        rates = [1.0 / time_pipe(p, raw_dev, repeats, warmups=1)
                 for p in (that, this, this, that)]
        peaks = [pipe_peak(p, raw_dev) for p in (that, this)]
        print(f"[pipe] config {n} {h}x{w} run_padded img/s: other "
              f"{rates[0]:.3f}, this {rates[1]:.3f}, this {rates[2]:.3f}, "
              f"other {rates[3]:.3f} ({repeats} images each); peak device "
              f"memory of one image other {peaks[0][0]:.3f} GB, this "
              f"{peaks[1][0]:.3f} GB ({peaks[1][1]:.3f} GB held before); "
              f"this tree's launches as chip_smoke.py's | {card}", flush=True)
        del this, that, raw_dev


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    card = card_line()
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{card}", flush=True)
    for line in ptxas((("this", ROOT), ("other", args.other))):
        print(line, flush=True)
    (o_rcd, o_mark, o_diffuse, o_nlm, o_sepblur, o_eaw, o_pw, o_iir,
     o_bgrid, o_warp) = other_kernels(args.other)
    pipe_ab(card, sys.modules["other_port"])
    diffuse3, blur3, chain3, rcd3, iir3 = captured(3, [
        (diffuse, "diffuse_iteration"), (sepblur, "sep_blur"),
        (pw, "pointwise_chain"), (rcd, "rcd_demosaic"),
        (iir, "gaussian_iir")])
    nlm2, blur2, eaw2, chain2 = captured(2, [
        (nlm, "nlm"), (sepblur, "sep_blur"), (eaw, "eaw_dn_coarse"),
        (pw, "pointwise_chain")])
    chain1, rcd1 = captured(1, [(pw, "pointwise_chain"),
                                (rcd, "rcd_demosaic")])
    chain4, mark4, lens4 = captured(4, [
        (pw, "pointwise_chain"), (markesteijn, "xtrans_markesteijn"),
        (warp, "lens_warp")])
    clip9, = captured(9, [(warp, "clip_warp")])
    ashift11, liquify11 = captured(11, [(warp, "homography_warp"),
                                        (warp, "liquify_warp")])
    chain7, slices7 = captured(7, [(pw, "pointwise_chain"),
                                   (bgrid, "slice_grid")])
    chains = {1: chain1, 2: chain2, 3: chain3, 4: chain4, 7: chain7}
    blur = blur2[0]
    mosaic4, pattern6, _ = mark4[0]
    cases = [
        ("rcd config 1", rcd1[0], rcd.rcd_demosaic, o_rcd.rcd_demosaic),
        ("rcd config 3", rcd3[0], rcd.rcd_demosaic, o_rcd.rcd_demosaic),
    ] + [
        (f"markesteijn {p} pass{'es' if p > 1 else ''}",
         (mosaic4, pattern6, p), markesteijn.xtrans_markesteijn,
         o_mark.xtrans_markesteijn) for p in (1, 3)
    ] + [
        ("diffuse", diffuse3[0], diffuse.diffuse_iteration,
         o_diffuse.diffuse_iteration),
        ("nlm", nlm2[0], nlm.nlm, o_nlm.nlm),
        ("sepblur config 3 d=1", blur3[0], sepblur.sep_blur,
         o_sepblur.sep_blur),
        ("iir config 3", iir3[0], iir.gaussian_iir, o_iir.gaussian_iir),
    ] + [
        (f"bgrid config 7 slice {i} {tuple(call[0].shape[:2])} ss {call[2]} "
         f"on {tuple(call[1].shape)}",
         call, bgrid.slice_grid, o_bgrid.slice_grid)
        for i, call in enumerate(slices7)
    ] + [
        (f"sepblur d={d}", blur[:2] + (d,), sepblur.sep_blur,
         o_sepblur.sep_blur) for d in (1, 32, 512)
    ] + [
        (f"eaw scale {eaw2[s][1]}", eaw2[s], eaw.eaw_dn_coarse,
         o_eaw.eaw_dn_coarse) for s in (0, 3, 6)
    ] + [
        (f"chain config {n}.{i}", call, pw.pointwise_chain,
         o_pw.pointwise_chain)
        for n in sorted(chains) for i, call in enumerate(chains[n])
    ] + [
        ("warp lens config 4", lens4[0], warp.lens_warp, o_warp.lens_warp),
        ("warp clipping config 9", clip9[0], warp.clip_warp,
         o_warp.clip_warp),
        ("warp ashift config 11", ashift11[0], warp.homography_warp,
         o_warp.homography_warp),
        ("warp liquify config 11", liquify11[0], warp.liquify_warp,
         o_warp.liquify_warp),
    ] + [
        (f"warp {name}, every tile direct", call, all_direct(fn), other_fn)
        for name, call, fn, other_fn in (
            ("clipping config 9", clip9[0], warp.clip_warp,
             o_warp.clip_warp),
            ("ashift config 11", ashift11[0], warp.homography_warp,
             o_warp.homography_warp),
            ("liquify config 11", liquify11[0], warp.liquify_warp,
             o_warp.liquify_warp))
    ]
    del diffuse3, blur3, chain3, rcd3, iir3, nlm2, blur2, eaw2, chain2
    del chains, chain1, rcd1, chain4, mark4, chain7, slices7, lens4, clip9
    del ashift11, liquify11
    for name, call, this_fn, other_fn in cases:
        x = call[0]
        got, want = this_fn(*call), other_fn(*call)
        torch.cuda.synchronize()
        for g, w_ in zip(*((got, want) if isinstance(got, tuple)
                           else ((got,), (want,)))):
            if not torch.equal(g, w_):
                raise AssertionError(f"{name}: this and other differ by "
                                     f"{(g - w_).abs().max().item()}")
        del got, want
        times = [median_ms(lambda: fn(*call), REPEATS)
                 for fn in (other_fn, this_fn, this_fn, other_fn)]
        print(f"[ab] {name} {tuple(x.shape)}: ms other {times[0]:.4f}, this "
              f"{times[1]:.4f}, this {times[2]:.4f}, other {times[3]:.4f} "
              f"(medians of {REPEATS}); outputs equal bit for bit | {card}",
              flush=True)
        for label, fn in (("this", this_fn), ("other", other_fn)):
            print(f"[launches] {name} {label}: " + ", ".join(
                f"{k} {us:.0f} us" for k, us in launch_times(
                    lambda: fn(*call))), flush=True)


if __name__ == "__main__":
    sys.exit(main())
