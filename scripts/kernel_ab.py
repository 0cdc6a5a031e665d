#!/usr/bin/env python3
"""Times the diffuse-iteration, NLM and sepblur kernels of this checkout
against those of another checkout, on one GPU, in turns.

    python3 scripts/kernel_ab.py --other DIR

DIR holds another tree of the repo's `ansel_tpu_torch/`, such as `git
archive` of an earlier commit unpacked into a git-ignored directory; that
package is imported as `other_port` and builds its kernels under
DIR/build.  The arguments are those that config 3's pipe hands its first
diffuse iteration ((3, 5504, 8320), S = 5, isotropic) and config 2's
pipe hands NLM ((3, 4000, 6016), 225 offsets, P = 1, variant 1) and its
first sepblur ((4, 1000, 1504), 5 taps, d = 1; also timed at d = 32),
captured from this checkout's pipes on synth_raw mosaics.  It first
prints what `nvcc -Xptxas -v` reports (registers, shared memory, spills)
for both trees' diffuse.cu and nlm.cu.  Then each kernel's output is held
bit for bit against the other tree's and timed in the order other, this,
this, other (each the median of REPEATS calls, device time between CUDA
events behind a spin kernel, as chip_smoke.py times its kernels), and
each device kernel that one call of either tree launches is listed in
launch order with its time (torch.profiler).  Needs a CUDA device.
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
from ansel_tpu_torch.kernels import _build, diffuse, nlm, sepblur  # noqa: E402
from ansel_tpu_torch.ops.base import pad_to  # noqa: E402
from chip_smoke import card_line, median_ms, swapped  # noqa: E402

REPEATS = 10


def other_kernels(root):
    """The diffuse, NLM and sepblur wrapper modules of the tree at
    `root`."""
    init = os.path.join(root, "ansel_tpu_torch", "__init__.py")
    spec = importlib.util.spec_from_file_location(
        "other_port", init, submodule_search_locations=[os.path.dirname(init)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["other_port"] = mod
    spec.loader.exec_module(mod)
    return [importlib.import_module(f"other_port.kernels.{name}")
            for name in ("diffuse", "nlm", "sepblur")]


def ptxas(trees):
    """`nvcc -Xptxas -v` lines of diffuse.cu and nlm.cu for each (label,
    root) tree, one nvcc per source, all started together."""
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
                for label, root in trees for name in ("diffuse", "nlm")]
        return [line for job in jobs for line in job.result()]


def launch_times(fn):
    """(kernel name, device us) of each kernel one call of fn launches,
    in launch order (the name up to its template arguments)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    """The first call's arguments of each (module, name) in config n's
    pipe, in the order given."""
    h, w = configs.FRAMES[n]
    raw, meta, _ = synth_raw(h=h, w=w, kind="gradients")
    pipe = port.compile_pipeline(meta, configs.history(n))
    raw_dev = torch.from_numpy(pad_to(raw, pipe.pipe.spec_in)).cuda()
    calls = [[] for _ in entries]

    def keep(i, real):
        return lambda *a: calls[i].append(a) or real(*a)

    with swapped([(mod, name, keep(i, getattr(mod, name)))
                  for i, (mod, name) in enumerate(entries)]):
        pipe.run_padded(raw_dev)
    torch.cuda.synchronize()
    return [c[0] for c in calls]


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
    other_diffuse, other_nlm, other_sepblur = other_kernels(args.other)
    (diffuse_call,) = captured(3, [(diffuse, "diffuse_iteration")])
    nlm_call, blur_call = captured(2, [(nlm, "nlm"), (sepblur, "sep_blur")])
    cases = [
        ("diffuse", diffuse_call, diffuse.diffuse_iteration,
         other_diffuse.diffuse_iteration),
        ("nlm", nlm_call, nlm.nlm, other_nlm.nlm),
        ("sepblur d=1", blur_call, sepblur.sep_blur, other_sepblur.sep_blur),
        ("sepblur d=32", blur_call[:2] + (32,), sepblur.sep_blur,
         other_sepblur.sep_blur),
    ]
    for name, call, this_fn, other_fn in cases:
        x = call[0]
        got, want = this_fn(*call), other_fn(*call)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: this and other differ by "
                                 f"{(got - want).abs().max().item()}")
        del got, want
        times = [median_ms(lambda: fn(*call), REPEATS)
                 for fn in (other_fn, this_fn, this_fn, other_fn)]
        print(f"[ab] {name} {tuple(x.shape)}: ms other {times[0]:.3f}, this "
              f"{times[1]:.3f}, this {times[2]:.3f}, other {times[3]:.3f} "
              f"(medians of {REPEATS}); outputs equal bit for bit | {card}",
              flush=True)
        for label, fn in (("this", this_fn), ("other", other_fn)):
            print(f"[launches] {name} {label}: " + ", ".join(
                f"{k} {us:.0f} us" for k, us in launch_times(
                    lambda: fn(*call))), flush=True)


if __name__ == "__main__":
    sys.exit(main())
