#!/usr/bin/env python3
"""The readings that a cell's check limit is set from, on the card, in
one process:

    python3 rawbench/control.py --workload <cell> --seeds 1-12 \\
        --control-seeds 1-3 [--seconds 3]

For each of `--seeds`, the program drives a short window of the cell's
own roll at its own load and the widest gap of its checked outputs from
the reference is read (the lower reading).  For each of
`--control-seeds`, the control takes the program's place: the reference
with its image rounded to bfloat16 after every stage, the nearest
precision below the configuration's float32, read on the same images
(the upper reading).  One JSON line a reading, then a summary line.
The benchmark's own runs do not run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def seeds(text: str) -> list:
    out = []
    for part in text.split(","):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b) + 1)) if b else [int(a)]
    return out


def readings(workload: str, program_seeds, control_seeds, seconds: float,
             device: str = "cuda", cfg: dict = None, emit=print) -> dict:
    """-> {"program": [gap per seed], "control": [gap per seed]}."""
    import torch

    from rawbench import harness, loadgen, scene

    bench = harness.load_bench()
    cell, centry = harness.cell_of(bench, workload)
    cfg = cfg or harness.load_config(centry)
    mix = loadgen.load(cell["traffic"])
    roll_n = int(mix["roll_images"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device == "cuda":
        from ansel_tpu_torch.kernels import _build

        _build.build_all()
    pipe = harness.build_pipe(cfg, device)
    out = {"program": [], "control": []}
    for seed in sorted(set(program_seeds) | set(control_seeds)):
        hists = harness.histories(cfg, mix, seed)
        drv = harness.Exporter(cfg, pipe, scene.roll(cfg, seed, roll_n,
                                                     device),
                               mix, hists, device)
        mosaics = drv.mosaics
        drv.drive(max_images=harness.warmup_images(mix))
        roll = drv.drive(seconds=seconds, keep_at=harness.keep_times(
            seed, int(cfg["check_images"]), seconds))
        sides = []
        if seed in program_seeds:
            sides.append(("program", roll.kept))
        if seed in control_seeds:
            # the control's outputs on the same images: the reference
            # rounded to bfloat16 after every stage
            from rawbench import reference

            ctl = [(n, reference.run(
                centry["name"], cfg if hists is None
                else dict(cfg, history=hists[n % roll_n]),
                mosaics[n % roll_n].to(device), round_to=torch.bfloat16))
                for n, _ in roll.kept]
            sides.append(("control", ctl))
        for side, kept in sides:
            t = time.perf_counter()
            gaps = harness.check(cfg, centry["name"], mosaics, kept, roll_n,
                                 hists, device)
            out[side].append(max(gaps))
            emit(json.dumps({"workload": workload, "seed": seed,
                             "side": side, "max_gap": max(gaps),
                             "images": len(kept), "window_images":
                             roll.submitted, "check_s":
                             time.perf_counter() - t}))
        del drv, roll, mosaics
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    from rawbench import harness

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    res = readings(args.workload, seeds(args.seeds),
                   seeds(args.control_seeds), args.seconds)
    lower, upper = max(res["program"]), min(res["control"])
    print(json.dumps({"workload": args.workload, "lower": lower,
                      "upper": upper, "ratio": upper / max(lower, 1e-30),
                      "card": harness.card_name()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
