#!/usr/bin/env python3
"""rawbench: one run of one cell of the benchmark of ansel_tpu_torch.

    python3 rawbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout on a machine with a CUDA card.  Prints the
set-up's parts, the checked numbers and their limits on standard error,
and the result as one JSON line, the last of standard output.  Exits
with 2, printing no result, where no card is found, and with 3 where a
module of JAX or of the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "build", "rawbench")
# the bytecode of every module the run imports (torch's ~1100 among them)
# is cached at a fixed path in the checkout, like the kernels: only the
# first run there compiles it, whatever the interpreter's default
sys.pycache_prefix = os.path.join(CACHE, "pycache")
sys.dont_write_bytecode = False

import argparse  # noqa: E402
import json  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    # every build and kernel cache at a fixed path inside the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)
    sys.path.insert(0, ROOT)

    import torch

    from rawbench import harness

    bench = harness.load_bench()
    cell, _ = harness.cell_of(bench, args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        print(f"rawbench: {args.workload} needs {cell['chips']} CUDA "
              "card(s); none usable here", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), t0=T0, bench=bench)
    found = harness.forbidden_modules()
    if found:
        print(f"rawbench: loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
