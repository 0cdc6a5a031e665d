#!/usr/bin/env python3
"""The float32 and special-function instructions per pixel that each
chain of the port's configs needs in the fused colour chain
(`csrc/pointwise_chain.cu`), counted from its SASS.

    python3 scripts/chain_count.py [--configs 1 2 3 4 7 10 11 12]
                                   [--stride 64] [--opcodes]

Three steps, on the machine with the card:

1. `nvcc` builds the chain source with the package's flags and
   `-lineinfo` into a cubin, and `nvdisasm --print-line-info-inline`
   lists its SASS, each instruction with the chain of (file, line) it was
   inlined through.
2. Each config's pipe runs once at its full frame (synth_raw, as
   `chip_smoke.py` makes it) with the chain wrapper's arguments kept;
   every `--stride`-th pixel of each chain's input goes through the same
   source built for the host with gcc's coverage instrumentation, which
   counts how often each source line runs on that data.  With
   `--opcodes`, also each op of `configs.GRADING_CASES` (its first
   parameter set, both saturation formulas of colorbalancergb) as a
   one-stage chain on config 10's chain inputs, as `chip_smoke.py`
   launches them: the RGB ops on the demosaiced image, the Lab ops on the
   second chain's input; and each op of `configs.LEGACY_CASES` (its
   first set, profile_gamma's three) on the input of the stage of config
   11's chain that `configs.legacy_jobs` picks.
3. Each SASS basic block of the interpreter kernel (`chain`) is weighted
   by the runs per pixel of its lines: a line of the kernel itself by its
   count over the pixels; a line of a device function without a loop by
   its count over the function's calls (the share of calls that take its
   branch); a line of a function with a loop by 1 if it ran at all (its
   copies in SASS are the unrolled iterations), unless the loop is
   marked `#pragma unroll 1` (a curve's nodes, the gamut series): then
   by its count over the function's calls, the iterations a call runs; a
   line of a template
   instantiated more than once (the stage dispatch `apply`), or of a
   file other than the chain source (a CUDA header), by 1, leaving the
   weight to its caller.  An instruction's weight is the product along
   its inline chain, and a block's the largest of its instructions' (a
   predicated instruction issues whether or not its branch is taken),
   over the opcode bodies' instructions where the block holds any (the
   dispatch work the compiler sinks into a case's first block runs once
   a stage, whichever case runs), and over those that are not a rolled
   loop's control where the block holds any (the `for` line runs once a
   call more than the body, and the compiler puts its first test into
   the prologue's block, which would weigh the prologue as the loop's
   iterations and the body as one more).  An accurate `logf` is a
   polynomial in float32 instructions, with no MUFU.
   The division and square-root slow paths, and the blocks that call
   them, are left out: they run only on denormal or huge operands.

What a chain needs is the opcode bodies' (the `case`s of the stage
switch) float32 arithmetic, FADD, FMUL, FFMA and FMNMX (a NaN-keeping
max or min is one `max.NaN.f32`), and their MUFU instructions (the
special-function unit: the reciprocal, square root, log2 and exp2
inside division, sqrtf, log2f and powf), which `chip_smoke.py` bounds
at their own rate.  Compares, selects, branches, integer work and the
interpreter's dispatch, pixel loads and stores and shared loads of the
constants are the implementation's, not the function's, and are left
out.  It prints, per chain, the whole kernel's and the bodies'
instructions per pixel by class; then the bodies' (float32, MUFU) counts
as the dict `chip_smoke.py` keeps.  Needs a CUDA device, nvcc, nvdisasm
and g++ with gcov.
"""

import argparse
import collections
import gzip
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import ansel_tpu_torch as port  # noqa: E402
from ansel_tpu_torch.io import configs  # noqa: E402
from ansel_tpu_torch.io.synthetic import synth_raw  # noqa: E402
from ansel_tpu_torch.kernels import _build  # noqa: E402
from ansel_tpu_torch.kernels import pointwise as pw  # noqa: E402
from ansel_tpu_torch.ops.base import pad_to  # noqa: E402

SOURCE = os.path.join(ROOT, "ansel_tpu_torch", "csrc", "pointwise_chain.cu")
KERNEL = "chain"
KERNEL_SYMBOL = re.compile(r"\d+chainE")  # the interpreter, not chain_fixed
FP32 = ("FADD", "FMUL", "FFMA", "FMNMX")

# host stand-ins for the CUDA names the chain source uses
HOST_HEADER = r"""
#pragma once
#include <cmath>
#include <cfloat>
#include <algorithm>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __restrict__
using std::isinf;
struct Dim3 { unsigned x = 0, y = 0, z = 0; };
static Dim3 threadIdx, blockIdx, blockDim{1, 1, 1}, gridDim{1, 1, 1};
inline void __syncthreads() {}
typedef void* cudaStream_t;
typedef int cudaError_t;
"""

# runs the kernel as one thread over a file's pixels (one row of them):
# n (int64), stages, consts (int32), prog, consts, 3 n floats
HOST_MAIN = r"""
#include <cstdio>
#include <vector>
int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  long long n;
  int ns, nk;
  if (fread(&n, 8, 1, f) != 1 || fread(&ns, 4, 1, f) != 1 ||
      fread(&nk, 4, 1, f) != 1) return 1;
  std::vector<int> prog(ns * RECORD);
  std::vector<float> k(nk), x(3 * n), y(3 * n);
  if (fread(prog.data(), 4, prog.size(), f) != prog.size() ||
      fread(k.data(), 4, nk, f) != (size_t)nk ||
      fread(x.data(), 4, x.size(), f) != x.size()) return 1;
  fclose(f);
  chain(x.data(), y.data(), n, (int)n, prog.data(), ns, k.data(), nk);
  return 0;
}
"""


def sass_listing(tmp):
    """nvdisasm's listing of the chain source, with inline line info."""
    cubin = os.path.join(tmp, "chain.cubin")
    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([_build.nvcc(), *flags, "-lineinfo", "-cubin", "-o", cubin,
                    SOURCE], check=True)
    nvdisasm = os.path.join(os.path.dirname(_build.nvcc()), "nvdisasm")
    return subprocess.run([nvdisasm, "--print-line-info-inline", cubin],
                          check=True, capture_output=True,
                          text=True).stdout.splitlines()


def sass_blocks(listing):
    """The interpreter kernel's basic blocks, each a list of (instruction,
    inline chain of (line, whether the line is the chain source's),
    innermost first); the slow-path subroutines after the kernel's body
    are dropped."""
    start = next(i for i, ln in enumerate(listing)
                 if ln.startswith(".text.") and KERNEL_SYMBOL.search(ln))
    marker = re.compile(r'\s*//## File "([^"]*)", line (\d+)'
                        r'( inlined at "[^"]*", line (\d+))?')
    source = os.path.realpath(SOURCE)
    blocks, block, pending, chain = [], [], [], ()
    for ln in listing[start + 1:]:
        if ln.startswith("//----") or ln.lstrip().startswith(".section"):
            break
        if ln.lstrip().startswith("$"):  # a subroutine: a slow path
            break
        m = marker.match(ln)
        if m:
            ours = os.path.realpath(m.group(1)) == source
            pending.append((int(m.group(2)), ours))
            if m.group(3) is None:
                chain, pending = tuple(pending), []
            continue
        if re.match(r"^\s*\.L_x_\d+:", ln):
            blocks.append(block)
            block = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", ln)
        if m:
            block.append((m.group(1), chain))
            if re.search(r"\b(BRA|BRX|EXIT|CALL|RET)\b", m.group(1)):
                blocks.append(block)
                block = []
    blocks.append(block)
    return [b for b in blocks if b]


def host_source(tmp):
    """The chain source cut after its interpreter, with a host main, as
    one C++ file whose line numbers are the source's."""
    lines = open(SOURCE).read().splitlines()
    cut = next(i for i, ln in enumerate(lines)
               if "specialised programs" in ln)
    with open(os.path.join(tmp, "cuda_runtime.h"), "w") as f:
        f.write(HOST_HEADER)
    path = os.path.join(tmp, "chain_host.cpp")
    with open(path, "w") as f:
        f.write("\n".join(lines[:cut]) + "\n}  // namespace\n" + HOST_MAIN)
    exe = os.path.join(tmp, "chain_host")
    subprocess.run(["g++", "-std=c++17", "-O0", "--coverage",
                    "-ffp-contract=off", "-I", tmp, "-o", exe, path],
                   check=True, cwd=tmp)
    return exe


def line_counts(exe, tmp, x, chain):
    """gcov's (line counts, functions) of one run of the host build over
    the pixels of x ((3, n) float32) through `chain`."""
    for name in os.listdir(tmp):
        if name.endswith(".gcda") or name.endswith(".json.gz"):
            os.remove(os.path.join(tmp, name))
    data = os.path.join(tmp, "pixels.bin")
    prog = chain.prog.cpu().numpy().astype(np.int32)
    consts = chain.consts.cpu().numpy().astype(np.float32)
    with open(data, "wb") as f:
        f.write(np.int64(x.shape[1]).tobytes())
        f.write(np.int32(prog.size // pw.RECORD).tobytes())
        f.write(np.int32(consts.size).tobytes())
        f.write(prog.tobytes())
        f.write(consts.tobytes())
        f.write(np.ascontiguousarray(x, dtype=np.float32).tobytes())
    subprocess.run([exe, data], check=True, cwd=tmp)
    subprocess.run(["gcov", "-j", "-o", tmp, "chain_host.cpp"], check=True,
                   cwd=tmp, capture_output=True)
    with gzip.open(os.path.join(tmp, "chain_host.gcov.json.gz")) as f:
        doc = json.load(f)
    (rec,) = [f for f in doc["files"] if f["file"].endswith("chain_host.cpp")]
    counts = {ln["line_number"]: ln["count"] for ln in rec["lines"]}
    funcs = [(fn["start_line"], fn["end_line"], fn["execution_count"])
             for fn in rec["functions"]]
    return counts, funcs


def weigh(blocks, counts, funcs, pixels, src_lines):
    """Instructions per pixel: ({class: count} of the whole kernel, of the
    opcode bodies), the classes "fp32" (FP32), "mufu", "shared load" and
    "other"."""
    def func(line):
        best = None
        for s, e, n in funcs:
            if s <= line <= e and (best is None or e - s < best[1] - best[0]):
                best = (s, e, n)
        return best

    # a template instantiated more than once: gcov sums its lines' counts
    # over the instantiations but counts each one's calls apart
    spans = collections.Counter((s, e) for s, e, _ in funcs)
    loops = {}

    def has_loop(fn):
        """'rolled' for a loop kept rolled (`#pragma unroll 1`), True for
        another loop, False for none."""
        if fn not in loops:
            body = src_lines[fn[0] - 1:fn[1]]
            loops[fn] = ("rolled" if any("#pragma unroll 1" in ln
                                         for ln in body)
                         else any(re.search(r"\bfor\s*\(", ln)
                                  for ln in body))
        return loops[fn]

    switch = next(i for i, ln in enumerate(src_lines, 1)
                  if "switch (rec[0])" in ln)
    kernel = func(switch)
    default = next(i for i in range(switch, kernel[1] + 1)
                   if "default:" in src_lines[i - 1])

    def weight(chain):
        w = 1.0
        for level, (line, ours) in enumerate(chain):
            fn = func(line) if ours else None
            if fn is None or spans[fn[:2]] > 1:
                continue
            c = counts.get(line, fn[2])
            if level == len(chain) - 1:
                w *= c / pixels
            elif has_loop(fn) == "rolled":
                w *= c / fn[2] if fn[2] else 0.0
            elif has_loop(fn):
                w *= 1.0 if c > 0 else 0.0
            else:
                w *= min(1.0, c / fn[2]) if fn[2] else 0.0
        return w

    def in_body(chain):
        return bool(chain) and chain[-1][1] and switch < chain[-1][0] < default

    def rolled_header(chain):
        """Whether an instruction is a rolled loop's control (its `for`
        line): that line runs once a call more than the body, and the
        compiler puts its first test in the prologue's block."""
        return any(ours and re.search(r"\bfor\s*\(", src_lines[line - 1])
                   and "#pragma unroll 1" in src_lines[line - 2]
                   for line, ours in chain)

    whole, bodies = collections.Counter(), collections.Counter()
    for block in blocks:
        if any("CALL" in ins for ins, _ in block):
            continue
        # a block of an opcode body is weighed by its body instructions
        # only: the compiler sinks dispatch work (the stage's const and int
        # pointers, attributed to the kernel's lines, which run once a
        # stage) into each case's first block, and that weight would make
        # the body of an opcode the chain never runs count as run.  Nor is
        # it weighed by a rolled loop's control, which would weigh the
        # loop's prologue (colorchecker's affine part) as its iterations
        chains = [chain for _, chain in block if in_body(chain)] \
            or [chain for _, chain in block]
        chains = [c for c in chains if not rolled_header(c)] or chains
        bw = max(weight(chain) for chain in chains)
        if bw == 0.0:
            continue
        for ins, chain in block:
            op = ins.split()[1] if ins.startswith("@") else ins.split()[0]
            op = op.split(".")[0]
            kind = ("fp32" if op in FP32 else "mufu" if op == "MUFU"
                    else "shared load" if op == "LDS" else "other")
            whole[kind] += bw
            if in_body(chain):
                bodies[kind] += bw
    return whole, bodies


def captured_chains(n, meta_out=None, groups_out=None):
    """(x, chain) of each chain call of config n's pipe at its frame (the
    chains' stage names appended to `groups_out`)."""
    h, w = configs.FRAMES[n]
    raw, meta, scene = synth_raw(h=h, w=w, kind="gradients")
    if meta_out is not None:
        meta_out.append(meta)
    if n in configs.XTRANS_CONFIGS:
        raw, meta = configs.remosaic_xtrans(meta, scene)
    pipe = port.compile_pipeline(meta, configs.history(n))
    if groups_out is not None:
        groups_out.extend(pipe.fused_groups())
    raw_dev = torch.from_numpy(pad_to(raw, pipe.pipe.spec_in)).cuda()
    calls, real = [], pw.pointwise_chain
    pw.pointwise_chain = lambda x, c: calls.append((x, c)) or real(x, c)
    try:
        pipe.run_padded(raw_dev)
    finally:
        pw.pointwise_chain = real
    torch.cuda.synchronize()
    return calls


def opcode_jobs():
    """((10, op[, formula]), x, chain) of each op of configs.GRADING_CASES
    as a one-stage chain on config 10's chain inputs, and ((11, op[, i]),
    x, chain) of each op of configs.LEGACY_CASES on config 11's, as
    chip_smoke.py launches them."""
    meta, groups = [], []
    calls = captured_chains(10, meta)
    jobs = configs.grading_jobs([x for x, _ in calls])
    (x, chain), = captured_chains(11, groups_out=groups)
    jobs += configs.legacy_jobs(x, chain, groups[0])
    return [(key, x, configs.opcode_chain(meta[0], name, prm, x.shape,
                                          x.device))
            for key, x, name, prm in jobs]


def fmt(parts):
    """'kind n.n, ...' of a {kind: instructions per pixel}."""
    return ", ".join(f"{k} {v:.1f}" for k, v in sorted(parts.items()))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", type=int, nargs="+",
                    default=[1, 2, 3, 4, 7, 10, 11, 12])
    ap.add_argument("--stride", type=int, default=64)
    ap.add_argument("--opcodes", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chain_count: no CUDA device")
    src_lines = open(SOURCE).read().splitlines()
    table = {}
    with tempfile.TemporaryDirectory() as tmp:
        blocks = sass_blocks(sass_listing(tmp))
        print(f"[sass] {KERNEL}: {sum(len(b) for b in blocks)} instructions "
              f"in {len(blocks)} blocks (slow paths left out)", flush=True)
        exe = host_source(tmp)
        jobs = [((n, i), x, chain) for n in args.configs
                for i, (x, chain) in enumerate(captured_chains(n))]
        if args.opcodes:
            jobs += opcode_jobs()
        for key, x, chain in jobs:
            xs = x.reshape(3, -1)[:, ::args.stride].cpu().numpy()
            counts, funcs = line_counts(exe, tmp, xs, chain)
            whole, bodies = weigh(blocks, counts, funcs, xs.shape[1],
                                  src_lines)
            table[key] = (round(bodies["fp32"]), round(bodies["mufu"]))
            ops = [int(r[0]) for r in
                   chain.prog.view(-1, pw.RECORD).tolist()]
            print(f"[count] {key} opcodes {ops} on "
                  f"{xs.shape[1]} pixels of {tuple(x.shape)}: kernel "
                  f"{sum(whole.values()):.1f} per pixel ({fmt(whole)}); "
                  f"opcode bodies {sum(bodies.values()):.1f} "
                  f"({fmt(bodies)})", flush=True)
    print("OPS_CHAIN = " + repr(table), flush=True)


if __name__ == "__main__":
    sys.exit(main())
