#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`ansel_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Builds every CUDA kernel from `ansel_tpu_torch/csrc/` (one nvcc per
source, all started together), holds each kernel against its plain torch
version on the card at the shapes the main paths give it, and drives
the three main paths through `compile_pipeline` and `output_array`, the
entry points a user calls, at their full frames:

  * bench config 1 at 24 MP (4000 x 6016; exposure +0.5,
    channelmixerrgb, filmicrgb): RCD and the fused colour chain;
  * bench config 2 at 24 MP, the high-ISO denoise stack (highlights
    guided Laplacian, denoiseprofile wavelets and NLM, exposure,
    filmicrgb): RCD, the chain, the sepblur, EAW and NLM kernels;
  * bench config 3 at 45 MP (5504 x 8256), the heavy iterative stack
    (diffuse 4 iterations, toneequal, local-Laplacian bilat, exposure,
    filmicrgb): RCD, the chain, sepblur, the IIR and diffuse kernels;
  * bench config 4 at 24 MP (an X-Trans 4000 x 6000 mosaic; Markesteijn,
    lens with TCA, exposure, filmicrgb): the Markesteijn and warp
    kernels and the chain;
  * the port's config 7 at 24 MP (4000 x 6016), the bilateral-grid stack
    (bilateral, exposure, filmicrgb, shadhi and bilat mode 0 through the
    grid, sharpen): RCD, the chain, sepblur and the grid-slice kernel;
  * the port's config 8 at 24 MP (4000 x 6016), the headless export: the
    history (hot pixels, raw denoise, CA correction on the mosaic and in
    RGB, NLM, defringe, bloom, exposure, filmicrgb) written as an XMP
    sidecar with an inactive blend blob on every item, as darktable
    writes them, and exported through the CLI (`ansel_tpu_torch.cli.main`)
    to a 16-bit PNG: RCD, the chain, sepblur, the IIR and NLM; then the
    CLI's `--devtest` and `entry()`;
  * the port's config 9 at 24 MP (4000 x 6016), a camera DNG (the 14-bit
    mosaic with a GainMap flat field in its OpcodeList2, written by this
    script) exported from its sidecar through the CLI: the flat field,
    flip (orientation 6), clipping (a 2-degree rotation and a 5% crop),
    exposure and filmicrgb to a 16-bit PNG, then with `--width 2048
    --height 2048` (initialscale) to a JPEG and a PDF: RCD, the warp
    kernel on clipping's map and the chain;
  * the port's config 10 at 24 MP (4000 x 6016), a graded look on top of
    config 1 (graduatednd, atrous, colorbalancergb, rgbcurve, tonecurve,
    colorzones, vignette): RCD, the chain in two programs of 5 and 10
    stages that read pixel positions, and the EAW kernel's atrous
    variant; each of the eleven grading opcodes is also held alone;
  * the port's config 11 at 24 MP (4000 x 6016), a pre-3.0 catalogue's
    look on config 1, straightened and retouched (ashift, liquify,
    colorbalance, velvia, vibrance, colorcontrast, colisa, splittoning):
    RCD, the warp kernel on ashift's homography and on liquify's brush
    displacement over its window, and the chain in one program of 15
    stages; each of the twelve legacy opcodes is also held alone;
  * the port's config 12 at 24 MP (4000 x 6016), a hazy back-lit
    landscape with a blown sky exported with film grain to 8 bits
    (exposure +1 EV, hazeremoval, filmicrgb with its highlight
    reconstruction planned and fired, grain, dither): RCD, the chain in
    four programs (filmicrgb's AgX alone after the reconstruction) and
    sepblur 36 times for the reconstruction's a-trous passes at
    dilations 1-256; before it JAX's generator (`pixel/prng`) on the card
    against the CPU, after it each op of `configs.OPS12` (censorize on
    the IIR and sepblur kernels, the salted Laplacian, tonemap,
    globaltonemap, colormapping, crystgrain) alone on its frame.
    Config 2's NLM input also runs the lattices past the kernel's chunk
    (K 15) and a patch radius past its template limit (P 9).

Each path runs with the launch counts set to 0 just before it and read
just after.  Every chain each config builds is also timed on its own
arguments, through its specialised kernel and the interpreter (which
must agree bit for bit), against its bound.  One line per phase; the line before the
last is the kernels' JSON record, the last line the device record.  Any failure
raises, so the script then exits non-zero without the last line.  It
needs a CUDA device and imports neither JAX nor `ansel_tpu`.
"""

import contextlib
import dataclasses
import json
import os
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

import ansel_tpu_torch as port
from ansel_tpu_torch import cli
from ansel_tpu_torch.entry import entry
from ansel_tpu_torch.io import configs
from ansel_tpu_torch.io.encode import read_png16, to_uint16, write_image
from ansel_tpu_torch.io.rawfile import load_raw, save_raw
from ansel_tpu_torch.io.synthetic import synth_raw
from ansel_tpu_torch.io.xmp import XMPDocument, parse_xmp, write_xmp
from ansel_tpu_torch.kernels import (_build, bgrid, diffuse, eaw, iir,
                                     markesteijn, nlm, rcd, sepblur, warp)
from ansel_tpu_torch.kernels import pointwise as pw
from ansel_tpu_torch.ops.base import pad_to
from ansel_tpu_torch.pipeline.blend import BlendParams
from ansel_tpu_torch.pipeline.export import export_image
from ansel_tpu_torch.pixel import prng
from ansel_tpu_torch.pixel.nlmeans import search_offsets

H, W = configs.BENCH_H, configs.BENCH_W
H3, W3 = configs.BENCH3_H, configs.BENCH3_W
H4, W4 = configs.BENCH4_H, configs.BENCH4_W
NO_LAUNCHES = {"rcd": 0, "chain": 0, "eaw": 0, "nlm": 0, "sepblur": 0,
               "iir": 0, "diffuse": 0, "markesteijn": 0, "warp": 0,
               "bgrid": 0}
LAUNCHES1 = dict(NO_LAUNCHES, rcd=1, chain=1)
LAUNCHES2 = dict(NO_LAUNCHES, rcd=1, chain=1, eaw=7, nlm=1, sepblur=360)
# config 3: chains [exposure], [colorin], [filmicrgb, _convert],
# [_convert, colorout]; the 10-level local Laplacian blurs 9 + 6 x 18 + 9
# times; toneequal's guided mask one IIR pair; diffuse one per iteration
LAUNCHES3 = dict(NO_LAUNCHES, rcd=1, chain=4, sepblur=126, iir=1, diffuse=4)
STAGES3 = ["rawprepare", "temperature", "highlights", "demosaic", "exposure",
           "toneequal", "colorin", "diffuse", "filmicrgb", "_convert",
           "bilat", "_convert", "colorout"]
# config 4: Markesteijn 1 pass, the lens warp, one chain
LAUNCHES4 = dict(NO_LAUNCHES, chain=1, markesteijn=1, warp=1)
STAGES4 = ["rawprepare", "temperature", "highlights", "demosaic", "lens",
           "exposure", "colorin", "filmicrgb", "colorout"]
# config 7: three chains, sharpen's blur, five grid slices (bilateral's
# three channels, shadhi's three-channel grid, bilat's)
LAUNCHES7 = dict(NO_LAUNCHES, rcd=1, chain=3, sepblur=1, bgrid=5)
STAGES7 = ["rawprepare", "temperature", "highlights", "demosaic",
           "bilateral", "exposure", "colorin", "_convert", "sharpen",
           "_convert", "filmicrgb", "_convert", "shadhi", "bilat",
           "_convert", "colorout"]
# config 8: three chains (config 7's sequences); rawdenoise's hat wavelet
# at d = 1, 2, 4, 8, 16 and defringe's sigma-4 blur; cacorrectrgb's seven
# Gaussians of sigma 5 (the guide, two four-plane manifolds, four safety
# planes); the nlmeans op's NLM pass
LAUNCHES8 = dict(NO_LAUNCHES, rcd=1, chain=3, sepblur=6, iir=7, nlm=1)
STAGES8 = ["rawprepare", "temperature", "highlights", "cacorrect",
           "hotpixels", "rawdenoise", "demosaic", "cacorrectrgb", "exposure",
           "colorin", "_convert", "nlmeans", "defringe", "_convert",
           "filmicrgb", "_convert", "bloom", "_convert", "colorout"]
# config 9: the chain of configs 2 and 4's sequence, RCD, the warp once
# on clipping's map
LAUNCHES9 = dict(NO_LAUNCHES, rcd=1, chain=1, warp=1)
STAGES9 = ["rawprepare", "temperature", "highlights", "demosaic", "flip",
           "clipping", "exposure", "colorin", "filmicrgb", "colorout"]
# config 10: the two chains (the second with colorbalancergb, the three
# curves and vignette), RCD, one atrous EAW scale each of the seven the
# 24 MP frame plans
LAUNCHES10 = dict(NO_LAUNCHES, rcd=1, chain=2, eaw=7)
STAGES10 = ["rawprepare", "temperature", "highlights", "demosaic",
            "exposure", "graduatednd", "colorin", "channelmixerrgb",
            "_convert", "atrous", "_convert", "colorbalancergb", "rgbcurve",
            "filmicrgb", "_convert", "tonecurve", "colorzones", "_convert",
            "vignette", "colorout"]
# config 11: RCD, the warp twice (ashift's homography, liquify's window),
# one chain of 15 stages
LAUNCHES11 = dict(NO_LAUNCHES, rcd=1, chain=1, warp=2)
STAGES11 = ["rawprepare", "temperature", "highlights", "demosaic", "ashift",
            "liquify", "exposure", "colorin", "channelmixerrgb",
            "colorbalance", "filmicrgb", "_convert", "colisa",
            "colorcontrast", "_convert", "velvia", "_convert", "vibrance",
            "_convert", "splittoning", "colorout"]
# config 12: RCD; the chain four times (exposure + colorin, filmicrgb's
# AgX after its highlight reconstruction, to Lab, from Lab + colorout);
# sepblur 36 times for the reconstruction (9 scales x 2 blurs x 2 passes)
# and 3 times for grain's box means
LAUNCHES12 = dict(NO_LAUNCHES, rcd=1, chain=4, sepblur=39)
HR_BLURS12 = 36
STAGES12 = ["rawprepare", "temperature", "highlights", "demosaic",
            "hazeremoval", "exposure", "colorin", "filmicrgb", "_convert",
            "grain", "_convert", "colorout", "dither"]
# run B's bounding box
BOX9 = 2048
NOISE_SIGMA = 200.0  # sensor units of 16383: a high-ISO mosaic
HOT8 = 1024          # hot photosites of config 8's frame, at the white point
REPEATS = 10         # kernel timings
PLAIN_REPEATS = 2    # plain twins at 24 MP take up to 0.6 s each
PIPE2_REPEATS = 3
PIPE3_REPEATS = 3
PIPE4_REPEATS = 10
PIPE12_REPEATS = 5
OPS12_REPEATS = 2
# the generator's normal draw on the card against the CPU: erf_inv's
# log1p and sqrt are torch's on either device and may part in the last
# bit; values reach ~5.4 (an ulp 4.8e-7)
NORMAL_TOL = 1e-6
PIPE7_REPEATS = 5
PIPE8_REPEATS = 5
PIPE9_REPEATS = 10

# H100 SXM peaks (NVIDIA's data sheet, at the 700 W limit): device
# memory rate and float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
SPIN_CLOCK_HZ = 1.98e9  # boost clock: sizes the spin kernel of median_ms
# instructions a warp scheduler issues: 4 per SM per clock, 32 lanes
# each, at the boost clock (a kernel built with --fmad=false issues each
# float32 multiply and add alone)
INSTR_PER_S = 132 * 4 * 32 * 1.98e9
# float32 operations per output pixel (per tap or offset where named),
# counted from each kernel's source; the fast exponentials count 4
FLOPS_RCD = 330
# RCD's IEEE divisions per pixel, each one MUFU reciprocal: the load's
# normalisation 1, the two statistics 2, at R/B sites the green's 6 and
# the chroma's 2, at G sites the two chroma planes' 4 (9 on average)
MUFU_RCD = 9
# MUFU instructions (reciprocal, square root, log2, exp2) the special
# function units issue: 16 a SM a clock (H100 architecture), at the boost
# clock
SFU_PER_S = 132 * 16 * 1.98e9
# what each chain needs per pixel, per (config, chain of its pipe in
# order): (float32 instructions, MUFU instructions), counted by
# scripts/chain_count.py from the SASS of the chain's opcode bodies: the
# float32 arithmetic (FADD, FMUL, FFMA, FMNMX; a NaN-keeping max or min is
# one max.NaN) and the MUFU instructions inside division, sqrtf, log2f
# and powf, each basic block weighted by how often that config's chain
# input takes its source lines (a gcov build of the same source over
# every 64th pixel; a block of an opcode body by its body instructions
# alone, and not by a rolled loop's control, which runs once a call more
# than the loop's body); compares, selects, branches, integer work and the
# dispatch are the implementation's and left out, as are the division
# and square-root slow paths (scripts/chain_count.py on an H100; recount
# when csrc/pointwise_chain.cu or a config's chain changes)
OPS_CHAIN = {(1, 0): (1095, 57), (2, 0): (847, 42), (3, 0): (6, 0),
             (3, 1): (15, 0), (3, 2): (835, 45), (3, 3): (219, 3),
             (4, 0): (846, 42), (7, 0): (183, 6), (7, 1): (895, 45),
             (7, 2): (219, 3),
             # config 9 runs config 4's program (1) on its clipped frame;
             # config 4's count, not recounted on config 9's pixels
             (9, 0): (846, 42),
             (10, 0): (491, 28), (10, 1): (4028, 152), (11, 0): (2231, 88),
             # each grading opcode alone on config 10's chain inputs
             # (`--opcodes`), colorbalancergb in dt UCS (1) and JzAzBz (0)
             (10, "colorbalancergb", 1): (1927, 72),
             (10, "colorbalancergb", 0): (1960, 59),
             (10, "rgbcurve"): (156, 5), (10, "rgblevels"): (74, 4),
             (10, "basecurve"): (140, 5), (10, "tonecurve"): (140, 5),
             (10, "levels"): (62, 3), (10, "basicadj"): (321, 10),
             (10, "colorzones"): (537, 15), (10, "negadoctor"): (318, 12),
             (10, "vignette"): (109, 6), (10, "graduatednd"): (61, 7),
             # each legacy opcode alone on config 11's chain's stage inputs
             # (`configs.legacy_jobs`), profile_gamma in its three forms
             (11, "velvia"): (58, 2), (11, "vibrance"): (15, 1),
             (11, "colorcontrast"): (6, 0), (11, "colorcorrection"): (8, 0),
             (11, "colisa"): (79, 3), (11, "splittoning"): (147, 0),
             (11, "colorize"): (4, 0), (11, "colorbalance"): (330, 12),
             (11, "splittoningrgb"): (118, 3), (11, "lowlight"): (407, 14),
             (11, "profile_gamma", 0): (174, 8),
             (11, "profile_gamma", 1): (231, 5),
             (11, "profile_gamma", 2): (135, 3),
             (11, "colorchecker"): (390, 0),
             # config 12: [exposure, colorin], filmicrgb's AgX alone
             # after its highlight reconstruction, to Lab, from Lab +
             # colorout (config 3's program on config 12's pixels)
             (12, 0): (21, 0), (12, 1): (666, 39), (12, 2): (183, 6),
             (12, 3): (219, 3)}
FLOPS_SEPBLUR_PER_TAP = 4        # two passes, a multiply and an add each
FLOPS_EAW = 25 * 24 + 10         # 25 taps; the divide and the detail
# the atrous variant per pixel: 25 taps of the three differences and
# squares 6, the chroma sum 1, the two scaled exponents 2 and fast
# exponentials 8, the two tap weights 2, three products and sums 6 and
# three weight sums 3; then three divides and three details
FLOPS_EAW_ATROUS = 25 * 28 + 6
FLOPS_NLM_PER_OFFSET = 31        # d2 11, box sum 4 (the column sums
                                 # shared), weight 9, sums 7
FLOPS_IIR = 30                   # per value: 15 per axis, both recursions
# NLM variant 0 (the nlmeans op) at P = 2, per pixel and offset: d2 11,
# the 5 x 5 box sum 8 (the column sums shared), the weight 5 (a product
# and the fast exponential), sums 7
FLOPS_NLM_V0_P2 = 31
# diffuse, per channel-pixel and scale: the B3 decompose (two 5-tap
# passes and HF) and the isotropic PDE step (q 6, box 4, energy 6,
# stencils 2 x 8, four kernels 7, update 5)
FLOPS_DIFFUSE_DECOMPOSE = 19
FLOPS_DIFFUSE_PDE_ISO = 44
# Markesteijn per pixel, each step counted only at the sites that need it
# and averaged over the 6 x 6 period (16 non-green, 4 solitary-green and
# 16 2x2-green sites of 36): greens 45 at non-green sites (20),
# solitary-green R/B 122 at solitary greens (14), R@B/B@R 60 at non-green
# sites (27), 2x2 fill 45 at 2x2 greens (20), per direction YPbPr once (9)
# and its derivative (14), counts 4 + 17 per direction, vote 8 per
# direction (the 5x5 box sum taken separably) + 40: 317 for 1 pass; 3
# passes add the recalculation (60 at non-green sites, 27), two more R/B
# sets (122) and 8 directions in place of 4 (698)
FLOPS_MARKESTEIJN = {1: 317, 3: 698}


def mufu_markesteijn(pattern6, passes):
    """Markesteijn's IEEE divisions per pixel (one MUFU reciprocal each;
    the halvings and eighths are exact products), averaged over the 6 x 6
    period: the vote's 3, per set and buffer the 2x2-green fill's two
    thirds where its hex pair is used, and per recalculation sweep and
    buffer a third at each non-green site it updates."""
    allhex, sgrow, sgcol = markesteijn.build_hex_tables(tuple(pattern6))
    pat = np.asarray(pattern6).reshape(6, 6)
    sets, total = (1 if passes == 1 else 3), 3 * 36
    for y in range(6):
        for x in range(6):
            rsg, csg = y % 3 == sgrow, x % 3 == sgcol
            hexes = allhex[(y % 3, x % 3)]
            if pat[y, x] == 1 and not rsg and not csg:
                total += sets * 2 * sum(
                    markesteijn._pair_nonzero(hexes, 2 * d) for d in range(4))
            elif pat[y, x] != 1 and passes == 3:
                for first, second in zip(*markesteijn.RECALC):
                    total += 2 * sum(hd != 0 and rsg == bool(sense)
                                     for hd, sense in (first, second))
    return total / 36
# the lens warp per pixel, three channels: the map 25 once, per channel
# the TCA factor 5, the coordinates 4 and the bilinear sample 25
FLOPS_WARP = 125
# clipping's map per pixel: the translation 4, the shears 4, the rotation
# 6, the outside test 4 (no keystone in config 9), then per channel the
# bilinear sample 25
FLOPS_CLIP_MAP, FLOPS_CLIP_CHANNEL = 18, 25
# ashift's homography per pixel: the denominator 4, the two numerators 4
# each and their divisions 2, the outside test 4; then per channel the
# bilinear sample 25
FLOPS_HOMOGRAPHY_MAP = 18
# liquify per pixel and stamp whose disc holds the pixel: the offsets 2,
# the distance 5 (two products, a sum, the square root, the division),
# Horner's nine steps 18, the clip 2, the term 2 and the sums 2; a
# radial stamp's term takes 8 rather than 2.  Per pixel of the window,
# the source position 2, then per channel the bilinear sample 25
FLOPS_LIQUIFY_PAIR, FLOPS_LIQUIFY_RADIAL = 31, 6
# the grid slice per pixel: the row weights 15, the bins 3 and their four
# tests; per channel and valid bin (b0, and b0 + 1 unless b0 = D - 1) the
# two column blends 6, the row blend 3 and the bin weight 2 (b0: 1 - f
# and the product) or 1 (b0 + 1), and the two bins' sum 1
FLOPS_BGRID_PIXEL = 22
FLOPS_BGRID_BIN0, FLOPS_BGRID_BIN1, FLOPS_BGRID_SUM = 11, 10, 1

# RCD: the kernel does the plain version's float32 operations in the same
# order (built with --fmad=false; division and sqrt are IEEE), so the two
# agree to rounding of the final `* scaler`; 1e-6 * scaler leaves room
# for that and is ten times tighter than the first bound set for it.  The
# kernel is also held to equality with its twin, which it meets (as does
# Markesteijn's).
RCD_TOL = 1e-6
# chain: powf/log2f/expf in the kernel and torch's pow/log2 on the card
# may differ by an ulp, and the filmic spline and gamut map amplify that
# on steep parts of the curve; display values are in [0, 1].  A chain
# that ends in Lab (config 3's [filmicrgb, _convert]) gives values up to
# 100, whose ulp is 100 times larger: there both bounds scale with the
# output's largest magnitude.
CHAIN_MAX_TOL, CHAIN_MEAN_TOL = 1e-4, 1e-6
# sepblur, EAW, NLM: the kernels repeat their twins' float32 operations in
# the same order and the fast exponentials are bit tricks; inputs are
# below ~10 (the VST'd and normalised planes).
STENCIL_TOL = 1e-5
# Markesteijn and the warp: the twins' float32 operations in the same order,
# true divisions, no transcendental; an ulp would move a direction
MARK_TOL = WARP_TOL = 1e-5
# the grid slice: its twin's float32 operations in the same order, no
# transcendental, a true division: bit for bit
BGRID_TOL = 0.0
# the IIR: its twin's float32 recursions in the same operand order, the
# forward and backward ones added once: bit for bit
IIR_TOL = 0.0
# the whole pipe against the plain functions composed: one display code
PIPE_TOL = 1.0 / 255.0
# config 7 with only the chain kernel kept against the rest's twins: every
# other kernel on its path (RCD, sepblur, the grid slice) matches its twin
# bit for bit and the splat between them is deterministic (a scatter that
# does not accumulate, a float32 bmm), so the outputs are equal
PIPE7_REST_TOL = 0.0
# config 8 likewise with only the chain kernel kept: RCD, sepblur, the IIR
# and NLM match their twins bit for bit, and the plain torch between them
# (cacorrect's sums and 6x6 solve, defringe's mean, the box means' cumulative
# sums) runs the same calls in both runs
PIPE8_REST_TOL = 0.0


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def median_ms(fn, repeats=REPEATS):
    """Median over `repeats` of one call's device time, CUDA events.  A
    spin kernel as long as the host took to enqueue the warm-up call (at
    most 50 ms) runs before each, so the events bracket the card's work
    and not the host's launch overhead (a wrapper's ctypes call and
    allocation cost tens of microseconds, which a 0.07 ms kernel would
    otherwise carry)."""
    t = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    spin_cycles = int((min(host_s, 0.05) + 1e-3) * SPIN_CLOCK_HZ)
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
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


def bound(bytes_moved, flops=0, instructions=0, sfu=0):
    """Least time on the card (ms) and what sets it: the bytes at the
    memory's rate, or the float32 operations at the float32 rate, the
    instructions at the issue rate or the MUFU instructions (among them)
    at the special function units' rate, whichever is longest."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = max(flops / FP32_FLOPS_PER_S, instructions / INSTR_PER_S,
                sfu / SFU_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def check_chains(config, calls, groups):
    """Each chain call (x, chain) of config `config`'s pipe on its own
    arguments: the kernel the wrapper picks (the chain's specialised
    program) vs the interpreter (bit for bit) and vs plain (both bounds
    scaled by the output's largest magnitude, which a chain that ends in
    Lab makes ~100), device times, and the bound: the three planes read
    and written once, against the chain's OPS_CHAIN instructions per
    pixel.  Returns the rows."""
    rows = []
    for i, ((x, chain), names) in enumerate(zip(calls, groups)):
        interpreted = dataclasses.replace(chain, fixed=-1)
        got = pw.pointwise_chain(x, chain)
        expect(chain.fixed >= 0 and torch.equal(
            got, pw.pointwise_chain(x, interpreted)),
            f"chain {config}.{i}: specialised program {chain.fixed} "
            "differs from the interpreter")
        want = pw.pointwise_chain_reference(x, chain)
        mx, mean = compare(got, want)
        scale = max(1.0, want.abs().max().item())
        del want, got
        expect(mx <= CHAIN_MAX_TOL * scale and mean <= CHAIN_MEAN_TOL * scale,
               f"chain {config}.{i}: max {mx}, mean {mean} (x {scale:.3g})")
        ms = median_ms(lambda: pw.pointwise_chain(x, chain))
        interp_ms = median_ms(lambda: pw.pointwise_chain(x, interpreted))
        plain_ms = median_ms(lambda: pw.pointwise_chain_reference(x, chain),
                             PLAIN_REPEATS)
        fp32, mufu = OPS_CHAIN[(config, i)]
        px = x[0].numel()
        b_ms, b_by = bound(2 * nbytes(x), instructions=(fp32 + mufu) * px,
                           sfu=mufu * px)
        rows.append(dict(max_abs_err=mx, ms=ms, plain_ms=plain_ms,
                         library_ms=None, bound_ms=b_ms, bound_by=b_by,
                         program=chain.fixed))
        print(f"[chain] config {config} chain {i} {'+'.join(names)} on "
              f"{tuple(x.shape)}: program {chain.fixed}, equal to the "
              f"interpreter; vs plain max {mx:.3g} mean {mean:.3g} (tol "
              f"{CHAIN_MAX_TOL:g} / {CHAIN_MEAN_TOL:g} x {scale:.3g}) | "
              f"kernel {ms:.4f} ms, interpreter {interp_ms:.4f} ms, plain "
              f"{plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}; {fp32} "
              f"float32 + {mufu} MUFU a pixel: issue "
              f"{(fp32 + mufu) * px / INSTR_PER_S * 1e3:.4f} ms, SFU "
              f"{mufu * px / SFU_PER_S * 1e3:.4f} ms; bytes "
              f"{2 * nbytes(x) / HBM_BYTES_PER_S * 1e3:.4f} ms)", flush=True)
    return rows


KERNEL_MODULES = {"rcd": rcd, "chain": pw, "eaw": eaw, "nlm": nlm,
                  "sepblur": sepblur, "iir": iir, "diffuse": diffuse,
                  "markesteijn": markesteijn, "warp": warp, "bgrid": bgrid}


def reset_launches():
    for mod in KERNEL_MODULES.values():
        mod.LAUNCHES = 0
    pw.PROGRAM_LAUNCHES.clear()
    warp.MAP_LAUNCHES.clear()


def read_launches():
    return {k: mod.LAUNCHES for k, mod in KERNEL_MODULES.items()}


def read_split():
    """The launches since reset_launches of each chain program (its index
    in pointwise.FIXED, -1 the interpreter) and of each warp map."""
    return dict(pw.PROGRAM_LAUNCHES), dict(warp.MAP_LAUNCHES)


@contextlib.contextmanager
def swapped(swaps):
    """Replace module attributes for the duration: (module, name, fn)."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def plain_twins(keep=()):
    """Each wrapper's kernel entry swapped for its plain twin (this
    script's own switch: the package has none), so a run composes the
    twins; the modules in `keep` launch their kernels."""
    return swapped([swap for swap in [
        (rcd, "rcd_demosaic", rcd.rcd_demosaic_reference),
        (pw, "pointwise_chain", pw.pointwise_chain_reference),
        (sepblur, "sep_blur", sepblur.sep_blur_reference),
        (eaw, "eaw_dn_coarse",
         lambda x, s, c: eaw.eaw_coarse_reference(x, s, c, eaw.DN)),
        (eaw, "eaw_atrous_coarse",
         lambda x, s, c: eaw.eaw_coarse_reference(x, s, c, eaw.ATROUS)),
        (nlm, "nlm", nlm.nlm_reference),
        (iir, "gaussian_iir", iir.gaussian_iir_reference),
        (diffuse, "diffuse_iteration", diffuse.diffuse_iteration_reference),
        (markesteijn, "xtrans_markesteijn",
         markesteijn.xtrans_markesteijn_reference),
        (warp, "lens_warp", warp.lens_warp_reference),
        (warp, "clip_warp", warp.clip_warp_reference),
        (warp, "homography_warp", warp.homography_warp_reference),
        (warp, "liquify_warp", warp.liquify_warp_reference),
        (bgrid, "slice_grid", bgrid.slice_grid_reference),
    ] if swap[0] not in keep])


@contextlib.contextmanager
def timed(phases, name):
    """Add the seconds the block takes to phases[name]."""
    t = time.perf_counter()
    try:
        yield
    finally:
        phases[name] = phases.get(name, 0.0) + time.perf_counter() - t


def noisy_like(raw_dev, sigma, seed=8):
    """`synth_raw`'s noise step on the card: the clean mosaic plus
    N(0, sigma) sensor units, clipped to [0, 65535]."""
    gen = torch.Generator(device=raw_dev.device).manual_seed(seed)
    noise = torch.randn(raw_dev.shape, generator=gen, device=raw_dev.device)
    return (raw_dev + sigma * noise).clamp_(0.0, 65535.0)


def captured_inputs(pipe, raw_dev):
    """Run the pipe once on a device-resident raw and keep the arguments
    its new kernels were called with: the first sepblur call at each
    dilation, every EAW scale, the NLM pass and the chain."""
    calls = {"sepblur": {}, "eaw": [], "nlm": [], "chain": []}
    real_sb, real_eaw, real_nlm = sepblur.sep_blur, eaw.eaw_dn_coarse, nlm.nlm
    real_chain = pw.pointwise_chain

    def sb(x, taps, d=1):
        calls["sepblur"].setdefault(d, (x, taps, d))
        return real_sb(x, taps, d)

    def ew(*args):
        calls["eaw"].append(args)
        return real_eaw(*args)

    def nl(*args):
        calls["nlm"].append(args)
        return real_nlm(*args)

    def ch(*args):
        calls["chain"].append(args)
        return real_chain(*args)

    with swapped([(sepblur, "sep_blur", sb), (eaw, "eaw_dn_coarse", ew),
                  (nlm, "nlm", nl), (pw, "pointwise_chain", ch)]):
        pipe.run_padded(raw_dev)
    expect(sorted(calls["sepblur"]) == [1, 2, 4, 8, 16, 32]
           and len(calls["eaw"]) == 7 and len(calls["nlm"]) == 1
           and len(calls["chain"]) == 1,
           f"unexpected kernel calls {[(k, len(v)) for k, v in calls.items()]}")
    return calls


def run_config1(card, record, raw, raw_dev, meta, pool):
    """Config 1's kernel checks and pipe; returns the future of its
    16-bit PNG size (encoded on a host thread)."""
    pipe = port.compile_pipeline(meta, configs.history(1))
    expect(pipe.device.type == "cuda", "compile_pipeline left the card")
    stages = [s.name for s in pipe.pipe.stages]
    expect(stages[3] == "demosaic" and pipe.fused_groups() == [stages[4:]],
           f"unexpected plan {stages}, chains {pipe.fused_groups()}")
    expect(raw.shape == pipe.pipe.spec_in.array_shape, "raw needs padding")
    mosaic = pipe.pipe.trace_fn(0, 3)(raw_dev, pipe.coeffs[0:3])
    cfa = pipe.pipe.stages[3].plan.spec_in.cfa
    scaler = pipe.coeffs[3]["scaler"]
    s = float(scaler)

    # -- RCD kernel vs plain: config-1 mosaic and a flat one
    flat = torch.full_like(mosaic, 0.3 * s)
    errs, rcd_err = [], 0.0
    for name, m in (("config-1", mosaic), ("flat", flat)):
        got = rcd.rcd_demosaic(m, cfa, scaler)
        want = rcd.rcd_demosaic_reference(m, cfa, scaler)
        mx, mean = compare(got, want)
        expect(mx <= RCD_TOL * s, f"rcd {name}: max {mx} > {RCD_TOL} x {s}")
        expect(torch.equal(got, want), f"rcd {name}: not bit-equal")
        rcd_err = max(rcd_err, mx)
        errs.append(f"{name} max {mx:.3g} mean {mean:.3g}")
        del got, want
    rcd_ms = median_ms(lambda: rcd.rcd_demosaic(mosaic, cfa, scaler))
    rcd_plain_ms = median_ms(
        lambda: rcd.rcd_demosaic_reference(mosaic, cfa, scaler),
        PLAIN_REPEATS)
    rgb = rcd.rcd_demosaic(mosaic, cfa, scaler)
    record["rcd"] = dict(max_abs_err=rcd_err, ms=rcd_ms,
                         plain_ms=rcd_plain_ms, library_ms=None)
    record["rcd"]["bound_ms"], record["rcd"]["bound_by"] = bound(
        nbytes(mosaic, rgb), instructions=FLOPS_RCD * mosaic.numel(),
        sfu=MUFU_RCD * mosaic.numel())
    print(f"[rcd] {H}x{W} kernel vs plain: {'; '.join(errs)} "
          f"(tol {RCD_TOL:g} x scaler {s:.4g}; bit-equal) | kernel "
          f"{rcd_ms:.3f} ms, plain {rcd_plain_ms:.3f} ms, bound "
          f"{record['rcd']['bound_ms']:.3f} ms "
          f"({record['rcd']['bound_by']})", flush=True)

    # -- chain kernel vs plain on the demosaic output
    chain = next(a for kind, _, _, a in pipe.steps if kind == "chain")
    (record["chain"],) = check_chains(1, [(rgb, chain)], pipe.fused_groups())

    # -- the full pipe through the user's entry point, launches counted
    reset_launches()
    out = pipe.output_array(raw)
    launches = read_launches()
    expect(launches == LAUNCHES1, f"launches {launches}")
    expect(out.shape == (3, H, W), f"output shape {out.shape}")
    expect(bool(np.isfinite(out).all()) and out.min() >= 0.0
           and out.max() <= 1.0, "output not finite or outside [0, 1]")
    plain = pw.pointwise_chain_reference(
        rcd.rcd_demosaic_reference(mosaic, cfa, scaler), chain)
    so = pipe.pipe.spec_out
    pipe_err = float(np.abs(out - plain[:, :so.height, :so.width]
                            .cpu().numpy()).max())
    expect(pipe_err <= PIPE_TOL, f"pipe vs plain: max {pipe_err}")
    peak, held = pipe_peak(pipe, raw_dev)
    per_img = time_pipe(pipe, raw_dev, REPEATS)
    print(f"[pipe] config 1 {H}x{W}: {len(stages)} stages, chains "
          f"{pipe.fused_groups()}, launches {launches}, vs plain max "
          f"{pipe_err:.3g} (tol 1/255), range [{out.min():.3g}, "
          f"{out.max():.3g}] | {1.0 / per_img:.2f} img/s, "
          f"{H * W / per_img / 1e6:.1f} MP/s ({per_img * 1e3:.1f} ms/img, "
          f"device-resident input), peak device memory {peak:.3f} GB "
          f"({held:.3f} GB held before) on {card}", flush=True)
    return pool.submit(png_size, out, "config1.png")


def time_pipe(pipe, raw_dev, repeats, warmups=2):
    """Seconds per image of run_padded, device-resident, after warm-ups."""
    for _ in range(warmups):
        pipe.run_padded(raw_dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(repeats):
        pipe.run_padded(raw_dev)
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / repeats


def pipe_peak(pipe, raw_dev):
    """(peak, held before) device GB of one run_padded call:
    max_memory_allocated after reset_peak_memory_stats, and what was
    allocated when the call began."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    pipe.run_padded(raw_dev)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 1e9, held / 1e9


def png_size(out, name):
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, name)
        write_image(png, out, bpp=16, icc=None)
        size = os.path.getsize(png)
    expect(size > 0, "empty PNG")
    return size


def check_sepblur(inputs, record):
    """The (4, H/4, W/4) Laplacian stacks at dilations 1-32."""
    err, lib_err, rows, ms, plain_ms, lib_ms = 0.0, 0.0, [], [], [], []
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the yardstick in float32
    try:
        for label, calls in inputs:
            for d, (x, taps, _) in sorted(calls.items()):
                mx, _ = compare(sepblur.sep_blur(x, taps, d),
                                sepblur.sep_blur_reference(x, taps, d))
                expect(mx <= STENCIL_TOL, f"sepblur {label} d={d}: max {mx}")
                err = max(err, mx)
                if label != "clean":
                    continue
                k = torch.tensor(taps, device=x.device)
                weight = torch.outer(k, k).expand(x.shape[0], 1, 5, 5)
                weight = weight.contiguous()
                xp = F.pad(x[None], (2 * d,) * 4, mode="replicate")
                conv = F.conv2d(xp, weight, dilation=d, groups=x.shape[0])[0]
                lx, _ = compare(conv, sepblur.sep_blur_reference(x, taps, d))
                expect(lx <= 1e-3, f"conv2d yardstick d={d}: {lx}")
                lib_err = max(lib_err, lx)
                ms.append(median_ms(lambda: sepblur.sep_blur(x, taps, d)))
                plain_ms.append(median_ms(
                    lambda: sepblur.sep_blur_reference(x, taps, d)))
                lib_ms.append(median_ms(lambda: F.conv2d(
                    xp, weight, dilation=d, groups=x.shape[0])))
                rows.append(f"d={d} {ms[-1]:.4f}/{plain_ms[-1]:.3f}/"
                            f"{lib_ms[-1]:.3f}")
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    x, taps, _ = inputs[0][1][1]
    # reach 1024, the highlights Laplacian's widest (scales 12: 5 taps at
    # d = 512), through the two passes
    far = sepblur.sep_blur(x, taps, 512)
    far_err, _ = compare(far, sepblur.sep_blur_reference(x, taps, 512))
    expect(far_err <= STENCIL_TOL, f"sepblur d=512: max {far_err}")
    err = max(err, far_err)
    far_ms = median_ms(lambda: sepblur.sep_blur(x, taps, 512))
    b_ms, b_by = bound(2 * nbytes(x),
                       FLOPS_SEPBLUR_PER_TAP * len(taps) * x.numel())
    record["sepblur"] = dict(max_abs_err=err, ms=float(np.mean(ms)),
                             plain_ms=float(np.mean(plain_ms)),
                             library_ms=float(np.mean(lib_ms)),
                             bound_ms=b_ms, bound_by=b_by)
    print(f"[sepblur] {tuple(x.shape)} B3 kernel vs plain on clean and "
          f"noisy stacks, and at d=512 (reach 1024, two passes, max "
          f"{far_err:.3g}, {far_ms:.4f} ms): max {err:.3g} (tol "
          f"{STENCIL_TOL:g}); conv2d vs plain max {lib_err:.3g} | ms "
          f"kernel/plain/conv2d: {', '.join(rows)} | bound {b_ms:.4f} ms "
          f"({b_by})", flush=True)


def check_eaw(inputs, record):
    """Config 2's seven wavelet scales (the Y0U0V0 VST of the demosaic
    output, then each scale's coarse image), and one atrous check."""
    err, rows, ms, plain_ms = 0.0, [], [], []
    for label, calls in inputs:
        for x, scale, inv_sigma2 in calls:
            got = eaw.eaw_dn_coarse(x, scale, inv_sigma2)
            want = eaw.eaw_coarse_reference(x, scale, inv_sigma2, eaw.DN)
            for g, w_ in zip(got, want):
                mx, _ = compare(g, w_)
                expect(mx <= STENCIL_TOL, f"eaw {label} s={scale}: max {mx}")
                err = max(err, mx)
            if label != "clean":
                continue
            ms.append(median_ms(lambda: eaw.eaw_dn_coarse(x, scale,
                                                          inv_sigma2)))
            plain_ms.append(median_ms(
                lambda: eaw.eaw_coarse_reference(x, scale, inv_sigma2,
                                                 eaw.DN), PLAIN_REPEATS))
            rows.append(f"s{scale} {ms[-1]:.3f}/{plain_ms[-1]:.1f}")
        x = calls[3][0]
        got = eaw.eaw_atrous_coarse(x, 3, 2.0)
        want = eaw.eaw_coarse_reference(x, 3, 2.0, eaw.ATROUS)
        for g, w_ in zip(got, want):
            mx, _ = compare(g, w_)
            expect(mx <= STENCIL_TOL, f"eaw atrous {label}: max {mx}")
            err = max(err, mx)
    x = inputs[0][1][0][0]
    b_ms, b_by = bound(3 * nbytes(x), FLOPS_EAW * x[0].numel())
    record["eaw"] = dict(max_abs_err=err, ms=float(np.mean(ms)),
                         plain_ms=float(np.mean(plain_ms)), library_ms=None,
                         bound_ms=b_ms, bound_by=b_by)
    print(f"[eaw] {tuple(x.shape)} dn scales 0-6 and atrous scale 3, kernel "
          f"vs plain on the clean and noisy config-2 scales: max {err:.3g} (tol "
          f"{STENCIL_TOL:g}) | ms kernel/plain: {', '.join(rows)} | bound "
          f"{b_ms:.3f} ms per scale ({b_by})", flush=True)


def check_nlm(inputs, record):
    """Config 2's NLM pass (variant 1) on its own input, and variant 0, on
    the resident path; then the clean input through a scattered lattice
    (K 7, scattering 1.0, variant 1), whose reach takes the streamed
    path."""
    err = 0.0
    for label, calls in inputs:
        v, *args1 = calls[0]
        offs, P = args1[0], args1[1]
        args0 = (offs, P, (1.0, 0.5, 0.5), 0.02, 0.0, 1.0, 0)
        for args in (args1, args0):
            mx, _ = compare(nlm.nlm(v, *args), nlm.nlm_reference(v, *args))
            expect(mx <= STENCIL_TOL, f"nlm {label} variant {args[-1]}: {mx}")
            err = max(err, mx)
        if label == "clean":
            ms = median_ms(lambda: nlm.nlm(v, *args1))
            plain_ms = median_ms(lambda: nlm.nlm_reference(v, *args1),
                                 PLAIN_REPEATS)
            far = (search_offsets(7, 1.0),) + tuple(args1[1:])
            far_reach = nlm._reach(far[0])
            expect(not nlm.plan(P, far_reach)[0], "scattered lattice resident")
            far_err, _ = compare(nlm.nlm(v, *far), nlm.nlm_reference(v, *far))
            expect(far_err <= STENCIL_TOL, f"nlm scattered: max {far_err}")
            far_ms = median_ms(lambda: nlm.nlm(v, *far))
    expect(nlm.plan(P, nlm._reach(offs))[0], "config 2's lattice streamed")
    b_ms, b_by = bound(2 * nbytes(v),
                       FLOPS_NLM_PER_OFFSET * len(offs) * v[0].numel())
    record["nlm"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=None, bound_ms=b_ms, bound_by=b_by)
    print(f"[nlm] {tuple(v.shape)} {len(offs)} offsets P={P}, variants 1 and "
          f"0, kernel (resident window) vs plain on clean and noisy: max "
          f"{err:.3g} (tol {STENCIL_TOL:g}) | kernel {ms:.3f} ms, plain "
          f"{plain_ms:.1f} ms, bound {b_ms:.3f} ms ({b_by}) | scattered "
          f"lattice (K 7, scattering 1.0, {len(far[0])} offsets, reach "
          f"{far_reach}, streamed): max {far_err:.3g}, kernel {far_ms:.3f} ms",
          flush=True)


def check_nlm_wide(call, record):
    """Config 2's noisy NLM input (variant 1) through what its planner
    emits for a wider denoiseprofile: nbhood 15 (961 offsets, two chunks
    carried in float32 scratch) at its P 1, and a patch radius of 9 (the
    wide form, P at run time) over K 3.  Each is held bit for bit against
    the twin on a 1000 x 1504 crop (the twin walks 961 offsets over whole
    planes) and timed at 24 MP."""
    v, offs, P, norm, sharp, cp_norm, inv1cw, variant = call
    center = 1.0 / inv1cw - 1.0
    rows = []
    wide = {}
    for label, K, p in (("K 15", 15, P), ("P 9", 3, 9)):
        lattice = search_offsets(K)
        n = 2 * p + 1
        args = (lattice, p, norm, sharp, center * n * n, inv1cw, variant)
        crop = v[:, :1000, :1504].contiguous()
        before = nlm.LAUNCHES
        got = nlm.nlm(crop, *args)
        chunks = nlm.LAUNCHES - before
        want = nlm.nlm_reference(crop, *args)
        mx, _ = compare(got, want)
        expect(torch.equal(got, want), f"nlm {label}: max {mx}")
        del got, want
        ms = median_ms(lambda: nlm.nlm(v, *args))
        plain_ms = median_ms(lambda: nlm.nlm_reference(crop, *args), 1)
        b_ms, b_by = bound(2 * nbytes(v),
                           FLOPS_NLM_PER_OFFSET * len(lattice) * v[0].numel())
        wide[label] = dict(max_abs_err=mx, ms=ms, bound_ms=b_ms,
                           launches_per_call=chunks)
        rows.append(f"{label} ({len(lattice)} offsets, P {p}, {chunks} "
                    f"launch{'es' if chunks > 1 else ''} a call): bit-equal "
                    f"on (3, 1000, 1504), plain there {plain_ms:.1f} ms | "
                    f"kernel {ms:.3f} ms on {tuple(v.shape)}, bound "
                    f"{b_ms:.3f} ms ({b_by})")
    record["nlm"]["wide"] = wide
    print(f"[nlm-wide] variant {variant}: {'; '.join(rows)}", flush=True)


def run_config2(card, record, raw, raw_dev, meta, pool, phases, pngs):
    """Config 2's pipe, then its kernel checks on the arguments the pipe
    hands them (clean and noisy mosaic) while the PNGs encode, then the
    pipe's timing; `pngs` are the PNG futures to wait for before it."""
    pipe = port.compile_pipeline(meta, configs.history(2))
    stages = [s.name for s in pipe.pipe.stages]
    expect(stages == ["rawprepare", "temperature", "highlights", "demosaic",
                      "denoiseprofile", "denoiseprofile", "exposure",
                      "colorin", "filmicrgb", "colorout"],
           f"unexpected config-2 plan {stages}")
    expect(pipe.fused_groups() == [stages[6:]],
           f"unexpected chains {pipe.fused_groups()}")
    expect(raw.shape == pipe.pipe.spec_in.array_shape, "raw needs padding")

    # -- config 2 through the user's entry point, launches counted
    with timed(phases, "pipe2 vs plain"):
        reset_launches()
        out = pipe.output_array(raw)
        launches = read_launches()
        expect(launches == LAUNCHES2, f"config-2 launches {launches}")
        expect(out.shape == (3, H, W), f"output shape {out.shape}")
        expect(bool(np.isfinite(out).all()) and out.min() >= 0.0
               and out.max() <= 1.0, "output not finite or outside [0, 1]")
        pngs.append(pool.submit(png_size, out, "config2.png"))
        reset_launches()
        with plain_twins():
            plain = pipe.output_array(raw)
        expect(all(v == 0 for v in read_launches().values()),
               f"the plain composition launched kernels: {read_launches()}")
        pipe_err = float(np.abs(out - plain).max())
        expect(pipe_err <= PIPE_TOL, f"config 2 vs plain: max {pipe_err}")
    with timed(phases, "capture"):
        calls = [(label, captured_inputs(pipe, r)) for label, r in
                 (("clean", raw_dev),
                  ("noisy", noisy_like(raw_dev, NOISE_SIGMA)))]
    with timed(phases, "sepblur"):
        check_sepblur([(label, c["sepblur"]) for label, c in calls], record)
    with timed(phases, "eaw"):
        check_eaw([(label, c["eaw"]) for label, c in calls], record)
    with timed(phases, "nlm"):
        check_nlm([(label, c["nlm"]) for label, c in calls], record)
    with timed(phases, "nlm-wide"):
        check_nlm_wide(calls[1][1]["nlm"][0], record)
    with timed(phases, "chain2"):
        check_chains(2, calls[0][1]["chain"], pipe.fused_groups())
    del calls

    with timed(phases, "png wait"):
        png_bytes = [f.result() for f in pngs]
    with timed(phases, "pipe2 timing"):
        per_img = time_pipe(pipe, raw_dev, PIPE2_REPEATS, warmups=1)
    print(f"[pipe2] config 2 {H}x{W}: {len(stages)} stages, chains "
          f"{pipe.fused_groups()}, launches {launches}, vs plain max "
          f"{pipe_err:.3g} (tol 1/255), range [{out.min():.3g}, "
          f"{out.max():.3g}] | {1.0 / per_img:.3f} img/s, "
          f"{per_img * 1e3:.1f} ms/img (device-resident input, "
          f"{PIPE2_REPEATS} repeats) on {card}", flush=True)
    print(f"[png] 16-bit PNG of config 1 {png_bytes[0]} B, config 2 "
          f"{png_bytes[1]} B (encoded on a host thread)", flush=True)
    return launches


def captured3(pipe, raw_dev):
    """Run config 3 once on a device-resident raw and keep the arguments
    of every kernel call: RCD, the IIR, the four diffuse iterations, the
    four chains and the 126 blurs."""
    calls = {"rcd": [], "iir": [], "diffuse": [], "chain": [], "sepblur": []}
    real = {"rcd": rcd.rcd_demosaic, "iir": iir.gaussian_iir,
            "diffuse": diffuse.diffuse_iteration,
            "chain": pw.pointwise_chain, "sepblur": sepblur.sep_blur}

    def keep(key):
        def call(*args):
            calls[key].append(args)
            return real[key](*args)
        return call

    with swapped([(rcd, "rcd_demosaic", keep("rcd")),
                  (iir, "gaussian_iir", keep("iir")),
                  (diffuse, "diffuse_iteration", keep("diffuse")),
                  (pw, "pointwise_chain", keep("chain")),
                  (sepblur, "sep_blur", keep("sepblur"))]):
        pipe.run_padded(raw_dev)
    counts = {k: len(v) for k, v in calls.items()}
    expect(counts == {k: LAUNCHES3[k] for k in calls},
           f"unexpected kernel calls {counts}")
    return calls


def check_reused3(calls):
    """The kernels of configs 1 and 2 on config 3's shapes: RCD on the
    45 MP mosaic and the local Laplacian's 126 blurs (45 MP planes down to
    11 x 17), each blur timed: their sum is sepblur's device time per
    image on config 3."""
    m, cfa, scaler = calls["rcd"][0]
    s = float(scaler)
    got = rcd.rcd_demosaic(m, cfa, scaler)
    want = rcd.rcd_demosaic_reference(m, cfa, scaler)
    rcd_err, _ = compare(got, want)
    expect(rcd_err <= RCD_TOL * s, f"rcd: max {rcd_err} > {RCD_TOL} x {s}")
    expect(torch.equal(got, want), "rcd on config 3: not bit-equal")
    rcd_ms = median_ms(lambda: rcd.rcd_demosaic(m, cfa, scaler))
    rcd_bound, rcd_by = bound(nbytes(m, got), instructions=FLOPS_RCD * m.numel(),
                              sfu=MUFU_RCD * m.numel())
    del got, want
    sb_err, sb_ms, b_ms = 0.0, [], 0.0
    for x, taps, *d in calls["sepblur"]:
        mx, _ = compare(sepblur.sep_blur(x, taps, *d),
                        sepblur.sep_blur_reference(x, taps, *d))
        expect(mx <= STENCIL_TOL, f"sepblur {tuple(x.shape)}: max {mx}")
        sb_err = max(sb_err, mx)
        sb_ms.append(median_ms(lambda: sepblur.sep_blur(x, taps, *d)))
        b_ms += bound(2 * nbytes(x),
                      FLOPS_SEPBLUR_PER_TAP * len(taps) * x.numel())[0]
    first = tuple(calls["sepblur"][0][0].shape)
    print(f"[reuse3] kernel vs plain on config 3's arguments: rcd "
          f"{tuple(m.shape)} max {rcd_err:.3g} (bit-equal), {rcd_ms:.3f} ms "
          f"(bound {rcd_bound:.3f} ms, {rcd_by}); {len(calls['sepblur'])} "
          f"blurs {first} and down, max {sb_err:.3g} | sepblur "
          f"{sum(sb_ms):.3f} ms per image (bound {b_ms:.3f} ms; the "
          f"largest, {first}, {max(sb_ms):.4f} ms)", flush=True)


def check_iir(calls, record):
    """toneequal's (average, square) pair at 1/4 size, sigma ~103."""
    x, coef, lo, hi = calls[0]
    mx, mean = compare(iir.gaussian_iir(x, coef, lo, hi),
                       iir.gaussian_iir_reference(x, coef, lo, hi))
    expect(mx <= IIR_TOL, f"iir: max {mx}")
    ms = median_ms(lambda: iir.gaussian_iir(x, coef, lo, hi))
    plain_ms = median_ms(lambda: iir.gaussian_iir_reference(x, coef, lo, hi),
                         PLAIN_REPEATS)
    b_ms, b_by = bound(2 * nbytes(x), FLOPS_IIR * x.numel())
    # the recursion's chain of dependent steps, one line's a pass
    floor_ms = iir.latency_floor_ms(*x.shape[-2:])
    record["iir"] = dict(max_abs_err=mx, ms=ms, plain_ms=plain_ms,
                         library_ms=None, bound_ms=b_ms, bound_by=b_by)
    print(f"[iir] {tuple(x.shape)} order 0, kernel vs plain on the config-3 "
          f"pair: max {mx:.3g} mean {mean:.3g} (tol {IIR_TOL:g}) | "
          f"kernel {ms:.4f} ms, plain {plain_ms:.1f} ms, bound {b_ms:.4f} ms "
          f"({b_by}), latency floor {floor_ms:.4f} ms ({iir.STEP_CYCLES} "
          f"cycles a step at {iir.CLOCK_HZ / 1e9:g} GHz)", flush=True)


def check_diffuse(calls, record):
    """Config 3's first and last diffuse iterations on their own inputs."""
    err, means = 0.0, []
    for args in (calls[0], calls[-1]):
        mx, mean = compare(diffuse.diffuse_iteration(*args),
                           diffuse.diffuse_iteration_reference(*args))
        expect(mx <= STENCIL_TOL, f"diffuse: max {mx}")
        err = max(err, mx)
        means.append(f"{mean:.3g}")
    x, c, scales, modes = calls[0]
    expect(tuple(modes) == (0, 0, 0, 0), f"modes {modes}: the operation "
           "count below is the isotropic one")
    ms = median_ms(lambda: diffuse.diffuse_iteration(x, c, scales, modes))
    plain_ms = median_ms(
        lambda: diffuse.diffuse_iteration_reference(x, c, scales, modes),
        PLAIN_REPEATS)
    flops = (FLOPS_DIFFUSE_DECOMPOSE + FLOPS_DIFFUSE_PDE_ISO) * scales \
        * x.numel()
    b_ms, b_by = bound(2 * nbytes(x), flops)
    record["diffuse"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             library_ms=None, bound_ms=b_ms, bound_by=b_by)
    print(f"[diffuse] {tuple(x.shape)} {scales} scales, modes {modes}, kernel "
          f"vs plain on iterations 1 and 4 of config 3: max {err:.3g} mean "
          f"{', '.join(means)} (tol {STENCIL_TOL:g}) | kernel {ms:.3f} ms, "
          f"plain {plain_ms:.1f} ms, bound {b_ms:.3f} ms ({b_by})",
          flush=True)


def run_config3(card, record, raw, meta, phases):
    """Config 3's pipe at 45 MP against the composed twins, its two new
    kernels on the arguments the pipe hands them, then its timing."""
    pipe = port.compile_pipeline(meta, configs.history(3))
    stages = [s.name for s in pipe.pipe.stages]
    expect(stages == STAGES3, f"unexpected config-3 plan {stages}")
    expect(pipe.fused_groups() == [["exposure"], ["colorin"],
                                   ["filmicrgb", "_convert"],
                                   ["_convert", "colorout"]],
           f"unexpected chains {pipe.fused_groups()}")
    static = pipe.pipe.stages[stages.index("diffuse")].plan.static
    expect(static == (5, 4, (0, 0, 0, 0), False), f"diffuse plan {static}")
    # the pipe runs 8256 columns padded to 8320 (a multiple of 128)
    raw_dev = torch.from_numpy(pad_to(raw, pipe.pipe.spec_in)).cuda()

    # -- config 3 through the user's entry point, launches counted
    with timed(phases, "pipe3 vs plain"):
        reset_launches()
        out = pipe.output_array(raw)
        launches = read_launches()
        expect(launches == LAUNCHES3, f"config-3 launches {launches}")
        expect(out.shape == (3, H3, W3), f"output shape {out.shape}")
        expect(bool(np.isfinite(out).all()) and out.min() >= 0.0
               and out.max() <= 1.0, "output not finite or outside [0, 1]")
        reset_launches()
        with plain_twins():
            plain = pipe.output_array(raw)
        expect(all(v == 0 for v in read_launches().values()),
               f"the plain composition launched kernels: {read_launches()}")
        pipe_err = float(np.abs(out - plain).max())
        expect(pipe_err <= PIPE_TOL, f"config 3 vs plain: max {pipe_err}")
        del plain
    with timed(phases, "capture3"):
        calls = captured3(pipe, raw_dev)
    with timed(phases, "iir"):
        check_iir(calls["iir"], record)
    with timed(phases, "diffuse"):
        check_diffuse(calls["diffuse"], record)
    with timed(phases, "reuse3"):
        check_reused3(calls)
    with timed(phases, "chain3"):
        check_chains(3, calls["chain"], pipe.fused_groups())
    del calls
    with timed(phases, "pipe3 timing"):
        per_img = time_pipe(pipe, raw_dev, PIPE3_REPEATS, warmups=1)
        peak, held = pipe_peak(pipe, raw_dev)
    print(f"[pipe3] config 3 {H3}x{W3}: {len(stages)} stages, chains "
          f"{pipe.fused_groups()}, launches {launches}, vs plain max "
          f"{pipe_err:.3g} (tol 1/255), range [{out.min():.3g}, "
          f"{out.max():.3g}] | {1.0 / per_img:.3f} img/s, "
          f"{per_img * 1e3:.1f} ms/img (device-resident input, "
          f"{PIPE3_REPEATS} repeats), peak device memory {peak:.3f} GB "
          f"({held:.3f} GB held before) on {card}", flush=True)
    return launches


def xtrans_raw(h, w):
    """synth_raw's scene through the X-Trans pattern, as bench.py does."""
    _, meta, scene = synth_raw(h=h, w=w, kind="gradients")
    return configs.remosaic_xtrans(meta, scene)


def captured4(pipe, raw_dev):
    """Run config 4 once on a device-resident raw and keep the arguments of
    its Markesteijn, warp and chain calls."""
    calls = {"markesteijn": [], "warp": [], "chain": []}
    real = {"markesteijn": markesteijn.xtrans_markesteijn,
            "warp": warp.lens_warp, "chain": pw.pointwise_chain}

    def keep(key):
        def call(*args):
            calls[key].append(args)
            return real[key](*args)
        return call

    with swapped([(markesteijn, "xtrans_markesteijn", keep("markesteijn")),
                  (warp, "lens_warp", keep("warp")),
                  (pw, "pointwise_chain", keep("chain"))]):
        pipe.run_padded(raw_dev)
    counts = {k: len(v) for k, v in calls.items()}
    expect(counts == {"markesteijn": 1, "warp": 1, "chain": 1},
           f"unexpected kernel calls {counts}")
    return calls


def check_markesteijn(calls, record):
    """The config-4 mosaic (4000 x 6016) demosaiced in 1 pass, as the pipe
    does, and in 3 passes (what a sidecar with 0x1002 runs)."""
    x, pattern6, passes = calls[0]
    expect(passes == 1, f"config 4 ran {passes} passes")
    rows, err, ms = [], 0.0, {}
    for p in (1, 3):
        got = markesteijn.xtrans_markesteijn(x, pattern6, p)
        want = markesteijn.xtrans_markesteijn_reference(x, pattern6, p)
        mx, mean = compare(got, want)
        expect(mx <= MARK_TOL, f"markesteijn {p} passes: max {mx}")
        expect(torch.equal(got, want), f"markesteijn {p}: not bit-equal")
        del got, want
        err = max(err, mx)
        ms[p] = median_ms(lambda: markesteijn.xtrans_markesteijn(
            x, pattern6, p))
        plain_ms = median_ms(lambda: markesteijn.xtrans_markesteijn_reference(
            x, pattern6, p), 1)
        b_ms, b_by = bound(
            4 * nbytes(x), instructions=FLOPS_MARKESTEIJN[p] * x.numel(),
            sfu=mufu_markesteijn(pattern6, p) * x.numel())
        rows.append(f"{p} pass{'es' if p > 1 else ''}: max {mx:.3g} mean "
                    f"{mean:.3g}, kernel {ms[p]:.3f} ms, plain {plain_ms:.1f} "
                    f"ms, bound {b_ms:.3f} ms ({b_by})")
        if p == 1:
            record["markesteijn"] = dict(ms=ms[1], plain_ms=plain_ms,
                                         library_ms=None, bound_ms=b_ms,
                                         bound_by=b_by)
    record["markesteijn"]["max_abs_err"] = err
    print(f"[markesteijn] {tuple(x.shape)} X-Trans, kernel vs plain on the "
          f"config-4 mosaic (tol {MARK_TOL:g}; bit-equal): "
          f"{'; '.join(rows)}",
          flush=True)


def check_warp(calls, record):
    """Config 4's lens warp on the demosaiced (3, 4000, 6016) image, and
    grid_sample on the same per-channel coordinates as the yardstick."""
    x, k, model, flags, cy, cx, rn = calls[0]
    mx, mean = compare(warp.lens_warp(x, k, model, flags, cy, cx, rn),
                       warp.lens_warp_reference(x, k, model, flags, cy, cx,
                                                rn))
    expect(mx <= WARP_TOL, f"warp: max {mx}")
    ms = median_ms(lambda: warp.lens_warp(x, k, model, flags, cy, cx, rn))
    plain_ms = median_ms(lambda: warp.lens_warp_reference(
        x, k, model, flags, cy, cx, rn), PLAIN_REPEATS)
    _, h, w = x.shape
    grid = []
    for ch in range(3):
        sy, sx = warp.lens_coords(k, model, flags, h, w, cy, cx, rn, ch)
        grid.append(torch.stack([sx / (w - 1) * 2 - 1,
                                 sy / (h - 1) * 2 - 1], -1))
    grid = torch.stack(grid)
    planes = x[:, None]

    def library():
        return F.grid_sample(planes, grid, mode="bilinear",
                             padding_mode="border", align_corners=True)

    lx, _ = compare(library()[:, 0],
                    warp.lens_warp_reference(x, k, model, flags, cy, cx, rn))
    expect(lx <= 1e-3, f"grid_sample yardstick: {lx}")
    lib_ms = median_ms(library)
    b_ms, b_by = bound(2 * nbytes(x), FLOPS_WARP * x[0].numel())
    record["warp"] = dict(max_abs_err=mx, ms=ms, plain_ms=plain_ms,
                          library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
    print(f"[warp] {tuple(x.shape)} lens model {model} flags {flags}, kernel "
          f"vs plain: max {mx:.3g} mean {mean:.3g} (tol {WARP_TOL:g}); "
          f"grid_sample vs plain max {lx:.3g} | kernel {ms:.3f} ms, plain "
          f"{plain_ms:.1f} ms, grid_sample {lib_ms:.3f} ms, bound "
          f"{b_ms:.3f} ms ({b_by})", flush=True)


def run_config4(card, record, raw, meta, phases):
    """Config 4's pipe at 24 MP X-Trans against the composed twins, its two
    new kernels on the arguments the pipe hands them, then its timing."""
    pipe = port.compile_pipeline(meta, configs.history(4))
    stages = [s.name for s in pipe.pipe.stages]
    expect(stages == STAGES4, f"unexpected config-4 plan {stages}")
    expect(pipe.fused_groups() == [STAGES4[5:]],
           f"unexpected chains {pipe.fused_groups()}")
    statics = [pipe.pipe.stages[i].plan.static[:1] for i in (3, 4)]
    expect(statics == [(0x1001,), (2,)], f"demosaic/lens plan {statics}")
    raw_dev = torch.from_numpy(pad_to(raw, pipe.pipe.spec_in)).cuda()

    # -- config 4 through the user's entry point, launches counted
    with timed(phases, "pipe4 vs plain"):
        reset_launches()
        out = pipe.output_array(raw)
        launches = read_launches()
        _, maps = read_split()
        expect(launches == LAUNCHES4, f"config-4 launches {launches}")
        expect(maps == {"lens": 1}, f"config-4 warp maps {maps}")
        launches["maps"] = maps
        expect(out.shape == (3, H4, W4), f"output shape {out.shape}")
        expect(bool(np.isfinite(out).all()) and out.min() >= 0.0
               and out.max() <= 1.0, "output not finite or outside [0, 1]")
        reset_launches()
        with plain_twins():
            plain = pipe.output_array(raw)
        expect(all(v == 0 for v in read_launches().values()),
               f"the plain composition launched kernels: {read_launches()}")
        pipe_err = float(np.abs(out - plain).max())
        expect(pipe_err <= PIPE_TOL, f"config 4 vs plain: max {pipe_err}")
        del plain
    with timed(phases, "capture4"):
        calls = captured4(pipe, raw_dev)
    with timed(phases, "markesteijn"):
        check_markesteijn(calls["markesteijn"], record)
    with timed(phases, "warp"):
        check_warp(calls["warp"], record)
    with timed(phases, "chain4"):
        check_chains(4, calls["chain"], pipe.fused_groups())
    del calls
    with timed(phases, "pipe4 timing"):
        per_img = time_pipe(pipe, raw_dev, PIPE4_REPEATS)
        peak, held = pipe_peak(pipe, raw_dev)
    lens_static = pipe.pipe.stages[4].plan.static
    print(f"[pipe4] config 4 {H4}x{W4} X-Trans: {len(stages)} stages, "
          f"demosaic 0x{pipe.pipe.stages[3].plan.static[0]:x} (1 pass), lens "
          f"{lens_static}, chains {pipe.fused_groups()}, launches {launches}, "
          f"vs plain max {pipe_err:.3g} (tol 1/255), range [{out.min():.3g}, "
          f"{out.max():.3g}] | {1.0 / per_img:.2f} img/s, "
          f"{per_img * 1e3:.2f} ms/img (device-resident input, "
          f"{PIPE4_REPEATS} repeats), peak device memory {peak:.3f} GB "
          f"({held:.3f} GB held before) on {card}", flush=True)
    return launches


def captured7(pipe, raw_dev):
    """Run config 7 once on a device-resident raw and keep the arguments of
    its five grid slices and its three chains."""
    calls = {"bgrid": [], "chain": []}
    real = {"bgrid": bgrid.slice_grid, "chain": pw.pointwise_chain}

    def keep(key):
        def call(*args):
            calls[key].append(args)
            return real[key](*args)
        return call

    with swapped([(bgrid, "slice_grid", keep("bgrid")),
                  (pw, "pointwise_chain", keep("chain"))]):
        pipe.run_padded(raw_dev)
    shapes = [(tuple(g.shape[:2]), ss) for g, _, ss in calls["bgrid"]]
    expect(shapes == [((32, 1), 15)] * 3 + [((4, 3), 100), ((6, 1), 50)],
           f"unexpected grid slices {shapes}")
    expect(len(calls["chain"]) == LAUNCHES7["chain"],
           f"{len(calls['chain'])} chains")
    return calls


def bgrid_work(g, z):
    """One slice's (bytes, operations): z read and the C output planes
    written once, the grid and the column taps read once; the operations
    that this z needs (the second bin is skipped where z is D - 1)."""
    D, C, _, _ = g.shape
    n = z.numel()
    second = int((torch.floor(z) + 1.0 <= D - 1).sum().item())
    flops = FLOPS_BGRID_PIXEL * n + C * (
        (FLOPS_BGRID_BIN0 + FLOPS_BGRID_SUM) * n + FLOPS_BGRID_BIN1 * second)
    return nbytes(g, z) + 4 * C * n + 16 * z.shape[1], flops


def grid_sample_slice(g, z, ss):
    """The same trilinear slice as one F.grid_sample over the grid as a
    (1, C, D, gh, gw) volume: cell-centred x and y, z mapped onto the bins,
    border padding; returns the call (its coordinates precomputed)."""
    D, C, gh, gw = g.shape
    Hp, Wp = z.shape
    dev = z.device
    xs = (torch.arange(Wp, device=dev, dtype=torch.float32) + 0.5) * 2.0 / Wp
    ys = (torch.arange(Hp, device=dev, dtype=torch.float32) + 0.5) * 2.0 / Hp
    coords = torch.stack([(xs - 1.0)[None, :].expand(Hp, Wp),
                          (ys - 1.0)[:, None].expand(Hp, Wp),
                          (2.0 * z + 1.0) / D - 1.0], -1)[None, None]
    vol = g.permute(1, 0, 2, 3)[None].contiguous()

    def call():
        return F.grid_sample(vol, coords, mode="bilinear",
                             padding_mode="border", align_corners=False)
    return call


def check_bgrid(calls, record):
    """The five config-7 slices (bilateral's three at ss 15 and 32 bins on
    4005 x 6030, shadhi's three-channel grid at ss 100 on 4000 x 6100,
    bilat's at ss 50 on 4000 x 6050), then two synthetic classes: ss 1 at
    32 bins (bilat mode 0 at its default sigma_s 0.5) over 2000 x 2000,
    and ss 10 with three channels and 4 bins (lowpass's bilateral
    algorithm at its default radius) over 4000 x 6020."""
    err, mean_err, lib_err, bounds, synth = 0.0, 0.0, 0.0, [], []
    ms, plain_ms, lib_ms, work = [], [], [], []
    for g, z, ss in calls:
        want = bgrid.slice_grid_reference(g, z, ss)
        mx, mean = compare(bgrid.slice_grid(g, z, ss), want)
        expect(mx <= BGRID_TOL, f"bgrid {tuple(g.shape)} ss {ss}: max {mx}")
        err, mean_err = max(err, mx), max(mean_err, mean)
        library = grid_sample_slice(g, z, ss)
        lx, _ = compare(library()[0, :, 0], want)
        scale = max(1.0, want.abs().max().item())
        expect(lx <= 1e-3 * scale, f"grid_sample yardstick: {lx}")
        lib_err = max(lib_err, lx / scale)
        del want
        ms.append(median_ms(lambda: bgrid.slice_grid(g, z, ss)))
        plain_ms.append(median_ms(
            lambda: bgrid.slice_grid_reference(g, z, ss), PLAIN_REPEATS))
        lib_ms.append(median_ms(library))
        del library
        work.append(bgrid_work(g, z))
        b_ms, b_by = bound(*work[-1])
        bounds.append(b_ms)
        print(f"[bgrid] slice {len(ms)} of config 7, {tuple(g.shape)} ss "
              f"{ss} on {tuple(z.shape)}: max {mx:.3g} mean {mean:.3g} | ms "
              f"kernel {ms[-1]:.4f}, plain {plain_ms[-1]:.2f}, grid_sample "
              f"{lib_ms[-1]:.3f}, bound {b_ms:.4f} ({b_by})", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(7)
    for D, C, gh, gw, ss in ((32, 1, 2000, 2000, 1), (4, 3, 400, 602, 10)):
        g = torch.rand((D, C, gh, gw), generator=gen, device="cuda")
        z = torch.rand((gh * ss, gw * ss), generator=gen,
                       device="cuda") * (D - 1)
        z[:8] = torch.floor(z[:8])                  # integers: one bin each
        z[8] = D - 1                                # the last bin exactly
        mx, mean = compare(bgrid.slice_grid(g, z, ss),
                           bgrid.slice_grid_reference(g, z, ss))
        expect(mx <= BGRID_TOL, f"bgrid synthetic ss {ss}: max {mx}")
        err, mean_err = max(err, mx), max(mean_err, mean)
        k_ms = median_ms(lambda: bgrid.slice_grid(g, z, ss))
        b_ms, b_by = bound(*bgrid_work(g, z))
        synth.append(f"{(D, C)} ss {ss} on {tuple(z.shape)}: max {mx:.3g}, "
                     f"kernel {k_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        del g, z
    # per launch, averaged over the five slices of one image
    b_ms, b_by = bound(sum(b for b, _ in work) / len(work),
                       sum(f for _, f in work) / len(work))
    record["bgrid"] = dict(max_abs_err=err, ms=float(np.mean(ms)),
                           plain_ms=float(np.mean(plain_ms)),
                           library_ms=float(np.mean(lib_ms)),
                           bound_ms=b_ms, bound_by=b_by)
    print(f"[bgrid] kernel vs plain on config 7's five slices and two "
          f"synthetic classes: max {err:.3g} mean {mean_err:.3g} (tol "
          f"{BGRID_TOL:g}); grid_sample "
          f"vs plain max {lib_err:.3g} of the largest value | ms per image "
          f"kernel {sum(ms):.4f}, bound {sum(bounds):.4f} "
          f"| {'; '.join(synth)}", flush=True)


def run_config7(card, record, raw, raw_dev, meta, phases):
    """Config 7's pipe at 24 MP against the composed twins, the grid slice
    on the arguments the pipe hands it, then the pipe's timing."""
    pipe = port.compile_pipeline(meta, configs.history(7))
    stages = [s.name for s in pipe.pipe.stages]
    expect(stages == STAGES7, f"unexpected config-7 plan {stages}")
    expect(pipe.fused_groups() == [["exposure", "colorin", "_convert"],
                                   ["_convert", "filmicrgb", "_convert"],
                                   ["_convert", "colorout"]],
           f"unexpected chains {pipe.fused_groups()}")
    expect(raw.shape == pipe.pipe.spec_in.array_shape, "raw needs padding")

    # -- config 7 through the user's entry point, launches counted
    with timed(phases, "pipe7 vs plain"):
        reset_launches()
        out = pipe.output_array(raw)
        launches = read_launches()
        expect(launches == LAUNCHES7, f"config-7 launches {launches}")
        expect(out.shape == (3, H, W), f"output shape {out.shape}")
        expect(bool(np.isfinite(out).all()) and out.min() >= 0.0
               and out.max() <= 1.0, "output not finite or outside [0, 1]")
        reset_launches()
        with plain_twins():
            plain = pipe.output_array(raw)
        expect(all(v == 0 for v in read_launches().values()),
               f"the plain composition launched kernels: {read_launches()}")
        pipe_err = float(np.abs(out - plain).max())
        expect(pipe_err <= PIPE_TOL, f"config 7 vs plain: max {pipe_err}")
        # the chain kernel kept: its Lab conversions round an ulp away
        # from its twin's ([chain] config 7), the rest of the path should
        # not
        reset_launches()
        with plain_twins(keep=(pw,)):
            plain = pipe.output_array(raw)
        expect(read_launches() == dict(NO_LAUNCHES, chain=3),
               f"the plain composition launched {read_launches()}")
        rest_err = float(np.abs(out - plain).max())
        expect(rest_err <= PIPE7_REST_TOL,
               f"config 7 vs plain, chain kernel kept: max {rest_err}")
        del plain
    with timed(phases, "capture7"):
        calls = captured7(pipe, raw_dev)
    with timed(phases, "bgrid"):
        check_bgrid(calls["bgrid"], record)
    with timed(phases, "chain7"):
        check_chains(7, calls["chain"], pipe.fused_groups())
    del calls
    with timed(phases, "pipe7 timing"):
        per_img = time_pipe(pipe, raw_dev, PIPE7_REPEATS)
        peak, held = pipe_peak(pipe, raw_dev)
    print(f"[pipe7] config 7 {H}x{W}: {len(stages)} stages, chains "
          f"{pipe.fused_groups()}, launches {launches}, vs plain max "
          f"{pipe_err:.3g} (tol 1/255; with the chain kernel kept, max "
          f"{rest_err:.3g}, tol {PIPE7_REST_TOL:g}), range [{out.min():.3g}, {out.max():.3g}] | "
          f"{1.0 / per_img:.2f} img/s, {per_img * 1e3:.2f} ms/img "
          f"(device-resident input, {PIPE7_REPEATS} repeats), peak device "
          f"memory {peak:.3f} GB ({held:.3f} GB held before) on {card}",
          flush=True)
    return launches


def write_sidecar8(path):
    """Config 8's history as an XMP sidecar, an inactive blend blob on
    every item as darktable writes them."""
    write_xmp(path, XMPDocument(history=[
        port.HistoryItem(op, dict(p), blend_params=BlendParams())
        for op, p in configs.HISTORIES[8]]))


def night_mosaic8(raw_dev, meta):
    """Config 8's frame: config 2's noisy mosaic with HOT8 photosites,
    drawn uniformly over the frame, stuck at the white point."""
    x = noisy_like(raw_dev, NOISE_SIGMA)
    gen = torch.Generator(device=x.device).manual_seed(88)
    ys = torch.randint(0, x.shape[0], (HOT8,), generator=gen, device=x.device)
    xs = torch.randint(0, x.shape[1], (HOT8,), generator=gen, device=x.device)
    x[ys, xs] = meta.white_point
    return x


def hot_replaced(pipe, raw_dev):
    """Photosites the hotpixels stage of `pipe` changes on `raw_dev`."""
    k = [s.name for s in pipe.pipe.stages].index("hotpixels")
    n = next(n for n, step in enumerate(pipe.steps) if step[1] == k)
    before = pipe.pipe.run_steps(raw_dev, pipe.steps[:n])
    after = pipe.pipe.run_steps(raw_dev, pipe.steps[:n + 1])
    return int((before != after).sum())


def captured8(pipe, raw_dev):
    """Run config 8 once on a device-resident raw and keep the arguments
    of its sepblur, IIR and NLM calls."""
    calls = {"sepblur": [], "iir": [], "nlm": []}
    real = {"sepblur": sepblur.sep_blur, "iir": iir.gaussian_iir,
            "nlm": nlm.nlm}

    def keep(key):
        def call(*args):
            calls[key].append(args)
            return real[key](*args)
        return call

    with swapped([(sepblur, "sep_blur", keep("sepblur")),
                  (iir, "gaussian_iir", keep("iir")),
                  (nlm, "nlm", keep("nlm"))]):
        pipe.run_padded(raw_dev)
    counts = {k: len(v) for k, v in calls.items()}
    expect(counts == {k: LAUNCHES8[k] for k in calls},
           f"unexpected kernel calls {counts}")
    return calls


def check_rawdenoise(calls, launches):
    """rawdenoise's hat wavelet on the four (2000, 3008) CFA planes at
    d = 1-16, and defringe's sigma-4 blur (33 taps) of the (2, 4000, 6016)
    chroma planes, each against the twin bit for bit."""
    rows, total, bounds = [], 0.0, 0.0
    for x, taps, *d in calls:
        got = sepblur.sep_blur(x, taps, *d)
        want = sepblur.sep_blur_reference(x, taps, *d)
        mx, _ = compare(got, want)
        expect(torch.equal(got, want),
               f"sepblur {tuple(x.shape)} {len(taps)} taps d={d}: max {mx}")
        del got, want
        ms = median_ms(lambda: sepblur.sep_blur(x, taps, *d))
        plain_ms = median_ms(lambda: sepblur.sep_blur_reference(x, taps, *d),
                             PLAIN_REPEATS)
        b_ms, b_by = bound(2 * nbytes(x),
                           FLOPS_SEPBLUR_PER_TAP * len(taps) * x.numel())
        total, bounds = total + ms, bounds + b_ms
        rows.append(f"{tuple(x.shape)} {len(taps)} taps d={d[0] if d else 1}"
                    f" {ms:.4f}/{plain_ms:.3f}/bound {b_ms:.4f} ({b_by})")
    print(f"[rawdenoise] sepblur on config 8's arguments ({launches} "
          f"launches an image), kernel vs plain: max 0 (bit-equal) | ms "
          f"kernel/plain: {'; '.join(rows)} | {total:.4f} ms per image "
          f"(bound {bounds:.4f})", flush=True)


def check_cacorrectrgb_iir(calls, launches):
    """cacorrectrgb's seven Gaussians of sigma 5: the (4000, 6016) guide
    and safety planes and the (4, 4000, 6016) manifold stacks, each
    against the twin bit for bit (IIR_TOL 0), with its launch plan."""
    rows, total, bounds, plain = [], 0.0, 0.0, {}
    for x, coef, lo, hi in calls:
        got = iir.gaussian_iir(x, coef, lo, hi)
        want = iir.gaussian_iir_reference(x, coef, lo, hi)
        mx, _ = compare(got, want)
        expect(mx <= IIR_TOL and torch.equal(got, want),
               f"iir {tuple(x.shape)}: max {mx}")
        del got, want
        ms = median_ms(lambda: iir.gaussian_iir(x, coef, lo, hi))
        shape = tuple(x.shape)
        if shape not in plain:
            plain[shape] = median_ms(
                lambda: iir.gaussian_iir_reference(x, coef, lo, hi), 1)
        b_ms, b_by = bound(2 * nbytes(x), FLOPS_IIR * x.numel())
        total, bounds = total + ms, bounds + b_ms
        h, w = x.shape[-2:]
        n = x.numel() // (h * w)
        blocks = [b for _, _, _, b, _, _ in iir.launch_plan(n, h, w)]
        rows.append(f"{shape} {ms:.4f} ms (plain {plain[shape]:.1f}, bound "
                    f"{b_ms:.4f} {b_by}, floor "
                    f"{iir.latency_floor_ms(h, w):.4f}; blocks {blocks}, "
                    f"{'16' if w % 4 == 0 else '4'}-byte copies)")
    print(f"[cacorrectrgb-iir] the IIR on config 8's arguments ({launches} "
          f"launches an image), kernel vs plain: max 0 (tol {IIR_TOL:g}; "
          f"bit-equal) | {'; '.join(rows)} | {total:.4f} ms per image "
          f"(bound {bounds:.4f})", flush=True)


def check_nlmeans(calls, launches):
    """The nlmeans op's NLM pass (variant 0, P 2, 225 offsets) on its Lab
    (3, 4000, 6016) input, against the twin bit for bit."""
    (v, offs, P, norm, sharp, cp_norm, inv1cw, variant), = calls
    expect(variant == 0 and P == 2 and len(offs) == 225,
           f"nlmeans call: variant {variant}, P {P}, {len(offs)} offsets")
    got = nlm.nlm(v, offs, P, norm, sharp, cp_norm, inv1cw, variant)
    want = nlm.nlm_reference(v, offs, P, norm, sharp, cp_norm, inv1cw,
                             variant)
    mx, mean = compare(got, want)
    expect(torch.equal(got, want), f"nlm variant 0: max {mx}")
    del got, want
    args = (v, offs, P, norm, sharp, cp_norm, inv1cw, variant)
    ms = median_ms(lambda: nlm.nlm(*args))
    plain_ms = median_ms(lambda: nlm.nlm_reference(*args), 1)
    b_ms, b_by = bound(2 * nbytes(v),
                       FLOPS_NLM_V0_P2 * len(offs) * v[0].numel())
    resident, smem = nlm.plan(P, nlm._reach(offs))
    print(f"[nlmeans] {tuple(v.shape)} variant 0, P {P}, {len(offs)} "
          f"offsets ({'resident' if resident else 'streamed'}, {smem} B "
          f"shared; {launches} launch an image), kernel vs plain: max "
          f"{mx:.3g} mean {mean:.3g} "
          f"(bit-equal) | kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, bound "
          f"{b_ms:.3f} ms ({b_by})", flush=True)


def run_config8(card, raw_dev, meta, phases, tmp):
    """Config 8 exported from a sidecar through the CLI on the card (the
    main path, launches counted) from a raw bundle of the noisy mosaic
    with hot photosites, its PNG against export_image's array, that array
    against the composed twins, its kernels on the arguments the pipe
    hands them, then `run_padded`'s rate and peak memory."""
    sidecar = os.path.join(tmp, "config8.xmp")
    png = os.path.join(tmp, "config8.png")
    bundle = os.path.join(tmp, "config8.npz")
    write_sidecar8(sidecar)
    with timed(phases, "mosaic8"):
        raw_dev = night_mosaic8(raw_dev, meta)
        raw = raw_dev.cpu().numpy()
        save_raw(bundle, raw, meta)
    with timed(phases, "pipe8 cli"):
        reset_launches()
        t = time.perf_counter()
        rc = cli.main([bundle, sidecar, png, "--bpp", "16", "--no-icc",
                       "-v"])
        cli_s = time.perf_counter() - t
        launches = read_launches()
    expect(rc == 0, f"cli exit {rc}")
    expect(launches == LAUNCHES8, f"config-8 launches {launches}")
    with timed(phases, "pipe8 vs plain"):
        out = export_image(raw, meta, xmp_path=sidecar)
        expect(out.shape == (3, H, W), f"output shape {out.shape}")
        expect(bool(np.isfinite(out).all()) and out.min() >= 0.0
               and out.max() <= 1.0, "output not finite or outside [0, 1]")
        expect(np.array_equal(read_png16(png), to_uint16(out)),
               "the CLI's PNG differs from export_image's array")
        reset_launches()
        with plain_twins():
            plain = export_image(raw, meta, xmp_path=sidecar)
        expect(all(v == 0 for v in read_launches().values()),
               f"the plain composition launched kernels: {read_launches()}")
        pipe_err = float(np.abs(out - plain).max())
        expect(pipe_err <= PIPE_TOL, f"config 8 vs plain: max {pipe_err}")
        reset_launches()
        with plain_twins(keep=(pw,)):
            plain = export_image(raw, meta, xmp_path=sidecar)
        expect(read_launches() == dict(NO_LAUNCHES, chain=3),
               f"the plain composition launched {read_launches()}")
        rest_err = float(np.abs(out - plain).max())
        expect(rest_err <= PIPE8_REST_TOL,
               f"config 8 vs plain, chain kernel kept: max {rest_err}")
        del plain
    pipe = port.compile_pipeline(meta, parse_xmp(sidecar).history)
    stages = [s.name for s in pipe.pipe.stages]
    expect(stages == STAGES8, f"unexpected config-8 plan {stages}")
    expect(pipe.fused_groups() == [["exposure", "colorin", "_convert"],
                                   ["_convert", "filmicrgb", "_convert"],
                                   ["_convert", "colorout"]],
           f"unexpected chains {pipe.fused_groups()}")
    hot = hot_replaced(pipe, raw_dev)
    expect(hot > 0, "the hotpixels stage replaced no photosite")
    with timed(phases, "capture8"):
        calls = captured8(pipe, raw_dev)
    with timed(phases, "rawdenoise"):
        check_rawdenoise(calls["sepblur"], launches["sepblur"])
    with timed(phases, "cacorrectrgb-iir"):
        check_cacorrectrgb_iir(calls["iir"], launches["iir"])
    with timed(phases, "nlmeans"):
        check_nlmeans(calls["nlm"], launches["nlm"])
    del calls
    with timed(phases, "pipe8 timing"):
        per_img = time_pipe(pipe, raw_dev, PIPE8_REPEATS)
        peak, held = pipe_peak(pipe, raw_dev)
    print(f"[pipe8] config 8 {H}x{W} from an XMP sidecar through the CLI, "
          f"the mosaic noisy (sigma {NOISE_SIGMA:g}) with {HOT8} hot "
          f"photosites ({hot} photosites replaced by hotpixels): "
          f"{len(stages)} stages, chains {pipe.fused_groups()}, launches "
          f"{launches}, PNG equal to to_uint16(export_image), vs plain max "
          f"{pipe_err:.3g} (tol 1/255; with the chain kernel kept, max "
          f"{rest_err:.3g}, tol {PIPE8_REST_TOL:g}), range [{out.min():.3g}, "
          f"{out.max():.3g}] | CLI export {cli_s:.2f} s wall (raw bundle "
          f"load, upload, pipe, download, 16-bit PNG) | {1.0 / per_img:.3f} img/s, "
          f"{per_img * 1e3:.2f} ms/img (device-resident input, "
          f"{PIPE8_REPEATS} repeats), peak device memory {peak:.3f} GB "
          f"({held:.3f} GB held before) on {card}", flush=True)


def opcode_list2_blob(h, w, mv, mh, gains4):
    """A DNG OpcodeList2 payload of four GainMaps, one per RGGB filter,
    each mv x mh points over the whole (h, w) frame (big-endian, DNG 1.3
    opcode 9): the same bytes as tests/test_dng.py's helper."""
    blob = struct.pack(">I", 4)
    for (dy, dx), gains in zip([(0, 0), (0, 1), (1, 0), (1, 1)], gains4):
        p = struct.pack(">10I", dy, dx, h, w, 0, 1, 2, 2, mv, mh)
        p += struct.pack(">4d", 1.0 / (mv - 1), 1.0 / (mh - 1), 0.0, 0.0)
        p += struct.pack(">I", 1) + np.asarray(gains, ">f4").tobytes()
        blob += struct.pack(">IIII", 9, 0x01030000, 1, len(p)) + p
    return blob


def write_dng(path, mosaic, black, white, opcodes):
    """An uncompressed 16-bit RGGB DNG of one strip: the tags of
    tests/test_dng.py's writer (BlackLevel, WhiteLevel, ColorMatrix1,
    AsShotNeutral) and an OpcodeList2."""
    h, w = mosaic.shape

    def rational(vals, signed=False):
        return b"".join(struct.pack("<ii" if signed else "<II",
                                    int(round(v * 10000)), 10000)
                        for v in vals)

    tags = [(0x0100, 4, 1, struct.pack("<I", w)),
            (0x0101, 4, 1, struct.pack("<I", h)),
            (0x0102, 3, 1, struct.pack("<H", 16)),
            (0x0103, 3, 1, struct.pack("<H", 1)),
            (0x0106, 3, 1, struct.pack("<H", 32803)),
            (0x0115, 3, 1, struct.pack("<H", 1)),
            (0x0116, 4, 1, struct.pack("<I", h)),
            (0x828E, 1, 4, bytes([0, 1, 1, 2])),
            (0xC61A, 5, 1, rational([black])),
            (0xC61D, 4, 1, struct.pack("<I", int(white))),
            (0xC622, 10, 9, rational([0.7, 0.2, 0.1, 0.25, 0.9, -0.15,
                                      0.05, -0.2, 1.1], signed=True)),
            (0xC628, 5, 3, rational([0.45, 1.0, 0.62])),
            (51009, 7, len(opcodes), opcodes)]
    n = len(tags) + 2
    heap_base = 8 + 2 + 12 * n + 4
    entries, heap = [], b""
    for tag, typ, count, data in tags:
        if len(data) <= 4:
            entries.append((tag, struct.pack("<HHI", tag, typ, count)
                            + data.ljust(4, b"\0")))
        else:
            entries.append((tag, struct.pack("<HHII", tag, typ, count,
                                             heap_base + len(heap))))
            heap += data
    payload = mosaic.astype("<u2").tobytes()
    entries.append((0x0111, struct.pack("<HHII", 0x0111, 4, 1,
                                        heap_base + len(heap))))
    entries.append((0x0117, struct.pack("<HHII", 0x0117, 4, 1,
                                        len(payload))))
    entries.sort(key=lambda e: e[0])
    with open(path, "wb") as f:
        f.write(b"II" + struct.pack("<HI", 42, 8))
        f.write(struct.pack("<H", n) + b"".join(e for _, e in entries)
                + struct.pack("<I", 0))
        f.write(heap)
        f.write(payload)


def write_sidecar9(path):
    write_xmp(path, XMPDocument(history=[
        port.HistoryItem(op, dict(p), blend_params=BlendParams())
        for op, p in configs.HISTORIES[9]]))


def captured9(pipe, raw_dev):
    """Run config 9 once on a device-resident raw and keep the arguments
    of its RCD, chain and warp calls."""
    calls = {"rcd": [], "chain": [], "warp": []}
    real = {"rcd": rcd.rcd_demosaic, "chain": pw.pointwise_chain,
            "warp": warp.clip_warp}

    def keep(key):
        def call(*args):
            calls[key].append(args)
            return real[key](*args)
        return call

    with swapped([(rcd, "rcd_demosaic", keep("rcd")),
                  (pw, "pointwise_chain", keep("chain")),
                  (warp, "clip_warp", keep("warp"))]):
        pipe.run_padded(raw_dev)
    counts = {k: len(v) for k, v in calls.items()}
    expect(counts == {k: LAUNCHES9[k] for k in calls},
           f"unexpected kernel calls {counts}")
    return calls


def check_warp_clip(calls, record):
    """clipping's map on the (3, 6016, 4000) flipped RGB config 9's pipe
    hands the warp (a window of it, as the ROI walk cuts it), against the
    twin bit for bit, and grid_sample on the same source coordinates as
    the yardstick."""
    (x, k, k_apply, oh, ow), = calls
    got = warp.clip_warp(x, k, k_apply, oh, ow)
    want = warp.clip_warp_reference(x, k, k_apply, oh, ow)
    mx, mean = compare(got, want)
    expect(torch.equal(got, want), f"warp-clip: max {mx}")
    del got, want
    ms = median_ms(lambda: warp.clip_warp(x, k, k_apply, oh, ow))
    plain_ms = median_ms(lambda: warp.clip_warp_reference(
        x, k, k_apply, oh, ow), PLAIN_REPEATS)
    _, h, w = x.shape
    sy, sx, inside = warp.clip_coords(k, k_apply, oh, ow, x.device)
    grid = torch.stack([sx / (w - 1) * 2 - 1, sy / (h - 1) * 2 - 1],
                       -1)[None]
    planes = x[None]
    mask = inside[None, None]

    def library():
        return F.grid_sample(planes, grid, mode="bilinear",
                             padding_mode="border", align_corners=True)

    lx, _ = compare(torch.where(mask, library(), 0.0)[0],
                    warp.clip_warp_reference(x, k, k_apply, oh, ow))
    expect(lx <= 1e-3, f"grid_sample yardstick: {lx}")
    lib_ms = median_ms(library)
    px = oh * ow
    b_ms, b_by = bound(nbytes(x) + 3 * 4 * px,
                       (FLOPS_CLIP_MAP + 3 * FLOPS_CLIP_CHANNEL) * px)
    record["warp-clip"] = dict(max_abs_err=mx, ms=ms, plain_ms=plain_ms,
                               library_ms=lib_ms, bound_ms=b_ms,
                               bound_by=b_by)
    print(f"[warp-clip] {tuple(x.shape)} -> (3, {oh}, {ow}) clipping's map "
          f"(keystone {bool(k_apply)}), kernel vs plain: max {mx:.3g} mean "
          f"{mean:.3g} (bit-equal); grid_sample vs plain max {lx:.3g} | "
          f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, grid_sample "
          f"{lib_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})", flush=True)


def read_pdf_image(path):
    """(width, height, bits) of a PDF's image and its decompressed bytes'
    length, from the writer's one FlateDecode image stream."""
    with open(path, "rb") as f:
        pdf = f.read()
    expect(pdf.startswith(b"%PDF-") and pdf.rstrip().endswith(b"%%EOF"),
           f"{path}: not a PDF")
    head = pdf.index(b"/Subtype /Image")
    dims = [int(pdf[head:].split(key)[1].split()[0])
            for key in (b"/Width ", b"/Height ", b"/BitsPerComponent ")]
    start = pdf.index(b"stream\n", head) + len(b"stream\n")
    return dims, len(zlib.decompressobj().decompress(pdf[start:]))


def run_config9(card, record, raw, meta, phases, tmp):
    """Config 9: the 24 MP mosaic written as a 14-bit DNG with its GainMap,
    exported from its sidecar through the CLI on the card (run A: launches
    counted, its PNG against export_image's array, that array against the
    composed twins), its kernels on the arguments the pipe hands them,
    `run_padded`'s rate and peak memory, then run B (a 2048 px bounding
    box, initialscale) to a JPEG and a PDF, each read back."""
    dng = os.path.join(tmp, "config9.dng")
    sidecar = os.path.join(tmp, "config9.xmp")
    png = os.path.join(tmp, "config9.png")
    with timed(phases, "dng9"):
        mv, mh = configs.DNG9_MAP_POINTS
        write_dng(dng, configs.mosaic9(raw), meta.black_levels[0],
                  meta.white_point, opcode_list2_blob(
                      H, W, mv, mh, configs.gain_maps9()))
        write_sidecar9(sidecar)
    with timed(phases, "pipe9 cli"):
        reset_launches()
        t = time.perf_counter()
        rc = cli.main([dng, sidecar, png, "--bpp", "16", "--no-icc", "-v"])
        cli_s = time.perf_counter() - t
        launches = read_launches()
        _, maps = read_split()
    expect(rc == 0, f"cli exit {rc}")
    # config 9 has no lens stage: its warp launches are clipping's map
    expect(launches == LAUNCHES9, f"config-9 launches {launches}")
    expect(maps == {"clip": 1}, f"config-9 warp maps {maps}")
    launches["maps"] = maps
    raw9, meta9 = load_raw(dng)
    expect(len(meta9.gain_maps) == 4, "the DNG's GainMaps were not read")
    with timed(phases, "pipe9 vs plain"):
        out = export_image(raw9, meta9, xmp_path=sidecar)
        expect(bool(np.isfinite(out).all()) and out.min() >= 0.0
               and out.max() <= 1.0, "output not finite or outside [0, 1]")
        expect(np.array_equal(read_png16(png), to_uint16(out)),
               "the CLI's PNG differs from export_image's array")
        reset_launches()
        with plain_twins():
            plain = export_image(raw9, meta9, xmp_path=sidecar)
        expect(all(v == 0 for v in read_launches().values()),
               f"the plain composition launched kernels: {read_launches()}")
        pipe_err = float(np.abs(out - plain).max())
        expect(pipe_err <= PIPE_TOL, f"config 9 vs plain: max {pipe_err}")
        del plain
    pipe = port.compile_pipeline(meta9, parse_xmp(sidecar).history)
    stages = [s.name for s in pipe.pipe.stages]
    expect(stages == STAGES9, f"unexpected config-9 plan {stages}")
    expect(pipe.pipe.stages[0].plan.static[2] == configs.DNG9_MAP_POINTS,
           "rawprepare planned no GainMap")
    raw_dev = torch.from_numpy(pad_to(raw9, pipe.pipe.spec_in)).cuda()
    with timed(phases, "capture9"):
        calls = captured9(pipe, raw_dev)
    with timed(phases, "warp-clip"):
        check_warp_clip(calls["warp"], record)
        x, cfa, scaler = calls["rcd"][0]
        expect(torch.equal(rcd.rcd_demosaic(x, cfa, scaler),
                           rcd.rcd_demosaic_reference(x, cfa, scaler)),
               "rcd on config 9's mosaic differs from its twin")
        check_chains(9, calls["chain"], pipe.fused_groups())
    del calls
    with timed(phases, "pipe9 timing"):
        per_img = time_pipe(pipe, raw_dev, PIPE9_REPEATS)
        peak, held = pipe_peak(pipe, raw_dev)
    del raw_dev
    with timed(phases, "pipe9 run B"):
        box = ["--width", str(BOX9), "--height", str(BOX9)]
        jpg, pdf = (os.path.join(tmp, f"config9b.{e}") for e in ("jpg", "pdf"))
        t = time.perf_counter()
        expect(cli.main([dng, sidecar, jpg, *box]) == 0, "run B jpg")
        jpg_s = time.perf_counter() - t
        expect(cli.main([dng, sidecar, pdf, "--no-icc", *box]) == 0,
               "run B pdf")
        from PIL import Image

        with Image.open(jpg) as im:
            im.load()
            jpg_size, jpg_mode = im.size, im.mode
        (pw_, ph_, bits), n = read_pdf_image(pdf)
        expect(jpg_mode == "RGB" and (pw_, ph_) == jpg_size and bits == 8
               and n == 3 * pw_ * ph_,
               f"run B: JPEG {jpg_size} {jpg_mode}, PDF {pw_}x{ph_} "
               f"{bits}-bit with {n} B")
        scaled = port.Pipeline(meta9, parse_xmp(sidecar).history,
                               scale=BOX9 / max(W, H))
        names_b = [s.name for s in scaled.stages]
        expect("initialscale" in names_b, "run B planned no initialscale")
    print(f"[pipe9] config 9 {H}x{W} DNG (14-bit, GainMap {mv}x{mh} a "
          f"filter) from an XMP sidecar through the CLI: {len(stages)} "
          f"stages, chains {pipe.fused_groups()}, launches {launches} "
          f"(the warp on clipping's map), output {out.shape[2]}x"
          f"{out.shape[1]}, PNG equal to to_uint16(export_image), vs plain "
          f"max {pipe_err:.3g} (tol 1/255), range [{out.min():.3g}, "
          f"{out.max():.3g}] | CLI export {cli_s:.2f} s wall (DNG decode, "
          f"upload, pipe, download, 16-bit PNG) | {1.0 / per_img:.3f} img/s, "
          f"{per_img * 1e3:.2f} ms/img (device-resident input, "
          f"{PIPE9_REPEATS} repeats), peak device memory {peak:.3f} GB "
          f"({held:.3f} GB held before) | run B (box {BOX9}, initialscale "
          f"planned): JPEG {jpg_size[0]}x{jpg_size[1]} in {jpg_s:.2f} s "
          f"wall, PDF {pw_}x{ph_} read back on {card}", flush=True)
    return launches


def captured10(pipe, raw_dev):
    """Run config 10 once on a device-resident raw and keep the arguments
    of its two chains and its atrous EAW scales."""
    calls = {"chain": [], "eaw": []}
    real = {"chain": pw.pointwise_chain, "eaw": eaw.eaw_atrous_coarse}

    def keep(key):
        def call(*args):
            calls[key].append(args)
            return real[key](*args)
        return call

    with swapped([(pw, "pointwise_chain", keep("chain")),
                  (eaw, "eaw_atrous_coarse", keep("eaw"))]):
        pipe.run_padded(raw_dev)
    expect(len(calls["chain"]) == LAUNCHES10["chain"]
           and [a[1] for a in calls["eaw"]] == list(range(LAUNCHES10["eaw"])),
           f"unexpected config-10 calls {len(calls['chain'])} chains, "
           f"scales {[a[1] for a in calls['eaw']]}")
    return calls


def check_atrous10(calls, record):
    """The EAW kernel's atrous variant on config 10's seven scales (Lab,
    the equaliser's sharpen): kernel vs twin at STENCIL_TOL, kernel and
    plain ms per scale, the bound per scale."""
    err, ms, plain_ms = 0.0, [], []
    for x, scale, sharpen in calls:
        got = eaw.eaw_atrous_coarse(x, scale, sharpen)
        want = eaw.eaw_coarse_reference(x, scale, sharpen, eaw.ATROUS)
        for g, w_ in zip(got, want):
            mx, _ = compare(g, w_)
            expect(mx <= STENCIL_TOL, f"eaw atrous s={scale}: max {mx}")
            err = max(err, mx)
        del got, want
        ms.append(median_ms(lambda: eaw.eaw_atrous_coarse(x, scale,
                                                          sharpen)))
        plain_ms.append(median_ms(
            lambda: eaw.eaw_coarse_reference(x, scale, sharpen, eaw.ATROUS),
            PLAIN_REPEATS))
    x = calls[0][0]
    b_ms, b_by = bound(3 * nbytes(x), FLOPS_EAW_ATROUS * x[0].numel())
    record["eaw-atrous"] = dict(max_abs_err=err, ms=float(np.mean(ms)),
                                plain_ms=float(np.mean(plain_ms)),
                                library_ms=None, bound_ms=b_ms,
                                bound_by=b_by, per_scale_ms=ms)
    print(f"[eaw-atrous] config 10's {len(calls)} scales on "
          f"{tuple(x.shape)}, kernel vs plain: max {err:.3g} (tol "
          f"{STENCIL_TOL:g}) | ms kernel/plain: "
          + ", ".join(f"s{i} {a:.3f}/{b:.1f}"
                      for i, (a, b) in enumerate(zip(ms, plain_ms)))
          + f" | bound {b_ms:.3f} ms per scale ({b_by})", flush=True)


def check_opcodes(meta, jobs):
    """Each job (key, x, op, params) as a one-stage chain on its input:
    kernel (the interpreter) vs its plain twin, bounds scaled as
    check_chains scales them; device ms and the bound from the opcode's
    OPS_CHAIN count.  Returns the rows."""
    rows = []
    for key, x, name, prm in jobs:
        chain = configs.opcode_chain(meta, name, prm, x.shape, x.device)
        got = pw.pointwise_chain(x, chain)
        want = pw.pointwise_chain_reference(x, chain)
        mx, mean = compare(got, want)
        scale = max(1.0, want.abs().max().item())
        changed = (want - x).abs().max().item()
        del got, want
        expect(changed > 1e-3, f"opcode {key}: output equals input")
        expect(mx <= CHAIN_MAX_TOL * scale
               and mean <= CHAIN_MEAN_TOL * scale,
               f"opcode {key}: max {mx}, mean {mean} (x {scale:.3g})")
        ms = median_ms(lambda: pw.pointwise_chain(x, chain))
        plain_ms = median_ms(
            lambda: pw.pointwise_chain_reference(x, chain),
            PLAIN_REPEATS)
        fp32, mufu = OPS_CHAIN[key]
        px = x[0].numel()
        b_ms, b_by = bound(2 * nbytes(x),
                           instructions=(fp32 + mufu) * px,
                           sfu=mufu * px)
        label = "/".join(str(k) for k in key[1:])
        rows.append(dict(op=label, max_abs_err=mx, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by))
        print(f"[opcode] {label} alone on {tuple(x.shape)}: "
              f"vs plain max {mx:.3g} mean {mean:.3g} (tol "
              f"{CHAIN_MAX_TOL:g} / {CHAIN_MEAN_TOL:g} x {scale:.3g}) | "
              f"kernel {ms:.4f} ms, plain {plain_ms:.1f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}; {fp32} float32 + {mufu} MUFU a "
              "pixel)", flush=True)
    return rows


def run_config10(card, record, raw, raw_dev, meta, phases):
    """Config 10 at 24 MP, the graded look: through the user's entry point
    with launches counted, against the composed twins; then its two chains,
    the atrous scales and each new opcode alone on the arguments the pipe
    hands them, and the pipe's timing and peak memory."""
    pipe = port.compile_pipeline(meta, configs.history(10))
    stages = [s.name for s in pipe.pipe.stages]
    expect(stages == STAGES10, f"unexpected config-10 plan {stages}")
    expect(pipe.fused_groups() == [STAGES10[4:9], STAGES10[10:]],
           f"unexpected chains {pipe.fused_groups()}")
    expect(raw.shape == pipe.pipe.spec_in.array_shape, "raw needs padding")
    # the specialised program of each chain
    fixed = [a.fixed for k, _, _, a in pipe.steps if k == "chain"]
    with timed(phases, "pipe10 vs plain"):
        reset_launches()
        out = pipe.output_array(raw)
        launches = read_launches()
        programs, maps = read_split()
        expect(launches == LAUNCHES10, f"config-10 launches {launches}")
        expect(programs == {f: 1 for f in fixed} and not maps,
               f"config-10 programs {programs}, warp maps {maps}")
        launches["programs"] = programs
        expect(out.shape == (3, H, W), f"output shape {out.shape}")
        expect(bool(np.isfinite(out).all()) and out.min() >= 0.0
               and out.max() <= 1.0, "output not finite or outside [0, 1]")
        reset_launches()
        with plain_twins():
            plain = pipe.output_array(raw)
        expect(all(v == 0 for v in read_launches().values()),
               f"the plain composition launched kernels: {read_launches()}")
        pipe_err = float(np.abs(out - plain).max())
        expect(pipe_err <= PIPE_TOL, f"config 10 vs plain: max {pipe_err}")
        del plain
    with timed(phases, "capture10"):
        calls = captured10(pipe, raw_dev)
    with timed(phases, "chain10"):
        rows = check_chains(10, calls["chain"], pipe.fused_groups())
        for i, row in enumerate(rows):
            record[f"chain10.{i}"] = row
    with timed(phases, "eaw-atrous"):
        check_atrous10(calls["eaw"], record)
    with timed(phases, "opcodes10"):
        # each grading opcode (8-18) on config 10's chain inputs: the RGB
        # ops on the demosaiced image, the Lab ops on the second chain's
        # input; colorbalancergb in both saturation formulas
        record["opcodes10"] = check_opcodes(meta, configs.grading_jobs(
            [a[0] for a in calls["chain"]]))
    del calls
    with timed(phases, "pipe10 timing"):
        per_img = time_pipe(pipe, raw_dev, REPEATS)
        peak, held = pipe_peak(pipe, raw_dev)
    print(f"[pipe10] config 10 {H}x{W}: {len(stages)} stages, chains "
          f"{pipe.fused_groups()} (programs "
          f"{[a.fixed for k, _, _, a in pipe.steps if k == 'chain']}), "
          f"launches {launches}, vs plain max {pipe_err:.3g} (tol 1/255), "
          f"range [{out.min():.3g}, {out.max():.3g}] | "
          f"{1.0 / per_img:.2f} img/s, {per_img * 1e3:.2f} ms/img "
          f"(device-resident input, {REPEATS} repeats after 2 warm-ups), "
          f"peak device memory {peak:.3f} GB ({held:.3f} GB held before) on "
          f"{card}", flush=True)
    return launches


def captured11(pipe, raw_dev):
    """Run config 11 once on a device-resident raw and keep the arguments
    of its chain and its two warps."""
    calls = {"chain": [], "homography": [], "liquify": []}
    real = {"chain": pw.pointwise_chain, "homography": warp.homography_warp,
            "liquify": warp.liquify_warp}

    def keep(key):
        def call(*args):
            calls[key].append(args)
            return real[key](*args)
        return call

    with swapped([(pw, "pointwise_chain", keep("chain")),
                  (warp, "homography_warp", keep("homography")),
                  (warp, "liquify_warp", keep("liquify"))]):
        pipe.run_padded(raw_dev)
    counts = {k: len(v) for k, v in calls.items()}
    expect(counts == {"chain": 1, "homography": 1, "liquify": 1},
           f"unexpected config-11 calls {counts}")
    return calls


def check_warp_ashift(calls, record):
    """ashift's homography on config 11's (3, 4000, 6016) demosaiced image,
    against the twin bit for bit, and grid_sample on the same source
    coordinates (the grid precomputed, the mask applied after) as the
    yardstick."""
    (x, k), = calls
    got = warp.homography_warp(x, k)
    want = warp.homography_warp_reference(x, k)
    mx, mean = compare(got, want)
    expect(torch.equal(got, want), f"warp-ashift: max {mx}")
    zero = (got == 0).all(dim=0).float().mean().item()
    del got
    ms = median_ms(lambda: warp.homography_warp(x, k))
    plain_ms = median_ms(lambda: warp.homography_warp_reference(x, k),
                         PLAIN_REPEATS)
    _, h, w = x.shape
    sy, sx, inside = warp.homography_coords(k, h, w, x.device)
    grid = torch.stack([sx / (w - 1) * 2 - 1, sy / (h - 1) * 2 - 1],
                       -1)[None]
    planes = x[None]

    def library():
        return F.grid_sample(planes, grid, mode="bilinear",
                             padding_mode="border", align_corners=True)

    lx, _ = compare(torch.where(inside[None, None], library(), 0.0)[0], want)
    expect(lx <= 1e-3, f"grid_sample yardstick: {lx}")
    del want
    lib_ms = median_ms(library)
    px = h * w
    b_ms, b_by = bound(2 * nbytes(x),
                       (FLOPS_HOMOGRAPHY_MAP + 3 * FLOPS_CLIP_CHANNEL) * px)
    record["warp-ashift"] = dict(max_abs_err=mx, ms=ms, plain_ms=plain_ms,
                                 library_ms=lib_ms, bound_ms=b_ms,
                                 bound_by=b_by)
    print(f"[warp-ashift] {tuple(x.shape)} ashift's inverse homography, "
          f"{zero:.1%} of the frame outside the source, kernel vs plain: "
          f"max {mx:.3g} mean {mean:.3g} (bit-equal); grid_sample vs plain "
          f"max {lx:.3g} | kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
          f"grid_sample {lib_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})",
          flush=True)


def liquify_pairs(stamps, win):
    """(pixel-stamp pairs of the window with the pixel inside the stamp's
    disc, those of radial stamps) for these stamps ((K, STAMP) float32 on
    the host), counted in float64: the work this run's data needs."""
    y0, y1, x0, x1 = win
    pairs = radial = 0
    for s in stamps:
        px, py, r = float(s[0]), float(s[1]), float(s[2])
        ya, yb = max(y0, int(np.floor(py - r))), min(y1, int(np.ceil(py + r)) + 1)
        xa, xb = max(x0, int(np.floor(px - r))), min(x1, int(np.ceil(px + r)) + 1)
        if ya >= yb or xa >= xb:
            continue
        yy, xx = np.mgrid[ya:yb, xa:xb]
        n = int((np.hypot(xx - px, yy - py) / r < 1.0).sum())
        pairs += n
        radial += n if s[6] != 0.0 else 0
    return pairs, radial


def check_warp_liquify(calls, record):
    """liquify's warp on config 11's ashift output: its stamps over the
    stamp-union window, pasted into a copy of the frame; against the twin
    bit for bit; the wrapper timed (the frame's copy and the window's
    kernel); grid_sample of the window at the twin's displaced positions
    (the grid precomputed) as the yardstick."""
    (x, stamps, win), = calls
    y0, y1, x0, x1 = win
    got = warp.liquify_warp(x, stamps, win)
    want = warp.liquify_warp_reference(x, stamps, win)
    mx, mean = compare(got, want)
    expect(torch.equal(got, want), f"warp-liquify: max {mx}")
    moved = (got - x).abs().max().item()
    expect(moved > 1e-3, "liquify moved nothing")
    del got
    ms = median_ms(lambda: warp.liquify_warp(x, stamps, win))
    plain_ms = median_ms(lambda: warp.liquify_warp_reference(x, stamps, win),
                         PLAIN_REPEATS)
    _, h, w = x.shape
    ax, ay, yy, xx = warp.liquify_displacement(stamps, win)
    sx, sy = xx + ax, yy + ay
    grid = torch.stack([sx / (w - 1) * 2 - 1, sy / (h - 1) * 2 - 1],
                       -1)[None]
    planes = x[None]

    def library():
        return F.grid_sample(planes, grid, mode="bilinear",
                             padding_mode="border", align_corners=True)

    lx, _ = compare(library()[0], want[:, y0:y1, x0:x1])
    expect(lx <= 1e-3, f"grid_sample yardstick: {lx}")
    del want, ax, ay, yy, xx, sx, sy
    lib_ms = median_ms(library)
    pairs, radial = liquify_pairs(stamps.cpu().numpy(), win)
    wpx = (y1 - y0) * (x1 - x0)
    flops = (FLOPS_LIQUIFY_PAIR * pairs + FLOPS_LIQUIFY_RADIAL * radial
             + (2 + 3 * FLOPS_CLIP_CHANNEL) * wpx)
    b_ms, b_by = bound(2 * nbytes(x), flops)
    record["warp-liquify"] = dict(max_abs_err=mx, ms=ms, plain_ms=plain_ms,
                                  library_ms=lib_ms, bound_ms=b_ms,
                                  bound_by=b_by)
    print(f"[warp-liquify] {tuple(x.shape)} {stamps.shape[0]} stamps over "
          f"the window {win} ({wpx / 1e6:.2f} MP; {pairs / wpx:.1f} stamps "
          f"a pixel on average), kernel vs plain: max {mx:.3g} mean "
          f"{mean:.3g} (bit-equal), moved up to {moved:.3g} | kernel (copy "
          f"and window) {ms:.3f} ms, plain {plain_ms:.1f} ms, grid_sample "
          f"(the window) {lib_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}; "
          f"{flops / 1e9:.2f} G float32 operations)", flush=True)


def run_config11(card, record, raw, raw_dev, meta, phases):
    """Config 11 at 24 MP, the legacy look straightened and retouched:
    through the user's entry point with launches counted, against the
    composed twins; then its chain, both warps and each legacy opcode
    alone on the arguments the pipe hands them, and the pipe's timing and
    peak memory."""
    pipe = port.compile_pipeline(meta, configs.history(11))
    stages = [s.name for s in pipe.pipe.stages]
    expect(stages == STAGES11, f"unexpected config-11 plan {stages}")
    expect(pipe.fused_groups() == [STAGES11[6:]],
           f"unexpected chains {pipe.fused_groups()}")
    ashift = pipe.pipe.stages[STAGES11.index("ashift")].plan
    # R11: the crop mode is recorded and, as in the JAX package, not applied
    expect(ashift.static[1] is not None and ashift.spec_out == ashift.spec_in,
           "ashift changed the frame")
    fixed = [a.fixed for k, _, _, a in pipe.steps if k == "chain"]
    with timed(phases, "pipe11 vs plain"):
        reset_launches()
        out = pipe.output_array(raw)
        launches = read_launches()
        programs, maps = read_split()
        expect(launches == LAUNCHES11, f"config-11 launches {launches}")
        expect(programs == {f: 1 for f in fixed}
               and maps == {"homography": 1, "liquify": 1},
               f"config-11 programs {programs}, warp maps {maps}")
        launches["programs"], launches["maps"] = programs, maps
        expect(out.shape == (3, H, W), f"output shape {out.shape}")
        expect(bool(np.isfinite(out).all()) and out.min() >= 0.0
               and out.max() <= 1.0, "output not finite or outside [0, 1]")
        reset_launches()
        with plain_twins():
            plain = pipe.output_array(raw)
        expect(all(v == 0 for v in read_launches().values()),
               f"the plain composition launched kernels: {read_launches()}")
        pipe_err = float(np.abs(out - plain).max())
        expect(pipe_err <= PIPE_TOL, f"config 11 vs plain: max {pipe_err}")
        del plain
    with timed(phases, "capture11"):
        calls = captured11(pipe, raw_dev)
    with timed(phases, "chain11"):
        (record["chain11.0"],) = check_chains(11, calls["chain"],
                                              pipe.fused_groups())
    with timed(phases, "warp-ashift"):
        check_warp_ashift(calls["homography"], record)
    with timed(phases, "warp-liquify"):
        check_warp_liquify(calls["liquify"], record)
    with timed(phases, "opcodes11"):
        (x, chain), = calls["chain"]
        record["opcodes11"] = check_opcodes(meta, configs.legacy_jobs(
            x, chain, pipe.fused_groups()[0]))
    del calls
    with timed(phases, "pipe11 timing"):
        per_img = time_pipe(pipe, raw_dev, REPEATS)
        peak, held = pipe_peak(pipe, raw_dev)
    print(f"[pipe11] config 11 {H}x{W}: {len(stages)} stages, chains "
          f"{pipe.fused_groups()} (programs "
          f"{[a.fixed for k, _, _, a in pipe.steps if k == 'chain']}), "
          f"launches {launches}, vs plain max {pipe_err:.3g} (tol 1/255), "
          f"range [{out.min():.3g}, {out.max():.3g}] | "
          f"{1.0 / per_img:.2f} img/s, {per_img * 1e3:.2f} ms/img "
          f"(device-resident input, {REPEATS} repeats after 2 warm-ups), "
          f"peak device memory {peak:.3f} GB ({held:.3f} GB held before) on "
          f"{card}", flush=True)
    return launches


def check_prng(card):
    """JAX's generator on the card against the same calls on the CPU at
    config 12's shapes: the keys and splits, the bits of each uniform and
    randint draw, the normal draws within NORMAL_TOL; each draw's device
    ms."""
    key = prng.PRNGKey(0x5EED)
    expect(prng.split(key, 30, device="cuda") == prng.split(key, 30),
           "split on the card differs from the host's")
    draws = [
        ("dither uniform", prng.uniform, (prng.PRNGKey(353), (3, H, W))),
        ("grain normal", prng.normal, (prng.PRNGKey(773), (H, W))),
        ("HR normal", prng.normal, (prng.PRNGKey(0), (3, H, W))),
        ("censorize uniform", prng.uniform,
         (prng.PRNGKey(1259), (3, H, W), -0.5, 0.5)),
        ("crystgrain randint", prng.randint, (key, (H, W), 0, 4)),
    ]
    rows = []
    for label, fn, args in draws:
        got = fn(*args, device="cuda").cpu()
        want = fn(*args)
        if fn is prng.normal:
            mx = (got - want).abs().max().item()
            same = (got == want).float().mean().item()
            expect(mx <= NORMAL_TOL, f"prng {label}: max {mx}")
            how = f"max {mx:.3g}, {same:.4f} equal"
        else:
            expect(torch.equal(got, want), f"prng {label}: bits differ")
            how = "bit-equal"
        del got, want
        ms = median_ms(lambda: fn(*args, device="cuda"), 3)
        rows.append(f"{label} {args[1]} {how}, {ms:.2f} ms")
    print(f"[prng] PRNGKey and split(30) equal the host's; card vs CPU: "
          f"{'; '.join(rows)} (normal tol {NORMAL_TOL:g}) on {card}",
          flush=True)


def captured12(pipe, raw_dev):
    """Run config 12 once on a device-resident raw and keep the arguments
    of its four chain calls and of its sepblur calls (the first at each
    dilation and tap count, with each one's call count)."""
    calls = {"chain": [], "sepblur": {}, "counts": {}}
    real_chain, real_sb = pw.pointwise_chain, sepblur.sep_blur

    def ch(*args):
        calls["chain"].append(args)
        return real_chain(*args)

    def sb(x, taps, d=1):
        k = (len(taps), d)
        calls["sepblur"].setdefault(k, (x, taps, d))
        calls["counts"][k] = calls["counts"].get(k, 0) + 1
        return real_sb(x, taps, d)

    with swapped([(pw, "pointwise_chain", ch), (sepblur, "sep_blur", sb)]):
        pipe.run_padded(raw_dev)
    hr = {k: n for k, n in calls["counts"].items() if k[0] == 5}
    expect(len(calls["chain"]) == LAUNCHES12["chain"]
           and sum(hr.values()) == HR_BLURS12
           and sum(calls["counts"].values()) == LAUNCHES12["sepblur"],
           f"unexpected config-12 calls {len(calls['chain'])} chains, "
           f"sepblur {calls['counts']}")
    return calls


def check_sepblur_hr(calls, record):
    """The reconstruction's B3 blurs of (3, 4000, 6016) at dilations 1 to
    256 (the two-pass form from 256): kernel vs twin bit for bit, device
    ms of the kernel, the twin and a depthwise F.conv2d of the same
    dilated 5 x 5 product, and the byte bound; the image's 36 launches
    summed by their counts."""
    rows, err, tot = [], 0.0, dict(ms=0.0, plain_ms=0.0, library_ms=0.0,
                                   bound_ms=0.0)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for (n, d), (x, taps, _) in sorted(calls["sepblur"].items()):
            if n != 5:
                continue
            got = sepblur.sep_blur(x, taps, d)
            want = sepblur.sep_blur_reference(x, taps, d)
            mx, _ = compare(got, want)
            expect(torch.equal(got, want), f"sepblur HR d={d}: max {mx}")
            err = max(err, mx)
            del got, want
            k = torch.tensor(taps, device=x.device)
            weight = torch.outer(k, k).expand(x.shape[0], 1, 5, 5)
            weight = weight.contiguous()
            xp = F.pad(x[None], (2 * d,) * 4, mode="replicate")
            ms = median_ms(lambda: sepblur.sep_blur(x, taps, d))
            plain_ms = median_ms(
                lambda: sepblur.sep_blur_reference(x, taps, d), PLAIN_REPEATS)
            lib_ms = median_ms(lambda: F.conv2d(xp, weight, dilation=d,
                                                groups=x.shape[0]))
            del xp
            b_ms, b_by = bound(2 * nbytes(x),
                               FLOPS_SEPBLUR_PER_TAP * len(taps) * x.numel())
            count = calls["counts"][(n, d)]
            for key_, v in (("ms", ms), ("plain_ms", plain_ms),
                            ("library_ms", lib_ms), ("bound_ms", b_ms)):
                tot[key_] += count * v
            rows.append(f"d={d} x{count} {ms:.4f}/{plain_ms:.2f}/"
                        f"{lib_ms:.3f}")
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    record["sepblur-hr"] = dict(max_abs_err=err, bound_by=b_by,
                                per_image=tot, launches=HR_BLURS12,
                                **{k: v / HR_BLURS12 for k, v in tot.items()})
    print(f"[sepblur-hr] filmicrgb's reconstruction, {tuple(x.shape)} B3 "
          f"kernel vs plain: max {err:.3g} (bit-equal) | ms kernel/plain/"
          f"conv2d: {', '.join(rows)} | per image ({HR_BLURS12} launches): "
          f"kernel {tot['ms']:.3f} ms, plain {tot['plain_ms']:.1f}, conv2d "
          f"{tot['library_ms']:.3f}, bound {tot['bound_ms']:.3f} ms "
          f"({b_by})", flush=True)


def run_config12(card, record, raw, raw_dev, meta, phases):
    """Config 12 at 24 MP, the hazy landscape with a blown sky: through
    the user's entry point with launches counted (the census read once),
    against the composed twins; then its four chains and the
    reconstruction's blurs on the arguments the pipe hands them, and the
    pipe's timing and peak memory."""
    pipe = port.compile_pipeline(meta, configs.history(12))
    stages = [s.name for s in pipe.pipe.stages]
    expect(stages == STAGES12, f"unexpected config-12 plan {stages}")
    groups = [STAGES12[5:7], STAGES12[8:9], STAGES12[10:12]]
    expect(pipe.fused_groups() == groups,
           f"unexpected chains {pipe.fused_groups()}")
    rec = pipe.pipe.stages[STAGES12.index("filmicrgb")].plan.static[5]
    expect(rec == (9, 1), f"reconstruction planned as {rec}")
    expect(raw.shape == pipe.pipe.spec_in.array_shape, "raw needs padding")
    with timed(phases, "pipe12 vs plain"):
        reset_launches()
        out = pipe.output_array(raw)
        launches = read_launches()
        programs, maps = read_split()
        expect(launches == LAUNCHES12, f"config-12 launches {launches}")
        expect(len(programs) == 4 and -1 not in programs and not maps,
               f"config-12 programs {programs}, warp maps {maps}")
        launches["programs"] = programs
        expect(out.shape == (3, H, W), f"output shape {out.shape}")
        expect(bool(np.isfinite(out).all()) and out.min() >= 0.0
               and out.max() <= 1.0, "output not finite or outside [0, 1]")
        reset_launches()
        with plain_twins():
            plain = pipe.output_array(raw)
        expect(all(v == 0 for v in read_launches().values()),
               f"the plain composition launched kernels: {read_launches()}")
        pipe_err = float(np.abs(out - plain).max())
        expect(pipe_err <= PIPE_TOL, f"config 12 vs plain: max {pipe_err}")
        del plain
    with timed(phases, "capture12"):
        calls = captured12(pipe, raw_dev)
        i = STAGES12.index("filmicrgb")
        x_in = pipe.pipe.trace_fn(0, i)(raw_dev, pipe.coeffs[:i])
        c = pipe.coeffs[i]
        norm = torch.sqrt(torch.sum(x_in * x_in, dim=0))
        arg = -norm * (c["rec_feather"] / c["rec_threshold"]) \
            + c["rec_feather"]
        clipped = int(torch.sum(arg < 4.0))
        expect(clipped > 9, f"census {clipped}: the reconstruction skipped")
        del x_in, norm, arg
    with timed(phases, "chain12"):
        names = [["exposure", "colorin"], ["filmicrgb"], ["_convert"],
                 ["_convert", "colorout"]]
        for j, row in enumerate(check_chains(12, calls["chain"], names)):
            record[f"chain12.{j}"] = row
    with timed(phases, "sepblur-hr"):
        check_sepblur_hr(calls, record)
    del calls
    with timed(phases, "pipe12 timing"):
        per_img = time_pipe(pipe, raw_dev, PIPE12_REPEATS)
        peak, held = pipe_peak(pipe, raw_dev)
    print(f"[pipe12] config 12 {H}x{W}: {len(stages)} stages, chains "
          f"{pipe.fused_groups()} + filmicrgb's AgX after its reconstruction "
          f"(rec {rec}, census fired: {clipped} pixels, one host read), "
          f"launches {launches} (sepblur {HR_BLURS12} for the "
          f"reconstruction), vs plain max {pipe_err:.3g} (tol 1/255), range "
          f"[{out.min():.3g}, {out.max():.3g}] | {1.0 / per_img:.2f} img/s, "
          f"{per_img * 1e3:.2f} ms/img (device-resident input, "
          f"{PIPE12_REPEATS} repeats after 2 warm-ups), peak device memory "
          f"{peak:.3f} GB ({held:.3f} GB held before) on {card}", flush=True)
    return launches


def op_alone(meta, raw_dev, name, params):
    """(pipe, i, x): `name` after config 12's +1 EV, planned by the
    user's entry point at the 24 MP frame, and its stage's input."""
    hist = [port.HistoryItem("exposure", {"exposure": 1.0}),
            port.HistoryItem(name, params)]
    pipe = port.compile_pipeline(meta, hist)
    i = [s.name for s in pipe.pipe.stages].index(name)
    return pipe, i, pipe.pipe.trace_fn(0, i)(raw_dev, pipe.coeffs[:i])


def check_iir_censorize(calls, record):
    """censorize's sigma-8 Gaussian of (3, 4000, 6016) on the IIR kernel
    against the twin (IIR_TOL, bit-equal), with its bound."""
    (x, coef, lo, hi), = calls
    got = iir.gaussian_iir(x, coef, lo, hi)
    want = iir.gaussian_iir_reference(x, coef, lo, hi)
    mx, _ = compare(got, want)
    expect(mx <= IIR_TOL and torch.equal(got, want), f"iir censorize: {mx}")
    del got, want
    ms = median_ms(lambda: iir.gaussian_iir(x, coef, lo, hi))
    plain_ms = median_ms(lambda: iir.gaussian_iir_reference(x, coef, lo, hi),
                         1)
    b_ms, b_by = bound(2 * nbytes(x), FLOPS_IIR * x.numel())
    floor_ms = iir.latency_floor_ms(*x.shape[-2:])
    record["iir-censorize"] = dict(max_abs_err=mx, ms=ms, plain_ms=plain_ms,
                                   library_ms=None, bound_ms=b_ms,
                                   bound_by=b_by, launches=1)
    print(f"[iir-censorize] {tuple(x.shape)} sigma 8, kernel vs plain: max "
          f"{mx:.3g} (tol {IIR_TOL:g}; bit-equal) | kernel {ms:.4f} ms, "
          f"plain {plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}), latency "
          f"floor {floor_ms:.4f} ms", flush=True)


def run_ops12(card, record, meta, raw_dev, phases):
    """Each op of configs.OPS12 alone on config 12's frame after +1 EV,
    through the stage's own run: its launches, within 1/255 of the same
    stage with every kernel's twin, and its device ms; censorize's IIR
    and 25-tap sepblur arguments against their twins."""
    rows = []
    for name, params in configs.OPS12:
        if params is None:   # colormapping: statistics of the frame
            _, _, lab = op_alone(meta, raw_dev, name, {})
            small = lab[:, ::8, ::8].cpu().numpy()
            params = configs.colormapping_params(
                small, small[:, ::-1] * np.float32(0.9)
                + np.float32([8.0, 5.0, -6.0]).reshape(3, 1, 1))
            del lab
        with timed(phases, f"ops12 {name}"):
            pipe, i, x = op_alone(meta, raw_dev, name, params)

            def run():
                return pipe.pipe.trace_fn(i, i + 1)(x, pipe.coeffs[i:i + 1])

            iir_calls, sb_calls = [], []
            real_iir, real_sb = iir.gaussian_iir, sepblur.sep_blur
            reset_launches()
            with swapped([(iir, "gaussian_iir", lambda *a: iir_calls.append(
                               a) or real_iir(*a)),
                          (sepblur, "sep_blur", lambda v, t, d=1:
                           sb_calls.append((v, t, d)) or real_sb(v, t, d))]):
                got = run()
            launches = {k: v for k, v in read_launches().items() if v}
            with plain_twins():
                want = run()
            mx, mean = compare(got, want)
            expect(mx <= PIPE_TOL, f"ops12 {name}: max {mx}")
            changed = (got - x).abs().max().item()
            expect(changed > 1e-3, f"ops12 {name}: output equals input")
            del got, want
            if name == "censorize":
                check_iir_censorize(iir_calls, record)
                v, t, d = sb_calls[0]
                got = sepblur.sep_blur(v, t, d)
                expect(torch.equal(got, sepblur.sep_blur_reference(v, t, d)),
                       "sepblur censorize: not bit-equal")
                del got
            del iir_calls, sb_calls
            ms = median_ms(run, OPS12_REPEATS)
        rows.append(dict(op=name, launches=launches, max_abs_err=mx, ms=ms))
        print(f"[ops12] {name} alone on {tuple(x.shape)}: launches "
              f"{launches}, vs plain max {mx:.3g} mean {mean:.3g} (tol "
              f"1/255) | {ms:.2f} ms on {card}", flush=True)
        del pipe, x
    record["ops12"] = rows


def run_devtest_and_entry(phases):
    """The CLI's card diagnostic, then entry()'s fn on the card against
    the same fn with every kernel's plain twin."""
    with timed(phases, "devtest"):
        rc = cli.main(["--devtest"])
        expect(rc == 0, f"--devtest exit {rc}")
        print("[devtest] ansel_tpu_torch.cli --devtest exit 0", flush=True)
    with timed(phases, "entry"):
        fn, (raw_p, co) = entry()
        expect(raw_p.device.type == "cuda", "entry() left the card")
        reset_launches()
        got = fn(raw_p, co)
        launches = read_launches()
        expect(launches == LAUNCHES1, f"entry launches {launches}")
        with plain_twins():
            want = fn(raw_p, co)
        mx, mean = compare(got, want)
        expect(mx <= PIPE_TOL, f"entry vs plain: max {mx}")
        expect(float(got.min()) >= 0.0 and float(got.max()) <= 1.0,
               "entry output outside [0, 1]")
        print(f"[entry] entry() fn on {tuple(raw_p.shape)}: "
              f"{tuple(got.shape)}, launches {launches}, vs plain max "
              f"{mx:.3g} mean {mean:.3g} (tol 1/255)", flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    t0 = time.perf_counter()
    phases = {}
    # float32 products, as the JAX package's HIGHEST precision (the resize)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{card}", flush=True)
    record = {}
    with ThreadPoolExecutor(max_workers=4) as pool:
        # the mosaics are made on host threads, the 24 MP one while nvcc
        # builds, the 45 MP and X-Trans ones while configs 1 and 2 run
        with timed(phases, "build + mosaic"):
            synth = pool.submit(synth_raw, h=H, w=W, kind="gradients")
            synth3 = pool.submit(synth_raw, h=H3, w=W3, kind="gradients")
            synth4 = pool.submit(xtrans_raw, H4, W4)
            build_s = _build.build_all()
            print(f"[build] nvcc built and loaded "
                  f"{', '.join(_build.KERNELS)} in {build_s:.1f} s",
                  flush=True)
            raw, meta, _ = synth.result()
            raw_dev = torch.from_numpy(raw).cuda()
        with timed(phases, "config 1"):
            png1 = run_config1(card, record, raw, raw_dev, meta, pool)
        launches = run_config2(card, record, raw, raw_dev, meta, pool,
                               phases, [png1])
        launches7 = run_config7(card, record, raw, raw_dev, meta, phases)
        with tempfile.TemporaryDirectory() as tmp:
            run_config8(card, raw_dev, meta, phases, tmp)
            launches9 = run_config9(card, record, raw, meta, phases, tmp)
        launches10 = run_config10(card, record, raw, raw_dev, meta, phases)
        launches11 = run_config11(card, record, raw, raw_dev, meta, phases)
        with timed(phases, "prng"):
            check_prng(card)
        launches12 = run_config12(card, record, raw, raw_dev, meta, phases)
        run_ops12(card, record, meta, raw_dev, phases)
        run_devtest_and_entry(phases)
        del raw_dev
        with timed(phases, "mosaic3 wait"):
            raw3, meta3, _ = synth3.result()
        launches3 = run_config3(card, record, raw3, meta3, phases)
        del raw3
        with timed(phases, "mosaic4 wait"):
            raw4, meta4 = synth4.result()
        launches4 = run_config4(card, record, raw4, meta4, phases)
    # launches per image: config 2's for the first five kernels, config
    # 3's for the IIR and diffuse kernels, config 4's for Markesteijn and
    # the warp, config 7's for the grid slice
    launches.update(iir=launches3["iir"], diffuse=launches3["diffuse"],
                    markesteijn=launches4["markesteijn"],
                    warp=launches4["warp"], bgrid=launches7["bgrid"])
    print(f"[done] total {time.perf_counter() - t0:.1f} s | "
          + ", ".join(f"{k} {v:.1f} s" for k, v in phases.items()),
          flush=True)

    sources = {
        "rcd": ("rcd_demosaic", "rcd.cu", "ansel_tpu/kernels/rcd_pallas.py:189"),
        "chain": ("pointwise_chain", "pointwise_chain.cu",
                  "ansel_tpu/kernels/pointwise.py:30"),
        "sepblur": ("sep_blur", "sepblur.cu",
                    "ansel_tpu/kernels/sepblur_pallas.py:189"),
        "eaw": ("eaw_dn_coarse", "eaw.cu",
                "ansel_tpu/kernels/eaw_pallas.py:199"),
        "nlm": ("nlm", "nlm.cu", "ansel_tpu/kernels/nlm_pallas.py:186"),
        "iir": ("gaussian_iir", "iir.cu",
                "ansel_tpu/kernels/iir_pallas.py:113"),
        "diffuse": ("diffuse_iteration", "diffuse.cu",
                    "ansel_tpu/kernels/diffuse_pallas.py:218"),
        "markesteijn": ("xtrans_markesteijn", "markesteijn.cu",
                        "ansel_tpu/kernels/markesteijn_pallas.py:372"),
        "warp": ("lens_warp", "warp.cu",
                 "ansel_tpu/kernels/warp_pallas.py:121"),
        "bgrid": ("slice_grid", "bgrid.cu",
                  "ansel_tpu/kernels/bgrid_pallas.py:92"),
    }
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = []
    for key, (name, src, replaces) in sources.items():
        r = record[key]
        entry_ = {"name": name, "route": "cuda",
                  "source": f"ansel_tpu_torch/csrc/{src}",
                  "replaces": replaces, "launches": launches[key],
                  **{k: r[k] for k in keys}}
        if key == "warp":
            # the top-level numbers are lens's map (config 4); every map
            # with its launches in its config's run and its own numbers
            entry_["launches"] = (launches["warp"] + launches9["warp"]
                                  + launches11["warp"])
            entry_["maps"] = [
                dict(map="lens", launches=launches4["maps"]["lens"],
                     **{k: r[k] for k in keys}),
                dict(map="clipping", launches=launches9["maps"]["clip"],
                     **{k: record["warp-clip"][k] for k in keys}),
                dict(map="ashift",
                     launches=launches11["maps"]["homography"],
                     **{k: record["warp-ashift"][k] for k in keys}),
                dict(map="liquify", launches=launches11["maps"]["liquify"],
                     **{k: record["warp-liquify"][k] for k in keys})]
        if key == "nlm":
            entry_["wide"] = r["wide"]
        if key == "chain":
            # the grading and legacy opcodes, each alone on config 10's
            # and config 11's arguments
            entry_["opcodes"] = record["opcodes10"] + record["opcodes11"]
        if key == "sepblur":
            # filmicrgb's reconstruction in config 12: per launch, and
            # per image over its 36 launches
            entry_["hr"] = {k: record["sepblur-hr"][k]
                            for k in keys + ("launches", "per_image")}
        if key == "iir":
            # censorize's sigma-8 blur, alone on config 12's frame
            entry_["censorize"] = {k: record["iir-censorize"][k]
                                   for k in keys + ("launches",)}
        kernels.append(entry_)
    # config 10: its two chains (the launches of each one's program) and
    # the EAW kernel's atrous variant (one launch per scale)
    for i in range(LAUNCHES10["chain"]):
        row = record[f"chain10.{i}"]
        kernels.append({"name": f"pointwise_chain[config10.{i}]",
                        "route": "cuda",
                        "source": "ansel_tpu_torch/csrc/pointwise_chain.cu",
                        "replaces": "ansel_tpu/kernels/pointwise.py:30",
                        "launches": launches10["programs"][row["program"]],
                        **{k: row[k] for k in keys}})
    # config 11: its one chain of 15 stages, and the warp kernel on
    # ashift's and on liquify's map, each with its launches in [pipe11]
    row = record["chain11.0"]
    kernels.append({"name": "pointwise_chain[config11.0]", "route": "cuda",
                    "source": "ansel_tpu_torch/csrc/pointwise_chain.cu",
                    "replaces": "ansel_tpu/kernels/pointwise.py:30",
                    "launches": launches11["programs"][row["program"]],
                    **{k: row[k] for k in keys}})
    for m, fn in (("ashift", "homography"), ("liquify", "liquify")):
        kernels.append({"name": f"{fn}_warp", "route": "cuda",
                        "source": "ansel_tpu_torch/csrc/warp.cu",
                        "replaces": "ansel_tpu/kernels/warp_pallas.py:121",
                        "launches": launches11["maps"][fn],
                        **{k: record[f"warp-{m}"][k] for k in keys}})
    # config 12: its four chain programs, each with its launches in
    # [pipe12]
    for j in range(LAUNCHES12["chain"]):
        row = record[f"chain12.{j}"]
        kernels.append({"name": f"pointwise_chain[config12.{j}]",
                        "route": "cuda",
                        "source": "ansel_tpu_torch/csrc/pointwise_chain.cu",
                        "replaces": "ansel_tpu/kernels/pointwise.py:30",
                        "launches": launches12["programs"][row["program"]],
                        **{k: row[k] for k in keys}})
    kernels.append({"name": "eaw_atrous_coarse", "route": "cuda",
                    "source": "ansel_tpu_torch/csrc/eaw.cu",
                    "replaces": "ansel_tpu/kernels/eaw_pallas.py:205",
                    "launches": launches10["eaw"],
                    **{k: record["eaw-atrous"][k] for k in keys}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
