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
    (K 15) and a patch radius past its template limit (P 9);
  * the port's config 13 at 24 MP (4000 x 6016), local edits on config
    1's develop: a raw denoise under a drawn gradient (the RAW blend),
    spots (two heals, a clone), a wavelet retouch, a second exposure under
    a feathered ellipse whose mask a later Lab stage reads (the raster
    side-band), parametric and hue-family blends that ride the chains as
    keep and blend records, a group of drawn shapes under a wide mask
    blur (the IIR), the details slider with a narrow one (sepblur): RCD,
    the chain in four programs, sepblur and the IIR; every blend mode and
    mask class as a blend record on its chain inputs (`[blend-modes]`);
    its sidecar exported through `python -m ansel_tpu_torch.cli`;
  * the port's config 14 at 24 MP (4000 x 6016), config 1's develop with
    a look shared as a style (`[pipe14]`): an ICC input profile, a .cube
    in sRGB, inline compressed-CLUT keypoints in linear Rec2020, a painted
    layer upsampled onto the frame and an ICC output profile (a B2A LUT),
    the fixtures written to a temporary directory from `--seed`, the
    style written as a .dtstyle, read back and merged, the merged history
    exported as a sidecar through `python -m ansel_tpu_torch.cli`: RCD and
    the chain in three programs, the profiles, LUTs and layer in torch;
  * the fast pipes on config 1's history (`[fastpipe]`): PREVIEW at 24 MP
    with a `demosaic` item given as a dict (planned PPG) and THUMBNAIL at
    scale 0.25 with a decoded method-7 blob (planned bilinear): the
    chain once each, the demosaics in torch;
  * `[r14]`: config 13's history at orientation 6, at scale 0.5, and with
    a crop between its raster source and consumer, each refused with
    ValueError while planning, before anything reaches the card.
  * the port's config 15 at 24 MP (4000 x 6016), a back-lit landscape
    (`[pipe15]`): config 1's mosaic 2 EV brighter and clipped at the white
    level (its clipped shares printed), HARMONIC highlights (the guided
    Laplacian's 360 blurs, then the dome core), RCD under the dual blend
    (0x2005) with green equilibration 3 and two passes of colour
    smoothing, config 1's develop: sepblur, RCD and the chain (program
    0), each held against its twin on the pipe's arguments;
  * `[demosaic-methods]`: one demosaic step alone at 24 MP for AMaZE,
    LMMSE (refine 1 and 4), VNG4, green equilibration 3, colour smoothing
    and the Bayer dual blend on config 1's mosaic, and X-Trans VNG and
    X-Trans dual (0x3001, the Markesteijn kernel held against its twin) on
    config 4's, each timed and held on a crop against the CPU;
  * `[highlight-modes]`: LCH and INPAINT on config 15's mosaic, INPAINT on
    config 4's clipped the same way, HARMONIC's dome core alone, each
    timed and held on a crop against the CPU;
  * the port's config 16 at 24 MP (4000 x 6016 -> 4444 x 6684 with its
    border), a high-ISO web export (`[pipe16]`): config 1's mosaic with
    an ILCE-7M3's ISO 3200 noise, denoiseprofile's automatic profile
    (the noise-profile database), exposure, diffuse at 8 scales (the
    XLA form in torch on the sepblur kernel), colorequal, colorprimaries
    (host CLUTs, built on a host thread while nvcc runs), filmicrgb
    colour science v5 on the chain's spline opcode (33), a border with a
    frame line and the ansel.svg signature: RCD, EAW, sepblur and two
    chain programs against their twins; its sidecar through `python -m
    ansel_tpu_torch.cli`; `[diffuse-wide]` the decompose's 8 blurs and
    the step; `[opcode] filmic-spline` opcode 33 alone for colour
    sciences v1-v4 with each preserve method, v5, and v5 after a
    highlight reconstruction, each with the interpreter's time;
    `[ops16]` each new torch op alone at 24 MP;
  * `[nn]`: rawdenoiseai alone at 24 MP with a single-scale U-Net and a
    multi-scale one with its low-band anchor on config 1's mosaic and the
    multi-scale one on config 4's X-Trans mosaic (models from `--seed`),
    each timed with its peak memory and held against the CPU on a crop
    handed to the op as the whole frame, with cuDNN's TF32 off (the
    setting printed, and how far TF32 would have moved the crop);
  * the port's config 17 at 24 MP (`[pipe17]`): config 16's noisy mosaic
    through rawdenoiseai's multi-scale net (written to an .anselnn in a
    temporary directory on the op's search path) and config 1's develop:
    RCD and the chain against their twins;
  * `[scopes]`: the histogram, waveform, vectorscope and statistics of
    config 1's output on the card, each equal to the CPU's;
  * bench config 5 (`[pipe5]`): the library's batch export of a roll of
    24 images, Bayer 4000 x 6016 and X-Trans 4000 x 6000, each saved
    with a sidecar of config 1's history (written on a host thread from
    the start), imported, queried through a collection and exported to
    JPEG on the serialized export queue's device jobs, a warm-up pass and
    a timed one (img/s, MP/s, where the wall time goes, peak memory): RCD,
    Markesteijn and the chain, the pipe cache hit on every image;
    `[generate-cache]` the CLI's thumbnail cache on its library in a new
    process;
  * the port's config 18 at 24 MP (`[pipe18]`), the multi-device paths
    on the machine's cards or, where it has fewer than a path's shards,
    on an explicit virtual mesh that it names: (a) `BatchPipeline` over
    dp 2, four images of config 1's mosaic at gains 1.00-1.03, each equal
    to the single pipe's bit for bit; (b) `SpatialPipeline` over sp 4,
    config 18's denoise stack on config 2's noisy mosaic (one halo
    exchange, denoiseprofile's statistic summed over the shards) within
    1/255 of the single pipe; (c) `spatial_sharded_pipe` over (dp 2, sp
    2), config 1's history within 1e-5, then config 1's develop behind
    denoiseprofile's wavelets and green equilibration 2 on the noisy
    mosaic within 1e-5 (each band computes the frame up to demosaic,
    whose stages read whole-frame statistics); each with img/s beside
    the single pipe's, peak memory and launches, and RCD, EAW, NLM and
    the chains held against their twins on a shard's arguments (sp shard
    1's window, whose origin is row 708); then `dryrun_multichip(4)`
    (`[dryrun]`);
  * the port's config 19 (`[pipe19]`), a Lightroom roll: config 5's
    Bayer and X-Trans images beside Lightroom sidecars (written on a
    host thread from the start), imported, crawled (the histories,
    ratings and tags), written back, exported to JPEG by `batch_export`
    and uploaded by `store_piwigo` to a mock ws.php this script serves on
    127.0.0.1, each render within 1/255 of a single pipe of the parsed
    history: RCD, Markesteijn, the warp on clipping's map, grain's blurs
    and two interpreted chains against their twins;
  * `[lut3d-pil]`: a Hald CLUT written by PIL as a palette PNG and as a
    JPEG, read through PIL by the lut3d op of a 24 MP pipe on the card,
    and the same history on the card and on the CPU on a crop.

Each path runs with the launch counts set to 0 just before it and read
just after.  Every chain each config builds is also timed on its own
arguments, through its specialised kernel and the interpreter (which
must agree bit for bit), against its bound.  One line per phase; the line before the
last is the kernels' JSON record, the last line the device record.  Any failure
raises, so the script then exits non-zero without the last line.  It
needs a CUDA device and imports neither JAX nor `ansel_tpu`.
"""

import argparse
import contextlib
import dataclasses
import http.server
import json
import os
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

import ansel_tpu_torch as port
from ansel_tpu_torch import cli
from ansel_tpu_torch.entry import dryrun_multichip, entry
from ansel_tpu_torch.io import anselnn, configs, encode, rawfile
from ansel_tpu_torch.io import xmp as xmp_mod
from ansel_tpu_torch.io.encode import read_png16, to_uint16, write_image
from ansel_tpu_torch.io.rawfile import load_raw, save_raw
from ansel_tpu_torch.io.synthetic import synth_raw
from ansel_tpu_torch.core.types import RawMeta
from ansel_tpu_torch.io.xmp import XMPDocument, parse_xmp, write_xmp
from ansel_tpu_torch.kernels import (_build, bgrid, diffuse, eaw, iir,
                                     markesteijn, nlm, rcd, sepblur, warp)
from ansel_tpu_torch.kernels import highlights_harmonic as hh
from ansel_tpu_torch.kernels import highlights_laplacian as hl_lap
from ansel_tpu_torch.kernels import pointwise as pw
from ansel_tpu_torch.kernels import unet
from ansel_tpu_torch.io import lightroom
from ansel_tpu_torch.library.collections import Collection
from ansel_tpu_torch.library.crawler import crawl
from ansel_tpu_torch.library.db import Library
from ansel_tpu_torch.library.export import batch_export
from ansel_tpu_torch.library.mipmap import MipmapCache
from ansel_tpu_torch.library.piwigo import PiwigoClient, store_piwigo
from ansel_tpu_torch.ops import rawdenoiseai as ai
from ansel_tpu_torch.ops.base import pad_to
from ansel_tpu_torch.ops.demosaic import DemosaicParams
from ansel_tpu_torch.pipeline.blend import BlendParams
from ansel_tpu_torch.pipeline import engine
from ansel_tpu_torch.pipeline import export as export_mod
from ansel_tpu_torch.pipeline import histogram as scopes
from ansel_tpu_torch.parallel import mesh as mesh_mod
from ansel_tpu_torch.parallel.batch import (BatchPipeline, make_mesh,
                                            spatial_sharded_pipe)
from ansel_tpu_torch.parallel.spatial import SpatialPipeline
from ansel_tpu_torch.pipeline.export import ExportSettings, export_image
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
LAUNCHES13 = dict(NO_LAUNCHES, rcd=1, chain=4, sepblur=10, iir=2)
STAGES13 = ["rawprepare", "temperature", "highlights", "rawdenoise",
            "demosaic", "spots", "retouch", "exposure", "exposure",
            "colorin", "channelmixerrgb", "colorbalancergb", "filmicrgb",
            "_convert", "tonecurve", "colorcontrast", "_convert", "velvia",
            "_convert", "vibrance", "colorzones", "_convert", "colorout"]
# run steps: the RAW blend, the feathered ellipse, the raster consumer,
# the group mask and the details slider on the spatial path
KINDS13 = ["stage"] * 3 + ["blend"] + ["stage"] * 3 + ["blend", "chain",
                                                       "blend", "chain",
                                                       "blend", "chain",
                                                       "blend", "chain"]
# config 14: RCD, the chain three times ([exposure], [channelmixerrgb],
# [filmicrgb]: programs 2, 17 and 12 of pointwise.FIXED); the ICC
# profiles, the two LUTs and the painted layer in torch between them
LAUNCHES14 = dict(NO_LAUNCHES, rcd=1, chain=3)
PROGRAMS14 = {2: 1, 17: 1, 12: 1}
STAGES14 = ["rawprepare", "temperature", "highlights", "demosaic",
            "exposure", "colorin", "channelmixerrgb", "lut3d", "lut3d",
            "drawlayer", "filmicrgb", "colorout"]
KINDS14 = ["stage"] * 4 + ["chain", "stage", "chain"] + ["stage"] * 3 \
    + ["chain", "stage"]
PIPE14_REPEATS = 5
# the fast pipes on config 1's history: PPG (PREVIEW) or bilinear
# (THUMBNAIL at FAST_SCALE) in torch, then config 1's chain (program 0)
LAUNCHES_FAST = dict(NO_LAUNCHES, chain=1)
FAST_SCALE = 0.25
# config 15: HARMONIC highlights (the guided Laplacian's 30 iterations x
# 2 passes x 6 scales of sepblur, then the dome core in torch), RCD under
# the dual blend (VNG4, the detail mask, green equilibration and colour
# smoothing in torch), config 1's chain (program 0)
LAUNCHES15 = dict(NO_LAUNCHES, rcd=1, chain=1, sepblur=360)
STAGES15 = ["rawprepare", "temperature", "highlights", "demosaic",
            "exposure", "colorin", "channelmixerrgb", "filmicrgb",
            "colorout"]
PIPE15_REPEATS = 5
# the clipped shares config 15's mosaic must have: every channel's and
# the all-clip cells' at least CLIP15_MIN (the per-channel domes and the
# all-clip core both fire), the all-clip cells' under CLIP15_ALL_MAX
CLIP15_MIN, CLIP15_ALL_MAX = 0.01, 0.40
# config 16: denoiseprofile's wavelets with its automatic profile (the
# EAW kernel, 7 scales), [exposure, colorin] (program 11), diffuse at 8
# scales (the XLA form in torch: sepblur at dilations 1-128), colorequal
# and colorprimaries (host CLUTs, torch), [filmicrgb v5, colorout] (the
# spline opcode's program), borders and watermark in torch
LAUNCHES16 = dict(NO_LAUNCHES, rcd=1, chain=2, eaw=7, sepblur=8)
PROGRAMS16 = {pw.FIXED.index(((pw.OP_EXPOSURE, 0), (pw.OP_MATRIX, 2))): 1,
              pw.FIXED.index(((pw.OP_FILMIC_SPLINE, 0),
                              (pw.OP_COLOROUT, 57))): 1}
SPLINE_ALONE = pw.FIXED.index(((pw.OP_FILMIC_SPLINE, 0),))
STAGES16 = ["rawprepare", "temperature", "highlights", "demosaic",
            "denoiseprofile", "exposure", "colorin", "diffuse",
            "colorprimaries", "colorequal", "filmicrgb", "colorout",
            "borders", "watermark"]
KINDS16 = ["stage"] * 5 + ["chain"] + ["stage"] * 3 + ["chain"] \
    + ["stage"] * 2
PIPE16_REPEATS = 5
OPS16_REPEATS = 2
# [nn]: rawdenoiseai alone at 24 MP, (label, architecture, X-Trans): the
# single-scale net and the multi-scale net with its anchor (bins of 4) on
# config 1's Bayer mosaic, the multi-scale net (bins of 6) on config 4's
# X-Trans mosaic; then the card against the CPU on a crop of NN_CROP at
# CROP_BAYER's or CROP_XTRANS's corner, handed to the op as the whole frame
NN_CASES = (("unet", "unet", False), ("unet-ms", "unet-ms", False),
            ("unet-ms-xtrans", "unet-ms", True))
NN_CROP = (512, 768)
NN_REPEATS = 3
# the card (cuDNN in IEEE float32) against the CPU (oneDNN) on the mosaic
# in [0, 1]: float32 convolutions summed in other orders, the anchor's
# block sums; a few ulps of the mosaic.  It does not separate TF32, which
# moves the crop by less (~6e-7): the spy on cuDNN's setting
# (`conv_precisions`) and UNET_REL_TOL on the net alone hold the precision
NN_TOL = 1e-6
# the U-Net's output alone on the card against the CPU, relative to its
# largest value: float32 sums in other orders (TF32's 10-bit mantissa
# would part them by ~1e-3)
UNET_REL_TOL = 1e-5
# a net that resolved moves the mosaic by more than this (random weights
# of scale 0.05 move it by ~1e-4)
NN_MOVED = 1e-6
# config 17: config 16's noisy mosaic, rawdenoiseai (its multi-scale net),
# config 1's develop (RCD, program 0)
LAUNCHES17 = dict(NO_LAUNCHES, rcd=1, chain=1)
# config 18 (the multi-device paths): (a) RCD and config 1's chain once an
# image; (b) and (c) each kernel of the single pipe once a shard
LAUNCHES18A = dict(NO_LAUNCHES, rcd=configs.BATCH18, chain=configs.BATCH18)
SPATIAL18_TOL = 1.0 / 255.0
SHARDED18_TOL = 1e-5     # the JAX package's own gate for spatial sharding
# config 19, the Lightroom roll: on each image its demosaic, clipping's
# map, two interpreted chains ([exposure .. colorzones], [_convert ..
# colorout]) and grain's three blurs between them
LAUNCHES19 = dict(NO_LAUNCHES, rcd=1, markesteijn=1, warp=2, chain=4,
                  sepblur=6)
PIWIGO19 = ["pwg.session.login", "pwg.session.getStatus",
            "pwg.categories.getList", "pwg.categories.add",
            "pwg.images.addSimple", "pwg.images.uploadCompleted",
            "pwg.images.addSimple", "pwg.images.uploadCompleted"]
STAGES17 = ["rawprepare", "rawdenoiseai", "temperature", "highlights",
            "demosaic", "exposure", "colorin", "channelmixerrgb",
            "filmicrgb", "colorout"]
PIPE17_REPEATS = 5
# [scopes]: stats' means on the card against the CPU's (float32 sums of
# 24 M values in other orders)
SCOPE_MEAN_TOL = 1e-5
SCOPE_REPEATS = 5
# [generate-cache]: images 1-4 of config 5's library, levels 0-2
GENERATE_CACHE_IMGS = 4
# [demosaic-methods] and [highlight-modes]: one step alone at the full
# frame, then the card against the CPU on a crop (Bayer 256 x 384 at an
# even corner, X-Trans 240 x 384 at a corner on the 6-pixel period)
CROP_BAYER = (1800, 2800, 256, 384)
CROP_XTRANS = (1800, 2796, 240, 384)
METHOD_REPEATS = 3
# the card against the CPU on the same crop through the same code: CUDA
# divides by a Python float as a product with its reciprocal and its exp,
# log and pow round otherwise than the CPU's by an ulp, so values part by
# rounding (CROP_MEAN_TOL of the output's magnitude on average); where a
# method decides by comparing two such values (AMaZE's and LMMSE's
# direction tests, VNG's threshold, the median networks) an ulp may flip
# the decision at a pixel, so the largest difference is bounded by
# CROP_MAX_TOL and the pixels beyond CROP_PART_TOL by CROP_SHARE
CROP_MEAN_TOL, CROP_MAX_TOL = 1e-6, 5e-2
CROP_PART_TOL, CROP_SHARE = 1e-4, 1e-3
BOX9 = 2048
NOISE_SIGMA = 200.0  # sensor units of 16383: a high-ISO mosaic
HOT8 = 1024          # hot photosites of config 8's frame, at the white point
REPEATS = 10         # kernel timings
PLAIN_REPEATS = 2    # plain twins at 24 MP take up to 0.6 s each
PIPE2_REPEATS = 3
PIPE3_REPEATS = 3
PIPE4_REPEATS = 10
PIPE12_REPEATS = 5
PIPE13_REPEATS = 5
BLEND_REPEATS = 5
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
             # config 18's first chain on a shard's window runs config 7's
             # first program (6); config 7's count, not recounted on
             # config 18's pixels (its second chain runs the interpreter)
             (18, 0): (183, 6),
             (10, 0): (491, 28), (10, 1): (4028, 152), (11, 0): (2231, 88),
             # config 13's chains, their blend records inside
             (13, 0): (4045, 163), (13, 1): (63, 0), (13, 2): (183, 6),
             (13, 3): (924, 18),
             # each grading opcode alone on config 10's chain inputs
             # (`--opcodes`), colorbalancergb in dt UCS (1) and JzAzBz (0)
             (10, "colorbalancergb", 1): (1927, 72),
             (10, "colorbalancergb", 0): (1961, 59),
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
             (11, "profile_gamma", 0): (216, 9),
             (11, "profile_gamma", 1): (273, 6),
             (11, "profile_gamma", 2): (135, 3),
             (11, "colorchecker"): (390, 0),
             # config 12: [exposure, colorin], filmicrgb's AgX alone
             # after its highlight reconstruction, to Lab, from Lab +
             # colorout (config 3's program on config 12's pixels)
             (12, 0): (21, 0), (12, 1): (666, 39), (12, 2): (183, 6),
             (12, 3): (219, 3),
             # config 14: [exposure], [channelmixerrgb], [filmicrgb]
             (14, 0): (6, 0), (14, 1): (247, 15), (14, 2): (672, 39),
             # config 15: config 1's program on its clipped, reconstructed
             # frame
             (15, 0): (1093, 57),
             # the fast pipes run config 1's program on their PPG and
             # bilinear pixels: config 1's count, not recounted on them
             ("preview", 0): (1095, 57), ("thumbnail", 0): (1095, 57),
             # config 16: [exposure, colorin], [filmicrgb v5, colorout];
             # opcode 33 alone on the second chain's input per colour
             # science and preserve method, and after a reconstruction
             (16, 0): (21, 0), (16, 1): (995, 49),
             (16, "filmic-spline", 0, 0): (299, 16),
             (16, "filmic-spline", 0, 1): (232, 15),
             (16, "filmic-spline", 0, 2): (234, 15),
             (16, "filmic-spline", 0, 3): (259, 17),
             (16, "filmic-spline", 0, 4): (247, 17),
             (16, "filmic-spline", 0, 5): (254, 17),
             (16, "filmic-spline", 1, 0): (293, 16),
             (16, "filmic-spline", 1, 1): (232, 15),
             (16, "filmic-spline", 1, 2): (234, 15),
             (16, "filmic-spline", 1, 3): (259, 17),
             (16, "filmic-spline", 1, 4): (247, 17),
             (16, "filmic-spline", 1, 5): (254, 17),
             (16, "filmic-spline", 2, 0): (293, 16),
             (16, "filmic-spline", 2, 1): (232, 15),
             (16, "filmic-spline", 2, 2): (234, 15),
             (16, "filmic-spline", 2, 3): (259, 17),
             (16, "filmic-spline", 2, 4): (247, 17),
             (16, "filmic-spline", 2, 5): (254, 17),
             (16, "filmic-spline", 3, 0): (617, 36),
             (16, "filmic-spline", 3, 1): (671, 40),
             (16, "filmic-spline", 3, 2): (674, 40),
             (16, "filmic-spline", 3, 3): (686, 42),
             (16, "filmic-spline", 3, 4): (678, 41),
             (16, "filmic-spline", 3, 5): (684, 42),
             (16, "filmic-spline", 4, 0): (839, 46),
             (16, "filmic-spline-rec"): (738, 42),
             # config 17: config 1's program on its denoised frame;
             # config 5: config 1's program on its roll's X-Trans image,
             # then on its Bayer image
             (17, 0): (1095, 57), (5, 0): (1093, 57), (5, 1): (1095, 57)}
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


def check_warp_clip(calls, record, key="warp-clip", tag="[warp-clip]"):
    """clipping's map on the (3, 6016, 4000) flipped RGB config 9's pipe
    hands the warp (a window of it, as the ROI walk cuts it), against the
    twin bit for bit, and grid_sample on the same source coordinates as
    the yardstick; into record[key]."""
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
    record[key] = dict(max_abs_err=mx, ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
    print(f"{tag} {tuple(x.shape)} -> (3, {oh}, {ow}) clipping's map "
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


def prng_draws():
    """Config 12's draws at its shapes: [(label, draw, its arguments)]."""
    return [
        ("dither uniform", prng.uniform, (prng.PRNGKey(353), (3, H, W))),
        ("grain normal", prng.normal, (prng.PRNGKey(773), (H, W))),
        ("HR normal", prng.normal, (prng.PRNGKey(0), (3, H, W))),
        ("censorize uniform", prng.uniform,
         (prng.PRNGKey(1259), (3, H, W), -0.5, 0.5)),
        ("crystgrain randint", prng.randint,
         (prng.PRNGKey(0x5EED), (H, W), 0, 4)),
    ]


def prng_on_cpu():
    """prng_draws() on the CPU (~30 s: a host thread makes them while the
    card runs the earlier phases)."""
    return [fn(*args) for _, fn, args in prng_draws()]


def check_prng(card, cpu):
    """JAX's generator on the card against the same calls on the CPU
    (`cpu`: prng_on_cpu()'s future) at config 12's shapes: the keys and
    splits, the bits of each uniform and randint draw, the normal draws
    within NORMAL_TOL; each draw's device ms."""
    key = prng.PRNGKey(0x5EED)
    expect(prng.split(key, 30, device="cuda") == prng.split(key, 30),
           "split on the card differs from the host's")
    rows = []
    for (label, fn, args), want in zip(prng_draws(), cpu.result()):
        got = fn(*args, device="cuda").cpu()
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


def sepblur_per_image(blurs):
    """Each (x, taps, d, count) blur of an image ((C, H, W) or (H, W), any
    odd tap count): kernel vs twin bit for bit, device ms of the kernel,
    the twin and a depthwise F.conv2d of the taps' dilated outer product,
    and the byte bound.  -> (rows, largest difference, {ms, plain_ms,
    library_ms, bound_ms} summed by the counts, bound_by, the last x)."""
    rows, err = [], 0.0
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for x, taps, d, count in blurs:
            got = sepblur.sep_blur(x, taps, d)
            want = sepblur.sep_blur_reference(x, taps, d)
            mx, _ = compare(got, want)
            expect(torch.equal(got, want), f"sepblur d={d}: max {mx}")
            err = max(err, mx)
            del got, want
            planes = x[None] if x.dim() == 3 else x[None, None]
            n, c = len(taps), planes.shape[1]
            k = torch.tensor(taps, device=x.device, dtype=torch.float32)
            weight = torch.outer(k, k).expand(c, 1, n, n).contiguous()
            xp = F.pad(planes, ((n // 2) * d,) * 4, mode="replicate")
            ms = median_ms(lambda: sepblur.sep_blur(x, taps, d))
            plain_ms = median_ms(
                lambda: sepblur.sep_blur_reference(x, taps, d), PLAIN_REPEATS)
            lib_ms = median_ms(lambda: F.conv2d(xp, weight, dilation=d,
                                                groups=c))
            del xp
            b_ms, b_by = bound(2 * nbytes(x),
                               FLOPS_SEPBLUR_PER_TAP * len(taps) * x.numel())
            for key_, v in (("ms", ms), ("plain_ms", plain_ms),
                            ("library_ms", lib_ms), ("bound_ms", b_ms)):
                tot[key_] += count * v
            rows.append(f"d={d} x{count} {ms:.4f}/{plain_ms:.3f}/"
                        f"{lib_ms:.3f}")
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    return rows, err, tot, b_by, x


def check_sepblur_hr(calls, record):
    """The reconstruction's B3 blurs of (3, 4000, 6016) at dilations 1 to
    256 (the two-pass form from 256), `sepblur_per_image`; the image's 36
    launches summed by their counts."""
    rows, err, tot, b_by, x = sepblur_per_image(
        (x, taps, d, calls["counts"][(n, d)])
        for (n, d), (x, taps, _) in sorted(calls["sepblur"].items())
        if n == 5)
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


def captured13(pipe, raw_dev):
    """Run config 13 once on a device-resident raw and keep the arguments
    of its four chain calls."""
    calls, real = [], pw.pointwise_chain

    def ch(*args):
        calls.append(args)
        return real(*args)

    with swapped([(pw, "pointwise_chain", ch)]):
        pipe.run_padded(raw_dev)
    expect(len(calls) == LAUNCHES13["chain"],
           f"unexpected config-13 chain calls {len(calls)}")
    return calls


def stage_input13(pipe, raw_dev, name):
    """The input of config 13's first stage called `name`, from the
    pipe's own run (the raster side-band carried)."""
    i = STAGES13.index(name)
    return pipe.pipe.trace_fn(0, i)(raw_dev, pipe.coeffs[:i], {})


def check_blend_modes(card, record, pipe, raw_dev):
    """Each case of configs.blend_cases() (every blend mode in Lab and in
    scene RGB, every mask class) as a chain of keep, a 3 x 3 matrix and
    blend records through the interpreter on config 13's chain inputs at
    24 MP: the scene RGB cases on channelmixerrgb's input, the Lab ones
    on tonecurve's.  Kernel vs twin (bit-equal, else the largest
    difference and the share of values that differ), device ms of both;
    the bound is the bytes (the three planes read and written)."""
    inputs = {4: stage_input13(pipe, raw_dev, "channelmixerrgb"),
              2: stage_input13(pipe, raw_dev, "tonecurve")}
    rows, worst, equal = [], 0.0, 0
    for label, cst, kw in configs.blend_cases():
        x = inputs[cst]
        chain = configs.blend_case_chain(cst, kw, x.device)
        got = pw.pointwise_chain(x, chain)
        want = pw.pointwise_chain_reference(x, chain)
        expect(torch.equal(torch.isnan(got), torch.isnan(want)),
               f"blend {label}: NaN where the twin has none")
        d = (got - want).abs().nan_to_num(0.0)
        mx, mean = d.max().item(), d.mean().item()
        share = (d > 0).float().mean().item()
        scale = max(1.0, want.nan_to_num(0.0).abs().max().item())
        del got, want, d
        expect(mx <= CHAIN_MAX_TOL * scale and mean <= CHAIN_MEAN_TOL * scale,
               f"blend {label}: max {mx}, mean {mean} (x {scale:.3g})")
        equal += mx == 0.0
        worst = max(worst, mx / scale)
        ms = median_ms(lambda: pw.pointwise_chain(x, chain), BLEND_REPEATS)
        plain_ms = median_ms(lambda: pw.pointwise_chain_reference(x, chain),
                             1)
        b_ms, b_by = bound(2 * nbytes(x))
        rows.append(dict(case=label, max_abs_err=mx, differ=share, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by))
        print(f"[blend-modes] {label} on {tuple(x.shape)}: "
              + ("bit-equal" if mx == 0.0 else
                 f"max {mx:.3g} (x {scale:.3g}), {share:.2e} of values "
                 "differ") + f" | kernel {ms:.4f} ms, plain {plain_ms:.1f} "
              f"ms, bound {b_ms:.4f} ms ({b_by})", flush=True)
    record["blend-modes"] = rows
    print(f"[blend-modes] {len(rows)} cases, {equal} bit-equal, largest "
          f"difference {worst:.3g} of the output's magnitude (tol "
          f"{CHAIN_MAX_TOL:g}) on {card}", flush=True)


def step_times(pipe, raw_dev):
    """Device ms of each run step of a pipe (CUDA events, median of 3,
    the raster side-band and raw-detail plane carried from the steps
    before)."""
    out = []
    x, carry = raw_dev, {}
    for step in pipe.steps:
        kind, i, j, _ = step
        times = []
        for _ in range(3):
            c = dict(carry, masks=dict(carry.get("masks", {})))
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            y = pipe.pipe.run_steps(x, [step], c)
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        carry = c
        names = "+".join(s.name for s in pipe.pipe.stages[i:j])
        out.append((f"{kind} {names}", float(np.median(times))))
        x = y
    return out


def write_sidecar13(path):
    write_xmp(path, XMPDocument(history=configs.history(13),
                                masks=configs.forms(13)))


def run_cli(bundle, sidecar, png):
    """`python -m ansel_tpu_torch.cli` on a raw bundle and a sidecar to a
    16-bit PNG in a new process; -> its wall seconds."""
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "ansel_tpu_torch.cli", bundle, sidecar, png,
         "--bpp", "16", "--no-icc", "-v"],
        capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t
    expect(proc.returncode == 0,
           f"cli exit {proc.returncode}: {proc.stderr[-2000:]}")
    return wall


def run_config13(card, record, raw, raw_dev, meta, phases, tmp):
    """Config 13 at 24 MP, local edits on config 1's develop (a raw
    denoise under a drawn gradient, spots, a wavelet retouch, a feathered
    ellipse, parametric and hue-family blends on the chains, a group mask
    with a wide blur, the details slider, the raster side-band): through
    the user's entry point with launches counted, against the composed
    twins; its chains on the arguments the pipe hands them; every blend
    mode and mask class as a record; each step's device time, the pipe's
    rate and peak memory; then its sidecar exported through `python -m
    ansel_tpu_torch.cli` against the in-process export."""
    pipe = port.compile_pipeline(meta, configs.history(13),
                                 forms=configs.forms(13))
    stages = [s.name for s in pipe.pipe.stages]
    expect(stages == STAGES13, f"unexpected config-13 plan {stages}")
    expect([k for k, *_ in pipe.steps] == KINDS13,
           f"unexpected config-13 steps {[k for k, *_ in pipe.steps]}")
    with timed(phases, "pipe13 vs plain"):
        reset_launches()
        out = pipe.output_array(raw)
        launches = read_launches()
        programs, maps = read_split()
        expect(launches == LAUNCHES13, f"config-13 launches {launches}")
        expect(len(programs) == 4 and -1 not in programs and not maps,
               f"config-13 programs {programs}, warp maps {maps}")
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
        pipe_mean = float(np.abs(out - plain).mean())
        expect(pipe_err <= PIPE_TOL, f"config 13 vs plain: max {pipe_err}")
        del plain
    with timed(phases, "chain13"):
        calls = captured13(pipe, raw_dev)
        names = [g for g in pipe.fused_groups()]
        for j, row in enumerate(check_chains(13, calls, names)):
            record[f"chain13.{j}"] = row
        del calls
    with timed(phases, "blend-modes"):
        check_blend_modes(card, record, pipe, raw_dev)
    with timed(phases, "pipe13 timing"):
        steps = step_times(pipe, raw_dev)
        per_img = time_pipe(pipe, raw_dev, PIPE13_REPEATS)
        peak, held = pipe_peak(pipe, raw_dev)
    print(f"[pipe13] config 13 {H}x{W}: {len(stages)} stages, chains "
          f"{pipe.fused_groups()}, launches {launches}, vs plain max "
          f"{pipe_err:.3g} mean {pipe_mean:.3g} (tol 1/255), range "
          f"[{out.min():.3g}, {out.max():.3g}] | {1.0 / per_img:.2f} img/s, "
          f"{per_img * 1e3:.2f} ms/img (device-resident input, "
          f"{PIPE13_REPEATS} repeats after 2 warm-ups), peak device memory "
          f"{peak:.3f} GB ({held:.3f} GB held before) | steps (device ms): "
          + ", ".join(f"{n} {t:.3f}" for n, t in steps) + f" on {card}",
          flush=True)
    sidecar = os.path.join(tmp, "config13.xmp")
    png = os.path.join(tmp, "config13.png")
    bundle = os.path.join(tmp, "config13.npz")
    with timed(phases, "pipe13 cli"):
        write_sidecar13(sidecar)
        save_raw(bundle, raw, meta)
        cli_s = run_cli(bundle, sidecar, png)
        exported = export_image(raw, meta, xmp_path=sidecar)
        expect(np.array_equal(read_png16(png), to_uint16(exported)),
               "the CLI's PNG differs from the in-process export")
        side_err = float(np.abs(exported - out).max())
        expect(side_err <= PIPE_TOL,
               f"the sidecar's export vs the render: max {side_err}")
    print(f"[pipe13] config 13's sidecar (history, blends and {len(configs.forms(13))} "
          f"forms) through `python -m ansel_tpu_torch.cli` to a 16-bit PNG: "
          f"{cli_s:.2f} s wall (a new process: start, kernels loaded, raw "
          f"bundle, pipe, PNG), equal to to_uint16 of the in-process "
          f"export, which is within {side_err:.3g} of the render (filmicrgb's "
          f"default params in float32) on {card}", flush=True)
    return launches


def captured14(pipe, raw_dev):
    """Run config 14 once on a device-resident raw and keep the arguments
    of its three chain calls and of its RCD call."""
    chains, demosaics = [], []
    real_chain, real_rcd = pw.pointwise_chain, rcd.rcd_demosaic

    def ch(*args):
        chains.append(args)
        return real_chain(*args)

    def rc(*args):
        demosaics.append(args)
        return real_rcd(*args)

    with swapped([(pw, "pointwise_chain", ch), (rcd, "rcd_demosaic", rc)]):
        pipe.run_padded(raw_dev)
    expect(len(chains) == LAUNCHES14["chain"] and len(demosaics) == 1,
           f"unexpected config-14 calls: {len(chains)} chains, "
           f"{len(demosaics)} RCD")
    return chains, demosaics[0]


def run_config14(card, record, raw, raw_dev, meta, phases, tmp, seed):
    """Config 14 at 24 MP, config 1's develop with a look shared as a
    style (an ICC input profile, a .cube, inline compressed-CLUT keypoints,
    a painted layer, a B2A output profile), its fixtures written from
    `seed` (`configs.history_files`), its sidecar and PNG to `tmp`:
    through the user's entry point with launches counted, against the
    composed twins; RCD and its three
    chains on the arguments the pipe hands them; each step's device time,
    the pipe's rate and peak memory; then the merged history's sidecar
    through `python -m ansel_tpu_torch.cli` against the in-process
    export."""
    with contextlib.ExitStack() as stack:
        with timed(phases, "pipe14 fixtures"):
            hist = stack.enter_context(configs.history_files(14, seed))
            pipe = port.compile_pipeline(meta, hist)
        stages = [s.name for s in pipe.pipe.stages]
        expect(stages == STAGES14, f"unexpected config-14 plan {stages}")
        expect([k for k, *_ in pipe.steps] == KINDS14,
               f"unexpected config-14 steps {[k for k, *_ in pipe.steps]}")
        with timed(phases, "pipe14 vs plain"):
            reset_launches()
            out = pipe.output_array(raw)
            launches = read_launches()
            programs, maps = read_split()
            expect(launches == LAUNCHES14, f"config-14 launches {launches}")
            expect(programs == PROGRAMS14 and not maps,
                   f"config-14 programs {programs}, warp maps {maps}")
            launches["programs"] = programs
            expect(out.shape == (3, H, W), f"output shape {out.shape}")
            expect(bool(np.isfinite(out).all()) and out.min() >= 0.0
                   and out.max() <= 1.0,
                   "output not finite or outside [0, 1]")
            reset_launches()
            with plain_twins():
                plain = pipe.output_array(raw)
            expect(all(v == 0 for v in read_launches().values()),
                   f"the plain composition launched kernels: "
                   f"{read_launches()}")
            pipe_err = float(np.abs(out - plain).max())
            pipe_mean = float(np.abs(out - plain).mean())
            expect(pipe_err <= PIPE_TOL,
                   f"config 14 vs plain: max {pipe_err}")
            del plain
        with timed(phases, "chain14"):
            calls, (mosaic, cfa, scaler) = captured14(pipe, raw_dev)
            got = rcd.rcd_demosaic(mosaic, cfa, scaler)
            expect(torch.equal(got, rcd.rcd_demosaic_reference(
                mosaic, cfa, scaler)), "config 14's RCD: not bit-equal")
            print(f"[pipe14] RCD on config 14's mosaic "
                  f"{tuple(mosaic.shape)}: bit-equal to its twin",
                  flush=True)
            del got, mosaic
            for j, row in enumerate(check_chains(14, calls,
                                                 pipe.fused_groups())):
                record[f"chain14.{j}"] = row
            del calls
        with timed(phases, "pipe14 timing"):
            steps = step_times(pipe, raw_dev)
            per_img = time_pipe(pipe, raw_dev, PIPE14_REPEATS)
            peak, held = pipe_peak(pipe, raw_dev)
        print(f"[pipe14] config 14 {H}x{W}: {len(stages)} stages, chains "
              f"{pipe.fused_groups()}, launches {launches}, vs plain max "
              f"{pipe_err:.3g} mean {pipe_mean:.3g} (tol 1/255), range "
              f"[{out.min():.3g}, {out.max():.3g}] | {1.0 / per_img:.2f} "
              f"img/s, {per_img * 1e3:.2f} ms/img (device-resident input, "
              f"{PIPE14_REPEATS} repeats after 2 warm-ups), peak device "
              f"memory {peak:.3f} GB ({held:.3f} GB held before) | steps "
              "(device ms): " + ", ".join(f"{n} {t:.3f}" for n, t in steps)
              + f" on {card}", flush=True)
        sidecar = os.path.join(tmp, "config14.xmp")
        png = os.path.join(tmp, "config14.png")
        bundle = os.path.join(tmp, "config14.npz")
        with timed(phases, "pipe14 cli"):
            write_xmp(sidecar, XMPDocument(history=hist))
            save_raw(bundle, raw, meta)
            cli_s = run_cli(bundle, sidecar, png)
            exported = export_image(raw, meta, xmp_path=sidecar)
            expect(np.array_equal(read_png16(png), to_uint16(exported)),
                   "the CLI's PNG differs from the in-process export")
            side_err = float(np.abs(exported - out).max())
            expect(side_err <= PIPE_TOL,
                   f"the sidecar's export vs the render: max {side_err}")
        print(f"[pipe14] config 14's sidecar (config 1 and the style "
              f"merged: {len(hist)} items, seed {seed}) through `python -m "
              f"ansel_tpu_torch.cli` to a 16-bit PNG: {cli_s:.2f} s wall (a "
              "new process: start, kernels loaded, raw bundle, profiles, "
              "LUTs and layer read, pipe, PNG), equal to to_uint16 of the "
              f"in-process export, which is within {side_err:.3g} of the "
              f"render on {card}", flush=True)
    return launches


def demosaic_blob(method):
    """A decoded demosaic params blob (version 4) with `method`: the fast
    pipes' override keeps its method."""
    cls = DemosaicParams
    return port.HistoryItem("demosaic", cls.codec.encode(
        cls(demosaicing_method=method)), version=cls.op_version)


def run_fastpipe(card, record, raw, raw_dev, meta, phases):
    """Config 1's history in the PREVIEW pipe with a `demosaic` item given
    as a dict (planned PPG) and in the THUMBNAIL pipe at FAST_SCALE with a
    method-7 blob (planned bilinear): the planned method, launches, the
    output against the composed twins, the chain against its twin, rate
    and peak memory.  Returns {pipe type: launches}."""
    out_launches = {}
    for pipe_type, item, kw, method in (
            ("preview", port.HistoryItem("demosaic", {}), {}, 0),
            ("thumbnail", demosaic_blob(7), {"scale": FAST_SCALE}, 7)):
        with timed(phases, f"fastpipe {pipe_type}"):
            pipe = port.compile_pipeline(meta, configs.history(1) + [item],
                                         pipe_type=pipe_type, **kw)
            planned = next(s.plan.static[0] for s in pipe.pipe.stages
                           if s.name == "demosaic")
            expect(planned == method and not pipe.pipe.windowed,
                   f"{pipe_type}: planned method {planned}, windowed "
                   f"{pipe.pipe.windowed}")
            reset_launches()
            out = pipe.output_array(raw)
            launches = read_launches()
            programs, _ = read_split()
            expect(launches == LAUNCHES_FAST and programs == {0: 1},
                   f"{pipe_type} launches {launches}, programs {programs}")
            launches["programs"] = programs
            so = pipe.pipe.spec_out
            expect(out.shape == (3, so.height, so.width)
                   and bool(np.isfinite(out).all()) and out.min() >= 0.0
                   and out.max() <= 1.0,
                   f"{pipe_type} output {out.shape} not finite or outside "
                   "[0, 1]")
            with plain_twins():
                plain = pipe.output_array(raw)
            pipe_err = float(np.abs(out - plain).max())
            expect(pipe_err <= PIPE_TOL,
                   f"{pipe_type} vs plain: max {pipe_err}")
            calls, real = [], pw.pointwise_chain

            def ch(*args, _calls=calls, _real=real):
                _calls.append(args)
                return _real(*args)

            with swapped([(pw, "pointwise_chain", ch)]):
                pipe.run_padded(raw_dev)
            (record[f"chain-{pipe_type}"],) = check_chains(
                pipe_type, calls, pipe.fused_groups())
            del calls
            per_img = time_pipe(pipe, raw_dev, REPEATS)
            peak, held = pipe_peak(pipe, raw_dev)
        print(f"[fastpipe] {pipe_type} ({kw or 'scale 1'}): demosaic "
              f"planned {planned} ({'PPG' if planned == 0 else 'bilinear'}),"
              f" output {out.shape}, launches {launches}, vs plain max "
              f"{pipe_err:.3g} (tol 1/255) | {1.0 / per_img:.2f} img/s, "
              f"{per_img * 1e3:.2f} ms/img (device-resident {H}x{W} input, "
              f"{REPEATS} repeats after 2 warm-ups), peak device memory "
              f"{peak:.3f} GB ({held:.3f} GB held before) on {card}",
              flush=True)
        out_launches[pipe_type] = launches
    return out_launches


def check_r14(meta, phases):
    """Config 13's history where a blend would read a side plane on
    another frame (ROADMAP R14): its details-refined vibrance at
    orientation 6 and at scale 0.5, and colour contrast's raster mask
    with a crop after its source (the details slider off): each raises
    ValueError while planning, naming both stages, with nothing uploaded
    to the card."""
    with timed(phases, "r14"):
        no_details = configs.history(13)
        for h in no_details:
            if h.blend_params is not None:
                h.blend_params = dataclasses.replace(h.blend_params,
                                                     details=0.0)
        no_details.insert(5, port.HistoryItem(
            "crop", {"cx": 0.1, "cy": 0.1, "cw": 0.8, "ch": 0.9}))
        cases = (
            ("orientation 6", dataclasses.replace(meta, orientation=6),
             configs.history(13), {}, ("vibrance", "flip")),
            ("scale 0.5", meta, configs.history(13), {"scale": 0.5},
             ("vibrance", "initialscale")),
            ("crop after the raster source", meta, no_details, {},
             ("colorcontrast", "crop")))
        for label, m, hist, kw, (stage, changer) in cases:
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            try:
                port.compile_pipeline(m, hist, forms=configs.forms(13), **kw)
            except ValueError as e:
                msg = str(e)
            else:
                raise AssertionError(f"r14 {label}: planned")
            expect(f"'{stage}'" in msg and f"'{changer}'" in msg,
                   f"r14 {label}: {msg}")
            expect(torch.cuda.memory_allocated() == before,
                   f"r14 {label}: memory reached the card before the refusal")
            print(f"[r14] config 13 at {label}: ValueError while planning, "
                  f"nothing uploaded: {msg}", flush=True)


def captured15(pipe, raw_dev):
    """Run config 15 once on a device-resident raw and keep the arguments
    of its RCD and chain calls and of its sepblur calls (the first at each
    dilation, with each dilation's call count)."""
    calls = {"rcd": [], "chain": [], "sepblur": {}, "counts": {}}
    real_rcd, real_chain = rcd.rcd_demosaic, pw.pointwise_chain
    real_sb = sepblur.sep_blur

    def rc(*args):
        calls["rcd"].append(args)
        return real_rcd(*args)

    def ch(*args):
        calls["chain"].append(args)
        return real_chain(*args)

    def sb(x, taps, d=1):
        calls["sepblur"].setdefault(d, (x, taps, d))
        calls["counts"][d] = calls["counts"].get(d, 0) + 1
        return real_sb(x, taps, d)

    with swapped([(rcd, "rcd_demosaic", rc), (pw, "pointwise_chain", ch),
                  (sepblur, "sep_blur", sb)]):
        pipe.run_padded(raw_dev)
    expect(len(calls["rcd"]) == 1 and len(calls["chain"]) == 1
           and sorted(calls["counts"]) == [1, 2, 4, 8, 16, 32]
           and sum(calls["counts"].values()) == LAUNCHES15["sepblur"],
           f"unexpected config-15 calls: {len(calls['rcd'])} RCD, "
           f"{len(calls['chain'])} chains, sepblur {calls['counts']}")
    return calls


def check_rcd15(call, record):
    """RCD on config 15's mosaic, under the dual blend."""
    check_rcd_call(call, record, "rcd15",
                   "[pipe15] RCD on config 15's mosaic")


def check_rcd_call(call, record, key, tag):
    """RCD on a pipe's (mosaic, cfa, scaler): bit-equal to its twin,
    device ms of both, the bound of config 1's line, into record[key]."""
    mosaic, cfa, scaler = call
    got = rcd.rcd_demosaic(mosaic, cfa, scaler)
    want = rcd.rcd_demosaic_reference(mosaic, cfa, scaler)
    mx, _ = compare(got, want)
    expect(torch.equal(got, want), f"{tag}: max {mx}")
    ms = median_ms(lambda: rcd.rcd_demosaic(mosaic, cfa, scaler))
    plain_ms = median_ms(lambda: rcd.rcd_demosaic_reference(
        mosaic, cfa, scaler), PLAIN_REPEATS)
    b_ms, b_by = bound(nbytes(mosaic, got),
                       instructions=FLOPS_RCD * mosaic.numel(),
                       sfu=MUFU_RCD * mosaic.numel())
    record[key] = dict(max_abs_err=mx, ms=ms, plain_ms=plain_ms,
                       library_ms=None, bound_ms=b_ms, bound_by=b_by)
    print(f"{tag} {tuple(mosaic.shape)}: bit-equal to its twin | kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms "
          f"({b_by})", flush=True)


def check_sepblur15(calls, record):
    """The guided Laplacian's B3 blurs of the (4, 1000, 1504) stacks at
    dilations 1 to 32, `sepblur_per_image`; the image's 360 launches
    summed by their counts."""
    rows, err, tot, b_by, x = sepblur_per_image(
        (x, taps, d, calls["counts"][d])
        for d, (x, taps, _) in sorted(calls["sepblur"].items()))
    n = LAUNCHES15["sepblur"]
    record["sepblur15"] = dict(max_abs_err=err, bound_by=b_by,
                               per_image=tot, launches=n,
                               **{k: v / n for k, v in tot.items()})
    print(f"[pipe15] sepblur in the guided Laplacian, {tuple(x.shape)} B3 "
          f"kernel vs plain: max {err:.3g} (bit-equal) | ms kernel/plain/"
          f"conv2d: {', '.join(rows)} | per image ({n} launches): kernel "
          f"{tot['ms']:.3f} ms, plain {tot['plain_ms']:.1f}, conv2d "
          f"{tot['library_ms']:.3f}, bound {tot['bound_ms']:.3f} ms "
          f"({b_by})", flush=True)


def run_config15(card, record, raw, raw_dev, meta, phases):
    """Config 15 at 24 MP, a back-lit landscape: config 1's mosaic 2 EV
    brighter and clipped at the white level (its clipped shares printed
    and held), HARMONIC highlights, RCD under the dual blend with green
    equilibration and colour smoothing, config 1's develop.  Through the
    user's entry point with launches counted, against the composed twins;
    RCD, sepblur and the chain on the arguments the pipe hands them; each
    step's device time, the pipe's rate and peak memory.  Returns the
    launches and the pipe."""
    raw15 = configs.mosaic15(raw, meta)
    raw15_dev = configs.mosaic15(raw_dev, meta)
    shares = configs.clip_shares(raw15, meta)
    expect(min(shares.values()) >= CLIP15_MIN
           and shares["all"] < CLIP15_ALL_MAX, f"config-15 shares {shares}")
    print(f"[pipe15] config 15's mosaic (config 1's x {configs.GAIN15:g}, "
          "clipped at the white level): photosites at white R "
          f"{shares['R']:.4f}, G {shares['G']:.4f}, B {shares['B']:.4f}; "
          f"2x2 cells with all four at white {shares['all']:.4f} (each at "
          f"least {CLIP15_MIN:g}, the cells under {CLIP15_ALL_MAX:g})",
          flush=True)
    pipe = port.compile_pipeline(meta, configs.history(15))
    stages = [s.name for s in pipe.pipe.stages]
    expect(stages == STAGES15, f"unexpected config-15 plan {stages}")
    expect([k for k, *_ in pipe.steps] == ["stage"] * 4 + ["chain"],
           f"unexpected config-15 steps {[k for k, *_ in pipe.steps]}")
    statics = [pipe.pipe.stages[i].plan.static for i in (2, 3)]
    with timed(phases, "pipe15 vs plain"):
        reset_launches()
        out = pipe.output_array(raw15)
        launches = read_launches()
        programs, _ = read_split()
        expect(launches == LAUNCHES15 and programs == {0: 1},
               f"config-15 launches {launches}, programs {programs}")
        launches["programs"] = programs
        expect(out.shape == (3, H, W), f"output shape {out.shape}")
        expect(bool(np.isfinite(out).all()) and out.min() >= 0.0
               and out.max() <= 1.0, "output not finite or outside [0, 1]")
        reset_launches()
        with plain_twins():
            plain = pipe.output_array(raw15)
        expect(all(v == 0 for v in read_launches().values()),
               f"the plain composition launched kernels: {read_launches()}")
        pipe_err = float(np.abs(out - plain).max())
        pipe_mean = float(np.abs(out - plain).mean())
        expect(pipe_err <= PIPE_TOL, f"config 15 vs plain: max {pipe_err}")
        del plain
    with timed(phases, "pipe15 kernels"):
        calls = captured15(pipe, raw15_dev)
        check_rcd15(calls["rcd"][0], record)
        check_sepblur15(calls, record)
        (record["chain15.0"],) = check_chains(15, calls["chain"],
                                              pipe.fused_groups())
        del calls
    with timed(phases, "pipe15 timing"):
        steps = step_times(pipe, raw15_dev)
        per_img = time_pipe(pipe, raw15_dev, PIPE15_REPEATS)
        peak, held = pipe_peak(pipe, raw15_dev)
    print(f"[pipe15] config 15 {H}x{W}: {len(stages)} stages, highlights "
          f"{statics[0]}, demosaic 0x{statics[1][0]:x} {statics[1][1:]}, "
          f"chains {pipe.fused_groups()}, launches {launches}, vs plain max "
          f"{pipe_err:.3g} mean {pipe_mean:.3g} (tol 1/255), range "
          f"[{out.min():.3g}, {out.max():.3g}] | {1.0 / per_img:.3f} img/s, "
          f"{per_img * 1e3:.1f} ms/img (device-resident input, "
          f"{PIPE15_REPEATS} repeats after 2 warm-ups), peak device memory "
          f"{peak:.3f} GB ({held:.3f} GB held before) | steps (device ms): "
          + ", ".join(f"{n} {t:.3f}" for n, t in steps) + f" on {card}",
          flush=True)
    return launches, pipe, raw15_dev


def stage_alone(meta, raw, params, op="demosaic", device="cuda"):
    """The stage `op` of a pipe planned on one item (op, params) and its
    input on `device` (the card) from the pipe's own stages before it, on
    the host mosaic `raw`: -> (stage, input, its coeffs, the pipe's
    context)."""
    pipe = port.compile_pipeline(meta, [port.HistoryItem(op, dict(params))],
                                 device=device)
    i = [s.name for s in pipe.pipe.stages].index(op)
    raw_dev = torch.from_numpy(pad_to(raw, pipe.pipe.spec_in)).to(device)
    x = pipe.pipe.trace_fn(0, i)(raw_dev, pipe.coeffs[:i])
    return pipe.pipe.stages[i], x, pipe.coeffs[i], pipe.pipe.ctx


def step_device(fn, repeats):
    """(mean device ms of `repeats` calls after one warm-up, CUDA events;
    peak device GB of the timed calls, and what was held before; the last
    output)."""
    out = fn()
    del out
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return (float(np.mean(times)), torch.cuda.max_memory_allocated() / 1e9,
            held / 1e9, out)


def crop_vs_cpu(fn, args, box):
    """`fn` on the card and on the CPU on the same crop of its plane
    arguments (the last two axes), other arguments moved alike: ->
    (max, mean, share beyond CROP_PART_TOL), each of the CPU output's
    magnitude (at least 1), held to the CROP_ tolerances."""
    y0, x0, h, w = box

    def cut(a):
        if torch.is_tensor(a) and a.dim() >= 2:
            return a[..., y0:y0 + h, x0:x0 + w].contiguous()
        return a

    def to_cpu(a):
        if torch.is_tensor(a):
            return a.cpu()
        if isinstance(a, dict):
            return {k: to_cpu(v) for k, v in a.items()}
        return a

    crop = [cut(a) for a in args]
    got = fn(*crop).cpu()
    want = fn(*[to_cpu(a) for a in crop])
    expect(bool(torch.isfinite(got).all()), "crop: non-finite on the card")
    d = (got - want).abs()
    scale = max(1.0, want.abs().max().item())
    mx, mean = d.max().item() / scale, d.mean().item() / scale
    share = (d > CROP_PART_TOL * scale).float().mean().item()
    expect(mx <= CROP_MAX_TOL and mean <= CROP_MEAN_TOL
           and share <= CROP_SHARE,
           f"crop card vs CPU: max {mx:.3g} mean {mean:.3g} share {share:.3g}"
           f" (of {scale:.3g})")
    return mx, mean, share


def with_spec(plan, box):
    """`plan` with its input spec cut to the crop `box` (the stages read
    the frame's size from it)."""
    _, _, h, w = box
    return dataclasses.replace(plan, spec_in=dataclasses.replace(
        plan.spec_in, width=w, height=h, pad_w=w, pad_h=h))


def run_demosaic_methods(card, record, meta, raw, meta4, raw4, phases):
    """Each demosaic branch the JAX package runs as plain XLA, as one
    demosaic step alone on config 1's 24 MP mosaic (RCD alone first, the
    base the post passes and the dual blend add to) and, for X-Trans VNG
    and X-Trans dual (0x3001), on config 4's: device ms (1 warm-up, then
    METHOD_REPEATS timed runs; 1 for AMaZE), peak memory, a finite output
    of the frame's shape, and the card against the CPU on a crop.  X-Trans
    dual launches the Markesteijn kernel: held against its twin there.
    Returns the X-Trans dual step's Markesteijn launches."""
    cases = (("RCD", meta, raw, {"demosaicing_method": 5},
              CROP_BAYER, METHOD_REPEATS),
             ("AMaZE", meta, raw, {"demosaicing_method": 1},
              CROP_BAYER, 1),
             ("LMMSE refine 1", meta, raw,
              {"demosaicing_method": 6, "lmmse_refine": 1}, CROP_BAYER,
              METHOD_REPEATS),
             ("LMMSE refine 4", meta, raw,
              {"demosaicing_method": 6, "lmmse_refine": 4}, CROP_BAYER,
              METHOD_REPEATS),
             ("VNG4", meta, raw, {"demosaicing_method": 2}, CROP_BAYER,
              METHOD_REPEATS),
             ("RCD + green eq 3", meta, raw,
              {"demosaicing_method": 5, "green_eq": 3}, CROP_BAYER,
              METHOD_REPEATS),
             ("RCD + smoothing 2", meta, raw,
              {"demosaicing_method": 5, "color_smoothing": 2}, CROP_BAYER,
              METHOD_REPEATS),
             ("RCD + dual", meta, raw,
              {"demosaicing_method": 5 | 0x2000}, CROP_BAYER,
              METHOD_REPEATS),
             ("X-Trans VNG", meta4, raw4, {"demosaicing_method": 0x1000},
              CROP_XTRANS, METHOD_REPEATS),
             ("X-Trans dual", meta4, raw4,
              {"demosaicing_method": 0x3001}, CROP_XTRANS, METHOD_REPEATS))
    rows, mark_launches = [], 0
    for label, m, r, params, box, repeats in cases:
        with timed(phases, f"demosaic {label}"):
            st, x, c, ctx = stage_alone(m, r, params)

            def step(x_, c_, plan=st.plan, st=st, ctx=ctx):
                return st.op.apply(x_, c_, plan, ctx)

            ms, peak, held, out = step_device(lambda: step(x, c), repeats)
            expect(out.shape == (3,) + tuple(x.shape)
                   and bool(torch.isfinite(out).all()),
                   f"{label}: output {tuple(out.shape)} not finite")
            del out
            if label == "X-Trans dual":
                reset_launches()
                calls, real = [], markesteijn.xtrans_markesteijn

                def mk(*args, _calls=calls, _real=real):
                    _calls.append(args)
                    return _real(*args)

                with swapped([(markesteijn, "xtrans_markesteijn", mk)]):
                    step(x, c)
                mark_launches = read_launches()["markesteijn"]
                expect(len(calls) == 1 and calls[0][2] == 1
                       and mark_launches == 1,
                       f"X-Trans dual: Markesteijn calls {len(calls)}, "
                       f"launches {mark_launches}")
                check_markesteijn_dual(calls[0], record)
                del calls
            plan = with_spec(st.plan, box)
            mx, mean, share = crop_vs_cpu(
                lambda x_, c_, plan=plan, st=st, ctx=ctx:
                st.op.apply(x_, c_, plan, ctx), [x, c], box)
        rows.append(dict(method=label, ms=ms, peak_gb=peak))
        print(f"[demosaic-methods] {label} {params} on "
              f"{tuple(x.shape)}: {ms:.1f} ms (device, {repeats} timed run"
              f"{'s' if repeats > 1 else ''} after 1 warm-up), peak device "
              f"memory {peak:.3f} GB ({held:.3f} GB held before), finite | "
              f"card vs CPU on a {box[2]}x{box[3]} crop: max {mx:.3g} mean "
              f"{mean:.3g}, {share:.3g} of values beyond {CROP_PART_TOL:g} "
              f"(of the output's magnitude) on {card}", flush=True)
        del x
    record["demosaic-methods"] = rows
    return mark_launches


def check_markesteijn_dual(call, record):
    """Markesteijn, 1 pass, as X-Trans dual runs it on config 4's mosaic."""
    check_markesteijn_call(call, record, "markesteijn-dual",
                           "[demosaic-methods] X-Trans dual's Markesteijn "
                           "(1 pass) on")


def check_markesteijn_call(call, record, key, tag):
    """Markesteijn on a pipe's (mosaic, pattern, passes): bit-equal to its
    twin, device ms of both at 1 pass, config 4's bound, into
    record[key]."""
    x, pattern6, passes = call
    got = markesteijn.xtrans_markesteijn(x, pattern6, passes)
    want = markesteijn.xtrans_markesteijn_reference(x, pattern6, passes)
    mx, _ = compare(got, want)
    expect(torch.equal(got, want), f"{tag}: max {mx}")
    del got, want
    ms = median_ms(lambda: markesteijn.xtrans_markesteijn(x, pattern6, 1))
    plain_ms = median_ms(lambda: markesteijn.xtrans_markesteijn_reference(
        x, pattern6, 1), 1)
    b_ms, b_by = bound(4 * nbytes(x),
                       instructions=FLOPS_MARKESTEIJN[1] * x.numel(),
                       sfu=mufu_markesteijn(pattern6, 1) * x.numel())
    record[key] = dict(max_abs_err=mx, ms=ms, plain_ms=plain_ms,
                       library_ms=None, bound_ms=b_ms, bound_by=b_by)
    print(f"{tag} {tuple(x.shape)}: bit-equal to its twin | kernel "
          f"{ms:.3f} ms, plain {plain_ms:.1f} ms, bound {b_ms:.3f} ms "
          f"({b_by})", flush=True)


def run_highlight_modes(card, record, meta, raw, meta4, raw4, pipe15,
                        raw15_dev, phases):
    """LCH and INPAINT alone on config 15's mosaic, INPAINT on config 4's
    X-Trans mosaic clipped the same way, and HARMONIC's dome core alone on
    config 15's highlights input and its Laplacian's output: device ms (1
    warm-up, METHOD_REPEATS timed runs), peak memory, finite, and the card
    against the CPU on a crop."""
    rows = []
    raw15, raw4_15 = configs.mosaic15(raw, meta), configs.mosaic15(raw4, meta4)
    for label, m, r, params, box in (
            ("LCH", meta, raw15, {"mode": 1}, CROP_BAYER),
            ("INPAINT", meta, raw15, {"mode": 2}, CROP_BAYER),
            ("X-Trans INPAINT", meta4, raw4_15, {"mode": 2}, CROP_XTRANS)):
        with timed(phases, f"highlights {label}"):
            st, x, c, ctx = stage_alone(m, r, params, "highlights")
            ms, peak, held, out = step_device(
                lambda: st.op.apply(x, c, st.plan, ctx), METHOD_REPEATS)
            moved = (out - torch.minimum(x, c["clip"])).abs().max().item()
            expect(bool(torch.isfinite(out).all()) and moved > 0.0,
                   f"{label}: not finite, or the clamp ({moved})")
            del out
            plan = with_spec(st.plan, box)
            mx, mean, share = crop_vs_cpu(
                lambda x_, c_, plan=plan, st=st, ctx=ctx:
                st.op.apply(x_, c_, plan, ctx), [x, c], box)
        rows.append(dict(mode=label, ms=ms, peak_gb=peak))
        print(f"[highlight-modes] {label} on {tuple(x.shape)}: {ms:.1f} ms "
              f"(device, {METHOD_REPEATS} timed runs after 1 warm-up), peak "
              f"device memory {peak:.3f} GB ({held:.3f} GB held before), "
              f"finite, {moved:.3g} from the clamp | card vs CPU on a "
              f"{box[2]}x{box[3]} crop: max {mx:.3g} mean {mean:.3g}, "
              f"{share:.3g} of values beyond {CROP_PART_TOL:g} on {card}",
              flush=True)
        del x
    with timed(phases, "highlights HARMONIC core"):
        stage = pipe15.pipe.stages[2]
        x = pipe15.pipe.trace_fn(0, 2)(raw15_dev, pipe15.coeffs[:2])
        clips = pipe15.coeffs[2]["clips"]
        _, scales, iters, noise, solid = stage.plan.static
        cfa = stage.plan.spec_in.cfa
        rec = hl_lap.laplacian_reconstruct(x, clips, cfa, scales, iters,
                                           noise, solid)
        ms, peak, held, out = step_device(
            lambda: hh.harmonic_dome_core(x, rec, clips, cfa),
            METHOD_REPEATS)
        moved = (out - rec).abs().max().item()
        expect(bool(torch.isfinite(out).all()) and moved > 0.0,
               f"HARMONIC core: not finite, or no dome ({moved})")
        del out
        mx, mean, share = crop_vs_cpu(
            lambda x_, r_, c_: hh.harmonic_dome_core(x_, r_, c_, cfa),
            [x, rec, clips], CROP_BAYER)
    rows.append(dict(mode="HARMONIC core", ms=ms, peak_gb=peak))
    print(f"[highlight-modes] HARMONIC's dome core on {tuple(x.shape)} "
          f"(the Laplacian's {iters} iterations before it, untimed): "
          f"{ms:.1f} ms (device, {METHOD_REPEATS} timed runs after 1 "
          f"warm-up), peak device memory {peak:.3f} GB ({held:.3f} GB held "
          f"before), finite, {moved:.3g} from the Laplacian's output | card "
          f"vs CPU on a {CROP_BAYER[2]}x{CROP_BAYER[3]} crop: max {mx:.3g} "
          f"mean {mean:.3g}, {share:.3g} of values beyond "
          f"{CROP_PART_TOL:g} on {card}", flush=True)
    record["highlight-modes"] = rows


def warm_cluts16():
    """Config 16's two 64^3 CLUTs into this process's cache (a host build
    of ~18 s, overlapped with the kernels' build)."""
    meta = configs.meta16(RawMeta(width=W, height=H))
    port.Pipeline(meta, configs.history(16), device="cpu").coeffs()


def captured16(pipe, raw_dev):
    """Run config 16 once on a device-resident raw and keep the arguments
    of its RCD, EAW, sepblur (by dilation) and chain calls."""
    calls = {"rcd": [], "eaw": [], "sepblur": {}, "chain": []}
    real_rcd, real_eaw = rcd.rcd_demosaic, eaw.eaw_dn_coarse
    real_sb, real_chain = sepblur.sep_blur, pw.pointwise_chain

    def keep(name, real):
        return lambda *a: calls[name].append(a) or real(*a)

    def sb(x, taps, d=1):
        calls["sepblur"][d] = (x, taps, d)
        return real_sb(x, taps, d)

    with swapped([(rcd, "rcd_demosaic", keep("rcd", real_rcd)),
                  (eaw, "eaw_dn_coarse", keep("eaw", real_eaw)),
                  (sepblur, "sep_blur", sb),
                  (pw, "pointwise_chain", keep("chain", real_chain))]):
        pipe.run_padded(raw_dev)
    expect(len(calls["rcd"]) == 1 and len(calls["eaw"]) == LAUNCHES16["eaw"]
           and sorted(calls["sepblur"]) == [1 << s for s in range(8)]
           and len(calls["chain"]) == LAUNCHES16["chain"],
           f"unexpected config-16 calls: "
           f"{[(k, len(v)) for k, v in calls.items()]}")
    return calls


def check_kernels16(calls, record):
    """RCD (bit-equal), the seven EAW scales of the automatic profile's
    wavelets (STENCIL_TOL), each against its twin with device ms."""
    check_rcd_call(calls["rcd"][0], record, "rcd16",
                   "[pipe16] RCD on config 16's noisy mosaic")
    check_eaw_calls(calls["eaw"], record, "eaw16",
                    "[pipe16] EAW on the automatic profile's wavelets")


def check_diffuse_wide(card, pipe, calls, raw_dev, record):
    """`[diffuse-wide]`: each sepblur launch of config 16's 8-scale
    decompose against its twin (bit-equal) with device ms, the conv2d
    yardstick and the bound; then the diffuse step's device ms and peak
    memory."""
    rows, err, tot, b_by, x = sepblur_per_image(
        (x, taps, d, 1) for d, (x, taps, _) in sorted(
            calls["sepblur"].items()))
    n = LAUNCHES16["sepblur"]
    record["sepblur16"] = dict(max_abs_err=err, bound_by=b_by,
                               per_image=tot, launches=n,
                               **{k: v / n for k, v in tot.items()})
    i = STAGES16.index("diffuse")
    y = pipe.pipe.trace_fn(0, i)(raw_dev, pipe.coeffs[:i])
    st, c, ctx = pipe.pipe.stages[i], pipe.coeffs[i], pipe.pipe.ctx
    ms, peak, held, out = step_device(
        lambda: st.op.apply(y, c, st.plan, ctx), METHOD_REPEATS)
    expect(bool(torch.isfinite(out).all()), "diffuse-wide: not finite")
    del out, y
    print(f"[diffuse-wide] config 16's diffuse at {st.plan.static[0]} "
          f"scales, {tuple(x.shape)} B3 decompose kernel vs plain: max "
          f"{err:.3g} (bit-equal) | ms kernel/plain/conv2d: "
          f"{', '.join(rows)} | per image ({n} launches): kernel "
          f"{tot['ms']:.3f} ms, plain {tot['plain_ms']:.1f}, conv2d "
          f"{tot['library_ms']:.3f}, bound {tot['bound_ms']:.3f} ms ({b_by}) "
          f"| the step: {ms:.1f} ms (device, {METHOD_REPEATS} timed runs "
          f"after 1 warm-up), peak device memory {peak:.3f} GB ({held:.3f} "
          f"GB held before) on {card}", flush=True)


def spline_rec_call(meta, raw_dev):
    """(x, chain) of filmicrgb v5's one-stage program after its highlight
    reconstruction (`configs.SPLINE_REC16`) on config 1's frame."""
    pipe = port.compile_pipeline(meta, [port.HistoryItem(op, dict(p))
                                        for op, p in configs.SPLINE_REC16])
    calls, real = [], pw.pointwise_chain
    with swapped([(pw, "pointwise_chain",
                   lambda x, c: calls.append((x, c)) or real(x, c))]):
        pipe.run_padded(raw_dev)
    rec = [(x, c) for x, c in calls if c.fixed == SPLINE_ALONE]
    expect(len(rec) == 1, "the reconstruction's spline program did not run")
    return rec[0]


def check_spline_opcode(card, meta, x, rec_call, record):
    """`[opcode] filmic-spline`: opcode 33 alone on config 16's second
    chain input for v1-v4 with each preserve method and v5, then v5's
    one-stage program after a reconstruction: the kernel (the spline's
    specialised program) bit-equal to the interpreter and against the
    twin, device ms of both and of the twin, the OPS_CHAIN bound."""
    jobs = [(key, x_, configs.opcode_chain(meta, name, prm, x_.shape,
                                           x_.device))
            for key, x_, name, prm in configs.spline_jobs(x)]
    jobs.append(((16, "filmic-spline-rec"),) + rec_call)
    rows, worst = [], 0.0
    for key, x_, chain in jobs:
        expect(chain.fixed == SPLINE_ALONE, f"{key}: program {chain.fixed}")
        interpreted = dataclasses.replace(chain, fixed=-1)
        got = pw.pointwise_chain(x_, chain)
        expect(torch.equal(got, pw.pointwise_chain(x_, interpreted)),
               f"{key}: the program differs from the interpreter")
        want = pw.pointwise_chain_reference(x_, chain)
        mx, mean = compare(got, want)
        scale = max(1.0, want.abs().max().item())
        del got, want
        expect(mx <= CHAIN_MAX_TOL * scale and mean <= CHAIN_MEAN_TOL * scale,
               f"opcode {key}: max {mx}, mean {mean}")
        worst = max(worst, mx)
        ms = median_ms(lambda: pw.pointwise_chain(x_, chain))
        interp_ms = median_ms(lambda: pw.pointwise_chain(x_, interpreted))
        plain_ms = median_ms(lambda: pw.pointwise_chain_reference(x_, chain),
                             PLAIN_REPEATS)
        fp32, mufu = OPS_CHAIN[key]
        px = x_[0].numel()
        b_ms, b_by = bound(2 * nbytes(x_), instructions=(fp32 + mufu) * px,
                           sfu=mufu * px)
        label = "/".join(str(k) for k in key[1:])
        rows.append(dict(op=label, max_abs_err=mx, ms=ms,
                         interpreter_ms=interp_ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by))
        print(f"[opcode] {label} on {tuple(x_.shape)}: program "
              f"{chain.fixed}, equal to the interpreter; vs plain "
              + ("bit-equal" if mx == 0.0 else f"max {mx:.3g} mean "
                 f"{mean:.3g}") + f" | kernel {ms:.4f} ms, interpreter "
              f"{interp_ms:.4f} ms, plain {plain_ms:.1f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}; {fp32} float32 + {mufu} MUFU a "
              f"pixel) on {card}", flush=True)
    record["opcodes16"] = rows
    return worst


def run_config16(card, record, raw, meta, phases, tmp):
    """Config 16 at 24 MP, a high-ISO web export: config 1's mosaic with
    the ILCE-7M3's ISO 3200 noise (`configs.mosaic16`, the camera named
    by `configs.meta16`), denoiseprofile's automatic profile, exposure,
    diffuse at 8 scales, colorequal, colorprimaries, filmicrgb v5, a
    border and the ansel.svg signature.  Through the user's entry point
    with launches counted, against the composed twins; its kernels on the
    arguments the pipe hands them (`[diffuse-wide]`, `[opcode]
    filmic-spline`); each step's device time, the pipe's rate and peak
    memory; then its sidecar through `python -m ansel_tpu_torch.cli`
    against the in-process export of the same bundle."""
    with timed(phases, "pipe16 mosaic"):
        raw16 = configs.mosaic16(raw, meta)
        meta16 = configs.meta16(meta)
        pipe = port.compile_pipeline(meta16, configs.history(16))
        raw16_dev = torch.from_numpy(pad_to(raw16, pipe.pipe.spec_in)).cuda()
    stages = [s.name for s in pipe.pipe.stages]
    expect(stages == STAGES16, f"unexpected config-16 plan {stages}")
    expect([k for k, *_ in pipe.steps] == KINDS16,
           f"unexpected config-16 steps {[k for k, *_ in pipe.steps]}")
    so = pipe.pipe.spec_out
    statics = {n: pipe.pipe.stages[STAGES16.index(n)].plan.static
               for n in ("denoiseprofile", "diffuse", "filmicrgb")}
    with timed(phases, "pipe16 vs plain"):
        reset_launches()
        out = pipe.output_array(raw16)
        launches = read_launches()
        programs, _ = read_split()
        expect(launches == LAUNCHES16 and programs == PROGRAMS16,
               f"config-16 launches {launches}, programs {programs}")
        launches["programs"] = programs
        expect(out.shape == (3, so.height, so.width)
               and so.width > W and so.height > H,
               f"output shape {out.shape}")
        expect(bool(np.isfinite(out).all()) and out.min() >= 0.0
               and out.max() <= 1.0, "output not finite or outside [0, 1]")
        reset_launches()
        with plain_twins():
            plain = pipe.output_array(raw16)
        expect(all(v == 0 for v in read_launches().values()),
               f"the plain composition launched kernels: {read_launches()}")
        pipe_err = float(np.abs(out - plain).max())
        pipe_mean = float(np.abs(out - plain).mean())
        expect(pipe_err <= PIPE_TOL, f"config 16 vs plain: max {pipe_err}")
        del plain
    with timed(phases, "pipe16 kernels"):
        calls = captured16(pipe, raw16_dev)
        check_kernels16(calls, record)
        for j, row in enumerate(check_chains(16, calls["chain"],
                                             pipe.fused_groups())):
            record[f"chain16.{j}"] = row
    with timed(phases, "diffuse-wide"):
        check_diffuse_wide(card, pipe, calls, raw16_dev, record)
    with timed(phases, "opcode filmic-spline"):
        raw_dev = torch.from_numpy(raw).cuda()
        worst = check_spline_opcode(card, meta, calls["chain"][1][0],
                                    spline_rec_call(meta, raw_dev), record)
        del calls, raw_dev
    print(f"[opcode] filmic-spline: {len(record['opcodes16'])} cases, "
          f"largest difference from the twin {worst:.3g}", flush=True)
    with timed(phases, "pipe16 timing"):
        steps = step_times(pipe, raw16_dev)
        per_img = time_pipe(pipe, raw16_dev, PIPE16_REPEATS)
        peak, held = pipe_peak(pipe, raw16_dev)
    print(f"[pipe16] config 16 {H}x{W} -> {so.height}x{so.width}: "
          f"{len(stages)} stages, denoiseprofile {statics['denoiseprofile']}"
          f", diffuse {statics['diffuse']}, filmicrgb "
          f"{statics['filmicrgb']}, chains {pipe.fused_groups()}, launches "
          f"{launches}, vs plain max {pipe_err:.3g} mean {pipe_mean:.3g} "
          f"(tol 1/255), range [{out.min():.3g}, {out.max():.3g}] | "
          f"{1.0 / per_img:.3f} img/s, {per_img * 1e3:.1f} ms/img "
          f"(device-resident input, {PIPE16_REPEATS} repeats after 2 "
          f"warm-ups), peak device memory {peak:.3f} GB ({held:.3f} GB held "
          "before) | steps (device ms): "
          + ", ".join(f"{n} {t:.3f}" for n, t in steps) + f" on {card}",
          flush=True)
    del raw16_dev
    sidecar = os.path.join(tmp, "config16.xmp")
    png = os.path.join(tmp, "config16.png")
    bundle = os.path.join(tmp, "config16.npz")
    with timed(phases, "pipe16 cli"):
        write_xmp(sidecar, XMPDocument(history=configs.history(16)))
        save_raw(bundle, raw16, meta16)
        cli_s = run_cli(bundle, sidecar, png)
        braw, bmeta = load_raw(bundle)[:2]
        exported = export_image(braw, bmeta, xmp_path=sidecar)
        expect(np.array_equal(read_png16(png), to_uint16(exported)),
               "the CLI's PNG differs from the in-process export")
        side_err = float(np.abs(exported - out).max())
        expect(side_err <= PIPE_TOL,
               f"the sidecar's export vs the render: max {side_err}")
    print(f"[pipe16] config 16's sidecar through `python -m "
          f"ansel_tpu_torch.cli` to a 16-bit PNG: {cli_s:.2f} s wall (a new "
          "process: start, kernels loaded, raw bundle, the two CLUTs built, "
          "pipe, PNG), equal to to_uint16 of the in-process export of the "
          f"bundle, which is within {side_err:.3g} of the render on {card}",
          flush=True)
    return launches


def run_ops16(card, record, meta, raw, meta4, raw4, phases):
    """`[ops16]`: each op of configs.OPS16 alone on a 24 MP frame (config
    1's mosaic after +0.7 EV; invert's X-Trans case on config 4's): its
    stage's device ms (OPS16_REPEATS after 1 warm-up) and peak memory,
    finite and changed."""
    rows = []
    for label, name, params in configs.OPS16:
        m, r = (meta4, raw4) if label == "invert-xtrans" else (meta, raw)
        with timed(phases, f"ops16 {label}"):
            hist = [port.HistoryItem("exposure", {"exposure": 0.7}),
                    port.HistoryItem(name, dict(params))]
            pipe = port.compile_pipeline(m, hist)
            i = [s.name for s in pipe.pipe.stages].index(name)
            raw_dev = torch.from_numpy(pad_to(r, pipe.pipe.spec_in)).cuda()
            x = pipe.pipe.trace_fn(0, i)(raw_dev, pipe.coeffs[:i])
            del raw_dev
            st, c, ctx = pipe.pipe.stages[i], pipe.coeffs[i], pipe.pipe.ctx
            reset_launches()
            ms, peak, held, out = step_device(
                lambda: st.op.apply(x, c, st.plan, ctx), OPS16_REPEATS)
            launches = {k: v for k, v in read_launches().items() if v}
            expect(not launches, f"ops16 {label}: launched {launches}")
            expect(bool(torch.isfinite(out).all()),
                   f"ops16 {label}: not finite")
            if out.shape == x.shape:
                changed = (out - x).abs().max().item()
            else:
                changed = float(out.shape[-1] - x.shape[-1])
            expect(changed > 1e-3, f"ops16 {label}: output equals input")
            shape = tuple(out.shape)
            del out
        rows.append(dict(op=label, ms=ms, peak_gb=peak))
        print(f"[ops16] {label} alone on {tuple(x.shape)} -> {shape}: "
              f"{ms:.2f} ms (device, {OPS16_REPEATS} timed runs after 1 "
              f"warm-up), peak device memory {peak:.3f} GB ({held:.3f} GB "
              f"held before), finite, changed on {card}", flush=True)
        del pipe, x
    record["ops16"] = rows


# --- rawdenoiseai's U-Net, config 17, the scopes, config 5 ---------------

def tf32_convolutions():
    """The U-Net's convolutions in TF32 (cuDNN's default) for the block:
    what the net would compute without its switch to IEEE float32."""
    return swapped([(unet, "CONV_FP32", "tf32")])


def conv_precisions(fn):
    """fn() with F.conv2d watched: -> (its output, the set of cuDNN's
    float32 convolution settings the calls ran under)."""
    seen = set()
    real = F.conv2d

    def spy(*args, **kw):
        seen.add(torch.backends.cudnn.conv.fp32_precision)
        return real(*args, **kw)

    with swapped([(F, "conv2d", spy)]):
        out = fn()
    return out, seen


def nn_crop(m, r, params, box):
    """rawdenoiseai on the NN_CROP crop of mosaic `r` at `box`, handed to
    the op as the whole frame, on the card (IEEE float32, then TF32) and
    on the CPU: -> (card, card in TF32, CPU outputs, its input on the
    CPU, the settings the card's convolutions ran under)."""
    (y0, x0), (ch, cw) = box, NN_CROP
    crop = np.ascontiguousarray(r[y0:y0 + ch, x0:x0 + cw])
    cmeta = dataclasses.replace(m, width=cw, height=ch)
    st, x, c, ctx = stage_alone(cmeta, crop, params, "rawdenoiseai")
    card, seen = conv_precisions(lambda: st.op.apply(x, c, st.plan, ctx))
    with tf32_convolutions():
        card_tf32 = st.op.apply(x, c, st.plan, ctx)
    st_c, x_c, c_c, ctx_c = stage_alone(cmeta, crop, params, "rawdenoiseai",
                                        device="cpu")
    cpu = st_c.op.apply(x_c, c_c, st_c.plan, ctx_c)
    return card.cpu(), card_tf32.cpu(), cpu, x_c, seen


def unet_vs_cpu(model, seed):
    """The fine net alone on uniform planes of NN_CROP on the card (IEEE
    float32, then TF32) and on the CPU: -> (the card's largest difference
    from the CPU, and TF32's, each relative to the CPU output's largest
    magnitude)."""
    fine = model.stage("fine")
    planes = torch.from_numpy(np.random.default_rng(seed).uniform(
        0.0, 1.0, (fine.in_channels,) + NN_CROP).astype(np.float32))
    want = unet.unet_forward(fine, planes)
    got = unet.unet_forward(fine, planes.cuda()).cpu()
    with tf32_convolutions():
        got_tf32 = unet.unet_forward(fine, planes.cuda()).cpu()
    scale = want.abs().max().item()
    return ((got - want).abs().max().item() / scale,
            (got_tf32 - want).abs().max().item() / scale)


def run_nn(card, record, meta, raw, meta4, raw4, phases, seed):
    """`[nn]`: rawdenoiseai alone at 24 MP for each of NN_CASES (its
    models from `seed` in the op's registry): the step's device ms and
    peak memory, its plan keyed to the model and its output changed; on
    an NN_CROP crop handed to the op as the whole frame, the card against
    the CPU (NN_TOL), the cuDNN setting its convolutions ran under, and
    how far TF32 would have moved the crop."""
    models = {"unet": anselnn.random_unet(seed=seed),
              "unet-ms": anselnn.random_unet_ms(seed=seed)}
    rows = []
    for label, arch, xtrans in NN_CASES:
        name = f"nn-{arch}"
        ai.MODEL_REGISTRY[name] = models[arch]
        m, r, box = ((meta4, raw4, CROP_XTRANS[:2]) if xtrans
                     else (meta, raw, CROP_BAYER[:2]))
        params = {"custom_model": name}
        with timed(phases, f"nn {label}"):
            st, x, c, ctx = stage_alone(m, r, params, "rawdenoiseai")
            expect(st.plan.static == name,
                   f"[nn] {label}: the model did not resolve")
            reset_launches()
            ms, peak, held, out = step_device(
                lambda: st.op.apply(x, c, st.plan, ctx), NN_REPEATS)
            launches = {k: v for k, v in read_launches().items() if v}
            expect(not launches, f"[nn] {label}: launched {launches}")
            expect(bool(torch.isfinite(out).all()), f"[nn] {label}: not "
                   "finite")
            moved = (out - x).abs().max().item()
            expect(moved > NN_MOVED, f"[nn] {label}: output equals input")
            shape = tuple(x.shape)
            del out, x, c
            got, got_tf32, want, x_c, seen = nn_crop(m, r, params, box)
            err = (got - want).abs().max().item()
            tf32 = (got_tf32 - got).abs().max().item()
            residual = (want - x_c).abs().max().item()
            expect(seen == {"ieee"}, f"[nn] {label}: convolutions ran "
                   f"under {seen}")
            expect(err <= NN_TOL, f"[nn] {label}: card vs CPU max {err}")
            net_rel, net_rel_tf32 = unet_vs_cpu(models[arch], seed)
            expect(net_rel <= UNET_REL_TOL, f"[nn] {label}: the U-Net on "
                   f"the card vs the CPU, relative {net_rel}")
        rows.append(dict(case=label, ms=ms, peak_gb=peak, max_abs_err=err,
                         tf32=tf32, unet_rel=net_rel,
                         unet_rel_tf32=net_rel_tf32))
        print(f"[nn] rawdenoiseai {label} ({models[arch].cfg['arch']}, "
              f"base {models[arch].stage('fine').base}, depth "
              f"{models[arch].stage('fine').depth}, anchor "
              f"{models[arch].anchor}, bin "
              f"{models[arch].bin_for(xtrans)}) alone on {shape}: {ms:.2f} "
              f"ms (device, {NN_REPEATS} timed runs after 1 warm-up), peak "
              f"device memory {peak:.3f} GB ({held:.3f} GB held before), "
              f"moved the mosaic by up to {moved:.3g} | on a "
              f"{NN_CROP[0]}x{NN_CROP[1]} crop at {box}: card vs CPU max "
              f"{err:.3g} (tol {NN_TOL:g}; the nets' residual up to "
              f"{residual:.3g}); cuDNN float32 convolutions in "
              f"unet_forward: {'/'.join(sorted(seen))} (outside it: "
              f"{torch.backends.cudnn.conv.fp32_precision}); TF32 would have moved the crop by "
              f"{tf32:.3g} | the fine U-Net alone on uniform planes of the "
              f"crop's size, card vs CPU relative {net_rel:.3g} (tol "
              f"{UNET_REL_TOL:g}), in TF32 {net_rel_tf32:.3g} on {card}",
              flush=True)
    record["nn"] = rows


def captured17(pipe, raw_dev):
    """Run config 17 once on a device-resident raw and keep the arguments
    of its RCD and chain calls."""
    calls = {"rcd": [], "chain": []}
    real_rcd, real_chain = rcd.rcd_demosaic, pw.pointwise_chain

    def rc(*args):
        calls["rcd"].append(args)
        return real_rcd(*args)

    def ch(*args):
        calls["chain"].append(args)
        return real_chain(*args)

    with swapped([(rcd, "rcd_demosaic", rc), (pw, "pointwise_chain", ch)]):
        pipe.run_padded(raw_dev)
    expect(len(calls["rcd"]) == 1 and len(calls["chain"]) == 1,
           f"unexpected config-17 calls: {len(calls['rcd'])} RCD, "
           f"{len(calls['chain'])} chains")
    return calls


def run_config17(card, record, raw, meta, phases, seed):
    """Config 17 at 24 MP: config 16's noisy mosaic through rawdenoiseai's
    multi-scale net with its anchor (`random_unet_ms(seed)` written to an
    .anselnn in a temporary directory on the op's search path, read by
    the planner), then config 1's develop.  Through the user's entry
    point with launches counted, against the composed twins; RCD and the
    chain on the arguments the pipe hands them; the net's step changes
    the mosaic; each step's device time, the pipe's rate and peak
    memory."""
    with timed(phases, "pipe17 mosaic"):
        raw17 = configs.mosaic16(raw, meta)
        meta17 = configs.meta16(meta)
        with configs.model17(seed) as model_path:
            pipe = port.compile_pipeline(meta17, configs.history(17))
        raw17_dev = torch.from_numpy(pad_to(raw17, pipe.pipe.spec_in)).cuda()
    stages = [s.name for s in pipe.pipe.stages]
    expect(stages == STAGES17, f"unexpected config-17 plan {stages}")
    expect([k for k, *_ in pipe.steps] == ["stage"] * 5 + ["chain"],
           f"unexpected config-17 steps {[k for k, *_ in pipe.steps]}")
    model = pipe.pipe.stages[1].plan.aux
    expect(pipe.pipe.stages[1].plan.static == configs.MODEL17
           and model.arch == "unet-ms" and model.anchor > 0,
           "config 17's model did not resolve")
    with timed(phases, "pipe17 vs plain"):
        reset_launches()
        out = pipe.output_array(raw17)
        launches = read_launches()
        programs, _ = read_split()
        expect(launches == LAUNCHES17 and programs == {0: 1},
               f"config-17 launches {launches}, programs {programs}")
        launches["programs"] = programs
        expect(out.shape == (3, H, W), f"output shape {out.shape}")
        expect(bool(np.isfinite(out).all()) and out.min() >= 0.0
               and out.max() <= 1.0, "output not finite or outside [0, 1]")
        reset_launches()
        with plain_twins():
            plain = pipe.output_array(raw17)
        expect(all(v == 0 for v in read_launches().values()),
               f"the plain composition launched kernels: {read_launches()}")
        pipe_err = float(np.abs(out - plain).max())
        pipe_mean = float(np.abs(out - plain).mean())
        expect(pipe_err <= PIPE_TOL, f"config 17 vs plain: max {pipe_err}")
        del plain
        x = pipe.pipe.trace_fn(0, 1)(raw17_dev, pipe.coeffs[:1])
        moved = (pipe.pipe.trace_fn(1, 2)(x, pipe.coeffs[1:2]) - x).abs() \
            .max().item()
        expect(moved > NN_MOVED, "config 17's net left the mosaic as it was")
        del x
    with timed(phases, "pipe17 kernels"):
        calls = captured17(pipe, raw17_dev)
        check_rcd_call(calls["rcd"][0], record, "rcd17",
                       "[pipe17] RCD on config 17's denoised mosaic")
        (record["chain17.0"],) = check_chains(17, calls["chain"],
                                              pipe.fused_groups())
        del calls
    with timed(phases, "pipe17 timing"):
        steps = step_times(pipe, raw17_dev)
        per_img = time_pipe(pipe, raw17_dev, PIPE17_REPEATS)
        peak, held = pipe_peak(pipe, raw17_dev)
    print(f"[pipe17] config 17 {H}x{W}: {len(stages)} stages, model "
          f"{os.path.basename(model_path)} ({model.arch}, anchor "
          f"{model.anchor}, bin {model.bin_for(False)}), chains "
          f"{pipe.fused_groups()}, launches {launches}, the net moved the "
          f"mosaic by up to {moved:.3g}, vs plain max {pipe_err:.3g} mean "
          f"{pipe_mean:.3g} (tol 1/255), range [{out.min():.3g}, "
          f"{out.max():.3g}] | {1.0 / per_img:.3f} img/s, "
          f"{H * W / per_img / 1e6:.1f} MP/s ({per_img * 1e3:.1f} ms/img, "
          f"device-resident input, {PIPE17_REPEATS} repeats after 2 "
          f"warm-ups), peak device memory {peak:.3f} GB ({held:.3f} GB held "
          "before) | steps (device ms): "
          + ", ".join(f"{n} {t:.3f}" for n, t in steps) + f" on {card}",
          flush=True)
    return launches


def run_scopes(card, record, raw_dev, meta, phases):
    """`[scopes]`: histogram, waveform, vectorscope and stats of config
    1's output on the card, each equal to the same function of that
    tensor on the CPU (counts for count; stats' min and max exactly, its
    means within SCOPE_MEAN_TOL), and the device ms of each."""
    with timed(phases, "scopes"):
        pipe = port.compile_pipeline(meta, configs.history(1))
        img = pipe.run_padded(raw_dev)[:, :H, :W].contiguous()
        img_cpu = img.cpu()
        rows = []
        for name, fn in (("histogram", scopes.histogram_rgb),
                         ("waveform", scopes.waveform),
                         ("vectorscope", scopes.vectorscope),
                         ("stats", scopes.stats)):
            got, want = fn(img), fn(img_cpu)
            if name == "stats":
                for k in ("min", "max"):
                    expect(torch.equal(got[k].cpu(), want[k]),
                           f"[scopes] stats {k}")
                for k in ("mean", "clipped"):
                    d = (got[k].cpu() - want[k]).abs().max().item()
                    expect(d <= SCOPE_MEAN_TOL, f"[scopes] stats {k}: {d}")
                shape = "4 x (3,)"
            else:
                expect(got.device.type == "cuda"
                       and torch.equal(got.cpu(), want),
                       f"[scopes] {name}: the card's counts differ")
                # a count a pixel of each channel; the waveform's a pixel of
                # each pooled column
                px = {"histogram": 3 * H * W, "vectorscope": H * W,
                      "waveform": 3 * H * want.shape[-1]}[name]
                expect(want.sum().item() == px,
                       f"[scopes] {name}: counts do not add up")
                shape = str(tuple(got.shape))
            ms = median_ms(lambda: fn(img), SCOPE_REPEATS)
            rows.append(dict(scope=name, ms=ms))
            print(f"[scopes] {name} of config 1's output {tuple(img.shape)} "
                  f"-> {shape}: equal to the CPU's | {ms:.3f} ms (device, "
                  f"median of {SCOPE_REPEATS}) on {card}", flush=True)
    record["scopes"] = rows


def by_mosaic(calls, chains):
    """Swaps that follow config 5's jobs (one at a time on the device
    worker) by the mosaic they demosaic: the first RCD, Markesteijn and
    chain call of each kind kept in `calls` (unless None), the chains by
    the mosaic they follow, and each chain call's launches (the wrapper's
    own count) added to `chains["bayer"]` or `chains["xtrans"]`."""
    real = {"rcd": rcd.rcd_demosaic, "mark": markesteijn.xtrans_markesteijn,
            "chain": pw.pointwise_chain}
    state = {"last": None}

    def keep(key, args):
        if calls is not None:
            calls.setdefault(key, args)

    def rc(*args):
        keep("rcd", args)
        state["last"] = "bayer"
        return real["rcd"](*args)

    def mk(*args):
        keep("mark", args)
        state["last"] = "xtrans"
        return real["mark"](*args)

    def ch(*args):
        keep(f"chain-{state['last']}", args)
        before = pw.LAUNCHES
        out = real["chain"](*args)
        chains[state["last"]] = (chains.get(state["last"], 0)
                                 + pw.LAUNCHES - before)
        return out

    return swapped([(rcd, "rcd_demosaic", rc),
                    (markesteijn, "xtrans_markesteijn", mk),
                    (pw, "pointwise_chain", ch)])


@contextlib.contextmanager
def export_parts():
    """The seconds of each part of batch_export's jobs over the block,
    from spies on what a job calls: "decode" (`load_raw` and the
    sidecar's `parse_xmp`), "export" (`export_image`), and inside it
    "render" (`CompiledPipe.output_array`: the run and its copy to the
    host) and "encode" (`encode.write_image`); "plan" is the rest of
    `export_image` (planning and the pipe's build)."""
    parts = dict.fromkeys(("decode", "export", "render", "encode"), 0.0)

    def spy(key, real):
        def timed_call(*args, **kw):
            t = time.perf_counter()
            try:
                return real(*args, **kw)
            finally:
                parts[key] += time.perf_counter() - t
        return timed_call

    with swapped([(rawfile, "load_raw", spy("decode", rawfile.load_raw)),
                  (xmp_mod, "parse_xmp", spy("decode", xmp_mod.parse_xmp)),
                  (export_mod, "export_image",
                   spy("export", export_mod.export_image)),
                  (engine.CompiledPipe, "output_array",
                   spy("render", engine.CompiledPipe.output_array)),
                  (encode, "write_image",
                   spy("encode", encode.write_image))]):
        yield parts
    parts["plan"] = parts.pop("export") - parts["render"] - parts["encode"]


def run_config5(card, record, phases, root, catalog, n):
    """Config 5, bench.py's library path on the port: the roll of `n`
    images (`configs.write_catalog5`, written on a host thread) imported
    into a library, queried through a Collection on its folder and
    batch-exported to JPEG (one device job an image on the serialized
    export queue: decode, render, encode); the first pass warms up, the
    second is timed with the launch counts set to 0 before it.  img/s,
    MP/s, the share of the wall time in each part of the jobs, peak
    memory; the pipe cache hit on every image of the timed pass; two
    JPEGs equal to `write_image` of `export_image`'s array, each array
    within 1/255 of the composed twins; RCD, Markesteijn and the chain on
    the arguments the warm-up pass handed them."""
    folder = os.path.join(root, "film")
    with timed(phases, "pipe5 catalog wait"):
        paths = catalog.result()
    with timed(phases, "pipe5 import"):
        lib = Library(os.path.join(root, "library.db"))
        ids = lib.import_film_roll(folder)
        coll = Collection(film_folder=folder)
        expect(len(ids) == n and coll.run(lib) == ids,
               f"config 5 imported {len(ids)} of {n}")
    calls = {}
    with timed(phases, "pipe5 warm-up"), by_mosaic(calls, {}):
        batch_export(lib, coll, os.path.join(root, "warm"))
    uploads = []
    real_upload = engine.coeffs_to_device

    def upload(*args):
        uploads.append(1)
        return real_upload(*args)

    chains = {}
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    with timed(phases, "pipe5 timed"), swapped(
            [(engine, "coeffs_to_device", upload)]), \
            by_mosaic(None, chains), export_parts() as parts:
        reset_launches()
        t = time.perf_counter()
        written = batch_export(lib, coll, os.path.join(root, "out"))
        wall = time.perf_counter() - t
        launches = read_launches()
        programs, _ = read_split()
    peak = torch.cuda.max_memory_allocated() / 1e9
    want = dict(NO_LAUNCHES, rcd=(n + 1) // 2, markesteijn=n // 2, chain=n)
    expect(launches == want and programs == {0: n}
           and chains == {"bayer": (n + 1) // 2, "xtrans": n // 2},
           f"config-5 launches {launches}, programs {programs}, chains by "
           f"mosaic {chains}")
    launches["programs"] = programs
    launches["chains"] = chains
    expect(not uploads, f"the timed pass built {len(uploads)} pipes' "
           "coefficients: the pipe cache missed")
    expect(len(written) == n and all(os.path.getsize(p) > 1000
                                     for p in written),
           "config 5 wrote too few or empty files")
    with timed(phases, "pipe5 check"):
        errs = []
        for i in (0, 1):
            raw, m = load_raw(paths[i])
            arr = export_image(raw, m, xmp_path=paths[i] + ".xmp")
            again = os.path.join(root, f"again{i}.jpg")
            s = ExportSettings()
            write_image(again, arr, quality=s.quality, bpp=s.bpp,
                        icc=b"srgb", meta=m)
            with open(again, "rb") as a, open(written[i], "rb") as b:
                expect(a.read() == b.read(), f"config 5's JPEG {i} differs "
                       "from write_image of export_image's array")
            expect(arr.shape == (3, m.height, m.width)
                   and bool(np.isfinite(arr).all()) and arr.min() >= 0.0
                   and arr.max() <= 1.0, f"config 5 image {i}: bad output")
            with plain_twins():
                plain = export_image(raw, m, xmp_path=paths[i] + ".xmp")
            errs.append(float(np.abs(arr - plain).max()))
            expect(errs[-1] <= PIPE_TOL, f"config 5 image {i} vs plain: "
                   f"max {errs[-1]}")
            del raw, arr, plain
    with timed(phases, "pipe5 kernels"):
        check_rcd_call(calls["rcd"], record, "rcd5",
                       "[pipe5] RCD on config 5's Bayer mosaic")
        check_markesteijn_call(calls["mark"], record, "markesteijn5",
                               "[pipe5] Markesteijn on config 5's X-Trans "
                               "mosaic")
        stages = ["exposure", "colorin", "channelmixerrgb", "filmicrgb",
                  "colorout"]
        record["chain5.0"], record["chain5.1"] = check_chains(
            5, [calls["chain-xtrans"], calls["chain-bayer"]],
            [stages, stages])
        del calls
    mp = configs.catalog5_pixels(n) / 1e6
    share = ", ".join(
        f"{k} {100 * v / wall:.1f}%" for k, v in
        (("decode", parts["decode"]), ("plan", parts["plan"]),
         ("render", parts["render"]), ("encode", parts["encode"]),
         ("the rest", wall - sum(parts.values()))))
    record["pipe5"] = dict(images=n, wall=wall, img_s=n / wall,
                           mp_s=mp / wall, peak_gb=peak,
                           render_share=parts["render"] / wall)
    print(f"[pipe5] config 5, the library's batch export of {n} images "
          f"(Bayer {H}x{W} and X-Trans {H4}x{W4}, {mp:.1f} MP): imported, "
          f"queried, exported to JPEG through the USER_EXPORT queue's device "
          f"jobs; launches {launches} in the timed pass, the pipe cache hit "
          f"on every image, two JPEGs equal to write_image of export_image's "
          f"array, each within {max(errs):.3g} of the composed twins (tol "
          f"1/255) | timed pass {wall:.2f} s: {n / wall:.3f} img/s, "
          f"{mp / wall:.1f} MP/s; wall time in the jobs' parts: {share} "
          f"(render = the pipe's run and its copy to the host); peak device "
          f"memory {peak:.3f} GB ({held:.3f} GB held before) on {card}",
          flush=True)
    return launches, lib


def run_generate_cache(card, root, phases):
    """`[generate-cache]`: `python -m ansel_tpu_torch.cli --generate-cache`
    on config 5's library for images 1-GENERATE_CACHE_IMGS in a new process
    (levels 0-2 on the card); the thumbnails it stored equal the same
    levels rendered in this process."""
    db = os.path.join(root, "library.db")
    cache = os.path.join(root, "mipmaps")
    with timed(phases, "generate-cache"):
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "ansel_tpu_torch.cli", "--generate-cache",
             "--library", db, "--max-imgid", str(GENERATE_CACHE_IMGS),
             "--cache-dir", cache],
            capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t
        expect(proc.returncode == 0,
               f"--generate-cache exit {proc.returncode}: "
               f"{proc.stderr[-2000:]}")
        lines = [ln for ln in proc.stdout.splitlines() if ln]
        expect(lines[-1].startswith(f"generated {3 * GENERATE_CACHE_IMGS} "
                                    "thumbnails"),
               f"--generate-cache said {lines[-1:]}")
        lib = Library(db)
        mc = MipmapCache(cache_dir=os.path.join(root, "again"))
        stored = MipmapCache(cache_dir=cache)
        for imgid in (1, 2):
            path = lib.image_path(imgid)
            for level in (0, 2):
                got = stored.get(path, level)
                want = mc.get(path, level, xmp_path=path + ".xmp")
                expect(stored.misses == 0 and np.array_equal(got, want),
                       f"--generate-cache's image {imgid} level {level} "
                       "differs from this process's")
        lib.close()
    print(f"[generate-cache] python -m ansel_tpu_torch.cli --generate-cache "
          f"--max-imgid {GENERATE_CACHE_IMGS}: {' | '.join(lines)} | "
          f"{wall:.2f} s wall (a new process: start, kernels loaded, "
          f"{GENERATE_CACHE_IMGS} raws read at each level, THUMBNAIL pipes on "
          f"the card); images 1-2 at levels 0 and 2 equal this process's "
          f"renders on {card}", flush=True)


# --- config 18: the multi-device paths ------------------------------------------
def card_mesh(n, spatial=1):
    """A mesh of n shards in rows of `spatial`: the machine's cards where
    it has n of them, else an explicit virtual mesh (the cards in turn,
    `parallel/mesh.virtual_devices`); -> (mesh, how it was built)."""
    cards = torch.cuda.device_count()
    if cards >= n:
        return make_mesh(n, spatial=spatial), f"{n} cards"
    mesh = make_mesh(n, spatial=spatial,
                     devices=mesh_mod.virtual_devices(n, "cuda"))
    return mesh, (f"a virtual mesh of {n} shards on {cards} card(s) "
                  f"({', '.join(str(d) for d in mesh.devices.flat)})")


@contextlib.contextmanager
def shard_calls(axis, index, names):
    """Spies that keep the arguments of each call that shard `index` of
    `axis` makes to the kernel entries in `names` ("rcd", "eaw", "nlm",
    "chain", "warp", "mark"): -> {name: [args, ...]}."""
    entries = {"rcd": (rcd, "rcd_demosaic"), "eaw": (eaw, "eaw_dn_coarse"),
               "nlm": (nlm, "nlm"), "chain": (pw, "pointwise_chain")}
    calls = {name: [] for name in names}

    def spy(name, real):
        def call(*args):
            if mesh_mod.in_shard(axis) and mesh_mod.axis_index(axis) == index:
                calls[name].append(args)
            return real(*args)
        return call

    with swapped([(mod, attr, spy(name, getattr(mod, attr)))
                  for name, (mod, attr) in entries.items()
                  if name in names]):
        yield calls


def mesh_rate(fn, images, repeats=3):
    """(img/s, peak GB, held GB) of `fn` running `images` images, device
    time included: one warm-up, then `repeats` calls timed between two
    synchronisations; the peak over one call."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(repeats):
        fn()
    torch.cuda.synchronize()
    rate = images * repeats / (time.perf_counter() - t)
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return rate, torch.cuda.max_memory_allocated() / 1e9, held / 1e9


def check_eaw_calls(calls, record, key, tag):
    """EAW on a pipe's scales (x, scale, inv_sigma2): each against its
    twin (STENCIL_TOL), device ms of both, the bound per scale."""
    err, rows, ms_, plain_ = 0.0, [], [], []
    for x, scale, inv_sigma2 in calls:
        got = eaw.eaw_dn_coarse(x, scale, inv_sigma2)
        want = eaw.eaw_coarse_reference(x, scale, inv_sigma2, eaw.DN)
        for g, w_ in zip(got, want):
            mx, _ = compare(g, w_)
            expect(mx <= STENCIL_TOL, f"{tag} s={scale}: max {mx}")
            err = max(err, mx)
        del got, want
        ms_.append(median_ms(lambda: eaw.eaw_dn_coarse(x, scale,
                                                       inv_sigma2)))
        plain_.append(median_ms(lambda: eaw.eaw_coarse_reference(
            x, scale, inv_sigma2, eaw.DN), PLAIN_REPEATS))
        rows.append(f"s{scale} {ms_[-1]:.3f}/{plain_[-1]:.1f}")
    x = calls[0][0]
    b_ms, b_by = bound(3 * nbytes(x), FLOPS_EAW * x[0].numel())
    record[key] = dict(max_abs_err=err, ms=float(np.mean(ms_)),
                       plain_ms=float(np.mean(plain_)), library_ms=None,
                       bound_ms=b_ms, bound_by=b_by)
    print(f"{tag} {tuple(x.shape)}, scales 0-{len(rows) - 1}, kernel vs "
          f"plain: max {err:.3g} (tol {STENCIL_TOL:g}) | ms kernel/plain: "
          f"{', '.join(rows)} | bound {b_ms:.3f} ms per scale ({b_by})",
          flush=True)


def check_nlm_call(call, record, key, tag):
    """NLM on a pipe's arguments against its twin (STENCIL_TOL), device
    ms of both and the bound."""
    v, offs = call[0], call[1]
    got, want = nlm.nlm(*call), nlm.nlm_reference(*call)
    mx, _ = compare(got, want)
    expect(mx <= STENCIL_TOL, f"{tag}: max {mx}")
    del got, want
    ms = median_ms(lambda: nlm.nlm(*call))
    plain_ms = median_ms(lambda: nlm.nlm_reference(*call), PLAIN_REPEATS)
    b_ms, b_by = bound(2 * nbytes(v),
                       FLOPS_NLM_PER_OFFSET * len(offs) * v[0].numel())
    record[key] = dict(max_abs_err=mx, ms=ms, plain_ms=plain_ms,
                       library_ms=None, bound_ms=b_ms, bound_by=b_by)
    print(f"{tag} {tuple(v.shape)} {len(offs)} offsets P={call[2]}: kernel "
          f"vs plain max {mx:.3g} (tol {STENCIL_TOL:g}) | kernel {ms:.3f} ms, "
          f"plain {plain_ms:.1f} ms, bound {b_ms:.3f} ms ({b_by})",
          flush=True)


def check_chain_interpreted(call, names, record, key, tag):
    """A chain the interpreter runs (its sequence has no program of its
    own in pointwise.FIXED): against the plain stages (the chain's
    tolerances, scaled by the output's magnitude), device ms, and the
    bound of its bytes (its operations are not counted by opcode)."""
    x, chain = call
    expect(chain.fixed == -1, f"{tag}: program {chain.fixed}, not the "
           "interpreter")
    got = pw.pointwise_chain(x, chain)
    want = pw.pointwise_chain_reference(x, chain)
    mx, mean = compare(got, want)
    scale = max(1.0, want.abs().max().item())
    del got, want
    expect(mx <= CHAIN_MAX_TOL * scale and mean <= CHAIN_MEAN_TOL * scale,
           f"{tag}: max {mx}, mean {mean} (x {scale:.3g})")
    ms = median_ms(lambda: pw.pointwise_chain(x, chain))
    plain_ms = median_ms(lambda: pw.pointwise_chain_reference(x, chain),
                         PLAIN_REPEATS)
    b_ms, b_by = bound(2 * nbytes(x))
    record[key] = dict(max_abs_err=mx, ms=ms, plain_ms=plain_ms,
                       library_ms=None, bound_ms=b_ms, bound_by=b_by)
    print(f"{tag} {'+'.join(names)} on {tuple(x.shape)}: interpreter vs "
          f"plain max {mx:.3g} mean {mean:.3g} (tol {CHAIN_MAX_TOL:g} / "
          f"{CHAIN_MEAN_TOL:g} x {scale:.3g}) | kernel {ms:.4f} ms, plain "
          f"{plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}; not counted "
          "by opcode)", flush=True)


def run_config18(card, record, raw_dev, meta, phases):
    """Config 18, the multi-device paths at 24 MP on the machine's cards,
    or on an explicit virtual mesh where it has fewer cards than shards:
    (a) `BatchPipeline` over dp 2 of config 1's mosaic at four gains, each
    image bit-equal to the single pipe's; (b) `SpatialPipeline` over sp 4
    of config 18's denoise stack on config 2's noisy mosaic (one halo
    exchange, denoiseprofile's statistic summed over the shards) within
    1/255 of the single pipe, RCD, EAW and NLM held against their twins
    on the interior shard 1's window; (c) `spatial_sharded_pipe` over (dp
    2, sp 2) of config 1's history within 1e-5 of the single pipe.  Each
    with img/s beside the single pipe's on the same card, peak memory and
    launches (4 x the single pipe's for (b) and (c)); the kernels of (a)
    on shard 1's arguments, of (c) on band 1's."""
    launches = {}
    # -- (a) the batch over dp
    with timed(phases, "pipe18 batch"):
        mesh, how = card_mesh(configs.DP18)
        hist1 = configs.history(1)
        bp = BatchPipeline(meta, hist1, mesh)
        batch = torch.stack([raw_dev * g for g in configs.GAINS18])
        single = port.compile_pipeline(meta, hist1)
        with shard_calls("dp", 1, ("rcd", "chain")) as calls_a:
            reset_launches()
            out = bp(batch)
            torch.cuda.synchronize()
            launches["a"] = read_launches()
        expect(launches["a"] == LAUNCHES18A, f"[pipe18] (a) launches "
               f"{launches['a']}")
        for i in range(configs.BATCH18):
            expect(torch.equal(out[i], single.run_padded(batch[i])),
                   f"[pipe18] (a) image {i} differs from the single pipe")
        del out
        rate, peak, held = mesh_rate(lambda: bp(batch), configs.BATCH18)
        one = 1.0 / time_pipe(single, raw_dev, REPEATS)
        print(f"[pipe18] (a) BatchPipeline, config 1's history over dp "
              f"{configs.DP18} on {how}: {configs.BATCH18} images of "
              f"{H}x{W} at gains {configs.GAINS18}, launches "
              f"{launches['a']}, each image equal to the single pipe's bit "
              f"for bit | {rate:.2f} img/s (the single pipe "
              f"{one:.2f} img/s), peak device memory {peak:.3f} GB "
              f"({held:.3f} GB held before) on {card}", flush=True)
        check_rcd_call(calls_a["rcd"][0], record, "rcd18a",
                       "[pipe18] (a) RCD on dp shard 1's mosaic")
        stages = [s.name for s in single.pipe.stages[4:]]
        (record["chain18a"],) = check_chains(
            1, [calls_a["chain"][0]], [stages])
        del batch, bp, calls_a
    # -- (b) the shifted-window scheme over sp
    with timed(phases, "pipe18 spatial"):
        mesh, how = card_mesh(configs.SP18, spatial=configs.SP18)
        hist = configs.history(18)
        noisy = noisy_like(raw_dev, NOISE_SIGMA)
        sp = SpatialPipeline(meta, hist, mesh, axis="sp")
        single = port.compile_pipeline(meta, hist)
        reset_launches()
        want = single.run_padded(noisy)
        torch.cuda.synchronize()
        one_launches = read_launches()
        with shard_calls("sp", 1, ("rcd", "eaw", "nlm", "chain")) as calls_b:
            reset_launches()
            got = sp(noisy)
            torch.cuda.synchronize()
            launches["b"] = read_launches()
            launches["b programs"], _ = read_split()
        expect(launches["b"] == {k: configs.SP18 * v
                                 for k, v in one_launches.items()},
               f"[pipe18] (b) launches {launches['b']}, the single pipe's "
               f"{one_launches}")
        so = single.pipe.spec_out
        err_b = (got - want[:, :so.height, :so.width]).abs().max().item()
        expect(bool(torch.isfinite(got).all()) and err_b < SPATIAL18_TOL,
               f"[pipe18] (b) vs the single pipe: max {err_b}")
        del got, want
        rate, peak, held = mesh_rate(lambda: sp(noisy), 1)
        one = 1.0 / time_pipe(single, noisy, 3, warmups=1)
        org = sp.shard_h - sp.halo
        window = sp.pipe.spec_in
        print(f"[pipe18] (b) SpatialPipeline, config 18's denoise stack "
              f"over sp {configs.SP18} on {how}: shard_h {sp.shard_h}, halo "
              f"{sp.halo} rows (windows of {sp.shard_h + 2 * sp.halo} rows, "
              f"shard 1's from row {org}), launches {launches['b']} "
              f"({configs.SP18} x the single pipe's), vs the single pipe "
              f"max {err_b:.3g} (tol 1/255) | {rate:.2f} img/s (the single "
              f"pipe {one:.2f} img/s), peak device memory {peak:.3f} GB "
              f"({held:.3f} GB held before) on {card}", flush=True)
        mosaic = calls_b["rcd"][0][0]
        expect(mosaic.shape == window.array_shape, "shard 1's RCD input")
        check_rcd_call(calls_b["rcd"][0], record, "rcd18b",
                       f"[pipe18] (b) RCD on shard 1's window (origin row "
                       f"{org}, CFA {calls_b['rcd'][0][1].name} at its "
                       f"origin, as at the frame's: origins stay congruent "
                       f"mod 2)")
        check_eaw_calls(calls_b["eaw"], record, "eaw18b",
                        "[pipe18] (b) EAW on shard 1's window")
        check_nlm_call(calls_b["nlm"][0], record, "nlm18b",
                       "[pipe18] (b) NLM on shard 1's window")
        names = [[s.name for s in sp.pipe.stages[i:j]]
                 for kind, i, j, _ in sp.compiled[str(mesh.devices[0, 0])].steps
                 if kind == "chain"]
        expect(len(calls_b["chain"]) == len(names) == 2
               and launches["b programs"] == {
                   calls_b["chain"][0][1].fixed: configs.SP18,
                   -1: configs.SP18},
               f"[pipe18] (b) chains {names}, programs "
               f"{launches['b programs']}")
        (record["chain18b.0"],) = check_chains(18, calls_b["chain"][:1],
                                               names[:1])
        check_chain_interpreted(calls_b["chain"][1], names[1], record,
                                "chain18b.1", "[pipe18] (b) chain 1 on "
                                "shard 1's window")
        record["pipe18b"] = dict(max_abs_err=err_b, img_s=rate, single=one,
                                 peak_gb=peak, halo=sp.halo)
        del noisy, sp, calls_b, mosaic
    # -- (c) each device its band of the output rows
    with timed(phases, "pipe18 sharded"):
        mesh, how = card_mesh(4, spatial=2)
        call, pipe = spatial_sharded_pipe(meta, hist1, mesh)
        single = engine.CompiledPipe(pipe)
        want = single.run_padded(raw_dev)[:, :H, :W]
        with shard_calls(mesh_mod.AXES, 1, ("rcd", "chain")) as calls_c:
            reset_launches()
            got = call(raw_dev)
            torch.cuda.synchronize()
            launches["c"] = read_launches()
        expect(launches["c"] == dict(NO_LAUNCHES, rcd=4, chain=4),
               f"[pipe18] (c) launches {launches['c']}")
        err_c = (got - want).abs().max().item()
        expect(err_c <= SHARDED18_TOL, f"[pipe18] (c) vs the single pipe: "
               f"max {err_c}")
        del got, want
        rate, peak, held = mesh_rate(lambda: call(raw_dev), 1)
        one = 1.0 / time_pipe(single, raw_dev, REPEATS)
        print(f"[pipe18] (c) spatial_sharded_pipe, config 1's history over "
              f"(dp 2, sp 2) on {how}: launches {launches['c']}, vs the "
              f"single pipe max {err_c:.3g} (tol {SHARDED18_TOL:g}) | "
              f"{rate:.2f} img/s (the single pipe {one:.2f} img/s), peak "
              f"device memory {peak:.3f} GB ({held:.3f} GB held before) on "
              f"{card}", flush=True)
        check_rcd_call(calls_c["rcd"][0], record, "rcd18c",
                       "[pipe18] (c) RCD on band 1's input window")
        record["chain18c"] = check_chains(
            1, [calls_c["chain"][0]], [[s.name for s in pipe.stages[4:]]])[0]
        del call, pipe, calls_c
    # -- (c) on a history whose stages read whole-frame statistics: every
    # band computes the frame up to demosaic
    with timed(phases, "pipe18 sharded frame"):
        hist = [port.HistoryItem(op, dict(p))
                for op, p in configs.HISTORY18_FRAME]
        noisy = noisy_like(raw_dev, NOISE_SIGMA)
        call, pipe = spatial_sharded_pipe(meta, hist, mesh)
        single = engine.CompiledPipe(pipe)
        reset_launches()
        want = single.run_padded(noisy)[:, :H, :W]
        torch.cuda.synchronize()
        one_launches = read_launches()
        reset_launches()
        got = call(noisy)
        torch.cuda.synchronize()
        launches["c frame"] = read_launches()
        expect(launches["c frame"] == {k: 4 * v
                                       for k, v in one_launches.items()}
               and one_launches["eaw"] > 0 and one_launches["rcd"] == 1,
               f"[pipe18] (c) frame launches {launches['c frame']}, the "
               f"single pipe's {one_launches}")
        err = (got - want).abs().max().item()
        expect(bool(torch.isfinite(got).all()) and err <= SHARDED18_TOL,
               f"[pipe18] (c) frame vs the single pipe: max {err}")
        del got, want
        rate, peak, held = mesh_rate(lambda: call(noisy), 1)
        one = 1.0 / time_pipe(single, noisy, 3, warmups=1)
        print(f"[pipe18] (c) spatial_sharded_pipe, config 1's develop behind "
              f"denoiseprofile's wavelets and green equilibration 2 on the "
              f"noisy mosaic over (dp 2, sp 2) on {how}: each band computes "
              f"the frame up to demosaic, launches {launches['c frame']} (4 "
              f"x the single pipe's), vs the single pipe max {err:.3g} (tol "
              f"{SHARDED18_TOL:g}) | {rate:.2f} img/s (the single pipe "
              f"{one:.2f} img/s), peak device memory {peak:.3f} GB "
              f"({held:.3f} GB held before) on {card}", flush=True)
        record["pipe18c_frame"] = dict(max_abs_err=err, img_s=rate,
                                       single=one, peak_gb=peak)
        del call, pipe, single, noisy
    return launches


def run_dryrun(phases):
    """`dryrun_multichip(4)` on the card (a virtual mesh where it has
    fewer than four cards): its four phases, each checked inside."""
    with timed(phases, "dryrun"):
        t = time.perf_counter()
        dryrun_multichip(4)
        print(f"[dryrun] dryrun_multichip(4) on the card: batch, sharded "
              f"bands, shifted windows, config 13's history over dp, all "
              f"held | {time.perf_counter() - t:.1f} s", flush=True)


# --- Hald CLUTs through PIL ----------------------------------------------------
def write_halds(directory):
    """A level-16 Hald CLUT (a 64 x 64 image) of a warm look, written by
    PIL as a palette PNG and as a JPEG: -> {form: path}."""
    from PIL import Image

    g = np.linspace(0.0, 1.0, 16)
    b, gg, r = np.meshgrid(g, g, g, indexing="ij")  # [b][g][r], r fastest
    look = np.stack([r ** 0.8, gg ** 0.95, b ** 1.2], -1).reshape(64, 64, 3)
    img = Image.fromarray(np.round(look * 255.0).astype(np.uint8), "RGB")
    paths = {"palette PNG": os.path.join(directory, "hald.png"),
             "JPEG": os.path.join(directory, "hald.jpg")}
    img.quantize(256).save(paths["palette PNG"])
    img.save(paths["JPEG"], quality=95)
    return paths


def run_lut3d_pil(card, record, raw, meta, phases):
    """The lut3d op on a Hald CLUT of each form PIL writes (a palette PNG,
    a JPEG), read through PIL: the table equal to PIL's RGB image / 255;
    the history [lut3d] on the card at 24 MP with launches counted, and
    against the same history on the CPU on a crop of the mosaic (a frame
    of its own) within 1/255."""
    from PIL import Image

    y0, x0, h, w = CROP_BAYER
    crop = np.ascontiguousarray(raw[y0:y0 + h, x0:x0 + w])
    meta_crop = dataclasses.replace(meta, width=w, height=h)
    with timed(phases, "lut3d-pil"), tempfile.TemporaryDirectory() as tmp:
        plain = port.compile_pipeline(meta, []).output_array(raw)
        for form, path in write_halds(tmp).items():
            hist = [port.HistoryItem("lut3d", {"filepath": path})]
            pipe = port.compile_pipeline(meta, hist)
            stage = next(s for s in pipe.pipe.stages if s.name == "lut3d")
            mode = Image.open(path).mode
            want = np.asarray(Image.open(path).convert("RGB"),
                              np.float32) / 255.0
            expect(stage.plan.static[2] == 16 and np.array_equal(
                stage.plan.aux["clut"].reshape(-1, 3), want.reshape(-1, 3)),
                f"[lut3d-pil] the {form} table")
            reset_launches()
            out = pipe.output_array(raw)
            launches = read_launches()
            expect(launches["rcd"] == 1 and launches["chain"] >= 1,
                   f"[lut3d-pil] launches {launches}")
            expect(out.shape == (3, H, W) and bool(np.isfinite(out).all()),
                   f"[lut3d-pil] {form}: output {out.shape}")
            moved = float(np.abs(out - plain).max())
            expect(moved > PIPE_TOL, f"[lut3d-pil] {form}: the look moved "
                   f"the image by {moved} only")
            per_img = time_pipe(pipe, torch.from_numpy(
                pad_to(raw, pipe.pipe.spec_in)).cuda(), 3, warmups=1)
            got = port.compile_pipeline(meta_crop, hist).output_array(crop)
            cpu = port.compile_pipeline(meta_crop, hist,
                                        device="cpu").output_array(crop)
            err = float(np.abs(got - cpu).max())
            expect(err <= PIPE_TOL, f"[lut3d-pil] {form}: card vs CPU max "
                   f"{err}")
            print(f"[lut3d-pil] a Hald CLUT of level 16 as a {form} (PIL "
                  f"mode {mode}), read through PIL: the table equal to "
                  f"PIL's RGB / 255; [lut3d] at {H}x{W} launches {launches}, "
                  f"{1.0 / per_img:.2f} img/s, the look moves the output by "
                  f"{moved:.3g}; on a {h}x{w} crop the card vs the CPU max "
                  f"{err:.3g} (tol 1/255) on {card}", flush=True)
            record[f"lut3d-pil {form}"] = dict(max_abs_err=err,
                                               img_s=1.0 / per_img)


# --- config 19: a Lightroom roll ------------------------------------------------
class MockWsPhp(http.server.BaseHTTPRequestHandler):
    """A Piwigo server's ws.php on the loopback interface: the login, its
    token, one album, new albums, uploads; every call logged."""

    calls = []

    def log_message(self, *args):
        pass

    def do_POST(self):
        body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
        ctype = self.headers.get("Content-Type", "")
        fields = {}
        if ctype.startswith("multipart/form-data"):
            boundary = ctype.split("boundary=")[1].encode()
            for part in body.split(b"--" + boundary):
                head, _, val = part.partition(b"\r\n\r\n")
                if b'name="image"' in head:
                    fields["image"] = len(val.rstrip(b"\r\n"))
                elif b'name="' in head:
                    name = head.split(b'name="')[1].split(b'"')[0].decode()
                    fields[name] = val.rstrip(b"\r\n").decode()
        else:
            fields = {k: v[0] for k, v in
                      urllib.parse.parse_qs(body.decode()).items()}
        method = fields.get("method", "")
        MockWsPhp.calls.append((method, fields))
        result = {"pwg.session.getStatus": {"pwg_token": "token19"},
                  "pwg.categories.getList": {"categories": [
                      {"id": 7, "name": "Travel", "fullname": "Travel"}]},
                  "pwg.categories.add": {"id": 42},
                  "pwg.images.addSimple": {"image_id": 1000 + len(
                      MockWsPhp.calls)}}.get(method, {})
        payload = json.dumps({"stat": "ok", "result": result}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)


def lightroom_calls(calls):
    """Spies that keep config 19's kernel arguments from the device
    worker: the first RCD, Markesteijn, clipping-map and blur call, and
    the first call of each chain (its opcode sequence), with the number
    of calls of each chain in `calls["chain calls"]`, in the order the
    chains first ran (one chain call launches one kernel)."""
    real = {"rcd": rcd.rcd_demosaic, "mark": markesteijn.xtrans_markesteijn,
            "clip": warp.clip_warp, "chain": pw.pointwise_chain,
            "sepblur": sepblur.sep_blur}

    def keep(key):
        def call(*args):
            if key == "chain":
                ops = tuple(args[1].prog.tolist()[::pw.RECORD])
                count = calls.setdefault("chain calls", {})
                if ops not in count:
                    calls.setdefault("chain", []).append(args)
                count[ops] = count.get(ops, 0) + 1
            else:
                calls.setdefault(key, [args])
            return real[key](*args)
        return call

    return swapped([(rcd, "rcd_demosaic", keep("rcd")),
                    (markesteijn, "xtrans_markesteijn", keep("mark")),
                    (warp, "clip_warp", keep("clip")),
                    (pw, "pointwise_chain", keep("chain")),
                    (sepblur, "sep_blur", keep("sepblur"))])


def run_config19(card, record, phases, root, roll):
    """Config 19, a Lightroom roll at 24 MP: config 5's Bayer and X-Trans
    images beside `configs.LIGHTROOM19` sidecars (written on a host
    thread), imported into a library and crawled (the Lightroom
    histories, ratings and tags imported, then written back as darktable
    sidecars by a second crawl), exported to JPEG by `batch_export` and
    uploaded by `store_piwigo` to a mock ws.php on 127.0.0.1; the wall
    time of each part; each image's render within 1/255 of a single
    CompiledPipe of the parsed Lightroom history; RCD, Markesteijn,
    clipping's map and the two interpreted chains on their arguments."""
    folder = os.path.join(root, "film")
    parts = {}
    with timed(phases, "pipe19 roll wait"):
        paths = roll.result()
    with timed(phases, "pipe19"):
        t = time.perf_counter()
        lib = Library(os.path.join(root, "library.db"))
        ids = lib.import_film_roll(folder)
        first, again = crawl(lib), crawl(lib, write_back=True)
        expect(first.reimported == ids and again.written_back == ids,
               f"config 19's crawls: {first}, {again}")
        for i in ids:
            expect(lib.rating(i) == 4 and lib.image_tags(i) == ["alps", "ski"]
                   and len(lib.read_history(i)) == 8,
                   f"config 19 image {i}: rating {lib.rating(i)}, tags "
                   f"{lib.image_tags(i)}")
        parts["import and crawl"] = time.perf_counter() - t
        calls = {}
        t = time.perf_counter()
        with lightroom_calls(calls):
            reset_launches()
            written = batch_export(lib, Collection(film_folder=folder),
                                   os.path.join(root, "out"))
            launches = read_launches()
            programs, maps = read_split()
        parts["batch_export"] = time.perf_counter() - t
        chain_calls = list(calls["chain calls"].values())
        expect(launches == LAUNCHES19 and programs == {-1: 4}
               and maps == {"clip": 2} and len(chain_calls) == 2
               and sum(chain_calls) == launches["chain"],
               f"config 19 launches {launches}, programs {programs}, maps "
               f"{maps}, calls of each chain {chain_calls}")
        expect(len(written) == 2 and all(os.path.getsize(p) > 1000
                                         for p in written),
               "config 19 wrote too few or empty JPEGs")
        MockWsPhp.calls = []
        server = http.server.HTTPServer(("127.0.0.1", 0), MockWsPhp)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            t = time.perf_counter()
            client = PiwigoClient(
                server=f"http://127.0.0.1:{server.server_port}",
                username="photographer", password="roll19")
            os.makedirs(os.path.join(root, "piwigo"))
            uploaded = store_piwigo(lib, ids, client, "Lightroom roll",
                                    tmp_dir=os.path.join(root, "piwigo"))
            parts["store_piwigo"] = time.perf_counter() - t
        finally:
            server.shutdown()
            server.server_close()
            thread.join()
        methods = [m for m, _ in MockWsPhp.calls]
        adds = [f for m, f in MockWsPhp.calls
                if m == "pwg.images.addSimple"]
        expect(methods == PIWIGO19 and len(uploaded) == 2
               and [f["name"] for f in adds] == ["img000", "img001"]
               and all(f["category"] == "42" and f["image"] > 1000
                       for f in adds),
               f"the mock's log: {methods}, {adds}")
        lib.close()
        t = time.perf_counter()
        history = lightroom.parse_lightroom_xmp(configs.LIGHTROOM19).history
        errs = []
        for path in paths:
            raw, m = load_raw(path)
            got = export_image(raw, m, xmp_path=path + ".xmp")
            want = engine.CompiledPipe(engine.Pipeline(
                m, history)).output_array(raw)
            expect(got.shape == want.shape and bool(np.isfinite(got).all()),
                   f"config 19's {path}: {got.shape} vs {want.shape}")
            errs.append(float(np.abs(got - want).max()))
            expect(errs[-1] <= PIPE_TOL, f"config 19 vs the parsed "
                   f"history: max {errs[-1]}")
        parts["check"] = time.perf_counter() - t
    print(f"[pipe19] config 19, a Lightroom roll (Bayer {H}x{W} and X-Trans "
          f"{H4}x{W4}): imported, crawled (histories, rating 4 and tags "
          f"alps, ski from the Lightroom sidecars, then written back), "
          f"exported to JPEG, uploaded to a mock ws.php ({', '.join(methods)});"
          f" launches {launches} (chain 0 {chain_calls[0]}, chain 1 "
          f"{chain_calls[1]}), chain programs {programs}, maps {maps}; "
          f"each render vs a single pipe of the parsed history max "
          f"{max(errs):.3g} (tol 1/255) | wall s: "
          + ", ".join(f"{k} {v:.2f}" for k, v in parts.items())
          + f" on {card}", flush=True)
    with timed(phases, "pipe19 kernels"):
        check_rcd_call(calls["rcd"][0], record, "rcd19",
                       "[pipe19] RCD on config 19's Bayer mosaic")
        check_markesteijn_call(calls["mark"][0], record, "markesteijn19",
                               "[pipe19] Markesteijn on config 19's X-Trans "
                               "mosaic")
        check_warp_clip(calls["clip"], record, "warp19",
                        "[pipe19] the warp on clipping's map")
        rows, err, tot, b_by, x = sepblur_per_image(
            [calls["sepblur"][0] + (1,)])
        record["sepblur19"] = dict(max_abs_err=err, bound_by=b_by, **tot)
        print(f"[pipe19] sepblur, grain's first blur {tuple(x.shape)}: "
              f"bit-equal to its twin | ms kernel/plain/conv2d: {rows[0]} | "
              f"bound {tot['bound_ms']:.4f} ms ({b_by})", flush=True)
        for j, names in enumerate((
                ["exposure", "colorin", "_convert", "tonecurve",
                 "colorzones"],
                ["_convert", "splittoning", "vignette", "colorout"])):
            check_chain_interpreted(calls["chain"][j], names, record,
                                    f"chain19.{j}",
                                    f"[pipe19] chain {j}")
    record["pipe19"] = dict(parts=parts, max_abs_err=max(errs))
    return dict(launches, chains=chain_calls)


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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of config 14's fixtures and of the models of "
                         "[nn] and config 17")
    args = ap.parse_args(argv)
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
    with tempfile.TemporaryDirectory(prefix="ansel_smoke5_") as root5, \
            tempfile.TemporaryDirectory(prefix="ansel_smoke19_") as root19, \
            ThreadPoolExecutor(max_workers=4) as pool:
        # the mosaics are made on host threads, the 24 MP one while nvcc
        # builds, the 45 MP and X-Trans ones while configs 1 and 2 run;
        # config 5's roll is written beside them, and [prng]'s CPU draws
        # after the build
        with timed(phases, "build + mosaic"):
            synth = pool.submit(synth_raw, h=H, w=W, kind="gradients")
            synth3 = pool.submit(synth_raw, h=H3, w=W3, kind="gradients")
            synth4 = pool.submit(xtrans_raw, H4, W4)
            cluts16 = pool.submit(warm_cluts16)
            catalog5 = pool.submit(configs.write_catalog5,
                                   os.path.join(root5, "film"))
            roll19 = pool.submit(configs.write_roll19,
                                 os.path.join(root19, "film"))
            build_s = _build.build_all()
            print(f"[build] nvcc built and loaded "
                  f"{', '.join(_build.KERNELS)} in {build_s:.1f} s",
                  flush=True)
            prng_cpu = pool.submit(prng_on_cpu)
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
            check_prng(card, prng_cpu)
        launches12 = run_config12(card, record, raw, raw_dev, meta, phases)
        run_ops12(card, record, meta, raw_dev, phases)
        with tempfile.TemporaryDirectory() as tmp:
            launches13 = run_config13(card, record, raw, raw_dev, meta,
                                      phases, tmp)
            launches14 = run_config14(card, record, raw, raw_dev, meta,
                                      phases, tmp, args.seed)
        launches_fast = run_fastpipe(card, record, raw, raw_dev, meta,
                                     phases)
        check_r14(meta, phases)
        run_devtest_and_entry(phases)
        del raw_dev
        with timed(phases, "mosaic3 wait"):
            raw3, meta3, _ = synth3.result()
        launches3 = run_config3(card, record, raw3, meta3, phases)
        del raw3
        with timed(phases, "mosaic4 wait"):
            raw4, meta4 = synth4.result()
        launches4 = run_config4(card, record, raw4, meta4, phases)
        # config 15 and the demosaic and highlight branches, config 1's
        # and config 4's mosaics at 24 MP
        t15 = time.perf_counter()
        with timed(phases, "mosaic15 upload"):
            raw_dev = torch.from_numpy(raw).cuda()
        launches15, pipe15, raw15_dev = run_config15(card, record, raw,
                                                     raw_dev, meta, phases)
        del raw_dev
        mark_dual = run_demosaic_methods(card, record, meta, raw, meta4, raw4,
                                         phases)
        run_highlight_modes(card, record, meta, raw, meta4, raw4, pipe15,
                            raw15_dev, phases)
        del pipe15, raw15_dev
        branches_s = time.perf_counter() - t15
        # config 16, its kernels at their new arguments and the new ops
        # alone, on config 1's and config 4's mosaics at 24 MP
        t16 = time.perf_counter()
        with timed(phases, "cluts16 wait"):
            cluts16.result()
        with tempfile.TemporaryDirectory() as tmp:
            launches16 = run_config16(card, record, raw, meta, phases, tmp)
        run_ops16(card, record, meta, raw, meta4, raw4, phases)
        slice16_s = time.perf_counter() - t16
        # rawdenoiseai alone and config 17, the scopes, config 5 (the
        # library's batch export) and --generate-cache
        t19 = time.perf_counter()
        run_nn(card, record, meta, raw, meta4, raw4, phases, args.seed)
        launches17 = run_config17(card, record, raw, meta, phases,
                                  args.seed)
        with timed(phases, "scopes upload"):
            raw_dev = torch.from_numpy(raw).cuda()
        run_scopes(card, record, raw_dev, meta, phases)
        del raw_dev
        launches5, lib5 = run_config5(card, record, phases, root5, catalog5,
                                      configs.LIBRARY5)
        run_generate_cache(card, root5, phases)
        lib5.close()
        slice19_s = time.perf_counter() - t19
        # the multi-device paths (config 18), dryrun_multichip and the
        # Lightroom roll (config 19)
        t20 = time.perf_counter()
        with timed(phases, "mosaic18 upload"):
            raw_dev = torch.from_numpy(raw).cuda()
        launches18 = run_config18(card, record, raw_dev, meta, phases)
        del raw_dev
        run_dryrun(phases)
        launches19 = run_config19(card, record, phases, root19, roll19)
        slice20_s = time.perf_counter() - t20
        run_lut3d_pil(card, record, raw, meta, phases)
    # launches per image: config 2's for the first five kernels, config
    # 3's for the IIR and diffuse kernels, config 4's for Markesteijn and
    # the warp, config 7's for the grid slice
    launches.update(iir=launches3["iir"], diffuse=launches3["diffuse"],
                    markesteijn=launches4["markesteijn"],
                    warp=launches4["warp"], bgrid=launches7["bgrid"])
    print(f"[done] total {time.perf_counter() - t0:.1f} s, of which "
          f"[pipe15], [demosaic-methods] and [highlight-modes] "
          f"{branches_s:.1f} s, [pipe16], [diffuse-wide], [opcode] "
          f"filmic-spline and [ops16] {slice16_s:.1f} s, [nn], [pipe17], "
          f"[scopes], [pipe5] and [generate-cache] {slice19_s:.1f} s, "
          f"[pipe18], [dryrun] and [pipe19] {slice20_s:.1f} s | "
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
            # and config 11's arguments; every blend mode and mask class
            # as a blend record on config 13's chain inputs
            entry_["opcodes"] = (record["opcodes10"] + record["opcodes11"]
                                 + record["opcodes16"])
            entry_["blend_records"] = record["blend-modes"]
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
    # config 13: its four chain programs (the blend records inside), each
    # with its launches in [pipe13]
    for j in range(LAUNCHES13["chain"]):
        row = record[f"chain13.{j}"]
        kernels.append({"name": f"pointwise_chain[config13.{j}]",
                        "route": "cuda",
                        "source": "ansel_tpu_torch/csrc/pointwise_chain.cu",
                        "replaces": "ansel_tpu/kernels/pointwise.py:30",
                        "launches": launches13["programs"][row["program"]],
                        **{k: row[k] for k in keys}})
    # config 14: its three chain programs, each with its launches in
    # [pipe14]; the fast pipes' chain (config 1's program) in [fastpipe]
    for j in range(LAUNCHES14["chain"]):
        row = record[f"chain14.{j}"]
        kernels.append({"name": f"pointwise_chain[config14.{j}]",
                        "route": "cuda",
                        "source": "ansel_tpu_torch/csrc/pointwise_chain.cu",
                        "replaces": "ansel_tpu/kernels/pointwise.py:30",
                        "launches": launches14["programs"][row["program"]],
                        **{k: row[k] for k in keys}})
    for pipe_type, fl in launches_fast.items():
        row = record[f"chain-{pipe_type}"]
        kernels.append({"name": f"pointwise_chain[{pipe_type}.0]",
                        "route": "cuda",
                        "source": "ansel_tpu_torch/csrc/pointwise_chain.cu",
                        "replaces": "ansel_tpu/kernels/pointwise.py:30",
                        "launches": fl["programs"][row["program"]],
                        **{k: row[k] for k in keys}})
    # config 15: RCD under the dual blend, sepblur in the guided
    # Laplacian (its numbers per launch, `per_image` over the 360) and
    # config 1's chain program, each with its launches in [pipe15]; the
    # Markesteijn kernel under X-Trans dual, its launches in that step of
    # [demosaic-methods]
    for name, src, replaces, key, n in (
            ("rcd_demosaic[config15]", "rcd.cu",
             "ansel_tpu/kernels/rcd_pallas.py:189", "rcd15",
             launches15["rcd"]),
            ("sep_blur[config15]", "sepblur.cu",
             "ansel_tpu/kernels/sepblur_pallas.py:189", "sepblur15",
             launches15["sepblur"]),
            ("xtrans_markesteijn[xtrans-dual]", "markesteijn.cu",
             "ansel_tpu/kernels/markesteijn_pallas.py:372",
             "markesteijn-dual", mark_dual)):
        entry_ = {"name": name, "route": "cuda",
                  "source": f"ansel_tpu_torch/csrc/{src}",
                  "replaces": replaces, "launches": n,
                  **{k: record[key][k] for k in keys}}
        if key == "sepblur15":
            entry_["per_image"] = record[key]["per_image"]
        kernels.append(entry_)
    row = record["chain15.0"]
    kernels.append({"name": "pointwise_chain[config15.0]", "route": "cuda",
                    "source": "ansel_tpu_torch/csrc/pointwise_chain.cu",
                    "replaces": "ansel_tpu/kernels/pointwise.py:30",
                    "launches": launches15["programs"][row["program"]],
                    **{k: row[k] for k in keys}})
    # config 16: RCD on its noisy mosaic, EAW on the automatic profile's
    # wavelets, sepblur in the 8-scale decompose of diffuse (its numbers
    # per launch, `per_image` over the 8) and its two chain programs,
    # each with its launches in [pipe16]
    for name, src, replaces, key, n in (
            ("rcd_demosaic[config16]", "rcd.cu",
             "ansel_tpu/kernels/rcd_pallas.py:189", "rcd16",
             launches16["rcd"]),
            ("eaw_dn_coarse[config16]", "eaw.cu",
             "ansel_tpu/kernels/eaw_pallas.py:199", "eaw16",
             launches16["eaw"]),
            ("sep_blur[config16]", "sepblur.cu",
             "ansel_tpu/kernels/sepblur_pallas.py:189", "sepblur16",
             launches16["sepblur"])):
        entry_ = {"name": name, "route": "cuda",
                  "source": f"ansel_tpu_torch/csrc/{src}",
                  "replaces": replaces, "launches": n,
                  **{k: record[key][k] for k in keys}}
        if key == "sepblur16":
            entry_["per_image"] = record[key]["per_image"]
        kernels.append(entry_)
    for j in range(LAUNCHES16["chain"]):
        row = record[f"chain16.{j}"]
        kernels.append({"name": f"pointwise_chain[config16.{j}]",
                        "route": "cuda",
                        "source": "ansel_tpu_torch/csrc/pointwise_chain.cu",
                        "replaces": "ansel_tpu/kernels/pointwise.py:30",
                        "launches": launches16["programs"][row["program"]],
                        **{k: row[k] for k in keys}})
    # config 17: RCD on its denoised mosaic and config 1's program, each
    # with its launches in [pipe17]; config 5: RCD on its Bayer images,
    # Markesteijn on its X-Trans images and config 1's program on each
    # kind of image, each with its launches in [pipe5]'s timed pass
    for name, src, replaces, key, n in (
            ("rcd_demosaic[config17]", "rcd.cu",
             "ansel_tpu/kernels/rcd_pallas.py:189", "rcd17",
             launches17["rcd"]),
            ("pointwise_chain[config17.0]", "pointwise_chain.cu",
             "ansel_tpu/kernels/pointwise.py:30", "chain17.0",
             launches17["programs"][record["chain17.0"]["program"]]),
            ("rcd_demosaic[config5]", "rcd.cu",
             "ansel_tpu/kernels/rcd_pallas.py:189", "rcd5",
             launches5["rcd"]),
            ("xtrans_markesteijn[config5]", "markesteijn.cu",
             "ansel_tpu/kernels/markesteijn_pallas.py:372", "markesteijn5",
             launches5["markesteijn"]),
            ("pointwise_chain[config5.bayer]", "pointwise_chain.cu",
             "ansel_tpu/kernels/pointwise.py:30", "chain5.1",
             launches5["chains"]["bayer"]),
            ("pointwise_chain[config5.xtrans]", "pointwise_chain.cu",
             "ansel_tpu/kernels/pointwise.py:30", "chain5.0",
             launches5["chains"]["xtrans"])):
        kernels.append({"name": name, "route": "cuda",
                        "source": f"ansel_tpu_torch/csrc/{src}",
                        "replaces": replaces, "launches": n,
                        **{k: record[key][k] for k in keys}})
    # config 18: each kernel of the multi-device paths on a shard's
    # arguments ((a) dp shard 1's image, (b) sp shard 1's window, (c) band
    # 1's input window), each with its launches over all shards of that
    # path's run; config 19: the Lightroom roll's demosaics, clipping's map
    # and its two interpreted chains, with their launches in [pipe19]'s
    # batch_export
    for name, src, replaces, key, n in (
            ("rcd_demosaic[batch18]", "rcd.cu",
             "ansel_tpu/kernels/rcd_pallas.py:189", "rcd18a",
             launches18["a"]["rcd"]),
            ("pointwise_chain[batch18.0]", "pointwise_chain.cu",
             "ansel_tpu/kernels/pointwise.py:30", "chain18a",
             launches18["a"]["chain"]),
            ("rcd_demosaic[spatial18]", "rcd.cu",
             "ansel_tpu/kernels/rcd_pallas.py:189", "rcd18b",
             launches18["b"]["rcd"]),
            ("eaw_dn_coarse[spatial18]", "eaw.cu",
             "ansel_tpu/kernels/eaw_pallas.py:199", "eaw18b",
             launches18["b"]["eaw"]),
            ("nlm[spatial18]", "nlm.cu",
             "ansel_tpu/kernels/nlm_pallas.py:186", "nlm18b",
             launches18["b"]["nlm"]),
            ("pointwise_chain[spatial18.0]", "pointwise_chain.cu",
             "ansel_tpu/kernels/pointwise.py:30", "chain18b.0",
             launches18["b programs"][record["chain18b.0"]["program"]]),
            ("pointwise_chain[spatial18.1]", "pointwise_chain.cu",
             "ansel_tpu/kernels/pointwise.py:30", "chain18b.1",
             launches18["b programs"][-1]),
            ("rcd_demosaic[sharded18]", "rcd.cu",
             "ansel_tpu/kernels/rcd_pallas.py:189", "rcd18c",
             launches18["c"]["rcd"]),
            ("pointwise_chain[sharded18.0]", "pointwise_chain.cu",
             "ansel_tpu/kernels/pointwise.py:30", "chain18c",
             launches18["c"]["chain"]),
            ("rcd_demosaic[config19]", "rcd.cu",
             "ansel_tpu/kernels/rcd_pallas.py:189", "rcd19",
             launches19["rcd"]),
            ("xtrans_markesteijn[config19]", "markesteijn.cu",
             "ansel_tpu/kernels/markesteijn_pallas.py:372", "markesteijn19",
             launches19["markesteijn"]),
            ("clip_warp[config19]", "warp.cu",
             "ansel_tpu/kernels/warp_pallas.py:121", "warp19",
             launches19["warp"]),
            ("sep_blur[config19]", "sepblur.cu",
             "ansel_tpu/kernels/sepblur_pallas.py:189", "sepblur19",
             launches19["sepblur"]),
            ("pointwise_chain[config19.0]", "pointwise_chain.cu",
             "ansel_tpu/kernels/pointwise.py:30", "chain19.0",
             launches19["chains"][0]),
            ("pointwise_chain[config19.1]", "pointwise_chain.cu",
             "ansel_tpu/kernels/pointwise.py:30", "chain19.1",
             launches19["chains"][1])):
        kernels.append({"name": name, "route": "cuda",
                        "source": f"ansel_tpu_torch/csrc/{src}",
                        "replaces": replaces, "launches": n,
                        **{k: record[key][k] for k in keys}})
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
