"""Fused per-pixel colour chain: the CUDA kernel
(`csrc/pointwise_chain.cu`) and its plain twin.

Replaces `ansel_tpu/kernels/pointwise.py:pallas_pointwise` as the engine
uses it: a group of consecutive per-pixel stages runs as one pass over a
(3, H, W) float32 image.  The Pallas kernel takes a traced Python
function; CUDA cannot, so each stage names an opcode with a body written
in the kernel, and `pack_chain` turns the group into a small program:
per stage an opcode, an offset into a float32 consts buffer and up to
eight static ints.  The plain twin runs the stages' torch functions in
order; a stage that reads pixel positions (`needs_pos`, the Pallas
kernel's `with_pos`) gets each pixel's row and column in the array.

A blended stage (`pipeline/blend.blend_specs`) is wrapped in two
records: a keep record before it holds the pixel it receives, and a
blend record after it mixes the stage's output with that pixel, as the
JAX engine's fused chain calls `apply_blend_pointwise` on the same tile
(`ansel_tpu/pipeline/engine.py:549-558`).  Records count against
MAX_STAGES and the blend record's consts against MAX_CONSTS.

The programs the configs build (`FIXED`) each have a kernel of their own
in the same source, with the opcodes and const offsets as template
parameters and the consts and ints passed by value; `pack_chain` marks a
chain that matches one, and every other chain runs the kernel's
interpreter.

`pointwise_chain` launches a kernel for a CUDA tensor and runs
`pointwise_chain_reference` for a CPU tensor.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import math
from typing import Any, Tuple

import torch

# opcodes and record layout: keep in step with csrc/pointwise_chain.cu
OP_EXPOSURE = 1
OP_MATRIX = 2
OP_CHANNELMIXERRGB = 3
OP_FILMIC_AGX = 4
OP_COLOROUT = 5
OP_CONVERT_WORK_LAB = 6
OP_CONVERT_LAB_WORK = 7
OP_COLORBALANCERGB = 8
OP_RGBCURVE = 9
OP_RGBLEVELS = 10
OP_BASECURVE = 11
OP_TONECURVE = 12
OP_LEVELS = 13
OP_BASICADJ = 14
OP_COLORZONES = 15
OP_NEGADOCTOR = 16
OP_VIGNETTE = 17
OP_GRADUATEDND = 18
OP_VELVIA = 19
OP_VIBRANCE = 20
OP_COLORCONTRAST = 21
OP_COLORCORRECTION = 22
OP_COLISA = 23
OP_SPLITTONING = 24
OP_COLORIZE = 25
OP_COLORBALANCE = 26
OP_SPLITTONINGRGB = 27
OP_LOWLIGHT = 28
OP_PROFILE_GAMMA = 29
OP_COLORCHECKER = 30
OP_KEEP = 31    # holds the pixel before a blended stage
OP_BLEND = 32   # mixes the stage's output with the held pixel
OP_FILMIC_SPLINE = 33
_KNOWN_OPS = frozenset(range(OP_EXPOSURE, OP_FILMIC_SPLINE + 1))
TRC_SRGB, TRC_LINEAR, TRC_GAMMA = 0, 1, 2
MAX_STAGES = 16
STAGE_INTS = 8
RECORD = 2 + STAGE_INTS
MAX_CONSTS = 1024
# a specialised program's consts travel in its kernel's parameters: 4 KB
# of them, and the ints, stay inside the 32764 bytes of kernel parameters
# that CUDA 12.1 and later allow on Volta and newer (config 10's second
# chain needs 388)
FIXED_CONSTS = 1024

# the specialised programs, as ((opcode, const offset), ...) per stage, in
# the order of csrc/pointwise_chain.cu's `Fixed` (the library reports
# its list and `_lib` checks the two agree)
FIXED = (
    # config 1: exposure, colorin, channelmixerrgb, filmicrgb, colorout
    ((OP_EXPOSURE, 0), (OP_MATRIX, 2), (OP_CHANNELMIXERRGB, 11),
     (OP_FILMIC_AGX, 78), (OP_COLOROUT, 148)),
    # configs 2 and 4: exposure, colorin, filmicrgb, colorout
    ((OP_EXPOSURE, 0), (OP_MATRIX, 2), (OP_FILMIC_AGX, 11), (OP_COLOROUT, 81)),
    # config 3: exposure; colorin; filmicrgb + to Lab; from Lab + colorout
    # (also config 7's last)
    ((OP_EXPOSURE, 0),),
    ((OP_MATRIX, 0),),
    ((OP_FILMIC_AGX, 0), (OP_CONVERT_WORK_LAB, 70)),
    ((OP_CONVERT_LAB_WORK, 0), (OP_COLOROUT, 12)),
    # config 7: exposure, colorin, to Lab; from Lab, filmicrgb, to Lab
    ((OP_EXPOSURE, 0), (OP_MATRIX, 2), (OP_CONVERT_WORK_LAB, 11)),
    ((OP_CONVERT_LAB_WORK, 0), (OP_FILMIC_AGX, 12), (OP_CONVERT_WORK_LAB, 82)),
    # the default pipe without an exposure edit, with and without
    # channelmixerrgb: colorin, [channelmixerrgb,] filmicrgb, colorout
    ((OP_MATRIX, 0), (OP_CHANNELMIXERRGB, 9), (OP_FILMIC_AGX, 76),
     (OP_COLOROUT, 146)),
    ((OP_MATRIX, 0), (OP_FILMIC_AGX, 9), (OP_COLOROUT, 79)),
    # config 11: exposure, colorin, channelmixerrgb, colorbalance,
    # filmicrgb, to Lab, colisa, colorcontrast, from Lab, velvia, to Lab,
    # vibrance, from Lab, splittoning, colorout
    ((OP_EXPOSURE, 0), (OP_MATRIX, 2), (OP_CHANNELMIXERRGB, 11),
     (OP_COLORBALANCE, 78), (OP_FILMIC_AGX, 94), (OP_CONVERT_WORK_LAB, 164),
     (OP_COLISA, 176), (OP_COLORCONTRAST, 181), (OP_CONVERT_LAB_WORK, 187),
     (OP_VELVIA, 199), (OP_CONVERT_WORK_LAB, 201), (OP_VIBRANCE, 213),
     (OP_CONVERT_LAB_WORK, 214), (OP_SPLITTONING, 226), (OP_COLOROUT, 232)),
    # config 12: exposure, colorin; filmicrgb alone after its highlight
    # reconstruction; to Lab before grain (then config 3's from Lab +
    # colorout)
    ((OP_EXPOSURE, 0), (OP_MATRIX, 2)),
    ((OP_FILMIC_AGX, 0),),
    ((OP_CONVERT_WORK_LAB, 0),),
    # config 13: exposure, colorin, channelmixerrgb blended (a parametric
    # mask of 3 channels), colorbalancergb blended (COLOR), filmicrgb, to
    # Lab, tonecurve blended (LAB_LIGHTNESS); from Lab alone; colorzones
    # blended (OVERLAY under a mask of 1 channel), from Lab, colorout
    ((OP_EXPOSURE, 0), (OP_MATRIX, 2), (OP_KEEP, 11),
     (OP_CHANNELMIXERRGB, 11), (OP_BLEND, 78), (OP_KEEP, 116),
     (OP_COLORBALANCERGB, 116), (OP_BLEND, 285), (OP_FILMIC_AGX, 305),
     (OP_CONVERT_WORK_LAB, 375), (OP_KEEP, 387), (OP_TONECURVE, 387),
     (OP_BLEND, 402)),
    ((OP_CONVERT_LAB_WORK, 0),),
    ((OP_KEEP, 0), (OP_COLORZONES, 0), (OP_BLEND, 49),
     (OP_CONVERT_LAB_WORK, 75), (OP_COLOROUT, 87)),
    # config 14: channelmixerrgb alone, between colorin's ICC profile and
    # the LUTs (its exposure and filmicrgb run config 3's and config 12's)
    ((OP_CHANNELMIXERRGB, 0),),
    # config 16: filmicrgb's spline route (colour science v5), colorout;
    # the spline alone after a highlight reconstruction (its exposure and
    # colorin run config 12's first)
    ((OP_FILMIC_SPLINE, 0), (OP_COLOROUT, 57)),
    ((OP_FILMIC_SPLINE, 0),),
    # config 10: exposure, graduatednd, colorin, channelmixerrgb, to Lab;
    # from Lab, colorbalancergb, rgbcurve, filmicrgb, to Lab, tonecurve,
    # colorzones, from Lab, vignette, colorout
    ((OP_EXPOSURE, 0), (OP_GRADUATEDND, 2), (OP_MATRIX, 16),
     (OP_CHANNELMIXERRGB, 25), (OP_CONVERT_WORK_LAB, 92)),
    ((OP_CONVERT_LAB_WORK, 0), (OP_COLORBALANCERGB, 12), (OP_RGBCURVE, 181),
     (OP_FILMIC_AGX, 211), (OP_CONVERT_WORK_LAB, 281), (OP_TONECURVE, 293),
     (OP_COLORZONES, 308), (OP_CONVERT_LAB_WORK, 357), (OP_VIGNETTE, 369),
     (OP_COLOROUT, 379)),
)

# launches of the CUDA kernels since the count was last set to 0: one per
# call, whether it runs a specialised program or the interpreter; and the
# same per program (its index in FIXED, -1 the interpreter)
LAUNCHES = 0
PROGRAM_LAUNCHES = collections.Counter()


@dataclasses.dataclass(frozen=True)
class Chain:
    """One fused group in both forms: `stages` = ((fn, coeffs,
    needs_pos), ...) for the plain twin; `prog` (int32) and `consts`
    (float32) on the group's device for the interpreter; `fixed`, the index in FIXED of the
    specialised program it matches (-1: none), with its stages' ints and
    its consts as host arrays for that kernel's parameters."""

    stages: Tuple[Tuple[Any, Any], ...]
    prog: torch.Tensor
    consts: torch.Tensor
    fixed: int = -1
    host_ints: Any = None
    host_consts: Any = None
    # per stage: True for a blend record, whose fn(kept, x, c) reads the
    # pixel the last keep record held
    reads_kept: Tuple[bool, ...] = ()


def _flat(v):
    return torch.as_tensor(v, dtype=torch.float32).reshape(-1).cpu().tolist()


def pack_chain(specs, coeffs, device) -> Chain:
    """PointwiseSpecs and their stages' coefficient dicts -> Chain."""
    if not 0 < len(specs) <= MAX_STAGES:
        raise ValueError(f"a chain holds 1..{MAX_STAGES} stages, "
                         f"got {len(specs)}")
    prog, consts = [], []
    for spec, c in zip(specs, coeffs):
        if spec.opcode not in _KNOWN_OPS:
            raise ValueError(f"unknown chain opcode {spec.opcode}")
        if len(spec.ints) > STAGE_INTS:
            raise ValueError(f"opcode {spec.opcode}: more than "
                             f"{STAGE_INTS} static ints")
        ints = [int(v) for v in spec.ints]
        prog += [spec.opcode, len(consts)] + ints \
            + [0] * (STAGE_INTS - len(ints))
        for name in spec.consts:
            consts += _flat(c[name])
        consts += [float(v) for v in spec.extra]
    if len(consts) > MAX_CONSTS:
        raise ValueError(f"chain needs {len(consts)} consts > {MAX_CONSTS}")
    key = tuple((prog[s], prog[s + 1]) for s in range(0, len(prog), RECORD))
    fixed = FIXED.index(key) if key in FIXED \
        and len(consts) <= FIXED_CONSTS else -1
    ints = [v for s in range(0, len(prog), RECORD)
            for v in prog[s + 2:s + RECORD]]
    return Chain(
        stages=tuple((spec.fn, c, spec.needs_pos)
                     for spec, c in zip(specs, coeffs)),
        prog=torch.tensor(prog, dtype=torch.int32, device=device),
        consts=torch.tensor(consts or [0.0], dtype=torch.float32,
                            device=device),
        fixed=fixed,
        host_ints=(ctypes.c_int * len(ints))(*ints),
        host_consts=(ctypes.c_float * max(1, len(consts)))(*consts),
        reads_kept=tuple(spec.reads_kept for spec in specs))


def positions(x: torch.Tensor):
    """(yy, xx): each pixel's float32 row and column in x (C, H, W), as
    the Pallas kernel's iota gives them to a `with_pos` stage."""
    _, h, w = x.shape
    yy = torch.arange(h, dtype=torch.float32, device=x.device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=x.device)[None, :]
    return yy.expand(h, w), xx.expand(h, w)


def pointwise_chain_reference(x: torch.Tensor, chain: Chain) -> torch.Tensor:
    """Plain torch: the stages' functions in order; a stage that reads
    pixel positions gets them as `positions(x)`, a blend record the
    image the last keep record (an identity) received."""
    pos = kept = None
    for (fn, c, needs_pos), blend in zip(chain.stages, chain.reads_kept):
        if blend:
            x = fn(kept, x, c)
            continue
        kept = x
        if needs_pos:
            pos = positions(x) if pos is None else pos
            x = fn(x, c, *pos)
        else:
            x = fn(x, c)
    return x


def atan_pos(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """atan2(y, x) restricted to the first quadrant (y, x >= 0), as the
    Pallas kernels compute it (their TPU lowering has no atan): a minimax
    odd polynomial on [0, 1] in Horner form plus the fold
    atan(t) = pi/2 - atan(1/t).  |err| < 2e-7 rad."""
    big = torch.clamp(torch.maximum(x, y), min=1e-20)
    small = torch.minimum(x, y)
    z = small / big
    s = z * z
    u = 0.00282363896258175373077393
    for k in _ATAN_POLY:
        u = u * s + k
    theta = u * s * z + z
    return torch.where(y > x, math.pi / 2.0 - theta, theta)


_ATAN_POLY = (-0.0159569028764963150024414, 0.0425049886107444763183594,
              -0.0748900920152664184570312, 0.106347933411598205566406,
              -0.142027363181114196777344, 0.199926957488059997558594,
              -0.333331018686294555664062)


def atan2_full(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Full-range atan2(y, x) from the first-quadrant polynomial, folded
    by the signs of x and y.  |err| < 2e-7 rad."""
    t = atan_pos(torch.abs(y), torch.abs(x))
    t = torch.where(x < 0.0, math.pi - t, t)
    return torch.where(y < 0.0, -t, t)


def _lib():
    from . import _build

    lib = _build.load("pointwise_chain")
    if not getattr(lib, "_typed", False):
        p = ctypes.c_void_p
        lib.pointwise_chain.argtypes = [p, p, ctypes.c_longlong,
                                        ctypes.c_int, p, ctypes.c_int, p,
                                        ctypes.c_int, ctypes.c_int, p]
        lib.pointwise_chain.restype = ctypes.c_int
        lib.pointwise_chain_fixed.argtypes = [ctypes.c_int, p, p,
                                              ctypes.c_longlong,
                                              ctypes.c_int, p, p,
                                              ctypes.c_int, p]
        lib.pointwise_chain_fixed.restype = ctypes.c_int
        lib.pointwise_chain_fixed_program.argtypes = [ctypes.c_int, p, p]
        lib.pointwise_chain_fixed_program.restype = ctypes.c_int
        for fn in ("pointwise_chain_record", "pointwise_chain_max_stages",
                   "pointwise_chain_max_consts",
                   "pointwise_chain_fixed_consts",
                   "pointwise_chain_fixed_count"):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = ctypes.c_int
        if (lib.pointwise_chain_record(), lib.pointwise_chain_max_stages(),
                lib.pointwise_chain_max_consts(),
                lib.pointwise_chain_fixed_consts()) != (
                    RECORD, MAX_STAGES, MAX_CONSTS, FIXED_CONSTS) \
                or _fixed_programs(lib) != FIXED:
            raise RuntimeError("csrc/pointwise_chain.cu and "
                               "kernels/pointwise.py disagree on the layout")
        lib._typed = True
    return lib


def _fixed_programs(lib):
    """The library's specialised programs, in FIXED's form."""
    out = []
    for i in range(lib.pointwise_chain_fixed_count()):
        ops, offs = (ctypes.c_int * MAX_STAGES)(), (ctypes.c_int * MAX_STAGES)()
        n = lib.pointwise_chain_fixed_program(i, ops, offs)
        out.append(tuple(zip(ops[:n], offs[:n])))
    return tuple(out)


def pointwise_chain(x: torch.Tensor, chain: Chain) -> torch.Tensor:
    """(3, H, W) float32 -> (3, H, W) through every stage of `chain`.  A
    CPU tensor runs the plain twin; a CUDA tensor launches one kernel of
    csrc/pointwise_chain.cu: the chain's specialised program, or the
    interpreter when it has none (`fixed` -1).  The kernel derives a
    stage's pixel positions from the flat index and W."""
    if x.device.type == "cpu":
        return pointwise_chain_reference(x, chain)
    if x.device.type != "cuda":
        raise ValueError(f"pointwise_chain: unsupported device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 3 or x.shape[0] != 3 \
            or not x.is_contiguous():
        raise ValueError("pointwise_chain: needs a contiguous (3, H, W) "
                         f"float32 tensor, got {x.dtype} {tuple(x.shape)}")
    prog, consts = chain.prog, chain.consts
    if prog.device != x.device or consts.device != x.device:
        raise ValueError("pointwise_chain: the chain was packed for "
                         f"{prog.device}, the image is on {x.device}")
    nstages = prog.numel() // RECORD
    global LAUNCHES
    lib = _lib()
    y = torch.empty_like(x)
    n = x.shape[1] * x.shape[2]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if chain.fixed >= 0:
            rc = lib.pointwise_chain_fixed(
                chain.fixed, x.data_ptr(), y.data_ptr(), n, x.shape[2],
                chain.host_ints, chain.host_consts, len(chain.host_consts),
                stream)
        else:
            rc = lib.pointwise_chain(x.data_ptr(), y.data_ptr(), n,
                                     x.shape[2], prog.data_ptr(), nstages,
                                     consts.data_ptr(), consts.numel(), sms,
                                     stream)
    if rc != 0:
        raise RuntimeError(f"pointwise_chain: CUDA launch failed ({rc})")
    LAUNCHES += 1
    PROGRAM_LAUNCHES[chain.fixed] += 1
    return y
