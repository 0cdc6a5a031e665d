"""Fused per-pixel colour chain: the CUDA kernel
(`csrc/pointwise_chain.cu`) and its plain twin.

Replaces `ansel_tpu/kernels/pointwise.py:pallas_pointwise` as the engine
uses it: a group of consecutive per-pixel stages runs as one pass over a
(3, H, W) float32 image.  The Pallas kernel takes a traced Python
function; CUDA cannot, so each stage names an opcode with a body written
in the kernel, and `pack_chain` turns the group into a small program:
per stage an opcode, an offset into a float32 consts buffer and up to
eight static ints.  The plain twin runs the stages' torch functions in
order.

`pointwise_chain` launches the kernel for a CUDA tensor and runs
`pointwise_chain_reference` for a CPU tensor.
"""

from __future__ import annotations

import ctypes
import dataclasses
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
_KNOWN_OPS = {OP_EXPOSURE, OP_MATRIX, OP_CHANNELMIXERRGB, OP_FILMIC_AGX,
              OP_COLOROUT, OP_CONVERT_WORK_LAB, OP_CONVERT_LAB_WORK}
TRC_SRGB, TRC_LINEAR, TRC_GAMMA = 0, 1, 2
MAX_STAGES = 16
STAGE_INTS = 8
RECORD = 2 + STAGE_INTS
MAX_CONSTS = 1024

# launches of the CUDA kernel since the count was last set to 0
LAUNCHES = 0


@dataclasses.dataclass(frozen=True)
class Chain:
    """One fused group in both forms: `stages` = ((fn, coeffs), ...) for
    the plain twin; `prog` (int32) and `consts` (float32) on the group's
    device for the kernel."""

    stages: Tuple[Tuple[Any, Any], ...]
    prog: torch.Tensor
    consts: torch.Tensor


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
    return Chain(
        stages=tuple((spec.fn, c) for spec, c in zip(specs, coeffs)),
        prog=torch.tensor(prog, dtype=torch.int32, device=device),
        consts=torch.tensor(consts or [0.0], dtype=torch.float32,
                            device=device))


def pointwise_chain_reference(x: torch.Tensor, chain: Chain) -> torch.Tensor:
    """Plain torch: the stages' functions in order."""
    for fn, c in chain.stages:
        x = fn(x, c)
    return x


def _lib():
    from . import _build

    lib = _build.load("pointwise_chain")
    if not getattr(lib, "_typed", False):
        p = ctypes.c_void_p
        lib.pointwise_chain.argtypes = [p, p, ctypes.c_longlong, p,
                                        ctypes.c_int, p, ctypes.c_int,
                                        ctypes.c_int, p]
        lib.pointwise_chain.restype = ctypes.c_int
        for fn in ("pointwise_chain_record", "pointwise_chain_max_stages",
                   "pointwise_chain_max_consts"):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = ctypes.c_int
        if (lib.pointwise_chain_record(), lib.pointwise_chain_max_stages(),
                lib.pointwise_chain_max_consts()) != (RECORD, MAX_STAGES,
                                                      MAX_CONSTS):
            raise RuntimeError("csrc/pointwise_chain.cu and "
                               "kernels/pointwise.py disagree on the layout")
        lib._typed = True
    return lib


def pointwise_chain(x: torch.Tensor, chain: Chain) -> torch.Tensor:
    """(3, H, W) float32 -> (3, H, W) through every stage of `chain`.  A
    CPU tensor runs the plain twin; a CUDA tensor launches
    csrc/pointwise_chain.cu once."""
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
        rc = lib.pointwise_chain(x.data_ptr(), y.data_ptr(), n,
                                 prog.data_ptr(), nstages, consts.data_ptr(),
                                 consts.numel(), sms, stream)
    if rc != 0:
        raise RuntimeError(f"pointwise_chain: CUDA launch failed ({rc})")
    LAUNCHES += 1
    return y
