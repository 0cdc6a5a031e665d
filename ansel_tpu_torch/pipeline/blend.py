"""Blend parameters: the host data of `ansel_tpu/pipeline/blend.py`.

darktable writes a `blendop_params` blob on every history item, and most
of them decode to `mask_mode == MASK_DISABLED`, which means no blend.
This module holds what the planner needs to tell that apart: the mask
and blend-mode constants (reference `src/develop/blend.h:54-120`), the
v11 struct `BlendParams` with its codec (blend.h:199-238),
`decode_blend_params` (None for a blob it cannot decode, which also
means no blend) and `blend_is_active`.

Not ported: the compositing itself (parametric masks, feathering, the
blend modes), which waits for the blends-and-masks slice (ROADMAP
Queue 1 item 8).  The engine refuses an active blend on a
geometry-preserving stage until then.
"""

from __future__ import annotations

import dataclasses

from ..core.params import cfield, params

# blend colorspace ids (blend.h:54-61)
CS_NONE, CS_RAW, CS_LAB, CS_RGB_DISPLAY, CS_RGB_SCENE = range(5)

# mask modes (blend.h:112-120)
MASK_DISABLED = 0
MASK_ENABLED = 1
MASK_SHAPE = 2
MASK_PARAMETRIC = 4
MASK_RASTER = 8

COMBINE_INV = 0x01
COMBINE_INCL = 0x02
COMBINE_MASKS_POS = 0x04

BLENDIF_SIZE = 16
BLEND_REVERSE = 0x80000000
BLEND_MODE_MASK = 0xFF

# modes (blend.h:63-110)
(B_DISABLED, B_NORMAL_OB, B_LIGHTEN, B_DARKEN, B_MULTIPLY, B_AVERAGE, B_ADD,
 B_SUBTRACT, B_DIFFERENCE, B_SCREEN, B_OVERLAY, B_SOFTLIGHT, B_HARDLIGHT,
 B_VIVIDLIGHT, B_LINEARLIGHT, B_PINLIGHT, B_LIGHTNESS, B_CHROMATICITY,
 B_HUE, B_COLOR) = range(0x14)
B_COLORADJUST = 0x16
B_HSV_VALUE = 0x1C
B_HSV_COLOR = 0x1D
B_DIFFERENCE2 = 0x17
B_NORMAL2 = 0x18
B_BOUNDED = 0x19
B_LAB_LIGHTNESS = 0x1A
B_LAB_COLOR = 0x1B
B_LAB_L = 0x1E
B_LAB_A = 0x1F
B_LAB_B = 0x20
B_RGB_R = 0x21
B_RGB_G = 0x22
B_RGB_B = 0x23
B_SUBTRACT_INVERSE = 0x25
B_DIVIDE = 0x26
B_DIVIDE_INVERSE = 0x27
B_GEOMETRIC_MEAN = 0x28
B_HARMONIC_MEAN = 0x29


@params(op="_blend", version=11)
@dataclasses.dataclass
class BlendParams:
    """dt_develop_blend_params_t v11 (blend.h:199-238)."""

    mask_mode: int = cfield("I", MASK_DISABLED)
    blend_cst: int = cfield("i", CS_NONE)
    blend_mode: int = cfield("I", B_NORMAL2)
    blend_parameter: float = cfield("f", 0.0)
    opacity: float = cfield("f", 100.0)
    mask_combine: int = cfield("I", 0)
    mask_id: int = cfield("I", 0)
    blendif: int = cfield("I", 0)
    feathering_radius: float = cfield("f", 0.0)
    feathering_guide: int = cfield("I", 1)
    blur_radius: float = cfield("f", 0.0)
    contrast: float = cfield("f", 0.0)
    brightness: float = cfield("f", 0.0)
    details: float = cfield("f", 0.0)
    reserved: tuple = cfield("3I", (0, 0, 0))
    blendif_parameters: tuple = cfield(f"{4 * BLENDIF_SIZE}f",
                                       (0.0,) * (4 * BLENDIF_SIZE))
    blendif_boost_factors: tuple = cfield(f"{BLENDIF_SIZE}f",
                                          (0.0,) * BLENDIF_SIZE)
    raster_mask_source: str = cfield("s:20", "")
    raster_mask_instance: int = cfield("i", 0)
    raster_mask_id: int = cfield("i", 0)
    raster_mask_invert: int = cfield("i", 0)


def decode_blend_params(raw: bytes):
    """A v11 blob -> BlendParams; None for None or for any blob the codec
    cannot decode (an older blendop version, a short blob)."""
    if raw is None:
        return None
    try:
        return BlendParams.codec.decode(bytes(raw))
    except Exception:
        return None


def blend_is_active(bp: BlendParams) -> bool:
    return bp is not None and bp.mask_mode != MASK_DISABLED
