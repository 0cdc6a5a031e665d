"""Core value types for the TPU-native pixel pipeline.

These replace the reference's buffer-descriptor / ROI machinery
(`ansel/src/develop/format.h`, `dt_iop_buffer_dsc_t`;
`src/develop/dev_pixelpipe.c:516-643` ROI planner) with *host-side static*
metadata: everything geometric is resolved before tracing so the jitted XLA
graph sees only static shapes.

Image data convention (TPU-first, not the reference's interleaved RGBA):
  * mosaic stage: one plane, shape ``(H, W)`` float32, CFA metadata alongside
  * RGB stages:   planar, shape ``(3, H, W)`` float32 — W maps to TPU lanes,
    H to sublanes, so spatial stencils tile naturally onto the VPU and
    per-pixel channel mixes are einsums over the tiny leading axis.

Arrays are padded once after load to lane/sublane multiples (see
``PadSpec``); the logical (valid) size travels in ``ImageSpec``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

LANE = 128     # TPU lane count: last-dim alignment target
SUBLANE = 8    # float32 sublane count: second-to-last-dim alignment target


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class Colorspace(enum.Enum):
    """Pipeline colorspace tags (cf. reference `dt_iop_colorspace_type_t`,
    src/develop/imageop.h — RAW/RGB/LAB/SCENE/DISPLAY distinctions)."""

    RAW = "raw"              # single-plane CFA mosaic, linear sensor units
    CAMERA_RGB = "camera"    # demosaiced, still in camera native RGB
    WORK_RGB = "work"        # linear working space (Rec2020 by default)
    LAB = "lab"              # CIE Lab (legacy display-referred ops)
    DISPLAY_RGB = "display"  # output space after colorout (possibly nonlinear)


class CFAPattern(enum.Enum):
    """2x2 Bayer phase: the color of (row 0, col 0), reading order RGGB etc.
    X-Trans carries its own 6x6 pattern matrix in RawMeta.xtrans."""

    RGGB = "RGGB"
    BGGR = "BGGR"
    GRBG = "GRBG"
    GBRG = "GBRG"
    XTRANS = "XTRANS"

    def color_at(self, y: int, x: int) -> int:
        """Color index (0=R,1=G,2=B) at mosaic position (y, x)."""
        if self is CFAPattern.XTRANS:
            raise ValueError("use RawMeta.xtrans for X-Trans sensors")
        s = self.value  # row-major 2x2: s[0]=(0,0) s[1]=(0,1) s[2]=(1,0) s[3]=(1,1)
        c = s[(y % 2) * 2 + (x % 2)]
        return {"R": 0, "G": 1, "B": 2}[c]

    def shifted(self, dy: int, dx: int) -> "CFAPattern":
        """Pattern seen when the origin moves by (dy, dx) — the reference
        recomputes demosaic phase per crop offset (doc/resizing-scaling.md)."""
        if self is CFAPattern.XTRANS:
            return self
        grid = [[self.color_at(y, x) for x in range(2)] for y in range(2)]
        names = "RGB"
        s = "".join(
            names[grid[(y + dy) % 2][(x + dx) % 2]] for y in range(2) for x in range(2)
        )
        return CFAPattern(s)


@dataclasses.dataclass(frozen=True)
class ROI:
    """A requested output window, reference `dt_iop_roi_t`
    (src/develop/imageop.h): integer window plus a scale relative to the
    full processed image."""

    x: int = 0
    y: int = 0
    width: int = 0
    height: int = 0
    scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class ImageSpec:
    """Static per-stage metadata threaded through planning.

    ``width``/``height`` are the *logical* (valid) pixel counts; the backing
    array is ``(channels?, pad_h, pad_w)`` with edge-replicated padding.
    """

    width: int
    height: int
    colorspace: Colorspace
    channels: int = 3
    pad_w: int = 0
    pad_h: int = 0
    # CFA phase of pixel (0,0) of *this* buffer (mosaic stages only)
    cfa: Optional[CFAPattern] = None
    # Backward-ROI windowing (reference modify_roi_in,
    # dev_pixelpipe.c:564-643): when this spec describes a WINDOW of a
    # larger logical frame, (org_y, org_x) is the window origin and
    # full_h/full_w the frame it was cut from.  Position-dependent ops
    # (lens center, clipping geometry, mask rasterization) must compute
    # in frame coordinates: absolute = buffer index + org.
    org_y: int = 0
    org_x: int = 0
    full_h: int = 0
    full_w: int = 0

    def __post_init__(self):
        if self.pad_w == 0:
            object.__setattr__(self, "pad_w", round_up(max(self.width, LANE), LANE))
        if self.pad_h == 0:
            object.__setattr__(self, "pad_h", round_up(max(self.height, SUBLANE), SUBLANE))
        if self.full_h == 0:
            object.__setattr__(self, "full_h", self.org_y + self.height)
        if self.full_w == 0:
            object.__setattr__(self, "full_w", self.org_x + self.width)

    @property
    def is_window(self) -> bool:
        return (self.org_y, self.org_x) != (0, 0) \
            or (self.full_h, self.full_w) != (self.height, self.width)

    @property
    def array_shape(self) -> Tuple[int, ...]:
        if self.colorspace is Colorspace.RAW:
            return (self.pad_h, self.pad_w)
        return (self.channels, self.pad_h, self.pad_w)

    def with_size(self, width: int, height: int, **kw) -> "ImageSpec":
        return dataclasses.replace(
            self, width=width, height=height, pad_w=0, pad_h=0, **kw
        )

    def with_colorspace(self, cs: Colorspace, channels: int = 3) -> "ImageSpec":
        return dataclasses.replace(self, colorspace=cs, channels=channels, cfa=None)


@dataclasses.dataclass(frozen=True)
class DngGainMap:
    """One DNG GainMap opcode from OpcodeList2 (opcode id 9).

    Reference: `src/common/dng_opcode.h:46-70` (struct layout) and
    `src/common/dng_opcode.c:57-130` (big-endian wire parse)."""

    top: int = 0
    left: int = 0
    bottom: int = 0
    right: int = 0
    plane: int = 0
    planes: int = 1
    row_pitch: int = 2
    col_pitch: int = 2
    map_points_v: int = 0
    map_points_h: int = 0
    map_spacing_v: float = 1.0
    map_spacing_h: float = 1.0
    map_origin_v: float = 0.0
    map_origin_h: float = 0.0
    map_planes: int = 1
    map_gain: Tuple[float, ...] = ()


@dataclasses.dataclass(frozen=True)
class RawMeta:
    """Decoded-raw metadata (the subset of reference `dt_image_t`,
    src/common/image.h:310-380, that the pipeline consumes)."""

    width: int
    height: int
    cfa: CFAPattern = CFAPattern.RGGB
    # sensor calibration (rawprepare inputs)
    black_levels: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    white_point: float = 65535.0
    # crop of the visible area inside the full sensor frame
    crop_x: int = 0
    crop_y: int = 0
    crop_right: int = 0
    crop_bottom: int = 0
    # as-shot white balance multipliers (camera RGB)
    wb_coeffs: Tuple[float, float, float, float] = (2.0, 1.0, 1.5, 0.0)
    # camera RGB -> CIE XYZ (D65-adapted) 3x3, row-major
    cam_to_xyz: Optional[Tuple[float, ...]] = None
    # 6x6 X-Trans pattern (color indices), row-major, or None for Bayer
    xtrans: Optional[Tuple[int, ...]] = None
    iso: float = 100.0
    exposure_bias: float = 0.0
    maker: str = ""
    model: str = ""
    # orientation in EXIF terms handled by flip op
    orientation: int = 0
    # DNG OpcodeList2 GainMaps (flat-field), image.h `dng_gain_maps`
    gain_maps: Tuple["DngGainMap", ...] = ()
