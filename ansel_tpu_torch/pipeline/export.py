"""Headless export — the ansel-cli semantics (`ansel_tpu/pipeline/
export.py`).

Reference: `ansel/src/apps/ansel-cli/main.c:198-863` +
`src/imageio/imageio_core.c:931-1150` (dt_imageio_export_with_flags):
raw + sidecar history -> planned pipe -> render -> encode.  The pipe
runs on the CUDA card unless the caller passes `device="cpu"`.

A bounding box that shrinks the image gives a scale below 1, for which
`Pipeline` injects initialscale, as the JAX package does.  The
sidecar's drawn forms (`XMPDocument.masks`) go to the pipe with its
history.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..core.types import RawMeta
from ..io import encode
from ..io.xmp import parse_xmp
from .engine import CompiledPipe, HistoryItem, Pipeline


@dataclasses.dataclass
class ExportSettings:
    """Subset of the reference's export options (imageio_core.c)."""

    max_width: int = 0      # 0 = native
    max_height: int = 0
    quality: int = 92
    format: str = "jpg"
    bpp: int = 8            # 8 or 16 (png/tiff)
    embed_icc: bool = True  # embed the output sRGB ICC profile
    embed_exif: bool = True  # carry maker/model/ISO over from the raw


def compute_export_scale(meta: RawMeta, s: ExportSettings) -> float:
    """Bounding-box fit (reference _get_export_size, imageio_core.c:1019+)."""
    if not s.max_width and not s.max_height:
        return 1.0
    sx = s.max_width / meta.width if s.max_width else 1.0
    sy = s.max_height / meta.height if s.max_height else 1.0
    return min(sx, sy, 1.0)


def export_image(
    raw: np.ndarray,
    meta: RawMeta,
    history: Optional[List[HistoryItem]] = None,
    xmp_path: Optional[str] = None,
    output_path: Optional[str] = None,
    settings: Optional[ExportSettings] = None,
    pipe_type: str = "export",
    device="cuda",
) -> np.ndarray:
    """raw mosaic + history (explicit or from sidecar) -> display RGB;
    optionally write the encoded file.  Returns (3, H, W) float32."""
    settings = settings or ExportSettings()
    forms = None
    order_version = None
    if history is None:
        if xmp_path:
            doc = parse_xmp(xmp_path)
            history, forms = doc.history, doc.masks
            order_version = doc.iop_order_version
        else:
            history = []
    scale = compute_export_scale(meta, settings)
    pipe = CompiledPipe(Pipeline(meta, history, device=device, scale=scale,
                                 forms=forms, order_version=order_version,
                                 pipe_type=pipe_type))
    out = pipe.output_array(raw)
    if output_path:
        encode.write_image(output_path, out, quality=settings.quality,
                           bpp=settings.bpp,
                           icc=b"srgb" if settings.embed_icc else None,
                           meta=meta if settings.embed_exif else None)
    return out
