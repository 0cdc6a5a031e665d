"""Drawn-mask forms: the host data of `ansel_tpu/pipeline/masks.py`.

A sidecar's `darktable:masks_history` carries each form as a type, an id
and a packed array of node structs (reference `src/develop/masks.h`:
type enum :134-145, node structs :234-291, DEVELOP_MASKS_VERSION 6).
`Form` holds one; `decode_points` unpacks its nodes.  The XMP reader
fills `XMPDocument.masks` with them as the JAX package does.

Not ported: rasterising the forms, which waits for the blends-and-masks
slice (ROADMAP Queue 1 item 8); the engine refuses every active blend,
so no form is read yet.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List

# dt_masks_type_t (masks.h:134-145)
MASK_CIRCLE = 1 << 0
MASK_POLYGON = 1 << 1
MASK_GROUP = 1 << 2
MASK_CLONE = 1 << 3
MASK_GRADIENT = 1 << 4
MASK_ELLIPSE = 1 << 5
MASK_BRUSH = 1 << 6

MASKS_VERSION = 6


@dataclasses.dataclass
class Form:
    """One mask form (dt_masks_form_t analog)."""

    id: int
    type: int
    name: str = ""
    version: int = MASKS_VERSION
    nodes: List[tuple] = dataclasses.field(default_factory=list)
    # clone-source position in normalized coords (dt_masks_form_t.source,
    # serialized as the XMP mask_src blob)
    src: tuple = (0.0, 0.0)

    def points_blob(self) -> bytes:
        fmt, _ = _NODE_CODECS[_base_type(self.type)]
        return b"".join(struct.pack(fmt, *n) for n in self.nodes)

    def src_blob(self) -> bytes:
        return struct.pack("<2f", *self.src)


# struct formats per node type (masks.h:234-291)
_NODE_CODECS = {
    MASK_CIRCLE: ("<4f", 4),            # cx, cy, radius, border
    MASK_ELLIPSE: ("<6fi", 7),          # cx, cy, rx, ry, rotation, border, flags
    MASK_POLYGON: ("<8fi", 9),          # node2 ctrl1_2 ctrl2_2 border2 state
    MASK_BRUSH: ("<10fi", 11),          # ... + density, hardness, state
    MASK_GRADIENT: ("<6fi", 7),         # cx, cy, rotation, extent, steepness,
                                        # curvature, state
    MASK_GROUP: ("<3if", 4),            # formid, parentid, state, opacity
}


def _base_type(t: int) -> int:
    return t & (MASK_CIRCLE | MASK_POLYGON | MASK_GROUP | MASK_GRADIENT
                | MASK_ELLIPSE | MASK_BRUSH)


def decode_points(mask_type: int, blob: bytes, nb: int) -> List[tuple]:
    fmt, _n = _NODE_CODECS[_base_type(mask_type)]
    size = struct.calcsize(fmt)
    out = []
    for i in range(nb):
        chunk = blob[i * size:(i + 1) * size]
        if len(chunk) < size:
            break
        out.append(struct.unpack(fmt, chunk))
    return out
