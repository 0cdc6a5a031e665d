"""Camera noise-profile database (noiseprofiles.json).

Reference: `ansel/src/common/noiseprofiles.c` — JSON schema (maker ->
models -> per-ISO {a[3], b[3]} Poissonian-Gaussian coefficients) and
linear ISO interpolation (dt_noiseprofile_interpolate :389-405).  Copied
from `ansel_tpu/io/noiseprofiles.py`.

A snapshot of the community-measured database is bundled at
`ansel_tpu_torch/data/noiseprofiles.json` (the file darktable and Ansel
ship as data/noiseprofiles.json; see data/README.md).  Precedence: an
explicit path > `$ANSEL_TPU_DATA/noiseprofiles.json` > the bundled
snapshot.  The coefficients feed denoiseprofile's variance-stabilising
transform; a missing database is logged, and denoiseprofile then falls
back to generic coefficients.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Optional, Tuple


def _default_path() -> Optional[str]:
    root = os.environ.get("ANSEL_TPU_DATA", "")
    here = os.path.dirname(__file__)
    for cand in ((os.path.join(root, "noiseprofiles.json") if root
                  else None),
                 os.path.join(here, "..", "data", "noiseprofiles.json")):
        if cand and os.path.isfile(cand):
            return cand
    return None


@functools.lru_cache(maxsize=4)
def load(path: Optional[str] = None) -> dict:
    """-> {(maker_lower, model_lower): [(iso, a3, b3), ...] sorted by iso}."""
    path = path or _default_path()
    if path is None:
        from ..core.log import log

        log("always", "noiseprofiles: no database found (bundled snapshot "
            "missing and ANSEL_TPU_DATA unset) — denoiseprofile auto a/b "
            "will fall back to generic coefficients")
        return {}
    with open(path, "r") as f:
        doc = json.load(f)
    out = {}
    for maker in doc.get("noiseprofiles", []):
        mk = maker.get("maker", "").strip().lower()
        for model in maker.get("models", []):
            md = model.get("model", "").strip().lower()
            rows = []
            for p in model.get("profiles", []):
                try:
                    rows.append((float(p["iso"]), tuple(p["a"]),
                                 tuple(p["b"])))
                except (KeyError, TypeError, ValueError):
                    continue
            if rows:
                rows.sort(key=lambda r: r[0])
                out[(mk, md)] = rows
    return out


def find(maker: str, model: str, iso: float,
         path: Optional[str] = None) -> Optional[Tuple[tuple, tuple]]:
    """-> interpolated (a[3], b[3]) for the camera at `iso`, or None.
    Matching is case-insensitive; the model may be a substring match
    (camera strings vary between raw decoders)."""
    db = load(path)
    if not db:
        return None
    mk, md = maker.strip().lower(), model.strip().lower()
    rows = db.get((mk, md))
    if rows is None:
        for (m, name), r in db.items():
            if m == mk and (name in md or md in name):
                rows = r
                break
    if rows is None:
        return None
    if iso <= rows[0][0]:
        return rows[0][1], rows[0][2]
    if iso >= rows[-1][0]:
        return rows[-1][1], rows[-1][2]
    for (i1, a1, b1), (i2, a2, b2) in zip(rows, rows[1:]):
        if i1 <= iso <= i2:
            # dt_noiseprofile_interpolate: linear in iso
            t = (iso - i1) / max(i2 - i1, 1e-9)
            a = tuple((1 - t) * x + t * y for x, y in zip(a1, a2))
            b = tuple((1 - t) * x + t * y for x, y in zip(b1, b2))
            return a, b
    return None
