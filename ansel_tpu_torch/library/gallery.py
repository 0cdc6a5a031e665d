"""HTML gallery export storage (`ansel_tpu/library/gallery.py`, on the
port's render: the CUDA card unless `device="cpu"`).

Reference: `ansel/src/imageio/storage/gallery.c` — the
"website gallery" storage plugin: exports images + thumbnails into a
folder and writes a self-contained index.html (plus per-image pages).
"""

from __future__ import annotations

import html
import os
from typing import List, Optional, Sequence

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
body {{ background:#111; color:#ddd; font-family:sans-serif;
        margin:2em; }}
.grid {{ display:flex; flex-wrap:wrap; gap:12px; }}
.grid a {{ display:block; }}
.grid img {{ max-height:240px; display:block; }}
figure {{ margin:0; }}
figcaption {{ font-size:0.8em; color:#999; padding-top:4px; }}
</style></head>
<body><h1>{title}</h1><div class="grid">
{items}
</div></body></html>
"""

_ITEM = ('<figure><a href="{full}"><img src="{thumb}" alt="{name}">'
         "</a><figcaption>{name}</figcaption></figure>")


def export_gallery(lib, imgids: Sequence[int], out_dir: str,
                   title: str = "Gallery",
                   settings=None, thumb_size: int = 240,
                   filename_pattern: str = "$(FILE_NAME)",
                   device="cuda") -> str:
    """Render `imgids` into `out_dir` (full size + thumbs + index.html);
    -> path of index.html (gallery.c store()/finalize_store)."""
    from ..io.rawfile import load_raw
    from ..library.variables import expand
    from ..pipeline.export import ExportSettings, export_image
    from ..io.encode import write_image

    os.makedirs(os.path.join(out_dir, "thumbs"), exist_ok=True)
    items: List[str] = []
    settings = settings or ExportSettings()
    for imgid in imgids:
        src = lib.image_path(imgid)
        xmp = lib.xmp_path(imgid)
        xmp = xmp if os.path.exists(xmp) else None
        raw, meta = load_raw(src)
        base = expand(filename_pattern, lib=lib, imgid=imgid)
        base = os.path.splitext(os.path.basename(base))[0]
        full_rel = f"{base}.jpg"
        thumb_rel = os.path.join("thumbs", f"{base}.jpg")
        out = export_image(raw, meta, xmp_path=xmp, settings=settings,
                           device=device)
        write_image(os.path.join(out_dir, full_rel), out)
        t = export_image(
            raw, meta, xmp_path=xmp,
            settings=ExportSettings(max_width=thumb_size,
                                    max_height=thumb_size),
            pipe_type="thumbnail", device=device)
        write_image(os.path.join(out_dir, thumb_rel), t)
        items.append(_ITEM.format(full=html.escape(full_rel),
                                  thumb=html.escape(thumb_rel),
                                  name=html.escape(base)))
    index = os.path.join(out_dir, "index.html")
    with open(index, "w") as f:
        f.write(_PAGE.format(title=html.escape(title),
                             items="\n".join(items)))
    return index
