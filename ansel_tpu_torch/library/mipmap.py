"""Mipmap cache: leveled thumbnail service with a disk-backed store
(`ansel_tpu/library/mipmap.py`, on the port's THUMBNAIL pipe).

Reference: `ansel/src/common/mipmap_cache.c` (11 fixed levels
360px..8K :42-55; disk-backed thumbnail store under ~/.cache
:196-219,513; LRU in-memory buffers).  Thumbnails render through the
same compiled pipeline with the `initialscale` early downscale (the
THUMBNAIL pipe type), so a level-2 thumb of a 24MP raw costs a fraction
of a full render, on the CUDA card unless the cache was made with
`device="cpu"`.
"""

from __future__ import annotations

import hashlib
import os
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np

# mipmap_cache.h:42-55 level long-edge sizes
LEVEL_SIZES = (180, 360, 720, 1440, 1920, 2560, 3840, 5120, 6144, 7680,
               8192)


class MipmapCache:
    """get(imgid|path, level) -> (3, h, w) uint8 thumbnail."""

    def __init__(self, cache_dir: Optional[str] = None,
                 mem_items: int = 64, device="cuda"):
        self.cache_dir = cache_dir or os.path.join(
            os.path.expanduser("~"), ".cache", "ansel_tpu_torch", "mipmaps")
        os.makedirs(self.cache_dir, exist_ok=True)
        self.mem_items = mem_items
        self.device = device
        self._mem: "OrderedDict[Tuple[str, int], np.ndarray]" \
            = OrderedDict()
        self.hits = self.misses = 0

    def _key(self, path: str, level: int) -> Tuple[str, int]:
        st = os.stat(path)
        h = hashlib.sha1(
            f"{os.path.abspath(path)}:{st.st_mtime_ns}".encode()
        ).hexdigest()[:24]
        return h, level

    def _disk_path(self, key) -> str:
        return os.path.join(self.cache_dir, f"{key[0]}-{key[1]}.npz")

    def get(self, path: str, level: int, xmp_path: Optional[str] = None,
            render=None) -> np.ndarray:
        """Thumbnail at `level`; renders (and stores) on miss.
        `render(path, xmp_path, scale) -> (3,h,w) float` overrides the
        default pipeline render (tests, non-raw inputs)."""
        level = max(0, min(level, len(LEVEL_SIZES) - 1))
        key = self._key(path, level)
        buf = self._mem.get(key)
        if buf is not None:
            from ..core import supervisor as sup

            sup.event("mipmap", "read", f"{key[0]}@{key[1]}")
            self._mem.move_to_end(key)
            self.hits += 1
            return buf
        disk = self._disk_path(key)
        if os.path.exists(disk):
            buf = np.load(disk)["thumb"]
            self._put_mem(key, buf)
            self.hits += 1
            return buf
        self.misses += 1
        buf = self._render(path, xmp_path, level, render)
        np.savez_compressed(disk, thumb=buf)
        self._put_mem(key, buf)
        return buf

    def _render(self, path, xmp_path, level, render):
        from ..io.rawfile import load_raw
        from ..pipeline.export import ExportSettings, export_image

        long_edge = LEVEL_SIZES[level]
        if render is not None:
            out = render(path, xmp_path, long_edge)
        else:
            raw, meta = load_raw(path)
            if xmp_path is None:
                cand = path + ".xmp"
                xmp_path = cand if os.path.exists(cand) else None
            out = export_image(
                raw, meta, xmp_path=xmp_path,
                settings=ExportSettings(max_width=long_edge,
                                        max_height=long_edge),
                pipe_type="thumbnail", device=self.device)
        out = np.clip(np.asarray(out), 0.0, 1.0)
        return (out * 255.0 + 0.5).astype(np.uint8)

    def _put_mem(self, key, buf):
        from ..core import supervisor as sup

        sup.event("mipmap", "create", f"{key[0]}@{key[1]}")
        self._mem[key] = buf
        self._mem.move_to_end(key)
        while len(self._mem) > self.mem_items:
            self._mem.popitem(last=False)

    def invalidate(self, path: str):
        """Drop all levels of one image (history changed)."""
        for level in range(len(LEVEL_SIZES)):
            try:
                key = self._key(path, level)
            except OSError:
                continue
            if key in self._mem:
                from ..core import supervisor as sup

                sup.event("mipmap", "dead", f"{key[0]}@{key[1]}")
            self._mem.pop(key, None)
            disk = self._disk_path(key)
            if os.path.exists(disk):
                os.remove(disk)
