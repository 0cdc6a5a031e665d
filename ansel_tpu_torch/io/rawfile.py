"""Raw file container IO.

Camera-native containers (DNG/TIFF, CR2, CR3, NEF, ARW, RAF, RW2, ORF,
PEF) decode through the native C++ library (`native/rawdec` via
`io/dng.py`), as in `ansel_tpu/io/rawfile.py`.  `.npz` bundles (mosaic +
RawMeta fields) remain the portable interchange format.
"""

from __future__ import annotations

import numpy as np

from ..core.types import CFAPattern, RawMeta


def save_raw(path: str, raw: np.ndarray, meta: RawMeta) -> None:
    np.savez_compressed(
        path,
        raw=raw,
        cfa=meta.cfa.value,
        black_levels=np.asarray(meta.black_levels, np.float32),
        white_point=np.float32(meta.white_point),
        wb_coeffs=np.asarray(meta.wb_coeffs, np.float32),
        cam_to_xyz=(np.asarray(meta.cam_to_xyz, np.float64)
                    if meta.cam_to_xyz is not None else np.zeros(0)),
        xtrans=(np.asarray(meta.xtrans, np.int32)
                if meta.xtrans is not None else np.zeros(0, np.int32)),
        crop=np.asarray([meta.crop_x, meta.crop_y, meta.crop_right,
                         meta.crop_bottom], np.int32),
        iso=np.float32(meta.iso),
        exposure_bias=np.float32(meta.exposure_bias),
        maker=meta.maker, model=meta.model,
        orientation=np.int32(meta.orientation),
    )


def load_raw(path: str):
    """Dispatch on container: camera raws through the native decoder
    (`io/dng.py`), else an .npz bundle written by `save_raw`."""
    low = path.lower()
    if low.endswith((".dng", ".tif", ".tiff", ".cr2", ".cr3", ".nef",
                     ".arw", ".raf", ".rw2", ".orf", ".pef")):
        from .dng import load_raw as load_native

        return load_native(path)
    z = np.load(path, allow_pickle=False)
    raw = np.asarray(z["raw"], np.float32)
    h, w = raw.shape
    cam = z["cam_to_xyz"]
    xtrans = z["xtrans"]
    crop = z["crop"]
    meta = RawMeta(
        width=w, height=h,
        cfa=CFAPattern(str(z["cfa"])),
        black_levels=tuple(float(v) for v in z["black_levels"]),
        white_point=float(z["white_point"]),
        wb_coeffs=tuple(float(v) for v in z["wb_coeffs"]),
        cam_to_xyz=tuple(cam.reshape(-1)) if cam.size else None,
        xtrans=tuple(int(v) for v in xtrans) if xtrans.size else None,
        crop_x=int(crop[0]), crop_y=int(crop[1]),
        crop_right=int(crop[2]), crop_bottom=int(crop[3]),
        iso=float(z["iso"]), exposure_bias=float(z["exposure_bias"]),
        maker=str(z["maker"]), model=str(z["model"]),
        orientation=int(z["orientation"]),
    )
    return raw, meta
