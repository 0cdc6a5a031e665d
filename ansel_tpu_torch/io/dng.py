"""Camera raw loader backed by the native C++ decoder (`native/rawdec`).

A port of `ansel_tpu/io/dng.py`: the TIFF IFD walk, packed 10/12/14/16-bit
mosaics, lossless-JPEG (compression 7) strips and the vendor containers
(CR2, CR3, RAF incl. X-Trans, NEF incl. 34713, ARW/ARW2, RW2, ORF, PEF)
decode in `native/rawdec/rawdec.cpp` through ctypes; the DNG OpcodeList2
GainMaps are parsed here.  The reference delegates camera decode to
rawspeed/LibRaw; tag semantics follow ansel/src/imageio/imageio_dng.c and
the DNG 1.4 specification.

The shared library is built at first use with `g++ -O2 -shared -fPIC`
into `build/ansel_tpu_torch/librawdec-<key>.so` at the root of the
checkout, <key> hashing the source and the flags, never beside the
source.  Concurrent builds (test workers) serialise on a file lock and
each build lands by an atomic rename.  A missing g++ or a failed build
raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..core.types import CFAPattern, DngGainMap, RawMeta

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None

_ROOT = Path(__file__).resolve().parents[2]
SRC = _ROOT / "native" / "rawdec" / "rawdec.cpp"
BUILD_DIR = _ROOT / "build" / "ansel_tpu_torch"
GXX_FLAGS = ("-O2", "-shared", "-fPIC")


def library_path() -> Path:
    key = hashlib.sha256(SRC.read_bytes()
                         + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"librawdec-{key[:16]}.so"


def build() -> Path:
    """Compile native/rawdec/rawdec.cpp unless its library exists;
    -> library path."""
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the raw decoder cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "librawdec.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # another process built it while we waited
            return out
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.run([gxx, *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed for {SRC.name}:\n{proc.stderr}")
        os.replace(tmp, out)
    return out


class _RawInfo(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_uint32), ("height", ctypes.c_uint32),
        ("bits", ctypes.c_uint32), ("compression", ctypes.c_uint32),
        ("cfa", ctypes.c_uint32 * 4),
        ("black", ctypes.c_double), ("white", ctypes.c_double),
        ("wb", ctypes.c_double * 3),
        ("cam_to_xyz", ctypes.c_double * 9),
        ("n_strips", ctypes.c_uint32),
        ("iso", ctypes.c_uint32),
        ("is_xtrans", ctypes.c_uint32),
        ("xtrans", ctypes.c_uint32 * 36),
        ("crop", ctypes.c_uint32 * 4),
        ("cr2_slices", ctypes.c_uint32 * 3),
        ("container", ctypes.c_uint32),
        ("endian_le", ctypes.c_uint32),
        ("nikon_meta_off", ctypes.c_uint64),
        ("nikon_meta_len", ctypes.c_uint32),
        ("nikon_meta_le", ctypes.c_uint32),
        ("sony_curve", ctypes.c_uint32 * 4),
        ("has_sony_curve", ctypes.c_uint32),
        ("maker", ctypes.c_char * 64),
        ("model", ctypes.c_char * 64),
        ("pentax_meta_off", ctypes.c_uint64),
        ("pentax_meta_len", ctypes.c_uint32),
        ("pentax_pad", ctypes.c_uint32),
    ]


CONTAINERS = {0: "dng/tiff", 1: "cr2", 2: "raf", 3: "nef", 4: "arw",
              5: "cr3", 6: "orf", 7: "rw2"}


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(build()))
        lib.rawdec_info.restype = ctypes.c_int
        lib.rawdec_info.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(_RawInfo),
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64)]
        lib.rawdec_decode.restype = ctypes.c_int
        lib.rawdec_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(_RawInfo),
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_uint16)]
        _LIB = lib
        return lib


_CFA_ENUM = {
    (0, 1, 1, 2): CFAPattern.RGGB,
    (1, 0, 2, 1): CFAPattern.GRBG,
    (1, 2, 0, 1): CFAPattern.GBRG,
    (2, 1, 1, 0): CFAPattern.BGGR,
}


_TIFF_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2,
                   9: 4, 10: 8, 11: 4, 12: 8}
_TAG_SUBIFDS = 330
_TAG_OPCODE_LIST2 = 51009  # DNG 1.3 OpcodeList2 (raw IFD)
_OPCODE_ID_GAINMAP = 9


def _iter_ifd_entries(buf: bytes, off: int, e: str):
    """Yield (tag, type, count, payload bytes) for one IFD."""
    import struct

    if off + 2 > len(buf):
        return
    (n,) = struct.unpack_from(e + "H", buf, off)
    for i in range(n):
        eo = off + 2 + 12 * i
        if eo + 12 > len(buf):
            return
        tag, typ, cnt = struct.unpack_from(e + "HHI", buf, eo)
        size = _TIFF_TYPE_SIZE.get(typ, 1) * cnt
        if size <= 4:
            data = buf[eo + 8 : eo + 8 + size]
        else:
            (doff,) = struct.unpack_from(e + "I", buf, eo + 8)
            data = buf[doff : doff + size]
        yield tag, typ, cnt, data


def parse_opcode_list2(blob: bytes) -> Tuple[DngGainMap, ...]:
    """Decode the GainMap opcodes out of an OpcodeList2 payload.

    Wire format (always big-endian regardless of TIFF byte order):
    dng_opcode.c:57-130 — count; then per opcode: id, dng-version,
    flags, param_size, params.  GainMap params at fixed offsets
    (dng_opcode.c:82-99): top/left/bottom/right/plane/planes/
    row_pitch/col_pitch/map_points_v/h (u32), map_spacing_v/h,
    map_origin_v/h (f64), map_planes (u32), then float gains."""
    import struct

    if len(blob) < 4:
        return ()
    (count,) = struct.unpack_from(">I", blob, 0)
    off = 4
    maps = []
    while count > 0 and off + 16 <= len(blob):
        opcode_id, _ver, _flags, psize = struct.unpack_from(
            ">IIII", blob, off)
        if off + 16 + psize > len(blob):
            break
        if opcode_id == _OPCODE_ID_GAINMAP and psize >= 76:
            p = blob[off + 16 : off + 16 + psize]
            u = struct.unpack_from(">10I", p, 0)
            sp = struct.unpack_from(">4d", p, 40)
            (mp,) = struct.unpack_from(">I", p, 72)
            n_gain = (psize - 76) // 4
            gains = struct.unpack_from(f">{n_gain}f", p, 76)
            maps.append(DngGainMap(
                top=u[0], left=u[1], bottom=u[2], right=u[3],
                plane=u[4], planes=u[5], row_pitch=u[6], col_pitch=u[7],
                map_points_v=u[8], map_points_h=u[9],
                map_spacing_v=sp[0], map_spacing_h=sp[1],
                map_origin_v=sp[2], map_origin_h=sp[3],
                map_planes=mp, map_gain=gains))
        off += 16 + psize
        count -= 1
    return tuple(maps)


def parse_gain_maps(buf: bytes) -> Tuple[DngGainMap, ...]:
    """Find OpcodeList2 (tag 51009) in IFD0 or its SubIFDs and decode
    the GainMaps (exif.cc:897-911 looks in SubImage1 then IFD0)."""
    import struct

    if len(buf) < 8 or buf[:2] not in (b"II", b"MM"):
        return ()
    e = "<" if buf[:2] == b"II" else ">"
    magic, ifd0 = struct.unpack_from(e + "HI", buf, 2)
    if magic != 42:
        return ()
    ifds = [ifd0]
    for tag, typ, cnt, data in _iter_ifd_entries(buf, ifd0, e):
        if tag == _TAG_SUBIFDS and typ == 4:
            ifds.extend(struct.unpack_from(e + f"{cnt}I", data, 0))
    for ifd in ifds:
        for tag, _typ, _cnt, data in _iter_ifd_entries(buf, ifd, e):
            if tag == _TAG_OPCODE_LIST2:
                gm = parse_opcode_list2(data)
                if gm:
                    return gm
    return ()


def load_raw(path: str) -> Tuple[np.ndarray, RawMeta]:
    """-> (mosaic float32 (H, W) in sensor units, RawMeta).

    Dispatches by container magic: DNG/TIFF, CR2 (Canon LJ92 + slices),
    RAF (Fuji, incl. X-Trans pattern), NEF (packed + vendor entropy
    coding 34713 with the MakerNote linearization curve), ARW (packed +
    Sony ARW2 32767 with the 0x7010 tone curve, incl. the SR2-encrypted
    private IFD)."""
    with open(path, "rb") as f:
        buf = f.read()
    lib = _lib()
    info = _RawInfo()
    offs = (ctypes.c_uint64 * 64)()
    cnts = (ctypes.c_uint64 * 64)()
    rc = lib.rawdec_info(buf, len(buf), ctypes.byref(info), offs, cnts)
    if rc != 0:
        raise ValueError(f"{path}: not a decodable raw container (rc={rc})")
    kind = CONTAINERS.get(info.container, "?")
    H, W = info.height, info.width
    out = np.empty((H, W), np.uint16)
    rows_per_strip = (H + max(info.n_strips, 1) - 1) // max(info.n_strips, 1)
    rc = lib.rawdec_decode(
        buf, len(buf), ctypes.byref(info), offs, cnts, rows_per_strip,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    if rc == 32:
        raise ValueError(f"{path}: NEF entropy payload (34713) without a "
                         "readable MakerNote linearization table (0x0096)")
    if rc == 33:
        raise ValueError(f"{path}: Sony ARW2 payload shorter than "
                         "width*height bytes")
    if rc != 0:
        raise ValueError(f"{path}: {kind} decode failed (rc={rc}, "
                         f"compression={info.compression})")

    cfa = _CFA_ENUM.get(tuple(info.cfa), CFAPattern.RGGB)
    # AsShotNeutral is the illuminant in camera space -> WB multipliers
    wb = np.asarray(info.wb, np.float64)
    wb = np.where(wb > 1e-9, 1.0 / np.maximum(wb, 1e-9), 1.0)
    wb = wb / max(wb[1], 1e-9)
    cam_to_xyz = np.asarray(info.cam_to_xyz, np.float64).reshape(3, 3)
    crop = tuple(int(v) for v in info.crop)  # (top, left, bottom, right)
    has_crop = crop[2] > 0 and crop[3] > 0 \
        and (crop[:2] != (0, 0) or crop[2] < H or crop[3] < W)
    meta = RawMeta(
        width=W, height=H,
        cfa=CFAPattern.XTRANS if info.is_xtrans else cfa,
        black_levels=(float(info.black),) * 4,
        white_point=float(info.white),
        crop_y=crop[0] if has_crop else 0,
        crop_x=crop[1] if has_crop else 0,
        crop_bottom=(H - crop[2]) if has_crop else 0,
        crop_right=(W - crop[3]) if has_crop else 0,
        wb_coeffs=(float(wb[0]), float(wb[1]), float(wb[2]), 0.0),
        cam_to_xyz=(tuple(cam_to_xyz.reshape(-1))
                    if np.abs(cam_to_xyz).sum() > 1e-9 else None),
        xtrans=(tuple(int(v) for v in info.xtrans)
                if info.is_xtrans else None),
        iso=float(info.iso or 100),
        maker=info.maker.decode("utf-8", "ignore"),
        model=info.model.decode("utf-8", "ignore"),
        gain_maps=parse_gain_maps(buf) if info.container == 0 else (),
    )
    return out.astype(np.float32), meta


# historic name: the loader originally handled DNG only
load_dng = load_raw
