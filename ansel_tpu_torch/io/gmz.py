"""G'MIC compressed CLUT support (.gmz keypoint sets -> dense 3D LUT),
copied from `ansel_tpu/io/gmz.py` (numpy and zlib only).

Behavioural reference: `ansel/src/iop/lut3dgmic.cpp`, a thin bridge
that (a) reads a .gmz archive of keypoint images (`lut3d_read_gmz`,
:156) and (b) expands one keypoint set to a dense `level^3` CLUT via
G'MIC's `-decompress_clut` command plus a `-cut 0,255` clamp
(`lut3d_decompress_clut`, :44-90).  Keypoint layout is a (1, N, 1, 6)
uchar image: channels = (R, G, B) cube position and (r, g, b) colour,
all in [0, 255]; darktable stores the keypoint bytes inline in the
lut3d params blob (lut3d.c:106 `c_clut`), so sidecar replay needs only
the decompression, not the original .gmz file.

* Decompression is a polyharmonic RBF interpolant phi(r) = r with a
  linear polynomial term, solved densely on the host in float64 (N <=
  2048 keypoints, lut3d.c:81), evaluated on the level^3 grid as one
  product and clamped to [0, 255] like the reference's `-cut`.  Same
  interpolation class and exactness at the keypoints as G'MIC, not its
  multiscale schedule bit for bit.
* The .gmz reader parses CImg's serialized CImgList layout (ASCII
  header `N type endianness`, per-image `W H D S [#csize]` + zlib blob;
  gmic appends one uchar image of NUL-separated LUT names); unknown
  layouts fail loudly rather than mis-parse.

The dense-CLUT cache mirrors the reference's .cimgz cache
(lut3d.c:233-242) as an in-process dict keyed by the keypoint bytes.
"""

from __future__ import annotations

import io
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

CLUT_LEVEL = 48          # DT_IOP_LUT3D_CLUT_LEVEL (lut3d.c:80)
MAX_KEYPOINTS = 2048     # DT_IOP_LUT3D_MAX_KEYPOINTS (lut3d.c:81)

_CACHE: Dict[Tuple[bytes, int], np.ndarray] = {}


# --------------------------------------------------------------- decompress

def decompress_clut(keypoints: np.ndarray, level: int = CLUT_LEVEL
                    ) -> np.ndarray:
    """(N, 6) uint8 keypoints -> (level, level, level, 3) float CLUT in
    [0, 1], indexed [b, g, r] like the Hald/.cube tables the lut3d op
    samples (flat index r + level*g + level^2*b)."""
    kp = np.asarray(keypoints, np.float64).reshape(-1, 6)
    n = kp.shape[0]
    if n == 0:
        raise ValueError("empty keypoint set")
    pos = kp[:, :3]            # (R, G, B) in [0, 255]
    val = kp[:, 3:]            # (r, g, b) in [0, 255]

    # polyharmonic RBF phi(r) = r + linear term; solve the augmented
    # symmetric system [[K, P], [P^T, 0]] [w; a] = [v; 0]
    d = np.linalg.norm(pos[:, None, :] - pos[None, :, :], axis=-1)
    P = np.concatenate([np.ones((n, 1)), pos], axis=1)      # (n, 4)
    A = np.zeros((n + 4, n + 4))
    A[:n, :n] = d
    A[:n, n:] = P
    A[n:, :n] = P.T
    rhs = np.zeros((n + 4, 3))
    rhs[:n] = val
    try:
        sol = np.linalg.solve(A, rhs)
    except np.linalg.LinAlgError:
        # degenerate keypoint geometry: fall back to least squares
        sol = np.linalg.lstsq(A, rhs, rcond=None)[0]
    w, a = sol[:n], sol[n:]

    g = np.arange(level, dtype=np.float64) * (255.0 / (level - 1))
    # grid in flat order r-fastest: idx = r + level*g + level^2*b
    bb, gg, rr = np.meshgrid(g, g, g, indexing="ij")
    q = np.stack([rr.ravel(), gg.ravel(), bb.ravel()], axis=1)  # (M, 3)
    dq = np.linalg.norm(q[:, None, :] - pos[None, :, :], axis=-1)
    out = dq @ w + np.concatenate(
        [np.ones((q.shape[0], 1)), q], axis=1) @ a
    out = np.clip(out, 0.0, 255.0) / 255.0                   # -cut 0,255
    return out.reshape(level, level, level, 3).astype(np.float32)


def clut_from_params(c_clut: bytes, nb_keypoints: int,
                     level: int = CLUT_LEVEL) -> Optional[np.ndarray]:
    """Dense CLUT from the inline params keypoints (lut3d.c
    calculate_clut_compressed), cached like the reference's .cimgz
    cache.  Returns None when the blob is truncated/invalid."""
    nb = int(nb_keypoints)
    if nb <= 0 or nb > MAX_KEYPOINTS:
        return None
    raw = bytes(c_clut)[: nb * 6]
    if len(raw) < nb * 6:
        return None
    key = (raw, level)
    hit = _CACHE.get(key)
    if hit is None:
        kp = np.frombuffer(raw, np.uint8).reshape(nb, 6)
        hit = _CACHE[key] = decompress_clut(kp, level)
    return hit


# ------------------------------------------------------------- gmz archive

def _read_line(f) -> str:
    out = bytearray()
    while True:
        ch = f.read(1)
        if not ch or ch == b"\n":
            break
        out += ch
    return out.decode("ascii", "replace")


_DTYPES = {
    "unsigned_char": np.uint8, "uchar": np.uint8,
    "char": np.int8, "unsigned_short": np.uint16, "short": np.int16,
    "unsigned_int": np.uint32, "int": np.int32,
    "float": np.float32, "double": np.float64,
}


def read_gmz(path: str) -> List[Tuple[str, np.ndarray]]:
    """Parse a .gmz archive -> [(lutname, (N, 6) uint8 keypoints), ...]
    (lut3d_read_gmz semantics: every (1, N, 1, 6) uchar image is a
    keypoint set; the trailing 1-channel uchar image carries the
    NUL-separated names)."""
    with open(path, "rb") as f:
        header = _read_line(f)
        parts = header.split()
        if len(parts) < 2:
            raise ValueError(f"{path}: not a CImg serialized list "
                             f"(header {header!r})")
        n_images = int(parts[0])
        dt = _DTYPES.get(parts[1])
        if dt is None:
            raise ValueError(f"{path}: unsupported pixel type {parts[1]}")
        if len(parts) > 2 and parts[2] not in ("little_endian",):
            raise ValueError(f"{path}: unsupported endianness {parts[2]}")
        images = []
        for _ in range(n_images):
            dims = _read_line(f)
            if not dims.strip():
                raise ValueError(f"{path}: truncated archive")
            dp = dims.split()
            w, h, z, s = (int(v) for v in dp[:4])
            count = w * h * z * s
            if len(dp) > 4 and dp[4].startswith("#"):
                csize = int(dp[4][1:])
                data = np.frombuffer(
                    zlib.decompress(f.read(csize)), dt, count)
            else:
                data = np.frombuffer(
                    f.read(count * np.dtype(dt).itemsize), dt, count)
            # CImg plane order: per channel, z-y-x planes
            images.append(data.reshape(s, z, h, w))

    if not images:
        return []
    names: List[str] = []
    keypoint_imgs = images
    last = images[-1]
    if len(images) > 1 and last.shape[0] == 1 and last.dtype == np.uint8:
        names = [s for s in bytes(last.ravel()).split(b"\0") if s]
        names = [s.decode("utf-8", "replace") for s in names]
        keypoint_imgs = images[:-1]
    out = []
    for i, img in enumerate(keypoint_imgs):
        s, z, h, w = img.shape
        if s != 6 or w != 1 or z != 1:
            raise ValueError(
                f"{path}: image {i} is {img.shape}, not a (1,N,1,6) "
                "keypoint set")
        # channels-last (N, 6)
        kp = img.reshape(6, h).T.astype(np.uint8)
        name = names[i] if i < len(names) else f"lut{i}"
        out.append((name, kp))
    return out


def write_gmz(path: str, luts: List[Tuple[str, np.ndarray]],
              compress: bool = True) -> None:
    """Write keypoint sets in the same serialized-CImgList layout
    read_gmz parses (round-trip fixture writer; also usable to author
    .gmz sets for this engine)."""
    buf = io.BytesIO()
    n = len(luts) + 1
    buf.write(f"{n} unsigned_char little_endian\n".encode())
    names_blob = b"".join(
        name.encode("utf-8") + b"\0" for name, _ in luts)

    def emit(arr_u8: np.ndarray, w, h, z, s):
        raw = arr_u8.astype(np.uint8).tobytes()
        if compress:
            c = zlib.compress(raw)
            buf.write(f"{w} {h} {z} {s} #{len(c)}\n".encode())
            buf.write(c)
        else:
            buf.write(f"{w} {h} {z} {s}\n".encode())
            buf.write(raw)

    for _, kp in luts:
        kp = np.asarray(kp, np.uint8).reshape(-1, 6)
        emit(kp.T.reshape(6, 1, kp.shape[0], 1), 1, kp.shape[0], 1, 6)
    emit(np.frombuffer(names_blob, np.uint8), len(names_blob), 1, 1, 1)
    with open(path, "wb") as f:
        f.write(buf.getvalue())
