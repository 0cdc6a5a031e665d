"""ICC profile reader: matrix+TRC and LUT (mft1/mft2, mAB/mBA) profiles,
and their application in torch.

Port of `ansel_tpu/color/icc.py`.  Reference behaviour:
`ansel/src/common/colorspaces.c` (the LCMS2 profile load
`dt_colorspaces_get_profile`, :2300-2661) and the fast-path matrix
extraction of `ansel/src/develop/iop_profile.c:300-520`.  The binary
parser (header, tag table, 'XYZ ', 'curv', 'para', 'chad', 'mft1',
'mft2', 'mAB ', 'mBA ') is host numpy, copied as it is.

The application differs in where its numbers are made: the JAX package
fits the curves inside the function it returns, which its jit runs once;
an eager port would fit them on every image.  So `to_xyz_coeffs` and
`to_device_coeffs` fit every curve (`_fit_curve`: a monotone Hermite
through up to 24 nodes, `pixel/curves.curve_coeffs`) and lay out every
CLUT on the host, once, as the stage's coefficients, and
`profile_to_xyz_fn` / `xyz_to_device_fn` return torch functions of the
pixels and those coefficients (on the device), evaluated through
`pixel/curves.eval_curve` and the shared sampler `ops/lut3d.lut3d_sample`.
The numbers are the JAX package's.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional

import numpy as np
import torch

_S15F16 = 65536.0


@dataclasses.dataclass
class ICCProfile:
    kind: str                      # "matrix" | "lut"
    to_xyz: Optional[np.ndarray] = None       # (3,3) RGB->XYZ D50
    trc: Optional[List[np.ndarray]] = None    # 3 x sampled curves [0,1]
    # LUT form (device -> PCS for A2B)
    in_curves: Optional[List[np.ndarray]] = None
    clut: Optional[np.ndarray] = None          # (N,N,N,3)
    out_curves: Optional[List[np.ndarray]] = None
    lut_matrix: Optional[np.ndarray] = None    # (3,3) pre-matrix (mft)
    pcs: str = "XYZ"               # "XYZ" | "Lab"
    white: Optional[np.ndarray] = None
    # B2A LUT (PCS -> device), (in_curves, clut, out_curves, matrix,
    # legacy16) — legacy16 marks mft2's 0xFF00-max Lab encoding
    b2a: Optional[tuple] = None


def _read_tags(buf: bytes):
    (count,) = struct.unpack_from(">I", buf, 128)
    tags = {}
    for k in range(count):
        sig, off, size = struct.unpack_from(">4sII", buf, 132 + 12 * k)
        tags[sig.decode("latin1")] = (off, size)
    return tags


def _xyz_tag(buf, off):
    x, y, z = struct.unpack_from(">iii", buf, off + 8)
    return np.array([x, y, z]) / _S15F16


def _curve_tag(buf, off, size):
    typ = buf[off:off + 4]
    if typ == b"curv":
        (n,) = struct.unpack_from(">I", buf, off + 8)
        if n == 0:
            return np.linspace(0.0, 1.0, 256)
        if n == 1:
            (g,) = struct.unpack_from(">H", buf, off + 12)
            gamma = g / 256.0
            return np.linspace(0.0, 1.0, 256) ** gamma
        vals = np.frombuffer(buf, ">u2", n, off + 12) / 65535.0
        return vals.astype(np.float64)
    if typ == b"para":
        (ft,) = struct.unpack_from(">H", buf, off + 8)
        nparams = {0: 1, 1: 3, 2: 4, 3: 5, 4: 7}[ft]
        prm = [v / _S15F16 for v in struct.unpack_from(
            f">{nparams}i", buf, off + 12)]
        x = np.linspace(0.0, 1.0, 1024)
        g = prm[0]
        if ft == 0:
            y = x ** g
        elif ft == 1:
            a, b = prm[1], prm[2]
            y = np.where(x >= -b / a, (a * x + b) ** g, 0.0)
        elif ft == 2:
            a, b, c = prm[1], prm[2], prm[3]
            y = np.where(x >= -b / a, (a * x + b) ** g + c, c)
        elif ft == 3:
            a, b, c, d = prm[1], prm[2], prm[3], prm[4]
            y = np.where(x >= d, (a * x + b) ** g, c * x)
        else:
            a, b, c, d, e, f = prm[1:7]
            y = np.where(x >= d, (a * x + b) ** g + e, c * x + f)
        return np.clip(y, 0.0, None)
    raise ValueError(f"unsupported curve type {typ!r}")


def _parse_mft(buf, off, size, wide):
    """'mft1'/'mft2' (lut8/lut16) -> (matrix, in_curves, clut, out_curves)."""
    n_in, n_out, n_grid = struct.unpack_from(">BBB", buf, off + 8)
    if n_in != 3 or n_out != 3:
        raise ValueError("only 3->3 LUTs supported")
    m = np.array(struct.unpack_from(">9i", buf, off + 12)) / _S15F16
    matrix = m.reshape(3, 3)
    pos = off + 48
    if wide:
        n_ent_in, n_ent_out = struct.unpack_from(">HH", buf, pos)
        pos += 4
        dt, scale, esize = ">u2", 65535.0, 2
    else:
        n_ent_in, n_ent_out = 256, 256
        dt, scale, esize = ">u1", 255.0, 1
    in_curves = []
    for _ in range(3):
        in_curves.append(np.frombuffer(buf, dt, n_ent_in, pos) / scale)
        pos += n_ent_in * esize
    n_clut = n_grid ** 3 * 3
    clut = (np.frombuffer(buf, dt, n_clut, pos) / scale).reshape(
        n_grid, n_grid, n_grid, 3)
    pos += n_clut * esize
    out_curves = []
    for _ in range(3):
        out_curves.append(np.frombuffer(buf, dt, n_ent_out, pos) / scale)
        pos += n_ent_out * esize
    return matrix, in_curves, clut, out_curves


def _parse_mab(buf, off, size):
    """'mAB ' lutAtoBType -> (in/B curves, clut, out/A curves, matrix)."""
    n_in, n_out = struct.unpack_from(">BB", buf, off + 8)
    if n_in != 3 or n_out != 3:
        raise ValueError("only 3->3 LUTs supported")
    off_b, off_mat, off_m, off_clut, off_a = struct.unpack_from(
        ">IIIII", buf, off + 12)

    def curves_at(o):
        if o == 0:
            return None
        out = []
        pos = off + o
        for _ in range(3):
            c = _curve_tag(buf, pos, size)
            # tag entries are 4-byte aligned
            typ = buf[pos:pos + 4]
            if typ == b"curv":
                (n,) = struct.unpack_from(">I", buf, pos + 8)
                step = 12 + 2 * n
            else:
                (ft,) = struct.unpack_from(">H", buf, pos + 8)
                step = 12 + 4 * {0: 1, 1: 3, 2: 4, 3: 5, 4: 7}[ft]
            pos += (step + 3) & ~3
            out.append(c)
        return out

    clut = None
    if off_clut:
        p0 = off + off_clut
        grid = struct.unpack_from(">16B", buf, p0)[:3]
        (prec,) = struct.unpack_from(">B", buf, p0 + 16)
        n = grid[0] * grid[1] * grid[2] * 3
        if prec == 1:
            clut = np.frombuffer(buf, ">u1", n, p0 + 20) / 255.0
        else:
            clut = np.frombuffer(buf, ">u2", n, p0 + 20) / 65535.0
        clut = clut.reshape(grid[0], grid[1], grid[2], 3)
    matrix = None
    if off_mat:
        m = np.array(struct.unpack_from(">12i", buf, off + off_mat)) \
            / _S15F16
        matrix = m[:9].reshape(3, 3)
    return curves_at(off_a), clut, curves_at(off_b), matrix


def _parse_b2a(data, tags):
    """B2A0/B2A1 (PCS -> device) in mft1/mft2/'mBA ' form, or None."""
    for tag in ("B2A0", "B2A1"):
        if tag not in tags:
            continue
        off, size = tags[tag]
        typ = data[off:off + 4]
        if typ in (b"mft1", b"mft2"):
            matrix, inc, clut, outc = _parse_mft(data, off, size,
                                                 typ == b"mft2")
            return (inc, clut, outc, matrix, typ == b"mft2")
        if typ == b"mBA ":
            # lutBtoAType shares the mAB layout; the 'A' curves sit on
            # the device side and 'B' on the PCS side, so the roles of
            # the parsed curve sets swap relative to A2B
            a_c, clut, b_c, matrix = _parse_mab(data, off, size)
            return (b_c, clut, a_c, matrix, False)
    return None


def parse_icc(data: bytes) -> ICCProfile:
    if len(data) < 132 or data[36:40] != b"acsp":
        raise ValueError("not an ICC profile")
    pcs = data[20:24].decode("latin1").strip()
    tags = _read_tags(data)

    white = None
    if "wtpt" in tags:
        white = _xyz_tag(data, tags["wtpt"][0])

    # chromatic adaptation (absolute -> D50-relative correction)
    chad = None
    if "chad" in tags:
        off = tags["chad"][0]
        m = np.array(struct.unpack_from(">9i", data, off + 8)) / _S15F16
        chad = m.reshape(3, 3)

    if all(t in tags for t in ("rXYZ", "gXYZ", "bXYZ", "rTRC")):
        cols = [_xyz_tag(data, tags[t][0])
                for t in ("rXYZ", "gXYZ", "bXYZ")]
        to_xyz = np.stack(cols, axis=1)
        trc = []
        for t in ("rTRC", "gTRC", "bTRC"):
            off, size = tags.get(t, tags["rTRC"])
            trc.append(_curve_tag(data, off, size))
        return ICCProfile(kind="matrix", to_xyz=to_xyz, trc=trc,
                          pcs=pcs, white=white)

    for tag in ("A2B0", "A2B1"):
        if tag not in tags:
            continue
        off, size = tags[tag]
        typ = data[off:off + 4]
        if typ in (b"mft1", b"mft2"):
            matrix, inc, clut, outc = _parse_mft(data, off, size,
                                                 typ == b"mft2")
            return ICCProfile(kind="lut", in_curves=inc, clut=clut,
                              out_curves=outc, lut_matrix=matrix,
                              pcs=pcs, white=white,
                              b2a=_parse_b2a(data, tags))
        if typ == b"mAB ":
            inc, clut, outc, matrix = _parse_mab(data, off, size)
            return ICCProfile(kind="lut", in_curves=inc, clut=clut,
                              out_curves=outc, lut_matrix=matrix,
                              pcs=pcs, white=white,
                              b2a=_parse_b2a(data, tags))
    b2a = _parse_b2a(data, tags)
    if b2a is not None:
        return ICCProfile(kind="lut", pcs=pcs, white=white, b2a=b2a)
    raise ValueError("profile has neither matrix+TRC nor supported LUT")


def load_icc(path: str) -> ICCProfile:
    with open(path, "rb") as f:
        return parse_icc(f.read())


def find_profile(meta, name: str, direction: str) -> ICCProfile:
    """The custom profile `name` of colorin (`direction` "in") or colorout
    ("out"), searched as the JAX package searches
    (`ansel_tpu/ops/colorin.py:76-94`, `colorout.py:122-131`): the name
    itself, then beside the sidecar, then in its `color/<direction>`
    folder."""
    import os

    search = getattr(meta, "sidecar_dir", "") or "."
    for cand in (name, os.path.join(search, name),
                 os.path.join(search, "color", direction, name)):
        if os.path.exists(cand):
            return load_icc(cand)
    raise ValueError(f"color{direction}: ICC profile '{name}' not found")


# --- application ---------------------------------------------------------

# the PCS's D50 white and the PCSXYZ encoding's scale (1 + 32767/32768)
_D50 = (0.9642, 1.0, 0.8249)
_PCSXYZ = 1.999969482421875
_IDENTITY_CURVE = np.linspace(0, 1, 2)


def _fit_curve(samples: np.ndarray, nodes: int = 24):
    """Monotone 1-D curve -> gather-free Hermite node fit."""
    from ..pixel.curves import MONOTONE_HERMITE, curve_coeffs

    xs = np.linspace(0.0, 1.0, len(samples))
    pick = np.unique(np.linspace(0, len(samples) - 1,
                                 min(nodes, len(samples))).astype(int))
    return curve_coeffs(xs[pick], samples[pick], MONOTONE_HERMITE)


def _curves(prefix, curves):
    """{prefix0..2: (3, n) node rows} of three fitted curves (identity
    where the profile has none)."""
    curves = curves or [_IDENTITY_CURVE] * 3
    return {f"{prefix}{ch}": np.stack(_fit_curve(t))
            for ch, t in enumerate(curves)}


def _flat_clut(clut: np.ndarray) -> np.ndarray:
    """An ICC CLUT ([in0][in1][in2] C order, in2 fastest) as lut3d_sample's
    (grid^3, 3) table (index r + g*L + b*L^2, r fastest)."""
    return clut.transpose(2, 1, 0, 3).reshape(-1, 3).astype(np.float32)


def to_xyz_coeffs(prof: ICCProfile) -> dict:
    """The host numbers of `profile_to_xyz_fn`: the TRC fits ("trc0..2")
    of a matrix profile; the input and output curve fits ("in0..2",
    "out0..2") and the flat CLUT ("clut") of a LUT profile."""
    if prof.kind == "matrix":
        return _curves("trc", prof.trc)
    return {**_curves("in", prof.in_curves), **_curves("out", prof.out_curves),
            "clut": _flat_clut(prof.clut)}


def to_device_coeffs(prof: ICCProfile) -> dict:
    """The host numbers of `xyz_to_device_fn`: the B2A LUT's input and
    output curve fits ("b2a_in0..2", "b2a_out0..2") and flat CLUT
    ("b2a_clut")."""
    if prof.b2a is None:
        raise ValueError("profile has no B2A LUT")
    inc, clut, outc, _, _ = prof.b2a
    return {**_curves("b2a_in", inc), **_curves("b2a_out", outc),
            "b2a_clut": _flat_clut(clut)}


def to_output_coeffs(prof: ICCProfile) -> dict:
    """The host numbers of colorout's ICC branch: for a matrix+TRC
    profile the numeric inverse of each (monotone) TRC as a 40-node
    monotone Hermite, its nodes packed toward 0 where the inverse gamma
    curve is steep ("inv0..2", `ansel_tpu/ops/colorout.py:137-146`); for a
    LUT profile `to_device_coeffs`."""
    from ..pixel.curves import MONOTONE_HERMITE, curve_coeffs

    if prof.kind != "matrix":
        return to_device_coeffs(prof)
    out = {}
    for ch in range(3):
        trc = prof.trc[ch]
        ys = np.linspace(0.0, 1.0, 4096)
        xs = np.interp(ys, trc, np.linspace(0.0, 1.0, len(trc)))
        pick = np.unique((np.linspace(0.0, 1.0, 40) ** 2 * 4095).astype(int))
        out[f"inv{ch}"] = np.stack(curve_coeffs(ys[pick], xs[pick],
                                                MONOTONE_HERMITE))
    return out


def _on(c, x):
    """Coefficients as float32 tensors on x's device (host arrays from
    to_xyz_coeffs or the stage's device coefficients)."""
    return {k: torch.as_tensor(v, dtype=torch.float32, device=x.device)
            for k, v in c.items()}


def profile_to_xyz_fn(prof: ICCProfile, coeffs: dict):
    """-> f(rgb (3, H, W) device values in [0, 1]) -> XYZ D50, reading
    `coeffs` (to_xyz_coeffs(prof), on the device)."""
    from ..pixel.curves import eval_curve
    from .transforms import apply_matrix, lab_to_xyz

    c0 = coeffs
    if prof.kind == "matrix":
        M = prof.to_xyz.tolist()

        def f(rgb):
            c = _on(c0, rgb)
            lin = torch.stack([
                eval_curve(torch.clamp(rgb[ch], 0.0, 1.0), *c[f"trc{ch}"])
                for ch in range(3)])
            return apply_matrix(lin, M)
        return f

    grid = prof.clut.shape[0]
    pcs_lab = prof.pcs.startswith("Lab")

    def f(rgb):
        from ..ops.lut3d import lut3d_sample

        c = _on(c0, rgb)
        t = torch.stack([eval_curve(torch.clamp(rgb[ch], 0.0, 1.0),
                                    *c[f"in{ch}"]) for ch in range(3)])
        out = lut3d_sample(torch.clamp(t, 0.0, 1.0), c["clut"], grid, 0)
        out = torch.stack([eval_curve(torch.clamp(out[ch], 0.0, 1.0),
                                      *c[f"out{ch}"]) for ch in range(3)])
        if pcs_lab:
            L = out[0] * 100.0
            a = out[1] * 255.0 - 128.0
            b = out[2] * 255.0 - 128.0
            return lab_to_xyz(torch.stack([L, a, b]),
                              np.asarray(_D50, np.float32))
        # PCSXYZ encoding: value * (1 + 32767/32768) ~ [0, 1.99997]
        return out * _PCSXYZ
    return f


def xyz_to_device_fn(prof: ICCProfile, coeffs: dict):
    """-> f(XYZ D50 (3, H, W)) -> device values through the B2A LUT (PCS
    encode -> mft matrix -> input curves -> CLUT -> output curves; the
    lut8/lut16Type processing model, ICC.1 §10.9/10.10), reading
    `coeffs` (to_device_coeffs(prof), on the device)."""
    from ..pixel.curves import eval_curve
    from .transforms import apply_matrix, fdiv, xyz_to_lab

    c0 = coeffs
    _, clut, _, matrix, legacy16 = prof.b2a
    grid = clut.shape[0]
    pcs_lab = prof.pcs.startswith("Lab")
    # mft2 keeps the legacy 16-bit Lab encoding whose max code is 0xFF00
    lab_scale = 65280.0 / 65535.0 if legacy16 else 1.0
    mat = None if matrix is None else matrix.tolist()

    def f(xyz):
        from ..ops.lut3d import lut3d_sample

        c = _on(c0, xyz)
        if pcs_lab:
            lab = xyz_to_lab(xyz, np.asarray(_D50, np.float32))
            enc = torch.stack([fdiv(lab[0], 100.0),
                               fdiv(lab[1] + 128.0, 255.0),
                               fdiv(lab[2] + 128.0, 255.0)]) * lab_scale
        else:
            enc = fdiv(xyz, _PCSXYZ)
            if mat is not None:
                enc = apply_matrix(enc, mat)
        enc = torch.clamp(enc, 0.0, 1.0)
        t = torch.stack([eval_curve(enc[ch], *c[f"b2a_in{ch}"])
                         for ch in range(3)])
        out = lut3d_sample(torch.clamp(t, 0.0, 1.0), c["b2a_clut"], grid, 0)
        return torch.stack([eval_curve(torch.clamp(out[ch], 0.0, 1.0),
                                       *c[f"b2a_out{ch}"])
                            for ch in range(3)])
    return f
