"""lensfun database bridge — (camera, lens, focal, aperture, distance) ->
distortion / TCA / vignetting model coefficients.

Copied from `ansel_tpu/io/lensfun.py` (it imports no JAX), with its
`ingest_db` (the CLI's `--ingest-lensfun`); the bundled snapshot is
`ansel_tpu_torch/data/lensfun/`.

Reference: `src/iop/lens.cc` (lensfun bridge): at commit
time the reference calls `lf_db_find_cameras_ext` / `lf_db_find_lenses_hd`
to fuzzy-match the EXIF camera/lens identities against the lensfun XML
database, then builds an `lfModifier` that interpolates each calibration
list to the shot's focal length / aperture / subject distance.  Without
this stage a real sidecar's lens op would apply (nearly) no correction.

This module is a self-contained reimplementation of the lensfun *data*
path: an XML parser for the public lensfun database schema, fuzzy
identity matching, and piecewise-linear interpolation over the
calibration lists (lensfun interpolates between the two bracketing focal
lengths; vignetting additionally over aperture and distance).

Database location, in priority order:
  1. conf key ``lensfun/dbpath`` (a directory of lensfun ``*.xml``) —
     point this at a full lensfun checkout for complete coverage;
  2. the bundled snapshot ``ansel_tpu_torch/data/lensfun/`` — a small set of
     common camera/lens entries so the shipped build resolves the usual
     suspects out of the box.  Bundled coefficient values are an
     abbreviated snapshot (see ansel_tpu/data/lensfun/README.md); exactness for a
     given lens requires the full upstream database.

Coordinate convention (applies to every model below): radii are
normalized so that r = 1 at half the SHORTER image dimension — the
PanoTools/ptlens convention lensfun calibrations use (lensfun
mod-coord NormScale = 2/min(w,h)).  Note this differs from the
half-diagonal normalization ``ops/lens.py`` uses for hand-entered
coefficients; resolved params therefore carry ``norm_short_side=1``.

Models (lensfun "XML description of lens database" docs):
  distortion: ptlens  rs = rd (a rd^3 + b rd^2 + c rd + 1-a-b-c)
              poly3   rs = rd (1 - k1 + k1 rd^2)
              poly5   rs = rd (1 + k1 rd^2 + k2 rd^4)
  tca:        linear  rs = rd kr|kb
              poly3   rs = rd (br rd^2 + cr rd + vr)   (per R/B channel)
  vignetting: pa      Cd = 1 + k1 r^2 + k2 r^4 + k3 r^6
"""

from __future__ import annotations

import dataclasses
import functools
import glob
import os
import re
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

from ..core import log

_BUNDLED = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "lensfun")


@dataclasses.dataclass
class Camera:
    maker: str = ""
    model: str = ""
    variants: Tuple[str, ...] = ()
    mount: str = ""
    cropfactor: float = 1.0


@dataclasses.dataclass
class LensEntry:
    maker: str = ""
    model: str = ""
    mounts: Tuple[str, ...] = ()
    cropfactor: float = 1.0
    # calibration rows, each keyed by focal length (mm)
    distortion: List[Dict] = dataclasses.field(default_factory=list)
    tca: List[Dict] = dataclasses.field(default_factory=list)
    vignetting: List[Dict] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Correction:
    """Resolved correction models at one (focal, aperture, distance)."""
    found_lens: bool = False
    crop: float = 1.0
    # distortion
    have_distortion: bool = False
    dist_model: str = "none"           # ptlens | poly3 | poly5
    dist: Tuple[float, ...] = (0.0, 0.0, 0.0)
    # tca per-channel polys: (vr, cr, br), (vb, cb, bb)
    have_tca: bool = False
    tca_r: Tuple[float, float, float] = (1.0, 0.0, 0.0)
    tca_b: Tuple[float, float, float] = (1.0, 0.0, 0.0)
    # vignetting (pa model)
    have_vignetting: bool = False
    vig: Tuple[float, float, float] = (0.0, 0.0, 0.0)


# ----------------------------------------------------------------- parse

def _text(el, tag, default=""):
    c = el.find(tag)
    return (c.text or "").strip() if c is not None and c.text else default


def _floats(el, names, default=0.0):
    return tuple(float(el.get(n, default)) for n in names)


def parse_file(path: str, cameras: List[Camera], lenses: List[LensEntry]):
    root = ET.parse(path).getroot()
    for cam in root.iter("camera"):
        variants = tuple((v.text or "").strip()
                         for v in cam.findall("variant"))
        cameras.append(Camera(
            maker=_text(cam, "maker"), model=_text(cam, "model"),
            variants=variants, mount=_text(cam, "mount"),
            cropfactor=float(_text(cam, "cropfactor", "1.0"))))
    for lens in root.iter("lens"):
        entry = LensEntry(
            maker=_text(lens, "maker"), model=_text(lens, "model"),
            mounts=tuple((m.text or "").strip()
                         for m in lens.findall("mount")),
            cropfactor=float(_text(lens, "cropfactor", "1.0")))
        cal = lens.find("calibration")
        if cal is not None:
            for d in cal.findall("distortion"):
                row = {"model": d.get("model", "none"),
                       "focal": float(d.get("focal", 0.0))}
                if row["model"] == "ptlens":
                    row["coeffs"] = _floats(d, ("a", "b", "c"))
                elif row["model"] == "poly3":
                    row["coeffs"] = (float(d.get("k1", 0.0)), 0.0, 0.0)
                elif row["model"] == "poly5":
                    row["coeffs"] = (float(d.get("k1", 0.0)),
                                     float(d.get("k2", 0.0)), 0.0)
                else:
                    continue
                entry.distortion.append(row)
            for t in cal.findall("tca"):
                row = {"model": t.get("model", "none"),
                       "focal": float(t.get("focal", 0.0))}
                if row["model"] == "linear":
                    row["r"] = (float(t.get("kr", 1.0)), 0.0, 0.0)
                    row["b"] = (float(t.get("kb", 1.0)), 0.0, 0.0)
                elif row["model"] == "poly3":
                    row["r"] = (float(t.get("vr", 1.0)),
                                float(t.get("cr", 0.0)),
                                float(t.get("br", 0.0)))
                    row["b"] = (float(t.get("vb", 1.0)),
                                float(t.get("cb", 0.0)),
                                float(t.get("bb", 0.0)))
                else:
                    continue
                entry.tca.append(row)
            for v in cal.findall("vignetting"):
                if v.get("model") != "pa":
                    continue
                entry.vignetting.append({
                    "focal": float(v.get("focal", 0.0)),
                    "aperture": float(v.get("aperture", 0.0)),
                    "distance": float(v.get("distance", 10.0)),
                    "coeffs": _floats(v, ("k1", "k2", "k3"))})
        for lst in (entry.distortion, entry.tca, entry.vignetting):
            lst.sort(key=lambda r: r["focal"])
        lenses.append(entry)


def ingest_db(src: str, dest: Optional[str] = None) -> Tuple[int, int]:
    """Ingest a full upstream lensfun database for calibrated correction.

    The bundled snapshot's coefficients are authored approximations (see
    data/lensfun/README.md) — this is the supported path to REAL
    measured calibrations.  `src` is either a directory containing
    lensfun ``*.xml`` files (e.g. a checkout's ``data/db/``, or the
    checkout root — ``data/db`` is searched too) or a ``.tar.*`` archive
    of one.  Each XML is validated (parses, contributes at least one
    camera or lens) and copied to `dest` (default
    ``~/.config/ansel_tpu/lensfun``); the conf key ``lensfun/dbpath``
    is pointed there so subsequent `resolve()` calls use it.

    Returns (n_cameras, n_lenses) parsed from the ingested set."""
    import shutil
    import tarfile
    import tempfile

    tmpdir = None
    try:
        if os.path.isfile(src) and ".tar" in os.path.basename(src):
            tmpdir = tempfile.mkdtemp(prefix="lensfun_ingest_")
            with tarfile.open(src) as tf:
                tf.extractall(tmpdir, filter="data")
            src = tmpdir
        candidates = [src, os.path.join(src, "data", "db"),
                      os.path.join(src, "db")]
        xmls: List[str] = []
        for d in candidates:
            if os.path.isdir(d):
                found = sorted(glob.glob(os.path.join(d, "*.xml")))
                if found:
                    xmls = found
                    break
            # archives may nest one level (lensfun-<ver>/data/db)
            if os.path.isdir(src):
                for sub in sorted(os.listdir(src)):
                    dd = os.path.join(src, sub, "data", "db")
                    if os.path.isdir(dd):
                        xmls = sorted(glob.glob(os.path.join(dd, "*.xml")))
                        break
            if xmls:
                break
        if not xmls:
            raise FileNotFoundError(
                f"no lensfun *.xml found under '{src}' (looked in ., "
                "data/db, db)")

        if dest is None:
            dest = os.path.expanduser("~/.config/ansel_tpu/lensfun")
        os.makedirs(dest, exist_ok=True)
        cameras: List[Camera] = []
        lenses: List[LensEntry] = []
        n_copied = 0
        for path in xmls:
            before = (len(cameras), len(lenses))
            try:
                parse_file(path, cameras, lenses)
            except ET.ParseError as e:
                log.log("always",
                        f"lensfun ingest: skipping malformed {path}: {e}")
                continue
            if (len(cameras), len(lenses)) == before:
                continue  # parsed but contributed nothing
            shutil.copy2(path, dest)
            n_copied += 1
        if n_copied == 0:
            raise ValueError(f"no usable lensfun XML in '{src}'")
        from ..core import conf
        conf.set("lensfun/dbpath", dest)
        load_db.cache_clear()
        log.log("always",
                f"lensfun ingest: {n_copied} files, {len(cameras)} "
                f"cameras, {len(lenses)} lenses -> {dest} "
                "(conf lensfun/dbpath updated)")
        return len(cameras), len(lenses)
    finally:
        if tmpdir is not None:
            shutil.rmtree(tmpdir, ignore_errors=True)


@functools.lru_cache(maxsize=4)
def load_db(dbpath: Optional[str] = None):
    """-> (cameras, lenses), parsed once per path."""
    if dbpath is None:
        try:
            from ..core import conf
            dbpath = conf.get("lensfun/dbpath", "") or _BUNDLED
        except Exception:
            dbpath = _BUNDLED
    cameras: List[Camera] = []
    lenses: List[LensEntry] = []
    for path in sorted(glob.glob(os.path.join(dbpath, "*.xml"))):
        try:
            parse_file(path, cameras, lenses)
        except ET.ParseError as e:
            log.log("library", f"lensfun: failed to parse {path}: {e}")
    return tuple(cameras), tuple(lenses)


# ----------------------------------------------------------------- match

_DROP = re.compile(r"[^a-z0-9.]+")


def _tokens(s: str) -> frozenset:
    return frozenset(t for t in _DROP.split(s.lower()) if t)


def _score(query: frozenset, cand: frozenset) -> float:
    """Fuzzy identity score: fraction of candidate tokens present in the
    query + small bonus for query coverage (the reference delegates to
    lensfun's fuzzy matcher; token containment covers the EXIF-string
    vs DB-name differences we see in practice)."""
    if not query or not cand:
        return 0.0
    inter = len(query & cand)
    return inter / len(cand) + 0.1 * inter / len(query)


def find_camera(cam_str: str, dbpath=None) -> Optional[Camera]:
    cameras, _ = load_db(dbpath)
    q = _tokens(cam_str)
    best, best_s = None, 0.0
    for c in cameras:
        names = [f"{c.maker} {c.model}"] + [f"{c.maker} {v}"
                                            for v in c.variants]
        s = max(_score(q, _tokens(n)) for n in names)
        if s > best_s:
            best, best_s = c, s
    return best if best_s >= 0.65 else None


def find_lens(lens_str: str, mount: str = "", dbpath=None
              ) -> Optional[LensEntry]:
    _, lenses = load_db(dbpath)
    q = _tokens(lens_str)
    best, best_s = None, 0.0
    for e in lenses:
        s = _score(q, _tokens(f"{e.maker} {e.model}"))
        if mount and e.mounts and mount not in e.mounts:
            s *= 0.5       # wrong mount strongly penalized, not fatal
        if s > best_s:
            best, best_s = e, s
    return best if best_s >= 0.65 else None


# ----------------------------------------------------- interpolation

def _bracket(rows: List[Dict], focal: float) -> Tuple[Dict, Dict, float]:
    """Two bracketing calibration rows + blend factor (lensfun
    interpolates linearly between neighboring focal lengths)."""
    lo = rows[0]
    hi = rows[-1]
    for r in rows:
        if r["focal"] <= focal:
            lo = r
        if r["focal"] >= focal:
            hi = r
            break
    if hi["focal"] <= lo["focal"]:
        return lo, lo, 0.0
    f = (focal - lo["focal"]) / (hi["focal"] - lo["focal"])
    return lo, hi, max(0.0, min(1.0, f))


def _lerp(a, b, f):
    return tuple(x + (y - x) * f for x, y in zip(a, b))


def resolve(camera: str, lens: str, focal: float, aperture: float,
            distance: float = 10.0, crop: float = 0.0,
            dbpath: Optional[str] = None) -> Correction:
    """Resolve correction models for one shot.  Unresolvable identities
    log a VISIBLE warning (lens.cc behavior: the module disables itself
    with a GUI message; headless we warn and return found_lens=False so
    the op can apply identity loudly, not silently)."""
    out = Correction()
    cam = find_camera(camera, dbpath) if camera else None
    out.crop = crop or (cam.cropfactor if cam else 1.0)
    entry = find_lens(lens, mount=cam.mount if cam else "",
                      dbpath=dbpath) if lens else None
    if entry is None:
        if lens or camera:
            log.log(
                "always",
                f"lensfun: no calibration match for camera='{camera}' "
                f"lens='{lens}' — lens correction will be IDENTITY. "
                "Point conf key lensfun/dbpath at a full lensfun db.")
        return out
    out.found_lens = True

    if entry.distortion:
        lo, hi, f = _bracket(entry.distortion, focal)
        if lo["model"] == hi["model"]:
            out.dist_model = lo["model"]
            out.dist = _lerp(lo["coeffs"], hi["coeffs"], f)
        else:  # model switch mid-zoom: take the nearer row
            r = lo if f < 0.5 else hi
            out.dist_model = r["model"]
            out.dist = tuple(r["coeffs"])
        out.have_distortion = True
    if entry.tca:
        lo, hi, f = _bracket(entry.tca, focal)
        out.tca_r = _lerp(lo["r"], hi["r"], f)
        out.tca_b = _lerp(lo["b"], hi["b"], f)
        out.have_tca = True
    if entry.vignetting:
        # nearest (aperture, distance) among rows bracketing the focal,
        # lerped over focal when both sides exist (lensfun does full
        # trilinear; aperture/distance grids in the db are sparse enough
        # that nearest-with-focal-lerp stays within calibration noise)
        def nearest(rows):
            return min(rows, key=lambda r: (
                abs(r["aperture"] - aperture) / max(aperture, 1e-3)
                + 0.1 * abs(r["distance"] - distance)
                / max(distance, 1e-3)))
        focals = sorted({r["focal"] for r in entry.vignetting})
        flo = max([x for x in focals if x <= focal], default=focals[0])
        fhi = min([x for x in focals if x >= focal], default=focals[-1])
        rlo = nearest([r for r in entry.vignetting if r["focal"] == flo])
        rhi = nearest([r for r in entry.vignetting if r["focal"] == fhi])
        f = 0.0 if fhi <= flo else (focal - flo) / (fhi - flo)
        out.vig = _lerp(rlo["coeffs"], rhi["coeffs"],
                        max(0.0, min(1.0, f)))
        out.have_vignetting = True
    return out
