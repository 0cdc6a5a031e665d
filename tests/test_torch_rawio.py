"""The port's camera raw loader (ansel_tpu_torch/io/dng.py, the native
decoder built under build/) against ansel_tpu's on the CPU: the mosaic
and every RawMeta field, GainMaps included, equal bit for bit on every
container the in-repo encoders write (tests/test_dng.py: uncompressed
16-bit, packed 12-bit, lossless-JPEG, GainMap; tests/rawfixtures.py: NEF
packed and 34713, ARW and ARW2, CR2, CR3, RAF Bayer and X-Trans, RW2, ORF,
PEF); garbage is rejected; rawprepare's GainMap flat field against the
JAX package's (plan and coefficients exactly, pixels within GM_TOL); a
small RAF through the port's X-Trans pipe against the JAX package's.

Tolerances: GM_TOL for the flat field (both packages sum the bilinear
map products in float32 matrix products, whose order of accumulation
differs); the X-Trans pipe within the display quantum 1/255 of the JAX
package's CPU pipe inside a RING-px border (its whole-image Markesteijn
fills the 2x2 greens and pads the frame its own way, ROADMAP R2, as in
tests/test_torch_config4.py)."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ansel_tpu
import ansel_tpu_torch
from ansel_tpu.core import types as ref_types
from ansel_tpu.io import dng as ref_dng
from ansel_tpu.io import rawfile as ref_rawfile
from ansel_tpu.ops import base as ref_base
from ansel_tpu_torch.core import types as port_types
from ansel_tpu_torch.io import dng, rawfile
from ansel_tpu_torch.ops import base as port_base
from rawfixtures import (write_arw, write_arw2, write_cr2, write_cr3,
                         write_nef, write_nef_34713, write_orf, write_pef,
                         write_raf, write_raf_compressed, write_rw2)
from test_dng import lj92_encode, opcode_list2_blob, write_dng

torch.set_num_threads(2)

GM_TOL = 1e-6
DISPLAY_QUANTUM = 1.0 / 255.0
RING = 16
XTRANS6 = np.asarray(((1, 2, 0, 1, 0, 2),
                      (0, 1, 1, 2, 1, 1),
                      (2, 1, 1, 0, 1, 1),
                      (1, 0, 2, 1, 2, 0),
                      (2, 1, 1, 0, 1, 1),
                      (0, 1, 1, 2, 1, 1)))


def _mosaic(h, w, bits, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << bits, (h, w), dtype=np.uint16)


def _smooth(h, w, lo, hi, seed, mid, amp, period):
    """A smooth mosaic with +-25 noise, as the predictive codecs' fixtures
    in tests/test_rawdec.py need."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = mid + amp[0] * np.sin(yy / period[0]) \
        + amp[1] * np.cos(xx / period[1])
    return np.clip(base + rng.integers(-25, 25, (h, w)), lo, hi) \
        .astype(np.uint16)


def _gainmaps(h, w):
    rng = np.random.default_rng(7)
    gains4 = [rng.uniform(0.8, 1.25, 3 * 5).astype(np.float32)
              for _ in range(4)]
    return opcode_list2_blob(h, w, 3, 5, gains4)


def _dng_lj92(p):
    m = _mosaic(32, 48, 16, seed=3)
    payload = lj92_encode(m)
    write_dng(p, m, compression=7, payload=payload)


# every container the in-repo encoders write: name -> writer(path)
WRITERS = {
    "dng-16": ("dng", lambda p: write_dng(p, _mosaic(32, 48, 16))),
    "dng-12": ("dng", lambda p: write_dng(p, _mosaic(32, 48, 12, 1),
                                          bits=12)),
    "dng-lj92": ("dng", _dng_lj92),
    "dng-gainmap": ("dng", lambda p: write_dng(
        p, _mosaic(32, 48, 16, 2),
        extra_tags=[(51009, 7, len(_gainmaps(32, 48)),
                     _gainmaps(32, 48))])),
    "nef": ("nef", lambda p: write_nef(p, _mosaic(48, 64, 14), bits=14)),
    "nef-34713": ("nef", lambda p: write_nef_34713(
        p, _mosaic(48, 64, 14, 14), bits=14)),
    "arw": ("arw", lambda p: write_arw(p, _mosaic(40, 96, 12), bits=12)),
    "arw2": ("arw", lambda p: write_arw2(
        p, _mosaic(32, 64, 11, 7), encrypted=True)),
    "cr2": ("cr2", lambda p: write_cr2(p, _mosaic(32, 96, 14, 3), bits=14,
                                       n_slices=3)),
    "cr3": ("cr3", lambda p: write_cr3(p, _mosaic(40, 64, 14, 7), bits=14,
                                       iso=1600)),
    "raf-bayer": ("raf", lambda p: write_raf_compressed(
        p, _mosaic(40, 64, 14, 5), xtrans=None, bits=14, block_size=64)),
    "raf-xtrans": ("raf", lambda p: write_raf(
        p, _mosaic(48, 60, 16), tuple(map(tuple, XTRANS6)))),
    "raf-xtrans-compressed": ("raf", lambda p: write_raf_compressed(
        p, _mosaic(48, 96, 14, 3), tuple(map(tuple, XTRANS6)), bits=14,
        block_size=48)),
    "rw2": ("rw2", lambda p: write_rw2(
        p, _smooth(40, 64, 160, 4095, 21, 1800, (700, 600), (15.0, 20.0)),
        iso=640)),
    "orf": ("orf", lambda p: write_orf(p, _mosaic(48, 64, 12, 6))),
    "orf-compressed": ("orf", lambda p: write_orf(
        p, _smooth(48, 64, 0, 4095, 5, 1500, (900, 800), (8.0, 10.0)),
        compressed=True)),
    "pef": ("pef", lambda p: write_pef(p, _mosaic(40, 64, 12, 17), bits=12)),
}


def _fields(meta):
    return {f.name: getattr(meta, f.name) for f in dataclasses.fields(meta)}


def _same_meta(port, ref):
    a, b = _fields(port), _fields(ref)
    assert a.keys() == b.keys()
    for k in a:
        if k == "cfa":
            assert a[k].value == b[k].value, k
        elif k == "gain_maps":
            assert [_fields(g) for g in a[k]] == [_fields(g) for g in b[k]]
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("name", sorted(WRITERS))
def test_loader_equals_the_reference(tmp_path, name):
    ext, write = WRITERS[name]
    path = str(tmp_path / f"shot.{ext}")
    write(path)
    raw, meta = rawfile.load_raw(path)
    ref_raw, ref_meta = ref_rawfile.load_raw(path)
    assert raw.dtype == np.float32 and raw.shape == ref_raw.shape
    assert np.array_equal(raw, ref_raw)
    _same_meta(meta, ref_meta)
    if name == "dng-gainmap":
        assert len(meta.gain_maps) == 4
    if name.startswith("raf-xtrans"):
        assert meta.xtrans is not None


def test_garbage_is_rejected(tmp_path):
    path = str(tmp_path / "junk.dng")
    with open(path, "wb") as f:
        f.write(b"II*\0" + bytes(range(256)) * 4)
    with pytest.raises(ValueError):
        dng.load_raw(path)
    with pytest.raises(ValueError):
        ref_dng.load_raw(path)


def test_the_decoder_is_built_under_build():
    lib = dng.build()
    assert lib.exists() and lib == dng.library_path()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.dirname(lib) == os.path.join(root, "build",
                                                "ansel_tpu_torch")


def test_parse_opcode_list2_equals_the_reference():
    blob = _gainmaps(32, 48)
    got, want = dng.parse_opcode_list2(blob), ref_dng.parse_opcode_list2(blob)
    assert [_fields(g) for g in got] == [_fields(g) for g in want]
    assert dng.parse_opcode_list2(blob[:10]) == ()


# --- rawprepare's GainMap flat field ----------------------------------------

@pytest.mark.parametrize("crop", [(0, 0), (3, 2)], ids=["full", "crop-odd"])
def test_gainmap_flat_field_equals_the_reference(tmp_path, crop):
    path = str(tmp_path / "gm.dng")
    WRITERS["dng-gainmap"][1](path)
    raw, meta = dng.load_raw(path)
    _, ref_meta = ref_dng.load_raw(path)
    out = []
    for base, m, types in ((port_base, meta, port_types),
                           (ref_base, ref_meta, ref_types)):
        op = base.get_op("rawprepare")
        p = dataclasses.replace(op.default_params(m), flat_field=1,
                                x=crop[1], y=crop[0])
        ctx = base.PlanContext(meta=m)
        spec = types.ImageSpec(width=m.width, height=m.height,
                               colorspace=types.Colorspace.RAW, channels=1,
                               cfa=types.CFAPattern.RGGB)
        plan = op.plan(ctx, spec, p)
        out.append((op, plan, op.coeffs(ctx, plan, p), ctx))
    (pop, pplan, pc, pctx), (rop, rplan, rc, rctx) = out
    assert pplan.static == rplan.static and pplan.static[2] == (3, 5)
    assert pc.keys() == rc.keys()
    for k in pc:
        assert np.array_equal(np.asarray(pc[k]), np.asarray(rc[k])), k
    x = np.asarray(np.pad(raw, ((0, pplan.spec_in.pad_h - raw.shape[0]),
                                (0, pplan.spec_in.pad_w - raw.shape[1])),
                          mode="edge"), np.float32)
    got = pop.apply(torch.from_numpy(x), {
        k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in pc.items()},
        pplan, pctx).numpy()
    want = np.asarray(rop.apply(jnp.asarray(x), {
        k: jnp.asarray(np.asarray(v, np.float32)) for k, v in rc.items()},
        rplan, rctx))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= GM_TOL


# --- a RAF through the port's X-Trans pipe ----------------------------------

@pytest.fixture
def fresh_xtrans_geometry():
    """The JAX package caches Markesteijn's per-shape masks in an
    lru_cache that keeps what its first call made: a tracer where that
    call ran inside another test file's jitted X-Trans pipe of the same
    shape in this process, which a later jit cannot use.  Empty it before
    and after."""
    from ansel_tpu.kernels import markesteijn as ref_markesteijn

    ref_markesteijn._geometry.cache_clear()
    yield
    ref_markesteijn._geometry.cache_clear()


def test_raf_through_the_xtrans_pipe(tmp_path, fresh_xtrans_geometry):
    yy, xx = np.mgrid[0:48, 0:60]
    scene = 0.2 + 0.5 * xx / 60 + 0.3 * yy / 48
    sel = XTRANS6[yy % 6, xx % 6]
    m = (scene * 4000 + 100 * (sel == 1)).astype(np.uint16)
    path = str(tmp_path / "shot.raf")
    write_raf(path, m, tuple(map(tuple, XTRANS6)))
    raw, meta = rawfile.load_raw(path)
    ref_raw, ref_meta = ref_rawfile.load_raw(path)
    items = [("demosaic", {"demosaicing_method": 1024 | 1}),
             ("filmicrgb", {})]
    got = ansel_tpu_torch.compile_pipeline(
        meta, [ansel_tpu_torch.HistoryItem(o, dict(p)) for o, p in items],
        device="cpu").output_array(raw)
    want = np.asarray(ansel_tpu.compile_pipeline(
        ref_meta, [ansel_tpu.HistoryItem(o, dict(p)) for o, p in items])
        .output_array(ref_raw))
    assert got.shape == want.shape == (3, 48, 60)
    assert np.isfinite(got).all() and got.max() > 0.05
    assert np.abs(got - want)[:, RING:-RING, RING:-RING].max() \
        <= DISPLAY_QUANTUM
