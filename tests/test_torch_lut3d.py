"""The port's lut3d (`ops/lut3d.py`, `io/lut3d_file.py`, `io/gmz.py`)
against ansel_tpu on the CPU.

* `lut3d_sample` at levels 2, 17 and 33, trilinear and tetrahedral: equal
  to the JAX function run op by op, and within SAMPLE_JIT_TOL of it
  under `jax.jit` (XLA's CPU jit fuses multiplies and adds into FMAs:
  measured 1.2e-7 on values in [0, 1]).
* The loaders: a .cube, a .3dl, a .gmz archive, inline keypoints and an
  8-bit Hald PNG written by PIL give the JAX package's tables bit for
  bit; a 16-bit Hald PNG and a Hald JPEG are read through PIL as the JAX
  package reads them, and refused without PIL (NotImplementedError, not
  the identity); a missing file is the identity in both packages.
* The op: `plan().static` and `coeffs()` equal the JAX package's for
  each source of a table (file, .gmz by name, inline keypoints, a
  relative path under ANSEL_TPU_LUT_ROOT, a missing file) and for the
  v1 and v2 params blobs; `apply` in each application colour space
  within APPLY_TOL of the JAX op's (measured up to 1.1e-6, the Adobe RGB
  transfer's pow on a Hald table; 0 in linear Rec2020)."""

import dataclasses
import struct
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ansel_tpu.core.params import params_class as ref_params_class
from ansel_tpu.core.types import Colorspace as RefCS
from ansel_tpu.core.types import ImageSpec as RefSpec
from ansel_tpu.io import gmz as ref_gmz
from ansel_tpu.io import lut3d_file as ref_file
from ansel_tpu.ops import base as ref_base
from ansel_tpu.ops import lut3d as ref_lut3d
from ansel_tpu.io.synthetic import synth_raw
from ansel_tpu_torch.core.params import params_class
from ansel_tpu_torch.core.types import Colorspace, ImageSpec
from ansel_tpu_torch.io import configs, gmz, lut3d_file
from ansel_tpu_torch.ops import base
from ansel_tpu_torch.ops import lut3d

torch.set_num_threads(1)

SAMPLE_JIT_TOL = 1e-6
APPLY_TOL = 2e-6
H, W = 24, 40


def _codes(seed):
    """(3, H, W) code values in [0, 1], the cube's faces included."""
    t = np.random.default_rng(seed).uniform(0, 1, (3, H, W)).astype(
        np.float32)
    t[:, 0, :6] = np.array([[0, 1, 0.5, 1, 0, 1]] * 3, np.float32)
    return t


@pytest.mark.parametrize("level", [2, 17, 33])
@pytest.mark.parametrize("interp", [0, 1], ids=["tetrahedral", "trilinear"])
def test_lut3d_sample_matches_jax(level, interp):
    rng = np.random.default_rng(level + 10 * interp)
    flat = rng.uniform(0, 1, (level ** 3, 3)).astype(np.float32)
    t = _codes(level)
    got = lut3d.lut3d_sample(torch.from_numpy(t), torch.from_numpy(flat),
                             level, interp).numpy()
    eager = np.asarray(ref_lut3d.lut3d_sample(jnp.asarray(t),
                                              jnp.asarray(flat), level,
                                              interp))
    jitted = np.asarray(jax.jit(lambda a, f: ref_lut3d.lut3d_sample(
        a, f, level, interp))(t, flat))
    assert got.shape == (3, H, W)
    assert np.array_equal(got, eager)
    assert np.abs(got - jitted).max() <= SAMPLE_JIT_TOL


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """A .cube (with a domain), a .3dl, a .gmz of two keypoint sets, an
    8-bit Hald PNG (PIL, level 16), a 16-bit one and a Hald JPEG."""
    d = tmp_path_factory.mktemp("lut3d")
    rng = np.random.default_rng(3)
    cube = configs.cube14(3, 17)
    paths = {"cube": str(d / "a.cube"), "3dl": str(d / "a.3dl"),
             "gmz": str(d / "set.gmz"), "hald": str(d / "hald.png"),
             "hald16": str(d / "hald16.png"), "jpg": str(d / "hald.jpg")}
    configs.write_cube(paths["cube"], cube)
    with open(paths["cube"], "a") as f:
        f.write("DOMAIN_MIN 0 0 0\nDOMAIN_MAX 1 1 1\n")
    codes = rng.integers(0, 1024, (17 ** 3, 3))
    with open(paths["3dl"], "w") as f:
        f.write("# a 3dl\n" + " ".join(str(v) for v in range(0, 1024, 64))
                + "\n" + "\n".join(" ".join(map(str, r)) for r in codes))
    gmz.write_gmz(paths["gmz"], [("warm", configs.keypoints14(1)),
                                 ("cool", configs.keypoints14(2))])
    hald = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    Image.fromarray(hald, "RGB").save(paths["hald"])
    Image.fromarray((hald.astype(np.uint16) * 257)[..., 0]).save(
        paths["hald16"])
    Image.fromarray(hald, "RGB").save(paths["jpg"])
    return paths


@pytest.mark.parametrize("kind", ["cube", "3dl", "hald"])
def test_loaders_equal_the_jax_package(tables, kind):
    got = lut3d_file.load_lut3d(tables[kind])
    want = ref_file.load_lut3d(tables[kind])
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape and np.array_equal(got, want)


def test_gmz_and_inline_keypoints_equal_the_jax_package(tables):
    got, want = gmz.read_gmz(tables["gmz"]), ref_gmz.read_gmz(tables["gmz"])
    assert [n for n, _ in got] == [n for n, _ in want] == ["warm", "cool"]
    for (_, a), (_, b) in zip(got, want):
        assert np.array_equal(a, b)
    kp = configs.keypoints14(0)
    assert np.array_equal(gmz.decompress_clut(kp, 17),
                          ref_gmz.decompress_clut(kp, 17))
    assert np.array_equal(gmz.clut_from_params(kp.tobytes(), len(kp)),
                          ref_gmz.clut_from_params(kp.tobytes(), len(kp)))
    assert gmz.clut_from_params(kp.tobytes()[:-1], len(kp)) is None


def test_other_hald_forms_are_refused(tables, monkeypatch):
    """PIL reads them in both packages alike; without PIL the port
    refuses rather than render the identity.  A file that is missing is
    an OSError in both, which the op turns into the identity."""
    for kind in ("hald16", "jpg"):
        want = ref_file.load_lut3d(tables[kind])
        assert want.shape[0] == 16
        assert np.array_equal(lut3d_file.load_lut3d(tables[kind]), want)
    missing = tables["jpg"][:-4] + "-missing.jpg"
    for loader in (lut3d_file.load_lut3d, ref_file.load_lut3d):
        with pytest.raises(OSError):
            loader(missing)
    monkeypatch.setitem(sys.modules, "PIL", None)
    for kind in ("hald16", "jpg"):
        with pytest.raises(NotImplementedError):
            lut3d_file.load_lut3d(tables[kind])
    with pytest.raises(OSError):
        lut3d_file.load_lut3d(missing)
    with pytest.raises(NotImplementedError):
        lut3d.Lut3D().plan(None, None, params_class("lut3d")(
            filepath=tables["hald16"]))


def test_png_reader_undoes_every_filter(tmp_path):
    """RGB and RGBA images whose rows PIL filters in each of the five
    ways equal PIL's decode."""
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:37, 0:53]
    for mode, c in (("RGB", 3), ("RGBA", 4)):
        smooth = (yy[..., None] * 3 + xx[..., None] * 5
                  + np.arange(c) * 40) % 256
        img = (smooth + rng.integers(0, 16, smooth.shape)).astype(np.uint8)
        path = str(tmp_path / f"{mode}.png")
        Image.fromarray(img, mode).save(path)
        with open(path, "rb") as f:
            raw = f.read()
        assert np.array_equal(lut3d_file.read_png8(path), img)
        assert np.array_equal(np.asarray(Image.open(path)), img)
        rows = zlib.decompress(b"".join(_chunks(raw, b"IDAT")))
        stride = 53 * c + 1
        assert len({rows[y * stride] for y in range(37)}) > 1


def _chunks(data, kind):
    pos = 8
    while pos + 8 <= len(data):
        (n,) = struct.unpack_from(">I", data, pos)
        if data[pos + 4:pos + 8] == kind:
            yield data[pos + 8:pos + 8 + n]
        pos += 12 + n


def _specs():
    return (ImageSpec(width=W, height=H, colorspace=Colorspace.WORK_RGB),
            RefSpec(width=W, height=H, colorspace=RefCS.WORK_RGB))


def _both(**kw):
    return params_class("lut3d")(**kw), ref_params_class("lut3d")(**kw)


def _cases(tables):
    kp = configs.keypoints14(0)
    return {
        "cube": dict(filepath=tables["cube"]),
        "3dl": dict(filepath=tables["3dl"], interpolation=1),
        "gmz-by-name": dict(filepath=tables["gmz"], lutname="cool"),
        "gmz-first": dict(filepath=tables["gmz"], lutname="nope"),
        "keypoints": dict(nb_keypoints=len(kp), c_clut=kp.tobytes(),
                          colorspace=4, interpolation=1),
        "hald": dict(filepath=tables["hald"], colorspace=1),
        "relative": dict(filepath="a.cube", colorspace=2),
        "missing": dict(filepath=tables["cube"] + ".gone"),
    }


@pytest.mark.parametrize("case", ["cube", "3dl", "gmz-by-name", "gmz-first",
                                  "keypoints", "hald", "relative",
                                  "missing"])
def test_op_plan_coeffs_and_apply_equal_the_jax_package(tables, case,
                                                        monkeypatch):
    import os

    monkeypatch.setenv("ANSEL_TPU_LUT_ROOT", os.path.dirname(tables["cube"]))
    p, rp = _both(**_cases(tables)[case])
    _, meta, _ = synth_raw(h=H, w=W)
    spec, rspec = _specs()
    op, rop = lut3d.Lut3D(), ref_lut3d.Lut3D()
    ctx = base.PlanContext(meta=meta)
    rctx = ref_base.PlanContext(meta=meta)
    plan, rplan = op.plan(ctx, spec, p), rop.plan(rctx, rspec, rp)
    assert plan.static == rplan.static
    assert (plan.static[2] == 0) == (case == "missing")
    c, rc = op.coeffs(ctx, plan, p), rop.coeffs(rctx, rplan, rp)
    assert c.keys() == rc.keys()
    for k in c:
        assert np.array_equal(c[k], np.asarray(rc[k]))
    x = np.random.default_rng(7).uniform(0.0, 1.2, (3, spec.pad_h,
                                                    spec.pad_w)).astype(
        np.float32)
    got = op.apply(torch.from_numpy(x), {k: torch.from_numpy(v)
                                         for k, v in c.items()}, plan, ctx)
    want = np.asarray(rop.apply(jnp.asarray(x), rc, rplan, rctx))
    assert np.abs(got.numpy() - want).max() <= APPLY_TOL


@pytest.mark.parametrize("cs", [0, 1, 2, 3, 4])
def test_apply_in_each_colorspace(tables, cs):
    p, rp = _both(filepath=tables["cube"], colorspace=cs)
    spec, rspec = _specs()
    _, meta, _ = synth_raw(h=H, w=W)
    op, rop = lut3d.Lut3D(), ref_lut3d.Lut3D()
    ctx, rctx = base.PlanContext(meta=meta), ref_base.PlanContext(meta=meta)
    plan, rplan = op.plan(ctx, spec, p), rop.plan(rctx, rspec, rp)
    c = {k: torch.from_numpy(v) for k, v in op.coeffs(ctx, plan, p).items()}
    x = np.random.default_rng(cs).uniform(-0.05, 1.1, (3, spec.pad_h,
                                                       spec.pad_w)).astype(
        np.float32)
    got = op.apply(torch.from_numpy(x), c, plan, ctx).numpy()
    want = np.asarray(rop.apply(jnp.asarray(x), rop.coeffs(rctx, rplan, rp),
                                rplan, rctx))
    assert np.abs(got - want).max() <= APPLY_TOL


@pytest.mark.parametrize("version", [1, 2])
def test_legacy_params_decode_alike(version):
    kp = configs.keypoints14(0)
    path = b"/luts/a.cube".ljust(512, b"\0")
    if version == 1:
        blob = struct.pack("<512s2i", path, 1, 1)
    else:
        blob = struct.pack("<512s3i12288s", path, 2, 0, len(kp),
                           kp.tobytes().ljust(12288, b"\0"))
    got = params_class("lut3d").from_legacy(version, blob)
    want = ref_params_class("lut3d").from_legacy(version, blob)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert params_class("lut3d").codec.encode(got) == \
        ref_params_class("lut3d").codec.encode(want)
