"""The port's ICC profiles (`color/icc.py`) and colorin's and colorout's
DT_COLORSPACE_FILE branches against ansel_tpu on the CPU.

* `parse_icc` gives the JAX package's profile, field for field, for
  the matrix+TRC, mft2 A2B and mft2 B2A profiles tests/test_icc.py
  makes (whose copies in `io/configs.py` make the same bytes), and for
  an mAB/mBA pair.
* `profile_to_xyz_fn` and `xyz_to_device_fn` equal the JAX functions run
  op by op, and are within JIT_TOL of them under `jax.jit` (XLA's CPU
  jit fuses multiplies and adds into FMAs: measured 6.0e-7).
* colorin and colorout: `plan().static` equals the JAX package's; the
  coefficients hold the JAX package's `M` (an identity) and, beside it,
  the curve fits and CLUT that the JAX package makes inside `apply`
  (`_fit_curve`, colorout's 40-node inverse TRC), equal to them; `apply`
  within OP_TOL of the JAX op's run op by op (measured 0); the profile is
  found
  as the JAX package searches for it, and a missing one raises
  ValueError while planning (in `apply` there)."""

import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ansel_tpu.color import icc as ref_icc
from ansel_tpu.core.types import Colorspace as RefCS
from ansel_tpu.core.types import ImageSpec as RefSpec
from ansel_tpu.core.types import RawMeta as RefMeta
from ansel_tpu.ops import base as ref_base
from ansel_tpu.ops import colorin as ref_colorin
from ansel_tpu.ops import colorout as ref_colorout
from ansel_tpu.pixel.curves import MONOTONE_HERMITE, curve_coeffs
from ansel_tpu_torch.color import icc
from ansel_tpu_torch.core.types import Colorspace, ImageSpec, RawMeta
from ansel_tpu_torch.io import configs
from ansel_tpu_torch.ops import base, colorin, colorout
from test_icc import make_b2a_icc, make_lut_icc, make_matrix_icc

torch.set_num_threads(1)

JIT_TOL = 1e-6
OP_TOL = 1e-6
H, W = 16, 32


def _mab_icc():
    """An mAB A2B0 (curves, a 5-grid 16-bit CLUT, 'para' curves) and an
    mBA B2A0 of the same layout."""
    def para(g):
        return b"para\0\0\0\0" + struct.pack(">H2xi", 0, int(g * 65536))

    def lut(tag):
        curves = para(1.0) * 3
        grid = 5
        g1 = np.linspace(0.0, 1.0, grid)
        rr, gg, bb = np.meshgrid(g1, g1, g1, indexing="ij")
        clut = np.stack([rr ** 1.2, gg, bb ** 0.8], -1)
        body = (struct.pack(">16B", *([grid] * 3 + [0] * 13))
                + struct.pack(">B3x", 2)
                + np.round(clut * 65535).astype(">u2").tobytes())
        head = 32
        off_b = head
        off_clut = off_b + len(curves)
        off_a = off_clut + len(body)
        return (tag + b"\0\0\0\0" + struct.pack(">BB2x", 3, 3)
                + struct.pack(">IIIII", off_b, 0, 0, off_clut, off_a)
                + curves + body + para(2.2) * 3)

    return configs._icc_tagged([
        (b"wtpt", configs._icc_xyz((0.9642, 1.0, 0.8249))),
        (b"A2B0", lut(b"mAB ")), (b"B2A0", lut(b"mBA "))])


PROFILES = {"matrix": make_matrix_icc(2.2),
            "matrix-1.0": make_matrix_icc(1.0), "mft2-a2b": make_lut_icc(),
            "mft2-b2a": make_b2a_icc(), "mab": _mab_icc()}
META = RawMeta(width=W, height=H)
REF_META = RefMeta(width=W, height=H)


def test_config_profiles_are_the_jax_tests_profiles():
    assert configs.icc_matrix_profile(1.0) == make_matrix_icc(1.0)
    assert configs.icc_matrix_profile(2.2) == make_matrix_icc(2.2)
    assert configs.icc_b2a_profile() == make_b2a_icc()


def _same(a, b):
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_parse_icc_matches(name):
    got, want = icc.parse_icc(PROFILES[name]), ref_icc.parse_icc(
        PROFILES[name])
    for f in ("kind", "to_xyz", "trc", "in_curves", "clut", "out_curves",
              "lut_matrix", "pcs", "white", "b2a"):
        assert _same(getattr(got, f), getattr(want, f)), f


def _rgb(seed, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, (3, H, W)).astype(
        np.float32)


@pytest.mark.parametrize("name", ["matrix", "mft2-a2b", "mab"])
def test_profile_to_xyz_matches(name):
    got_p, want_p = icc.parse_icc(PROFILES[name]), ref_icc.parse_icc(
        PROFILES[name])
    x = _rgb(1)
    got = icc.profile_to_xyz_fn(got_p, icc.to_xyz_coeffs(got_p))(
        torch.from_numpy(x)).numpy()
    f = ref_icc.profile_to_xyz_fn(want_p)
    assert np.array_equal(got, np.asarray(f(jnp.asarray(x))))
    assert np.abs(got - np.asarray(jax.jit(f)(x))).max() <= JIT_TOL


@pytest.mark.parametrize("name", ["mft2-b2a", "mab"])
def test_xyz_to_device_matches(name):
    got_p, want_p = icc.parse_icc(PROFILES[name]), ref_icc.parse_icc(
        PROFILES[name])
    x = _rgb(2, 0.0, 0.9)
    got = icc.xyz_to_device_fn(got_p, icc.to_device_coeffs(got_p))(
        torch.from_numpy(x)).numpy()
    f = ref_icc.xyz_to_device_fn(want_p)
    assert np.array_equal(got, np.asarray(f(jnp.asarray(x))))
    assert np.abs(got - np.asarray(jax.jit(f)(x))).max() <= JIT_TOL


def _fits(curves):
    return [np.stack(ref_icc._fit_curve(t))
            for t in (curves or [np.linspace(0, 1, 2)] * 3)]


def _flat(clut):
    return clut.transpose(2, 1, 0, 3).reshape(-1, 3).astype(np.float32)


def _run(pkg_op, ctx, spec, p, x, torch_side):
    plan = pkg_op.plan(ctx, spec, p)
    c = pkg_op.coeffs(ctx, plan, p)
    if torch_side:
        dev = {k: torch.as_tensor(np.asarray(v, np.float32))
               for k, v in c.items()}
        return plan, c, pkg_op.apply(torch.from_numpy(x), dev, plan,
                                     ctx).numpy()
    return plan, c, np.asarray(pkg_op.apply(jnp.asarray(x), c, plan, ctx))


@pytest.mark.parametrize("name", ["matrix", "mft2-a2b", "mab"])
def test_colorin_file_profile(tmp_path, name):
    path = tmp_path / "in.icc"
    path.write_bytes(PROFILES[name])
    prof = ref_icc.parse_icc(PROFILES[name])
    x = _rgb(3, 0.02, 0.98)
    got = _run(colorin.Colorin(), base.PlanContext(meta=META),
               ImageSpec(width=W, height=H, colorspace=Colorspace.CAMERA_RGB),
               colorin.ColorinParams(type=0, filename=str(path)), x, True)
    want = _run(ref_colorin.Colorin(),
                ref_base.PlanContext(meta=REF_META),
                RefSpec(width=W, height=H, colorspace=RefCS.CAMERA_RGB),
                ref_colorin.ColorinParams(type=0, filename=str(path)), x,
                False)
    assert got[0].static == want[0].static
    assert np.array_equal(got[1]["M"], want[1]["M"])
    if prof.kind == "matrix":
        extra = dict(zip(("trc0", "trc1", "trc2"), _fits(prof.trc)))
    else:
        extra = {**dict(zip(("in0", "in1", "in2"), _fits(prof.in_curves))),
                 **dict(zip(("out0", "out1", "out2"),
                            _fits(prof.out_curves))),
                 "clut": _flat(prof.clut)}
    assert set(got[1]) == {"M"} | set(extra)
    for k, v in extra.items():
        assert np.array_equal(got[1][k], v), k
    assert np.abs(got[2] - want[2]).max() <= OP_TOL
    assert colorin.Colorin().pointwise_spec(got[0], None) is None


@pytest.mark.parametrize("name", ["matrix", "mft2-b2a", "mab"])
def test_colorout_file_profile(tmp_path, name):
    path = tmp_path / "out.icc"
    path.write_bytes(PROFILES[name])
    prof = ref_icc.parse_icc(PROFILES[name])
    x = _rgb(4, -0.05, 1.1)
    got = _run(colorout.Colorout(), base.PlanContext(meta=META),
               ImageSpec(width=W, height=H, colorspace=Colorspace.WORK_RGB),
               colorout.ColoroutParams(type=0, filename=str(path)), x, True)
    want = _run(ref_colorout.Colorout(),
                ref_base.PlanContext(meta=REF_META),
                RefSpec(width=W, height=H, colorspace=RefCS.WORK_RGB),
                ref_colorout.ColoroutParams(type=0, filename=str(path)), x,
                False)
    assert got[0].static == want[0].static == ("icc", str(path))
    assert np.array_equal(got[1]["M"], want[1]["M"])
    if prof.kind == "matrix":
        extra = {}
        for ch in range(3):
            ys = np.linspace(0.0, 1.0, 4096)
            xs = np.interp(ys, prof.trc[ch],
                           np.linspace(0.0, 1.0, len(prof.trc[ch])))
            pick = np.unique((np.linspace(0.0, 1.0, 40) ** 2
                              * 4095).astype(int))
            extra[f"inv{ch}"] = np.stack(curve_coeffs(
                ys[pick], xs[pick], MONOTONE_HERMITE))
    else:
        inc, clut, outc, _, _ = prof.b2a
        extra = {**dict(zip(("b2a_in0", "b2a_in1", "b2a_in2"), _fits(inc))),
                 **dict(zip(("b2a_out0", "b2a_out1", "b2a_out2"),
                            _fits(outc))),
                 "b2a_clut": _flat(clut)}
    assert set(got[1]) == {"M"} | set(extra)
    for k, v in extra.items():
        assert np.array_equal(got[1][k], v), k
    assert got[2].min() >= 0.0 and got[2].max() <= 1.0
    assert np.abs(got[2] - want[2]).max() <= OP_TOL


def test_profiles_are_searched_as_the_jax_package_searches(tmp_path,
                                                           monkeypatch):
    """A bare name is looked up as given, then under ./color/in (colorin)
    or ./color/out (colorout) of the working directory; a missing or
    empty name raises ValueError while planning."""
    monkeypatch.chdir(tmp_path)
    for sub in ("in", "out"):
        (tmp_path / "color" / sub).mkdir(parents=True)
    (tmp_path / "color" / "in" / "cam.icc").write_bytes(PROFILES["matrix"])
    (tmp_path / "color" / "out" / "disp.icc").write_bytes(
        PROFILES["mft2-b2a"])
    ctx = base.PlanContext(meta=META)
    spec = ImageSpec(width=W, height=H, colorspace=Colorspace.CAMERA_RGB)
    plan = colorin.Colorin().plan(ctx, spec, colorin.ColorinParams(
        type=0, filename="cam.icc"))
    assert plan.aux.kind == "matrix"
    plan = colorout.Colorout().plan(ctx, spec, colorout.ColoroutParams(
        type=0, filename="disp.icc"))
    assert plan.aux.kind == "lut" and plan.aux.b2a is not None
    for p in (colorin.ColorinParams(type=0, filename="gone.icc"),
              colorin.ColorinParams(type=0)):
        with pytest.raises(ValueError):
            colorin.Colorin().plan(ctx, spec, p)
    with pytest.raises(ValueError, match="not found"):
        colorout.Colorout().plan(ctx, spec, colorout.ColoroutParams(
            type=0, filename="gone.icc"))
    # an A2B-only LUT profile cannot render an output
    (tmp_path / "a2b.icc").write_bytes(PROFILES["mft2-a2b"])
    with pytest.raises(ValueError, match="no B2A"):
        colorout.Colorout().plan(ctx, spec, colorout.ColoroutParams(
            type=0, filename="a2b.icc"))
