"""The port's demosaic branches that are plain XLA in the JAX package,
held against it on the CPU: AMaZE, LMMSE (refine 0-4), VNG4 (the four
Bayer patterns), X-Trans VNG, green equilibration (modes 1-3), colour
smoothing, and the demosaic op's dual blend on Bayer (RCD | DUAL) and
X-Trans (0x3001: Markesteijn 1 pass | DUAL).  AMaZE, LMMSE and VNG are
also held against the JAX-free oracles of `tests/mirrors` at the sizes
and interiors of the JAX package's own mirror tests.

The inputs are float32 arrays made from numpy seeds and handed to both
packages.  The dual blends share their base: the JAX op's RCD and its
CPU Markesteijn (another form than its TPU kernel, ROADMAP R2) are
replaced by the port's, so the test holds the blend itself."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ansel_tpu.core.params import params_class as ref_params_class
from ansel_tpu.core.types import CFAPattern as RefCFA
from ansel_tpu.core.types import Colorspace as RefCS
from ansel_tpu.core.types import ImageSpec as RefSpec
from ansel_tpu.core.types import RawMeta as RefMeta
from ansel_tpu.kernels import amaze as ref_amaze
from ansel_tpu.kernels import demosaic_post as ref_post
from ansel_tpu.kernels import lmmse as ref_lmmse
from ansel_tpu.kernels import markesteijn as ref_mark
from ansel_tpu.kernels import rcd as ref_rcd
from ansel_tpu.kernels import vng as ref_vng
from ansel_tpu.ops import _bayer as ref_bayer
from ansel_tpu.ops.base import PlanContext as RefCtx
from ansel_tpu.ops.base import get_op as ref_get_op
from ansel_tpu_torch.core.params import params_class
from ansel_tpu_torch.core.types import (CFAPattern, Colorspace, ImageSpec,
                                        RawMeta)
from ansel_tpu_torch.io.configs import XTRANS6
from ansel_tpu_torch.kernels import (amaze, demosaic_post, lmmse, markesteijn,
                                     rcd, vng)
from ansel_tpu_torch.ops import _bayer
from ansel_tpu_torch.ops import demosaic as dem
from ansel_tpu_torch.ops.base import PlanContext, get_op

from mirrors.amaze_ref import amaze_ref
from mirrors.lmmse_ref import lmmse_ref
from mirrors.vng_ref import vng_ref

torch.set_num_threads(1)

# VNG, colour smoothing, and green equilibration's local pass: each
# pixel's float32 operations in the JAX function's order, compares and
# min/max only past the arithmetic (measured equal)
EXACT = 0.0
# AMaZE: the same operations in the same order; XLA's CPU code fuses a
# product into a sum here and there (measured 6.0e-8 on values below 1,
# 0.8% of the values an ulp apart; 2.4e-7 at scaler 3)
AMAZE_TOL = 1e-6
# LMMSE: the gamma pair's exp/log are XLA's and torch's, an ulp apart at
# times, and the 9-tap sums fuse differently (measured 1.9e-6 on values
# up to 3.7)
LMMSE_TOL = 4e-6
# the full-average green equilibration: the two phase sums are frame
# reductions in another order (measured 2.4e-7 on values below 1)
FAVG_TOL = 1e-6
# the dual blend: the raw-detail mask's sqrt and the sigmoid's exp are
# torch's and XLA's, an ulp apart at times (measured 3.6e-7 at most)
DUAL_TOL = 1e-5
# the mirror oracles, as the JAX package's mirror tests hold its kernels
AMAZE_REF_TOL, AMAZE_REF_M = 1e-5, 20
LMMSE_REF_TOL, LMMSE_REF_M = 2e-6, 20
VNG_REF_M = 6


def _amaze_scene(H, W, seed=5, nyquist_patch=True):
    """tests/test_amaze_mirror.py's scene: smooth colour ramps, noise and
    a pixel-frequency checkerboard, RGGB."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W),
                         indexing="ij")
    scene = np.stack([0.25 + 0.45 * xx + 0.1 * np.sin(9 * yy),
                      0.45 - 0.2 * yy + 0.25 * xx,
                      0.2 + 0.5 * yy * xx])
    scene += rng.normal(0, 0.015, scene.shape)
    if nyquist_patch:
        ph, pw = slice(H // 3, H // 3 + 12), slice(W // 3, W // 3 + 12)
        chk = (np.add.outer(np.arange(12), np.arange(12)) % 2) * 0.5
        scene[:, ph, pw] = 0.25 + chk
    scene = np.clip(scene, 0.0, 1.0).astype(np.float32)
    sel = np.zeros((H, W), int)
    for r in range(2):
        for c in range(2):
            sel[r::2, c::2] = RefCFA.RGGB.color_at(r, c)
    return np.take_along_axis(scene, sel[None], axis=0)[0]


def _wave_scene(h, w, seed, a=5.0, b=7.0, noise=0.15):
    """tests/test_lmmse_mirror.py's and test_vng_mirror.py's scene."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    scene = (0.3 + 0.25 * np.sin(yy / a) + 0.25 * np.cos(xx / b)
             + noise * rng.rand(h, w))
    return np.clip(scene, 0.0, 1.0).astype(np.float32)


def _smooth_mosaic(h, w, seed, imbalance=1.03):
    """A smooth Bayer mosaic whose second green phase reads `imbalance`
    higher: green equilibration's local pass fires on it (its spreads
    stay below 0.0001 x ISO 100)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    x = 0.3 + 0.2 * yy + 0.15 * xx + 0.002 * rng.random((h, w))
    x[1::2, 0::2] *= imbalance
    return x.astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    d = np.abs(got - want)
    assert d.max() <= tol, (float(d.max()), np.argwhere(d > tol)[:4])


# --------------------------------------------------------------- AMaZE

@pytest.mark.parametrize("patch", [False, True])
def test_amaze_matches_reference_and_mirror(patch):
    m = _amaze_scene(72, 88, nyquist_patch=patch)
    got = amaze.amaze_demosaic(_t(m), CFAPattern.RGGB).numpy()
    _close(got, ref_amaze.amaze_demosaic(jnp.asarray(m), RefCFA.RGGB),
           AMAZE_TOL)
    want = amaze_ref(m, lambda r, c: RefCFA.RGGB.color_at(r % 2, c % 2),
                     sequential=True)
    s = slice(AMAZE_REF_M, -AMAZE_REF_M)
    _close(got[:, s, s], want[:, s, s], AMAZE_REF_TOL)


@pytest.mark.parametrize("cfa", ["BGGR", "GBRG"])
def test_amaze_scaler_and_phase_match_reference(cfa):
    m = _wave_scene(72, 88, seed=4) * 3.0
    got = amaze.amaze_demosaic(_t(m), CFAPattern[cfa], torch.tensor(3.0))
    _close(got, ref_amaze.amaze_demosaic(jnp.asarray(m), RefCFA[cfa], 3.0),
           3.0 * AMAZE_TOL)


def test_amaze_scans_are_sequential():
    """Stage 3 and the escalations read the values their own loop already
    wrote (the reference's in-place order), not the input: a Jacobi
    evaluation of either scan differs."""
    rng = np.random.default_rng(3)
    raw = _t(rng.random((40, 36)).astype(np.float32))
    esc = amaze._escalate_rows(raw, 8, 8)
    jac = raw.clone()
    for r in range(8, 32):
        alt = 0.25 * (raw[r - 1, 7:27] + raw[r - 1, 9:29] + raw[r + 1, 7:27]
                      + raw[r + 1, 9:29])
        keep = torch.abs(0.5 - raw[r, 8:28]) < torch.abs(0.5 - alt)
        jac[r, 8:28] = torch.where(keep, alt, raw[r, 8:28])
    assert torch.equal(esc[:8], raw[:8]) and torch.equal(esc[32:], raw[32:])
    assert not torch.equal(esc, jac)
    ref = np.asarray(ref_amaze._escalate_rows(jnp.asarray(raw.numpy()), 8, 8))
    assert np.array_equal(esc.numpy(), ref)


@pytest.mark.parametrize("axis", [0, 1])
def test_amaze_stage3_matches_reference_scan(axis):
    rng = np.random.default_rng(10 + axis)
    shape = (30, 26)
    raw, alt, c0, n1, n2 = (rng.normal(0, 0.2, shape).astype(np.float32)
                            for _ in range(5))
    c0 = np.abs(c0) + 0.5
    gm = (np.add.outer(np.arange(30), np.arange(26)) % 2 == 0)
    got = amaze._stage3_seq(*(_t(a) for a in (raw, alt, gm, c0, n1, n2)),
                            1.0, axis=axis)
    want = ref_amaze._stage3_seq(*(jnp.asarray(a) for a in
                                   (raw, alt, gm, c0, n1, n2)),
                                 1.0, axis=axis)
    _close(got, want, AMAZE_TOL)


# --------------------------------------------------------------- LMMSE

@pytest.mark.parametrize("refine", [0, 1, 2, 3, 4])
def test_lmmse_matches_reference_and_mirror(refine):
    m = _wave_scene(72, 88, seed=3) * 3.7
    got = lmmse.lmmse_demosaic(_t(m), CFAPattern.RGGB, torch.tensor(3.7),
                               refine=refine).numpy()
    _close(got, ref_lmmse.lmmse_demosaic(jnp.asarray(m), RefCFA.RGGB, 3.7,
                                         refine=refine), LMMSE_TOL)
    want = lmmse_ref(m, RefCFA.RGGB.color_at, scaler=3.7, mode=refine)
    s = slice(LMMSE_REF_M, -LMMSE_REF_M)
    _close(got[:, s, s], want[:, s, s], 3.7 * LMMSE_REF_TOL)


def test_lmmse_bggr_matches_reference():
    m = _wave_scene(72, 88, seed=11)
    got = lmmse.lmmse_demosaic(_t(m), CFAPattern.BGGR, 1.0, refine=1)
    _close(got, ref_lmmse.lmmse_demosaic(jnp.asarray(m), RefCFA.BGGR, 1.0,
                                         refine=1), LMMSE_TOL)


# ----------------------------------------------------------------- VNG

@pytest.mark.parametrize("cfa", ["RGGB", "BGGR", "GRBG", "GBRG"])
def test_vng4_matches_reference_and_mirror(cfa):
    m = _wave_scene(48, 64, seed=7, a=4.0, b=6.0, noise=0.2)
    got = vng.vng4_demosaic(_t(m), CFAPattern[cfa]).numpy()
    _close(got, ref_vng.vng4_demosaic(jnp.asarray(m), RefCFA[cfa]), EXACT)
    want = vng_ref(m, filters=ref_vng._FILTERS[RefCFA[cfa]])
    s = slice(VNG_REF_M, -VNG_REF_M)
    _close(got[:, s, s], np.moveaxis(want, -1, 0)[:3, s, s], EXACT)


def test_xtrans_vng_matches_reference_and_mirror():
    m = _wave_scene(48, 64, seed=9, a=4.0, b=6.0, noise=0.2)
    got = vng.xtrans_vng_demosaic(_t(m), XTRANS6).numpy()
    _close(got, ref_vng.xtrans_vng_demosaic(jnp.asarray(m), XTRANS6), EXACT)
    want = vng_ref(m, xtrans=tuple(XTRANS6[r * 6:(r + 1) * 6]
                                   for r in range(6)))
    s = slice(VNG_REF_M, -VNG_REF_M)
    _close(got[:, s, s], np.moveaxis(want, -1, 0)[:3, s, s], EXACT)


@pytest.mark.parametrize("h,w", [(7, 11)])
def test_vng_lattices_cover_odd_frames(h, w):
    """The class lattices of frames whose sides are no multiple of the
    period (and X-Trans frames smaller than two periods) write every
    pixel as the JAX function's whole-frame form does."""
    m = np.random.default_rng(h).random((h, w)).astype(np.float32)
    _close(vng.xtrans_vng_demosaic(_t(m), XTRANS6),
           ref_vng.xtrans_vng_demosaic(jnp.asarray(m), XTRANS6), EXACT)
    _close(vng.vng4_demosaic(_t(m), CFAPattern.GRBG),
           ref_vng.vng4_demosaic(jnp.asarray(m), RefCFA.GRBG), EXACT)


def test_xtrans_lin_interpolate_matches_reference():
    m = np.random.default_rng(5).random((48, 64)).astype(np.float32)
    got = vng.xtrans_lin_interpolate(_t(m), XTRANS6).numpy()
    want, _ = ref_vng.xtrans_lin_interpolate(jnp.asarray(m), XTRANS6)
    _close(got, np.stack([np.asarray(p) for p in want]), EXACT)


def test_xtrans_color_masks_match_reference():
    got = _bayer.xtrans_color_masks(XTRANS6, 13, 17).numpy()
    want = np.asarray(ref_bayer.xtrans_color_masks(XTRANS6, 13, 17))
    assert got.dtype == np.float32 and np.array_equal(got, want)


# ------------------------------------------- green equilibration, smoothing

@pytest.mark.parametrize("mode", [1, 2, 3])
@pytest.mark.parametrize("cfa", ["RGGB", "GBRG"])
def test_green_eq_matches_reference(mode, cfa):
    m = _smooth_mosaic(48, 64, seed=mode)
    got = demosaic_post.apply_green_eq(_t(m), CFAPattern[cfa], mode, 0.01)
    want = ref_post.apply_green_eq(jnp.asarray(m), RefCFA[cfa], mode, 0.01)
    _close(got, want, EXACT if mode == 1 else FAVG_TOL)
    assert np.abs(got.numpy() - m).max() > 1e-4   # it fired


@pytest.mark.parametrize("passes", [1, 2])
def test_color_smoothing_matches_reference(passes):
    rgb = np.random.default_rng(passes).random((3, 33, 47)).astype(
        np.float32) - 0.1
    _close(demosaic_post.color_smoothing(_t(rgb), passes),
           ref_post.color_smoothing(jnp.asarray(rgb), passes), EXACT)


# ------------------------------------------------------ the demosaic op

def _op_pair(params, x, cfa, xtrans=None, iso=100.0):
    """The demosaic op of each package planned and applied on the mosaic
    `x`: -> (port static, port output, JAX output)."""
    h, w = x.shape
    outs, statics = [], []
    for pkg in ("port", "ref"):
        if pkg == "port":
            Meta, Ctx, Spec, CS, C, op, pcls = (
                RawMeta, PlanContext, ImageSpec, Colorspace, CFAPattern,
                get_op("demosaic"), params_class("demosaic"))
        else:
            Meta, Ctx, Spec, CS, C, op, pcls = (
                RefMeta, RefCtx, RefSpec, RefCS, RefCFA,
                ref_get_op("demosaic"), ref_params_class("demosaic"))
        meta = Meta(width=w, height=h, cfa=C[cfa], xtrans=xtrans, iso=iso,
                    wb_coeffs=(2.0, 1.0, 1.5, 1.0))
        ctx = Ctx(meta=meta, processed_maximum=(1.0, 1.0, 1.0))
        spec = Spec(width=w, height=h, colorspace=CS.RAW, channels=1,
                    cfa=C[cfa], pad_w=w, pad_h=h)
        p = pcls(**params)
        plan = op.plan(ctx, spec, p)
        c = op.coeffs(ctx, plan, p)
        statics.append(plan.static)
        if pkg == "port":
            c = {k: torch.tensor(v, dtype=torch.float32) for k, v in c.items()}
            outs.append(op.apply(_t(x), c, plan, ctx).numpy())
        else:
            outs.append(np.asarray(op.apply(jnp.asarray(x), c, plan, ctx)))
    assert statics[0] == statics[1]
    return statics[0], outs[0], outs[1]


@pytest.fixture
def shared_base(monkeypatch):
    """The JAX op's RCD and CPU Markesteijn replaced by the port's."""
    def rcd_port(x, cfa, scaler):
        return jnp.asarray(rcd.rcd_demosaic(
            _t(np.asarray(x)), CFAPattern[cfa.name],
            torch.tensor(np.asarray(scaler, np.float32))).numpy())

    def mark_port(x, xtrans):
        return jnp.asarray(markesteijn.xtrans_markesteijn(
            _t(np.asarray(x)), tuple(xtrans), 1).numpy())

    monkeypatch.setattr(ref_rcd, "rcd_demosaic", rcd_port)
    monkeypatch.setattr(ref_mark, "xtrans_demosaic", mark_port)


@pytest.mark.parametrize("params", [
    {"demosaicing_method": dem.RCD | dem.DUAL_FLAG},
    {"demosaicing_method": dem.RCD | dem.DUAL_FLAG, "dual_thrs": 0.6,
     "green_eq": 3, "color_smoothing": 2},
    {"demosaicing_method": dem.VNG4, "color_smoothing": 3},
    {"demosaicing_method": dem.AMAZE, "green_eq": 1},
    {"demosaicing_method": dem.LMMSE, "lmmse_refine": 4, "green_eq": 2},
], ids=["rcd-dual", "rcd-dual-geq-smooth", "vng4-smooth", "amaze-geq",
        "lmmse-geq"])
def test_bayer_op_matches_reference(shared_base, params):
    m = _wave_scene(72, 88, seed=21, a=3.0, b=2.5, noise=0.05)
    static, got, want = _op_pair(params, m, "RGGB")
    tol = DUAL_TOL if static[0] & dem.DUAL_FLAG else max(AMAZE_TOL,
                                                         LMMSE_TOL)
    _close(got, want, tol)


def test_xtrans_dual_plans_markesteijn_one_pass_and_blends(shared_base,
                                                           monkeypatch):
    """0x3001 (ROADMAP R1: XTRANS_FLAG 0x1000 | DUAL_FLAG 0x2000 | 1)
    plans Markesteijn with one pass and the dual blend over 3-colour VNG;
    colour smoothing after it."""
    m = _wave_scene(48, 64, seed=31, a=3.0, b=2.5, noise=0.05)
    calls, real = [], markesteijn.xtrans_markesteijn
    monkeypatch.setattr(markesteijn, "xtrans_markesteijn",
                        lambda x, p, passes: calls.append(passes)
                        or real(x, p, passes))
    static, got, want = _op_pair(
        {"demosaicing_method": 0x3001, "color_smoothing": 1}, m, "XTRANS",
        xtrans=XTRANS6)
    assert static[0] == 0x3001 == dem.MARKESTEIJN | dem.DUAL_FLAG
    assert calls == [1, 1]        # the port's op, then the shared base
    _close(got, want, DUAL_TOL)
    plain = markesteijn.xtrans_markesteijn(_t(m), XTRANS6, 1).numpy()
    assert np.abs(got - plain).max() > 1e-3   # the blend and smoothing


def test_xtrans_vng_method_runs_through_the_op():
    m = _wave_scene(48, 64, seed=41)
    static, got, want = _op_pair({"demosaicing_method": dem.XTRANS_FLAG},
                                 m, "XTRANS", xtrans=XTRANS6)
    assert static[0] == dem.XTRANS_FLAG
    _close(got, want, EXACT)


def test_green_eq_threshold_follows_iso():
    """0.0001 x ISO (demosaic.c:1001): at ISO 10 the local pass finds no
    green flat enough on this mosaic, at ISO 100 it does."""
    m = _smooth_mosaic(48, 64, seed=9, imbalance=1.0)
    m[1::2, 0::2] += np.float32(0.004)
    params = {"demosaicing_method": dem.PPG, "green_eq": 1}
    _, lo, lo_ref = _op_pair(params, m, "RGGB", iso=10.0)
    _, hi, hi_ref = _op_pair(params, m, "RGGB", iso=100.0)
    _close(lo, lo_ref, EXACT)
    _close(hi, hi_ref, EXACT)
    assert np.abs(hi - lo).max() > 1e-4
