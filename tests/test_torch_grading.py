"""The eleven grading ops of the chain kernel (colorbalancergb, rgbcurve,
rgblevels, basecurve, tonecurve, levels, basicadj, colorzones,
negadoctor, vignette, graduatednd) against ansel_tpu on the CPU, each at
the two parameter sets of `configs.GRADING_CASES`: plan statics and
coefficients equal; the port's chain stage (its plain torch `fn`, what a
CPU chain runs) against the JAX package's `pointwise_spec.fn` run through
`pallas_pointwise(..., interpret=True)` as the JAX engine fuses it, and
against the JAX op's own `apply`, at (3, 48, 64).  Also `atan_pos` and
`atan2_full` against the JAX ones and the position-reading ops on a whole
frame and under an `out_window`, inside the chains of both packages."""

import dataclasses
import enum

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ansel_tpu
import ansel_tpu_torch
from ansel_tpu.core.types import Colorspace as RefColorspace
from ansel_tpu.core.types import ImageSpec as RefImageSpec
from ansel_tpu.io.synthetic import synth_raw
from ansel_tpu.kernels import pointwise as ref_pw
from ansel_tpu.kernels import rcd as ref_rcd
from ansel_tpu.kernels import rcd_pallas
from ansel_tpu.ops import base as ref_base
from ansel_tpu.pipeline import engine as ref_engine
from ansel_tpu_torch.core.types import Colorspace, ImageSpec
from ansel_tpu_torch.io import configs
from ansel_tpu_torch.kernels import pointwise as pw
from ansel_tpu_torch.ops import base
from ansel_tpu_torch.pipeline import engine

torch.set_num_threads(1)

# the frame; the arrays are its lane-padded (3, 48, 128), as the engines
# run a stage (the position-reading ops see the padding's columns too)
H, W = 48, 64
# Both packages run the same float32 operations in the same order; what
# differs is XLA's and torch's pow/exp/log/cos on the CPU (an ulp each),
# XLA's FMA contraction, and how far each op amplifies that.  Every bound
# scales with the output's largest magnitude (Lab outputs reach 100 and
# more).  colorbalancergb's JzAzBz branch (set B) raises a PQ term to the
# power 134 and back: on this input each float32 form (the port's, the
# JAX package's fused and per-op) lies 2.0-2.2e-5 on average and 3.2-3.5e-4
# at most from the same function evaluated in float64 (output scale 2.6),
# so two forms differ by up to twice that (measured: mean 2.0e-5, max
# 6.2e-4).  Its dt UCS branch (set A) chains a dozen powers (1.6e-5 at
# most from float64).
MAX_TOL = {"colorbalancergb": 3e-4}
MEAN_TOL = {"colorbalancergb": 1e-5}
DEFAULT_MAX_TOL = 2e-5
DEFAULT_MEAN_TOL = 1e-6


def _plain(v):
    if isinstance(v, enum.Enum):
        return v.value
    if dataclasses.is_dataclass(v):
        return tuple(_plain(getattr(v, f.name)) for f in dataclasses.fields(v))
    if isinstance(v, (tuple, list)):
        return tuple(_plain(x) for x in v)
    return v


@pytest.fixture(scope="session")
def meta():
    return synth_raw(h=32, w=48)[1]


def _input(kind, shape, seed=7):
    """(3, h, w) float32: work RGB with a little below 0 and up to 1.6, or
    Lab with L in [0, 100] and a, b in [-80, 80]; some zeros."""
    rng = np.random.default_rng(seed)
    _, h, w = shape
    if kind == "lab":
        x = np.stack([rng.uniform(0.0, 100.0, (h, w)),
                      rng.uniform(-80.0, 80.0, (h, w)),
                      rng.uniform(-80.0, 80.0, (h, w))])
    else:
        x = rng.uniform(-0.05, 1.6, (3, h, w))
    x = x.astype(np.float32)
    x[:, 0, :5] = 0.0
    return x


def _planned(pkg_base, op_name, params, meta, spec):
    op = pkg_base.get_op(op_name)
    p = dataclasses.replace(op.default_params(meta), **params)
    ctx = pkg_base.PlanContext(meta=meta)
    plan = op.plan(ctx, spec, p)
    return op, ctx, plan, op.coeffs(ctx, plan, p)


KIND = {name: kind for name, kind, _, _ in configs.GRADING_CASES}


def _spec(pkg_types, op_name):
    """The op's input space: Lab or work RGB, camera RGB for graduatednd
    (it runs before colorin)."""
    cs = {"lab": "LAB", "rgb": "WORK_RGB"}[KIND[op_name]]
    if op_name == "graduatednd":
        cs = "CAMERA_RGB"
    ImageSpec_, Colorspace_ = pkg_types
    return ImageSpec_(width=W, height=H, colorspace=getattr(Colorspace_, cs))


def _pallas(op, ctx, plan, c, x):
    """The JAX op's pointwise spec through pallas_pointwise in interpret
    mode, packed as the JAX engine packs a fused group (tiles of 16 x 32,
    so a position-reading stage sees tile offsets)."""
    spec = op.pointwise_spec(plan, ctx)
    pack = ref_pw.ConstPack()
    vec = pack.pack(c, spec.consts)

    def block_fn(block, consts_ref, yy=None, xx=None):
        cd = {}
        for name in spec.consts:
            if name in spec.lists:
                v = pack.get_list(consts_ref, name)
            else:
                v = pack.get(consts_ref, name)
                if name in spec.mats:
                    v = [[v[3 * r + i] for i in range(3)] for r in range(3)]
            cd[name] = v
        if spec.needs_pos:
            return spec.fn(block, cd, yy, xx)
        return spec.fn(block, cd)

    return np.asarray(ref_pw.pallas_pointwise(
        block_fn, jnp.asarray(x), vec, tile_h=16, tile_w=32,
        with_pos=spec.needs_pos, interpret=True))


CASES = [(name, label, params)
         for name, _, a, b in configs.GRADING_CASES
         for label, params in (("A", a), ("B", b))]


@pytest.mark.parametrize("name,label,params", CASES,
                         ids=[f"{n}-{l}" for n, l, _ in CASES])
def test_grading_op_matches_the_jax_package(name, label, params, meta):
    kind = KIND[name]
    rop, rctx, rplan, rc = _planned(ref_base, name, params, meta,
                                    _spec((RefImageSpec, RefColorspace), name))
    op, ctx, plan, c = _planned(base, name, params, meta,
                                _spec((ImageSpec, Colorspace), name))
    assert plan.spec_in.array_shape == (3, H, 128)
    x = _input(kind, plan.spec_in.array_shape)
    assert type(op).__name__ == type(rop).__name__
    assert _plain(plan.static) == _plain(rplan.static)
    assert sorted(c) == sorted(rc)
    for k in c:
        assert np.array_equal(np.asarray(c[k], np.float32),
                              np.asarray(rc[k], np.float32)), k

    dev = engine.coeffs_to_device([c], "cpu")[0]
    chain = pw.pack_chain([op.pointwise_spec(plan, ctx)], [dev], "cpu")
    got = pw.pointwise_chain(torch.from_numpy(x), chain).numpy()
    # the op's own per-op path gives the same numbers
    assert np.array_equal(
        op.apply(torch.from_numpy(x), dev, plan, ctx).numpy(), got)
    assert np.isfinite(got).all()
    assert np.abs(got - x).max() > 1e-3      # not an identity
    jax_c = {k: (jnp.asarray(np.asarray(v, np.float32))
                 if not isinstance(v, tuple) else
                 tuple(jnp.asarray(a) for a in v)) for k, v in rc.items()}
    for want in (_pallas(rop, rctx, rplan, rc, x),
                 np.asarray(rop.apply(jnp.asarray(x), jax_c, rplan, rctx))):
        scale = max(1.0, float(np.abs(want).max()))
        d = np.abs(got - want)
        assert d.max() <= MAX_TOL.get(name, DEFAULT_MAX_TOL) * scale, \
            (d.max(), scale)
        assert d.mean() <= MEAN_TOL.get(name, DEFAULT_MEAN_TOL) * scale, \
            (d.mean(), scale)


def _atan_args():
    rng = np.random.default_rng(9)
    v = rng.uniform(-3.0, 3.0, (2, 4000)).astype(np.float32)
    special = np.array([[0.0, 0.0, 1.0, -1.0, 0.0, -0.0, np.nan, 1.0, 2.0,
                         -2.0, 1e-30, np.inf],
                        [0.0, 1.0, 0.0, 0.0, -1.0, -1.0, 1.0, np.nan, 2.0,
                         -2.0, 1e-30, 1.0]], np.float32)
    return np.concatenate([v, special], axis=1)


def test_atan_functions_match():
    y, x = _atan_args()
    ay, ax = np.abs(y), np.abs(x)
    for got, want in (
            (pw.atan_pos(torch.from_numpy(ay), torch.from_numpy(ax)),
             ref_pw.atan_pos(jnp.asarray(ay), jnp.asarray(ax))),
            (pw.atan2_full(torch.from_numpy(y), torch.from_numpy(x)),
             ref_pw.atan2_full(jnp.asarray(y), jnp.asarray(x)))):
        got, want = got.numpy(), np.asarray(want)
        assert np.array_equal(np.isnan(got), np.isnan(want))
        ok = ~np.isnan(want)
        # the same Horner steps and fold: an ulp of pi at most
        assert np.abs(got[ok] - want[ok]).max() <= 4e-7
    # all four quadrants against numpy, within the polynomial's 2e-7 rad,
    # away from the guard (max(|x|, |y|) >= 1e-20) and signed zeros
    ok = np.isfinite(y) & np.isfinite(x) & (np.abs(x) > 1e-6) \
        & (np.abs(y) > 1e-6)
    got = pw.atan2_full(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    assert np.abs(got[ok] - np.arctan2(y[ok], x[ok])).max() <= 5e-7


# a pipe whose chains hold both position-reading ops: graduatednd inside
# the first (camera RGB, before colorin), vignette in the last
POS_HISTORY = (("exposure", {"exposure": 0.5}),
               ("graduatednd", dict(configs.HISTORIES[10][9][1])),
               ("vignette", dict(configs.HISTORIES[10][8][1])),
               ("filmicrgb", {}))
# 120 x 240: the vignette's and the ND's gradients cross the frame
PH, PW = 120, 240
WIN = (16, 40, 64, 120)
# the chain's filmic spline and gamut map amplify an ulp of torch's and
# XLA's powers (measured max 3.2e-5 against both JAX forms and under the
# window), as in tests/test_torch_pointwise.py
POS_TOL = 1e-4


@pytest.fixture(scope="session")
def pos_raw():
    return synth_raw(h=PH, w=PW, kind="gradients")


def _pos_pipes(meta, win):
    port = ansel_tpu_torch.Pipeline(
        meta, [ansel_tpu_torch.HistoryItem(o, dict(p))
               for o, p in POS_HISTORY], device="cpu", out_window=win)
    ref = ansel_tpu.Pipeline(
        meta, [ansel_tpu.HistoryItem(o, dict(p)) for o, p in POS_HISTORY],
        out_window=win)
    assert [s.name for s in port.stages] == [s.name for s in ref.stages]
    for p, r in zip(port.stages, ref.stages):
        assert _plain(p.plan.spec_in) == _plain(r.plan.spec_in), p.name
        assert _plain(p.plan.static) == _plain(r.plan.static), p.name
    return port, ref


def _jax_run(pipe, raw, fused, monkeypatch):
    """The JAX side demosaics with its Pallas RCD in interpret mode (what
    the TPU runs; its CPU RCD differs on a ~4 px border)."""
    monkeypatch.setattr(ref_rcd, "rcd_demosaic",
                        lambda x, cfa, s: rcd_pallas.rcd_demosaic_pallas(
                            x, cfa, s, interpret=True))
    monkeypatch.setattr(ref_engine, "_FORCE_FUSION_INTERPRET", fused)
    ref_engine._COMPILE_CACHE.clear()
    try:
        return np.asarray(ref_engine.CompiledPipe(pipe).output_array(raw))
    finally:
        ref_engine._COMPILE_CACHE.clear()


@pytest.mark.parametrize("fused", [False, True], ids=["per-op", "fused"])
def test_position_ops_in_the_chain(pos_raw, fused, monkeypatch):
    raw, meta, _ = pos_raw
    port, ref = _pos_pipes(meta, None)
    compiled = engine.CompiledPipe(port)
    assert compiled.fused_groups() == [[
        "exposure", "graduatednd", "colorin", "filmicrgb", "vignette",
        "colorout"]]
    got = compiled.output_array(raw)
    want = _jax_run(ref, raw, fused, monkeypatch)
    assert got.shape == want.shape == (3, PH, PW)
    assert np.abs(got - want).max() <= POS_TOL


def test_position_ops_under_an_out_window(pos_raw, monkeypatch):
    """Both ops read positions, so they and everything before them plan
    the whole frame; colorout alone plans the window.  The port's chain
    ends at vignette and colorout runs on the window: the whole frame's
    crop, as the JAX package's per-op path gives it.  (The JAX package's
    fused path runs colorout in the same group on the whole frame and
    hands back its top-left corner: ROADMAP R10.)"""
    raw, meta, _ = pos_raw
    port, ref = _pos_pipes(meta, WIN)
    compiled = engine.CompiledPipe(port)
    assert compiled.fused_groups() == [
        ["exposure", "graduatednd", "colorin", "filmicrgb", "vignette"],
        ["colorout"]]
    got = compiled.output_array(raw)
    want = _jax_run(ref, raw, False, monkeypatch)
    y0, x0, h, w = WIN
    assert got.shape == want.shape == (3, h, w)
    assert np.abs(got - want).max() <= POS_TOL
    whole = _jax_run(_pos_pipes(meta, None)[1], raw, False, monkeypatch)
    assert np.abs(got - whole[:, y0:y0 + h, x0:x0 + w]).max() <= POS_TOL
