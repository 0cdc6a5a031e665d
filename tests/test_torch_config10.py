"""The port's config 10 (the default pipe plus a graded look: colour
balance rgb, an RGB curve, a tone curve, colour zones, the contrast
equaliser, a vignette and a graduated ND; the port's own history in
ansel_tpu_torch/io/configs.py) against ansel_tpu on the CPU: atrous and
zonesystem op by op (atrous's scales through the EAW kernel's twin
against the JAX package's atrous Pallas kernel in interpret mode), the
plan, statics and coefficients, every new stage changing its input, the
kernel wrappers the pipe calls, and the whole pipe against
`ansel_tpu.compile_pipeline(...).output_array` with its fused chains in
interpret mode and without.  The raw comes from synth_raw and goes to
both packages."""

import dataclasses
import enum

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ansel_tpu
import ansel_tpu_torch
from ansel_tpu.io.synthetic import synth_raw
from ansel_tpu.kernels import rcd as ref_rcd
from ansel_tpu.kernels import rcd_pallas
from ansel_tpu.kernels.eaw_pallas import eaw_atrous_coarse_pallas
from ansel_tpu.ops import atrous as ref_atrous
from ansel_tpu.ops import base as ref_base
from ansel_tpu.pipeline import engine as ref_engine
from ansel_tpu_torch import interop
from ansel_tpu_torch.core.types import Colorspace, ImageSpec
from ansel_tpu_torch.io import configs
from ansel_tpu_torch.kernels import eaw, pointwise, rcd
from ansel_tpu_torch.ops import base

torch.set_num_threads(2)

STAGES = ["rawprepare", "temperature", "highlights", "demosaic", "exposure",
          "graduatednd", "colorin", "channelmixerrgb", "_convert", "atrous",
          "_convert", "colorbalancergb", "rgbcurve", "filmicrgb", "_convert",
          "tonecurve", "colorzones", "_convert", "vignette", "colorout"]
NEW = ("graduatednd", "atrous", "colorbalancergb", "rgbcurve", "tonecurve",
       "colorzones", "vignette")
# 96 x 160 (padded to 96 x 256): atrous plans 4 scales (log2(96) - 2)
H, W = 96, 160
DISPLAY_QUANTUM = 1.0 / 255.0
# the JAX package's CPU RCD differs from its Pallas RCD (which the port's
# twin repeats) on a ~4 px border (ROADMAP R3); atrous's four scales carry
# that 2 (2^4 - 1) = 30 px inward: measured max 0.39 on the whole frame,
# 3.6e-3 without a 4 px ring, 9.5e-4 without 16 px
RING = 16
# against the JAX Pallas RCD: the whole frame, measured max 5.4e-5
# (per-op and fused), mean 5.5e-7
MEAN_TOL = 1e-5
# atrous: the EAW twin repeats the Pallas kernel's float32 operations;
# the synthesis adds a boost times a soft threshold per scale (measured
# max 3.1e-5, an ulp or two of Lab values up to 100)
ATROUS_TOL = 1e-4
# zonesystem: the same float32 operations (measured equal); an ulp of
# Lab values up to 100 is 7.6e-6
ZONE_TOL = 2e-5


def _hist(pkg):
    return configs.history(10, pkg.HistoryItem)


def _plain(v):
    if isinstance(v, enum.Enum):
        return v.value
    if dataclasses.is_dataclass(v):
        return tuple(_plain(getattr(v, f.name)) for f in dataclasses.fields(v))
    if isinstance(v, (tuple, list)):
        return tuple(_plain(x) for x in v)
    return v


@pytest.fixture(scope="module")
def slice10():
    raw, meta, _ = synth_raw(h=H, w=W, kind="gradients")
    port = ansel_tpu_torch.compile_pipeline(meta, _hist(ansel_tpu_torch),
                                            device="cpu")
    before = (eaw.LAUNCHES, pointwise.LAUNCHES)
    got = port.output_array(raw)
    assert (eaw.LAUNCHES, pointwise.LAUNCHES) == before  # twins on the CPU
    return port, got, raw, meta


def _lab_input(seed=4, shape=(3, 64, 128)):
    """Lab with edges: smooth L with a bright block, a and b in +-60."""
    rng = np.random.default_rng(seed)
    _, h, w = shape
    yy, xx = np.mgrid[0:h, 0:w]
    L = 30.0 + 40.0 * xx / w + 5.0 * rng.standard_normal((h, w))
    L[16:40, 30:80] += 25.0
    x = np.stack([np.clip(L, 0.0, 100.0),
                  60.0 * np.sin(yy / 7.0) + 3.0 * rng.standard_normal((h, w)),
                  40.0 * np.cos(xx / 11.0)])
    return x.astype(np.float32)


def _planned(pkg_base, types, name, params, meta, shape):
    ImageSpec_, Colorspace_ = types
    op = pkg_base.get_op(name)
    p = dataclasses.replace(op.default_params(meta), **params)
    ctx = pkg_base.PlanContext(meta=meta)
    spec = ImageSpec_(width=shape[2], height=shape[1],
                      colorspace=Colorspace_.LAB)
    plan = op.plan(ctx, spec, p)
    return op, ctx, plan, op.coeffs(ctx, plan, p)


def _ref_types():
    from ansel_tpu.core.types import Colorspace as C
    from ansel_tpu.core.types import ImageSpec as I

    return I, C


def test_atrous_matches_the_jax_pallas_kernel(monkeypatch):
    """Config 10's atrous at a frame that plans 4 scales, each scale of the
    JAX op on its atrous Pallas kernel in interpret mode (what the TPU
    runs), the port's on the EAW twin."""
    params = dict(configs.HISTORIES[10][7][1])
    meta = synth_raw(h=32, w=48)[1]
    x = _lab_input()
    rop, rctx, rplan, rc = _planned(ref_base, _ref_types(), "atrous", params,
                                    meta, x.shape)
    op, ctx, plan, c = _planned(base, (ImageSpec, Colorspace), "atrous",
                                params, meta, x.shape)
    assert type(op).__name__ == type(rop).__name__
    assert plan.static == rplan.static == 4
    assert plan.aux == tuple(float(v) for v in np.float32(c["sharp"]))
    assert sorted(c) == sorted(rc)
    for k in c:
        assert np.array_equal(c[k], rc[k]), k
    calls = []
    monkeypatch.setattr(
        ref_atrous, "eaw_decompose_scale",
        lambda v, s, sharpen: calls.append(s) or eaw_atrous_coarse_pallas(
            v, s, sharpen, interpret=True))
    want = np.asarray(rop.apply(jnp.asarray(x), rc, rplan, rctx))
    assert calls == [0, 1, 2, 3]
    seen = []
    real = eaw.eaw_atrous_coarse
    monkeypatch.setattr(eaw, "eaw_atrous_coarse",
                        lambda v, s, k: seen.append((s, k)) or real(v, s, k))
    dev = interop.coeffs_from_reference([rc], "cpu")[0]
    got = op.apply(torch.from_numpy(x), dev, plan, ctx).numpy()
    assert seen == list(enumerate(plan.aux))
    assert np.abs(got - x).max() > 1e-3
    assert np.abs(got - want).max() <= ATROUS_TOL


def test_zonesystem_matches():
    meta = synth_raw(h=32, w=48)[1]
    x = _lab_input(shape=(3, 48, 128))
    zones = (0.0, 0.08, 0.2, 0.33, 0.45, 0.55, 0.66, 0.8, 0.9, 1.0)
    for params in ({"size": 10, "zone": zones + (-1.0,) * 15},
                   {"size": 6, "zone": (-1.0, 0.15, -1.0, 0.5, 0.7)
                    + (-1.0,) * 20}):
        rop, rctx, rplan, rc = _planned(ref_base, _ref_types(), "zonesystem",
                                        params, meta, x.shape)
        op, ctx, plan, c = _planned(base, (ImageSpec, Colorspace),
                                    "zonesystem", params, meta, x.shape)
        assert type(op).__name__ == type(rop).__name__
        assert plan.static == rplan.static
        for k in c:
            assert np.array_equal(c[k], rc[k]), k
        want = np.asarray(rop.apply(jnp.asarray(x), rc, rplan, rctx))
        dev = interop.coeffs_from_reference([rc], "cpu")[0]
        got = op.apply(torch.from_numpy(x), dev, plan, ctx).numpy()
        assert np.abs(got - x).max() > 1e-3
        assert np.abs(got - want).max() <= ZONE_TOL


def test_config10_plan_and_coeffs_equal_reference(slice10):
    port, _, _, meta = slice10
    ref = ansel_tpu.Pipeline(meta, _hist(ansel_tpu))
    assert [s.name for s in port.pipe.stages] == STAGES
    assert [s.name for s in ref.stages] == STAGES
    for p, r in zip(port.pipe.stages, ref.stages):
        assert _plain(p.plan.spec_in) == _plain(r.plan.spec_in), p.name
        assert _plain(p.plan.static) == _plain(r.plan.static), p.name
    for p, r in zip(port.pipe.coeffs(), ref.coeffs()):
        assert sorted(p or {}) == sorted(r or {})
        for k in p or {}:
            assert np.array_equal(np.asarray(p[k], np.float32),
                                  np.asarray(r[k], np.float32)), k


def test_config10_chains_and_new_stages(slice10):
    port, _, raw, _ = slice10
    assert port.fused_groups() == [STAGES[4:9], STAGES[10:]]
    assert [k for k, *_ in port.steps] == ["stage"] * 4 + [
        "chain", "stage", "chain"]
    assert [a.fixed for k, _, _, a in port.steps if k == "chain"] == [
        pointwise.FIXED.index(p) for p in pointwise.FIXED[-2:]]
    # every new stage changes its input by more than 1e-3 somewhere
    pipe = port.pipe
    x = torch.from_numpy(base.pad_to(raw, pipe.spec_in))
    for i, s in enumerate(pipe.stages):
        y = pipe.trace_fn(i, i + 1)(x, port.coeffs[i:i + 1])
        if s.name in NEW:
            assert (y - x).abs().max().item() > 1e-3, s.name
        x = y


def test_config10_calls_each_kernel_wrapper(monkeypatch):
    """One RCD, the two chains, one atrous EAW scale per planned scale
    (four at 96 x 160), in that order."""
    raw, meta, _ = synth_raw(h=H, w=W, kind="gradients")
    calls = []
    for mod, name in ((rcd, "rcd_demosaic"), (eaw, "eaw_atrous_coarse"),
                      (pointwise, "pointwise_chain")):
        real = getattr(mod, name)

        def spy(*args, _real=real, _name=name):
            calls.append(_name if _name != "eaw_atrous_coarse"
                         else (_name, args[1]))
            return _real(*args)

        monkeypatch.setattr(mod, name, spy)
    ansel_tpu_torch.compile_pipeline(meta, _hist(ansel_tpu_torch),
                                     device="cpu").output_array(raw)
    assert calls == ["rcd_demosaic", "pointwise_chain"] + [
        ("eaw_atrous_coarse", s) for s in range(4)] + ["pointwise_chain"]


@pytest.mark.parametrize("pallas_rcd,fused", [(False, False), (True, True)],
                         ids=["cpu-rcd-per-op", "pallas-rcd-fused"])
def test_config10_matches_the_jax_package(slice10, pallas_rcd, fused,
                                          monkeypatch):
    _, got, raw, meta = slice10
    if pallas_rcd:
        monkeypatch.setattr(ref_rcd, "rcd_demosaic",
                            lambda x, cfa, s: rcd_pallas.rcd_demosaic_pallas(
                                x, cfa, s, interpret=True))
    monkeypatch.setattr(ref_engine, "_FORCE_FUSION_INTERPRET", fused)
    ref_engine._COMPILE_CACHE.clear()
    try:
        want = np.asarray(ansel_tpu.compile_pipeline(meta, _hist(ansel_tpu))
                          .output_array(raw))
    finally:
        ref_engine._COMPILE_CACHE.clear()
    assert got.shape == want.shape == (3, H, W)
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0
    r = 0 if pallas_rcd else RING
    d = np.abs(got - want)[:, r:H - r, r:W - r]
    assert d.max() <= DISPLAY_QUANTUM and d.mean() <= MEAN_TOL
