"""The port's colour rings (`color/colorrings.py`, copied numpy) and the
two ops that build their CLUTs from it, colorequal and colorprimaries,
against ansel_tpu on the CPU: the CLUT builders bit for bit (at config
16's params and at a second set, at level 9), the sparse local field
against the scalar mirror `tests/mirrors/colorequal_ref.fill_lut`, and
each op's plan, coefficients and `apply` (the HLG transfer, the
tetrahedral sample, back) with config 16's params.  A 64^3 build takes
~14 s (colorequal) and ~3 s (colorprimaries) on the host, so the ops'
comparisons run both packages at CLUT_LEVEL 9 (each package's builders
wrapped to that level and its module constant set to it, which `apply`
reads); the builders themselves are the same code at every level.  The
port's 64^3 CLUTs are config 16's (tests/test_torch_config16.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ansel_tpu.color import colorrings as ref_rings
from ansel_tpu.core import types as ref_types
from ansel_tpu.core.params import params_class as ref_params_class
from ansel_tpu.ops import base as ref_base
from ansel_tpu.ops import colorequal as ref_colorequal
from ansel_tpu.ops import colorprimaries as ref_colorprimaries
from ansel_tpu_torch.color import colorrings as rings
from ansel_tpu_torch.core import types as port_types
from ansel_tpu_torch.core.params import params_class
from ansel_tpu_torch.io import configs
from ansel_tpu_torch.ops import base as port_base
from ansel_tpu_torch.ops import colorequal, colorprimaries
from ansel_tpu_torch.pipeline.engine import coeffs_to_device
from tests.mirrors import colorequal_ref as mirror

torch.set_num_threads(1)

H, W = 40, 64
# apply: XLA's and torch's log/exp in the HLG transfer (whose inverse
# has a slope of ~5.5 near code 1) and the fused products of the
# tetrahedral weights (measured 2.3e-5 for colorprimaries, 1.7e-6 for
# colorequal, on outputs to ~2)
APPLY_TOL = 1e-4
# the vectorised field against the scalar loop (ansel_tpu's own test
# holds its builder to 1e-5, tests/test_colorequal_mirror.py)
MIRROR_TOL = 1e-5
OPS = {"colorequal": ("Colorequal", ref_colorequal, colorequal,
                      "ColorEqual"),
       "colorprimaries": ("Colorprimaries", ref_colorprimaries,
                          colorprimaries, "ColorPrimaries")}
SECOND = {"colorequal": dict(sigma_L=60.0, sigma_theta=0.6,
                             neutral_protection=0.0),
          "colorprimaries": dict(gamut_coverage=80.0, sigma_rho=0.5,
                                 neutral_protection=0.2)}


def _params16(name, pcls, **extra):
    return pcls(name)(**dict(dict(configs.HISTORIES[16])[name], **extra))


def _fixture_params(name, pcls):
    # trilinear (1): another cache key than config 16's 64^3 CLUT
    return _params16(name, pcls, interpolation=1)


LEVEL = 9


@pytest.fixture(scope="module")
def ops16():
    """Each op planned on both packages with config 16's params, and its
    coefficients, at CLUT_LEVEL 9 (see the module's docstring)."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (rings, ref_rings):
            mp.setattr(mod, "CLUT_LEVEL", LEVEL)
            for fn in ("build_clut", "build_primaries_clut"):
                real = getattr(mod, fn)
                mp.setattr(mod, fn, lambda p, level=None, _real=real:
                           _real(p, level=LEVEL))
        yield _ops16()


def _ops16():
    out = {}
    for name, (_, ref_mod, mod, cls) in OPS.items():
        pair = []
        for types, base, pcls, m in (
                (ref_types, ref_base, ref_params_class, ref_mod),
                (port_types, port_base, params_class, mod)):
            op = getattr(m, cls)()
            p = _fixture_params(name, pcls)
            ctx = base.PlanContext(meta=types.RawMeta(width=W, height=H))
            spec = types.ImageSpec(width=W, height=H,
                                   colorspace=types.Colorspace.WORK_RGB)
            plan = op.plan(ctx, spec, p)
            pair.append((op, ctx, plan, op.coeffs(ctx, plan, p)))
        out[name] = pair
    return out


@pytest.mark.parametrize("name", sorted(OPS))
def test_plan_and_coeffs_equal_the_jax_package(ops16, name):
    """(The port's CLUT cache is keyed by params, not level: the fixture's
    params are config 16's with `interpolation` 1 there, so no 64^3 entry
    is shadowed.)"""
    (_, _, rplan, rco), (_, _, pplan, pco) = ops16[name]
    assert pplan.static == rplan.static and pplan.static is not None
    assert sorted(pco) == sorted(rco) == ["clut", "white"]
    for k in rco:
        assert np.array_equal(np.asarray(pco[k], np.float32),
                              np.asarray(rco[k], np.float32)), k
    assert pco["clut"].shape == (LEVEL ** 3, 3)


@pytest.mark.parametrize("name", sorted(OPS))
def test_apply_matches_the_jax_package(ops16, name):
    (rop, rctx, rplan, rco), (pop, pctx, pplan, pco) = ops16[name]
    rng = np.random.default_rng(len(name))
    x = rng.uniform(0.0, 1.5, (3, H, W)).astype(np.float32)
    x[:, :4] *= 0.01                     # the HLG transfer's square-root leg
    rc = {k: jnp.asarray(np.asarray(v)) for k, v in rco.items()}
    want = np.asarray(jax.jit(lambda v: rop.apply(v, rc, rplan, rctx))(
        jnp.asarray(x)))
    c = coeffs_to_device([pco], "cpu")[0]
    got = pop.apply(torch.from_numpy(x), c, pplan, pctx).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - x).max() > 1e-2       # the edit moved colours
    assert np.abs(got - want).max() <= APPLY_TOL


@pytest.mark.parametrize("name", sorted(OPS))
def test_clut_builders_equal_the_jax_package(name):
    build = {"colorequal": "build_clut",
             "colorprimaries": "build_primaries_clut"}[name]
    for extra in ({}, SECOND[name]):
        got = getattr(rings, build)(_params16(name, params_class, **extra),
                                    level=9)
        want = getattr(ref_rings, build)(
            _params16(name, ref_params_class, **extra), level=9)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_sparse_local_field_matches_the_scalar_mirror():
    rng = np.random.default_rng(0)
    n = 40
    anchors = dict(
        L=rng.uniform(0.0, 1.7, n), rho=rng.uniform(0.0, 0.8, n),
        theta=rng.uniform(-np.pi, np.pi, n),
        delta_L=rng.uniform(-0.2, 0.2, n),
        chroma_scale=rng.uniform(0.5, 1.5, n),
        delta_theta=rng.uniform(-0.5, 0.5, n),
        weight=rng.uniform(0.2, 1.0, n))
    got = rings.fill_lut_sparse_local_field(anchors, 0.35, 0.3, 0.8, 0.1, 9)
    want = mirror.fill_lut([{k: float(v[i]) for k, v in anchors.items()}
                            for i in range(n)], 0.35, 0.3, 0.8, 0.1, 9)
    assert np.abs(got - want).max() <= MIRROR_TOL


@pytest.mark.parametrize("name", sorted(OPS))
def test_neutral_params_pass_through(name):
    _, _, mod, cls = OPS[name]
    op = getattr(mod, cls)()
    ctx = port_base.PlanContext(meta=port_types.RawMeta(width=W, height=H))
    spec = port_types.ImageSpec(width=W, height=H,
                                colorspace=port_types.Colorspace.WORK_RGB)
    p = params_class(name)()
    plan = op.plan(ctx, spec, p)
    assert plan.static is None and op.coeffs(ctx, plan, p) is None
    x = torch.ones((3, H, W))
    assert op.apply(x, None, plan, ctx) is x


def test_clut_cache_builds_once(monkeypatch):
    calls = []
    real = rings.build_primaries_clut

    def spy(p, level=rings.CLUT_LEVEL):
        calls.append(level)
        return real(p, level=9)

    monkeypatch.setattr(rings, "build_primaries_clut", spy)
    p = _params16("colorprimaries", params_class, gamut_coverage=55.0)
    op = colorprimaries.ColorPrimaries()
    ctx = port_base.PlanContext(meta=port_types.RawMeta(width=W, height=H))
    spec = port_types.ImageSpec(width=W, height=H,
                                colorspace=port_types.Colorspace.WORK_RGB)
    plan = op.plan(ctx, spec, p)
    a = op.coeffs(ctx, plan, p)["clut"]
    b = op.coeffs(ctx, plan, p)["clut"]
    assert a is b and calls == [rings.CLUT_LEVEL]
