"""The port's ops built on the full-size guided filters against ansel_tpu
on the CPU: hazeremoval (camera RGB), tonemap (camera RGB), globaltonemap
(Reinhard, filmic and Drago, with and without the detail layer; Lab) and
colormapping (Lab, its statistics from `acquire_stats` of two scenes).
For each, the plan and the coefficients bit for bit and `apply` on a
small seeded input within the stated tolerance.  Inputs come from numpy
seeds and go to both packages as the same float32 arrays; they are
scenes where the guided filters are well conditioned (config 12's frame,
where hazeremoval's is not, is tests/test_torch_config12.py's)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ansel_tpu.core import types as ref_types
from ansel_tpu.core.params import params_class as ref_params_class
from ansel_tpu.ops import base as ref_base
from ansel_tpu.ops import colormapping as ref_cmap
from ansel_tpu_torch.core import types as port_types
from ansel_tpu_torch.core.params import params_class
from ansel_tpu_torch.io import configs
from ansel_tpu_torch.ops import base as port_base
from ansel_tpu_torch.ops import colormapping as cmap
from ansel_tpu_torch.pipeline.engine import coeffs_to_device

torch.set_num_threads(1)

H, W = 96, 136
# What the two packages round differently (measured maxima): the box
# means' cumulative sums (torch's sequential ones, XLA's scans) in every
# guided filter, XLA's fused products, the Drago logarithms; colormapping
# also its jax.image.resize product order and its 128 curve pieces:
#   hazeremoval 1.1e-6 (camera RGB to ~1.3), tonemap 2.4e-7,
#   globaltonemap 3.1e-5 (Lab L to ~105, an ulp of 100 is 7.6e-6),
#   colormapping 1.1e-4 (Lab)
TOL = {"hazeremoval": 1e-5, "tonemap": 2e-6, "globaltonemap": 1e-4,
       "colormapping": 5e-4}


def _image(kind, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    base = 0.45 + 0.3 * np.sin(xx / 11.0) * np.cos(yy / 15.0) + yy / H * 0.2
    base[H // 4: H // 2, W // 3: W // 2] += 0.3
    base += rng.normal(0.0, 0.02, (H, W))
    if kind == "LAB":
        return np.stack([np.clip(base, 0.0, 1.2) * 80.0,
                         20.0 * np.sin(xx / 23.0) + rng.normal(0, 3, (H, W)),
                         15.0 * np.cos(yy / 19.0) + rng.normal(0, 3, (H, W))]
                        ).astype(np.float32)
    # camera RGB with a veil: no channel near 0 where the haze is
    rgb = np.stack([np.roll(base, s, axis=1) * f + 0.15
                    for s, f in ((2, 0.9), (0, 1.0), (-2, 0.8))])
    return np.clip(rgb, 0.01, None).astype(np.float32)


def colormapping_params(seed=2):
    """The target's statistics from one Lab scene, the source's from
    another."""
    source = (_image("LAB", seed + 1)[:, ::-1] * np.float32(0.9)
              + np.float32([8.0, 5.0, -6.0]).reshape(3, 1, 1))
    return configs.colormapping_params(_image("LAB", seed), source)


CASES = [
    ("hazeremoval", "hazeremoval", "HazeRemoval", {}, "CAMERA_RGB"),
    ("hazeremoval-strong", "hazeremoval", "HazeRemoval",
     {"strength": 0.6, "distance": 0.5}, "CAMERA_RGB"),
    ("tonemap", "tonemap", "Tonemap", {}, "CAMERA_RGB"),
    ("globaltonemap-reinhard", "globaltonemap", "GlobalTonemap",
     {"operator": 0}, "LAB"),
    ("globaltonemap-filmic", "globaltonemap", "GlobalTonemap",
     {"operator": 1, "detail": 0.5}, "LAB"),
    ("globaltonemap-drago", "globaltonemap", "GlobalTonemap", {}, "LAB"),
    ("globaltonemap-drago-detail", "globaltonemap", "GlobalTonemap",
     {"detail": 0.8, "drago_bias": 0.7}, "LAB"),
    ("colormapping", "colormapping", "ColorMapping", "stats", "LAB"),
    ("colormapping-flat", "colormapping", "ColorMapping", "stats-flat",
     "LAB"),
]


def _params(params):
    if params == "stats":
        return colormapping_params()
    if params == "stats-flat":   # no equalisation: no guided filter
        return dict(colormapping_params(4), equalization=0.0)
    return params


def _pair(module, cls, params, kind):
    out = []
    for pkg, types, base, pcls in (
            ("ansel_tpu", ref_types, ref_base, ref_params_class),
            ("ansel_tpu_torch", port_types, port_base, params_class)):
        op = getattr(importlib.import_module(f"{pkg}.ops.{module}"), cls)()
        p = pcls(op.name)(**_params(params))
        ctx = base.PlanContext(meta=types.RawMeta(width=W, height=H))
        spec = types.ImageSpec(width=W, height=H,
                               colorspace=getattr(types.Colorspace, kind),
                               channels=3)
        plan = op.plan(ctx, spec, p)
        out.append((op, ctx, plan, op.coeffs(ctx, plan, p)))
    return out


def _tol(name):
    return TOL[name.split("-")[0]]


@pytest.mark.parametrize("name,module,cls,params,kind", CASES,
                         ids=[c[0] for c in CASES])
def test_plan_and_coeffs_equal_the_jax_package(name, module, cls, params,
                                               kind):
    (_, _, rplan, rco), (_, _, pplan, pco) = _pair(module, cls, params, kind)
    assert pplan.static == rplan.static
    assert pplan.spec_out == pplan.spec_in
    assert (rco is None) == (pco is None)
    if rco is not None:
        assert sorted(rco) == sorted(pco)
        for k in rco:
            assert np.array_equal(np.asarray(pco[k], np.float32),
                                  np.asarray(rco[k], np.float32)), k


@pytest.mark.parametrize("name,module,cls,params,kind", CASES,
                         ids=[c[0] for c in CASES])
def test_apply_matches_the_jax_package(name, module, cls, params, kind):
    (rop, rctx, rplan, rco), (pop, pctx, pplan, pco) = _pair(
        module, cls, params, kind)
    x = _image(kind, seed=len(name))
    want = np.asarray(jax.jit(lambda v: rop.apply(v, rco, rplan, rctx))(
        jnp.asarray(x)))
    c = coeffs_to_device([pco], "cpu")[0]
    got = pop.apply(torch.from_numpy(x), c, pplan, pctx).numpy()
    assert got.shape == want.shape == x.shape
    assert np.isfinite(got).all()
    assert np.abs(got - x).max() > 1e-2           # the op changed something
    assert np.abs(got - want).max() <= _tol(name)


def test_colormapping_acquire_stats_is_the_jax_packages():
    lab = _image("LAB", 6)
    for got, want in zip(cmap.acquire_stats(lab, n=4, seed=3),
                         ref_cmap.acquire_stats(lab, n=4, seed=3)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_colormapping_inactive_passes_through():
    (_, _, rplan, rco), (pop, pctx, pplan, pco) = _pair(
        "colormapping", "ColorMapping", {}, "LAB")
    assert pplan.static == rplan.static and pplan.static[0] is False
    assert pco == rco == {}
    x = torch.from_numpy(_image("LAB", 1))
    assert pop.apply(x, {}, pplan, pctx) is x
