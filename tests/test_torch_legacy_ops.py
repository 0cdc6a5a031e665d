"""The twelve legacy pointwise ops of the chain kernel (velvia, vibrance,
colorcontrast, colorcorrection, colisa, splittoning, colorize,
colorbalance, splittoningrgb, lowlight, profile_gamma, colorchecker)
against ansel_tpu on the CPU, each at every parameter set of
`configs.LEGACY_CASES` (each set another branch): plan statics and
coefficients equal; the port's chain stage (its plain torch `fn`, what a
CPU chain runs) and its `apply` against the JAX package's
`pointwise_spec.fn` run through `pallas_pointwise(..., interpret=True)`
as the JAX engine fuses it, and against the JAX op's own `apply`, at
(3, 48, 64).  colorchecker with more than 12 patches has no chain stage
in either package (the engine runs it alone), which a pipe pins."""

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
from ansel_tpu.ops import base as ref_base
from ansel_tpu_torch.core.types import Colorspace, ImageSpec
from ansel_tpu_torch.io import configs
from ansel_tpu_torch.kernels import pointwise as pw
from ansel_tpu_torch.ops import base
from ansel_tpu_torch.pipeline import engine

# one intra-op thread: with JAX initialised in the same process, torch's
# first two-thread `sqrt` on the CPU now and then returned the half of a
# (48, 128) plane that the second thread computes off by up to ~2.5e-4
# relative, which a later identical call does not repeat (measured: 3 of
# 32 fresh processes at two threads, 0 of 32 at one)
torch.set_num_threads(1)

# the frame; the arrays are its lane-padded (3, 48, 128), as the engines
# run a stage
H, W = 48, 64
# Both packages run the same float32 operations in the same order; what
# differs is XLA's and torch's pow/exp/log on the CPU (an ulp each) and
# XLA's FMA contraction, and how far each op amplifies that.  Every bound
# scales with the output's largest magnitude (Lab outputs reach 100).
MAX_TOL = 2e-5
MEAN_TOL = 1e-6


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


def _input(kind, shape, seed=11):
    """(3, h, w) float32: work or camera RGB with a little below 0 and up
    to 1.6, or Lab with L in [0, 100] and a, b in [-80, 80]; some
    zeros."""
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


KIND = {name: kind for name, kind, _ in configs.LEGACY_CASES}
SPACE = {"lab": "LAB", "rgb": "WORK_RGB", "camera": "CAMERA_RGB"}


def _planned(pkg_base, pkg_types, op_name, params, meta):
    ImageSpec_, Colorspace_ = pkg_types
    spec = ImageSpec_(width=W, height=H,
                      colorspace=getattr(Colorspace_, SPACE[KIND[op_name]]))
    op = pkg_base.get_op(op_name)
    p = dataclasses.replace(op.default_params(meta), **params)
    ctx = pkg_base.PlanContext(meta=meta)
    plan = op.plan(ctx, spec, p)
    return op, ctx, plan, op.coeffs(ctx, plan, p)


def _pallas(op, ctx, plan, c, x):
    """The JAX op's pointwise spec through pallas_pointwise in interpret
    mode, packed as the JAX engine packs a fused group."""
    spec = op.pointwise_spec(plan, ctx)
    pack = ref_pw.ConstPack()
    vec = pack.pack(c, spec.consts)

    def block_fn(block, consts_ref):
        cd = {}
        for name in spec.consts:
            if name in spec.lists:
                v = pack.get_list(consts_ref, name)
            else:
                v = pack.get(consts_ref, name)
                if name in spec.mats:
                    v = [[v[3 * r + i] for i in range(3)] for r in range(3)]
            cd[name] = v
        return spec.fn(block, cd)

    return np.asarray(ref_pw.pallas_pointwise(
        block_fn, jnp.asarray(x), vec, tile_h=16, tile_w=32,
        interpret=True))


CASES = [(name, i, params) for name, _, sets in configs.LEGACY_CASES
         for i, params in enumerate(sets)]


@pytest.mark.parametrize("name,i,params", CASES,
                         ids=[f"{n}-{i}" for n, i, _ in CASES])
def test_legacy_op_matches_the_jax_package(name, i, params, meta):
    rop, rctx, rplan, rc = _planned(ref_base, (RefImageSpec, RefColorspace),
                                    name, params, meta)
    op, ctx, plan, c = _planned(base, (ImageSpec, Colorspace), name, params,
                                meta)
    assert plan.spec_in.array_shape == (3, H, 128)
    x = _input(KIND[name], plan.spec_in.array_shape)
    assert type(op).__name__ == type(rop).__name__
    assert _plain(plan.static) == _plain(rplan.static)
    assert sorted(c) == sorted(rc)
    for k in c:
        assert np.array_equal(np.asarray(c[k], np.float32),
                              np.asarray(rc[k], np.float32)), k

    dev = engine.coeffs_to_device([c], "cpu")[0]
    got = op.apply(torch.from_numpy(x), dev, plan, ctx).numpy()
    spec, rspec = op.pointwise_spec(plan, ctx), rop.pointwise_spec(rplan, rctx)
    assert (spec is None) == (rspec is None)
    if spec is not None:
        chain = pw.pack_chain([spec], [dev], "cpu")
        # the chain stage and the per-op path give the same numbers
        assert np.array_equal(
            pw.pointwise_chain(torch.from_numpy(x), chain).numpy(), got)
    assert np.isfinite(got).all()
    assert np.abs(got - x).max() > 1e-3      # not an identity
    jax_c = {k: jnp.asarray(np.asarray(v, np.float32)) for k, v in rc.items()}
    wants = [np.asarray(rop.apply(jnp.asarray(x), jax_c, rplan, rctx))]
    if rspec is not None:
        wants.append(_pallas(rop, rctx, rplan, rc, x))
    for want in wants:
        scale = max(1.0, float(np.abs(want).max()))
        d = np.abs(got - want)
        assert d.max() <= MAX_TOL * scale, \
            (d.max(), scale)
        assert d.mean() <= MEAN_TOL * scale, \
            (d.mean(), scale)
