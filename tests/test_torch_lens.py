"""The port's lens op (ansel_tpu_torch/ops/lens.py, its warp in
kernels/warp.py) against ansel_tpu on the CPU: apply against the JAX
package's CPU gather and against its TPU form (the Pallas two-pass warp in
interpret mode), for each distortion model with and without TCA, with
vignetting, and the identity branch; plan, coefficients, the legacy
params ladder and the lensfun database resolution."""

import dataclasses
import functools
import struct
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ansel_tpu.core import params as ref_params
from ansel_tpu.core import types as ref_types
from ansel_tpu.io import lensfun as ref_lensfun
from ansel_tpu.kernels import warp_pallas
from ansel_tpu.ops import base as ref_base
from ansel_tpu.ops import lens as ref_lens
from ansel_tpu_torch.core import params as port_params
from ansel_tpu_torch.core import types as port_types
from ansel_tpu_torch.io import configs
from ansel_tpu_torch.io import lensfun
from ansel_tpu_torch.kernels import warp
from ansel_tpu_torch.ops import base as port_base
from ansel_tpu_torch.ops import lens

torch.set_num_threads(2)

# 96 x 288 pads its columns to 384, as config 4's 6000 pad to 6016
H, W = 96, 288
CONFIG4 = dict(configs.HISTORIES[4])["lens"]
CASES = {
    "config4": CONFIG4,
    "ptlens-no-tca": dict(dist_a=-0.02, dist_b=0.01, dist_c=-0.005,
                          modify_flags=lens.MODIFY_DISTORTION
                          | lens.MODIFY_VIGNETTING),
    "poly3-tca-vig": dict(distortion_model=lens.DIST_POLY3, dist_a=0.03,
                          tca_r=1.0008, tca_b=0.9994, tca_cr=2e-4,
                          tca_bb=-1e-4, vig_k1=-0.3, vig_k2=0.1,
                          vig_k3=-0.02),
    "poly5-scale": dict(distortion_model=lens.DIST_POLY5, dist_a=-0.02,
                        dist_b=0.01, scale=0.98, tca_r=1.0005,
                        tca_b=0.9995),
    # no distortion, TCA or scale: max_disp 1, only the vignetting gain
    "identity-vig": dict(distortion_model=lens.DIST_NONE, tca_r=1.0,
                         tca_b=1.0, vig_k1=-0.25),
}


def _image(seed=0, noise=0.05):
    """A smooth (3, 96, 384) image plus uniform noise: values in [0, 1]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:384]
    img = np.stack([0.5 + 0.4 * np.sin(yy / (9.0 + 3 * i))
                    * np.cos(xx / (13.0 + 5 * i)) for i in range(3)])
    return (img + noise * rng.random(img.shape)).astype(np.float32)


def _spec(types_mod):
    return types_mod.ImageSpec(width=W, height=H,
                               colorspace=types_mod.Colorspace.CAMERA_RGB)


def _both(params):
    """(port plan, port coeffs, ref plan, ref coeffs) for `params`."""
    out = []
    for types_mod, base, mod in ((port_types, port_base, lens),
                                 (ref_types, ref_base, ref_lens)):
        p = dataclasses.replace(mod.LensParams(), **params)
        ctx = base.PlanContext(meta=types_mod.RawMeta(width=W, height=H))
        op = base.get_op("lens")
        plan = op.plan(ctx, _spec(types_mod), p)
        out += [plan, op.coeffs(ctx, plan, p)]
    return out


def _plain(plan):
    spec = dataclasses.astuple(plan.spec_in)
    return plan.static, tuple(getattr(v, "value", v) for v in spec)


def _port_apply(params, x):
    plan, co, _, _ = _both(params)
    c = {k: torch.tensor(v, dtype=torch.float32) for k, v in co.items()}
    ctx = port_base.PlanContext(meta=port_types.RawMeta(width=W, height=H))
    return port_base.get_op("lens").apply(torch.from_numpy(x), c, plan,
                                          ctx).numpy()


def _ref_apply(params, x, tpu_form=False, monkeypatch=None):
    """ansel_tpu's apply, jitted with float32 coefficients as the compiled
    pipe runs it; tpu_form routes it through the Pallas warp in interpret
    mode, as on the TPU."""
    _, _, plan, co = _both(params)
    c = jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.float32), co)
    ctx = ref_base.PlanContext(meta=ref_types.RawMeta(width=W, height=H))
    if tpu_form:
        monkeypatch.setattr(ref_lens, "jax", types.SimpleNamespace(
            default_backend=lambda: "tpu", lax=jax.lax))
        monkeypatch.setattr(warp_pallas, "warp_model", functools.partial(
            warp_pallas.warp_model, interpret=True))
    fn = jax.jit(lambda a, cc: ref_base.get_op("lens").apply(a, cc, plan,
                                                               ctx))
    out = np.asarray(fn(jnp.asarray(x), c))
    if tpu_form:
        monkeypatch.undo()
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_and_coeffs_equal_the_jax_package(case):
    plan, co, ref_plan, ref_co = _both(CASES[case])
    assert _plain(plan) == _plain(ref_plan)
    assert co == ref_co


def test_config4_plans_its_displacement_bound():
    plan, _, _, _ = _both(CONFIG4)
    assert plan.static == (lens.DIST_PTLENS, 11, 3, False)
    big = port_types.ImageSpec(width=6000, height=4000,
                               colorspace=port_types.Colorspace.CAMERA_RGB)
    ctx = port_base.PlanContext(meta=port_types.RawMeta(width=6000,
                                                        height=4000))
    p = dataclasses.replace(lens.LensParams(), **CONFIG4)
    assert lens.Lens().plan(ctx, big, p).static == (lens.DIST_PTLENS, 11, 37,
                                                    False)


# XLA's CPU jit turns the division by the constant rnorm into a product
# with its reciprocal and contracts products into FMAs; the port divides
# and rounds each operation.  A coordinate moves by an ulp at most, which
# moves a sample by a few 1e-6 on this noisy image (measured <= 3.8e-6).
CPU_TOL = 1e-5


@pytest.mark.parametrize("case", sorted(CASES))
def test_apply_matches_the_jax_cpu_gather(case):
    x = _image(seed=len(case))
    got = _port_apply(CASES[case], x)
    want = _ref_apply(CASES[case], x)
    assert got.shape == want.shape == x.shape
    assert np.abs(got - want).max() <= CPU_TOL


# the two-pass Pallas warp against a direct gather on a smooth image: the
# JAX package's own gate (tests/test_warp_pallas.py)
TPU_TOL = 1e-3


@pytest.mark.parametrize("case", ["config4", "poly3-tca-vig",
                                  "identity-vig"])
def test_apply_matches_the_tpu_form(case, monkeypatch):
    x = _image(seed=3, noise=0.0)
    got = _port_apply(CASES[case], x)
    want = _ref_apply(CASES[case], x, tpu_form=True, monkeypatch=monkeypatch)
    assert np.abs(got - want).max() <= TPU_TOL


def test_identity_branch_launches_no_warp(monkeypatch):
    plan, _, _, _ = _both(CASES["identity-vig"])
    assert plan.static[2] <= 1
    monkeypatch.setattr(warp, "lens_warp", None)   # any call would raise
    x = _image()
    got = _port_apply(CASES["identity-vig"], x)
    assert np.abs(got - x).max() > 0      # the vignetting gain still runs
    no_vig = dict(CASES["identity-vig"], vig_k1=0.0)
    assert np.array_equal(_port_apply(no_vig, x), x)


def test_warp_twin_powers_are_products():
    """r**3 and r**2 are products in the twin, as JAX's integer_pow."""
    r = torch.from_numpy(np.random.default_rng(1).uniform(0, 1.5, 4096)
                         .astype(np.float32))
    jr = jnp.asarray(r.numpy())
    assert np.array_equal((r * (r * r)).numpy(), np.asarray(jr ** 3))
    assert np.array_equal((r * r).numpy(), np.asarray(jr ** 2))
    r2 = r * r
    assert np.array_equal((r2 * r2).numpy(), np.asarray(jr ** 4))


@pytest.mark.parametrize("version", [2, 3, 4])
def test_legacy_params_equal_the_jax_package(version):
    name = 52 if version == 2 else 128
    raw = struct.pack(f"<2i5fi{name}s{name}si2f", 11, 0, 1.0, 1.5, 35.0, 4.0,
                      3.0, 1, b"Canon EOS 40D", b"Canon EF 24-105mm",
                      0, 0.9995, 1.0005)
    if version == 4:
        raw += struct.pack("<i", 0)
    got = port_params.decode_blob("lens", version, raw)
    want = ref_params.decode_blob("lens", version, raw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.tca_r, got.tca_b) == (want.tca_r, want.tca_b)


def test_database_identity_resolves_like_the_jax_package():
    ident = dict(camera="Canon EOS 40D",
                 lens="Canon EF 100mm f/2.8L Macro IS USM", focal=100.0,
                 aperture=8.0, distance=3.32)
    got = lensfun.resolve(**ident)
    assert got.found_lens and got.have_distortion and got.have_vignetting
    assert dataclasses.asdict(got) == dataclasses.asdict(
        ref_lensfun.resolve(**ident))
    plan, co, ref_plan, ref_co = _both(ident)
    assert plan.static[3] is True          # lensfun's short-side radius
    assert _plain(plan) == _plain(ref_plan)
    assert co == ref_co
