"""The port's bilateral-grid and blur-family ops against ansel_tpu on the
CPU: bilat mode 0, bilateral, shadhi and lowpass (both algorithms),
sharpen, highpass, monochrome, colorreconstruct and soften.  For each,
the plan and the coefficients bit for bit and `apply` on a small Lab or
RGB image within a stated tolerance; then the legacy ladders of shadhi
(v1-v4) and lowpass (v1-v3).  Inputs come from numpy seeds and go to
both packages as the same float32 arrays."""

import importlib
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ansel_tpu.core import types as ref_types
from ansel_tpu.core.params import params_class as ref_params_class
from ansel_tpu.ops import base as ref_base
from ansel_tpu_torch.core import types as port_types
from ansel_tpu_torch.core.params import params_class
from ansel_tpu_torch.ops import base as port_base
from ansel_tpu_torch.pipeline.engine import coeffs_to_device

torch.set_num_threads(2)

H, W = 48, 72

# (id, module, op class, params, input colorspace), each with the error
# measured against the JAX package.  The tolerances are on the ops' own
# scale (Lab L in [0, 100] and a/b about +-40, whose ulp is 7.6e-6 near
# 100; RGB in [0, 1]) and cover what the two packages round differently:
# the grid's splat sums in another order (bf16 operands, float32 sums),
# the IIR and box means run as eager recursions and cumulative sums where
# the JAX package runs blocked products, and XLA's CPU jit fuses products
# into sums.
LAB_TOL, RGB_TOL = 1e-3, 1e-6
# shadhi's chroma correction divides by max(|1 - L|, 1e-6) (L in [0, 1]),
# so an ulp of its blurred L grows by up to 1e4 where L nears white: with
# the grid's splat summed in another order, measured 4.1e-3 on a/b at an
# L of 99.99 (seed 16).  The Gaussian algorithm stays within LAB_TOL.
SHADHI_GRID_TOL = 1e-2
CASES = [
    ("bilat-grid", "bilat", "Bilat",                         # 2.3e-5
     dict(mode=0, sigma_r=20.0, sigma_s=50.0, detail=0.25), "LAB"),
    ("bilat-grid-fine", "bilat", "Bilat",                    # 7.6e-6
     dict(mode=0, sigma_r=8.0, sigma_s=6.0, detail=-0.4), "LAB"),
    ("bilateral", "bilateral", "Bilateral", {}, "CAMERA_RGB"),   # 1.2e-7
    ("shadhi-gaussian", "shadhi", "ShadowsHighlights", {}, "LAB"),  # 5.3e-5
    ("shadhi-bilateral", "shadhi", "ShadowsHighlights",      # 4.1e-3
     dict(radius=30.0, shadows=90.0, highlights=-80.0, compress=20.0,
          whitepoint=10.0, shadhi_algo=1), "LAB"),
    ("lowpass-gaussian", "lowpass", "Lowpass", {}, "LAB"),   # 1.8e-4
    ("lowpass-bilateral", "lowpass", "Lowpass",              # 1.5e-5
     dict(lowpass_algo=1, contrast=-0.5, brightness=0.3, saturation=0.5,
          unbound=0), "LAB"),
    ("sharpen", "sharpen", "Sharpen", {}, "LAB"),            # 0
    ("sharpen-wide", "sharpen", "Sharpen",                   # 5.3e-5
     dict(radius=12.0, amount=1.2, threshold=0.1), "LAB"),
    ("highpass", "highpass", "Highpass", {}, "LAB"),         # 4.6e-5
    ("highpass-small", "highpass", "Highpass",               # 0
     dict(sharpness=1.0, contrast=80.0), "LAB"),
    ("monochrome", "monochrome", "Monochrome",               # 3.1e-5
     dict(a=10.0, b=-20.0, size=0.5, highlights=0.3), "LAB"),
    ("colorreconstruct", "colorreconstruct", "ColorReconstruct",  # 1.3e-4
     dict(threshold=55.0, spatial=100.0, precedence=2, hue=0.3), "LAB"),
    ("soften", "soften", "Soften", {}, "WORK_RGB"),          # 0
]
# bilat mode 0's apply is held by tests/test_torch_bilat.py and, in the
# pipe, tests/test_torch_config7.py
APPLY_CASES = [c for c in CASES if c[1] != "bilat"]


def _image(colorspace, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    base = 0.5 + 0.3 * np.sin(xx / 7.0) * np.cos(yy / 11.0)
    base[H // 3: H // 2, W // 4: W // 2] += 0.35            # an edge
    base += rng.normal(0.0, 0.03, (H, W))
    if colorspace == "LAB":
        L = np.clip(base, 0.0, 1.0) * 100.0
        L[: H // 5, -W // 4:] = 97.0                         # near white
        return np.stack([L, rng.uniform(-40, 40, (H, W)),
                         rng.uniform(-40, 40, (H, W))]).astype(np.float32)
    rgb = np.stack([base * s for s in (0.9, 1.0, 0.7)])
    return np.clip(rgb + rng.normal(0.0, 0.02, rgb.shape), 0.0, 1.2) \
        .astype(np.float32)


def _pair(module, cls, params, colorspace):
    out = []
    for pkg, types, base, pcls in (
            ("ansel_tpu", ref_types, ref_base, ref_params_class),
            ("ansel_tpu_torch", port_types, port_base, params_class)):
        op = getattr(importlib.import_module(f"{pkg}.ops.{module}"), cls)()
        p = pcls(op.name)(**params)
        ctx = base.PlanContext(meta=types.RawMeta(width=W, height=H))
        spec = types.ImageSpec(width=W, height=H,
                               colorspace=getattr(types.Colorspace,
                                                  colorspace))
        plan = op.plan(ctx, spec, p)
        out.append((op, ctx, plan, op.coeffs(ctx, plan, p)))
    return out


@pytest.mark.parametrize("name,module,cls,params,colorspace", CASES,
                         ids=[c[0] for c in CASES])
def test_plan_and_coeffs_equal_the_jax_package(name, module, cls, params,
                                               colorspace):
    (_, _, rplan, rco), (_, _, pplan, pco) = _pair(module, cls, params,
                                                   colorspace)
    assert pplan.static == rplan.static
    assert pplan.spec_out == pplan.spec_in
    assert (rco is None) == (pco is None)
    if rco is not None:
        assert sorted(rco) == sorted(pco)
        for k in rco:
            assert np.array_equal(np.asarray(pco[k]), np.asarray(rco[k])), k


@pytest.mark.parametrize("name,module,cls,params,colorspace",
                         APPLY_CASES, ids=[c[0] for c in APPLY_CASES])
def test_apply_matches_the_jax_package(name, module, cls, params,
                                       colorspace):
    (rop, rctx, rplan, rco), (pop, pctx, pplan, pco) = _pair(
        module, cls, params, colorspace)
    x = _image(colorspace, seed=len(name))
    want = np.asarray(rop.apply(jnp.asarray(x), rco, rplan, rctx))
    c = coeffs_to_device([pco], "cpu")[0]
    got = pop.apply(torch.from_numpy(x), c, pplan, pctx).numpy()
    assert got.shape == want.shape == x.shape
    assert np.isfinite(got).all()
    assert np.abs(got - x).max() > 1e-3           # the op changed something
    tol = (SHADHI_GRID_TOL if name == "shadhi-bilateral" else
           LAB_TOL if colorspace == "LAB" else RGB_TOL)
    assert np.abs(got - want).max() <= tol


def _fields(p):
    return {k: getattr(p, k) for k in vars(p)}


@pytest.mark.parametrize("version,raw", [
    (1, struct.pack("<i6f", 0, 50.0, 40.0, 5.0, 30.0, 0.0, 60.0)),
    (1, struct.pack("<i6f", 1, -80.0, 40.0, 5.0, 30.0, 0.0, 60.0)),
    (2, struct.pack("<i8f", 0, 60.0, 30.0, 2.0, -40.0, 0.0, 50.0, 90.0,
                    40.0)),
    (3, struct.pack("<i8fI", 0, -60.0, 30.0, 2.0, -40.0, 0.0, 50.0, 90.0,
                    40.0, 1)),
    (4, struct.pack("<i8fIf", 0, 70.0, 30.0, 2.0, -40.0, 0.0, 50.0, 90.0,
                    40.0, 0, 0.02)),
], ids=["v1", "v1-bilateral", "v2", "v3-bilateral", "v4"])
def test_shadhi_legacy_params_decode_like_reference(version, raw):
    from ansel_tpu.ops import shadhi as ref_shadhi
    from ansel_tpu_torch.ops import shadhi

    want = ref_shadhi.ShadHiParams.from_legacy(version, raw)
    got = shadhi.ShadHiParams.from_legacy(version, raw)
    assert _fields(got) == _fields(want)
    assert got.shadhi_algo == (1 if struct.unpack("<if", raw[:8])[1] < 0
                               else 0)


@pytest.mark.parametrize("version,raw", [
    (1, struct.pack("<i3f", 0, 12.0, 1.5, 0.8)),
    (2, struct.pack("<i4f", 0, -12.0, 1.5, 0.2, 0.8)),
    (3, struct.pack("<i4fi", 1, 20.0, -0.5, 0.2, 1.1, 1)),
], ids=["v1", "v2-bilateral", "v3"])
def test_lowpass_legacy_params_decode_like_reference(version, raw):
    from ansel_tpu.ops import lowpass as ref_lowpass
    from ansel_tpu_torch.ops import lowpass

    want = ref_lowpass.LowpassParams.from_legacy(version, raw)
    got = lowpass.LowpassParams.from_legacy(version, raw)
    assert _fields(got) == _fields(want)


def test_grid_ops_are_registered_with_the_reference_versions():
    from ansel_tpu.ops.base import all_ops as ref_all_ops
    from ansel_tpu_torch.ops.base import all_ops

    names = ("bilateral", "shadhi", "lowpass", "sharpen", "highpass",
             "monochrome", "colorreconstruct", "soften")
    ref = ref_all_ops()
    port = all_ops()
    for n in names:
        assert n in port, n
        assert type(port[n]).__name__ == type(ref[n]).__name__
