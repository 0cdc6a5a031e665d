"""The port's toneequal against ansel_tpu on the CPU: every estimator and
every detail filter against the JAX op, the guided surfaces with the
TPU's Pallas IIR and with the JAX CPU IIR, the scalar mirror of
luminance_mask.h and toneequal.c, the quantization path, and plan,
coefficients and legacy params bit for bit.  Inputs come from numpy
seeds and go to both packages as the same float32 arrays."""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ansel_tpu.core import types as ref_types
from ansel_tpu.kernels.iir_pallas import gaussian_iir_pallas
from ansel_tpu.ops import base as ref_base
from ansel_tpu.ops import toneequal as ref_te
from ansel_tpu.pixel import blur as ref_blur
from ansel_tpu.pixel import guided as ref_guided
from ansel_tpu_torch.core import types as port_types
from ansel_tpu_torch.ops import base as port_base
from ansel_tpu_torch.ops import toneequal as port_te
from ansel_tpu_torch.pipeline import engine
from ansel_tpu_torch.pixel import guided
from tests.mirrors.toneequal_ref import toneequal_ref

torch.set_num_threads(2)

# Tolerances are relative to the largest output value.
# No mask filter: the same float32 operations but for the estimators'
# channel sums and the 8-band sum (the JAX package reduces over an axis,
# the port adds in order) and jnp.cbrt, which the port writes as a 1/3
# power, then exp and log2 of the two libraries an ulp apart: measured
# 1.4e-6 on outputs up to 2.9 (4.9e-7 relative).
NONE_TOL = 2e-6
# A mask filter with the Pallas IIR on the JAX side: the same recursions
# (the twin is held to the Pallas kernel within 5e-6,
# tests/test_torch_iir.py), then log2 and the Gaussian bands.
PALLAS_TOL = 1e-5
# Against the JAX CPU op, whose IIR is the XLA blocked form (another
# summation order): measured 1.4e-6 on outputs up to 2.9.
XLA_TOL = 1e-5
# the scalar float64 mirror, as ansel_tpu's own test holds its op
# (tests/test_heavy_ops.py:183); absolute, outputs below 4.8
MIRROR_TOL = 2e-5

H, W = 48, 80


def _image(seed=5, h=H, w=W):
    rng = np.random.default_rng(seed)
    x = np.exp2(rng.uniform(-9.0, 0.5, (3, h, w))).astype(np.float32)
    x[:, h // 4: h // 2, w // 3: w // 2] *= 4.0    # an edge for the mask
    return x


def _pair(params, h=H, w=W):
    out = []
    for types, base, mod in ((ref_types, ref_base, ref_te),
                             (port_types, port_base, port_te)):
        ctx = base.PlanContext(meta=types.RawMeta(width=w, height=h))
        spec = types.ImageSpec(width=w, height=h,
                               colorspace=types.Colorspace.CAMERA_RGB)
        op, p = mod.ToneEqualizer(), mod.ToneEqualParams(**params)
        plan = op.plan(ctx, spec, p)
        out.append((op, ctx, plan, op.coeffs(ctx, plan, p)))
    return out


def _apply_both(params, x):
    (rop, rctx, rplan, rc), (pop, pctx, pplan, pc) = _pair(params,
                                                           *x.shape[1:])
    want = np.asarray(rop.apply(jnp.asarray(x), rc, rplan, rctx))
    c = engine.coeffs_to_device([pc], "cpu")[0]
    got = pop.apply(torch.from_numpy(x), c, pplan, pctx).numpy()
    return got, want


SLIDERS = dict(shadows=0.5, blacks=0.8, highlights=-0.6, speculars=-1.0)


@pytest.mark.parametrize("method", range(7))
def test_every_estimator_matches_jax_op(method):
    x = _image()
    x[0, :4, :4] = -0.01   # negative values through |RGB| and the clamps
    params = dict(SLIDERS, method=method, details=port_te.TEQ_NONE,
                  exposure_boost=0.5)
    got, want = _apply_both(params, x)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= NONE_TOL * np.abs(want).max()


@pytest.mark.parametrize("details", [1, 2, 3, 4])
@pytest.mark.parametrize("iterations", [1, 2])
def test_every_filter_matches_jax_op_with_pallas_iir(details, iterations,
                                                     monkeypatch):
    def pallas_iir(x, sigma, order=0, vmin=None, vmax=None):
        return gaussian_iir_pallas(x, sigma, order, vmin, vmax,
                                   interpret=True)

    monkeypatch.setattr(ref_blur, "gaussian_iir", pallas_iir)
    params = dict(SLIDERS, details=details, iterations=iterations,
                  contrast_boost=0.3, feathering=2.0, blending=10.0)
    got, want = _apply_both(params, _image(details))
    assert np.abs(got - want).max() <= PALLAS_TOL * np.abs(want).max()


@pytest.mark.parametrize("details", [3, 4])
def test_eigf_filters_match_jax_cpu_op(details):
    params = dict(SLIDERS, details=details, blending=10.0)
    got, want = _apply_both(params, _image(details + 10))
    assert np.abs(got - want).max() <= XLA_TOL * np.abs(want).max()


def test_quantized_mask_matches_jax_op():
    params = dict(SLIDERS, quantization=0.25, details=port_te.TEQ_EIGF)
    got, want = _apply_both(params, _image(3))
    assert np.abs(got - want).max() <= XLA_TOL * np.abs(want).max()


@pytest.mark.parametrize("method", range(7))
def test_no_filter_matches_reference_mirror(method):
    rng = np.random.default_rng(5)
    img = rng.uniform(0.001, 1.2, (3, 12, 16)).astype(np.float32)
    params = dict(shadows=1.0, highlights=-0.5, method=method,
                  details=port_te.TEQ_NONE, exposure_boost=0.3)
    (_, _, _, _), (op, ctx, plan, pc) = _pair(params, 12, 16)
    c = engine.coeffs_to_device([pc], "cpu")[0]
    got = op.apply(torch.from_numpy(img), c, plan, ctx).numpy()
    p = port_te.ToneEqualParams(**params)
    want = toneequal_ref(img.astype(np.float64), method,
                         2.0 ** p.exposure_boost, 0.0, 1.0,
                         port_te.solve_factors(p), p.smoothing)
    assert np.abs(got - want).max() <= MIRROR_TOL


@pytest.mark.parametrize("params", [
    {}, SLIDERS, dict(SLIDERS, smoothing=0.5, feathering=4.0, blending=2.0,
                      quantization=0.1, exposure_boost=-1.0,
                      contrast_boost=1.0, iterations=30)])
def test_plan_and_coeffs_equal_reference(params):
    (_, _, rplan, rc), (_, _, pplan, pc) = _pair(params, 5504, 8256)
    assert pplan.static == rplan.static
    assert sorted(pc) == sorted(rc)
    for k in pc:
        assert np.array_equal(np.asarray(pc[k]), np.asarray(rc[k])), k


def test_legacy_v1_decodes_like_reference():
    raw = struct.pack("<13f3i", *[0.1 * i for i in range(13)], 2, 3, 4)
    ref = ref_te.ToneEqualParams.from_legacy(1, raw)
    got = port_te.ToneEqualParams.from_legacy(1, raw)
    assert [getattr(got, f) for f in vars(ref)] == list(vars(ref).values())


@pytest.mark.parametrize("src,dst", [((40, 64), (10, 16)),
                                     ((10, 16), (40, 64)),
                                     ((37, 50), (9, 12)),
                                     ((9, 12), (37, 50))])
def test_interp_node_matches_reference(src, dst):
    x = np.random.default_rng(1).random((2,) + src).astype(np.float32)
    want = np.asarray(ref_guided._interp_node(jnp.asarray(x), *dst))
    got = guided._interp_node(torch.from_numpy(x), *dst).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6
