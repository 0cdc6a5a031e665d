"""The port's curve machinery (ansel_tpu_torch/pixel/curves.py) against
ansel_tpu/pixel/curves.py on the CPU, mirroring tests/test_curves.py's
cases: the host node slopes and LUTs equal bit for bit, the per-pixel
evaluations within 1e-6 over the three curve types and the linear
extrapolation on both sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ansel_tpu.pixel import curves as ref
from ansel_tpu_torch.pixel import curves

torch.set_num_threads(2)

# same float32 operations in the same order; XLA's CPU jit may contract a
# product and a sum into one FMA, which moves the last bit or two of a
# value near 1
TOL = 1e-6

TYPES = [ref.CUBIC_SPLINE, ref.CATMULL_ROM, ref.MONOTONE_HERMITE]
NODES = {
    "identity": ([0.0, 1.0], [0.0, 1.0]),
    "s-curve": ([0.0, 0.1, 0.35, 0.7, 1.0], [0.0, 0.07, 0.38, 0.78, 1.0]),
    "flat-step": ([0.0, 0.2, 0.5, 1.0], [0.0, 0.4, 0.45, 1.0]),
    "unsorted": ([0.6, 0.0, 1.0, 0.25], [0.5, 0.0, 1.0, 0.35]),
    "inner": ([0.2, 0.5, 0.8], [0.1, 0.6, 0.7]),
}


@pytest.mark.parametrize("kind", TYPES, ids=["cubic", "catmull", "monotone"])
@pytest.mark.parametrize("name", sorted(NODES))
def test_curve_coeffs_and_lut_equal(name, kind):
    xs, ys = NODES[name]
    for a, b in zip(curves.curve_coeffs(xs, ys, kind),
                    ref.curve_coeffs(xs, ys, kind)):
        assert a.dtype == b.dtype == np.float32
        assert np.array_equal(a, b)
    for lut_max, size in ((1.0, ref.LUT_SIZE), (2.0, 256)):
        assert np.array_equal(
            curves.sample_curve(xs, ys, kind, lut_max=lut_max, size=size),
            ref.sample_curve(xs, ys, kind, lut_max=lut_max, size=size))


def _samples():
    """Points below, inside and above every node range, the nodes
    themselves, and a NaN."""
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.uniform(-0.5, 1.6, 4000),
                        [0.0, 0.1, 0.2, 0.25, 0.35, 0.5, 0.6, 0.7, 0.8, 1.0,
                         np.nan]])
    return x.astype(np.float32).reshape(1, -1)


@pytest.mark.parametrize("kind", TYPES, ids=["cubic", "catmull", "monotone"])
@pytest.mark.parametrize("name", sorted(NODES))
def test_eval_curve_matches(name, kind):
    xs, ys = NODES[name]
    c = ref.curve_coeffs(xs, ys, kind)
    x = _samples()
    want = np.asarray(ref.eval_curve(jnp.asarray(x), *c))
    got = curves.eval_curve(torch.from_numpy(x), *c).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert np.abs(got[ok] - want[ok]).max() <= TOL
    # the device form the ops use: the (3, n) coefficient tensor's rows
    rows = torch.from_numpy(np.asarray(c))
    got_rows = curves.eval_curve(torch.from_numpy(x), *rows).numpy()
    assert np.array_equal(got_rows[ok], got[ok])
    # with the upper slope overridden (tonecurve/rgbcurve's fitted tail)
    want = np.asarray(ref.eval_curve(jnp.asarray(x), *c,
                                     unbounded_slope=0.25))
    got = curves.eval_curve(torch.from_numpy(x), *c,
                            unbounded_slope=0.25).numpy()
    assert np.abs(got[ok] - want[ok]).max() <= TOL


@pytest.mark.parametrize("name", sorted(NODES))
def test_eval_linear_matches(name):
    xs, ys = NODES[name]
    order = np.argsort(xs)
    xs = np.float32(np.asarray(xs)[order])
    ys = np.float32(np.asarray(ys)[order])
    x = _samples()
    want = np.asarray(ref.eval_linear(jnp.asarray(x), xs, ys))
    got = curves.eval_linear(torch.from_numpy(x), xs, ys).numpy()
    ok = ~np.isnan(want)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.abs(got[ok] - want[ok]).max() <= TOL


@pytest.mark.parametrize("kind", TYPES, ids=["cubic", "catmull", "monotone"])
def test_apply_lut_matches(kind):
    xs, ys = NODES["s-curve"]
    lut = ref.sample_curve(xs, ys, kind, lut_max=2.0, size=512)
    x = np.float32(np.random.default_rng(6).uniform(-0.3, 3.0, (8, 300)))
    for slope in (None, 0.5):
        want = np.asarray(ref.apply_lut(jnp.asarray(x), lut, lut_max=2.0,
                                        unbounded_slope=slope))
        got = curves.apply_lut(torch.from_numpy(x), lut, lut_max=2.0,
                               unbounded_slope=slope).numpy()
        assert np.abs(got - want).max() <= TOL


def test_identity_and_extrapolation():
    """tests/test_curves.py's identity and linear-extrapolation cases."""
    lut = curves.sample_curve([0.0, 1.0], [0.0, 1.0], curves.MONOTONE_HERMITE)
    assert np.allclose(lut, np.linspace(0, 1, curves.LUT_SIZE), atol=1e-6)
    lut = curves.sample_curve([0.0, 0.5], [0.0, 0.25], curves.CATMULL_ROM,
                              lut_max=2.0)
    assert abs(lut[-1] - 1.0) < 2e-3
    c = curves.curve_coeffs([0.0, 0.5], [0.0, 0.25], curves.CATMULL_ROM)
    y = curves.eval_curve(torch.tensor([-1.0, 2.0]), *c)
    assert torch.allclose(y, torch.tensor([-0.5, 1.0]))
