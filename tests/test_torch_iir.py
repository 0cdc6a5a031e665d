"""The port's Deriche IIR and box means against ansel_tpu on the CPU: the
plain twin against the Pallas kernel in interpret mode (orders 0-2, the
clamp, 1-3 planes, sides that are and are not multiples of 8) and
against the JAX package's CPU path, and the coefficients bit for bit.
Inputs come from numpy seeds and go to both packages as the same float32
arrays."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ansel_tpu.kernels.iir_pallas import gaussian_iir_pallas
from ansel_tpu.pixel import blur as ref_blur
from ansel_tpu_torch.kernels import iir
from ansel_tpu_torch.pixel import blur

torch.set_num_threads(2)

# twin vs Pallas: the same float32 recursions in the same operand order
# (the Pallas interpreter runs XLA's CPU code, which may fuse a product
# into the following add); values are O(1) and the recursion's feedback
# grows an ulp-level difference: measured 2.6e-6 at sigma 20
PALLAS_TOL = 5e-6
# twin vs the JAX CPU path: that path solves the recursion as blocked
# triangular-Toeplitz products (another summation order, and the
# backward start at the true end of the line): measured 3.4e-6
XLA_TOL = 2e-5

CASES = [
    # (shape, sigma, order, vmin, vmax)
    ((40, 64), 3.0, 0, None, None),           # multiples of 8
    ((1, 37, 53), 5.5, 0, None, None),        # not multiples of 8
    ((2, 24, 45), 20.0, 0, None, None),       # sigma near the side
    ((3, 33, 16), 2.0, 1, None, None),
    ((2, 16, 29), 4.0, 2, None, None),
    ((3, 21, 30), 3.0, 0, 0.0, 1.0),          # clamped
    ((2, 19, 27), 2.5, 1, None, 0.8),         # clamped above only
]


def _input(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.2, 1.3, shape).astype(np.float32)
    x[..., : shape[-2] // 3, :] += 0.5   # an edge, so the sides differ
    return x


@pytest.mark.parametrize("shape,sigma,order,vmin,vmax", CASES)
def test_iir_twin_matches_pallas(shape, sigma, order, vmin, vmax):
    x = _input(shape, len(shape) * 100 + shape[-1])
    want = np.asarray(gaussian_iir_pallas(jnp.asarray(x), sigma, order,
                                          vmin, vmax, interpret=True))
    got = blur.gaussian_iir(torch.from_numpy(x), sigma, order, vmin,
                            vmax).numpy()
    assert got.shape == want.shape == x.shape
    assert np.abs(got - want).max() <= PALLAS_TOL


@pytest.mark.parametrize("shape,sigma,order,vmin,vmax", CASES[:5])
def test_iir_twin_matches_jax_cpu_path(shape, sigma, order, vmin, vmax):
    x = _input(shape, shape[-1])
    want = np.asarray(ref_blur.gaussian_iir(jnp.asarray(x), sigma, order,
                                            vmin, vmax))
    got = blur.gaussian_iir(torch.from_numpy(x), sigma, order, vmin,
                            vmax).numpy()
    assert np.abs(got - want).max() <= XLA_TOL


@pytest.mark.parametrize("sigma", [0.7, 3.0, 103.25])
@pytest.mark.parametrize("order", [0, 1, 2])
def test_deriche_coeffs_equal_reference(sigma, order):
    assert blur._deriche_coeffs(sigma, order) == \
        ref_blur._deriche_coeffs(sigma, order)


@pytest.mark.parametrize("radius", [1, 5, 9, 23])
def test_box_blur_matches_reference(radius):
    x = _input((2, 30, 70), radius)
    want = np.asarray(ref_blur.box_blur(jnp.asarray(x), radius))
    got = blur.box_blur(torch.from_numpy(x), radius).numpy()
    # the cumulative sums run in another order (up to 70 values near 1)
    assert np.abs(got - want).max() <= 2e-6


def test_wrapper_runs_the_twin_on_cpu_and_refuses_other_devices():
    x = torch.from_numpy(_input((2, 12, 20), 1))
    coef = blur._deriche_coeffs(3.0)
    before = iir.LAUNCHES
    assert torch.equal(iir.gaussian_iir(x, coef),
                       iir.gaussian_iir_reference(x, coef))
    assert iir.LAUNCHES == before
    assert blur.gaussian_iir(x, 0.0) is x
    with pytest.raises(ValueError):
        iir.gaussian_iir(torch.zeros((2, 8, 8), device="meta"), coef)
