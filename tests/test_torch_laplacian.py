"""The port's highlight reconstruction path against ansel_tpu: the sepblur
twin against the Pallas kernel in interpret mode (full frame), the
bilinear resize against `jax.image.resize`, `laplacian_reconstruct`
against the JAX package's, and the highlights op's LAPLACIAN mode.
Inputs come from numpy seeds and go to both packages as the same float32
arrays."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ansel_tpu.core.types import CFAPattern as RefCFA
from ansel_tpu.kernels import highlights_laplacian as ref_hl
from ansel_tpu.kernels.sepblur_pallas import sep_blur_pallas
from ansel_tpu_torch.core.types import CFAPattern
from ansel_tpu_torch.kernels import highlights_laplacian as hl
from ansel_tpu_torch.kernels import sepblur
from ansel_tpu_torch.ops import _bayer
from ansel_tpu_torch.pixel import shifts
from ansel_tpu_torch.pixel.resample import resize_bilinear

torch.set_num_threads(2)

B3 = (1 / 16, 4 / 16, 6 / 16, 4 / 16, 1 / 16)
# The twin and the Pallas kernel do the same float32 products and sums in
# tap order; XLA's CPU code may fuse a product into the following sum, a
# few ulps at most (measured 1.2e-7 on values below 1).
SEP_TOL = 1e-6
# Both build the same float32 weight matrices; the column sums and the
# products run in another order (measured 1.2e-7 on values below 1).
RESIZE_TOL = 1e-6
# The whole reconstruction: 30 iterations x 12 blurs and guided fits at
# 1/4 size, two resizes and whole-frame sums, each rounding in its own
# order (measured below 2e-6 on values up to 1.2).  Where the variances
# of two channels tie to a few ulps, the guided fit picks its guiding
# channel by rounding: that moves a patch of pixels by up to 7.5e-4
# (2.2% of the frame on the seeds below, where two such ties occur).
LAPLACIAN_TOL, LAPLACIAN_TIE_TOL, TIE_SHARE = 1e-5, 1e-3, 0.05


@pytest.mark.parametrize("shape,taps,d", [
    ((4, 37, 75), B3, 1), ((4, 37, 75), B3, 2), ((4, 37, 75), B3, 4),
    ((4, 37, 75), B3, 8), ((4, 37, 75), B3, 16), ((4, 37, 75), B3, 32),
    ((4, 37, 75), B3, 64),                          # wider than the frame
    ((29, 50), (0.1, 0.2, 0.4, 0.2, 0.1, 0.05, -0.05), 3),  # 2-D, 7 taps
])
def test_sepblur_twin_matches_pallas_full_frame(shape, taps, d):
    x = np.random.default_rng(d).random(shape).astype(np.float32)
    ref = np.asarray(sep_blur_pallas(jnp.asarray(x), taps, d, interpret=True))
    got = sepblur.sep_blur_reference(torch.from_numpy(x), taps, d).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= SEP_TOL


@pytest.mark.parametrize("shape,d", [((2, 30, 700), 128), ((2, 30, 700), 256),
                                     ((1100, 20), 256), ((3, 9, 1200), 512)])
def test_sepblur_twin_matches_shifted_adds_past_reach_256(shape, d):
    """Past a reach of 256 the JAX package takes the XLA shifted adds of
    `pixel/shifts.sep_filter`, not its Pallas kernel: the twin (which the
    kernel follows on the card at any reach) equals them there too."""
    from ansel_tpu.pixel.shifts import sep_filter as ref_sep_filter

    x = np.random.default_rng(d).random(shape).astype(np.float32)
    ref = np.asarray(ref_sep_filter(jnp.asarray(x), B3, d))
    got = sepblur.sep_blur_reference(torch.from_numpy(x), B3, d).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= SEP_TOL


def test_sep_filter_routes_and_runs_the_plain_version_on_cpu():
    x = torch.from_numpy(np.random.default_rng(1).random((4, 20, 30))
                         .astype(np.float32))
    before = sepblur.LAUNCHES
    got = shifts.sep_filter(x, B3, 4)
    assert sepblur.LAUNCHES == before
    assert torch.equal(got, sepblur.sep_blur_reference(x, B3, 4))
    # a strided view goes the same way as its contiguous copy
    xt = x.transpose(1, 2)
    assert torch.equal(shifts.sep_filter(xt, B3, 2),
                       sepblur.sep_blur_reference(xt.contiguous(), B3, 2))


def test_sepblur_wrapper_refuses_other_devices():
    with pytest.raises(ValueError):
        sepblur.sep_blur(torch.zeros((2, 8, 8), device="meta"), B3, 1)


@pytest.mark.parametrize("shape,out", [
    ((4, 37, 53), (4, 9, 13)),      # down x4, odd sizes
    ((4, 9, 13), (4, 37, 53)),      # up x4
    ((3, 41, 61), (3, 10, 61)),     # one axis only
    ((37, 53), (37, 53)),           # identity
])
def test_resize_matches_jax_image_resize(shape, out):
    x = np.random.default_rng(sum(shape)).random(shape).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), out, "bilinear"))
    got = resize_bilinear(torch.from_numpy(x), out).numpy()
    assert got.shape == ref.shape == out
    assert np.abs(got - ref).max() <= RESIZE_TOL


def _clipped_mosaic(h, w, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.05, 0.6, (h, w)).astype(np.float32)
    x[20:44, 30:70] = rng.uniform(0.9, 1.2, (24, 40)).astype(np.float32)
    return x


@pytest.fixture(scope="session")
def reconstructions():
    """ansel_tpu's laplacian_reconstruct on a small RGGB and BGGR mosaic
    with a clipped patch, and the inputs."""
    out = {}
    for cfa in ("RGGB", "BGGR"):
        x = _clipped_mosaic(72, 104, seed=len(cfa) + ord(cfa[0]))
        ref = np.asarray(ref_hl.laplacian_reconstruct(
            jnp.asarray(x), [0.8, 0.85, 0.9], RefCFA[cfa], 8, 30, 0.0, 0.5))
        out[cfa] = (x, ref)
    return out


@pytest.mark.parametrize("cfa", ["RGGB", "BGGR"])
def test_laplacian_reconstruct_matches_reference(reconstructions, cfa):
    x, ref = reconstructions[cfa]
    got = hl.laplacian_reconstruct(
        torch.from_numpy(x), torch.tensor([0.8, 0.85, 0.9]), CFAPattern[cfa],
        8, 30, 0.0, 0.5).numpy()
    d = np.abs(got - ref)
    assert d.max() <= LAPLACIAN_TIE_TOL
    assert np.mean(d > LAPLACIAN_TOL) <= TIE_SHARE
    assert np.abs(got - x).max() > 0.1  # the clipped patch was rebuilt


def test_laplacian_runs_360_blurs_per_reconstruction(monkeypatch):
    calls = []
    real = shifts.sep_filter
    monkeypatch.setattr(hl, "sep_filter",
                        lambda *a, **k: calls.append(a[2]) or real(*a, **k))
    x = torch.from_numpy(_clipped_mosaic(64, 96, seed=2))
    hl.laplacian_reconstruct(x, [0.8, 0.85, 0.9], CFAPattern.RGGB, 8, 30,
                             0.0, 0.5)
    assert len(calls) == 30 * 2 * 6
    assert sorted(set(calls)) == [1, 2, 4, 8, 16, 32]


def test_laplacian_salt_draws_once_with_the_last_key(monkeypatch):
    """The salt (refused until JAX's generator was ported) fires once, on
    the last iteration's guided pass, with the last of the iterations'
    keys, on the (4, h/4, w/4) stack; the JAX package's salted run is
    held in tests/test_torch_noise_ops.py."""
    from ansel_tpu_torch.pixel import prng

    draws, real = [], prng.normal
    monkeypatch.setattr(prng, "normal", lambda key, shape, device="cpu":
                        draws.append((key, tuple(shape)))
                        or real(key, shape, device))
    x = torch.from_numpy(_clipped_mosaic(64, 96, seed=3))
    hl.laplacian_reconstruct(x, [0.8, 0.85, 0.9], CFAPattern.RGGB, 8, 3,
                             0.1, 0.5)
    assert draws == [(prng.split(prng.PRNGKey(hl.SALT_SEED), 3)[-1],
                      (4, 16, 24))]


@pytest.mark.parametrize("cfa", ["RGGB", "BGGR", "GRBG", "GBRG"])
def test_bayer_masks_and_selects_match_reference(cfa):
    from ansel_tpu.ops import _bayer as ref_bayer

    got = _bayer.color_masks(CFAPattern[cfa], 6, 7).numpy()
    ref = np.asarray(ref_bayer.color_masks(RefCFA[cfa], 6, 7))
    assert np.array_equal(got, ref)
    vals = [1.5, 2.0, 0.5, 2.25]
    got = _bayer.color_select(torch.tensor(vals), CFAPattern[cfa], 5, 6)
    ref = ref_bayer.color_select(vals, RefCFA[cfa], 5, 6)
    assert np.array_equal(got.numpy(), np.asarray(ref))
    rp, cp = _bayer.parity_maps(5, 6, 1, 0)
    rrp, rcp = ref_bayer.parity_maps(5, 6, 1, 0)
    assert np.array_equal(rp.numpy(), np.asarray(rrp))
    assert np.array_equal(cp.numpy(), np.asarray(rcp))
