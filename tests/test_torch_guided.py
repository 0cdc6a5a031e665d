"""The port's full-size guided filters (`ansel_tpu_torch/pixel/guided.py`:
`guided_filter`, `fast_guided_filter`, `eigf`) against
`ansel_tpu.pixel.guided` on the CPU, at radii on both sides of the box
mean's switch from the sepblur stencil (r <= 7) to cumulative sums, and
hazeremoval's value bisection (`_bisect_quantile`) against the JAX
package's on a plane of more than 2^24 pixels, where a float32 count
rounds.  The planes are smooth scenes with texture, where the filters
are well conditioned."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ansel_tpu.ops import hazeremoval as ref_haze
from ansel_tpu.pixel import guided as ref
from ansel_tpu_torch.ops import hazeremoval as haze
from ansel_tpu_torch.pixel import guided

torch.set_num_threads(1)

H, W = 120, 184
# torch's sequential cumulative sums and the JAX package's (XLA's scan,
# or its blocked triangular products past 2 x 128 samples) round
# differently; the box means agree to ~1e-6 and the filters to the
# measured maxima below (values of order 1)
GUIDED_TOL = 2e-5
# the bisection's counts are exact integers compared in float32 in both
BISECT_BIG = (4200, 4200)   # 17.64 M pixels > 2^24


def _planes(seed=3):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    base = 0.5 + 0.4 * np.sin(xx / 17.0) * np.cos(yy / 23.0)
    edge = (xx > W * 0.55).astype(np.float32) * 0.3
    guide = base + edge + 0.05 * rng.standard_normal((H, W)).astype(
        np.float32)
    src = 0.7 * guide + 0.1 * rng.standard_normal((H, W)).astype(np.float32)
    return guide.astype(np.float32), src.astype(np.float32)


def _compare(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert np.isfinite(got.numpy()).all()
    return np.abs(got.numpy() - want).max()


@pytest.mark.parametrize("radius,eps", [(3, 0.025), (9, 0.025), (40, 0.16)])
def test_guided_filter(radius, eps):
    g, s = _planes()
    got = guided.guided_filter(torch.from_numpy(g), torch.from_numpy(s),
                               radius, eps)
    want = ref.guided_filter(jnp.asarray(g), jnp.asarray(s), radius, eps)
    assert _compare(got, want) <= GUIDED_TOL


@pytest.mark.parametrize("radius,scaling", [(3, 4), (16, 4), (50, 8)])
def test_fast_guided_filter(radius, scaling):
    """radius < 4 takes the full-size filter; beyond, the (a, b) surface
    at a block-mean downsample, upsampled as jax.image.resize "linear"
    (frame sizes that are not a multiple of the scaling pad and crop)."""
    g, s = _planes(5)
    g, s = g[:, :W - 3], s[:, :W - 3]
    got = guided.fast_guided_filter(torch.from_numpy(g), torch.from_numpy(s),
                                    radius, 64.0, scaling=scaling)
    want = ref.fast_guided_filter(jnp.asarray(g), jnp.asarray(s), radius,
                                  64.0, scaling=scaling)
    assert _compare(got, want) <= GUIDED_TOL


@pytest.mark.parametrize("radius,feathering", [(5, 0.01), (12, 0.1)])
def test_eigf(radius, feathering):
    g, s = _planes(7)
    got = guided.eigf(torch.from_numpy(g), torch.from_numpy(s), radius,
                      feathering)
    want = ref.eigf(jnp.asarray(g), jnp.asarray(s), radius, feathering)
    assert _compare(got, want) <= GUIDED_TOL


@pytest.mark.parametrize("radius", [6])
def test_hazeremoval_window_min_max(radius):
    g, _ = _planes(9)
    for got, want in ((haze.box_min(torch.from_numpy(g), radius),
                       ref_haze.box_min(jnp.asarray(g), radius)),
                      (haze.box_max(torch.from_numpy(g), radius),
                       ref_haze.box_max(jnp.asarray(g), radius))):
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def big_plane():
    rng = np.random.default_rng(11)
    v = rng.random(BISECT_BIG, dtype=np.float32)
    # ties: a tenth of the plane at one value, as clipped pixels give
    v[:420] = 0.75
    mask = rng.random(BISECT_BIG, dtype=np.float32) < 0.6
    return v, mask


def test_bisect_quantile_over_2_24_pixels(big_plane):
    """The first quantile of hazeremoval (0.95 size + 1 over the whole
    plane) and the masked second one, bit for bit: the count passes 2^24,
    so both packages compare it as a rounded float32."""
    v, mask = big_plane
    size = v.size
    assert size > 1 << 24
    vt, vj = torch.from_numpy(v), jnp.asarray(v)
    target = size * 0.95 + 1.0
    got = haze._bisect_quantile(vt, torch.tensor(target, dtype=torch.float32),
                                vt.min(), vt.max())
    want = ref_haze._bisect_quantile(vj, target, jnp.min(vj), jnp.max(vj))
    assert got.item() == float(want)
    n = int(mask.sum())
    got = haze._bisect_quantile(
        vt, torch.tensor(n, dtype=torch.float32) * 0.95 + 1.0, vt.min(),
        vt.max(), mask=torch.from_numpy(mask))
    want = ref_haze._bisect_quantile(
        vj, jnp.float32(n) * 0.95 + 1.0, jnp.min(vj), jnp.max(vj),
        mask=jnp.asarray(mask))
    assert got.item() == float(want)


def test_bisect_counts_round_as_float32():
    """Past 2^24 the count and the target compare as float32, as in the
    JAX package: 2^24 values at or below every midpoint against a target
    of 2^24 + 1 (float32 2^24) hit at each round, where an exact integer
    comparison would never hit and leave the upper bound at 1."""
    n = 1 << 24
    v = torch.zeros(n + 3)
    v[n:] = 1.0
    target = n + 1.0
    got = haze._bisect_quantile(v, torch.tensor(target, dtype=torch.float32),
                                v.min(), v.max(), iters=4)
    vj = jnp.asarray(v.numpy())
    want = ref_haze._bisect_quantile(vj, target, jnp.min(vj), jnp.max(vj),
                                     iters=4)
    assert got.item() == float(want) == 1.0 / 16.0
