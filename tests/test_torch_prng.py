"""The port's copy of JAX's threefry-2x32 generator
(`ansel_tpu_torch/pixel/prng.py`) against `jax.random` on the CPU: keys,
splits, raw bits, uniform (the [0, 1) default and [-0.5, 0.5)) and
randint bit for bit at the seeds the JAX package draws with (grain 773,
dither 353, censorize 1259, the Laplacian's salt 0x411E, crystgrain
0x5EED, filmic's highlight reconstruction 0), on odd 2-D and (3, H, W)
shapes; normal and erf_inv within their stated tolerance (XLA's and
torch's float32 log1p differ in the last bit now and then)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ansel_tpu.ops.crystgrain import LAYER_KERNELS
from ansel_tpu_torch.pixel import prng

torch.set_num_threads(1)

SEEDS = (0, 353, 773, 1259, 0x411E, 0x5EED)
SHAPES = ((37, 53), (3, 21, 17))
# normal: the same uniform draw through the same erf_inv polynomial; only
# log1p rounds differently (measured max 4.8e-7 on these draws and over
# 2M points of (-1, 1))
NORMAL_TOL = 5e-7
ERFINV_TOL = 5e-7


def _key(seed):
    return jax.random.PRNGKey(seed)


def _bits(a):
    return np.asarray(a).astype(np.int64)


def test_threefry_is_partitionable():
    """The bits pinned here are those of the partitionable scheme, JAX's
    default since 0.5 (the original scheme draws others)."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_and_split(seed):
    assert prng.PRNGKey(seed) == tuple(np.asarray(_key(seed)).tolist())
    crystgrain_layers = 30
    for n in (2, 5, crystgrain_layers):
        want = np.asarray(jax.random.split(_key(seed), n)).tolist()
        got = prng.split(prng.PRNGKey(seed), n)
        assert [list(k) for k in got] == want
        # hashed as tensors (the form a device runs) -> the same keys
        assert prng.split(prng.PRNGKey(seed), n, device="cpu") == got
    # a split of a split, as crystgrain and randint take them
    k1 = prng.split(prng.PRNGKey(seed))[1]
    want = np.asarray(jax.random.split(jax.random.split(_key(seed))[1],
                                       3)).tolist()
    assert [list(k) for k in prng.split(k1, 3)] == want


@pytest.mark.parametrize("shape", SHAPES, ids=["2d", "3hw"])
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniform_randint_are_jax_bits(seed, shape):
    key, k = prng.PRNGKey(seed), _key(seed)
    assert np.array_equal(prng.random_bits(key, shape).numpy(),
                          _bits(jax.random.bits(k, shape)))
    got = prng.uniform(key, shape)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(jax.random.uniform(k, shape)))
    assert np.array_equal(
        prng.uniform(key, shape, -0.5, 0.5).numpy(),
        np.asarray(jax.random.uniform(k, shape, jnp.float32, -0.5, 0.5)))
    got = prng.randint(key, shape, 0, LAYER_KERNELS)
    assert got.dtype == torch.int32
    assert np.array_equal(
        got.numpy(), np.asarray(jax.random.randint(k, shape, 0,
                                                   LAYER_KERNELS)))
    # a span that is not a power of two takes the multiplier's path
    assert np.array_equal(
        prng.randint(key, shape, -7, 1000).numpy(),
        np.asarray(jax.random.randint(k, shape, -7, 1000)))


@pytest.mark.parametrize("shape", SHAPES, ids=["2d", "3hw"])
@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_tolerance(seed, shape):
    got = prng.normal(prng.PRNGKey(seed), shape).numpy()
    want = np.asarray(jax.random.normal(_key(seed), shape))
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= NORMAL_TOL
    assert (got == want).mean() > 0.9


def test_erf_inv_against_xla():
    x = np.linspace(-1.0, 1.0, 2_000_001, dtype=np.float32)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    got = prng.erf_inv(torch.from_numpy(x)).numpy()
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin)
    assert got[0] == -np.inf and got[-1] == np.inf
    assert np.abs(got[fin] - want[fin]).max() <= ERFINV_TOL
    assert (got == want).mean() > 0.9
    # torch.erfinv is another function: off by more, exact less often
    other = torch.erfinv(torch.from_numpy(x)).numpy()
    assert np.abs(other[fin] - want[fin]).max() > ERFINV_TOL


def test_normal_constants_are_jax_float32():
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    assert np.float32(prng._NORMAL_LO) == lo
    assert np.float32(prng._SQRT2_F32) == np.float32(np.sqrt(2))


def test_tensor_and_host_threefry_agree():
    """The hash on Python ints (keys) and on int64 tensors (draws) is one
    function: both give JAX's words for a few counters."""
    key = prng.PRNGKey(0x5EED)
    hi = torch.tensor([0, 0, 1, 7], dtype=torch.int64)
    lo = torch.tensor([0, 5, 3, 0xFFFFFFFF], dtype=torch.int64)
    y0, y1 = prng.threefry2x32(key, hi, lo)
    for i in range(4):
        assert (y0[i].item(), y1[i].item()) == prng.threefry2x32(
            key, int(hi[i]), int(lo[i]))
