"""JAX's default random number generator, threefry-2x32, in torch.

The JAX package draws its noise with `jax.random` (grain, dither,
censorize, crystgrain, filmicrgb's highlight reconstruction and the
highlights Laplacian's salt), so the port draws the same bits:
`jax/_src/prng.py` (JAX 0.9.0, `jax_threefry_partitionable` on, its
default) and `jax/_src/random.py`:

  * `PRNGKey(seed)` (`threefry_seed`): the key [seed >> 32, seed & M];
  * `threefry2x32` (`_threefry2x32_lowering`): five groups of four
    rounds over two 32-bit words, a key injection after each;
  * `split(key, n)` (`_threefry_split_foldlike`): the hash of the
    counters (0, i), i < n, whose two words are the i-th new key;
  * `random_bits(key, shape)` (`_threefry_random_bits_partitionable`):
    the hash of each element's flat index as (hi, lo) words, the two
    output words xor-ed;
  * `uniform` (`_uniform`): 23 mantissa bits under the exponent of 1.0,
    minus 1, scaled and clamped in float32;
  * `randint` (`_randint`): two draws from a split key, reduced modulo
    the span as uint32 arithmetic does;
  * `normal` (`_normal_real`): a uniform on (nextafter(-1, 0), 1) through
    sqrt(2) erf_inv, where erf_inv is the single-precision polynomial of
    XLA's `chlo.erf_inv` lowering (M. Giles, "Approximating the erfinv
    function"), not `torch.erfinv`.

A key is a pair of Python ints.  The 32-bit words of a draw live in
int64 tensors, masked to 32 bits after every add and shift, so the bits
are exact on any device (torch's uint32 arithmetic is not complete on
CUDA).  Every draw is plain torch: about 150 elementwise launches over
the element count.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
Key = Tuple[int, int]


def PRNGKey(seed: int) -> Key:
    """threefry_seed: a 64-bit seed's high and low words."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return (seed >> 32, seed & M32)


def threefry2x32(key: Key, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the word pairs (x0, x1),
    Python ints or int64 tensors holding uint32 values -> (y0, y1) of the
    same kind."""
    ks = (key[0], key[1], key[0] ^ key[1] ^ _PARITY)
    tensor = isinstance(x0, torch.Tensor)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            if tensor:
                x0.add_(x1).bitwise_and_(M32)
                low = x1 >> (32 - r)
                x1.bitwise_left_shift_(r).bitwise_and_(M32) \
                    .bitwise_or_(low).bitwise_xor_(x0)
            else:
                x0 = (x0 + x1) & M32
                x1 = (((x1 << r) & M32) | (x1 >> (32 - r))) ^ x0
        inc0, inc1 = ks[(i + 1) % 3], ks[(i + 2) % 3] + i + 1
        if tensor:
            x0.add_(inc0).bitwise_and_(M32)
            x1.add_(inc1).bitwise_and_(M32)
        else:
            x0 = (x0 + inc0) & M32
            x1 = (x1 + inc1) & M32
    return x0, x1


def split(key: Key, num: int = 2, device=None) -> List[Key]:
    """jax.random.split: `num` new keys, the hash of the counters (0, i).
    On the host by default; with `device`, hashed as tensors there and
    read back."""
    if device is None:
        return [threefry2x32(key, 0, i) for i in range(num)]
    lo = torch.arange(num, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(key, torch.zeros_like(lo), lo)
    return [tuple(k) for k in torch.stack([y0, y1], 1).tolist()]


def random_bits(key: Key, shape: Sequence[int], device="cpu") -> torch.Tensor:
    """32 random bits per element (int64 holding uint32): the hash of each
    element's flat index, its two words xor-ed."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(key, idx >> 32, idx & M32)
    return y0.bitwise_xor_(y1).reshape(tuple(shape))


def _f32(v, device):
    """A float32 scalar on `device`, filled there (a copy from pageable
    host memory would wait for the device's queue)."""
    return torch.full((), v, dtype=torch.float32, device=device)


def uniform(key: Key, shape: Sequence[int], minval=0.0, maxval=1.0,
            device="cpu") -> torch.Tensor:
    """float32 uniform on [minval, maxval), jax.random.uniform's bits."""
    bits = random_bits(key, shape, device)
    one = bits.bitwise_right_shift_(9).bitwise_or_(0x3F800000)
    floats = one.to(torch.int32).view(torch.float32) - 1.0
    lo, hi = _f32(minval, device), _f32(maxval, device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def randint(key: Key, shape: Sequence[int], minval: int, maxval: int,
            device="cpu") -> torch.Tensor:
    """int32 uniform on [minval, maxval), jax.random.randint's bits (two
    draws reduced modulo the span in uint32 arithmetic)."""
    span = max(int(maxval) - int(minval), 1)
    if span >= 1 << 31:
        raise ValueError(f"randint: span {span} is not supported")
    k1, k2 = split(key)
    higher = random_bits(k1, shape, device)
    lower = random_bits(k2, shape, device)
    multiplier = ((1 << 16) % span) ** 2 % span
    offset = (higher.remainder_(span).mul_(multiplier).bitwise_and_(M32)
              .add_(lower.remainder_(span)).bitwise_and_(M32)
              .remainder_(span))
    return (offset + int(minval)).to(torch.int32)


# XLA's erf_inv for float32 (chlo.erf_inv, M. Giles's single-precision
# form): nine coefficients for w < 5 and for w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function as XLA lowers it: w = -log1p(-x^2);
    a polynomial in w - 2.5 (w < 5) or sqrt(w) - 3, times x; +-inf at
    |x| = 1."""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, a, b) + p * w
    return torch.where(torch.abs(x) == 1.0, x * math.inf, p * x)


# jax.random.normal's uniform: (nextafter(-1, 0), 1) in float32
_NORMAL_LO = -0.99999994
_SQRT2_F32 = 1.4142135


def normal(key: Key, shape: Sequence[int], device="cpu") -> torch.Tensor:
    """float32 standard normal, jax.random.normal's draws."""
    u = uniform(key, shape, _NORMAL_LO, 1.0, device)
    return erf_inv(u) * _SQRT2_F32
