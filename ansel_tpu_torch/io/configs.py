"""The bench configurations the port runs (`bench.py:CONFIGS`), defined
once for the chip smoke, the profile script and the tests.

Each history is a tuple of (op, params) pairs, so that a test can build
the JAX package's `HistoryItem`s from the same pairs as the port's.
"""

from __future__ import annotations

# frame of bench configs 1 and 2: a 24 MP Bayer raw
BENCH_H, BENCH_W = 4000, 6016
# frame of bench config 3: a 45 MP Bayer raw
BENCH3_H, BENCH3_W = 5504, 8256

_A, _B = (4e-4,) * 3, (1e-5,) * 3
HISTORIES = {
    # the default pipe
    1: (("exposure", {"exposure": 0.5}),
        ("channelmixerrgb", {}),
        ("filmicrgb", {})),
    # the high-ISO denoise stack: guided-Laplacian highlights, a wavelet
    # denoise pass and an NLM pass
    2: (("highlights", {"mode": 3, "clip": 1.0}),
        ("denoiseprofile", {"a": _A, "b": _B, "strength": 2.0}),
        ("denoiseprofile", {"a": _A, "b": _B, "strength": 1.0, "mode": 0}),
        ("exposure", {"exposure": 0.5}),
        ("filmicrgb", {})),
    # the heavy iterative stack: diffuse (4 iterations), toneequal with
    # its guided mask, local-Laplacian local contrast
    3: (("diffuse", {"iterations": 4, "first": 0.2, "second": 0.2,
                     "third": 0.2, "fourth": 0.2, "radius": 8}),
        ("toneequal", {"shadows": 0.5}),
        ("bilat", {"sigma_r": 100.0, "sigma_s": 100.0, "detail": 0.3}),
        ("exposure", {"exposure": 0.5}),
        ("filmicrgb", {})),
}

# each config's frame (height, width)
FRAMES = {1: (BENCH_H, BENCH_W), 2: (BENCH_H, BENCH_W),
          3: (BENCH3_H, BENCH3_W)}


def history(config: int, item_cls=None) -> list:
    """Config `config`'s history as `item_cls(op, params)` items, each
    with its own params dict (the port's `HistoryItem` by default)."""
    if item_cls is None:
        from ..pipeline.engine import HistoryItem as item_cls
    return [item_cls(op, dict(p)) for op, p in HISTORIES[config]]
