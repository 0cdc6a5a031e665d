"""The bench configurations the port runs (`bench.py:CONFIGS`), and the
port's own config 7, defined once for the chip smoke, the profile script
and the tests.

Each history is a tuple of (op, params) pairs, so that a test can build
the JAX package's `HistoryItem`s from the same pairs as the port's.
"""

from __future__ import annotations

# frame of bench configs 1 and 2: a 24 MP Bayer raw
BENCH_H, BENCH_W = 4000, 6016
# frame of bench config 3: a 45 MP Bayer raw
BENCH3_H, BENCH3_W = 5504, 8256
# frame of bench config 4: a 24 MP X-Trans raw (padded to 6016 columns)
BENCH4_H, BENCH4_W = 4000, 6000

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
    # X-Trans Markesteijn and lens with TCA.  bench.py labels it 3-pass,
    # but 1024 | 2 lacks the X-Trans flag, so both packages plan
    # Markesteijn 1-pass
    4: (("demosaic", {"demosaicing_method": 1024 | 2}),
        ("lens", {"tca_r": 1.0005, "tca_b": 0.9995, "dist_a": -0.02}),
        ("exposure", {"exposure": 0.5}),
        ("filmicrgb", {})),
    # the bilateral-grid stack, the port's own history: bench.py has no
    # config 7 (its 5 is the library path and its 6 a sidecar the repo
    # lacks).  The surface-blur bilateral (radius 15, three grids of 32
    # range bins), shadows & highlights softened by the bilateral grid
    # (radius 100), local contrast in bilateral mode (bilat mode 0, every
    # pre-3.0 bilat v1 sidecar) and sharpen: five grid slices per image
    7: (("bilateral", {}),
        ("exposure", {"exposure": 0.5}),
        ("filmicrgb", {}),
        ("shadhi", {"shadhi_algo": 1}),
        ("bilat", {"mode": 0, "sigma_r": 20.0, "sigma_s": 50.0,
                   "detail": 0.25}),
        ("sharpen", {})),
}

# each config's frame (height, width)
FRAMES = {1: (BENCH_H, BENCH_W), 2: (BENCH_H, BENCH_W),
          3: (BENCH3_H, BENCH3_W), 4: (BENCH4_H, BENCH4_W),
          7: (BENCH_H, BENCH_W)}
# configs whose raw is an X-Trans mosaic (`remosaic_xtrans`)
XTRANS_CONFIGS = (4,)

# Fuji X-Trans III 6x6 pattern (colour indices, row-major)
XTRANS6 = (1, 2, 0, 1, 0, 2,
           0, 1, 1, 2, 1, 1,
           2, 1, 1, 0, 1, 1,
           1, 0, 2, 1, 2, 0,
           2, 1, 1, 0, 1, 1,
           0, 1, 1, 2, 1, 1)


def history(config: int, item_cls=None) -> list:
    """Config `config`'s history as `item_cls(op, params)` items, each
    with its own params dict (the port's `HistoryItem` by default)."""
    if item_cls is None:
        from ..pipeline.engine import HistoryItem as item_cls
    return [item_cls(op, dict(p)) for op, p in HISTORIES[config]]


def remosaic_xtrans(meta, scene):
    """Re-sample `synth_raw`'s (3, H, W) scene through XTRANS6: -> (the
    (H, W) float32 X-Trans mosaic in sensor units, meta with the pattern),
    as bench.py's `_remosaic_xtrans`."""
    import dataclasses

    import numpy as np

    _, h, w = scene.shape
    meta = dataclasses.replace(meta, xtrans=XTRANS6)
    idx = np.asarray(XTRANS6).reshape(6, 6)
    sel = idx[np.arange(h)[:, None] % 6, np.arange(w)[None, :] % 6]
    lin = np.take_along_axis(np.asarray(scene), sel[None], axis=0)[0]
    wb = np.asarray(meta.wb_coeffs)[:3][sel]
    raw = (lin / np.maximum(wb, 1e-6)
           * (meta.white_point - meta.black_levels[0])
           + meta.black_levels[0]).astype(np.float32)
    return raw, meta
