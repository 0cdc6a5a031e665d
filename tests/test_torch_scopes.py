"""The scopes (`ansel_tpu_torch/pipeline/histogram.py`) against ansel_tpu's
on the CPU, count for count: histogram, waveform, vectorscope and the
clipping statistics.  The inputs sit at bin centres: the waveform pools
columns and the vectorscope mixes channels before binning, and an ulp
between XLA's and torch's arithmetic may move a value across a bin edge
on arbitrary inputs.  tests/test_scopes.py's cases run on the port too."""

import numpy as np
import pytest
import torch

from ansel_tpu.pipeline import histogram as ref
from ansel_tpu_torch.pipeline import histogram as scopes

torch.set_num_threads(1)


def _centred(rng, shape, bins):
    """Values at bin centres: k / (bins - 1) for random k."""
    k = rng.integers(0, bins, shape)
    return (k / np.float64(bins - 1)).astype(np.float32)


@pytest.mark.parametrize("bins,hw", [(256, (40, 60)), (64, (33, 17)),
                                     (16, (1, 5))])
def test_histogram_counts_equal_the_jax_package(bins, hw):
    rng = np.random.default_rng(bins)
    img = _centred(rng, (3,) + hw, bins)
    img[0, 0, :2] = (-0.3, 1.7)     # clipped into the end bins
    want = np.asarray(ref.histogram_rgb(img, bins=bins))
    got = scopes.histogram_rgb(torch.from_numpy(img), bins=bins)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("bins,w,out_cols", [(160, 720, 0), (32, 100, 50),
                                             (64, 90, 7), (20, 64, 200)])
def test_waveform_counts_equal_the_jax_package(bins, w, out_cols):
    """Each pooled column group holds one value, so its mean sits at the
    bin centre in both packages."""
    rng = np.random.default_rng(w)
    h, c = 24, 3
    step = max(w // (out_cols or min(w, 360)), 1)
    groups = -(-w // step)
    img = np.repeat(_centred(rng, (c, h, groups), bins), step,
                    axis=2)[:, :, :w]
    want = np.asarray(ref.waveform(img, bins=bins, out_cols=out_cols))
    got = scopes.waveform(torch.from_numpy(img), bins=bins,
                          out_cols=out_cols).numpy()
    assert got.shape == want.shape
    assert np.array_equal(got, want)


def _chroma(rng, n, size):
    """RGB whose Cb and Cr (the vectorscope's projection) sit at bin
    centres."""
    y = rng.uniform(0.3, 0.7, n)
    cb = rng.integers(size // 4, 3 * size // 4, n) / (size - 1)
    cr = rng.integers(size // 4, 3 * size // 4, n) / (size - 1)
    b = y + (cb - 0.5) / 0.564
    r = y + (cr - 0.5) / 0.713
    g = (y - 0.299 * r - 0.114 * b) / 0.587
    return np.stack([r, g, b]).astype(np.float32)


@pytest.mark.parametrize("size", [128, 64, 32])
def test_vectorscope_counts_equal_the_jax_package(size):
    rng = np.random.default_rng(size)
    img = _chroma(rng, 40 * 30, size).reshape(3, 40, 30)
    want = np.asarray(ref.vectorscope(img, size=size))
    got = scopes.vectorscope(torch.from_numpy(img), size=size).numpy()
    assert np.array_equal(got, want)
    assert got.sum() == 40 * 30


def test_stats_equal_the_jax_package():
    rng = np.random.default_rng(3)
    img = rng.uniform(0.0, 1.0, (3, 30, 50)).astype(np.float32)
    img[:, :4] = 1.0
    want = ref.stats(img)
    got = scopes.stats(torch.from_numpy(img))
    for k in ("min", "max"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    # means of float32 sums taken in other orders: within an ulp or two
    for k in ("mean", "clipped"):
        assert np.allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6,
                           atol=0), k


def test_scopes_take_numpy_arrays():
    img = np.full((3, 4, 6), 0.5, np.float32)
    assert scopes.histogram_rgb(img, bins=8).sum().item() == 3 * 24


# --- tests/test_scopes.py on the port ------------------------------------

def test_histogram_matches_numpy():
    rng = np.random.default_rng(0)
    img = rng.uniform(0.0, 1.0, (3, 40, 60)).astype(np.float32)
    h = scopes.histogram_rgb(torch.from_numpy(img), bins=64).numpy()
    assert h.shape == (3, 64)
    for c in range(3):
        want = np.bincount(
            np.clip((img[c] * 63 + 0.5).astype(int), 0, 63).ravel(),
            minlength=64)
        assert np.array_equal(h[c], want)


def test_waveform_shape_and_mass():
    rng = np.random.default_rng(1)
    img = rng.uniform(0.0, 1.0, (3, 32, 100)).astype(np.float32)
    wf = scopes.waveform(torch.from_numpy(img), bins=32, out_cols=50).numpy()
    assert wf.shape == (3, 32, 50)
    assert np.allclose(wf.sum(axis=1), 32.0)


def test_waveform_puts_bright_on_top():
    img = np.ones((3, 8, 10), np.float32)
    wf = scopes.waveform(torch.from_numpy(img), bins=16, out_cols=10)
    assert wf[:, 0].sum().item() == 3 * 8 * 10 and wf[:, 1:].sum() == 0


def test_vectorscope_neutral_peaks_center():
    img = np.full((3, 16, 16), 0.4, np.float32)
    vs = scopes.vectorscope(torch.from_numpy(img), size=64).numpy()
    assert vs.sum() == 16 * 16
    peak = np.unravel_index(vs.argmax(), vs.shape)
    assert abs(peak[0] - 32) <= 1 and abs(peak[1] - 32) <= 1


def test_stats_clipped_fraction():
    img = torch.zeros((3, 10, 10))
    img[:, :5] = 1.0
    assert np.allclose(scopes.stats(img)["clipped"].numpy(), 0.5)
