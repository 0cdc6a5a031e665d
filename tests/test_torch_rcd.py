"""The port's RCD (ansel_tpu_torch/kernels/rcd.py) against the TPU kernel
`rcd_demosaic_pallas` run in interpret mode, on the full frame, borders
included.  Inputs come from numpy seeds and go to both packages as the
same float32 arrays."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ansel_tpu.core.types import CFAPattern as RefCFA
from ansel_tpu.kernels.rcd_pallas import rcd_demosaic_pallas
from ansel_tpu_torch.core.types import CFAPattern
from ansel_tpu_torch.kernels import rcd

torch.set_num_threads(2)

# Both run RCD's float32 operations in the same order on the same
# edge-padded frame; what is left is XLA's and torch's rounding of a few
# fused operations, measured at ~2e-6 on values up to ~2.7.
TOL = 1e-5


def _mosaic(kind, h, w, scaler, seed):
    rng = np.random.default_rng(seed)
    if kind == "flat":
        return np.full((h, w), 0.3 * scaler, np.float32)
    return (rng.uniform(0.0, 1.0, (h, w)) * scaler).astype(np.float32)


@pytest.mark.parametrize("cfa,h,w,scaler,kind", [
    ("RGGB", 144, 384, 1.0, "noise"),
    ("GBRG", 136, 400, 2.7, "noise"),   # ragged: neither tile size divides
    ("RGGB", 136, 400, 2.7, "flat"),    # v/(v+h) at EPSSQ on flat areas
    ("GBRG", 144, 384, 1.0, "flat"),
])
def test_rcd_matches_pallas_full_frame(cfa, h, w, scaler, kind):
    x = _mosaic(kind, h, w, scaler, seed=h + w)
    ref = np.asarray(rcd_demosaic_pallas(jnp.asarray(x), RefCFA[cfa], scaler,
                                         interpret=True))
    got = rcd.rcd_demosaic_reference(torch.from_numpy(x), CFAPattern[cfa],
                                     scaler).numpy()
    assert got.shape == ref.shape == (3, h, w)
    assert np.abs(got - ref).max() <= TOL


def test_rcd_wrapper_runs_the_plain_version_on_cpu():
    x = torch.from_numpy(_mosaic("noise", 40, 64, 1.5, seed=1))
    before = rcd.LAUNCHES
    out = rcd.rcd_demosaic(x, CFAPattern.RGGB, 1.5)
    assert rcd.LAUNCHES == before
    assert torch.equal(out, rcd.rcd_demosaic_reference(x, CFAPattern.RGGB,
                                                       1.5))


def test_rcd_wrapper_refuses_other_devices_and_patterns():
    with pytest.raises(ValueError):
        rcd.rcd_demosaic(torch.zeros((8, 8), device="meta"),
                         CFAPattern.RGGB)
    with pytest.raises(ValueError):
        rcd.rcd_demosaic(torch.zeros((8, 8)), CFAPattern.XTRANS)


def test_rcd_scaler_tensor_equals_float():
    x = torch.from_numpy(_mosaic("noise", 32, 48, 2.0, seed=3))
    a = rcd.rcd_demosaic_reference(x, CFAPattern.BGGR, 2.0)
    b = rcd.rcd_demosaic_reference(x, CFAPattern.BGGR, torch.tensor(2.0))
    assert torch.equal(a, b)


def _reach(fn, x, y0, x0):
    """How far from (y0, x0) the outputs of fn move when that mosaic pixel
    is made NaN or raised by 0.7 (Chebyshev px)."""
    base = fn(x)
    far = 0
    for value in (float("nan"), float(x[y0, x0]) + 0.7):
        y = x.clone()
        y[y0, x0] = value
        out = fn(y)
        same = (out == base) | (torch.isnan(out) & torch.isnan(base))
        ys, xs = torch.nonzero(~same.all(0), as_tuple=True)
        if len(ys):
            far = max(far, int((ys - y0).abs().max()),
                      int((xs - x0).abs().max()))
    return far


@pytest.mark.parametrize("cfa", ["RGGB", "GBRG"])
@pytest.mark.parametrize("py,px", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_rcd_reach_is_within_the_kernel_halo(cfa, py, px):
    """A mosaic pixel moves no output farther than the halo a block of the
    kernel loads: the edge-extended frame within HALO px decides a
    pixel, so the tile's result equals the twin's."""
    x = torch.from_numpy(_mosaic("noise", 48, 48, 1.0, seed=9))
    far = _reach(lambda m: rcd.rcd_demosaic_reference(m, CFAPattern[cfa]),
                 x, 24 + py, 24 + px)
    assert 0 < far <= rcd.HALO
