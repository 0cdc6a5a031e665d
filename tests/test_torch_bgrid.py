"""The port's bilateral grid (ansel_tpu_torch/pixel/bilateralgrid.py and
the slice kernel's plain twin, kernels/bgrid.py) against ansel_tpu on the
CPU: the twin against the Pallas slice's tile body evaluated op by op
(exact) and in interpret mode (a gate), the column upsample on both of
its branches, `grid_filter` against the JAX package's XLA path and its
Pallas path, and the Gaussians built on the upsample and the ported blur
kernels.  Inputs come from numpy seeds and go to both packages as the
same float32 arrays."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ansel_tpu.kernels import bgrid_pallas as bp
from ansel_tpu.pixel import bilateralgrid as ref_bg
from ansel_tpu.pixel import blur as ref_blur
from ansel_tpu_torch.kernels import bgrid
from ansel_tpu_torch.pixel import bilateralgrid as bg
from ansel_tpu_torch.pixel import blur

torch.set_num_threads(2)

# the JAX package's own gate between its two slice forms
# (tests/test_bgrid_pallas.py): relative to the output's largest value
REL_TOL = 2e-5
# the upsample for ss > 16: the JAX package contracts a dense matrix,
# which XLA's CPU dot sums with fused multiply-adds (one rounding fewer
# than the two products and their sum): measured 6e-8 on values in [0, 1)
UPSAMPLE_TOL = 1.2e-7

# (D, C, gh, gw, ss): the classes of tests/test_bgrid_pallas.py (D from
# its sigmas: 32, 32, 11 and 6), then ss = 1, ss = 100 with three
# channels (shadhi), ss = 10 with three (lowpass's default radius)
CLASSES = [
    (32, 1, 5, 9, 15),
    (32, 3, 5, 9, 15),
    (11, 1, 9, 17, 8),
    (6, 1, 3, 5, 50),
    (8, 1, 70, 130, 1),
    (4, 3, 2, 3, 100),
    (4, 3, 6, 11, 10),
]


def _grid_and_z(D, C, gh, gw, ss, seed):
    rng = np.random.default_rng(seed)
    G = (rng.random((D, C, gh, gw)) * 2.0 - 0.5).astype(np.float32)
    z = (rng.random((gh * ss, gw * ss)) * (D - 1)).astype(np.float32)
    z[0, :5] = 0.0                       # the lowest bin exactly
    z[1, :5] = D - 1                     # the highest: bin D gets weight 0
    z[2, :9] = np.arange(9) % D          # integers: one bin each
    z[-1, -3:] = [0.0, D - 1, D // 2]
    return G, z


class _Ref:
    """A host array standing in for a Pallas ref (`.at[...]` and [...])."""

    def __init__(self, a):
        self.a = a

    @property
    def at(self):
        return self

    def __getitem__(self, idx):
        return self.a[idx]


def _pallas_op_by_op(G, z, ss, monkeypatch):
    """bgrid_pallas.slice_grid's grid run by hand: each tile's `_kernel`
    evaluated one operation at a time (no compiler fuses anything), with
    the slab DMA a host copy.  Its column upsample is the port's
    (`bg.upsample_axis`), which test_upsample_axis_matches_reference holds
    against the JAX package's."""
    D, C, gh, gw = G.shape
    Hp, Wp = z.shape
    th, tw = bp.TILE_H, bp.TILE_W
    gxy = bg.upsample_axis(torch.from_numpy(G), ss, 3).numpy()
    ph, pw = (-Hp) % th, (-Wp) % tw
    zq = np.pad(z, ((0, ph), (0, pw)), mode="edge")
    ghh = min(bp._cdiv(gh, 8) * 8, bp._cdiv(th // ss + 3 + 7, 8) * 8)
    gh_pad = bp._cdiv(max(gh, ghh), 8) * 8
    gxy = np.pad(gxy, ((0, 0), (0, 0), (0, gh_pad - gh), (0, pw)),
                 mode="edge")

    class Copy:
        def __init__(self, src, dst, sem):
            self.src, self.dst = src, dst

        def start(self):
            self.dst[...] = self.src

        def wait(self):
            pass

    monkeypatch.setattr(bp, "pltpu",
                        types.SimpleNamespace(make_async_copy=Copy))
    out = np.zeros((C,) + zq.shape, np.float32)
    for i in range(zq.shape[0] // th):
        for j in range(zq.shape[1] // tw):
            monkeypatch.setattr(bp, "pl", types.SimpleNamespace(
                program_id=lambda a, ij=(i, j): ij[a],
                ds=lambda s, n: slice(int(s), int(s) + n)))
            o = np.zeros((C, th, tw), np.float32)
            bp._kernel(zq[i * th:(i + 1) * th, j * tw:(j + 1) * tw],
                       _Ref(gxy), o, np.zeros((D, C, ghh, tw), np.float32),
                       None, ss=ss, D=D, C=C, gh=gh, gh_pad=gh_pad, ghh=ghh)
            out[:, i * th:(i + 1) * th, j * tw:(j + 1) * tw] = o
    monkeypatch.undo()
    return out[:, :Hp, :Wp]


@pytest.mark.parametrize("D,C,gh,gw,ss", CLASSES)
def test_twin_equals_the_pallas_tile_body(D, C, gh, gw, ss, monkeypatch):
    G, z = _grid_and_z(D, C, gh, gw, ss, seed=D * 100 + ss)
    want = _pallas_op_by_op(G, z, ss, monkeypatch)
    got = bgrid.slice_grid(torch.from_numpy(G), torch.from_numpy(z),
                           ss).numpy()
    assert got.shape == want.shape == (C, gh * ss, gw * ss)
    assert np.array_equal(got, want)


# in interpret mode XLA's CPU jit fuses the kernel's products into its
# sums; the grid values in [-0.5, 1.5] cancel: measured 1.2e-6 relative.
# The classes of tests/test_bgrid_pallas.py run here through
# test_grid_filter_matches_the_pallas_path
@pytest.mark.parametrize("D,C,gh,gw,ss", [(8, 1, 30, 130, 1), CLASSES[5]])
def test_twin_matches_the_pallas_kernel_in_interpret_mode(D, C, gh, gw, ss):
    G, z = _grid_and_z(D, C, gh, gw, ss, seed=D * 100 + ss)
    want = np.asarray(bp.slice_grid(jnp.asarray(G), jnp.asarray(z), ss,
                                    interpret=True))
    got = bgrid.slice_grid(torch.from_numpy(G), torch.from_numpy(z),
                           ss).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() / np.abs(want).max() < REL_TOL


@pytest.mark.parametrize("ss", [1, 8, 16, 17, 50])
@pytest.mark.parametrize("axis", [1, 2])
def test_upsample_axis_matches_reference(ss, axis):
    g = np.random.default_rng(ss).random((3, 5, 7)).astype(np.float32)
    want = np.asarray(ref_bg.upsample_axis(jnp.asarray(g), ss, axis=axis))
    got = bg.upsample_axis(torch.from_numpy(g), ss, axis).numpy()
    assert got.shape == want.shape
    if ss <= 16:
        assert np.array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= UPSAMPLE_TOL


def test_upsample_taps_are_the_dense_matrix_rows():
    for n_in, ss in ((5, 8), (7, 50), (1, 20), (4, 1)):
        M = ref_bg._upsample_matrix(n_in * ss, n_in, ss)
        i0, i1, w0, w1 = bg.upsample_taps(n_in, ss)
        dense = np.zeros_like(M)
        j = np.arange(n_in * ss)
        np.add.at(dense, (j, i0), w0)
        np.add.at(dense, (j, i1), w1)
        assert np.array_equal(dense, M), (n_in, ss)


# (ss, sr, C, lo, hi, detail): tests/test_bgrid_pallas.py's classes and
# its detail case
FILTERS = [
    (15, 2.0 / 31.0, 1, 0.0, 2.0, None),
    (15, 2.0 / 31.0, 3, 0.0, 2.0, None),
    (8, 0.2, 1, 0.0, 2.0, None),
    (50, 20.0, 1, 0.0, 100.0, None),
    (20, 12.0, 1, 0.0, 100.0, 0.3),
]


def _filter_inputs(C, lo, hi, detail, seed=7, h=60, w=130):
    rng = np.random.RandomState(seed)
    guide = rng.rand(h, w).astype(np.float32) * (hi - lo) + lo
    values = guide[None] if detail is not None else \
        rng.rand(C, h, w).astype(np.float32) * hi
    return guide, values


def _port_filter(guide, values, ss, sr, lo, hi, detail):
    return bg.grid_filter(torch.from_numpy(guide), torch.from_numpy(values),
                          ss, sr, lo, hi, detail=detail).numpy()


def _check(got, want):
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    scale = max(np.abs(want).max(), 1e-3)
    assert np.abs(got - want).max() / scale < REL_TOL


@pytest.mark.parametrize("ss,sr,C,lo,hi,detail", [FILTERS[1], FILTERS[4]])
def test_grid_filter_matches_the_xla_path(ss, sr, C, lo, hi, detail):
    guide, values = _filter_inputs(C, lo, hi, detail)
    want = np.asarray(ref_bg.grid_filter(jnp.asarray(guide),
                                         jnp.asarray(values), ss, sr, lo, hi,
                                         detail=detail))
    _check(_port_filter(guide, values, ss, sr, lo, hi, detail), want)


@pytest.mark.parametrize("ss,sr,C,lo,hi,detail", FILTERS)
def test_grid_filter_matches_the_pallas_path(ss, sr, C, lo, hi, detail):
    guide, values = _filter_inputs(C, lo, hi, detail)
    ref_bg._FORCE_PALLAS_INTERPRET = True
    try:
        want = np.asarray(ref_bg.grid_filter(jnp.asarray(guide),
                                             jnp.asarray(values), ss, sr, lo,
                                             hi, detail=detail))
    finally:
        ref_bg._FORCE_PALLAS_INTERPRET = False
    _check(_port_filter(guide, values, ss, sr, lo, hi, detail), want)


def test_grid_filter_pads_ragged_frames_to_whole_cells():
    guide, values = _filter_inputs(1, 0.0, 100.0, None, seed=3, h=53, w=71)
    before = bgrid.LAUNCHES
    got = _port_filter(guide, values, 10, 25.0, 0.0, 100.0, None)
    assert bgrid.LAUNCHES == before      # the twin on the CPU
    assert got.shape == (1, 53, 71) and np.isfinite(got).all()
    # a constant image stays constant, at its value rounded to bfloat16 as
    # the splat rounds it
    flat = _port_filter(np.full((53, 71), 40.0, np.float32),
                        np.full((2, 53, 71), 0.7, np.float32), 10, 25.0,
                        0.0, 100.0, None)
    assert np.abs(flat - 0.69921875).max() < 1e-6


def test_bilateral_self_matches_reference():
    x = _image((3, 40, 70), 14) * 0.6
    want = np.asarray(ref_bg.bilateral_self(jnp.asarray(x), 10, 0.25))
    got = bg.bilateral_self(torch.from_numpy(x), 10, 0.25).numpy()
    _check(got, want)


def _image(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    x[..., : shape[-2] // 3, :] += 0.5   # an edge
    return x


# the separable FIR (sigma <= 4) sums its taps in the JAX package's order;
# the IIR (sigma > 4) and the box means in their own (tests/test_torch_iir.py)
BLUR_TOL = 2e-5


@pytest.mark.parametrize("shape,sigma", [((2, 33, 47), 3.0),
                                         ((3, 48, 64), 6.5)])
def test_gaussian_blur_matches_reference(shape, sigma):
    x = _image(shape, 11)
    want = np.asarray(ref_blur.gaussian_blur(jnp.asarray(x), sigma))
    got = blur.gaussian_blur(torch.from_numpy(x), sigma).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= BLUR_TOL


@pytest.mark.parametrize("shape,sigma", [((3, 90, 130), 40.0),
                                         ((45, 61), 100.0)])
def test_gaussian_blur_fast_matches_reference(shape, sigma):
    x = _image(shape, 12)
    want = np.asarray(ref_blur.gaussian_blur_fast(jnp.asarray(x), sigma))
    got = blur.gaussian_blur_fast(torch.from_numpy(x), sigma).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= BLUR_TOL


@pytest.mark.parametrize("shape,sigma", [((40, 56), 2.0), ((2, 70, 90), 20.0)])
def test_fast_gaussian_matches_reference(shape, sigma):
    x = _image(shape, 13)
    want = np.asarray(ref_blur.fast_gaussian(jnp.asarray(x), sigma))
    got = blur.fast_gaussian(torch.from_numpy(x), sigma).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= BLUR_TOL
