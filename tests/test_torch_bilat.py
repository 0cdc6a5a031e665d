"""The port's local Laplacian and bilat against ansel_tpu on the CPU: the
remap curve, the pyramid filter at several depths and parameters, the
bilat op on a Lab image, and plan and legacy params bit for bit.  Inputs
come from numpy seeds and go to both packages as the same float32
arrays."""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ansel_tpu.core import types as ref_types
from ansel_tpu.ops import base as ref_base
from ansel_tpu.ops import bilat as ref_bilat
from ansel_tpu.pixel import locallaplacian as ref_ll
from ansel_tpu_torch.core import types as port_types
from ansel_tpu_torch.kernels import sepblur
from ansel_tpu_torch.ops import base as port_base
from ansel_tpu_torch.ops import bilat as port_bilat
from ansel_tpu_torch.pixel import locallaplacian as ll

torch.set_num_threads(2)

# the same float32 operations in the same order; XLA's CPU code may fuse
# a product into the following sum, and the collapse adds up to ten
# levels: measured 4.8e-7 on L in [0, 1]
LL_TOL = 2e-6
# bilat's L is the filter's output times 100
BILAT_TOL = 2e-4


def _luminance(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    L = 0.5 + 0.3 * np.sin(xx / 7.0) * np.cos(yy / 11.0)
    L += rng.normal(0.0, 0.05, (h, w))
    L[h // 3: h // 2, w // 4: w // 2] += 0.3   # an edge
    return np.clip(L, 0.0, 1.0).astype(np.float32)


def test_curve_matches_reference():
    x = np.linspace(-0.5, 1.5, 4001, dtype=np.float32)
    for g in (0.0833333, 0.25, 0.9166667):
        g32 = float(np.float32(g))
        want = np.asarray(ref_ll.curve(jnp.asarray(x), jnp.float32(g32), 0.2,
                                       1.5, 0.7, 0.3))
        got = ll.curve(torch.from_numpy(x), g32, 0.2, 1.5, 0.7, 0.3).numpy()
        assert np.abs(got - want).max() <= 1e-6


@pytest.mark.parametrize("hw,args", [
    ((64, 96), (0.5, 1.0, 1.0, 0.3)),      # config 3's bilat
    ((37, 53), (0.2, 0.5, 1.5, -0.2)),     # odd sides
    ((130, 70), (0.35, 1.2, 0.8, 0.6)),
    ((5, 9), (0.5, 1.0, 1.0, 0.3)),        # the 2-level floor
])
def test_local_laplacian_matches_reference(hw, args):
    L = _luminance(*hw, seed=hw[0])
    want = np.asarray(ref_ll.local_laplacian(jnp.asarray(L), *args))
    before = sepblur.LAUNCHES
    got = ll.local_laplacian(torch.from_numpy(L), *args).numpy()
    assert sepblur.LAUNCHES == before
    assert got.shape == want.shape == L.shape
    assert np.abs(got - want).max() <= LL_TOL


def _pair(params, h=48, w=72):
    out = []
    for types, base, mod in ((ref_types, ref_base, ref_bilat),
                             (port_types, port_base, port_bilat)):
        ctx = base.PlanContext(meta=types.RawMeta(width=w, height=h))
        spec = types.ImageSpec(width=w, height=h,
                               colorspace=types.Colorspace.LAB)
        op, p = mod.Bilat(), mod.BilatParams(**params)
        out.append((op, ctx, op.plan(ctx, spec, p)))
    return out


@pytest.mark.parametrize("params", [
    dict(sigma_r=100.0, sigma_s=100.0, detail=0.3),   # config 3
    dict(sigma_r=40.0, sigma_s=150.0, detail=-0.25, midtone=0.3),
])
def test_bilat_matches_reference(params):
    (rop, rctx, rplan), (pop, pctx, pplan) = _pair(params)
    assert pplan.static == rplan.static
    rng = np.random.default_rng(9)
    lab = np.stack([100.0 * _luminance(48, 72, 2),
                    rng.uniform(-30, 30, (48, 72)),
                    rng.uniform(-30, 30, (48, 72))]).astype(np.float32)
    want = np.asarray(rop.apply(jnp.asarray(lab), None, rplan, rctx))
    got = pop.apply(torch.from_numpy(lab), None, pplan, pctx).numpy()
    assert np.abs(got - lab).max() > 0.1   # it changed L
    assert np.array_equal(got[1:], lab[1:])
    assert np.abs(got - want).max() <= BILAT_TOL


def test_bilateral_grid_is_refused_at_plan_time():
    """Mode 0, the bilateral grid, is no longer refused: it plans as the
    reference does and matches it (the grid on L with the detail slicing,
    a and b untouched)."""
    (rop, rctx, rplan), (pop, pctx, pplan) = _pair(dict(
        mode=port_bilat.MODE_BILATERAL, sigma_r=20.0, sigma_s=50.0,
        detail=0.25))
    assert pplan.static == rplan.static
    rng = np.random.default_rng(10)
    lab = np.stack([100.0 * _luminance(48, 72, 3),
                    rng.uniform(-30, 30, (48, 72)),
                    rng.uniform(-30, 30, (48, 72))]).astype(np.float32)
    want = np.asarray(rop.apply(jnp.asarray(lab), None, rplan, rctx))
    got = pop.apply(torch.from_numpy(lab), None, pplan, pctx).numpy()
    assert np.abs(got - lab).max() > 0.1   # it changed L
    assert np.array_equal(got[1:], lab[1:])
    assert np.abs(got - want).max() <= BILAT_TOL


@pytest.mark.parametrize("version,raw", [
    (1, struct.pack("<3f", 20.0, 30.0, 0.4)),
    (2, struct.pack("<I3f", 1, 20.0, 30.0, 0.4)),
])
def test_legacy_params_decode_like_reference(version, raw):
    ref = ref_bilat.BilatParams.from_legacy(version, raw)
    got = port_bilat.BilatParams.from_legacy(version, raw)
    assert [getattr(got, f) for f in vars(ref)] == list(vars(ref).values())
