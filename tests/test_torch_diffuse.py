"""The port's diffuse iteration and op against ansel_tpu on the CPU: the
plain twin against the Pallas kernel in interpret mode over the full
frame (1-5 scales, the three isotropy modes mixed across the four
kernels, frames smaller than the halo), the op against the JAX CPU op in
the interior and against the scalar mirror of diffuse.c, and plan and
coefficients bit for bit.  Inputs come from numpy seeds and go to both
packages as the same float32 arrays."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ansel_tpu.core import types as ref_types
from ansel_tpu.kernels.diffuse_pallas import diffuse_iteration_pallas
from ansel_tpu.ops import base as ref_base
from ansel_tpu.ops import diffuse as ref_diffuse
from ansel_tpu_torch.core import types as port_types
from ansel_tpu_torch.kernels import diffuse, sepblur
from ansel_tpu_torch.ops import base as port_base
from ansel_tpu_torch.ops import diffuse as port_diffuse
from ansel_tpu_torch.pipeline import engine
from tests.mirrors.diffuse_ref import heat_pde_diffusion

torch.set_num_threads(2)

# twin vs Pallas: the same float32 operations in the same order; the
# Pallas interpreter's XLA CPU code may fuse a product into the following
# sum, and 1 / energy amplifies that: measured 8.3e-6 at 5 scales on
# values in [0, 1]
PALLAS_TOL = 2e-5
# the op vs the JAX CPU op in the interior: the XLA path splits the 3x3
# stencil and the energy sum otherwise and divides by the energy where
# the kernel multiplies by its inverse (ansel_tpu's own test holds the
# two within 1e-5, tests/test_heavy_ops.py:119)
XLA_TOL = 1e-5
# the scalar float64 mirror of heat_PDE_diffusion, as ansel_tpu's own
# test holds its XLA step (tests/test_heavy_ops.py:155)
MIRROR_TOL = 5e-5

# (scales, modes, frame): every mode in every kernel slot across the
# cases; the last two frames are smaller than the 3 (2^S - 1) halo
TWIN_CASES = [
    (1, (0, 0, 0, 0), (40, 56)),
    (2, (1, 2, 0, 1), (37, 50)),
    (3, (2, 0, 1, 0), (30, 70)),
    (4, (1, 1, 2, 2), (50, 61)),
    (5, (0, 0, 0, 0), (48, 72)),
    (5, (0, 2, 2, 1), (20, 33)),
    (3, (2, 1, 0, 2), (9, 14)),
]


def _coeffs(scales, seed):
    rng = np.random.default_rng(seed)
    return {
        "aniso": np.float32([1.5, 0.7, 2.0, 0.3]),
        "ABCD": rng.uniform(-0.05, 0.05, (scales, 4)).astype(np.float32),
        "strength": rng.uniform(0.9, 1.2, scales).astype(np.float32),
        "norm_reg": rng.uniform(0.1, 0.5, scales).astype(np.float32),
        "variance_threshold": np.float32(0.05),
        "threshold": np.float32(0.0),
    }


def _tensors(c):
    return {k: torch.as_tensor(v) for k, v in c.items()}


@pytest.mark.parametrize("scales,modes,hw", TWIN_CASES)
def test_diffuse_twin_matches_pallas_full_frame(scales, modes, hw):
    rng = np.random.default_rng(scales * 10 + hw[0])
    x = rng.uniform(0.05, 0.9, (3,) + hw).astype(np.float32)
    c = _coeffs(scales, hw[1])
    want = np.asarray(diffuse_iteration_pallas(jnp.asarray(x), c, scales,
                                               modes, interpret=True))
    got = diffuse.diffuse_iteration(torch.from_numpy(x), _tensors(c), scales,
                                    modes).numpy()
    assert got.shape == want.shape == x.shape
    assert np.abs(got - want).max() <= PALLAS_TOL


def _pair(params, h=96, w=256):
    """Both packages' diffuse op planned on an h x w work-RGB frame."""
    out = []
    for types, base, mod in ((ref_types, ref_base, ref_diffuse),
                             (port_types, port_base, port_diffuse)):
        ctx = base.PlanContext(meta=types.RawMeta(width=w, height=h))
        spec = types.ImageSpec(width=w, height=h,
                               colorspace=types.Colorspace.WORK_RGB)
        op, p = mod.Diffuse(), mod.DiffuseParams(**params)
        plan = op.plan(ctx, spec, p)
        out.append((op, ctx, plan, op.coeffs(ctx, plan, p)))
    return out


OP_CASES = {
    "iso-2-scales": dict(iterations=2, radius=1, first=0.1, second=-0.05,
                         third=0.1, fourth=0.05, sharpness=0.1,
                         regularization=1.0),
    "isophote": dict(iterations=1, radius=2, first=0.1, second=-0.05,
                     third=0.1, fourth=0.05, regularization=1.0,
                     anisotropy_first=2.0, anisotropy_second=2.0,
                     anisotropy_third=-2.0),
    "gradient-mask": dict(iterations=1, radius=2, first=0.2, second=0.1,
                          third=-0.1, fourth=0.1, variance_threshold=0.5,
                          anisotropy_first=-2.0, anisotropy_fourth=1.0,
                          threshold=0.5),
    "config3": dict(iterations=4, first=0.2, second=0.2, third=0.2,
                    fourth=0.2, radius=8),
}


@pytest.mark.parametrize("name", sorted(OP_CASES))
def test_diffuse_plan_and_coeffs_equal_reference(name):
    (_, _, rplan, rc), (_, _, pplan, pc) = _pair(OP_CASES[name])
    assert pplan.static == rplan.static
    assert sorted(pc) == sorted(rc)
    for k in pc:
        assert np.array_equal(np.asarray(pc[k]), np.asarray(rc[k])), k


@pytest.mark.parametrize("name", ["iso-2-scales", "isophote",
                                  "gradient-mask"])
def test_diffuse_op_matches_jax_cpu_op_interior(name):
    (rop, rctx, rplan, rc), (pop, pctx, pplan, pc) = _pair(OP_CASES[name])
    rng = np.random.default_rng(3)
    x = rng.uniform(0.05, 0.9, (3, 96, 256)).astype(np.float32)
    want = np.asarray(rop.apply(jnp.asarray(x), rc, rplan, rctx))
    c = engine.coeffs_to_device([pc], "cpu")[0]
    got = pop.apply(torch.from_numpy(x), c, pplan, pctx).numpy()
    assert np.abs(got - x).max() > 1e-3   # it diffused
    halo = diffuse.halo(pplan.static[0])
    ring = (slice(None), slice(halo, -halo), slice(halo, -halo))
    assert np.abs(got[ring] - want[ring]).max() <= XLA_TOL


@pytest.mark.parametrize("modes", [(1, 0, 2, 1), (0, 0, 0, 0),
                                   (2, 2, 1, 0)])
def test_diffuse_one_scale_matches_reference_mirror(modes):
    """A 1-scale iteration is the B3 decompose and one PDE step:
    held against the scalar float64 transcription of diffuse.c's
    heat_PDE_diffusion on the same LF/HF split, away from the 3-px
    ring where the mirror clamps its stencil."""
    rng = np.random.default_rng(42)
    x = rng.uniform(0.05, 1.0, (3, 16, 24)).astype(np.float32)
    c = _coeffs(1, 7)
    got = diffuse.diffuse_iteration(torch.from_numpy(x), _tensors(c), 1,
                                    modes).numpy()
    lf = sepblur.sep_blur_reference(torch.from_numpy(x),
                                    diffuse.B3).numpy()
    want = heat_pde_diffusion(
        (x - lf).astype(np.float64), lf.astype(np.float64), c["aniso"],
        modes, float(c["variance_threshold"]), 1, float(c["norm_reg"][0]),
        c["ABCD"][0], float(c["strength"][0]))
    ring = (slice(None), slice(3, -3), slice(3, -3))
    assert np.abs(got[ring] - want[ring]).max() <= MIRROR_TOL


def test_diffuse_refuses_more_than_five_scales():
    with pytest.raises(NotImplementedError):
        _pair(dict(radius=12))


def test_diffuse_legacy_v1_decodes_like_reference():
    import struct

    raw = struct.pack("<ififf4ff4f", 3, 0.5, 6, 0.2, 0.1, 1.0, -1.0, 0.5,
                      0.0, 0.3, 0.1, 0.2, -0.1, 0.05)
    ref = ref_diffuse.DiffuseParams.from_legacy(1, raw)
    got = port_diffuse.DiffuseParams.from_legacy(1, raw)
    assert [getattr(got, f) for f in vars(ref)] == list(vars(ref).values())


def test_wrapper_runs_the_twin_on_cpu_and_refuses_other_devices():
    x = torch.rand((3, 20, 30))
    c = _tensors(_coeffs(2, 1))
    before = diffuse.LAUNCHES
    assert torch.equal(diffuse.diffuse_iteration(x, c, 2, (0, 1, 2, 0)),
                       diffuse.diffuse_iteration_reference(x, c, 2,
                                                           (0, 1, 2, 0)))
    assert diffuse.LAUNCHES == before
    with pytest.raises(ValueError):
        diffuse.diffuse_iteration(torch.zeros((3, 8, 8), device="meta"), c,
                                  2, (0, 0, 0, 0))
