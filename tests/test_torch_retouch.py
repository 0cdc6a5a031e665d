"""The port's healing and retouching (`pixel/heal.py`, `ops/spots.py`,
`ops/retouch.py`, `pixel/wavelets.atrous_*`, `ops/hidden.py`) against
the JAX package's on the CPU, on config 13's forms: the Poisson heal;
spots with two heals and a clone; retouch at 4 scales (a heal on the
image, a blur on scale 2, a fill on the residual), at 0 scales (every
tool on the image, one without a window) and with a clone source; the
a-trous decompose and its reconstruction; and the two identity modules.

Tolerances: heal and the tools on the image within 2e-6 (the same
float32 operations in the same order); retouch at 4 scales within 1e-5
(its blur of radius 6 runs through each package's Deriche IIR)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ansel_tpu.ops  # noqa: F401  (registers the JAX package's ops)
from ansel_tpu.core import types as ref_types
from ansel_tpu.ops import base as ref_base
from ansel_tpu.ops import retouch as ref_retouch
from ansel_tpu.ops import spots as ref_spots
from ansel_tpu.pipeline import masks as rm
from ansel_tpu.pixel import heal as ref_heal
from ansel_tpu.pixel import wavelets as ref_wavelets
from ansel_tpu_torch.core.types import Colorspace, ImageSpec, RawMeta
from ansel_tpu_torch.io import configs
from ansel_tpu_torch.ops import base, retouch, spots
from ansel_tpu_torch.pipeline import masks as pm
from ansel_tpu_torch.pixel import heal, wavelets

torch.set_num_threads(1)

EXACT_TOL = 2e-6
IIR_TOL = 1e-5
H, W = 96, 160


def _image(seed=0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W] / np.float32(W)
    smooth = np.stack([0.3 + 0.4 * x, 0.2 + 0.5 * y, 0.5 - 0.2 * x * y])
    return (smooth + 0.05 * rng.standard_normal((3, H, W))).astype(
        np.float32)


def _ctx(pkg_base, pkg_types, form_cls):
    meta = (RawMeta if pkg_base is base else ref_types.RawMeta)(
        width=W, height=H)
    ctx = pkg_base.PlanContext(meta=meta)
    ctx.notes["forms"] = configs.forms13(form_cls)
    spec = pkg_types.ImageSpec(width=W, height=H,
                               colorspace=pkg_types.Colorspace.WORK_RGB,
                               channels=3)
    return ctx, spec


def _run(name, p_port, p_ref, x):
    """(port output, JAX output, port plan static, JAX plan static)."""
    import ansel_tpu_torch.core.types as port_types

    ctx, spec = _ctx(base, port_types, pm.Form)
    rctx, rspec = _ctx(ref_base, ref_types, rm.Form)
    op, rop = base.get_op(name), ref_base.get_op(name)
    plan, rplan = op.plan(ctx, spec, p_port), rop.plan(rctx, rspec, p_ref)
    got = op.apply(torch.from_numpy(x), None, plan, ctx).numpy()
    want = np.asarray(jax.jit(lambda v: rop.apply(v, None, rplan, rctx))(
        jnp.asarray(x)))
    return got, want, plan.static, rplan.static


def test_heal_matches_reference():
    rng = np.random.default_rng(2)
    dst = _image(1)[:, :40, :56]
    src = _image(2)[:, :40, :56]
    m = np.zeros((40, 56), np.float32)
    m[10:30, 12:44] = rng.uniform(0.3, 1.0, (20, 32))
    got = heal.heal(torch.from_numpy(dst), torch.from_numpy(src),
                    torch.from_numpy(m)).numpy()
    want = np.asarray(jax.jit(ref_heal.heal)(dst, src, m))
    assert np.abs(got - want).max() <= EXACT_TOL


def test_spots_match_reference():
    x = _image()
    got, want, static, rstatic = _run(
        "spots", configs.spots_params13(spots.SpotsParams),
        configs.spots_params13(ref_spots.SpotsParams), x)
    assert static == rstatic and len(static) == 3
    assert all(c[5] is not None for c in static)   # each on its window
    assert np.abs(got - want).max() <= EXACT_TOL
    assert np.abs(got - x).max() > 1e-2


def _retouch_params(cls, pack, num_scales, recs):
    blob = b"".join(pack(*r[:3], **r[3]) for r in recs)
    blob += b"\0" * (len(cls().rt_forms) - len(blob))
    return cls(rt_forms=blob, num_scales=num_scales)


RETOUCH = {
    "config13": None,
    "image-only": (0, [(301, 0, 2, {}), (203, 0, 1, {}),
                       (302, 0, 3, {"blur_radius": 2.0}),
                       (106, 0, 4, {"fill_mode": 0})]),
    "scales-clone": (3, [(203, 1, 1, {}), (301, 2, 2, {}),
                         (303, 4, 4, {"fill_mode": 1,
                                      "fill_color": (0.1, 0.2, 0.3)})]),
}


@pytest.mark.parametrize("case", sorted(RETOUCH))
def test_retouch_matches_reference(case):
    x = _image(3)
    if RETOUCH[case] is None:
        p = configs.retouch_params13(retouch.RetouchParams, retouch.pack_form)
        rp = configs.retouch_params13(ref_retouch.RetouchParams,
                                      ref_retouch.pack_form)
    else:
        n, recs = RETOUCH[case]
        p = _retouch_params(retouch.RetouchParams, retouch.pack_form, n,
                            recs)
        rp = _retouch_params(ref_retouch.RetouchParams,
                             ref_retouch.pack_form, n, recs)
    assert p.codec.encode(p) == rp.codec.encode(rp)
    got, want, static, rstatic = _run("retouch", p, rp, x)
    assert static == rstatic
    tol = IIR_TOL if case == "config13" else EXACT_TOL
    assert np.abs(got - want).max() <= tol
    assert np.abs(got - x).max() > 1e-2


@pytest.mark.parametrize("hw", [(H, W), configs.FRAMES[13]])
def test_retouch_config13_plan_matches_reference(hw):
    """At 96 x 160 the scale edits' union window (with its a-trous reach)
    covers over half the frame, so they decompose the whole frame; at 24
    MP they decompose a window.  Each image tool has its window."""
    h, w = hw
    ctx = base.PlanContext(meta=RawMeta(width=w, height=h))
    ctx.notes["forms"] = configs.forms13(pm.Form)
    rctx = ref_base.PlanContext(meta=ref_types.RawMeta(width=w, height=h))
    rctx.notes["forms"] = configs.forms13(rm.Form)
    spec = ImageSpec(width=w, height=h, colorspace=Colorspace.WORK_RGB)
    rspec = ref_types.ImageSpec(width=w, height=h,
                                colorspace=ref_types.Colorspace.WORK_RGB)
    p = configs.retouch_params13(retouch.RetouchParams, retouch.pack_form)
    rp = configs.retouch_params13(ref_retouch.RetouchParams,
                                  ref_retouch.pack_form)
    static = base.get_op("retouch").plan(ctx, spec, p).static
    assert static == ref_base.get_op("retouch").plan(rctx, rspec, rp).static
    num_scales, recs, wv_win = static
    assert num_scales == 4 and [r[2] for r in recs] == [0, 2, 5]
    assert (wv_win is None) == (hw == (H, W))
    assert recs[0][9] is not None


@pytest.mark.parametrize("scales", [1, 4])
def test_atrous_decompose_matches_reference(scales):
    x = _image(4)
    details, residual = wavelets.atrous_decompose(torch.from_numpy(x),
                                                  scales)
    rdetails, rresidual = ref_wavelets.atrous_decompose(x, scales)
    for d, r in zip(details + [residual], list(rdetails) + [rresidual]):
        assert np.abs(d.numpy() - np.asarray(r)).max() <= EXACT_TOL
    back = wavelets.atrous_reconstruct(details, residual).numpy()
    assert np.abs(back - x).max() <= 1e-5


@pytest.mark.parametrize("name", ["gamma", "mask_manager"])
def test_hidden_modules_are_identities(name):
    op = base.get_op(name)
    rop = ref_base.get_op(name)
    cls = type(op.default_params(None))
    assert cls.codec.encode(cls()) == type(rop.default_params(None)).codec \
        .encode(type(rop.default_params(None))())
    x = torch.from_numpy(_image(5))
    spec = ImageSpec(width=W, height=H, colorspace=Colorspace.WORK_RGB)
    plan = op.plan(base.PlanContext(meta=RawMeta(width=W, height=H)), spec,
                   cls())
    assert torch.equal(op.apply(x, None, plan, None), x)
