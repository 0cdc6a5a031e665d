"""The port's drawn masks (`ansel_tpu_torch/pipeline/masks.py`) and the
windowed tools' planning (`ops/_maskwin.py`) against
`ansel_tpu/pipeline/masks.py` and `ansel_tpu/ops/_maskwin.py` on the
CPU: `rasterize` of each shape (config 13's forms and variants: a
proportional ellipse, a linear gradient, a rotated ellipse) and of a
group in each state (union, intersection, difference, exclusion, an
inverted member), on the whole frame and on a window at an origin;
`form_bbox`, `form_signature` and `plan_window` equal to JAX's.

Tolerance: circle, polygon, brush and group masks within 2e-6 (the
same float32 operations; torch's and XLA's sqrt round alike); the
ellipse's and the gradient's within 1e-5 (their host scalars' cos and sin
come from numpy, the JAX package's from XLA, and the gradient's erf is
XLA's own polynomial)."""

import dataclasses

import numpy as np
import pytest
import torch

from ansel_tpu.ops import _maskwin as ref_maskwin
from ansel_tpu.pipeline import masks as rm
from ansel_tpu_torch.core.types import Colorspace, ImageSpec
from ansel_tpu_torch.io import configs
from ansel_tpu_torch.ops import _maskwin
from ansel_tpu_torch.pipeline import masks as pm

torch.set_num_threads(1)

EXACT_TOL = 2e-6
TRIG_TOL = 1e-5
H, W = 60, 96
FORMS = configs.FORMS13
EXTRA = {
    # a proportional ellipse turned 70 degrees, a linear gradient
    401: (configs.ELLIPSE, ((0.5, 0.5, 0.2, 0.1, 70.0, 0.3, 1),), (0, 0)),
    402: (configs.GRADIENT, ((0.4, 0.5, 30.0, 0.3, 0.0, 0.4, 0),), (0, 0)),
}
STATES = {"union": configs.UNION, "intersection": 1 << 4,
          "difference": configs.DIFFERENCE, "exclusion": 1 << 6}


def _forms(pkg_form, extra=()):
    table = {**FORMS, **EXTRA}
    for fid, t, nodes in extra:
        table[fid] = (t, nodes, (0.0, 0.0))
    return {fid: pkg_form(id=fid, type=t, name="f", nodes=list(nodes),
                          src=src)
            for fid, (t, nodes, src) in table.items()}


def _group(state, inverse=False):
    """Circle 103 then the polygon 104 in `state` (the second member
    inverted when `inverse`)."""
    s = STATES[state] | (1 << 2 if inverse else 0) | 3
    return [(500, configs.GROUP, ((103, 500, 3 | configs.UNION, 1.0),
                                  (104, 500, s, 0.8)))]


def _raster(fid, extra, h, w, origin):
    pf, rf = _forms(pm.Form, extra), _forms(rm.Form, extra)
    got = pm.rasterize(pf[fid], pf, h, w, norm_h=H, norm_w=W, origin=origin)
    want = np.asarray(rm.rasterize(rf[fid], rf, h, w, norm_h=H, norm_w=W,
                                   origin=origin))
    return got.numpy(), want


SHAPES = sorted(set(FORMS) | set(EXTRA))


@pytest.mark.parametrize("window", [False, True], ids=["frame", "window"])
@pytest.mark.parametrize("fid", SHAPES)
def test_rasterize_matches_reference(fid, window):
    h, w, origin = (24, 40, (17, 29)) if window else (H, W, (0, 0))
    got, want = _raster(fid, (), h, w, origin)
    t = {**FORMS, **EXTRA}[fid][0]
    tol = TRIG_TOL if t in (configs.ELLIPSE, configs.GRADIENT) else EXACT_TOL
    assert got.shape == want.shape == (h, w)
    assert np.abs(got - want).max() <= tol
    assert 0.0 <= got.min() and got.max() <= 1.0


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("state", sorted(STATES))
def test_group_states_match_reference(state, inverse):
    got, want = _raster(500, _group(state, inverse), H, W, (0, 0))
    assert np.abs(got - want).max() <= EXACT_TOL
    got_w, _ = _raster(500, _group(state, inverse), 20, 30, (10, 40))
    assert np.abs(got_w - got[10:30, 40:70]).max() <= EXACT_TOL


def test_shapes_cover_something():
    """Each of config 13's forms leaves a mask inside the frame."""
    pf = _forms(pm.Form)
    for fid in FORMS:
        m = pm.rasterize(pf[fid], pf, H, W)
        assert m.max().item() > 0.5, fid


@pytest.mark.parametrize("fid", SHAPES + [500])
def test_form_bbox_and_signature_match_reference(fid):
    extra = _group("difference")
    pf, rf = _forms(pm.Form, extra), _forms(rm.Form, extra)
    assert pm.form_bbox(pf[fid], pf, H, W) == rm.form_bbox(rf[fid], rf, H, W)
    assert pm.form_signature(pf[fid], pf) == rm.form_signature(rf[fid], rf)


def test_form_signature_moves_with_a_node():
    pf = _forms(pm.Form)
    moved = dict(pf)
    n = pf[103].nodes[0]
    moved[103] = dataclasses.replace(pf[103], nodes=[(n[0] + 0.01,) + n[1:]])
    assert pm.form_signature(pf[106], pf) != pm.form_signature(moved[106],
                                                               moved)


@pytest.mark.parametrize("fid,dy,dx,margin", [
    (201, 4, 3, 16), (203, -3, 5, 16), (301, 0, 0, 30), (302, 2, -2, 16),
    (106, 0, 0, 16), (101, 0, 0, 16), (102, 50, 0, 16)])
def test_plan_window_matches_reference(fid, dy, dx, margin):
    from ansel_tpu.core import types as ref_types

    spec = ImageSpec(width=W, height=H, colorspace=Colorspace.WORK_RGB,
                     channels=3)
    rspec = ref_types.ImageSpec(width=W, height=H,
                                colorspace=ref_types.Colorspace.WORK_RGB,
                                channels=3)
    pf, rf = _forms(pm.Form), _forms(rm.Form)
    assert _maskwin.plan_window(pf[fid], pf, spec, dy, dx, margin) == \
        ref_maskwin.plan_window(rf[fid], rf, rspec, dy, dx, margin)


def test_apply_windowed_pastes_into_a_copy():
    pf = _forms(pm.Form)
    spec = ImageSpec(width=W, height=H, colorspace=Colorspace.WORK_RGB,
                     channels=3)
    x = torch.rand((3, H, W), generator=torch.Generator().manual_seed(0))
    win = _maskwin.plan_window(pf[201], pf, spec, 4, 3)
    y = _maskwin.apply_windowed(x, pf[201], pf, spec, win,
                                lambda d, s, m: d + m[None], 4, 3)
    y0, y1, x0, x1 = win
    m = pm.rasterize(pf[201], pf, y1 - y0, x1 - x0, norm_h=H, norm_w=W,
                     origin=(y0, x0))
    assert torch.equal(y[:, y0:y1, x0:x1], x[:, y0:y1, x0:x1] + m[None])
    outside = torch.ones((H, W), dtype=torch.bool)
    outside[y0:y1, x0:x1] = False
    assert torch.equal(y[:, outside], x[:, outside])
