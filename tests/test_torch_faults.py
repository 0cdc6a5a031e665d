"""The repairs of the port's faults F4-F6 against ansel_tpu on the CPU.

F4: a raw's orientation.  flip is injected for an orientation other than
0 and 1, as the JAX package injects it; the planned ops, the output
shape and the pixels equal the JAX package's for orientations 0, 1, 3, 6
and 8 with an empty history and with an explicit flip item of each of
the eight orientation values; and the port's `resolve_history` names the
same ops as JAX's for a Bayer and an X-Trans raw at orientations 1 and 6.
F5: an op the JAX package does not register (a module of a newer
darktable) is skipped into `Pipeline.unsupported`, as there.
F6: the NLM twin at the lattices the card's kernel now takes in chunks
(K 15 and 20: 961 and 1681 offsets) and at patch radii above the
kernel's template limit (P 9 and 12), against the JAX package's XLA
path (`pixel/nlmeans.nlmeans(..., force_xla=True)`).
F7 (ROADMAP R14): a blend that would read the raw-detail plane or a
raster mask on another frame than its own is refused while planning,
where the JAX package fails at run time on the same history.

Tolerances: whole pipes within the display quantum 1/255 of the JAX
package with its RCD as the TPU runs it (the Pallas kernel in interpret
mode; its CPU RCD differs on a ~4 px border); NLM within NLM_TOL on the
interior (the XLA path edge-pads the patch distances where the kernel
and its twin clamp the image, which differs on a ring of P px, R7)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ansel_tpu
import ansel_tpu_torch
from ansel_tpu.io.synthetic import synth_raw
from ansel_tpu.ops.base import all_ops as ref_all_ops
from ansel_tpu.pipeline import engine as ref_engine
from ansel_tpu.pixel import nlmeans as ref_nlmeans
from ansel_tpu_torch.io import configs
from ansel_tpu_torch.kernels import nlm
from ansel_tpu_torch.ops import base as port_base
from ansel_tpu_torch.pipeline import engine
from ansel_tpu_torch.pixel.nlmeans import search_offsets

torch.set_num_threads(2)

DISPLAY_QUANTUM = 1.0 / 255.0
# the twin sums each offset's patch distances as the kernel does (column
# sums, then rows) where the XLA path box-sums them through cumulative
# sums, so a weight's last bits differ and the differences add up over the
# lattice: measured 5.7e-6 at K 20 (1681 offsets), 3.6e-7 at P 9, on
# values in [0.2, 0.9]
NLM_TOL = 1e-5
H, W = 64, 96
ORIENTATIONS = (0, 1, 3, 6, 8)


@pytest.fixture(scope="module")
def pallas_rcd():
    """ansel_tpu's RCD as the TPU runs it: the Pallas kernel in interpret
    mode (its CPU RCD differs on a ~4 px border)."""
    from ansel_tpu.kernels import rcd as ref_rcd
    from ansel_tpu.kernels import rcd_pallas

    mp = pytest.MonkeyPatch()
    mp.setattr(ref_rcd, "rcd_demosaic",
               lambda x, cfa, s: rcd_pallas.rcd_demosaic_pallas(
                   x, cfa, s, interpret=True))
    ref_engine._COMPILE_CACHE.clear()
    yield
    mp.undo()
    ref_engine._COMPILE_CACHE.clear()


@pytest.fixture(scope="module")
def frame():
    return synth_raw(h=H, w=W, kind="gradients")


def _render(meta, items):
    """(the port's Pipeline, the JAX package's) of `items` on `meta`."""
    port = ansel_tpu_torch.Pipeline(
        meta, [ansel_tpu_torch.HistoryItem(op, dict(p)) for op, p in items],
        device="cpu")
    ref = ansel_tpu.Pipeline(
        meta, [ansel_tpu.HistoryItem(op, dict(p)) for op, p in items])
    return port, ref


# --- F4: the orientation ---------------------------------------------------

def _orientation_case(frame, pallas_rcd, orientation, items):
    raw, meta, _ = frame
    meta = dataclasses.replace(meta, orientation=orientation)
    port, ref = _render(meta, items)
    names = [s.name for s in port.stages]
    assert names == [s.name for s in ref.stages]
    assert [s.plan.static for s in port.stages] == \
        [s.plan.static for s in ref.stages]
    got = engine.CompiledPipe(port).output_array(raw)
    want = np.asarray(ref_engine.CompiledPipe(ref).output_array(raw))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= DISPLAY_QUANTUM
    return names, got.shape


@pytest.mark.parametrize("orientation", ORIENTATIONS)
def test_orientation_of_an_empty_history(frame, pallas_rcd, orientation):
    names, shape = _orientation_case(frame, pallas_rcd, orientation, [])
    assert ("flip" in names) == (orientation not in (0, 1))
    swapped = orientation in (5, 6, 7, 8)
    assert shape == ((3, W, H) if swapped else (3, H, W))


@pytest.mark.parametrize("value", range(8))
def test_explicit_flip_item(frame, pallas_rcd, value):
    """An explicit orientation overrides the raw's, which runs through
    ORIENTATIONS across the eight values."""
    orientation = ORIENTATIONS[value % len(ORIENTATIONS)]
    names, shape = _orientation_case(
        frame, pallas_rcd, orientation,
        [("flip", {"orientation": value}), ("exposure", {"exposure": 0.5})])
    assert "flip" in names
    assert shape == ((3, W, H) if value & 4 else (3, H, W))


@pytest.mark.parametrize("xtrans", [False, True], ids=["bayer", "xtrans"])
@pytest.mark.parametrize("orientation", [1, 6])
def test_resolve_history_names_the_reference_ops(frame, xtrans,
                                                 orientation):
    """Every op either package injects for this raw: a default-enabled op
    of the JAX package that the port lacked would be dropped in silence."""
    _, meta, _ = frame
    meta = dataclasses.replace(
        meta, orientation=orientation,
        xtrans=configs.XTRANS6 if xtrans else None)
    port = [h.op for h in engine.resolve_history(meta, [])]
    ref = [h.op for h in ref_engine.resolve_history(meta, [])]
    assert port == ref
    assert ("flip" in port) == (orientation == 6)


# --- F5: ops the JAX package does not register ------------------------------

def test_reference_ops_are_the_reference_registry():
    assert port_base.REFERENCE_OPS == frozenset(ref_all_ops())
    assert set(port_base.all_ops()) <= port_base.REFERENCE_OPS


@pytest.mark.parametrize("op", ["sigmoid", "agx"])
def test_an_unknown_op_is_skipped(frame, pallas_rcd, op):
    raw, meta, _ = frame
    items = [(op, {}), ("exposure", {"exposure": 0.5})]
    port, ref = _render(meta, items)
    assert port.unsupported == ref.unsupported == [op]
    assert [s.name for s in port.stages] == [s.name for s in ref.stages]
    got = engine.CompiledPipe(port).output_array(raw)
    want = np.asarray(ref_engine.CompiledPipe(ref).output_array(raw))
    assert np.abs(got - want).max() <= DISPLAY_QUANTUM
    plain = ansel_tpu_torch.compile_pipeline(
        meta, [ansel_tpu_torch.HistoryItem("exposure", {"exposure": 0.5})],
        device="cpu").output_array(raw)
    assert np.array_equal(got, plain)


def test_an_unported_reference_op_is_still_refused(frame, monkeypatch):
    """Every op of the JAX package is ported (rawdenoiseai the last;
    lut3d and relight before it), so the refusal of a reference op the
    port does not register is held with one taken out of the registry:
    the planner raises rather than skip it into `unsupported`.  With the
    registry whole the same item plans."""
    from ansel_tpu_torch.ops import base as ops_base

    _, meta, _ = frame
    items = [ansel_tpu_torch.HistoryItem("rawdenoiseai", {})]
    pipe = ansel_tpu_torch.Pipeline(meta, items, device="cpu")
    assert "rawdenoiseai" in [s.name for s in pipe.stages]
    assert not pipe.unsupported
    monkeypatch.delitem(ops_base._OPS, "rawdenoiseai")
    with pytest.raises(NotImplementedError, match="rawdenoiseai"):
        ansel_tpu_torch.Pipeline(meta, items, device="cpu")


# --- F7: R14, side planes on another frame ---------------------------------

def _details_item(pkg, bl):
    """Config 13's vibrance: an L range refined by the details slider."""
    return [pkg.HistoryItem("vibrance", {"amount": 40.0},
                            blend_params=bl.BlendParams(
                                **configs.BLENDS13[11][1]))]


def _raster_items(pkg, bl, crop=True):
    """An exposure instance with a uniform mask, read as colour
    contrast's raster source (config 13's blend), a crop between them."""
    items = [pkg.HistoryItem("exposure", {"exposure": 0.7}, multi_priority=1,
                             blend_params=bl.BlendParams(mask_mode=1,
                                                         opacity=60.0)),
             pkg.HistoryItem("colorcontrast", {},
                             blend_params=bl.BlendParams(
                                 **configs.BLENDS13[12][1]))]
    if crop:
        items.insert(1, pkg.HistoryItem(
            "crop", {"cx": 0.1, "cy": 0.1, "cw": 0.8, "ch": 0.9}))
    return items


R14_CASES = {
    "details-orientation-6": (_details_item, {"orientation": 6}, {},
                              ("vibrance", "flip")),
    "details-scale-0.5": (_details_item, {}, {"scale": 0.5},
                          ("vibrance", "initialscale")),
    "raster-crop": (_raster_items, {}, {}, ("colorcontrast", "crop")),
}


@pytest.fixture(scope="module")
def frame96():
    return synth_raw(h=96, w=160, kind="gradients")


@pytest.mark.parametrize("case", sorted(R14_CASES))
def test_r14_refused_at_plan_time_where_the_jax_package_fails(
        frame96, case, monkeypatch):
    """A details-refined blend after a change of frame, and a raster
    consumer on another frame than its source, raise ValueError while
    the port plans, naming the blended stage and the one that changed
    the frame; the JAX package fails on the same history while it runs
    (a broadcast of the plane or mask against the blend's input)."""
    from ansel_tpu.pipeline import blend as rb
    from ansel_tpu_torch.pipeline import blend as pb
    from test_torch_blend import share_rcd

    raw, meta, _ = frame96
    items, meta_kw, kw, (stage, changer) = R14_CASES[case]
    meta = dataclasses.replace(meta, **meta_kw)
    with pytest.raises(ValueError, match=f"stage '{stage}'.*'{changer}' "
                       "changed the frame"):
        ansel_tpu_torch.Pipeline(meta, items(ansel_tpu_torch, pb),
                                 device="cpu", **kw)
    share_rcd(monkeypatch)
    with pytest.raises(Exception):
        ansel_tpu.compile_pipeline(meta, items(ansel_tpu, rb),
                                   **kw).output_array(raw)


def test_r14_config13_refused_at_the_measured_frames(frame96):
    """Config 13's whole history at orientation 6 and at scale 0.5 (its
    vibrance reads the details plane), and with a crop after exposure and
    the details slider off (colour contrast reads exposure's mask): each
    refused while planning."""
    _, meta, _ = frame96
    forms = configs.forms(13)
    for m, kw in ((dataclasses.replace(meta, orientation=6), {}),
                  (meta, {"scale": 0.5})):
        with pytest.raises(ValueError, match="stage 'vibrance'"):
            ansel_tpu_torch.Pipeline(m, configs.history(13), device="cpu",
                                     forms=forms, **kw)
    hist = configs.history(13)
    for h in hist:
        if h.blend_params is not None:
            h.blend_params = dataclasses.replace(h.blend_params, details=0.0)
    hist.insert(5, ansel_tpu_torch.HistoryItem(
        "crop", {"cx": 0.1, "cy": 0.1, "cw": 0.8, "ch": 0.9}))
    with pytest.raises(ValueError, match="stage 'colorcontrast'.*'crop'"):
        ansel_tpu_torch.Pipeline(meta, hist, device="cpu", forms=forms)


def test_r14_same_frames_still_plan_and_run(frame96, monkeypatch):
    """Without a change of frame both packages run the same histories,
    and agree within the display quantum."""
    from ansel_tpu.pipeline import blend as rb
    from ansel_tpu_torch.pipeline import blend as pb
    from test_torch_blend import share_rcd

    raw, meta, _ = frame96
    share_rcd(monkeypatch)
    for items in (_details_item, lambda p, b: _raster_items(p, b, False)):
        got = ansel_tpu_torch.compile_pipeline(
            meta, items(ansel_tpu_torch, pb), device="cpu").output_array(raw)
        want = np.asarray(ansel_tpu.compile_pipeline(
            meta, items(ansel_tpu, rb)).output_array(raw))
        assert np.abs(got - want).max() <= DISPLAY_QUANTUM


# --- F6: the lattices and patch radii the planners can emit -----------------

@pytest.fixture(scope="module")
def lab_image():
    """A smooth (3, 40, 56) image plus noise, values in [0, 1]."""
    rng = np.random.default_rng(6)
    yy, xx = np.mgrid[0:40, 0:56]
    img = np.stack([0.5 + 0.3 * np.sin(yy / (5.0 + i)) * np.cos(xx / 7.0)
                    for i in range(3)])
    return (img + 0.1 * rng.random(img.shape)).astype(np.float32)


@pytest.mark.parametrize("P,K", [(1, 15), (2, 20), (9, 3), (12, 2)],
                         ids=["K15", "K20", "P9", "P12"])
@pytest.mark.parametrize("center_weight", [-1.0, 0.5],
                         ids=["variant0", "variant1"])
def test_nlm_twin_against_the_xla_path(lab_image, P, K, center_weight):
    norm = (0.6, 0.3, 0.3)
    sharp = 3.0
    want = np.asarray(ref_nlmeans.nlmeans(
        jnp.asarray(lab_image), P, K, sharp, norm, center_weight,
        force_xla=True))
    offsets = search_offsets(K)
    assert len(offsets) > nlm.MAX_OFFSETS or P > nlm.MAX_P
    n = 2 * P + 1
    if center_weight >= 0.0:
        got = nlm.nlm(torch.from_numpy(lab_image), offsets, P, norm, sharp,
                      center_weight * n * n, 1.0 / (1.0 + center_weight), 1)
    else:
        got = nlm.nlm(torch.from_numpy(lab_image), offsets, P, norm, sharp,
                      0.0, 1.0, 0)
    got = got.numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want)[:, P:-P, P:-P].max() <= NLM_TOL
