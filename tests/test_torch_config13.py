"""The port's config 13 (local edits on config 1's develop: a raw denoise
under a drawn gradient, spots, a wavelet retouch, a second exposure
under a feathered ellipse, the channel mixer under a parametric mask,
colour balance rgb in COLOR, velvia under a group with a wide mask blur,
a tone curve in OVERLAY and colour zones in LAB_LIGHTNESS, vibrance with
the details slider and a narrow blur, colour contrast through the
ellipse's mask; `ansel_tpu_torch/io/configs.py`) against ansel_tpu on
the CPU at 96 x 160 (the forms are normalised, so they land inside): the
plan, the schedule (which blends ride the chains and their programs),
the whole pipe per op and with the JAX package's fused chains in
interpret mode, the pipe under an `out_window` against the whole frame's
crop, the raster side-band's events and its missing-source error in both
packages, the pipe cache's miss when a form's node moves, and the
sidecar's export against the in-process render.

The JAX pipe is handed the port's RCD twin (as in
tests/test_torch_blend.py).  Tolerances: the display quantum (1/255) and
MEAN_TOL for the whole pipe; measured max 5.3e-5, mean 3.7e-7 per op
(the Jz trapezoids' slopes and the Lab conversion near black amplify
float32 pow's last-bit differences);
the window against the crop within WINDOW_TOL (the crop's edge feels
the window's edge-replicated border through the spatial blends)."""

import dataclasses

import numpy as np
import pytest
import torch

import ansel_tpu
import ansel_tpu_torch
from ansel_tpu.io.synthetic import synth_raw
from ansel_tpu.ops import retouch as ref_retouch
from ansel_tpu.ops import spots as ref_spots
from ansel_tpu.pipeline import blend as rb
from ansel_tpu.pipeline import engine as ref_engine
from ansel_tpu.pipeline import masks as rm
from ansel_tpu_torch.core import supervisor as sup
from ansel_tpu_torch.io import configs
from ansel_tpu_torch.io.xmp import XMPDocument, parse_xmp, write_xmp
from ansel_tpu_torch.kernels import pointwise as pw
from ansel_tpu_torch.pipeline import blend as pb
from ansel_tpu_torch.pipeline import engine
from ansel_tpu_torch.pipeline.export import export_image
from test_torch_blend import share_rcd

torch.set_num_threads(1)

H, W = 96, 160
DISPLAY_QUANTUM = 1.0 / 255.0
MEAN_TOL = 1e-5
STAGES = ["rawprepare", "temperature", "highlights", "rawdenoise",
          "demosaic", "spots", "retouch", "exposure", "exposure", "colorin",
          "channelmixerrgb", "colorbalancergb", "filmicrgb", "_convert",
          "tonecurve", "colorcontrast", "_convert", "velvia", "_convert",
          "vibrance", "colorzones", "_convert", "colorout"]
# step kinds: the RAW blend, the feathered ellipse, the raster consumer,
# the group mask, the details slider run the spatial path
STEPS = [("stage", 0, 1), ("stage", 1, 2), ("stage", 2, 3),
         ("blend", 3, 4), ("stage", 4, 5), ("stage", 5, 6), ("stage", 6, 7),
         ("blend", 7, 8), ("chain", 8, 15), ("blend", 15, 16),
         ("chain", 16, 17), ("blend", 17, 18), ("chain", 18, 19),
         ("blend", 19, 20), ("chain", 20, 23)]
WINDOW = (20, 32, 48, 80)
SIDECAR_TOL = 1e-4   # measured 3.0e-5


def _ref_hist():
    return configs.history13(ansel_tpu.HistoryItem, rb.BlendParams,
                             ref_spots.SpotsParams,
                             ref_retouch.RetouchParams,
                             ref_retouch.pack_form)


@pytest.fixture(scope="module")
def slice13():
    raw, meta, _ = synth_raw(h=H, w=W, kind="gradients")
    port = ansel_tpu_torch.compile_pipeline(
        meta, configs.history(13), device="cpu", forms=configs.forms(13))
    return port, port.output_array(raw), raw, meta


def test_config13_plan_equals_reference(slice13):
    port, _, _, meta = slice13
    ref = ansel_tpu.Pipeline(meta, _ref_hist(), forms=configs.forms13(rm.Form))
    assert [s.name for s in port.pipe.stages] == STAGES
    assert [s.name for s in ref.stages] == STAGES
    for p, r in zip(port.pipe.stages, ref.stages):
        assert p.multi_priority == r.multi_priority
        assert (p.blend is None) == (r.blend is None), p.name
        assert p.blend_static == r.blend_static, p.name
        if p.name in ("spots", "retouch"):
            assert p.plan.static == r.plan.static
    blended = [s.name for s in port.pipe.stages if s.blend is not None]
    assert blended == ["rawdenoise", "exposure", "channelmixerrgb",
                       "colorbalancergb", "tonecurve", "colorcontrast",
                       "velvia", "vibrance", "colorzones"]


def test_config13_schedule_and_programs(slice13):
    """A blend rides a chain exactly where the JAX engine fuses it: the
    channel mixer's, colour balance's, the tone curve's and colour
    zones' (each between a keep and a blend record, its chain a program
    of FIXED); every other blend runs the spatial path."""
    port = slice13[0]
    assert [(k, i, j) for k, i, j, _ in port.steps] == STEPS
    chains = [a for k, _, _, a in port.steps if k == "chain"]
    for chain in chains:
        recs = chain.prog.view(-1, pw.RECORD)[:, :2].tolist()
        assert chain.fixed >= 0
        assert pw.FIXED[chain.fixed] == tuple(map(tuple, recs))
    ops = [r[0] for c in chains for r in c.prog.view(-1, pw.RECORD).tolist()]
    assert ops.count(pw.OP_KEEP) == ops.count(pw.OP_BLEND) == 4


def test_config13_calls_each_kernel_wrapper(monkeypatch):
    """RCD once, the four chains, sepblur for rawdenoise, retouch's
    a-trous and blur, the narrow mask blur and the detail-free box means;
    the IIR for the wide mask blur."""
    from ansel_tpu_torch.kernels import iir, rcd, sepblur

    raw, meta, _ = synth_raw(h=H, w=W, kind="gradients")
    calls = {}
    for mod, name in ((rcd, "rcd_demosaic"), (sepblur, "sep_blur"),
                      (pw, "pointwise_chain"), (iir, "gaussian_iir")):
        real = getattr(mod, name)

        def spy(*args, _real=real, _name=name):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*args)

        monkeypatch.setattr(mod, name, spy)
    ansel_tpu_torch.compile_pipeline(meta, configs.history(13), device="cpu",
                                     forms=configs.forms(13)).output_array(raw)
    assert calls["rcd_demosaic"] == 1 and calls["pointwise_chain"] == 4
    assert calls["gaussian_iir"] >= 1 and calls["sep_blur"] > 8


@pytest.mark.parametrize("fused", [False, True], ids=["per-op", "fused"])
def test_config13_matches_the_jax_package(slice13, fused, monkeypatch):
    _, got, raw, meta = slice13
    share_rcd(monkeypatch)
    monkeypatch.setattr(ref_engine, "_FORCE_FUSION_INTERPRET", fused)
    ref_engine._COMPILE_CACHE.clear()
    try:
        want = np.asarray(ansel_tpu.compile_pipeline(
            meta, _ref_hist(), forms=configs.forms13(rm.Form))
            .output_array(raw))
    finally:
        ref_engine._COMPILE_CACHE.clear()
    assert got.shape == want.shape == (3, H, W)
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0
    d = np.abs(got - want)
    assert d.max() <= DISPLAY_QUANTUM and d.mean() <= MEAN_TOL


def test_config13_edits_change_the_image(slice13):
    """Each blended or retouching stage moves its input, but colour
    zones: its OVERLAY blend is masked to the input's L below 0.5 (R13),
    which this frame does not reach."""
    port, _, raw, _ = slice13
    pipe = port.pipe
    from ansel_tpu_torch.ops import base

    x = torch.from_numpy(base.pad_to(raw, pipe.spec_in))
    carry = {}
    for i, s in enumerate(pipe.stages):
        y = pipe.trace_fn(i, i + 1)(x, port.coeffs[i:i + 1], carry)
        moved = (y - x).abs().max().item()
        if s.name == "colorzones":
            assert moved == 0.0 and x[0].min().item() > 0.5
        elif s.blend is not None or s.name in ("spots", "retouch"):
            assert moved > 1e-3, s.name
        x = y
    assert set(carry["masks"]) == {("exposure", 1), ("exposure", None),
                                   ("colorcontrast", 0),
                                   ("colorcontrast", None), ("velvia", 0),
                                   ("velvia", None), ("vibrance", 0),
                                   ("vibrance", None)}
    assert carry["rawdetail"].shape == pipe.stages[4].plan.spec_out \
        .array_shape[1:]


def test_config13_window_matches_the_whole_frame(slice13):
    port, got, raw, meta = slice13
    y0, x0, h, w = WINDOW
    win = ansel_tpu_torch.CompiledPipe(engine.Pipeline(
        meta, configs.history(13), device="cpu", forms=configs.forms(13),
        out_window=WINDOW))
    out = win.output_array(raw)
    assert out.shape == (3, h, w)
    d = np.abs(out - got[:, y0:y0 + h, x0:x0 + w])
    assert d.max() <= DISPLAY_QUANTUM and d.mean() <= MEAN_TOL


def test_missing_raster_source_raises_in_both_packages():
    """Colour contrast reading the mask of an exposure instance that has
    no blend: a named source that is missing is an error in both
    packages (an empty name fills the mask)."""
    raw, meta, _ = synth_raw(h=32, w=48, kind="gradients")
    kw = dict(configs.BLENDS13[12][1])
    for pkg, bl in ((ansel_tpu_torch, pb), (ansel_tpu, rb)):
        hist = [pkg.HistoryItem("colorcontrast", {},
                                blend_params=bl.BlendParams(**kw))]
        extra = {"device": "cpu"} if pkg is ansel_tpu_torch else {}
        with pytest.raises(RuntimeError,
                           match="raster mask source 'exposure'"):
            pkg.compile_pipeline(meta, hist, **extra).output_array(raw)
        hist[0].blend_params = bl.BlendParams(
            **dict(kw, raster_mask_source=""))
        out = pkg.compile_pipeline(meta, hist, **extra).output_array(raw)
        assert np.isfinite(np.asarray(out)).all()


def test_raster_side_band_events():
    raw, meta, _ = synth_raw(h=32, w=48, kind="gradients")
    sup._reset_for_tests(True)
    try:
        ansel_tpu_torch.compile_pipeline(
            meta, configs.history(13), device="cpu",
            forms=configs.forms(13)).output_array(raw)
        events = [(r["op"], r["key"]) for r in sup.ring()
                  if r["kind"] == "raster_mask"]
    finally:
        sup._reset_for_tests(False)
    assert ("create", "exposure|1") in events
    assert events.index(("read", "exposure|1")) > events.index(
        ("create", "exposure|1"))


def test_stage_split_runner_carries_the_side_band():
    """`-d perf`'s runner schedules each stage alone: the raster source's
    mask and the raw-detail plane reach their readers (a fresh side-band
    a stage would raise at colorcontrast's named source)."""
    from ansel_tpu_torch.pipeline.profiling import run_stages

    raw, meta, _ = synth_raw(h=32, w=48, kind="gradients")
    pipe = engine.Pipeline(meta, configs.history(13), device="cpu",
                           forms=configs.forms(13))
    reps = run_stages(pipe, raw, nan_scan=True, verbose=False)
    assert [r.name for r in reps] == STAGES
    assert all(r.nan == 0 and r.inf == 0 for r in reps)


def test_pipe_cache_misses_when_a_form_moves():
    raw, meta, _ = synth_raw(h=32, w=48, kind="gradients")
    engine._PIPE_CACHE.clear()
    forms = configs.forms(13)
    a = ansel_tpu_torch.compile_pipeline(meta, configs.history(13),
                                         device="cpu", forms=forms)
    moved = dict(forms)
    n = forms[103].nodes[0]
    moved[103] = dataclasses.replace(forms[103],
                                     nodes=[(n[0] + 0.05,) + n[1:]])
    b = ansel_tpu_torch.compile_pipeline(meta, configs.history(13),
                                         device="cpu", forms=moved)
    c = ansel_tpu_torch.compile_pipeline(meta, configs.history(13),
                                         device="cpu", forms=forms)
    assert a.pipe.signature() != b.pipe.signature()
    assert a.pipe.signature() == c.pipe.signature()
    assert len(engine._PIPE_CACHE) == 2
    assert np.abs(a.output_array(raw) - b.output_array(raw)).max() > 1e-3


def test_config13_sidecar_exports_like_the_render(slice13, tmp_path):
    """The sidecar carries the history, its blends and forms; its export
    plans the same pipe.  Only filmicrgb's default params, which the
    history leaves to their float64 defaults and the sidecar stores in
    float32, move its coefficients by a rounding."""
    port, got, raw, meta = slice13
    path = str(tmp_path / "c13.xmp")
    write_xmp(path, XMPDocument(history=configs.history(13),
                                masks=configs.forms(13)))
    doc = parse_xmp(path)
    assert doc.masks == configs.forms(13)
    assert [(h.op, h.multi_priority,
             pb.decode_blend_params(h.blend_params)) for h in doc.history] \
        == [(h.op, h.multi_priority, h.blend_params)
            for h in configs.history(13)]
    out = export_image(raw, meta, xmp_path=path, device="cpu")
    assert np.abs(out - got).max() <= SIDECAR_TOL
