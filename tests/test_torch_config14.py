"""The port's config 14 (config 1's develop with a look shared as a style:
an ICC input profile, a .cube in sRGB, inline compressed-CLUT keypoints
in linear Rec2020, a painted layer and an ICC output profile;
`ansel_tpu_torch/io/configs.py`) against ansel_tpu on the CPU at
96 x 160.

Each package builds the history its own way: the fixtures written from
the seed, the style written with its own `write_style`, read back with
its `parse_style` and merged onto config 1 with its `apply_style`.  The
two histories hold the same items and blobs; the plans, statics and
coefficients agree (the ICC stages hold the JAX package's `M` and the
fits it makes in `apply`); the chains are [exposure], [channelmixerrgb]
and [filmicrgb], each a program of `pointwise.FIXED`; RCD runs once.
The JAX pipe is handed the port's RCD twin (as in
tests/test_torch_blend.py), and the whole frame agrees within the
display quantum and MEAN_TOL (measured max 2.6e-6, mean 1.2e-7); the
merged history's sidecar exports within SIDECAR_TOL of the render
(measured 1.2e-6: filmicrgb's default params stored as float32)."""

import shutil

import numpy as np
import pytest
import torch

import ansel_tpu
import ansel_tpu_torch
from ansel_tpu.core.params import params_class as ref_params_class
from ansel_tpu.io import styles as ref_styles
from ansel_tpu.io.synthetic import synth_raw
from ansel_tpu_torch.io import configs
from ansel_tpu_torch.io.xmp import XMPDocument, write_xmp
from ansel_tpu_torch.kernels import pointwise as pw
from ansel_tpu_torch.pipeline.export import export_image
from test_torch_blend import share_rcd

torch.set_num_threads(1)

H, W = 96, 160
DISPLAY_QUANTUM = 1.0 / 255.0
MEAN_TOL = 1e-5
SIDECAR_TOL = 1e-4
STAGES = ["rawprepare", "temperature", "highlights", "demosaic", "exposure",
          "colorin", "channelmixerrgb", "lut3d", "lut3d", "drawlayer",
          "filmicrgb", "colorout"]
STEPS = [("stage", 0, 1), ("stage", 1, 2), ("stage", 2, 3), ("stage", 3, 4),
         ("chain", 4, 5), ("stage", 5, 6), ("chain", 6, 7), ("stage", 7, 8),
         ("stage", 8, 9), ("stage", 9, 10), ("chain", 10, 11),
         ("stage", 11, 12)]


@pytest.fixture(scope="module")
def slice14():
    d = configs.fixture_dir14()
    raw, meta, _ = synth_raw(h=H, w=W, kind="gradients")
    hist = configs.history14(d, seed=0)
    ref_hist = configs.history14(d, 0, ansel_tpu.HistoryItem,
                                 ref_params_class, ref_styles)
    port = ansel_tpu_torch.compile_pipeline(meta, hist, device="cpu")
    yield port, port.output_array(raw), raw, meta, hist, ref_hist, d
    shutil.rmtree(d, ignore_errors=True)


def test_config14_histories_are_equal(slice14):
    hist, ref_hist = slice14[4], slice14[5]
    view = [(h.op, h.params, h.version, h.enabled, h.multi_priority)
            for h in hist]
    assert view == [(h.op, h.params, h.version, h.enabled,
                     h.multi_priority) for h in ref_hist]
    assert [(op, mp) for op, _, _, _, mp in view] == [
        ("exposure", 0), ("channelmixerrgb", 0), ("filmicrgb", 0)] + list(
        configs.STYLE14)
    assert all(isinstance(h.params, bytes) for h in hist[3:])


def test_config14_plan_equals_reference(slice14):
    port, _, _, meta, _, ref_hist, _ = slice14
    ref = ansel_tpu.Pipeline(meta, ref_hist)
    assert [s.name for s in port.pipe.stages] == STAGES
    assert [s.name for s in ref.stages] == STAGES
    assert [s.multi_priority for s in port.pipe.stages] == [
        s.multi_priority for s in ref.stages]
    for p, r in zip(port.pipe.stages, ref.stages):
        assert p.plan.static == r.plan.static, p.name
    got, want = port.pipe.coeffs(), ref.coeffs()
    for s, c, rc in zip(port.pipe.stages, got, want):
        if rc is None:
            assert c is None, s.name
            continue
        assert set(rc) <= set(c), s.name
        for k in rc:
            assert np.array_equal(np.asarray(c[k], np.float32),
                                  np.asarray(rc[k], np.float32)), (s.name, k)
    extra = {s.name: sorted(set(c) - set(rc)) for s, c, rc
             in zip(port.pipe.stages, got, want) if rc and set(c) - set(rc)}
    assert extra == {
        "colorin": ["trc0", "trc1", "trc2"],
        "colorout": ["b2a_clut", "b2a_in0", "b2a_in1", "b2a_in2",
                     "b2a_out0", "b2a_out1", "b2a_out2"]}
    lut = [s.plan.static for s in port.pipe.stages if s.name == "lut3d"]
    assert [(cs, interp, level) for cs, interp, level, _ in lut] == [
        (4, 1, 48), (0, 0, configs.CUBE14_LEVEL)]


def test_config14_schedule_and_programs(slice14):
    port = slice14[0]
    assert [(k, i, j) for k, i, j, _ in port.steps] == STEPS
    chains = [a for k, _, _, a in port.steps if k == "chain"]
    assert [pw.FIXED[c.fixed] for c in chains] == [
        ((pw.OP_EXPOSURE, 0),), ((pw.OP_CHANNELMIXERRGB, 0),),
        ((pw.OP_FILMIC_AGX, 0),)]


def test_config14_calls_each_kernel_wrapper(slice14, monkeypatch):
    from ansel_tpu_torch.kernels import rcd

    port, _, raw, *_ = slice14
    calls = {}
    for mod, name in ((rcd, "rcd_demosaic"), (pw, "pointwise_chain")):
        real = getattr(mod, name)

        def spy(*args, _real=real, _name=name):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*args)

        monkeypatch.setattr(mod, name, spy)
    port.output_array(raw)
    assert calls == {"rcd_demosaic": 1, "pointwise_chain": 3}


def test_config14_matches_the_jax_package(slice14, monkeypatch):
    _, got, raw, meta, _, ref_hist, _ = slice14
    share_rcd(monkeypatch)
    want = np.asarray(ansel_tpu.compile_pipeline(meta, ref_hist)
                      .output_array(raw))
    assert got.shape == want.shape == (3, H, W)
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0
    d = np.abs(got - want)
    assert d.max() <= DISPLAY_QUANTUM and d.mean() <= MEAN_TOL


def test_config14_style_moves_the_image(slice14):
    """Each stage of the style changes its input."""
    port, _, raw, *_ = slice14
    from ansel_tpu_torch.ops import base

    pipe = port.pipe
    x = torch.from_numpy(base.pad_to(raw, pipe.spec_in))
    for i, s in enumerate(pipe.stages):
        y = pipe.trace_fn(i, i + 1)(x, port.coeffs[i:i + 1])
        if i >= 5 and s.name != "filmicrgb":
            assert (y - x).abs().max().item() > 1e-3, s.name
        x = y


def test_config14_sidecar_exports_like_the_render(slice14, tmp_path):
    _, got, raw, meta, hist, _, _ = slice14
    path = str(tmp_path / "c14.xmp")
    write_xmp(path, XMPDocument(history=hist))
    out = export_image(raw, meta, xmp_path=path, device="cpu")
    assert out.shape == got.shape
    assert np.abs(out - got).max() <= SIDECAR_TOL
