"""The port's config 7 (the bilateral-grid stack: bilateral, exposure,
filmicrgb, shadhi with the grid, bilat mode 0, sharpen; the port's own
history in ansel_tpu_torch/io/configs.py) against ansel_tpu on the CPU:
plan and coefficients, the whole pipe against the JAX package's
`compile_pipeline(...).output_array` with its grid slice on the XLA path
and on the Pallas kernel in interpret mode, and with its fused chains in
interpret mode, and which kernel wrappers the pipe calls.  The raw comes
from synth_raw and goes to both packages."""

import dataclasses
import enum

import numpy as np
import pytest
import torch

import ansel_tpu
import ansel_tpu_torch
from ansel_tpu.io.synthetic import synth_raw
from ansel_tpu.kernels import rcd as ref_rcd
from ansel_tpu.kernels import rcd_pallas
from ansel_tpu.pipeline import engine as ref_engine
from ansel_tpu.pixel import bilateralgrid as ref_bg
from ansel_tpu_torch.io import configs
from ansel_tpu_torch.kernels import bgrid, pointwise, rcd, sepblur

torch.set_num_threads(2)

STAGES = ["rawprepare", "temperature", "highlights", "demosaic", "bilateral",
          "exposure", "colorin", "_convert", "sharpen", "_convert",
          "filmicrgb", "_convert", "shadhi", "bilat", "_convert", "colorout"]
# 120 x 240 pads to 120 x 256 (a multiple of 128 columns): the bilateral
# grid (ss 15) has 8 x 18 cells, bilat's (ss 50) 3 x 6, shadhi's (ss 100)
# 2 x 3; at 8 cell rows the interpret-mode slice stages 8 of them per tile
H, W = 120, 240
DISPLAY_QUANTUM = 1.0 / 255.0


def _hist(pkg):
    return configs.history(7, pkg.HistoryItem)


def _plain(v):
    if isinstance(v, enum.Enum):
        return v.value
    if dataclasses.is_dataclass(v):
        return tuple(_plain(getattr(v, f.name))
                     for f in dataclasses.fields(v))
    if isinstance(v, (tuple, list)):
        return tuple(_plain(x) for x in v)
    return v


@pytest.fixture(scope="module")
def slice7():
    raw, meta, _ = synth_raw(h=H, w=W, kind="gradients")
    port = ansel_tpu_torch.compile_pipeline(meta, _hist(ansel_tpu_torch),
                                            device="cpu")
    before = bgrid.LAUNCHES
    got = port.output_array(raw)
    assert bgrid.LAUNCHES == before      # the twins on the CPU
    return port, got, raw, meta


def _reference(raw, meta, grid_interpret, fusion_interpret, monkeypatch):
    """ansel_tpu's config 7 through compile_pipeline(...).output_array,
    demosaicing with the Pallas RCD in interpret mode (what the TPU runs;
    its CPU RCD, kernels/rcd.py, differs on a ~4 px border, which the
    grids' cells of up to 100 px and their 5-tap blurs carry across the
    frame: measured 0.35 at 400 x 600)."""
    monkeypatch.setattr(ref_rcd, "rcd_demosaic",
                        lambda x, cfa, s: rcd_pallas.rcd_demosaic_pallas(
                            x, cfa, s, interpret=True))
    monkeypatch.setattr(ref_bg, "_FORCE_PALLAS_INTERPRET", grid_interpret)
    monkeypatch.setattr(ref_engine, "_FORCE_FUSION_INTERPRET",
                        fusion_interpret)
    ref_engine._COMPILE_CACHE.clear()
    try:
        return np.asarray(ansel_tpu.compile_pipeline(meta, _hist(ansel_tpu))
                          .output_array(raw))
    finally:
        ref_engine._COMPILE_CACHE.clear()


def test_config7_plan_and_coeffs_equal_reference(slice7):
    port, _, _, meta = slice7
    ref = ansel_tpu.Pipeline(meta, _hist(ansel_tpu))
    assert [s.name for s in port.pipe.stages] == STAGES
    assert [s.name for s in ref.stages] == STAGES
    for p, r in zip(port.pipe.stages, ref.stages):
        assert _plain(p.plan.spec_in) == _plain(r.plan.spec_in), p.name
        assert _plain(p.plan.static) == _plain(r.plan.static), p.name
    for p, r in zip(port.pipe.coeffs(), ref.coeffs()):
        assert sorted(p or {}) == sorted(r or {})
        for k in p or {}:
            assert np.array_equal(np.asarray(p[k]), np.asarray(r[k])), k


# full frame, borders included: the grids splat bf16-rounded operands in
# float32 and sum in another order, the chains round within an ulp or so;
# measured max 1.5e-5, 1.8e-5 and 2.2e-5 (mean 3.2e-7) in the three forms
@pytest.mark.parametrize("grid_interpret,fusion_interpret", [
    (False, False), (True, False), (False, True)],
    ids=["grid-xla", "grid-pallas-interpret", "fusion-interpret"])
def test_config7_matches_the_jax_package(slice7, grid_interpret,
                                         fusion_interpret, monkeypatch):
    _, got, raw, meta = slice7
    want = _reference(raw, meta, grid_interpret, fusion_interpret,
                      monkeypatch)
    assert got.shape == want.shape == (3, H, W)
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0
    d = np.abs(got - want)
    assert d.max() <= DISPLAY_QUANTUM and d.mean() <= 1e-5


def test_config7_chains(slice7):
    port = slice7[0]
    assert port.fused_groups() == [["exposure", "colorin", "_convert"],
                                   ["_convert", "filmicrgb", "_convert"],
                                   ["_convert", "colorout"]]
    assert [k for k, *_ in port.steps] == (
        ["stage"] * 5 + ["chain", "stage", "chain", "stage", "stage",
                         "chain"])


def test_config7_calls_each_kernel_wrapper(monkeypatch):
    """Five grid slices (bilateral's three channels at ss 15 and 32 bins,
    shadhi's three-channel grid at ss 100 and 4 bins, bilat's at ss 50 and
    6 bins), one RCD, one sepblur (sharpen's blur of L), three chains."""
    raw, meta, _ = synth_raw(h=96, w=200, kind="gradients")
    calls = []
    for mod, name in ((bgrid, "slice_grid"), (rcd, "rcd_demosaic"),
                      (sepblur, "sep_blur"), (pointwise, "pointwise_chain")):
        real = getattr(mod, name)

        def spy(*args, _real=real, _name=name):
            if _name == "slice_grid":
                D, C = args[0].shape[:2]
                calls.append((_name, D, C, args[2]))
            else:
                calls.append((_name,))
            return _real(*args)

        monkeypatch.setattr(mod, name, spy)
    ansel_tpu_torch.compile_pipeline(meta, _hist(ansel_tpu_torch),
                                     device="cpu").output_array(raw)
    assert calls == [("rcd_demosaic",)] + [("slice_grid", 32, 1, 15)] * 3 + [
        ("pointwise_chain",), ("sep_blur",), ("pointwise_chain",),
        ("slice_grid", 4, 3, 100), ("slice_grid", 6, 1, 50),
        ("pointwise_chain",)]
