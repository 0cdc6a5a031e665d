"""The PREVIEW and THUMBNAIL pipes and the demosaics they select (PPG and
the bilinear fallback, `ops/demosaic.py`) against ansel_tpu on the CPU.

* `ppg_demosaic` and `bilinear_demosaic` on every Bayer phase equal the
  JAX functions, run op by op and under `jax.jit` (the shifts wrap round
  the frame as `jnp.roll` does; the stencils are `PaddedView` adds).
* The override's quirks, each planned as the JAX package plans it: a
  `demosaic` item whose params are a dict or None becomes PPG, a decoded
  blob or a params dataclass keeps its method (method 7, which the JAX
  package does not name, runs bilinear), a history without a `demosaic`
  item keeps the default RCD, and on X-Trans method 0 becomes
  Markesteijn.  The fast pipes plan no backward ROI; filmicrgb's
  reconstruction, denoiseprofile's and nlmeans' decimation take their
  fast branches.
* Config 1's history with a `demosaic` dict in the PREVIEW pipe, and
  with a method-7 blob in the THUMBNAIL pipe at scale 0.25, each against
  the JAX pipe within the display quantum and MEAN_TOL (measured 2.6e-5
  and 1.4e-5 at most: filmicrgb's curve in the fused chain); the
  preview's chain is config 1's program."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ansel_tpu
import ansel_tpu_torch
from ansel_tpu.core.types import CFAPattern as RefCFA
from ansel_tpu.io.synthetic import synth_raw
from ansel_tpu.ops import demosaic as ref_demosaic
from ansel_tpu_torch.core.params import params_class
from ansel_tpu_torch.core.types import CFAPattern
from ansel_tpu_torch.io import configs
from ansel_tpu_torch.kernels import pointwise as pw
from ansel_tpu_torch.ops import demosaic

torch.set_num_threads(1)

DISPLAY_QUANTUM = 1.0 / 255.0
MEAN_TOL = 1e-5
H, W = 96, 160


@pytest.mark.parametrize("fn", ["ppg_demosaic", "bilinear_demosaic"])
@pytest.mark.parametrize("phase", ["RGGB", "BGGR", "GRBG", "GBRG"])
def test_fast_demosaics_match_jax(fn, phase):
    x = np.random.default_rng(len(phase + fn)).uniform(
        0.0, 1.0, (24, 40)).astype(np.float32)
    got = getattr(demosaic, fn)(torch.from_numpy(x),
                                CFAPattern[phase]).numpy()
    ref = getattr(ref_demosaic, fn)
    eager = np.asarray(ref(jnp.asarray(x), RefCFA[phase]))
    jitted = np.asarray(jax.jit(lambda a: ref(a, RefCFA[phase]))(x))
    assert got.shape == (3, 24, 40)
    assert np.array_equal(got, eager) and np.array_equal(got, jitted)


def test_ppg_wraps_round_the_frame():
    """The shifts are rolls: on rows of constant values (so that the
    horizontal estimate is taken), a bright photosite in the last column
    moves the green estimate two columns on, in the first columns."""
    rows = np.random.default_rng(0).uniform(0.1, 0.9, (16, 1))
    x = np.repeat(rows, 24, axis=1).astype(np.float32)
    y = x.copy()
    y[1, -1] = 5.0
    a, b = (demosaic.ppg_demosaic(torch.from_numpy(v), CFAPattern.RGGB)
            for v in (x, y))
    assert (a - b)[1, 1, 1].abs().item() > 1e-3


def _blob(method):
    cls = params_class("demosaic")
    return cls.codec.encode(cls(demosaicing_method=method))


def _plans(meta, items, pipe_type="preview", **kw):
    """The demosaic stage's planned static in each package."""
    out = []
    for pkg, extra in ((ansel_tpu_torch, {"device": "cpu"}), (ansel_tpu, {})):
        hist = [pkg.HistoryItem(op, p, version=4 if op == "demosaic"
                                and isinstance(p, bytes) else None)
                for op, p in items]
        pipe = pkg.Pipeline(meta, hist, pipe_type=pipe_type, **extra, **kw)
        out.append({s.name: s.plan.static for s in pipe.stages})
    return out


@pytest.mark.parametrize("items,method", [
    ([("demosaic", {"demosaicing_method": 5})], 0),
    ([("demosaic", None)], 0),
    ([("demosaic", _blob(5))], 5),
    ([("demosaic", _blob(7))], 7),
    ([("exposure", {"exposure": 0.5})], 5),
], ids=["dict", "none", "blob-rcd", "blob-bilinear", "no-item"])
@pytest.mark.parametrize("pipe_type", ["preview", "thumbnail"])
def test_override_quirks_plan_alike(items, method, pipe_type):
    _, meta, _ = synth_raw(h=32, w=48)
    got, want = _plans(meta, items, pipe_type)
    assert got["demosaic"] == want["demosaic"]
    assert got["demosaic"][0] == method


def test_override_on_xtrans_plans_markesteijn():
    _, meta, _ = synth_raw(h=36, w=48)
    meta = dataclasses.replace(meta, xtrans=configs.XTRANS6)
    got, want = _plans(meta, [("demosaic", {"demosaicing_method": 5})])
    assert got["demosaic"] == want["demosaic"]
    assert got["demosaic"][0] == demosaic.MARKESTEIJN


def test_a_dataclass_keeps_its_method():
    _, meta, _ = synth_raw(h=32, w=48)
    p = params_class("demosaic")(demosaicing_method=7)
    pipe = ansel_tpu_torch.Pipeline(
        meta, [ansel_tpu_torch.HistoryItem("demosaic", p)], device="cpu",
        pipe_type="thumbnail")
    assert [s.plan.static[0] for s in pipe.stages
            if s.name == "demosaic"] == [7]


@pytest.mark.parametrize("pipe_type,windowed", [
    ("preview", False), ("thumbnail", False), ("export", True)])
def test_fast_pipes_plan_no_backward_roi(pipe_type, windowed):
    _, meta, _ = synth_raw(h=64, w=96)
    for pkg, extra in ((ansel_tpu_torch, {"device": "cpu"}), (ansel_tpu, {})):
        pipe = pkg.Pipeline(meta, [pkg.HistoryItem("exposure", {})],
                            pipe_type=pipe_type, out_window=(8, 8, 32, 48),
                            **extra)
        assert pipe.windowed is windowed


def test_fast_branches_fire():
    """filmicrgb plans no highlight reconstruction, denoiseprofile and
    nlmeans decimate their search, in both packages' fast pipes."""
    _, meta, _ = synth_raw(h=64, w=96)
    items = [("filmicrgb", {"reconstruct_threshold": -1.0}),
             ("denoiseprofile", {"a": (4e-4,) * 3, "b": (1e-5,) * 3,
                                 "mode": 0}),
             ("nlmeans", {})]
    got, want = _plans(meta, items)
    fast = {k: got[k] for k in ("filmicrgb", "denoiseprofile", "nlmeans")}
    assert fast == {k: want[k] for k in fast}
    full, _ = _plans(meta, items, "export")
    assert fast["filmicrgb"][-1] is None and full["filmicrgb"][-1] is not None
    assert fast["denoiseprofile"][-1] and not full["denoiseprofile"][-1]
    assert fast["nlmeans"][-1] and not full["nlmeans"][-1]


FAST_CASES = {
    "preview": ([("demosaic", {})], {}),
    "thumbnail-bilinear": ([("demosaic", _blob(7))], {"scale": 0.25}),
}


@pytest.fixture(scope="module")
def frame():
    return synth_raw(h=H, w=W, kind="gradients")


@pytest.mark.parametrize("case", sorted(FAST_CASES))
def test_fast_pipe_matches_the_jax_package(frame, case):
    raw, meta, _ = frame
    extra_items, kw = FAST_CASES[case]
    pipe_type = case.split("-")[0]
    items = [(op, dict(p)) for op, p in configs.HISTORIES[1]] + extra_items
    outs = []
    for pkg, extra in ((ansel_tpu_torch, {"device": "cpu"}), (ansel_tpu, {})):
        hist = [pkg.HistoryItem(op, p, version=4 if isinstance(p, bytes)
                                else None) for op, p in items]
        pipe = pkg.compile_pipeline(meta, hist, pipe_type=pipe_type,
                                    **extra, **kw)
        outs.append((pipe, np.asarray(pipe.output_array(raw))))
    (port, got), (ref, want) = outs
    assert [s.plan.static for s in port.pipe.stages
            if s.name == "demosaic"] == [
        s.plan.static for s in ref.pipe.stages if s.name == "demosaic"]
    planned = next(s.plan.static[0] for s in port.pipe.stages
                   if s.name == "demosaic")
    assert planned == (0 if pipe_type == "preview" else 7)
    assert got.shape == want.shape
    assert got.shape == ((3, H, W) if pipe_type == "preview"
                         else (3, H // 4, W // 4))
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0
    d = np.abs(got - want)
    assert d.max() <= DISPLAY_QUANTUM and d.mean() <= MEAN_TOL
    (chain,) = [a for k, _, _, a in port.steps if k == "chain"]
    assert pw.FIXED[chain.fixed] == pw.FIXED[0]
