"""The port's config 11 (a pre-3.0 catalogue's look on config 1's
develop, straightened and retouched: ashift, liquify, colorbalance,
velvia, vibrance, colorcontrast, colisa, splittoning; the port's own
history in ansel_tpu_torch/io/configs.py, liquify's brush path scaled to
the frame) against ansel_tpu on the CPU: the plan, statics and
coefficients, the one chain and its specialised program, every new stage
changing its input, the kernel wrappers the pipe calls, and the whole
pipe against `ansel_tpu.compile_pipeline(...).output_array` with its
Pallas RCD in interpret mode, per op and with its fused chain in
interpret mode.  Also colorchecker's schedule: with 12 patches it runs
inside the chain, with 24 alone, in both packages.  The raw comes from
synth_raw and goes to both packages."""

import dataclasses
import enum

import numpy as np
import pytest
import torch

import ansel_tpu
import ansel_tpu_torch
from ansel_tpu.io.synthetic import synth_raw
from ansel_tpu.kernels import pointwise as ref_pw
from ansel_tpu.kernels import rcd as ref_rcd
from ansel_tpu.kernels import rcd_pallas
from ansel_tpu.pipeline import engine as ref_engine
from ansel_tpu_torch.io import configs
from ansel_tpu_torch.kernels import pointwise, rcd, warp
from ansel_tpu_torch.ops import base

# one intra-op thread: with JAX initialised in the same process, torch's
# first two-thread `sqrt` on the CPU now and then returned the half of a
# (48, 128) plane that the second thread computes off by up to ~2.5e-4
# relative, which a later identical call does not repeat (measured: 3 of
# 32 fresh processes at two threads, 0 of 32 at one)
torch.set_num_threads(1)

STAGES = ["rawprepare", "temperature", "highlights", "demosaic", "ashift",
          "liquify", "exposure", "colorin", "channelmixerrgb", "colorbalance",
          "filmicrgb", "_convert", "colisa", "colorcontrast", "_convert",
          "velvia", "_convert", "vibrance", "_convert", "splittoning",
          "colorout"]
NEW = ("ashift", "liquify", "colorbalance", "colisa", "colorcontrast",
       "velvia", "vibrance", "splittoning")
H, W = 96, 160
DISPLAY_QUANTUM = 1.0 / 255.0
# Against the JAX package with its Pallas RCD (the port's RCD twin repeats
# it; the JAX CPU RCD differs on a ~4 px border, which ashift's rotation
# carries into the frame, so no ring can be dropped): the whole frame,
# measured max 2.3e-5 per op and 2.2e-5 fused, mean 2.5e-7
MEAN_TOL = 1e-5


def _hist(pkg):
    """Config 11's history with liquify's path scaled to the H x W
    frame."""
    return [pkg.HistoryItem(op, {"nodes": configs.liquify_nodes(H, W)}
                            if op == "liquify" else dict(p))
            for op, p in configs.HISTORIES[11]]


def _plain(v):
    if isinstance(v, enum.Enum):
        return v.value
    if dataclasses.is_dataclass(v):
        return tuple(_plain(getattr(v, f.name)) for f in dataclasses.fields(v))
    if isinstance(v, (tuple, list)):
        return tuple(_plain(x) for x in v)
    return v


@pytest.fixture(scope="module")
def slice11():
    raw, meta, _ = synth_raw(h=H, w=W, kind="gradients")
    port = ansel_tpu_torch.compile_pipeline(meta, _hist(ansel_tpu_torch),
                                            device="cpu")
    before = (warp.LAUNCHES, pointwise.LAUNCHES)
    got = port.output_array(raw)
    assert (warp.LAUNCHES, pointwise.LAUNCHES) == before  # twins on the CPU
    return port, got, raw, meta


def test_config11_plan_and_coeffs_equal_reference(slice11):
    port, _, _, meta = slice11
    ref = ansel_tpu.Pipeline(meta, _hist(ansel_tpu))
    assert [s.name for s in port.pipe.stages] == STAGES
    assert [s.name for s in ref.stages] == STAGES
    for p, r in zip(port.pipe.stages, ref.stages):
        assert _plain(p.plan.spec_in) == _plain(r.plan.spec_in), p.name
        assert _plain(p.plan.spec_out) == _plain(r.plan.spec_out), p.name
        assert _plain(p.plan.static) == _plain(r.plan.static), p.name
    for p, r in zip(port.pipe.coeffs(), ref.coeffs()):
        assert sorted(p or {}) == sorted(r or {})
        for k in p or {}:
            assert np.array_equal(np.asarray(p[k], np.float32),
                                  np.asarray(r[k], np.float32)), k


def test_config11_chain_and_new_stages(slice11):
    port, _, raw, _ = slice11
    assert port.fused_groups() == [STAGES[6:]]
    assert [k for k, *_ in port.steps] == ["stage"] * 6 + ["chain"]
    (chain,) = [a for k, _, _, a in port.steps if k == "chain"]
    records = chain.prog.view(-1, pointwise.RECORD)[:, :2].tolist()
    assert chain.fixed >= 0
    assert pointwise.FIXED[chain.fixed] == tuple(map(tuple, records))
    # every new stage changes its input by more than 1e-3 somewhere
    pipe = port.pipe
    x = torch.from_numpy(base.pad_to(raw, pipe.spec_in))
    for i, s in enumerate(pipe.stages):
        y = pipe.trace_fn(i, i + 1)(x, port.coeffs[i:i + 1])
        if s.name in NEW:
            assert (y - x).abs().max().item() > 1e-3, s.name
        x = y


def test_config11_calls_each_kernel_wrapper(monkeypatch):
    """RCD, ashift's homography warp, liquify's warp over its window, then
    the one chain."""
    raw, meta, _ = synth_raw(h=H, w=W, kind="gradients")
    calls = []
    for mod, name in ((rcd, "rcd_demosaic"), (warp, "homography_warp"),
                      (warp, "liquify_warp"),
                      (pointwise, "pointwise_chain")):
        real = getattr(mod, name)

        def spy(*args, _real=real, _name=name):
            calls.append(_name)
            return _real(*args)

        monkeypatch.setattr(mod, name, spy)
    ansel_tpu_torch.compile_pipeline(meta, _hist(ansel_tpu_torch),
                                     device="cpu").output_array(raw)
    assert calls == ["rcd_demosaic", "homography_warp", "liquify_warp",
                     "pointwise_chain"]


@pytest.mark.parametrize("fused", [False, True], ids=["per-op", "fused"])
def test_config11_matches_the_jax_package(slice11, fused, monkeypatch):
    _, got, raw, meta = slice11
    monkeypatch.setattr(ref_rcd, "rcd_demosaic",
                        lambda x, cfa, s: rcd_pallas.rcd_demosaic_pallas(
                            x, cfa, s, interpret=True))
    monkeypatch.setattr(ref_engine, "_FORCE_FUSION_INTERPRET", fused)
    ref_engine._COMPILE_CACHE.clear()
    try:
        want = np.asarray(ansel_tpu.compile_pipeline(meta, _hist(ansel_tpu))
                          .output_array(raw))
    finally:
        ref_engine._COMPILE_CACHE.clear()
    assert got.shape == want.shape == (3, H, W)
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0
    d = np.abs(got - want)
    assert d.max() <= DISPLAY_QUANTUM and d.mean() <= MEAN_TOL


CHECKER_HISTORY = (("exposure", {"exposure": 0.5}), ("colorchecker", None),
                   ("filmicrgb", {}))


@pytest.mark.parametrize("n,groups", [(12, 1), (24, 2)])
def test_colorchecker_runs_in_the_chain_up_to_12_patches(n, groups,
                                                         monkeypatch):
    """12 patches: one chain holds colorchecker, as the JAX package fuses
    it; 24: the stage runs alone between two chains, where the JAX
    package's pointwise spec is None and its fused run launches the chain
    kernel twice."""
    raw, meta, _ = synth_raw(h=32, w=48, kind="gradients")
    hist = [(op, p if p is not None else configs.checker_patches(n))
            for op, p in CHECKER_HISTORY]
    port = ansel_tpu_torch.compile_pipeline(
        meta, [ansel_tpu_torch.HistoryItem(o, dict(p)) for o, p in hist],
        device="cpu")
    names = [s.name for s in port.pipe.stages]
    i = names.index("colorchecker")
    chains = port.fused_groups()
    assert len(chains) == groups
    assert any("colorchecker" in g for g in chains) == (n <= 12)
    kinds = {j: k for k, j, _, _ in port.steps}
    assert (kinds.get(i) == "stage") == (n > 12)
    got = port.output_array(raw)

    launched = []
    real = ref_pw.pallas_pointwise
    monkeypatch.setattr(ref_pw, "pallas_pointwise",
                        lambda *a, **k: launched.append(1) or real(*a, **k))
    monkeypatch.setattr(ref_engine, "_FORCE_FUSION_INTERPRET", True)
    monkeypatch.setattr(ref_rcd, "rcd_demosaic",
                        lambda x, cfa, s: rcd_pallas.rcd_demosaic_pallas(
                            x, cfa, s, interpret=True))
    ref_engine._COMPILE_CACHE.clear()
    try:
        ref = ansel_tpu.compile_pipeline(
            meta, [ansel_tpu.HistoryItem(o, dict(p)) for o, p in hist])
        want = np.asarray(ref.output_array(raw))
    finally:
        ref_engine._COMPILE_CACHE.clear()
    rstage = ref.pipe.stages[i]
    assert rstage.name == "colorchecker"
    assert (rstage.op.pointwise_spec(rstage.plan, ref.pipe.ctx)
            is None) == (n > 12)
    assert len(launched) == groups
    d = np.abs(got - want)
    assert d.max() <= DISPLAY_QUANTUM and d.mean() <= MEAN_TOL
