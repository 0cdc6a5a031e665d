"""The port's config 15 (a back-lit landscape on a low-ISO Bayer body:
HARMONIC highlights at the module's defaults, RCD under the dual blend
with green equilibration 3 and two passes of colour smoothing, then
config 1's develop; the port's own history in ansel_tpu_torch/io/
configs.py) against ansel_tpu on the CPU at 128 x 256, where the dome
pyramid has 2 levels: the plan, statics and coefficients, the chain's
program, the kernel wrappers the pipe calls, and the whole pipe against
`ansel_tpu.compile_pipeline(...).output_array` at the module's default
30 iterations.

R15 (ROADMAP Queue 3), a property of the guided Laplacian (the JAX
package's function, which the port's computes: tests/
test_torch_laplacian.py) that shows on this mosaic: 41% of its green
photosites sit at the white level, and on such a frame the 30 iterations
amplify a one-ulp change of the input (~10x every 5 iterations) until
the reconstruction moves by 0.27.  So the
comparisons hand the JAX pipe the port's RCD twin (held against the
Pallas kernel in tests/test_torch_rcd.py) and the port's
`laplacian_reconstruct` (held against the JAX package's in
tests/test_torch_laplacian.py) through `jax.pure_callback`: the
highlights stage with the JAX package's own dome core, then the whole
pipe with the port's core shared too, so that the demosaic branches and
the chain are the JAX package's."""

import dataclasses
import enum

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ansel_tpu
import ansel_tpu_torch
from ansel_tpu.io.synthetic import synth_raw
from ansel_tpu.kernels import highlights_harmonic as ref_hh
from ansel_tpu.kernels import highlights_laplacian as ref_hl
from ansel_tpu.kernels import rcd as ref_rcd
from ansel_tpu.pipeline import engine as ref_engine
from ansel_tpu_torch.core.types import CFAPattern
from ansel_tpu_torch.io import configs
from ansel_tpu_torch.kernels import highlights_harmonic as hh
from ansel_tpu_torch.kernels import highlights_laplacian as hl
from ansel_tpu_torch.kernels import pointwise, rcd, sepblur
from ansel_tpu_torch.ops import base

torch.set_num_threads(1)

STAGES = ["rawprepare", "temperature", "highlights", "demosaic", "exposure",
          "colorin", "channelmixerrgb", "filmicrgb", "colorout"]
H, W = 128, 256
DISPLAY_QUANTUM = 1.0 / 255.0
# the highlights stage with the JAX package's dome core (measured 2.3e-4
# on mosaic values up to 2.6: the CG sums' order over 30-100 iterations)
CORE_TOL = 1e-3
# the whole pipe with RCD, the Laplacian and the core shared: the detail
# mask's sqrt and exp, the chain's transcendental functions (measured max
# 3.6e-5, mean 2.7e-7)
MEAN_TOL = 1e-5


def _hist(pkg):
    return [pkg.HistoryItem(op, dict(p)) for op, p in configs.HISTORIES[15]]


def _plain(v):
    if isinstance(v, enum.Enum):
        return v.value
    if dataclasses.is_dataclass(v):
        return tuple(_plain(getattr(v, f.name)) for f in dataclasses.fields(v))
    if isinstance(v, (tuple, list)):
        return tuple(_plain(x) for x in v)
    return v


@pytest.fixture(scope="module")
def slice15():
    raw, meta, _ = synth_raw(h=H, w=W, kind="gradients")
    raw = configs.mosaic15(raw, meta)
    port = ansel_tpu_torch.compile_pipeline(meta, _hist(ansel_tpu_torch),
                                            device="cpu")
    before = (rcd.LAUNCHES, sepblur.LAUNCHES, pointwise.LAUNCHES)
    got = port.output_array(raw)
    assert (rcd.LAUNCHES, sepblur.LAUNCHES, pointwise.LAUNCHES) == before
    return port, got, raw, meta


def test_config15_mosaic_clips_every_channel(slice15):
    """Each channel's share at white and the share of 2x2 cells clipped in
    all four photosites: at least 1% each (the per-channel domes and the
    all-clip core both fire), the all-clip cells under 40%."""
    _, _, raw, meta = slice15
    shares = configs.clip_shares(raw, meta)
    assert min(shares.values()) >= 0.01 and shares["all"] < 0.4
    assert raw.dtype == np.float32 and raw.max() == meta.white_point


def test_config15_plan_and_coeffs_equal_reference(slice15):
    port, _, _, meta = slice15
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
    hl_static = port.pipe.stages[2].plan.static
    dm_static = port.pipe.stages[3].plan.static
    assert hl_static == (4, 8, 30, 0.0, 0.5)
    assert dm_static == (0x2005, 3, 0.0, 2, 1, 0.2)


def test_config15_chain_is_program_0(slice15):
    port = slice15[0]
    assert port.fused_groups() == [STAGES[4:]]
    assert [k for k, *_ in port.steps] == ["stage"] * 4 + ["chain"]
    (chain,) = [a for k, _, _, a in port.steps if k == "chain"]
    assert chain.fixed == 0


def test_config15_calls_each_kernel_wrapper(monkeypatch):
    """The guided Laplacian's 360 blurs (30 iterations x 2 passes x 6
    scales at dilations 1-32), then RCD under the dual blend, then the
    chain; the dome core, VNG4, the detail mask and the post passes are
    plain torch.  At 128 x 256 the Laplacian plans 6 scales, as at 24
    MP."""
    raw, meta, _ = synth_raw(h=H, w=W, kind="gradients")
    raw = configs.mosaic15(raw, meta)
    calls = []
    for mod, name in ((rcd, "rcd_demosaic"), (sepblur, "sep_blur"),
                      (pointwise, "pointwise_chain")):
        real = getattr(mod, name)

        def spy(*args, _real=real, _name=name):
            calls.append(_name if _name != "sep_blur" else args[2])
            return _real(*args)

        monkeypatch.setattr(mod, name, spy)
    ansel_tpu_torch.compile_pipeline(meta, _hist(ansel_tpu_torch),
                                     device="cpu").output_array(raw)
    blurs = [1 << s for s in range(6)] * 2 * 30
    assert calls == blurs + ["rcd_demosaic", "pointwise_chain"]


def test_config15_branches_change_their_input(slice15):
    """HARMONIC's core moves the Laplacian's reconstruction; the dual
    blend, green equilibration and smoothing move RCD's output."""
    port, _, raw, _ = slice15
    pipe = port.pipe
    x = pipe.trace_fn(0, 2)(torch.from_numpy(base.pad_to(raw, pipe.spec_in)),
                            port.coeffs[:2])
    c = port.coeffs[2]
    rec = hl.laplacian_reconstruct(x, c["clips"], CFAPattern.RGGB, 8, 30,
                                   0.0, 0.5)
    y = pipe.trace_fn(2, 3)(x, port.coeffs[2:3])
    assert (y - rec).abs().max().item() > 0.05
    assert torch.equal(y, hh.harmonic_dome_core(x, rec, c["clips"],
                                                CFAPattern.RGGB))
    d = port.coeffs[3]
    rgb = pipe.trace_fn(3, 4)(y, port.coeffs[3:4])
    plain = rcd.rcd_demosaic(y, CFAPattern.RGGB, d["scaler"])
    assert (rgb - plain).abs().max().item() > 1e-3


@pytest.mark.parametrize("iterations,moves", [(10, False), (30, True)])
def test_config15_laplacian_amplifies_an_ulp_r15(slice15, iterations, moves):
    """R15, pinned: on config 15's highlights input, every input value
    one ulp higher moves the guided Laplacian's reconstruction by less
    than 1e-4 after 10 iterations and by more than 0.1 after the
    module's default 30 (measured 1.7e-5 and 0.27)."""
    port, _, raw, _ = slice15
    pipe = port.pipe
    x = pipe.trace_fn(0, 2)(torch.from_numpy(base.pad_to(raw, pipe.spec_in)),
                            port.coeffs[:2])
    clips = port.coeffs[2]["clips"]
    up = torch.nextafter(x, torch.full_like(x, 4.0))
    a = hl.laplacian_reconstruct(x, clips, CFAPattern.RGGB, 8, iterations,
                                 0.0, 0.5)
    b = hl.laplacian_reconstruct(up, clips, CFAPattern.RGGB, 8, iterations,
                                 0.0, 0.5)
    moved = (a - b).abs().max().item()
    assert moved > 0.1 if moves else moved < 1e-4


def _shared(monkeypatch, core=False):
    """The JAX pipe with the port's RCD twin and Laplacian (R15: see the
    module's docstring); with `core`, the port's dome core too."""
    def rcd_shared(x, cfa, scaler):
        def f(x, s):
            return rcd.rcd_demosaic(torch.from_numpy(np.array(x)),
                                    CFAPattern[cfa.name],
                                    torch.from_numpy(np.array(s))).numpy()
        return jax.pure_callback(
            f, jax.ShapeDtypeStruct((3,) + x.shape, jnp.float32), x, scaler)

    def laplacian_shared(x, clips, cfa, *args, **kw):
        def f(x, c):
            return hl.laplacian_reconstruct(
                torch.from_numpy(np.array(x)), torch.from_numpy(np.array(c)),
                CFAPattern[cfa.name], *args, **kw).numpy()
        return jax.pure_callback(
            f, jax.ShapeDtypeStruct(x.shape, jnp.float32), x,
            jnp.asarray(clips, jnp.float32))

    def core_shared(x, rec, clips, cfa):
        def f(x, r, c):
            return hh.harmonic_dome_core(
                torch.from_numpy(np.array(x)), torch.from_numpy(np.array(r)),
                torch.from_numpy(np.array(c)), CFAPattern[cfa.name]).numpy()
        return jax.pure_callback(
            f, jax.ShapeDtypeStruct(x.shape, jnp.float32), x, rec,
            jnp.asarray(clips, jnp.float32))

    monkeypatch.setattr(ref_rcd, "rcd_demosaic", rcd_shared)
    monkeypatch.setattr(ref_hl, "laplacian_reconstruct", laplacian_shared)
    if core:
        monkeypatch.setattr(ref_hh, "harmonic_dome_core", core_shared)


def test_config15_highlights_stage_matches_the_jax_package(slice15,
                                                          monkeypatch):
    """The HARMONIC stage with the JAX package's own dome core (the
    Laplacian shared, R15) on config 15's mosaic: its CG sums reduce in
    another order than torch's, within CORE_TOL on values up to 2.6."""
    port, _, raw, meta = slice15
    _shared(monkeypatch)
    ref = ansel_tpu.Pipeline(meta, _hist(ansel_tpu))
    x = base.pad_to(raw, port.pipe.spec_in)
    want = np.asarray(jax.jit(ref.trace_fn(0, 3))(x, ref.coeffs()[:3]))
    got = port.pipe.trace_fn(0, 3)(torch.from_numpy(x), port.coeffs[:3])
    assert np.abs(got.numpy() - want).max() <= CORE_TOL


def test_config15_matches_the_jax_package(slice15, monkeypatch):
    """The whole pipe with RCD, the Laplacian and the dome core shared:
    green equilibration, the dual blend's VNG4, smoothing and detail mask,
    colour smoothing and the chain are the JAX package's.  (With the core
    not shared, its 2.3e-4 at the mosaic crosses RCD's and VNG's direction
    choices at a few pixels, past the display quantum.)"""
    _, got, raw, meta = slice15
    _shared(monkeypatch, core=True)
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
