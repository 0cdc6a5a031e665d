"""The port's config 12 (a hazy, back-lit landscape with a blown sky,
exported with film grain to an 8-bit file: exposure +1 EV, hazeremoval,
filmicrgb with its highlight reconstruction planned and fired, grain,
dither; the port's own history in ansel_tpu_torch/io/configs.py) against
ansel_tpu on the CPU at 96 x 160: the plan, statics and coefficients,
the chains and their specialised programs, the kernel wrappers the pipe
calls (the reconstruction's 2 x 3 scales x 2 passes of sepblur), and the
whole pipe against `ansel_tpu.compile_pipeline(...).output_array`, per
op and with its fused chains in interpret mode.

R12 (ROADMAP Queue 3), a fault of the JAX package, shows on this frame:
hazeremoval's ambient light is 0, because its bisected quantile of the
bright hazy pixels lies just above the clipped sky's tie, so no pixel is
selected; its transmission map is then 1 - 2e5 x, and the guided filter
over it cancels in float32, so an ulp's difference in its input moves
its output by more than a display level.  The port computes what
the JAX package computes (pinned below); to hold the rest of the pipe to
1/255, the comparison hands the JAX pipe the port's RCD twin (held
against the Pallas kernel in tests/test_torch_rcd.py) and, in
hazeremoval, the port's guided filter (held against the JAX package's in
tests/test_torch_guided.py), each through `jax.pure_callback`."""

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
from ansel_tpu.kernels import rcd as ref_rcd
from ansel_tpu.ops import hazeremoval as ref_haze
from ansel_tpu.pipeline import engine as ref_engine
from ansel_tpu_torch.core.types import CFAPattern
from ansel_tpu_torch.io import configs
from ansel_tpu_torch.kernels import pointwise, rcd, sepblur
from ansel_tpu_torch.ops import base
from ansel_tpu_torch.ops import hazeremoval as haze
from ansel_tpu_torch.pixel import guided

torch.set_num_threads(1)

STAGES = ["rawprepare", "temperature", "highlights", "demosaic",
          "hazeremoval", "exposure", "colorin", "filmicrgb", "_convert",
          "grain", "_convert", "colorout", "dither"]
NEW = ("hazeremoval", "filmicrgb", "grain", "dither")
H, W = 96, 160
SCALES = 3  # floor(log2(2 * 160 / 20 - 1)); 9 at 6016 columns
DISPLAY_QUANTUM = 1.0 / 255.0
# with the RCD twin and hazeremoval's guided filter shared: measured max
# 1.8e-5 per op and 1.9e-5 fused, mean 2.1e-7 (normal's log1p in the
# reconstruction's noise, XLA's fused products, grain's deviation)
MEAN_TOL = 1e-5


def _hist(pkg):
    return [pkg.HistoryItem(op, dict(p)) for op, p in configs.HISTORIES[12]]


def _plain(v):
    if isinstance(v, enum.Enum):
        return v.value
    if dataclasses.is_dataclass(v):
        return tuple(_plain(getattr(v, f.name)) for f in dataclasses.fields(v))
    if isinstance(v, (tuple, list)):
        return tuple(_plain(x) for x in v)
    return v


@pytest.fixture(scope="module")
def slice12():
    raw, meta, _ = synth_raw(h=H, w=W, kind="gradients")
    port = ansel_tpu_torch.compile_pipeline(meta, _hist(ansel_tpu_torch),
                                            device="cpu")
    before = (rcd.LAUNCHES, sepblur.LAUNCHES, pointwise.LAUNCHES)
    got = port.output_array(raw)
    assert (rcd.LAUNCHES, sepblur.LAUNCHES, pointwise.LAUNCHES) == before
    return port, got, raw, meta


def test_config12_plan_and_coeffs_equal_reference(slice12):
    port, _, _, meta = slice12
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
    filmic = port.pipe.stages[STAGES.index("filmicrgb")]
    assert filmic.plan.static[5] == (SCALES, 1)


def test_config12_chains_and_programs(slice12):
    """[exposure, colorin], [_convert], [_convert, colorout] run as
    chains, each its own program; filmicrgb runs alone (its
    reconstruction is spatial) and tone-maps through the one-stage AgX
    program."""
    port = slice12[0]
    assert port.fused_groups() == [STAGES[5:7], STAGES[8:9], STAGES[10:12]]
    chains = [a for k, _, _, a in port.steps if k == "chain"]
    for chain in chains:
        recs = chain.prog.view(-1, pointwise.RECORD)[:, :2].tolist()
        assert chain.fixed >= 0
        assert pointwise.FIXED[chain.fixed] == tuple(map(tuple, recs))


def test_config12_calls_each_kernel_wrapper(monkeypatch):
    """RCD; the first chain; filmicrgb's reconstruction (the census fires
    on this frame): per scale its low-pass at 2^s and the inpainting blur,
    in the RGB pass and the ratio pass; the AgX chain; to Lab; grain's
    three box means (3 taps); the last chain."""
    raw, meta, _ = synth_raw(h=H, w=W, kind="gradients")
    calls = []
    for mod, name in ((rcd, "rcd_demosaic"), (sepblur, "sep_blur"),
                      (pointwise, "pointwise_chain")):
        real = getattr(mod, name)

        def spy(*args, _real=real, _name=name):
            calls.append(_name if _name != "sep_blur"
                         else (len(args[1]), args[2]))
            return _real(*args)

        monkeypatch.setattr(mod, name, spy)
    ansel_tpu_torch.compile_pipeline(meta, _hist(ansel_tpu_torch),
                                     device="cpu").output_array(raw)
    rec = [(5, d) for s in range(SCALES) for d in (1 << s, 1)] * 2
    assert calls == (["rcd_demosaic", "pointwise_chain"] + rec
                     + ["pointwise_chain", "pointwise_chain"]
                     + [(3, 1)] * 3 + ["pointwise_chain"])


def test_config12_new_stages_change_their_input(slice12):
    port, _, raw, _ = slice12
    pipe = port.pipe
    x = torch.from_numpy(base.pad_to(raw, pipe.spec_in))
    for i, s in enumerate(pipe.stages):
        y = pipe.trace_fn(i, i + 1)(x, port.coeffs[i:i + 1])
        if s.name in NEW:
            assert (y - x).abs().max().item() > 1e-3, s.name
        x = y


def _ambient_selection(x, pkg):
    """hazeremoval's two bisected quantiles on x and the count of pixels
    its ambient light averages, in either package."""
    if pkg == "torch":
        dark = haze.box_min(torch.amin(x, dim=0), haze.W1)
        size = torch.tensor(dark.numel() * 0.95 + 1.0, dtype=torch.float32)
        crit = haze._bisect_quantile(dark, size, dark.min(), dark.max())
        hazy = dark >= crit
        sums = x[0] + x[1] + x[2]
        bright = haze._bisect_quantile(
            sums, hazy.sum().to(torch.float32) * 0.95 + 1.0, sums.min(),
            sums.max(), mask=hazy)
        return int(hazy.sum()), int((hazy & (sums >= bright)).sum())
    dark = ref_haze.box_min(jnp.min(x, axis=0), ref_haze.W1)
    crit = ref_haze._bisect_quantile(dark, dark.size * 0.95 + 1.0,
                                     jnp.min(dark), jnp.max(dark))
    hazy = dark >= crit
    sums = x[0] + x[1] + x[2]
    bright = ref_haze._bisect_quantile(
        sums, jnp.sum(hazy).astype(jnp.float32) * 0.95 + 1.0, jnp.min(sums),
        jnp.max(sums), mask=hazy)
    return int(jnp.sum(hazy)), int(jnp.sum(hazy & (sums >= bright)))


def test_config12_hazeremoval_ambient_light_is_empty_r12(slice12):
    """R12, pinned: on the clipped sky the bright quantile lands just above
    the tie, so hazeremoval averages no pixel into its ambient light (0)
    in both packages; every input value one ulp higher then moves its
    output by more than a display level."""
    port, _, raw, _ = slice12
    pipe = port.pipe
    i = STAGES.index("hazeremoval")
    x = pipe.trace_fn(0, i)(torch.from_numpy(base.pad_to(raw, pipe.spec_in)),
                            port.coeffs[:i])
    n_hazy, n_sel = _ambient_selection(x, "torch")
    assert n_hazy > 0 and n_sel == 0
    assert _ambient_selection(jnp.asarray(x.numpy()), "jax") == (n_hazy, 0)
    run = pipe.trace_fn(i, i + 1)
    y = run(x, port.coeffs[i:i + 1])
    up = run(torch.nextafter(x, torch.full_like(x, 2.0)), port.coeffs[i:i + 1])
    assert (up - y).abs().max().item() > DISPLAY_QUANTUM   # measured 0.010


def _shared(monkeypatch):
    """The JAX pipe with the port's RCD twin and, in hazeremoval, the
    port's guided filter (R12: see the module's docstring)."""
    def rcd_shared(x, cfa, scaler):
        def f(x, s):
            return rcd.rcd_demosaic(torch.from_numpy(np.array(x)),
                                    CFAPattern[cfa.name],
                                    torch.from_numpy(np.array(s))).numpy()
        return jax.pure_callback(
            f, jax.ShapeDtypeStruct((3,) + x.shape, jnp.float32), x, scaler)

    def guided_shared(g, s, r, eps):
        def f(g, s):
            return guided.guided_filter(torch.from_numpy(np.array(g)),
                                        torch.from_numpy(np.array(s)), r,
                                        eps).numpy()
        return jax.pure_callback(
            f, jax.ShapeDtypeStruct(g.shape, jnp.float32), g, s)

    monkeypatch.setattr(ref_rcd, "rcd_demosaic", rcd_shared)
    monkeypatch.setattr(ref_haze, "guided_filter", guided_shared)


@pytest.mark.parametrize("fused", [False, True], ids=["per-op", "fused"])
def test_config12_matches_the_jax_package(slice12, fused, monkeypatch):
    _, got, raw, meta = slice12
    _shared(monkeypatch)
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


def test_config12_reconstruction_census_fires(slice12):
    """The clip mask's census (arg < 4, more than 9 pixels) on filmicrgb's
    input; with the reconstruction the tone-mapped frame differs."""
    port, _, raw, _ = slice12
    pipe = port.pipe
    i = STAGES.index("filmicrgb")
    x = pipe.trace_fn(0, i)(torch.from_numpy(base.pad_to(raw, pipe.spec_in)),
                            port.coeffs[:i])
    c = port.coeffs[i]
    norm = torch.sqrt(torch.sum(x * x, dim=0))
    arg = -norm * (c["rec_feather"] / c["rec_threshold"]) + c["rec_feather"]
    assert int(torch.sum(arg < 4.0)) > 9
    stage = pipe.stages[i]
    with_rec = stage.op.apply(x, c, stage.plan, pipe.ctx)
    without = stage.op._agx(x, c, stage.plan.static)
    assert (with_rec - without).abs().max().item() > 1e-2
