"""The port's ops that draw JAX's generator's noise (`pixel/prng`) against
ansel_tpu on the CPU: grain, dither (every type), censorize (the sepblur
and IIR blurs, pixelation, noise), crystgrain (mono and colour),
filmicrgb's highlight reconstruction (census fired and not, one and two
passes) and the highlights Laplacian's salt.  For each, the plan and the
coefficients bit for bit and `apply` on a small seeded input within the
stated tolerance.  Inputs come from numpy seeds and go to both packages
as the same float32 arrays."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ansel_tpu.core import types as ref_types
from ansel_tpu.core.params import params_class as ref_params_class
from ansel_tpu.core.types import CFAPattern as RefCFA
from ansel_tpu.kernels import highlights_laplacian as ref_hl
from ansel_tpu.ops import base as ref_base
from ansel_tpu_torch.core import types as port_types
from ansel_tpu_torch.core.params import params_class
from ansel_tpu_torch.core.types import CFAPattern
from ansel_tpu_torch.kernels import highlights_laplacian as hl
from ansel_tpu_torch.kernels import pointwise, sepblur
from ansel_tpu_torch.ops import base as port_base
from ansel_tpu_torch.pipeline.engine import coeffs_to_device

torch.set_num_threads(1)

H, W = 96, 136
# What the two packages round differently, per op (measured maxima):
#   grain: jnp.std's reduction against torch's, and normal's log1p
#     (5e-7 of the draw), scaled by 25 L units: 7.6e-6 on L in [0, 100];
#   dither: the same uniform bits and float32 order; XLA fuses the
#     noise's product into the sum where the amplitude is not a power of
#     two: 6e-8 (one ulp);
#   censorize: XLA's resize product order and the IIR's blocked form:
#     1.1e-6;
#   crystgrain: the same uniform and randint bits and the same stencil
#     order against the JAX package run op by op: 0;
#   filmicrgb: normal's 5e-7 through the noise and the wavelet scales,
#     XLA's fused products, then the AgX curve: 3.5e-6 in display RGB;
#   the salted Laplacian: as tests/test_torch_laplacian.py holds the
#     unsalted one (ties of the guiding channel).
TOL = {"grain": 5e-5, "dither": 1.2e-7, "censorize": 2e-6, "crystgrain": 0.0,
       "filmicrgb": 2e-5}
LAPLACIAN_TOL, LAPLACIAN_TIE_TOL, TIE_SHARE = 1e-5, 1e-3, 0.05


def _image(kind, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    base = 0.45 + 0.35 * np.sin(xx / 9.0) * np.cos(yy / 13.0)
    base[H // 4: H // 2, W // 3: W // 2] += 0.3
    base += rng.normal(0.0, 0.02, (H, W))
    if kind == "LAB":
        return np.stack([np.clip(base, 0.0, 1.0) * 100.0,
                         rng.uniform(-30, 30, (H, W)),
                         rng.uniform(-30, 30, (H, W))]).astype(np.float32)
    rgb = np.stack([np.roll(base, s, axis=1) * f
                    for s, f in ((2, 0.9), (0, 1.0), (-2, 0.75))])
    if kind == "DISPLAY_RGB":
        return np.clip(rgb, 0.0, 1.0).astype(np.float32)
    return np.clip(rgb, 0.0, None).astype(np.float32)


def _pair(module, cls, params, kind, pm=(1.0, 1.0, 1.0)):
    out = []
    for pkg, types, base, pcls in (
            ("ansel_tpu", ref_types, ref_base, ref_params_class),
            ("ansel_tpu_torch", port_types, port_base, params_class)):
        op = getattr(importlib.import_module(f"{pkg}.ops.{module}"), cls)()
        p = pcls(op.name)(**params)
        ctx = base.PlanContext(meta=types.RawMeta(width=W, height=H))
        ctx.processed_maximum = pm
        spec = types.ImageSpec(width=W, height=H,
                               colorspace=getattr(types.Colorspace, kind),
                               channels=3)
        plan = op.plan(ctx, spec, p)
        out.append((op, ctx, plan, op.coeffs(ctx, plan, p)))
    return out


def _equal_coeffs(a, b):
    """Coefficient trees equal bit for bit (crystgrain's banks hold lists
    of arrays of unlike shapes)."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal_coeffs(a[k], b[k])
    elif isinstance(a, (list, tuple)) and a and not np.isscalar(a[0]):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _equal_coeffs(u, v)
    else:
        assert np.array_equal(np.asarray(a, np.float32),
                              np.asarray(b, np.float32))


CASES = [
    ("grain", "grain", "Grain", {}, "LAB"),
    ("grain-fine", "grain", "Grain", {"scale": 0.8, "midtones_bias": 30.0},
     "LAB"),
] + [
    (f"dither-{t}", "dither", "Dither", {"dither_type": t}, "DISPLAY_RGB")
    for t in range(6)
] + [
    # the random mode at -20 dB (its default -200 dB adds 1e-10)
    ("dither-6", "dither", "Dither", {"dither_type": 6, "damping": -20.0},
     "DISPLAY_RGB"),
    ("censorize", "censorize", "Censorize",
     {"radius_1": 3.0, "pixelate": 8.0, "radius_2": 6.0, "noise": 0.2},
     "WORK_RGB"),
    ("censorize-blur", "censorize", "Censorize",
     {"radius_1": 5.0, "radius_2": 1.5}, "WORK_RGB"),
    ("crystgrain-mono", "crystgrain", "CrystGrain", {"layers": 4},
     "WORK_RGB"),
    ("crystgrain-colour", "crystgrain", "CrystGrain",
     {"layers": 3, "mode": 1, "grain_size": 6.0}, "WORK_RGB"),
]


def _tol(name):
    return TOL[name.split("-")[0]]


@pytest.mark.parametrize("name,module,cls,params,kind", CASES,
                         ids=[c[0] for c in CASES])
def test_plan_and_coeffs_equal_the_jax_package(name, module, cls, params,
                                               kind):
    (_, _, rplan, rco), (_, _, pplan, pco) = _pair(module, cls, params, kind)
    assert pplan.static == rplan.static
    assert pplan.spec_out == pplan.spec_in
    assert (rco is None) == (pco is None)
    if rco is not None:
        _equal_coeffs(pco, rco)


@pytest.mark.parametrize("name,module,cls,params,kind", CASES,
                         ids=[c[0] for c in CASES])
def test_apply_matches_the_jax_package(name, module, cls, params, kind):
    (rop, rctx, rplan, rco), (pop, pctx, pplan, pco) = _pair(
        module, cls, params, kind)
    x = _image(kind, seed=len(name))
    fn = lambda v: rop.apply(v, rco, rplan, rctx)  # noqa: E731
    # crystgrain runs op by op (its jitted graph of stencils compiles for
    # minutes at any size)
    want = np.asarray((fn if module == "crystgrain" else jax.jit(fn))(
        jnp.asarray(x)))
    c = coeffs_to_device([pco], "cpu")[0]
    got = pop.apply(torch.from_numpy(x), c, pplan, pctx).numpy()
    assert got.shape == want.shape == x.shape
    assert np.isfinite(got).all()
    changed = np.abs(got - x).max()
    assert (changed == 0.0) if name == "dither-0" else (changed > 1e-4)
    assert np.abs(got - want).max() <= _tol(name)


FILMIC = {"reconstruct_threshold": -3.0}
FILMIC_CASES = [
    ("fired-hq1", dict(FILMIC), 1.0),
    ("fired-hq0", dict(FILMIC, high_quality_reconstruction=0), 1.0),
    # every norm under the clip mask's census threshold: planned, not run
    ("not-fired", dict(FILMIC), 0.05),
]


@pytest.mark.parametrize("name,params,gain", FILMIC_CASES,
                         ids=[c[0] for c in FILMIC_CASES])
def test_filmic_highlight_reconstruction(name, params, gain, monkeypatch):
    """The JAX package's apply (its lax.cond census and its AgX tone map)
    against the port's (the census read once, the AgX map as config 12's
    one-stage chain program); the a-trous blurs go to the sepblur
    wrapper, two a scale and pass (the low frequencies at 2^s, the
    inpainting blur at 1)."""
    (rop, rctx, rplan, rco), (pop, pctx, pplan, pco) = _pair(
        "filmicrgb", "FilmicRGB", params, "WORK_RGB", pm=(4.0, 4.0, 4.0))
    scales = 3  # floor(log2(2 * 136 / 20 - 1))
    hq = params.get("high_quality_reconstruction", 1)
    assert rplan.static == pplan.static
    assert pplan.static[5] == (scales, hq)
    assert pop.pointwise_spec(pplan, pctx) is None
    _equal_coeffs(pco, rco)
    x = _image("WORK_RGB", seed=5) * gain * 2.5
    want = np.asarray(jax.jit(lambda v: rop.apply(v, rco, rplan, rctx))(
        jnp.asarray(x)))
    c = coeffs_to_device([pco], "cpu")[0]
    blurs, chains = [], []
    real_blur, real_chain = sepblur.sep_blur, pointwise.pointwise_chain
    monkeypatch.setattr(sepblur, "sep_blur", lambda v, t, d=1:
                        blurs.append(d) or real_blur(v, t, d))
    monkeypatch.setattr(pointwise, "pointwise_chain", lambda v, ch:
                        chains.append(ch) or real_chain(v, ch))
    got = pop.apply(torch.from_numpy(x), c, pplan, pctx).numpy()
    fired = name != "not-fired"
    norm = np.sqrt((x.astype(np.float64) ** 2).sum(0))
    threshold = float(pco["rec_threshold"]) * 0.75  # (feather - 4) / feather
    assert (np.sum(norm > threshold) > 9) == fired
    assert blurs == ([d for s in range(scales) for d in (1 << s, 1)]
                     * (1 + hq) if fired else [])
    (chain,) = chains
    assert pointwise.FIXED[chain.fixed] == ((pointwise.OP_FILMIC_AGX, 0),)
    assert got.shape == want.shape == x.shape
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0
    assert np.abs(got - want).max() <= TOL["filmicrgb"]
    if fired:
        # the reconstruction changed the tone-mapped image
        no_rec = pop._agx(torch.from_numpy(x), c, pplan.static).numpy()
        assert np.abs(got - no_rec).max() > 1e-3


def test_filmic_without_reconstruction_stays_in_the_chain():
    (_, _, rplan, _), (pop, pctx, pplan, _) = _pair(
        "filmicrgb", "FilmicRGB", {}, "WORK_RGB")
    assert rplan.static[5] is None and pplan.static[5] is None
    assert pop.pointwise_spec(pplan, pctx).opcode == pointwise.OP_FILMIC_AGX


def _clipped_mosaic(h, w, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.05, 0.6, (h, w)).astype(np.float32)
    x[20:44, 30:70] = rng.uniform(0.9, 1.2, (24, 40)).astype(np.float32)
    return x


@pytest.mark.parametrize("cfa,iterations", [("RGGB", 2), ("GBRG", 1)])
def test_laplacian_salt_matches_the_jax_package(cfa, iterations):
    """The salted last iteration: normal bits from the last key of
    split(PRNGKey(0x411E), iterations)."""
    x = _clipped_mosaic(72, 104, seed=iterations)
    clips = [0.8, 0.85, 0.9]
    want = np.asarray(ref_hl.laplacian_reconstruct(
        jnp.asarray(x), clips, RefCFA[cfa], 8, iterations, 0.1, 0.5))
    got = hl.laplacian_reconstruct(torch.from_numpy(x), torch.tensor(clips),
                                   CFAPattern[cfa], 8, iterations, 0.1,
                                   0.5).numpy()
    plain = hl.laplacian_reconstruct(torch.from_numpy(x),
                                     torch.tensor(clips), CFAPattern[cfa], 8,
                                     iterations, 0.0, 0.5).numpy()
    d = np.abs(got - want)
    assert d.max() <= LAPLACIAN_TIE_TOL
    assert np.mean(d > LAPLACIAN_TOL) <= TIE_SHARE
    assert np.abs(got - plain).max() > 1e-3  # the salt moved the result


@pytest.mark.parametrize("shape,out", [((3, 9, 13), (3, 96, 136)),
                                       ((3, 37, 53), (3, 10, 61)),
                                       ((2, 12, 17), (2, 12, 17))])
def test_resize_nearest_matches_jax_image_resize(shape, out):
    """censorize's pixelation upsample: `jax.image.resize(..., "nearest")`
    index for index."""
    from ansel_tpu_torch.pixel.resample import resize_nearest

    x = np.random.default_rng(sum(shape)).random(shape).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), out, "nearest"))
    got = resize_nearest(torch.from_numpy(x), out).numpy()
    assert got.shape == want.shape == out
    assert np.array_equal(got, want)


def test_crystgrain_banks_through_the_pipe():
    """crystgrain's coefficients hold a list of patches of unlike shapes:
    the engine moves them to the device as lists of tensors, and a second
    pipe of the same history reuses the first one's (the fingerprint
    reads them too)."""
    import ansel_tpu_torch
    from ansel_tpu_torch.io.synthetic import synth_raw

    raw, meta, _ = synth_raw(h=48, w=72)
    hist = [ansel_tpu_torch.HistoryItem("crystgrain", {"layers": 2})]
    a = ansel_tpu_torch.compile_pipeline(meta, hist, device="cpu")
    i = [s.name for s in a.pipe.stages].index("crystgrain")
    patches = a.coeffs[i]["patches"]
    assert len(patches) == 2 and all(len(row) == 4 for row in patches)
    assert all(isinstance(p, torch.Tensor) and p.shape[0] == p.shape[1]
               for row in patches for p in row)
    b = ansel_tpu_torch.compile_pipeline(meta, hist, device="cpu")
    assert b.coeffs is a.coeffs
    assert np.isfinite(a.output_array(raw)).all()
