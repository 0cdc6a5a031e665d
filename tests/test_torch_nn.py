"""rawdenoiseai's U-Net (`ansel_tpu_torch/io/anselnn.py`,
`kernels/unet.py`, `ops/rawdenoiseai.py`) against ansel_tpu on the CPU:
the `.anselnn` container across the two packages, `unet_forward`, the op
for the single-scale and the multi-scale net with its low-band anchor on
Bayer and X-Trans (plan and coefficients exactly, the output within
OP_TOL), the anchor alone, its reflect padding and linear resize, and
the port's config 17 (config 16's noisy mosaic, rawdenoiseai, config 1's
develop) against the JAX pipe.  tests/test_nn.py's cases run on the port
too.

Tolerances: U-Net outputs within UNET_TOL (measured 8.7e-11 on outputs
up to 3.2e-4: XLA's and oneDNN's float32 convolutions sum in other
orders); the op on mosaics in [0, 0.6] within OP_TOL (measured 1.2e-7:
the anchor's 16-px block sums); the resize within RESIZE_TOL (measured
4.8e-7 at x16); config 17 within the display quantum and MEAN_TOL with
the port's RCD twin handed to the JAX pipe (as tests/test_torch_blend.py
does; measured max 3.0e-5, mean 2.2e-7: the chain's pow, log2 and
exp)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ansel_tpu
import ansel_tpu_torch
from ansel_tpu.core import types as ref_types
from ansel_tpu.io import anselnn as ref_nn
from ansel_tpu.io.synthetic import synth_raw
from ansel_tpu.kernels import unet as ref_unet
from ansel_tpu.ops import _bayer as ref_bayer
from ansel_tpu.ops import base as ref_base
from ansel_tpu.ops import rawdenoiseai as ref_ai
from ansel_tpu.pipeline import engine as ref_engine
from ansel_tpu_torch.core import types
from ansel_tpu_torch.io import anselnn, configs
from ansel_tpu_torch.kernels import unet
from ansel_tpu_torch.ops import _bayer
from ansel_tpu_torch.ops import base as ops_base
from ansel_tpu_torch.ops import rawdenoiseai as ai
from ansel_tpu_torch.pipeline.engine import coeffs_to_device
from test_torch_blend import share_rcd

torch.set_num_threads(1)

UNET_TOL = 1e-8
OP_TOL = 2e-6
RESIZE_TOL = 1e-6
DISPLAY_QUANTUM = 1.0 / 255.0
MEAN_TOL = 1e-6
H, W = 64, 128


def _models():
    """(label, JAX model, port model): each built by its own package."""
    return [("unet", ref_nn.random_unet(base=4, depth=2, seed=3),
             anselnn.random_unet(base=4, depth=2, seed=3)),
            ("unet-ms", ref_nn.random_unet_ms(base=4, depth=2, seed=5),
             anselnn.random_unet_ms(base=4, depth=2, seed=5))]


@pytest.mark.parametrize("label", ["unet", "unet-ms"])
def test_random_models_equal_the_jax_package(label):
    _, ref, port = next(m for m in _models() if m[0] == label)
    assert port.cfg == ref.cfg
    assert list(port.tensors) == list(ref.tensors)
    for k, v in ref.tensors.items():
        assert port.tensors[k].dtype == v.dtype
        assert np.array_equal(port.tensors[k], v), k


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("label", ["unet", "unet-ms"])
def test_anselnn_files_cross_the_two_packages(tmp_path, label, writer):
    """A file either package writes is byte-identical to the other's and
    loads bit for bit in both."""
    _, ref, port = next(m for m in _models() if m[0] == label)
    a, b = str(tmp_path / "a.anselnn"), str(tmp_path / "b.anselnn")
    save = ref_nn.save_anselnn if writer == "jax" else anselnn.save_anselnn
    save(a, ref.cfg, ref.tensors)
    (anselnn.save_anselnn if writer == "jax" else ref_nn.save_anselnn)(
        b, port.cfg, port.tensors)
    assert open(a, "rb").read() == open(b, "rb").read()
    for load in (ref_nn.load_anselnn, anselnn.load_anselnn):
        back = load(a)
        assert back.cfg == ref.cfg and back.arch == ref.arch
        for k, v in ref.tensors.items():
            assert np.array_equal(back.tensors[k], v), k
    ms = anselnn.load_anselnn(a)
    if label == "unet-ms":
        assert ms.has_coarse and ms.anchor == 1
        assert (ms.bin_for(False), ms.bin_for(True)) == (4, 6)
        assert ms.stage("fine").in_channels == 8
        assert ms.stage("coarse").out_channels == 3


def test_anselnn_rejects_another_file(tmp_path):
    p = tmp_path / "x.anselnn"
    p.write_bytes(b"NOTANSEL" + b"\0" * 8)
    with pytest.raises(ValueError, match="ANSELDN1"):
        anselnn.load_anselnn(str(p))


@pytest.mark.parametrize("shape", [(5, 64, 128), (5, 40, 128), (5, 37, 61),
                                   (8, 9, 14)])
def test_unet_forward_matches_jax(shape):
    """Base 4, depth 2; odd frames take the down conv's zero pad to even
    and the upsample's crop to the skip."""
    m = ref_nn.random_unet(base=4, depth=2, in_ch=shape[0], seed=11)
    pm = anselnn.NNModel(m.cfg, m.tensors)
    x = np.random.default_rng(shape[1]).uniform(
        0.0, 1.0, shape).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: ref_unet.unet_forward(m, v))(x))
    got = unet.unet_forward(pm, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1,) + shape[1:]
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= UNET_TOL


def test_ieee_float32_restores_the_setting():
    conv = torch.backends.cudnn.conv
    before = conv.fp32_precision
    assert unet.CONV_FP32 == "ieee"
    for mode in ("ieee", "tf32"):
        with unet.conv_fp32(mode):
            assert conv.fp32_precision == mode
        assert conv.fp32_precision == before


@pytest.mark.parametrize("n,pad", [(5, 3), (5, 12), (3, 40), (64, 0),
                                   (2, 9), (1, 4), (37, 27)])
def test_reflect_pad_tail_equals_jnp_pad(n, pad):
    """Mirrored again where the pad is longer than the axis, as
    `jnp.pad(mode="reflect")` does and `F.pad` refuses."""
    v = np.arange(2 * n, dtype=np.float32).reshape(2, n) * 1.5
    want = np.asarray(jnp.pad(v, ((0, pad), (0, pad)), mode="reflect"))
    got = ai.reflect_pad_tail(torch.from_numpy(v), pad, pad).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("factor", [2, 16])
def test_linear_upsample_matches_jax_image_resize(factor):
    p = np.random.default_rng(factor).normal(size=(11, 7)).astype(np.float32)
    shape = (11 * factor, 7 * factor)
    want = np.asarray(jax.image.resize(p, shape, "linear"))
    got = ai.upsample_linear(torch.from_numpy(p), shape).numpy()
    assert np.abs(got - want).max() <= RESIZE_TOL


def _frame(xtrans, h=H, w=W):
    """(JAX meta, spec, port meta, spec) of an RGGB or X-Trans frame."""
    cfa = "XTRANS" if xtrans else "RGGB"
    out = []
    for t in (ref_types, types):
        meta = t.RawMeta(width=w, height=h, cfa=t.CFAPattern.RGGB)
        if xtrans:
            meta = dataclasses.replace(meta, xtrans=configs.XTRANS6)
        out += [meta, t.ImageSpec(width=w, height=h,
                                  colorspace=t.Colorspace.RAW, channels=1,
                                  cfa=t.CFAPattern[cfa])]
    return out


def _both_ops(model, name, strength=1.0, **kw):
    ref_ai.MODEL_REGISTRY[name] = model
    ai.MODEL_REGISTRY[name] = anselnn.NNModel(model.cfg, model.tensors)
    return (ref_ai.RawDenoiseAIParams(custom_model=name, strength=strength,
                                      **kw),
            ai.RawDenoiseAIParams(custom_model=name, strength=strength,
                                  **kw))


def _coeffs_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _coeffs_equal(a[k], b[k])
        else:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


@pytest.mark.parametrize("xtrans", [False, True], ids=["bayer", "xtrans"])
@pytest.mark.parametrize("label", ["unet", "unet-ms", "unet-ms-no-anchor"])
def test_rawdenoiseai_matches_jax(label, xtrans):
    """plan().static and coeffs() equal the JAX package's exactly; the
    output within OP_TOL.  The multi-scale net bins by 4 on Bayer and 6
    on X-Trans, its anchor on unless the model's cfg turns it off."""
    _, ref, _ = next(m for m in _models() if m[0] == label[:7])
    if label == "unet-ms-no-anchor":
        ref = ref_nn.NNModel(dict(ref.cfg, anchor=0), ref.tensors)
    rp, pp = _both_ops(ref, f"test-{label}", noise_level=1.5)
    rmeta, rspec, meta, spec = _frame(xtrans)
    rop, op = ref_ai.RawDenoiseAI(), ai.RawDenoiseAI()
    rctx, ctx = ref_base.PlanContext(meta=rmeta), ops_base.PlanContext(
        meta=meta)
    rplan, plan = rop.plan(rctx, rspec, rp), op.plan(ctx, spec, pp)
    assert plan.static == rplan.static == f"test-{label}"
    rc, c = rop.coeffs(rctx, rplan, rp), op.coeffs(ctx, plan, pp)
    _coeffs_equal(rc, c)
    x = np.random.default_rng(7).uniform(
        0.0, 0.6, (spec.pad_h, spec.pad_w)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, k: rop.apply(v, k, rplan, rctx))(
        x, rc))
    got = op.apply(torch.from_numpy(x), coeffs_to_device([c], "cpu")[0],
                   plan, ctx).numpy()
    assert got.shape == want.shape == x.shape
    assert np.isfinite(got).all()
    assert np.abs(got - x).max() > 1e-5      # the net changed the mosaic
    assert np.abs(got - want).max() <= OP_TOL


def test_rawdenoiseai_without_model_is_identity():
    op = ai.RawDenoiseAI()
    _, _, meta, spec = _frame(False)
    ctx = ops_base.PlanContext(meta=meta)
    p = ai.RawDenoiseAIParams(custom_model="missing_model.anselnn")
    plan = op.plan(ctx, spec, p)
    assert plan.static is None and op.coeffs(ctx, plan, p) is None
    x = torch.ones(spec.array_shape)
    assert op.apply(x, None, plan, ctx) is x


def test_models_resolve_from_the_search_path(tmp_path, monkeypatch):
    """custom_model names a file under MODEL_SEARCH_PATH, loaded once into
    the registry; the registry wins over the path."""
    m = anselnn.random_unet(base=4, depth=2, seed=2)
    anselnn.save_anselnn(str(tmp_path / "net.anselnn"), m.cfg, m.tensors)
    monkeypatch.setattr(ai, "MODEL_SEARCH_PATH", [str(tmp_path)])
    monkeypatch.setattr(ai, "MODEL_REGISTRY", {})
    got = ai._resolve_model(ai.RawDenoiseAIParams(custom_model="net.anselnn"))
    assert ai.MODEL_REGISTRY["net.anselnn"] is got
    assert all(np.array_equal(got.tensors[k], v) for k, v in m.tensors.items())
    assert ai._resolve_model(ai.RawDenoiseAIParams(custom_model="other")) \
        is None


@pytest.mark.parametrize("hw", [(128, 128), (40, 24), (20, 70)],
                         ids=["two-blocks", "narrow", "short"])
def test_low_band_anchor_matches_jax(hw):
    """The anchor alone, and on frames narrower or shorter than its 64-px
    block (the reflect pad mirrors more than once)."""
    h, w = hw
    rng = np.random.default_rng(h + w)
    x = (0.3 + rng.normal(0, 0.01, (h, w))).astype(np.float32)
    masks = _bayer.color_masks(types.CFAPattern.RGGB, h, w).numpy()
    sigma = np.full((h, w), 0.01, np.float32)
    denoised = (x - 0.05 + rng.normal(0, 0.002, (h, w))).astype(np.float32)
    want = np.asarray(jax.jit(ref_ai.low_band_anchor)(x, masks, sigma,
                                                      denoised))
    got = ai.low_band_anchor(*(torch.from_numpy(a) for a in
                               (x, masks, sigma, denoised))).numpy()
    assert got.shape == (h, w)
    assert np.abs(got - want).max() <= OP_TOL
    # the anchor pulls the drifted DC back to the measurement
    assert abs(got.mean() - x.mean()) < abs(denoised.mean() - x.mean())


def test_low_band_anchor_restores_measurement_dc():
    """tests/test_nn.py's case on the port."""
    h, w = 128, 128
    rng = np.random.default_rng(0)
    x = (1000.0 + rng.normal(0, 10.0, (h, w))).astype(np.float32)
    masks = _bayer.color_masks(types.CFAPattern.RGGB, h, w)
    sigma = torch.full((h, w), 10.0)
    out = ai.low_band_anchor(torch.from_numpy(x), masks, sigma,
                             torch.from_numpy(x - 50.0)).numpy()
    assert abs(out.mean() - x.mean()) < 2.0, out.mean() - x.mean()
    assert np.isfinite(out).all()


def test_xtrans_selects_equal_the_jax_package():
    vals = [np.float32(v) for v in (0.25, 1.5, 3.0)]
    want = np.asarray(ref_bayer.xtrans_color_select(
        vals, configs.XTRANS6, 12, 18))
    got = _bayer.xtrans_color_select(vals, configs.XTRANS6, 12, 18).numpy()
    assert np.array_equal(got, want)


# --- config 17 ---------------------------------------------------------------

C17_H, C17_W = 96, 160


@pytest.fixture(scope="module")
def config17():
    raw, meta, _ = synth_raw(h=C17_H, w=C17_W, kind="gradients")
    raw, meta = configs.mosaic16(raw, meta), configs.meta16(meta)
    with configs.model17(seed=4), configs.model17(seed=4, ops=ref_ai):
        port = ansel_tpu_torch.compile_pipeline(meta, configs.history(17),
                                                device="cpu")
        ref = ansel_tpu.Pipeline(meta, configs.history(17,
                                                       ansel_tpu.HistoryItem))
        ref_coeffs = ref.coeffs()    # the JAX op reads its registry
        with pytest.MonkeyPatch.context() as mp:
            share_rcd(mp)
            ref_engine._COMPILE_CACHE.clear()
            want = np.asarray(ansel_tpu.compile_pipeline(
                meta, configs.history(17, ansel_tpu.HistoryItem))
                .output_array(raw))
            ref_engine._COMPILE_CACHE.clear()
        return (port, port.output_array(raw), (ref, ref_coeffs), want, raw,
                meta)


def test_config17_plans_as_the_jax_package(config17):
    port, _, (ref, ref_coeffs), _, _, _ = config17
    names = [s.name for s in port.pipe.stages]
    assert names == [s.name for s in ref.stages]
    assert names[:3] == ["rawprepare", "rawdenoiseai", "temperature"]
    assert port.pipe.stages[1].plan.static == ref.stages[1].plan.static \
        == configs.MODEL17
    _coeffs_equal(ref_coeffs[1], port.pipe.coeffs()[1])
    assert port.fused_groups() == [["exposure", "colorin",
                                    "channelmixerrgb", "filmicrgb",
                                    "colorout"]]


def test_config17_matches_the_jax_pipe(config17):
    _, got, _, want, raw, _ = config17
    assert got.shape == want.shape == (3,) + raw.shape
    d = np.abs(got - want)
    assert d.max() <= DISPLAY_QUANTUM and d.mean() <= MEAN_TOL


def test_config17_denoises_what_config1_would_not(config17):
    """The net runs in the pipe: the same raw without it differs."""
    port, got, _, _, raw, meta = config17
    plain = ansel_tpu_torch.compile_pipeline(
        meta, configs.history(1), device="cpu").output_array(raw)
    assert np.abs(got - plain).max() > 1e-4


def test_rawdenoiseai_in_pipeline():
    """tests/test_nn.py's pipeline case on the port."""
    ai.MODEL_REGISTRY["testnet"] = anselnn.random_unet(base=4, depth=2,
                                                       seed=1)
    raw, meta, _ = synth_raw(h=64, w=128)
    pipe = ansel_tpu_torch.compile_pipeline(meta, [
        ansel_tpu_torch.HistoryItem("rawdenoiseai", {
            "custom_model": "testnet", "strength": 0.5}),
        ansel_tpu_torch.HistoryItem("demosaic", {"demosaicing_method": 0}),
    ], device="cpu")
    names = [s.name for s in pipe.pipe.stages]
    assert names.index("rawdenoiseai") < names.index("temperature")
    assert np.isfinite(pipe.output_array(raw)).all()
