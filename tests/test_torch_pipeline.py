"""The port's config-1 slice against ansel_tpu: plan and coefficient
parity, the whole slice on the CPU, fused groups, the branches that raise
while planning, no silent CPU, and no JAX behind `import ansel_tpu_torch`."""

import dataclasses
import enum
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ansel_tpu
import ansel_tpu_torch
from ansel_tpu.io.synthetic import synth_raw
from ansel_tpu.kernels.rcd_pallas import rcd_demosaic_pallas
from ansel_tpu.ops.base import pad_to
from ansel_tpu.pipeline import engine as ref_engine
from ansel_tpu_torch.io import configs, encode

torch.set_num_threads(2)

CONFIG1 = list(configs.HISTORIES[1])
DISPLAY_QUANTUM = 1.0 / 255.0


def _hist(pkg, items):
    return [pkg.HistoryItem(op, params) for op, params in items]


def _plain(v):
    """Plan values with each package's enums replaced by their values."""
    if isinstance(v, enum.Enum):
        return v.value
    if dataclasses.is_dataclass(v):
        return tuple(_plain(getattr(v, f.name))
                     for f in dataclasses.fields(v))
    if isinstance(v, (tuple, list)):
        return tuple(_plain(x) for x in v)
    return v


def _variant(exposure=0.5, filmic=None):
    return [("exposure", {"exposure": exposure}), ("channelmixerrgb", {}),
            ("filmicrgb", filmic or {})]


@pytest.mark.parametrize("items", [
    CONFIG1,
    _variant(exposure=-1.0),
    _variant(exposure=2.0),
    _variant(filmic={"version": 5}),
    _variant(filmic={"version": 6}),
    _variant(filmic={"version": 8}),
    _variant(filmic={"version": 9}),
], ids=["config1", "ev-1", "ev+2", "agx-v6", "agx-v7", "agx-v9", "agx-v10"])
def test_plan_and_coeffs_equal_reference(items):
    _, meta, _ = synth_raw(h=144, w=400)
    ref = ansel_tpu.Pipeline(meta, _hist(ansel_tpu, items))
    port = ansel_tpu_torch.Pipeline(meta, _hist(ansel_tpu_torch, items),
                                    device="cpu")
    assert [s.name for s in port.stages] == [s.name for s in ref.stages]
    assert len(port.stages) == 9 and not port.windowed and not ref.windowed
    for p, r in zip(port.stages, ref.stages):
        assert _plain(p.plan.spec_in) == _plain(r.plan.spec_in)
        assert _plain(p.plan.spec_out) == _plain(r.plan.spec_out)
        assert _plain(p.plan.static) == _plain(r.plan.static), p.name
    for p, r in zip(port.coeffs(), ref.coeffs()):
        assert (p is None) == (r is None)
        assert sorted(p or {}) == sorted(r or {})
        for k in p or {}:
            assert np.array_equal(np.asarray(p[k]), np.asarray(r[k])), k


def test_windowed_plan_equals_reference_and_crops_the_full_run():
    raw, meta, _ = synth_raw(h=144, w=400)
    win = (24, 40, 64, 200)
    ref = ansel_tpu.Pipeline(meta, _hist(ansel_tpu, CONFIG1), out_window=win)
    port = ansel_tpu_torch.Pipeline(meta, _hist(ansel_tpu_torch, CONFIG1),
                                    device="cpu", out_window=win)
    assert port.windowed and ref.windowed
    for p, r in zip(port.stages, ref.stages):
        assert _plain(p.plan.spec_in) == _plain(r.plan.spec_in), p.name
        assert _plain(p.plan.static) == _plain(r.plan.static), p.name
    got = ansel_tpu_torch.pipeline.engine.CompiledPipe(port).output_array(raw)
    full = ansel_tpu_torch.compile_pipeline(
        meta, _hist(ansel_tpu_torch, CONFIG1), device="cpu").output_array(raw)
    y0, x0, h, w = win
    assert got.shape == (3, h, w)
    # the demosaic window keeps an 18-px halo, so the crop is exact
    assert np.array_equal(got, full[:, y0:y0 + h, x0:x0 + w])


def _positional_exposure(pkg, monkeypatch):
    """Register, for this test only, an exposure whose pointwise spec
    reads pixel positions (as vignette's and graduatednd's do)."""
    base = pkg.ops.base
    plain = base.get_op("exposure")

    class Positional(type(plain)):
        def pointwise_spec(self, plan, ctx):
            spec = super().pointwise_spec(plan, ctx)
            return dataclasses.replace(
                spec, needs_pos=True,
                fn=lambda x, c, yy, xx, _fn=spec.fn: _fn(x, c))

    monkeypatch.setitem(base._OPS, "exposure", Positional())


def test_positional_stage_is_a_full_frame_boundary(monkeypatch):
    raw, meta, _ = synth_raw(h=144, w=400)
    win = (24, 40, 64, 200)
    _positional_exposure(ansel_tpu, monkeypatch)
    _positional_exposure(ansel_tpu_torch, monkeypatch)
    ref = ansel_tpu.Pipeline(meta, _hist(ansel_tpu, CONFIG1), out_window=win)
    port = ansel_tpu_torch.Pipeline(meta, _hist(ansel_tpu_torch, CONFIG1),
                                    device="cpu", out_window=win)
    assert port.windowed and ref.windowed
    names = [s.name for s in port.stages]
    at = names.index("exposure")
    for p, r in zip(port.stages, ref.stages):
        assert _plain(p.plan.spec_in) == _plain(r.plan.spec_in), p.name
    full = ansel_tpu_torch.Pipeline(meta, _hist(ansel_tpu_torch, CONFIG1),
                                    device="cpu").stages
    # exposure and everything before it plan the whole frame; the stages
    # after it plan the window
    for i, (p, f) in enumerate(zip(port.stages, full)):
        same = _plain(p.plan.spec_in) == _plain(f.plan.spec_in)
        assert same == (i <= at), p.name
    assert port.stages[at].op.roi_in(port.stages[at].plan, port.ctx,
                                     win) is None
    # the chain kernel takes it; its chain ends there, where the window
    # shrinks, and the next one runs on the window: the full run's crop
    compiled = ansel_tpu_torch.pipeline.engine.CompiledPipe(port)
    chains = [(i, j) for kind, i, j, _ in compiled.steps if kind == "chain"]
    assert chains == [(at, at + 1), (at + 1, len(names))]
    got = compiled.output_array(raw)
    whole = ansel_tpu_torch.compile_pipeline(
        meta, _hist(ansel_tpu_torch, CONFIG1), device="cpu").output_array(raw)
    y0, x0, h, w = win
    assert np.array_equal(got, whole[:, y0:y0 + h, x0:x0 + w])


def test_resolve_history_matches_reference_for_config1():
    _, meta, _ = synth_raw(h=144, w=400)
    port = ansel_tpu_torch.pipeline.engine.resolve_history(
        meta, _hist(ansel_tpu_torch, CONFIG1))
    ref = ref_engine.resolve_history(meta, _hist(ansel_tpu, CONFIG1))
    assert [h.op for h in port] == [h.op for h in ref if h.enabled]


@pytest.fixture(scope="module")
def slice144():
    """The config-1 slice on synth_raw(144, 400): the port's output on the
    CPU, the reference in its TPU form (Pallas RCD and the fused chain in
    interpret mode) and its CPU CompiledPipe."""
    raw, meta, _ = synth_raw(h=144, w=400)
    port = ansel_tpu_torch.compile_pipeline(
        meta, _hist(ansel_tpu_torch, CONFIG1), device="cpu")
    got = port.output_array(raw)

    ref = ansel_tpu.Pipeline(meta, _hist(ansel_tpu, CONFIG1))
    co = ref.coeffs()
    x = ref.trace_fn(0, 3)(jnp.asarray(pad_to(raw, ref.spec_in)), co[0:3])
    rgb = rcd_demosaic_pallas(x, ref.stages[3].plan.spec_in.cfa,
                              co[3]["scaler"], interpret=True)
    ref_engine._FORCE_FUSION_INTERPRET = True
    ref_engine._COMPILE_CACHE.clear()
    try:
        tpu_form = np.asarray(ref.trace_fn(4, 9)(rgb, co[4:9]))[:, :144, :400]
    finally:
        ref_engine._FORCE_FUSION_INTERPRET = False
        ref_engine._COMPILE_CACHE.clear()
    cpu_form = ansel_tpu.compile_pipeline(
        meta, _hist(ansel_tpu, CONFIG1)).output_array(raw)
    return port, got, tpu_form, cpu_form


def test_slice_matches_tpu_form_full_frame(slice144):
    _, got, tpu_form, _ = slice144
    assert got.shape == tpu_form.shape == (3, 144, 400)
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0
    d = np.abs(got - tpu_form)
    assert d.max() <= DISPLAY_QUANTUM and d.mean() <= 1e-4


def test_slice_matches_cpu_pipe_interior(slice144):
    # ansel_tpu's CPU path runs kernels/rcd.py, which pads rows by 8 and
    # wraps columns: its border differs by design, so drop a 16-px ring
    _, got, _, cpu_form = slice144
    ring = (slice(None), slice(16, -16), slice(16, -16))
    assert np.abs(got[ring] - cpu_form[ring]).max() <= DISPLAY_QUANTUM


def test_config1_fuses_stages_4_to_8_into_one_chain(slice144):
    port = slice144[0]
    assert port.fused_groups() == [["exposure", "colorin", "channelmixerrgb",
                                    "filmicrgb", "colorout"]]
    assert [k for k, *_ in port.steps] == ["stage"] * 4 + ["chain"]


def _xtrans(meta):
    return dataclasses.replace(meta, xtrans=configs.XTRANS6)


@pytest.mark.parametrize("items,meta_fn,kw", [
    ([("highlights", {"mode": 1})], None, {}),
    ([("highlights", {"mode": 2})], None, {}),
    ([("blurs", {})], None, {}),                             # not ported
    ([("highlights", {"mode": 4})], None, {}),
    ([("demosaic", {"demosaicing_method": 0})], None, {}),   # PPG
    ([("demosaic", {"demosaicing_method": 1})], None, {}),   # AMaZE
    ([("demosaic", {"demosaicing_method": 7})], None, {}),   # fallback
    ([("demosaic", {"green_eq": 1})], None, {}),
    ([("demosaic", {"color_smoothing": 2})], None, {}),
    ([("filmicrgb", {"version": 4})], None, {}),             # spline v5
    ([("filmicrgb", {"version": 0})], None, {}),             # spline v1
    ([("filmicrgb", {"version": 2})], None, {}),             # spline v3
    ([("colorin", {"type": 0})], None, {}),                  # ICC file
    ([("colorout", {"type": 0})], None, {}),                 # ICC file
    ([("lut3d", {})], None, {}),                             # not ported
    ([("denoiseprofile", {})], None, {}),          # automatic noise profile
    ([("diffuse", {"radius": 12})], None, {}),     # 6 wavelet scales
    ([("retouch", {})], None, {}),                           # not ported
    ([("demosaic", {"demosaicing_method": 0x3001})], _xtrans, {}),  # dual
    ([("demosaic", {"color_smoothing": 2})], _xtrans, {}),
    ([("highlights", {"mode": 3})], _xtrans, {}),  # Laplacian on X-Trans
    (CONFIG1, None, {"pipe_type": "preview"}),
], ids=["lch", "inpaint", "blurs", "harmonic", "ppg", "amaze",
        "bilinear", "green-eq", "smoothing", "filmic-v5",
        "filmic-v1", "filmic-v3", "colorin-icc", "colorout-icc",
        "unported-op", "denoise-auto-profile", "diffuse-6-scales",
        "retouch", "xtrans-dual", "xtrans-smoothing",
        "xtrans-laplacian", "preview"])
def test_unported_branches_raise_at_plan_time(items, meta_fn, kw):
    _, meta, _ = synth_raw(h=64, w=128)
    if meta_fn is not None:
        meta = meta_fn(meta)
    with pytest.raises(NotImplementedError):
        ansel_tpu_torch.Pipeline(meta, _hist(ansel_tpu_torch, items),
                                 device="cpu", **kw)


def test_xtrans_raises_at_plan_time():
    """X-Trans plans Markesteijn; its VNG (kernels/vng.py) is not ported."""
    _, meta, _ = synth_raw(h=60, w=120)
    meta = _xtrans(meta)
    ansel_tpu_torch.Pipeline(meta, [], device="cpu")
    with pytest.raises(NotImplementedError):
        ansel_tpu_torch.Pipeline(meta, _hist(ansel_tpu_torch, [
            ("demosaic", {"demosaicing_method": 0x1000})]), device="cpu")


def test_blend_raises_at_plan_time():
    # an active blend (mask_mode != 0) on a geometry-preserving stage; an
    # inactive or undecodable blob plans as no blend, as in ansel_tpu
    # (tests/test_torch_export.py)
    from ansel_tpu_torch.pipeline.blend import MASK_ENABLED, BlendParams

    _, meta, _ = synth_raw(h=64, w=128)
    blob = BlendParams.codec.encode(BlendParams(mask_mode=MASK_ENABLED))
    item = ansel_tpu_torch.HistoryItem("exposure", {"exposure": 1.0},
                                       blend_params=blob)
    with pytest.raises(NotImplementedError):
        ansel_tpu_torch.Pipeline(meta, [item], device="cpu")


def test_cuda_device_is_never_replaced_by_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, meta, _ = synth_raw(h=64, w=128)
    with pytest.raises(RuntimeError):
        ansel_tpu_torch.compile_pipeline(
            meta, _hist(ansel_tpu_torch, CONFIG1), device="cuda")


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, meta, _ = synth_raw(h=64, w=128)
    with pytest.raises(RuntimeError):
        ansel_tpu_torch.compile_pipeline(meta, _hist(ansel_tpu_torch, CONFIG1))
    with pytest.raises(RuntimeError):
        ansel_tpu_torch.Pipeline(meta, _hist(ansel_tpu_torch, CONFIG1))


def test_import_loads_no_jax():
    code = ("import sys, ansel_tpu_torch; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'ansel_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_png16_writes_without_pil(tmp_path, slice144):
    got = slice144[1]
    path = str(tmp_path / "out.png")
    encode.write_image(path, got, bpp=16, icc=None)
    with open(path, "rb") as f:
        head = f.read(33)
    assert head[:8] == b"\x89PNG\r\n\x1a\n"
    assert int.from_bytes(head[16:20], "big") == 400      # width
    assert int.from_bytes(head[20:24], "big") == 144      # height
    assert head[24] == 16                                 # bit depth
