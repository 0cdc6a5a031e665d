"""The port's config 16 (a darktable-4.0-era scene-referred edit of a
high-ISO raw exported for the web: denoiseprofile with its automatic
profile, exposure, diffuse at 8 wavelet scales, colour equalizer and
colour primaries, filmic rgb colour science v5, a border with a frame
line and the ansel.svg signature; `ansel_tpu_torch/io/configs.py`)
against ansel_tpu on the CPU at 96 x 160: the plan, statics and
coefficients, the schedule and its chain programs, the kernel wrappers
the pipe calls, the whole pipe against
`ansel_tpu.compile_pipeline(...).output_array`, and the sidecar exported
through `python -m ansel_tpu_torch.cli` in a new process against
`export_image`.

The JAX pipe is handed the port's RCD twin (as in
tests/test_torch_blend.py) and the port's 64^3 CLUTs (colorequal's and
colorprimaries', built once here: the builders are held against the JAX
package's in tests/test_torch_colorrings.py, and a build takes ~14 s).
Tolerances: the display quantum (1/255) and MEAN_TOL for the whole pipe,
frame, border and signature (measured max 4.3e-5, mean 2.8e-7: XLA's and
torch's pow, log2 and exp in the chain and the HLG transfer, the
wavelet denoise's and diffuse's sums)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import ansel_tpu
import ansel_tpu_torch
from ansel_tpu.color import colorrings as ref_rings
from ansel_tpu.io.synthetic import synth_raw
from ansel_tpu.pipeline import engine as ref_engine
from ansel_tpu_torch.color import colorrings as rings
from ansel_tpu_torch.io import configs
from ansel_tpu_torch.io.encode import read_png16, to_uint16
from ansel_tpu_torch.io.rawfile import load_raw, save_raw
from ansel_tpu_torch.io.xmp import XMPDocument, write_xmp
from ansel_tpu_torch.kernels import diffuse, eaw, pointwise, rcd, sepblur
from ansel_tpu_torch.pipeline.export import export_image
from test_torch_blend import share_rcd

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 96, 160
DISPLAY_QUANTUM = 1.0 / 255.0
MEAN_TOL = 1e-5
STAGES = ["rawprepare", "temperature", "highlights", "demosaic",
          "denoiseprofile", "exposure", "colorin", "diffuse",
          "colorprimaries", "colorequal", "filmicrgb", "colorout", "borders",
          "watermark"]
KINDS = ["stage"] * 5 + ["chain"] + ["stage"] * 3 + ["chain"] + ["stage"] * 2
PROGRAMS = (((pointwise.OP_EXPOSURE, 0), (pointwise.OP_MATRIX, 2)),
            ((pointwise.OP_FILMIC_SPLINE, 0), (pointwise.OP_COLOROUT, 57)))
# the sidecar's export against the render of the same raw and meta: the
# history's floats are float32 already (the CLUT ops' sigmas set, so that
# both build one CLUT), and the defaults it leaves move nothing here
# (measured 0)
SIDECAR_TOL = 0.0


def _hist(pkg):
    return [pkg.HistoryItem(op, dict(p)) for op, p in configs.HISTORIES[16]]


def _mosaic():
    raw, meta, _ = synth_raw(h=H, w=W, kind="gradients")
    return configs.mosaic16(raw, meta), meta


@pytest.fixture(scope="module")
def slice16():
    raw, meta = _mosaic()
    pmeta = configs.meta16(meta)
    port = ansel_tpu_torch.compile_pipeline(pmeta, configs.history(16),
                                            device="cpu")
    got = port.output_array(raw)
    return port, got, raw, pmeta


@pytest.fixture(scope="module")
def ref16(slice16):
    """The JAX package's pipe, planned and run with the port's RCD twin and
    the port's CLUTs."""
    port, _, raw, _ = slice16
    c = dict(zip([s.name for s in port.pipe.stages], port.pipe.coeffs()))
    cluts = {"build_clut": c["colorequal"]["clut"],
             "build_primaries_clut": c["colorprimaries"]["clut"]}
    import ansel_tpu.io.synthetic as ref_synth

    _, meta, _ = ref_synth.synth_raw(h=H, w=W, kind="gradients")
    meta = configs.meta16(meta)
    with pytest.MonkeyPatch.context() as mp:
        share_rcd(mp)
        for name, clut in cluts.items():
            mp.setattr(ref_rings, name, lambda p, level=None, _c=clut: _c)
        ref_engine._COMPILE_CACHE.clear()
        try:
            want = np.asarray(ansel_tpu.compile_pipeline(
                meta, _hist(ansel_tpu)).output_array(raw))
            ref = ansel_tpu.Pipeline(meta, _hist(ansel_tpu))
            ref_coeffs = ref.coeffs()
        finally:
            ref_engine._COMPILE_CACHE.clear()
    return ref, ref_coeffs, want


def test_config16_mosaic_and_meta():
    """The noise is the ILCE-7M3's at ISO 3200 (its variance model,
    checked on the flat lower rows' red photosites), seeded; the meta
    names the camera."""
    raw, meta = _mosaic()
    clean, _, _ = synth_raw(h=H, w=W, kind="gradients")
    assert raw.dtype == np.float32 and raw.min() >= 0.0
    assert np.array_equal(raw, configs.mosaic16(clean, meta))
    assert not np.array_equal(raw, configs.mosaic16(clean, meta, seed=1))
    d = (raw - clean)[0::2, 0::2]
    assert 0.0 < float(np.std(d)) < 0.05 * (meta.white_point
                                           - meta.black_levels[0])
    m = configs.meta16(meta)
    assert (m.maker, m.model, m.iso) == ("Sony", "ILCE-7M3", 3200.0)


def test_config16_plan_and_coeffs_equal_reference(slice16, ref16):
    port = slice16[0]
    ref, ref_coeffs, _ = ref16
    assert [s.name for s in port.pipe.stages] == STAGES
    assert [s.name for s in ref.stages] == STAGES
    for p, r in zip(port.pipe.stages, ref.stages):
        assert p.plan.static == r.plan.static, p.name
        for a, b in ((p.plan.spec_in, r.plan.spec_in),
                     (p.plan.spec_out, r.plan.spec_out)):
            assert (a.width, a.height, a.pad_w, a.pad_h, a.full_w,
                    a.full_h) == (b.width, b.height, b.pad_w, b.pad_h,
                                  b.full_w, b.full_h), p.name
    for name, p, r in zip(STAGES, port.pipe.coeffs(), ref_coeffs):
        assert sorted(p or {}) == sorted(r or {}), name
        for k in p or {}:
            assert np.array_equal(np.asarray(p[k], np.float32),
                                  np.asarray(r[k], np.float32)), (name, k)
    static = dict(zip(STAGES, [s.plan.static for s in port.pipe.stages]))
    assert static["diffuse"][0] == 8                 # wavelet scales
    assert static["filmicrgb"][:2] == (4, 1)         # v5; no reconstruction
    assert static["filmicrgb"][5] is None
    borders = port.pipe.stages[STAGES.index("borders")].plan
    assert borders.spec_out.width > W and borders.spec_out.full_w == W


def test_config16_steps_and_programs(slice16):
    port = slice16[0]
    assert [k for k, *_ in port.steps] == KINDS
    chains = [a for k, _, _, a in port.steps if k == "chain"]
    assert tuple(pointwise.FIXED[c.fixed] for c in chains) == PROGRAMS
    assert port.fused_groups() == [["exposure", "colorin"],
                                   ["filmicrgb", "colorout"]]


def test_config16_calls_each_kernel_wrapper(slice16, monkeypatch):
    """RCD, the EAW decompose once a denoise scale, the first chain, the
    8-scale decompose's blurs at dilations 1-128 (the diffuse kernel is
    not called past five scales), the second chain."""
    port, _, raw, _ = slice16
    scales = port.pipe.stages[STAGES.index("denoiseprofile")].plan.static[0]
    calls = []
    for mod, name in ((rcd, "rcd_demosaic"), (eaw, "eaw_dn_coarse"),
                      (sepblur, "sep_blur"), (pointwise, "pointwise_chain"),
                      (diffuse, "diffuse_iteration")):
        real = getattr(mod, name)

        def spy(*args, _real=real, _name=name):
            calls.append(_name if _name != "sep_blur" else args[2])
            return _real(*args)

        monkeypatch.setattr(mod, name, spy)
    port.output_array(raw)
    assert calls == (["rcd_demosaic"] + ["eaw_dn_coarse"] * scales
                     + ["pointwise_chain"] + [1 << s for s in range(8)]
                     + ["pointwise_chain"])


def test_config16_matches_the_jax_package(slice16, ref16):
    _, got, _, _ = slice16
    want = ref16[2]
    assert got.shape == want.shape and got.shape[1:] != (H, W)
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0
    d = np.abs(got - want)
    assert d.max() <= DISPLAY_QUANTUM and d.mean() <= MEAN_TOL


def test_config16_sidecar_through_the_cli(slice16, tmp_path):
    """The sidecar through `python -m ansel_tpu_torch.cli` (a new process,
    the raw as a bundle that carries the camera's name and ISO) writes
    the 16-bit PNG of `export_image` of the bundle's raw and meta (the
    bundle stores the white balance in float32, which denoiseprofile's
    float64 coefficients read), which is the render of that meta."""
    _, got, raw, meta = slice16
    sidecar = str(tmp_path / "c16.xmp")
    bundle = str(tmp_path / "c16.npz")
    png = str(tmp_path / "c16.png")
    write_xmp(sidecar, XMPDocument(history=configs.history(16)))
    save_raw(bundle, raw, meta)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "ansel_tpu_torch.cli", bundle, sidecar, png,
         "--bpp", "16", "--no-icc", "--device", "cpu"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "GENERIC" not in proc.stderr
    braw, bmeta = load_raw(bundle)[:2]
    out = export_image(braw, bmeta, xmp_path=sidecar, device="cpu")
    assert np.array_equal(read_png16(png), to_uint16(out))
    render = ansel_tpu_torch.compile_pipeline(
        bmeta, configs.history(16), device="cpu").output_array(braw)
    assert np.abs(out - render).max() <= SIDECAR_TOL
    assert np.abs(out - got).max() <= DISPLAY_QUANTUM


def test_config16_clut_is_built_once_a_process(slice16, monkeypatch):
    """A second compile of the same edit reuses the host CLUTs."""
    _, _, _, meta = slice16
    monkeypatch.setattr(rings, "build_clut", None)
    monkeypatch.setattr(rings, "build_primaries_clut", None)
    pipe = ansel_tpu_torch.Pipeline(meta, configs.history(16), device="cpu")
    assert [s.name for s in pipe.stages] == STAGES
    c = dict(zip(STAGES, pipe.coeffs()))
    assert c["colorequal"]["clut"].shape == (rings.CLUT_LEVEL ** 3, 3)
