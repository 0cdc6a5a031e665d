"""The port's product surface against ansel_tpu on the CPU: blend
parameters that plan as no blend (a history whose every item carries an
inactive `blendop_params` blob, as darktable writes them), `export_image`
from a sidecar of config 8's history, the CLI in a subprocess
(`--device cpu`), `entry()` against `__graft_entry__.entry()`, and the
crash and supervisor rails with the pipe cache's events.

Tolerances: whole pipes, borders included, within the display quantum
1/255 of the JAX package run as the TPU runs it (its RCD, and config 8's
NLM, through the Pallas kernels in interpret mode: its CPU paths differ
on a border of a few px); the same pipe with and without inactive blend
blobs equal bit for bit."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import ansel_tpu
import ansel_tpu_torch
from ansel_tpu.io.synthetic import synth_raw
from ansel_tpu.pipeline import blend as ref_blend
from ansel_tpu.pipeline.export import export_image as ref_export_image
from ansel_tpu_torch.core import crash
from ansel_tpu_torch.core import supervisor as sup
from ansel_tpu_torch.io import configs
from ansel_tpu_torch.io.encode import read_png16, to_uint16
from ansel_tpu_torch.io.xmp import XMPDocument, write_xmp
from ansel_tpu_torch.pipeline import blend
from ansel_tpu_torch.pipeline import engine
from ansel_tpu_torch.pipeline.export import (ExportSettings,
                                             compute_export_scale,
                                             export_image)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DISPLAY_QUANTUM = 1.0 / 255.0
# config 8 needs 3 tiles of 32 half-resolution rows for cacorrect
H8, W8 = 192, 288
# config 8 is held to the JAX package as the TPU runs it: its CPU RCD and
# its XLA NLM path (which edge-pads the patch distances, the kernel the
# image) differ from the Pallas kernels on a border of a few px, which
# bloom's eight 109-px box means carry across a frame this small
# (measured 0.012 at 32 px in); with both Pallas kernels in interpret
# mode the whole frame agrees (measured max 5.6e-5, mean 3.6e-7)
INACTIVE = blend.BlendParams.codec.encode(blend.BlendParams())
ACTIVE = blend.BlendParams.codec.encode(
    blend.BlendParams(mask_mode=blend.MASK_ENABLED, opacity=50.0))


def _run(args, timeout=300):
    # the subprocess's torch uses this process's two CPU threads, so its
    # reductions (defringe's mean) sum in the same order
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


# --- step 0: blend parameters that plan as no blend -------------------------

def _config1(pkg, blend_params=None):
    return [pkg.HistoryItem(op, dict(p), blend_params=blend_params)
            for op, p in configs.HISTORIES[1]]


@pytest.fixture
def pallas_rcd(monkeypatch):
    """ansel_tpu's RCD as the TPU runs it: the Pallas kernel in interpret
    mode (its CPU RCD differs on a ~4 px border)."""
    from ansel_tpu.kernels import rcd as ref_rcd
    from ansel_tpu.kernels import rcd_pallas
    from ansel_tpu.pipeline import engine as ref_engine

    monkeypatch.setattr(ref_rcd, "rcd_demosaic",
                        lambda x, cfa, s: rcd_pallas.rcd_demosaic_pallas(
                            x, cfa, s, interpret=True))
    ref_engine._COMPILE_CACHE.clear()
    yield
    ref_engine._COMPILE_CACHE.clear()


@pytest.fixture(scope="session")
def config1_blobs():
    raw, meta, _ = synth_raw(h=128, w=192, kind="gradients")
    plain = ansel_tpu_torch.compile_pipeline(
        meta, _config1(ansel_tpu_torch), device="cpu")
    blobbed = ansel_tpu_torch.compile_pipeline(
        meta, _config1(ansel_tpu_torch, INACTIVE), device="cpu")
    return (raw, meta, plain, blobbed, plain.output_array(raw),
            blobbed.output_array(raw))


def test_inactive_blend_blobs_render_as_no_blend(config1_blobs, pallas_rcd):
    """darktable's blendop_params on every item, mask_mode 0: the port
    refused these histories before; they plan and render as the same
    history without them, and as the JAX package renders them (whole
    frame)."""
    raw, meta, plain, blobbed, out, out_blobbed = config1_blobs
    assert blobbed.pipe.signature() == plain.pipe.signature()
    assert np.array_equal(out_blobbed, out)
    ref = np.asarray(ansel_tpu.compile_pipeline(
        meta, _config1(ansel_tpu, INACTIVE)).output_array(raw))
    assert out.shape == ref.shape
    assert np.abs(out_blobbed - ref).max() <= DISPLAY_QUANTUM


@pytest.mark.parametrize("op,bp", [
    ("exposure", b"\0" * 8),                       # undecodable: no blend
    ("exposure", b"\x07\0\0\0" + b"\0" * 300),     # an older blendop
    ("exposure", blend.BlendParams()),             # a BlendParams, inactive
    ("demosaic", ACTIVE),                          # (H, W) -> (3, H, W)
], ids=["short", "legacy", "dataclass", "shape-changing-stage"])
def test_blobs_that_plan_as_no_blend_in_both_packages(config1_blobs, op, bp):
    raw, meta, plain, *_ = config1_blobs
    items = [ansel_tpu_torch.HistoryItem(op, {}, blend_params=bp)]
    port = ansel_tpu_torch.Pipeline(meta, items, device="cpu")
    ref_bp = bp if isinstance(bp, bytes) else ref_blend.BlendParams()
    ref = ansel_tpu.Pipeline(meta, [ansel_tpu.HistoryItem(
        op, {}, blend_params=ref_bp)])
    assert all(s.blend is None for s in ref.stages)
    assert len(port.stages) == len(ref.stages)


@pytest.mark.parametrize("bp", [ACTIVE, blend.BlendParams(mask_mode=1)],
                         ids=["blob", "dataclass"])
def test_an_active_blend_is_refused(bp):
    """No longer refused since blends were ported: an active blend on a
    geometry-preserving stage plans as the JAX package plans it, with the
    blob as its cache key (tests/test_torch_blend.py holds the
    compositing)."""
    _, meta, _ = synth_raw(h=64, w=128)
    items = [ansel_tpu_torch.HistoryItem("exposure", {}, blend_params=bp)]
    port = ansel_tpu_torch.Pipeline(meta, items, device="cpu")
    ref_bp = bp if isinstance(bp, bytes) else ref_blend.BlendParams(
        mask_mode=1)
    ref = ansel_tpu.Pipeline(meta, [ansel_tpu.HistoryItem(
        "exposure", {}, blend_params=ref_bp)])
    assert [s.blend_static for s in port.stages] == [
        s.blend_static for s in ref.stages]
    assert sum(s.blend is not None for s in port.stages) == 1


# --- export_image and the CLI on config 8 ------------------------------------

@pytest.fixture(scope="session")
def sidecar8(tmp_path_factory):
    """Config 8's history as darktable writes it: an inactive blend blob
    on every item."""
    path = str(tmp_path_factory.mktemp("config8") / "config8.xmp")
    write_xmp(path, XMPDocument(history=[
        engine.HistoryItem(op, dict(p), blend_params=blend.BlendParams())
        for op, p in configs.HISTORIES[8]]))
    return path


def _pallas_nlmeans(img, P, K, sharpness, norm, center_weight=-1.0,
                    decimate=False):
    """ansel_tpu's nlmeans as the nlmeans op reaches it on the TPU: the
    Pallas kernel, variant 0, in interpret mode."""
    from ansel_tpu.kernels.nlm_pallas import nlm_pallas
    from ansel_tpu.pixel.nlmeans import _scatter

    assert center_weight < 0.0 and not decimate
    offs = tuple(_scatter(1.0, 0.0, dy, dx) for dy in range(-K, K + 1)
                 for dx in range(-K, K + 1))
    return nlm_pallas(img, offs, P, norm, sharpness, 0.0, 1.0, variant=0,
                      interpret=True)


@pytest.fixture(scope="session")
def export8(sidecar8):
    """The port's export_image on the CPU and ansel_tpu's, with its RCD
    and its nlmeans op's NLM routed to their Pallas kernels in interpret
    mode."""
    from ansel_tpu.kernels import rcd as ref_rcd
    from ansel_tpu.kernels import rcd_pallas
    from ansel_tpu.ops import nlmeans as ref_nlmeans
    from ansel_tpu.pipeline import engine as ref_engine

    raw, meta, _ = synth_raw(h=H8, w=W8, kind="gradients")
    got = export_image(raw, meta, xmp_path=sidecar8, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_rcd, "rcd_demosaic",
                   lambda x, cfa, s: rcd_pallas.rcd_demosaic_pallas(
                       x, cfa, s, interpret=True))
        mp.setattr(ref_nlmeans, "nlmeans", _pallas_nlmeans)
        ref_engine._COMPILE_CACHE.clear()
        try:
            want = np.asarray(ref_export_image(raw, meta,
                                               xmp_path=sidecar8))
        finally:
            ref_engine._COMPILE_CACHE.clear()
    return raw, meta, got, want


def test_export_image_matches_the_jax_package(export8):
    _, _, got, want = export8
    assert got.shape == want.shape == (3, H8, W8)
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0
    d = np.abs(got - want)
    assert d.max() <= DISPLAY_QUANTUM and d.mean() <= 1e-5


def test_export_plans_config8_as_the_jax_package(sidecar8):
    from ansel_tpu.io.xmp import parse_xmp as ref_parse
    from ansel_tpu_torch.io.xmp import parse_xmp

    _, meta, _ = synth_raw(h=H8, w=W8)
    port = ansel_tpu_torch.Pipeline(meta, parse_xmp(sidecar8).history,
                                    device="cpu")
    ref = ansel_tpu.Pipeline(meta, ref_parse(sidecar8).history)
    assert [s.name for s in port.stages] == [s.name for s in ref.stages]
    assert [s.blend for s in ref.stages] == [None] * len(ref.stages)
    pipe = ansel_tpu_torch.CompiledPipe(port)
    # the colour stages run as config 7's three chains
    assert pipe.fused_groups() == [["exposure", "colorin", "_convert"],
                                   ["_convert", "filmicrgb", "_convert"],
                                   ["_convert", "colorout"]]


def test_export_scale_refuses_to_shrink(pallas_rcd):
    """The bounding box never enlarges (scale at most 1); a box that
    shrinks the image, refused until initialscale was ported, now renders
    at the export size as the JAX package does."""
    raw, meta, _ = synth_raw(h=64, w=128)
    assert compute_export_scale(meta, ExportSettings()) == 1.0
    assert compute_export_scale(meta, ExportSettings(max_width=256)) == 1.0
    s = ExportSettings(max_width=64)
    assert compute_export_scale(meta, s) == 0.5
    out = export_image(raw, meta, history=[], settings=s, device="cpu")
    ref = ref_export_image(raw, meta, history=[], settings=s)
    assert out.shape == ref.shape == (3, 32, 64)
    assert np.abs(out - ref).max() <= DISPLAY_QUANTUM


def test_cli_writes_the_16_bit_png_of_export_image(tmp_path, sidecar8,
                                                   export8):
    out = str(tmp_path / "out.png")
    proc = _run(["-m", "ansel_tpu_torch.cli", f"synth:{W8}x{H8}", sidecar8,
                 out, "--bpp", "16", "--no-icc", "--device", "cpu", "-v"])
    assert proc.returncode == 0, proc.stderr
    assert "[export]" in proc.stderr
    assert np.array_equal(read_png16(out), to_uint16(export8[2]))


@pytest.mark.parametrize("op,params,args,bp,message", [
    ("lut3d", {"filepath": "hald16.png"}, ["--width", "100"], INACTIVE,
     "lut3d_file.read_png8: a PNG of bit depth 16"),
    ("lut3d", {"filepath": "hald.tif"}, [], ACTIVE,
     "lut3d: a Hald CLUT image other than"),
], ids=["width", "active-blend"])
def test_cli_refuses_what_is_not_ported(tmp_path, op, params, args, bp,
                                        message):
    """The "width" case refused `--width` until export scaling was
    ported; it now plans the export at that width up to a branch the
    port has not ported yet (lut3d's 16-bit Hald PNG; rawdenoiseai,
    filmicrgb's v5 colour science and highlights' LCH mode until they
    were ported).  The "active-blend" case refused an active blend until
    blends were ported; it now carries one on a branch the port has not
    ported (lut3d's TIFF Hald CLUT; rawdenoiseai, relight and drawlayer
    until they were ported).  Since the port reads a Hald CLUT through
    PIL as the JAX package does, the CLI runs as on a machine without PIL,
    where the port's own PNG reader refuses these forms."""
    from test_torch_pipeline import write_hald_forms

    write_hald_forms(str(tmp_path))
    params = {k: str(tmp_path / v) for k, v in params.items()}
    xmp = str(tmp_path / "h.xmp")
    write_xmp(xmp, [engine.HistoryItem(op, params, blend_params=bp)])
    out = str(tmp_path / "out.png")
    without_pil = ("import runpy, sys; sys.modules['PIL'] = None; "
                   "runpy.run_module('ansel_tpu_torch.cli', "
                   "run_name='__main__')")
    proc = _run(["-c", without_pil, "synth:128x64", xmp, out,
                 "--bpp", "16", "--no-icc", "--device", "cpu", *args])
    assert proc.returncode != 0
    assert "NotImplementedError" in proc.stderr and message in proc.stderr
    # the crash rail names the image
    assert "processing context" in proc.stderr and "synth:128x64" in \
        proc.stderr
    assert not os.path.exists(out)


def test_cli_debug_perf_nan_and_supervisor(tmp_path):
    out = str(tmp_path / "out.png")
    proc = _run(["-m", "ansel_tpu_torch.cli", "synth:128x64", out, "--bpp",
                 "16", "--no-icc", "--device", "cpu", "-d", "perf", "-d",
                 "nan", "-d", "supervisor"])
    assert proc.returncode == 0, proc.stderr
    assert "[perf] demosaic" in proc.stdout and "TOTAL" in proc.stdout
    assert "[nan]" not in proc.stderr
    assert "[supervisor] 1 events, 0 anomalies" in proc.stderr
    assert read_png16(out).shape == (64, 128, 3)


def test_run_stages_schedules_each_stage_as_the_export(monkeypatch):
    """`-d perf` and `-d nan` split the pipe at every stage but schedule
    each as the export does: a per-pixel stage runs as a one-stage chain
    (the chain kernel on the card) in both of its calls, the warm-up and
    the timed one, and never through its op's plain `apply`."""
    from ansel_tpu_torch.kernels import pointwise as pw
    from ansel_tpu_torch.pipeline import profiling

    raw, meta, _ = synth_raw(h=64, w=128)
    pipe = engine.Pipeline(meta, _config1(ansel_tpu_torch), device="cpu")
    pixel = [s for s in pipe.stages if pipe._chain_spec(s) is not None]
    chains = []
    real = pw.pointwise_chain

    def spy(x, chain):
        chains.append(tuple(op for op, _, _ in chain.stages))
        return real(x, chain)

    monkeypatch.setattr(pw, "pointwise_chain", spy)
    for s in pixel:
        monkeypatch.setattr(s.op, "apply", None)
    reps = profiling.run_stages(pipe, raw, nan_scan=True, verbose=False)
    assert [r.name for r in reps] == [s.name for s in pipe.stages]
    assert len(pixel) >= 3
    assert [len(c) for c in chains] == [1] * (2 * len(pixel))
    assert all(r.nan == 0 and r.inf == 0 for r in reps)


def test_cli_help_and_import_load_neither_jax_nor_lxml():
    code = ("import runpy, sys; sys.argv = ['cli', '--help']\n"
            "try:\n"
            "    runpy.run_module('ansel_tpu_torch.cli', run_name='__main__')\n"
            "except SystemExit:\n"
            "    pass\n"
            "import ansel_tpu_torch.io.xmp, ansel_tpu_torch.entry\n"
            "import ansel_tpu_torch.pipeline.profiling\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ansel_tpu', 'lxml'))\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    proc = _run(["-c", code], timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "usage:" in proc.stdout


def test_cli_devtest_without_a_card_fails():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from ansel_tpu_torch import cli

    assert cli.main(["--devtest"]) == 1


@pytest.mark.parametrize("mode", ["--generate-cache", "--ingest-lensfun"])
def test_cli_library_modes_are_not_ported(mode, tmp_path, capsys):
    """Both modes were refused with NotImplementedError until the library
    was ported; each now runs as the JAX package's CLI runs it, and on
    the same bad argument fails as it fails: `--generate-cache` without
    `--library` at argparse (exit 2), `--ingest-lensfun` on a folder
    without lensfun XML with FileNotFoundError
    (tests/test_torch_library.py runs both modes on a library and a
    lensfun checkout)."""
    from ansel_tpu import cli as ref_cli
    from ansel_tpu_torch import cli

    errors = []
    for main in (ref_cli.main, cli.main):
        with pytest.raises((SystemExit, FileNotFoundError)) as err:
            main([mode, str(tmp_path)])
        errors.append((type(err.value), getattr(err.value, "code", None)))
    assert errors[0] == errors[1]
    assert errors[1] == ((SystemExit, 2) if mode == "--generate-cache"
                         else (FileNotFoundError, None))


# --- entry() ----------------------------------------------------------------

def test_entry_matches_the_graft_entry(pallas_rcd):
    sys.path.insert(0, ROOT)
    try:
        import __graft_entry__
    finally:
        sys.path.remove(ROOT)
    from ansel_tpu_torch.entry import entry

    import jax

    rfn, (rraw, rco) = __graft_entry__.entry()
    want = np.asarray(jax.jit(rfn)(rraw, rco))
    fn, (raw, co) = entry(device="cpu")
    assert raw.device.type == "cpu" and np.array_equal(raw.numpy(), rraw)
    got = fn(raw, co).numpy()
    assert got.shape == want.shape == (3, 256, 384)
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0
    assert np.abs(got - want).max() <= DISPLAY_QUANTUM


def test_entry_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from ansel_tpu_torch.entry import entry

    with pytest.raises(RuntimeError):
        entry()


# --- crash and supervisor rails ----------------------------------------------

def test_breadcrumbs_roundtrip():
    crash.breadcrumb("image", "/x/y.nef")
    crash.breadcrumb("pipe", "export")
    assert crash.breadcrumbs() == {"image": "/x/y.nef", "pipe": "export"}
    crash.breadcrumb("pipe", None)
    crash.breadcrumb("image", None)
    assert crash.breadcrumbs() == {}


def test_excepthook_prints_context():
    code = ("from ansel_tpu_torch.core import crash\n"
            "crash.install()\n"
            "crash.breadcrumb('image', '/roll/IMG_0042.NEF')\n"
            "raise RuntimeError('boom')\n")
    r = _run(["-c", code], timeout=120)
    assert r.returncode != 0
    assert "processing context" in r.stderr
    assert "IMG_0042.NEF" in r.stderr and "boom" in r.stderr


def test_faulthandler_dumps_on_fatal_signal():
    code = ("from ansel_tpu_torch.core import crash\n"
            "crash.install()\n"
            "import ctypes; ctypes.string_at(0)\n")  # SIGSEGV
    r = _run(["-c", code], timeout=120)
    assert r.returncode != 0
    assert "Fatal Python error" in r.stderr or "Segmentation" in r.stderr


@pytest.fixture
def supervised():
    sup._reset_for_tests(on=True)
    yield
    sup._reset_for_tests(on=False)


def test_crud_and_resurrection_flagging(supervised):
    sup.event("pipe", "create", "abc")
    sup.event("pipe", "read", "abc")
    sup.event("pipe", "dead", "abc")
    sup.event("pipe", "read", "abc")      # use-after-free
    sup.event("pipe", "create", "abc")    # resurrection
    a = sup.anomalies()
    assert len(a) == 2
    assert all(r.get("resurrected") for r in a)


def test_duplicate_create_and_unknown_read(supervised):
    sup.event("stage", "create", 1)
    sup.event("stage", "create", 1)       # duplicate
    sup.event("stage", "read", 2)         # never created
    kinds = [("duplicate" in r, "unknown" in r) for r in sup.anomalies()]
    assert (True, False) in kinds and (False, True) in kinds


def test_engine_emits_pipe_events_and_reuses_by_signature(supervised):
    """A new signature creates, a repeat reads what the first built (its
    steps), a change of coefficients alone updates: its output follows
    the new coefficients, never the cached ones."""
    raw, meta, _ = synth_raw(h=64, w=128)
    hist = _config1(ansel_tpu_torch)
    engine._PIPE_CACHE.clear()
    first = ansel_tpu_torch.compile_pipeline(meta, hist, device="cpu")
    out = first.output_array(raw)
    again = ansel_tpu_torch.compile_pipeline(meta, hist, device="cpu")
    assert again.steps is first.steps
    assert np.array_equal(again.output_array(raw), out)
    brighter = [ansel_tpu_torch.HistoryItem("exposure", {"exposure": 1.5})]
    brighter += hist[1:]
    b = ansel_tpu_torch.compile_pipeline(meta, brighter, device="cpu")
    assert b.pipe.signature() == first.pipe.signature()
    assert b.steps is not first.steps
    assert b.output_array(raw).mean() > out.mean()
    ops = [(r["kind"], r["op"]) for r in sup.ring()]
    assert ops == [("pipe", "create"), ("pipe", "read"), ("pipe", "update")]
    assert sup.anomalies() == []
    engine._PIPE_CACHE.clear()
