"""The port's export geometry against ansel_tpu on the CPU: flip, crop,
clipping (with its warp in kernels/warp.py), scalepixels, rotatepixels,
initialscale, finalscale and restorescans, each with `plan().static`
and `coeffs()` equal to the JAX package's and its apply on the same
float32 input; every legacy params ladder; the export scale through
`export_image`; the PDF writer; and the port's config 9 (a DNG with a
GainMap, exported from its sidecar through the CLI) against the JAX CLI.

Tolerances: OP_TOL for the ops the port computes with the same float32
operations in the same order (measured 0: flip, crop, clipping,
rotatepixels, restorescans); RESAMPLE_TOL for the resamplers, whose
float32 products accumulate in another order (measured 1.0e-5 for
scalepixels' Lanczos matrices, 1.8e-7 for the scale ops); clipping also
within CLIP_TOL of the JAX CPU gather (measured 0) and TPU_TOL of its
TPU form (the two-pass Pallas warp in interpret mode, ROADMAP R4), or
TPU_KEYSTONE_TOL where a keystone bends the map; whole pipes within
the display quantum 1/255 of the JAX package (its RCD through the Pallas
kernel in interpret mode where a warp carries RCD's border inwards).

The JAX package plans clipping on the sensor frame's size after a flip
that swaps the axes or an export downscale (`ImageSpec.with_size` keeps
`full_h`/`full_w`; ROADMAP R9).  The port mirrors it, which
`test_clipping_after_a_swap_plans_the_sensor_frame` pins."""

import dataclasses
import functools
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ansel_tpu
import ansel_tpu_torch
from ansel_tpu import cli as ref_cli
from ansel_tpu.core import params as ref_params
from ansel_tpu.core import types as ref_types
from ansel_tpu.io import pdfwriter as ref_pdf
from ansel_tpu.io.synthetic import synth_raw
from ansel_tpu.kernels import warp_pallas
from ansel_tpu.ops import base as ref_base
from ansel_tpu.pipeline import engine as ref_engine
from ansel_tpu_torch import cli
from ansel_tpu_torch.core import params as port_params
from ansel_tpu_torch.core import types as port_types
from ansel_tpu_torch.io import configs, pdfwriter
from ansel_tpu_torch.io.encode import read_png16, write_image
from ansel_tpu_torch.io.xmp import XMPDocument, write_xmp
from ansel_tpu_torch.ops import base as port_base
from ansel_tpu_torch.pipeline import engine
from ansel_tpu_torch.pipeline.blend import BlendParams
from ansel_tpu_torch.pipeline.export import (ExportSettings,
                                             compute_export_scale)
from test_dng import opcode_list2_blob, write_dng

torch.set_num_threads(2)

OP_TOL = 0.0
RESAMPLE_TOL = 2e-5
CLIP_TOL = 1e-5
TPU_TOL = 1e-3
# the two-pass warp's fixed-point inverse of a keystone map: measured
# 1.2e-3 to 1.7e-3 against the direct gather
TPU_KEYSTONE_TOL = 2e-3
DISPLAY_QUANTUM = 1.0 / 255.0
H, W = 96, 144
# config 9 at a small size
H9, W9 = 160, 240

CASES = {
    "flip-6": ("flip", {"orientation": 6}),
    "flip-3": ("flip", {"orientation": 3}),
    "flip-null": ("flip", {}),
    "crop": ("crop", {"cx": 0.1, "cy": 0.2, "cw": 0.8, "ch": 0.9}),
    "clipping-rotate-crop": ("clipping", dict(configs.HISTORIES[9])[
        "clipping"]),
    "clipping-identity": ("clipping", {}),
    "clipping-old-keystone": ("clipping", {
        "angle": -3.0, "cx": 0.1, "cw": 0.9, "k_type": 4, "k_h": 0.1,
        "k_v": -0.05, "crop_auto": 0}),
    "clipping-quad-keystone": ("clipping", {
        "angle": 1.0, "k_type": 0, "k_apply": 1, "kxa": 0.1, "kya": 0.15,
        "kxb": 0.85, "kyb": 0.1, "kxc": 0.9, "kyc": 0.9, "kxd": 0.15,
        "kyd": 0.85}),
    "clipping-quad-horizontal": ("clipping", {
        "k_type": 1, "k_apply": 1, "kxa": 0.1, "kya": 0.15, "kxb": 0.85,
        "kyb": 0.1, "kxc": 0.9, "kyc": 0.9, "kxd": 0.15, "kyd": 0.85}),
    "clipping-quad-vertical": ("clipping", {
        "k_type": 2, "k_apply": 1, "kxa": 0.1, "kya": 0.15, "kxb": 0.85,
        "kyb": 0.1, "kxc": 0.9, "kyc": 0.9, "kxd": 0.15, "kyd": 0.85}),
    "clipping-flip-frame": ("clipping", {"angle": 4.0, "cw": -0.9,
                                         "ch": -0.8}),
    "scalepixels-tall": ("scalepixels", {"pixel_aspect_ratio": 0.7}),
    "scalepixels-wide": ("scalepixels", {"pixel_aspect_ratio": 1.6}),
    "rotatepixels": ("rotatepixels", {"angle": 5.0, "rx": 20, "ry": 30}),
    "restorescans": ("restorescans", {"diffusion": 0.3, "iterations": 2,
                                      "C_m": 0.1, "M_o": 0.05}),
    "initialscale": ("initialscale", {"method": 1}),
    "finalscale": ("finalscale", {}),
}
SCALES = {"initialscale": 0.5, "finalscale": 0.37}
TOLS = {"scalepixels": RESAMPLE_TOL, "initialscale": RESAMPLE_TOL,
        "finalscale": RESAMPLE_TOL}


@pytest.fixture(scope="module")
def frame():
    return synth_raw(h=H, w=W, kind="gradients")


def _image(seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:256]
    img = np.stack([0.5 + 0.4 * np.sin(yy / (9.0 + 3 * i))
                    * np.cos(xx / (13.0 + 5 * i)) for i in range(3)])
    return (img + 0.05 * rng.random(img.shape)).astype(np.float32)


def _plans(name, params, meta, scale=1.0):
    """[(op, plan, coeffs, ctx)] of the port, then of the JAX package."""
    out = []
    for base, types in ((port_base, port_types), (ref_base, ref_types)):
        op = base.get_op(name)
        p = dataclasses.replace(op.default_params(meta), **params)
        ctx = base.PlanContext(meta=meta, scale=scale)
        spec = types.ImageSpec(width=W, height=H,
                               colorspace=types.Colorspace.WORK_RGB)
        plan = op.plan(ctx, spec, p)
        out.append((op, plan, op.coeffs(ctx, plan, p), ctx))
    return out


def _to(c, fn):
    return None if c is None else {
        k: fn(np.asarray(v, np.float32)) for k, v in c.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_equals_the_reference(frame, case):
    name, params = CASES[case]
    _, meta, _ = frame
    (pop, pplan, pc, pctx), (rop, rplan, rc, rctx) = _plans(
        name, params, meta, SCALES.get(name, 1.0))
    assert pplan.static == rplan.static
    assert pplan.spec_out.array_shape == rplan.spec_out.array_shape
    assert (pc is None) == (rc is None)
    if pc is not None:
        assert pc.keys() == rc.keys()
        for k in pc:
            assert np.array_equal(np.asarray(pc[k]), np.asarray(rc[k])), k
    x = _image()
    got = pop.apply(torch.from_numpy(x), _to(pc, torch.from_numpy), pplan,
                    pctx).numpy()
    want = np.asarray(rop.apply(jnp.asarray(x), _to(rc, jnp.asarray), rplan,
                                rctx))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOLS.get(name, OP_TOL)


@pytest.mark.parametrize("case", sorted(
    c for c in CASES if CASES[c][0] == "clipping"
    and c not in ("clipping-identity", "clipping-flip-frame")))
def test_clipping_against_the_tpu_form(frame, case, monkeypatch):
    """The JAX package's clipping as the TPU runs it: `warp_static`'s
    host bounds and the two-pass Pallas warp in interpret mode (R4).  A
    mirrored frame is left out: its map is no small displacement, and the
    two-pass warp's fixed-point inverse does not reach it (0.83 apart)."""
    _, params = CASES[case]
    _, meta, _ = frame
    (pop, pplan, _, pctx), (rop, rplan, _, rctx) = _plans(
        "clipping", params, meta)
    x = _image(1)
    got = pop.apply(torch.from_numpy(x), None, pplan, pctx).numpy()
    cpu = np.asarray(rop.apply(jnp.asarray(x), None, rplan, rctx))
    assert np.abs(got - cpu).max() <= CLIP_TOL
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(warp_pallas, "warp_model", functools.partial(
        warp_pallas.warp_model, interpret=True))
    tpu = np.asarray(rop.apply(jnp.asarray(x), None, rplan, rctx))
    keystone = "keystone" in case or "quad" in case
    assert np.abs(got - tpu).max() <= (
        TPU_KEYSTONE_TOL if keystone else TPU_TOL)


@pytest.mark.parametrize("op,version,blob", [
    ("clipping", 2, struct.pack("<7f", 1.5, 0.1, 0.05, 0.9, 0.95,
                                struct.unpack("<f", struct.pack(
                                    "<I", struct.unpack("<I", struct.pack(
                                        "<f", 0.1))[0] | 0x40000000))[0],
                                0.0)),
    ("clipping", 3, struct.pack("<7f", -2.0, 0.0, 0.1, 1.0, 0.9, 0.0, 0.2)),
    ("clipping", 4, struct.pack("<15f4i", 1.0, 0.05, 0.05, 0.95, 0.95, 0.0,
                                0.0, 0.2, 0.2, 0.8, 0.2, 0.8, 0.8, 0.2, 0.8,
                                0, 0, 1, 1)),
    ("flip", 1, struct.pack("<i", 5)),
    ("initialscale", 1, struct.pack("<i", 1)),
    ("finalscale", 1, struct.pack("<i", 0)),
], ids=["clipping-v2", "clipping-v3", "clipping-v4", "flip-v1",
        "initialscale-v1", "finalscale-v1"])
def test_legacy_params_equal_the_reference(op, version, blob):
    got = port_params.decode_blob(op, version, blob)
    want = ref_params.decode_blob(op, version, blob)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("name", ["flip", "crop", "clipping", "scalepixels",
                                  "rotatepixels", "restorescans",
                                  "initialscale", "finalscale"])
def test_params_blob_equals_the_reference(name):
    cls, ref_cls = port_params.params_class(name), \
        ref_params.params_class(name)
    assert cls.op_version == ref_cls.op_version
    assert cls.codec.encode(cls()) == ref_cls.codec.encode(ref_cls())


# --- pipes: the ROI walk under a crop, export scaling, R9 --------------------

@pytest.fixture(scope="module")
def pallas_rcd():
    """ansel_tpu's RCD as the TPU runs it: the Pallas kernel in interpret
    mode (its CPU RCD differs on a ~4 px border, which a warp carries
    inwards)."""
    from ansel_tpu.kernels import rcd as ref_rcd
    from ansel_tpu.kernels import rcd_pallas

    mp = pytest.MonkeyPatch()
    mp.setattr(ref_rcd, "rcd_demosaic",
               lambda x, cfa, s: rcd_pallas.rcd_demosaic_pallas(
                   x, cfa, s, interpret=True))
    ref_engine._COMPILE_CACHE.clear()
    yield
    mp.undo()
    ref_engine._COMPILE_CACHE.clear()


def _pipes(meta, items, scale=1.0):
    port = ansel_tpu_torch.Pipeline(
        meta, [ansel_tpu_torch.HistoryItem(o, dict(p)) for o, p in items],
        device="cpu", scale=scale)
    ref = ansel_tpu.Pipeline(
        meta, [ansel_tpu.HistoryItem(o, dict(p)) for o, p in items],
        scale=scale)
    assert [s.name for s in port.stages] == [s.name for s in ref.stages]
    for a, b in zip(port.stages, ref.stages):
        assert a.plan.static == b.plan.static, a.name
        for sa, sb in ((a.plan.spec_in, b.plan.spec_in),
                       (a.plan.spec_out, b.plan.spec_out)):
            assert (sa.array_shape, sa.org_y, sa.org_x, sa.full_h,
                    sa.full_w) == (sb.array_shape, sb.org_y, sb.org_x,
                                   sb.full_h, sb.full_w), a.name
    return port, ref


def _outputs(port, ref, raw):
    got = engine.CompiledPipe(port).output_array(raw)
    want = np.asarray(ref_engine.CompiledPipe(ref).output_array(raw))
    assert got.shape == want.shape
    return got, want


@pytest.mark.parametrize("params", [
    {"angle": 1.0, "cx": 0.35, "cy": 0.31, "cw": 0.95, "ch": 0.9},
    {"angle": -1.5, "cx": 0.33, "cy": 0.29, "cw": 0.93, "ch": 0.97,
     "k_type": 4, "k_v": 0.05},
], ids=["rotate", "keystone"])
def test_a_crop_windows_the_stages_before_it(frame, pallas_rcd, params):
    """The backward ROI walk: clipping's `roi_in` shrinks every stage
    before it; RCD runs on a window of the mosaic and clipping on a window
    of RCD's output whose origin is odd in the first case."""
    raw, meta, _ = frame
    port, ref = _pipes(meta, [("clipping", params),
                              ("exposure", {"exposure": 0.5})])
    assert port.windowed and ref.windowed
    si = {s.name: s.plan.spec_in for s in port.stages}
    assert (si["demosaic"].org_y, si["demosaic"].org_x) != (0, 0)
    assert si["demosaic"].height < H and si["demosaic"].width < W
    assert si["clipping"].org_y > si["demosaic"].org_y
    got, want = _outputs(port, ref, raw)
    assert np.abs(got - want).max() <= DISPLAY_QUANTUM


@pytest.mark.parametrize("scale", [0.5, 0.8, 1.25])
def test_export_scale_injects_the_scale_op(frame, pallas_rcd, scale):
    raw, meta, _ = frame
    port, ref = _pipes(meta, configs.HISTORIES[1], scale)
    names = [s.name for s in port.stages]
    assert ("initialscale" in names) == (scale < 1)
    assert ("finalscale" in names) == (scale > 1)
    got, want = _outputs(port, ref, raw)
    assert got.shape == (3, round(H * scale), round(W * scale))
    assert np.abs(got - want).max() <= DISPLAY_QUANTUM


def test_clipping_after_a_swap_plans_the_sensor_frame(frame):
    """R9: after flip's axis swap both packages plan clipping on the
    sensor frame's (H, W), so its output is landscape-shaped."""
    _, meta, _ = frame
    port, _ = _pipes(meta, configs.HISTORIES[9][1:])
    so = {s.name: s.plan.spec_out for s in port.stages}
    si = {s.name: s.plan.spec_in for s in port.stages}
    assert (so["flip"].height, so["flip"].width) == (W, H)
    assert (si["clipping"].full_h, si["clipping"].full_w) == (H, W)
    assert so["clipping"].width > so["clipping"].height


# --- PDF ---------------------------------------------------------------------

def _strip_date(pdf: bytes) -> bytes:
    i = pdf.index(b"/CreationDate")
    return pdf[:i] + pdf[pdf.index(b")", i) + 1:]


@pytest.mark.parametrize("bpp", [8, 16])
def test_pdf_equals_the_reference(tmp_path, bpp):
    img = _image(2)[:, :40, :60]
    a, b = str(tmp_path / "port.pdf"), str(tmp_path / "ref.pdf")
    write_image(a, img, bpp=bpp, icc=None)
    ref_pdf.write_pdf(b, img, bpp=bpp, icc=None)
    got, want = open(a, "rb").read(), open(b, "rb").read()
    assert got.startswith(b"%PDF-") and got.rstrip().endswith(b"%%EOF")
    assert len(got) == len(want)
    assert _strip_date(got)[:-64] == _strip_date(want)[:-64]
    assert pdfwriter.parse_paper_size("a4") == ref_pdf.parse_paper_size("a4")


# --- config 9: a DNG exported from its sidecar through the CLI ---------------

@pytest.fixture(scope="module")
def dng9(tmp_path_factory):
    """Config 9 at 160 x 240: the 14-bit mosaic as a DNG with its GainMap,
    and the sidecar with an inactive blend blob on every item."""
    d = tmp_path_factory.mktemp("config9")
    raw, _, _ = synth_raw(h=H9, w=W9, kind="gradients")
    mv, mh = configs.DNG9_MAP_POINTS
    blob = opcode_list2_blob(H9, W9, mv, mh, configs.gain_maps9())
    write_dng(str(d / "in.dng"), configs.mosaic9(raw), black=256.0,
              white=16383.0, extra_tags=[(51009, 7, len(blob), blob)])
    write_xmp(str(d / "in.xmp"), XMPDocument(history=[
        engine.HistoryItem(op, dict(p), blend_params=BlendParams())
        for op, p in configs.HISTORIES[9]]))
    return d


@pytest.mark.parametrize("extra", [[], ["--width", "96", "--height", "96"]],
                         ids=["full", "scaled"])
def test_config9_cli_equals_the_reference_cli(dng9, pallas_rcd, extra):
    port, ref = str(dng9 / f"port{len(extra)}.png"), \
        str(dng9 / f"ref{len(extra)}.png")
    args = [str(dng9 / "in.dng"), str(dng9 / "in.xmp")]
    assert cli.main(args + [port, "--bpp", "16", "--no-icc", "--device",
                            "cpu", *extra]) == 0
    assert ref_cli.main(args + [ref, "--bpp", "16", "--no-icc",
                                *extra]) == 0
    got, want = read_png16(port), read_png16(ref)
    assert got.shape == want.shape
    assert np.abs(got.astype(np.int64) - want).max() / 65535.0 \
        <= DISPLAY_QUANTUM
    doc = ansel_tpu_torch.io.xmp.parse_xmp(str(dng9 / "in.xmp"))
    raw, meta = ansel_tpu_torch.io.rawfile.load_raw(str(dng9 / "in.dng"))
    scale = compute_export_scale(meta, ExportSettings(
        max_width=96 if extra else 0, max_height=96 if extra else 0))
    pipe = engine.Pipeline(meta, doc.history, device="cpu", scale=scale)
    names = [s.name for s in pipe.stages]
    assert names[:2] == ["rawprepare", "temperature"]
    assert pipe.stages[0].plan.static[2] == configs.DNG9_MAP_POINTS
    assert "flip" in names and "clipping" in names
    assert ("initialscale" in names) == bool(extra)


def test_config9_pdf_through_the_cli(dng9):
    out = str(dng9 / "out.pdf")
    assert cli.main([str(dng9 / "in.dng"), str(dng9 / "in.xmp"), out,
                     "--no-icc", "--device", "cpu", "--width", "96",
                     "--height", "96"]) == 0
    pdf = open(out, "rb").read()
    assert pdf.startswith(b"%PDF-") and b"/FlateDecode" in pdf
    i = pdf.index(b"stream\n") + len(b"stream\n")
    body = zlib.decompressobj().decompress(pdf[i:])
    w = int(pdf.split(b"/Width ")[1].split()[0])
    h = int(pdf.split(b"/Height ")[1].split()[0])
    assert len(body) == 3 * w * h
