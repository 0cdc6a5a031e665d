"""The last creative and export ops of the port against ansel_tpu on the
CPU: legacy filmic (Lab through ProPhoto, both preserve modes and the
global desaturation), channelmixer (the RGB mix and its gray mode),
invert (on a Bayer and an X-Trans mosaic), relight (Lab), blurs (the
lens, motion and gaussian PSFs through the FFT), borders (constant and
by aspect, each with a frame line; the canvas grows) and watermark (the
SVG mode with the bundled ansel.svg, and the text mode).  For each, the
plan and the coefficients bit for bit, `apply` on a small seeded input
within the tolerance stated in TOL, and each `from_legacy` on packed
older params.  Inputs come from numpy seeds and go to both packages as
the same float32 arrays."""

import importlib
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ansel_tpu.core import types as ref_types
from ansel_tpu.core.params import params_class as ref_params_class
from ansel_tpu.ops import base as ref_base
from ansel_tpu_torch.core import types as port_types
from ansel_tpu_torch.core.params import params_class
from ansel_tpu_torch.io import configs
from ansel_tpu_torch.ops import base as port_base
from ansel_tpu_torch.ops import watermark as port_watermark
from ansel_tpu_torch.pipeline.engine import coeffs_to_device

torch.set_num_threads(1)

H, W = 48, 72
# What the two packages round differently (measured maxima): legacy
# filmic's Lab <-> XYZ <-> ProPhoto and its pow/log2 (1.7e-4 on b near
# white, where b = 200 (fy - fz) scales an ulp of f by 200; the JAX op
# itself moves by 2.4e-5 there between jit and eager); relight's
# pow(2, x) and Lab scaling (1.9e-5 on L to 95); the FFTs, pocketfft in
# float32 on both sides (blurs 6.6e-7 on values to 1.05); XLA's fused
# multiply-add in the watermark's composite (1.2e-7); channelmixer's
# einsum, invert and borders were exact here.
# R16: legacy filmic's cubic interpolator (a 4th-order polynomial shoulder,
# its coefficients to 7e3 at these latitudes) is ill-conditioned in
# float32: one ulp more on every input moves the JAX op itself by 0.072
# (Lab, values to 100), its jit and eager forms differ by 0.095, and the
# port's output lies 0.054 from the eager form; so that case is held to
# twice the JAX op's own one-ulp movement
TOL = {"filmic": 5e-4, "channelmixer": 1e-6, "invert": 0.0, "relight": 1e-4,
       "blurs": 2e-6, "borders": 0.0, "watermark": 1e-6,
       "filmic-desaturate-poly": 0.15}


def _image(kind, seed, h=H, w=W):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 0.4 + 0.3 * np.sin(xx / 9.0) * np.cos(yy / 13.0) + yy / h * 0.3
    base += rng.normal(0.0, 0.03, (h, w))
    if kind == "LAB":
        return np.stack([np.clip(base, 0.02, 1.0) * 95.0,
                         25.0 * np.sin(xx / 17.0) + rng.normal(0, 4, (h, w)),
                         20.0 * np.cos(yy / 11.0) + rng.normal(0, 4, (h, w))]
                        ).astype(np.float32)
    if kind == "RAW":
        return np.clip(base + rng.normal(0.0, 0.05, (h, w)), 0.0,
                       1.1).astype(np.float32)
    rgb = np.stack([np.roll(base, s, axis=1) * f
                    for s, f in ((3, 1.1), (0, 1.0), (-3, 0.7))])
    return np.clip(rgb, 0.0, None).astype(np.float32)


# (id, module, class, params, input kind; "XTRANS" a RAW X-Trans mosaic)
CASES = [
    ("filmic", "filmic", "FilmicLegacy", {}, "LAB"),
    ("filmic-preserve", "filmic", "FilmicLegacy",
     {"preserve_color": 1, "saturation": 60.0, "contrast": 1.2}, "LAB"),
    ("filmic-desaturate-poly", "filmic", "FilmicLegacy",
     {"global_saturation": 70.0, "interpolator": 1, "latitude_stops": 3.0,
      "output_power": 2.0}, "LAB"),
    ("channelmixer", "channelmixer", "ChannelMixer",
     {"red": (0, 0, 0, 0.9, 0.1, 0.05, 0), "green": (0, 0, 0, 0.05, 1.1, 0, 0),
      "blue": (0, 0, 0, -0.05, 0.1, 0.95, 0)}, "WORK_RGB"),
    ("channelmixer-gray", "channelmixer", "ChannelMixer",
     {"red": (0, 0, 0, 1, 0, 0, 0.3), "green": (0, 0, 0, 0, 1, 0, 0.6),
      "blue": (0, 0, 0, 0, 0, 1, 0.1)}, "WORK_RGB"),
    ("invert-bayer", "invert", "Invert", {"color": (0.9, 1.0, 0.8, 0.95)},
     "RAW"),
    ("invert-xtrans", "invert", "Invert", {"color": (0.9, 1.0, 0.8, 0.95)},
     "XTRANS"),
    ("relight", "relight", "Relight", {"ev": 0.8, "center": 0.3,
                                       "width": 6.0}, "LAB"),
    ("relight-dark", "relight", "Relight", {"ev": -0.6, "center": 0.7,
                                            "width": 2.0}, "LAB"),
    ("blurs-lens", "blurs", "Blurs", {"type": 0, "radius": 6, "blades": 6,
                                      "concavity": 1.5, "linearity": 0.8,
                                      "rotation": 0.3}, "WORK_RGB"),
    ("blurs-motion", "blurs", "Blurs", {"type": 1, "radius": 7,
                                        "angle": 0.6, "curvature": 1.5,
                                        "offset": 0.2}, "WORK_RGB"),
    ("blurs-gaussian", "blurs", "Blurs", {"type": 2, "radius": 5},
     "WORK_RGB"),
    ("borders-constant-frame", "borders", "Borders",
     {"color": (0.95, 0.93, 0.9), "size": 0.08, "pos_h": 0.3,
      "frame_size": 0.3, "frame_offset": 0.4,
      "frame_color": (0.1, 0.1, 0.12)}, "WORK_RGB"),
    ("borders-aspect-frame", "borders", "Borders",
     {"aspect": 1.5, "aspect_orient": 1, "size": 0.05, "pos_v": 0.6,
      "frame_size": 0.5, "frame_offset": 0.2}, "WORK_RGB"),
    ("borders-aspect-landscape", "borders", "Borders",
     {"aspect": 2.0, "aspect_orient": 0, "size": 0.1}, "WORK_RGB"),
    ("watermark-svg", "watermark", "Watermark",
     {"filename": "ansel.svg", "scale": 40.0, "alignment": 8,
      "opacity": 70.0, "xoffset": -0.02, "yoffset": -0.03}, "WORK_RGB"),
    ("watermark-svg-larger", "watermark", "Watermark",
     {"filename": "darktable.svg", "scale": 60.0, "alignment": 0,
      "sizeto": 1}, "WORK_RGB"),
    ("watermark-text", "watermark", "Watermark",
     {"text": "(c) ansel", "color": (0.9, 0.8, 0.1), "scale": 300.0,
      "alignment": 4, "font": "DejaVu Sans Bold 10"}, "WORK_RGB"),
]


def _spec_meta(types, kind, h=H, w=W):
    if kind in ("RAW", "XTRANS"):
        xtrans = configs.XTRANS6 if kind == "XTRANS" else None
        cfa = types.CFAPattern.XTRANS if xtrans else types.CFAPattern.RGGB
        meta = types.RawMeta(width=w, height=h, cfa=cfa, xtrans=xtrans)
        spec = types.ImageSpec(width=w, height=h,
                               colorspace=types.Colorspace.RAW, channels=1,
                               cfa=cfa)
        return spec, meta
    spec = types.ImageSpec(width=w, height=h,
                           colorspace=getattr(types.Colorspace, kind),
                           channels=3)
    return spec, types.RawMeta(width=w, height=h)


def _pair(module, cls, params, kind):
    out = []
    for pkg, types, base, pcls in (
            ("ansel_tpu", ref_types, ref_base, ref_params_class),
            ("ansel_tpu_torch", port_types, port_base, params_class)):
        op = getattr(importlib.import_module(f"{pkg}.ops.{module}"), cls)()
        p = pcls(op.name)(**params)
        spec, meta = _spec_meta(types, kind)
        ctx = base.PlanContext(meta=meta)
        plan = op.plan(ctx, spec, p)
        out.append((op, ctx, plan, op.coeffs(ctx, plan, p)))
    return out


def _plain(spec):
    return tuple(getattr(spec, f) for f in (
        "width", "height", "channels", "pad_w", "pad_h", "org_y", "org_x",
        "full_h", "full_w")) + (spec.colorspace.name,)


def _input(kind, spec, seed):
    x = _image("RAW" if kind == "XTRANS" else kind, seed)
    if kind in ("RAW", "XTRANS"):
        out = np.zeros(spec.array_shape, np.float32)
        out[:H, :W] = x
        return out
    out = np.zeros(spec.array_shape, np.float32)
    out[:, :H, :W] = x
    return out


@pytest.mark.parametrize("name,module,cls,params,kind", CASES,
                         ids=[c[0] for c in CASES])
def test_plan_and_coeffs_equal_the_jax_package(name, module, cls, params,
                                               kind):
    (_, _, rplan, rco), (_, _, pplan, pco) = _pair(module, cls, params, kind)
    assert pplan.static == rplan.static
    assert _plain(pplan.spec_in) == _plain(rplan.spec_in)
    assert _plain(pplan.spec_out) == _plain(rplan.spec_out)
    assert (rco is None) == (pco is None)
    if rco is not None:
        assert sorted(rco) == sorted(pco)
        for k in rco:
            assert np.array_equal(np.asarray(pco[k], np.float32),
                                  np.asarray(rco[k], np.float32)), k


@pytest.mark.parametrize("name,module,cls,params,kind", CASES,
                         ids=[c[0] for c in CASES])
def test_apply_matches_the_jax_package(name, module, cls, params, kind):
    (rop, rctx, rplan, rco), (pop, pctx, pplan, pco) = _pair(
        module, cls, params, kind)
    x = _input(kind, pplan.spec_in, seed=len(name))
    rc = None if rco is None else {k: jnp.asarray(np.asarray(v))
                                   for k, v in rco.items()}
    want = np.asarray(jax.jit(lambda v: rop.apply(v, rc, rplan, rctx))(
        jnp.asarray(x)))
    c = coeffs_to_device([pco], "cpu")[0]
    got = pop.apply(torch.from_numpy(x), c, pplan, pctx).numpy()
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    if got.shape == x.shape:
        assert np.abs(got - x).max() > 1e-2       # the op changed something
    assert np.abs(got - want).max() <= TOL.get(name, TOL[module])


def test_borders_canvas_holds_picture_frame_and_colour():
    (_, _, _, _), (op, ctx, plan, co) = _pair(
        "borders", "Borders", dict(CASES[12][3]), "WORK_RGB")
    x0, y0, frame_size, _ = plan.static
    so = plan.spec_out
    assert (so.width, so.height) != (W, H) and so.full_w == W
    x = torch.from_numpy(_input("WORK_RGB", plan.spec_in, 3))
    out = op.apply(x, coeffs_to_device([co], "cpu")[0], plan, ctx)
    assert out.shape == (3, so.pad_h, so.pad_w)
    assert torch.equal(out[:, y0:y0 + H, x0:x0 + W], x[:, :H, :W])
    assert torch.allclose(out[:, 0, 0], torch.tensor([0.95, 0.93, 0.9]))
    frame = torch.tensor([0.1, 0.1, 0.12])
    ring = (out == frame.reshape(3, 1, 1)).all(dim=0)
    assert frame_size > 0 and ring.sum() > 2 * (W + H)


def test_watermark_refuses_where_pil_or_its_font_is_missing(monkeypatch):
    """Without a system DejaVu Sans, both modes render with the package's
    copy of it (the same glyphs: the overlay is bit-equal); without any
    copy of the font the text mode, and without PIL either mode, is a
    plan-time refusal naming what is missing; a missing SVG file stays
    the JAX package's loud no-op."""
    op = port_watermark.Watermark()
    spec, meta = _spec_meta(port_types, "WORK_RGB")
    real = port_watermark.os.path.exists
    text = params_class("watermark")(**CASES[-1][3])
    svg = params_class("watermark")(**CASES[-3][3])
    want = [op.plan(port_base.PlanContext(meta=meta), spec, p).aux
            for p in (text, svg)]
    monkeypatch.setattr(port_watermark.os.path, "exists",
                        lambda path: not path.startswith("/usr/share/fonts")
                        and real(path))
    for p, w in zip((text, svg), want):
        got = op.plan(port_base.PlanContext(meta=meta), spec, p).aux
        assert np.array_equal(got, w)
    monkeypatch.setattr(port_watermark.os.path, "exists",
                        lambda path: False if path.endswith(".ttf")
                        else real(path))
    with pytest.raises(NotImplementedError, match="DejaVuSans-Bold.ttf"):
        op.plan(port_base.PlanContext(meta=meta), spec, text)
    from ansel_tpu_torch.io import svglite
    # (PIL looks a missing file's name up in the system's font folders)
    monkeypatch.setattr(svglite, "_FONTS", {
        k: "/nonexistent/NoSuch" + os.path.basename(v)
        for k, v in svglite._FONTS.items()})
    monkeypatch.setattr(svglite, "_BUNDLED_FONTS", "/nonexistent")
    with pytest.raises(NotImplementedError, match="the SVG mode without a "
                       "font"):
        op.plan(port_base.PlanContext(meta=meta), spec, svg)
    monkeypatch.undo()
    import sys
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(NotImplementedError, match="without PIL"):
        op.plan(port_base.PlanContext(meta=meta), spec, svg)
    monkeypatch.undo()
    ctx = port_base.PlanContext(meta=meta)
    plan = op.plan(ctx, spec, params_class("watermark")(filename="none.svg"))
    assert plan.static is None
    assert ctx.notes["watermark_missing"] == ["none.svg"]


def _pad(b, n):
    return b + b"\x00" * (n - len(b))


# (op, version, packed older params): each decoded by both packages
LEGACY = [
    ("channelmixer", 1, struct.pack("<21f", *([0.1, 0.2, 0.3, 0.9, 0.1, 0.0,
                                              0.0] * 3))),
    ("channelmixer", 1, struct.pack("<21f", *([0.1, 0.2, 0.3, 0.9, 0.1, 0.0,
                                              0.4] * 3))),
    ("invert", 1, struct.pack("<3f", 0.8, 0.9, 0.7)),
    ("borders", 1, struct.pack("<5f", 0.9, 0.8, 0.7, 0.75, -0.1)),
    ("borders", 2, struct.pack("<4f20si2f20sf20s2f3f", 0.9, 0.8, 0.7, 1.5,
                               _pad(b"3:2", 20), 1, 0.1, 0.4,
                               _pad(b"2/5", 20), 0.5, _pad(b"1/2", 20),
                               0.2, 0.3, 0.1, 0.2, 0.3)),
    ("watermark", 1, struct.pack("<4fi64s", 80.0, 50.0, 0.1, 0.0, 2,
                                 b"ansel.svg")),
    ("watermark", 2, struct.pack("<4f2i64s", 80.0, 50.0, 0.1, 0.0, 2, 1,
                                 b"ansel.svg")),
    ("watermark", 3, struct.pack("<4fifi64s", 80.0, 50.0, 0.1, 0.0, 2,
                                 15.0, 2, b"darktable.svg")),
    ("watermark", 4, struct.pack("<4fifi64s64s3f64s", 80.0, 50.0, 0.1, 0.0,
                                 2, 15.0, 2, b"darktable.svg", b"hello",
                                 0.1, 0.2, 0.3, b"DejaVu Sans 12")),
    ("filmic", 1, struct.pack("<12fi", 18.0, -8.0, 2.5, 0.0, 18.0, 0.0,
                              100.0, 2.2, 2.0, 1.4, 90.0, 0.1, 1)),
    ("filmic", 2, struct.pack("<12f2i", 18.0, -8.0, 2.5, 0.0, 18.0, 0.0,
                              100.0, 2.2, 2.0, 1.4, 90.0, 0.1, 1, 1)),
]


@pytest.mark.parametrize("op,version,raw", LEGACY,
                         ids=[f"{o}-v{v}-{i}" for i, (o, v, _)
                              in enumerate(LEGACY)])
def test_from_legacy_equals_the_jax_package(op, version, raw):
    got = params_class(op).from_legacy(version, raw)
    want = ref_params_class(op).from_legacy(version, raw)
    assert got is not None and want is not None
    a, b = (tuple(getattr(v, f) for f in v.__dataclass_fields__)
            for v in (got, want))
    assert str(a) == str(b)   # the NaN of invert v1's fourth channel
