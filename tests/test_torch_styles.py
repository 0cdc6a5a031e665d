"""The port's styles (`io/styles.py`, on ElementTree) against ansel_tpu's
(on lxml) on the CPU.

A reference-like `.dtstyle` with multi-instances (colorbalancergb at
priority 2, exposure at priorities 1 and 2, blend params on one) is
built here, standing in for the reference's fixture that
tests/test_styles.py reads from a checkout of darktable's sources
(absent, ROADMAP R6).  Each package reads the file the other writes to
equal items; `apply_style` merges alike (same op and priority replaces,
anything else appends); a style's exposure items drive a pipe in both
packages to the same plan and to outputs within the display quantum."""

import dataclasses

import numpy as np
import pytest
import torch

import ansel_tpu
import ansel_tpu_torch
from ansel_tpu.core.params import decode_blob as ref_decode_blob
from ansel_tpu.core.params import params_class as ref_params_class
from ansel_tpu.io import styles as ref_styles
from ansel_tpu.io.synthetic import synth_raw
from ansel_tpu.pipeline import blend as ref_blend
from ansel_tpu_torch.core.params import decode_blob, params_class
from ansel_tpu_torch.io import styles
from ansel_tpu_torch.pipeline import blend

torch.set_num_threads(1)

DISPLAY_QUANTUM = 1.0 / 255.0


def _items(pkg, pc, bl):
    """The fixture's plugins as `pkg`'s HistoryItems: exposure at 1.2449
    EV (priority 2, a 70% uniform blend) and -0.3 EV (priority 1),
    colorbalancergb at priority 2, a disabled vibrance."""
    exp, cb, vib = pc("exposure"), pc("colorbalancergb"), pc("vibrance")
    blob = bl.BlendParams.codec.encode(bl.BlendParams(mask_mode=1,
                                                      opacity=70.0))
    return [
        pkg.HistoryItem("exposure", exp(exposure=1.2449), version=6,
                        multi_priority=2, blend_params=blob),
        pkg.HistoryItem("exposure", exp(exposure=-0.3), version=6,
                        multi_priority=1),
        pkg.HistoryItem("colorbalancergb", cb(chroma_global=0.2),
                        version=cb.op_version, multi_priority=2),
        pkg.HistoryItem("vibrance", vib(amount=30.0),
                        version=vib.op_version, enabled=False),
    ]


def _style(pkg, mod, pc, bl):
    return mod.Style(name="test", description="mixed instances",
                     items=_items(pkg, pc, bl),
                     iop_list="exposure,1,exposure,2,colorbalancergb,2")


def _view(style):
    return (style.name, style.description, style.iop_list,
            [(h.op, h.params, h.version, h.enabled, h.multi_priority,
              h.blend_params) for h in style.items])


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    d = tmp_path_factory.mktemp("styles")
    port_path, ref_path = str(d / "port.dtstyle"), str(d / "ref.dtstyle")
    styles.write_style(port_path, _style(ansel_tpu_torch, styles,
                                         params_class, blend))
    ref_styles.write_style(ref_path, _style(ansel_tpu, ref_styles,
                                            ref_params_class, ref_blend))
    return port_path, ref_path


@pytest.mark.parametrize("reader", ["port", "jax"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_file(fixtures, reader, writer):
    path = fixtures[writer == "jax"]
    got = (styles if reader == "port" else ref_styles).parse_style(path)
    want = ref_styles.parse_style(fixtures[1])
    assert _view(got) == _view(want)
    assert [(h.op, h.multi_priority) for h in got.items] == [
        ("exposure", 2), ("exposure", 1), ("colorbalancergb", 2),
        ("vibrance", 0)]


def test_reference_like_fixture_decodes(fixtures):
    """As tests/test_styles.py's reference fixture test reads it."""
    style = styles.parse_style(fixtures[1])
    assert style.name == "test"
    ops = [(h.op, h.multi_priority) for h in style.items]
    assert ("colorbalancergb", 2) in ops and ("exposure", 1) in ops
    exp = next(h for h in style.items
               if h.op == "exposure" and h.multi_priority == 2)
    p = decode_blob("exposure", exp.version, exp.params)
    assert abs(p.exposure - 1.2449) < 1e-3
    assert dataclasses.asdict(p) == dataclasses.asdict(
        ref_decode_blob("exposure", exp.version, exp.params))
    bp = blend.decode_blend_params(exp.blend_params)
    assert bp is not None and bp.opacity == 70.0
    assert bp == blend.BlendParams(**dataclasses.asdict(
        ref_blend.decode_blend_params(exp.blend_params)))


def test_apply_style_merges_alike(fixtures):
    def merge(pkg, mod):
        base = [pkg.HistoryItem("exposure", {"exposure": 0.1},
                                multi_priority=1),
                pkg.HistoryItem("filmicrgb", {})]
        out = mod.apply_style(base, mod.parse_style(fixtures[0]))
        return [(h.op, h.multi_priority, h.params) for h in out]

    got, want = merge(ansel_tpu_torch, styles), merge(ansel_tpu, ref_styles)
    assert got == want
    # exposure 1 replaced in place, the rest appended in the style's order
    assert [(op, mp) for op, mp, _ in got] == [
        ("exposure", 1), ("filmicrgb", 0), ("exposure", 2),
        ("colorbalancergb", 2), ("vibrance", 0)]
    assert isinstance(got[0][2], bytes)


def test_style_round_trip(tmp_path):
    p = str(tmp_path / "rt.dtstyle")
    exp = params_class("exposure")
    styles.write_style(p, styles.Style(name="rt", items=[
        ansel_tpu_torch.HistoryItem("exposure", exp(exposure=0.7),
                                    version=6)]))
    back = styles.parse_style(p)
    assert back.name == "rt" and back.iop_list is None
    assert abs(decode_blob("exposure", 6, back.items[0].params).exposure
               - 0.7) < 1e-6
    with open(p, "rb") as f:
        assert styles.parse_style(f.read()).items == back.items


def test_style_drives_the_pipe_alike(fixtures, monkeypatch):
    """The style's exposure instances (one blended) on a demosaic item,
    in both packages."""
    from test_torch_blend import share_rcd

    raw, meta, _ = synth_raw(h=32, w=48, kind="gradients")
    share_rcd(monkeypatch)
    outs = []
    for pkg, mod, extra in ((ansel_tpu_torch, styles, {"device": "cpu"}),
                            (ansel_tpu, ref_styles, {})):
        items = [h for h in mod.parse_style(fixtures[0]).items
                 if h.op == "exposure"]
        items.append(pkg.HistoryItem("demosaic", {"demosaicing_method": 5}))
        pipe = pkg.compile_pipeline(meta, items, **extra)
        outs.append((np.asarray(pipe.output_array(raw)),
                     [(s.name, s.multi_priority) for s in pipe.pipe.stages]))
    (got, plan), (want, ref_plan) = outs
    assert plan == ref_plan
    assert ("exposure", 2) in plan and ("exposure", 1) in plan
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= DISPLAY_QUANTUM
