"""Every registered op through the port's `spatial_sharded_pipe`, band by
band, against the port's single pipe: 192x256 over four virtual CPU
bands, each op at tests/test_all_ops_smoke.py's params, then the
branches of the mandatory stages and of the stages that window, where a
whole-frame statistic or a wide stencil could make a band differ
(`Pipeline(exact_window=True)`, `ops.base.exact_window`).  Then the
sharded denoiseprofile against the JAX package's `spatial_sharded_pipe`
on four virtual CPU devices, and AMaZE under a plain
`Pipeline(out_window=)`, which keeps the JAX package's windowed pipe
and its gap to the whole frame (ROADMAP R20).

Each demosaic method's reach (`Demosaic.reach`) is also held against
the reach of a perturbed mosaic pixel, as tests/test_torch_rcd.py holds
RCD's kernel halo."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ansel_tpu
import ansel_tpu_torch
from ansel_tpu.io.synthetic import synth_raw
from ansel_tpu.parallel import batch as ref_batch
from ansel_tpu_torch.core.types import CFAPattern, Colorspace, ImageSpec
from ansel_tpu_torch.io import configs
from ansel_tpu_torch.ops import base as ops_base
from ansel_tpu_torch.ops import demosaic as dem
from ansel_tpu_torch.parallel.batch import make_mesh, spatial_sharded_pipe
from ansel_tpu_torch.pipeline import engine

sys.path.insert(0, os.path.dirname(__file__))
from test_all_ops_smoke import MANDATORY, SPECIAL  # noqa: E402
from test_torch_rcd import _reach  # noqa: E402

torch.set_num_threads(1)

H, W, BANDS = 192, 256, 4
# the bands against the single pipe: each kept row is computed by the same
# operations on the same values (0 measured for every case)
SHARDED_TOL = 1e-5
# the sharded denoiseprofile against the JAX package's: the op's own gap
# to the JAX op (tests/test_torch_denoise.py's DP_TOL: XLA divides by the
# EAW weight sum where the port multiplies by its inverse, and sums the
# per-scale variance in another order), carried through colorout's curve
# (2.36e-5 measured); the JAX pipe's GSPMD partition is 2.7e-7 from its
# own single pipe here
JAX_SHARDED_TOL = 5e-5
# AMaZE's windowed pipe against the JAX package's, both with the port's
# AMaZE: the stages around it (rawprepare, white balance, highlight
# clipping, the colour matrices and curves) in torch's and XLA's float32
WINDOWED_JAX_TOL = 1e-5

PPG = ("demosaic", {"demosaicing_method": 0})
XTRANS = "x-trans"

# (label, history, mosaic): the branches beyond the smoke's params
BRANCHES = {
    # the mandatory stages at their defaults, RCD demosaic
    "defaults": ([], None),
    # highlights: CLIP and LCH window; INPAINT and the reconstructions are
    # full-frame boundaries (short runs of the Laplacian's iterations)
    **{f"highlights-{m}": ([("highlights", dict(mode=m, clip=0.5,
                                                 iterations=2, scales=3))],
                           "clipped")
       for m in range(5)},
    # every Bayer method the dispatch names, the bilinear fallback and
    # the passthroughs
    **{f"demosaic-{m}": ([("demosaic", {"demosaicing_method": m})], None)
       for m in (0, 1, 2, 3, 4, 5, 7)},
    **{f"lmmse-refine-{r}": ([("demosaic", {"demosaicing_method": 6,
                                            "lmmse_refine": r})], None)
       for r in range(5)},
    # green equilibration 2 and 3 take one ratio over the frame
    **{f"green-eq-{g}": ([("demosaic", {"green_eq": g})], None)
       for g in (1, 2, 3)},
    "color-smoothing-3": ([("demosaic", {"color_smoothing": 3})], None),
    "dual-rcd": ([("demosaic", {"demosaicing_method": 5 | 0x2000})], None),
    "dual-amaze-smooth": ([("demosaic", {"demosaicing_method": 1 | 0x2000,
                                         "color_smoothing": 2,
                                         "green_eq": 1})], None),
    # X-Trans: Markesteijn 1 and 3 passes, VNG, the dual blend
    **{f"xtrans-{m:#x}": ([("demosaic", {"demosaicing_method": m})], XTRANS)
       for m in (0x1001, 0x1002, 0x1000, 0x3001)},
    # denoiseprofile: wavelets (a detail variance over the frame a
    # scale) in Y0U0V0 and RGB, the automatic profile, NLM
    "denoise-wavelets-rgb": ([("denoiseprofile", dict(
        SPECIAL["denoiseprofile"], wavelet_color_mode=0)), PPG], None),
    "denoise-wavelets-auto": ([("denoiseprofile", {"mode": 4}), PPG], None),
    "denoise-nlm": ([("denoiseprofile", dict(SPECIAL["denoiseprofile"],
                                             mode=0)), PPG], None),
    # filmic's highlight reconstruction and its census of clipped pixels
    "filmicrgb-reconstruct": ([("filmicrgb", {"reconstruct_threshold":
                                              -3.0}), PPG], "clipped"),
    # rawprepare's GainMap flat field, read at each band's origin
    "rawprepare-gainmap": ([("rawprepare", {"flat_field": 1})], "gainmap"),
}


def _mosaic(kind):
    raw, meta, scene = synth_raw(h=H, w=W, kind="gradients")
    if kind == "clipped":
        raw = configs.mosaic15(raw, meta)
    elif kind == XTRANS:
        raw, meta = configs.remosaic_xtrans(meta, scene)
    elif kind == "gainmap":
        meta = configs.gain_map_meta9(meta)
    return np.asarray(raw, np.float32), meta


def _items(pkg, ops):
    return [pkg.HistoryItem(op, dict(p)) for op, p in ops]


def _sharded_gap(ops, kind=None):
    raw, meta = _mosaic(kind)
    hist = _items(ansel_tpu_torch, ops)
    call, pipe = spatial_sharded_pipe(
        meta, hist, make_mesh(BANDS, devices=[torch.device("cpu")] * BANDS))
    got = call(raw)
    ho, wo = pipe.spec_out.height, pipe.spec_out.width
    want = engine.CompiledPipe(pipe)(raw)[:, :ho, :wo]
    assert got.shape == want.shape
    return (got - want).abs().max().item()


@pytest.mark.parametrize("opname", sorted(
    n for n in ops_base.all_ops() if n not in MANDATORY))
def test_each_op_sharded_equals_the_single_pipe(opname):
    ops = [(opname, SPECIAL.get(opname, {}))]
    if opname != "demosaic":
        ops.append(PPG)
    assert _sharded_gap(ops) <= SHARDED_TOL


@pytest.mark.parametrize("label", sorted(BRANCHES))
def test_each_branch_sharded_equals_the_single_pipe(label):
    ops, kind = BRANCHES[label]
    assert _sharded_gap(ops, kind) <= SHARDED_TOL


def _exact_plan(meta, params, cfa_spec):
    ctx = ops_base.PlanContext(meta=meta, notes={"exact_window": True})
    op = ops_base.get_op("demosaic")
    return op, op.plan(ctx, cfa_spec, dem.DemosaicParams(**params)), ctx


@pytest.mark.parametrize("params", [
    {"demosaicing_method": 0}, {"demosaicing_method": 2},
    {"demosaicing_method": 5}, {"demosaicing_method": 7},
    *({"demosaicing_method": 6, "lmmse_refine": r} for r in range(5)),
    {"green_eq": 1, "color_smoothing": 2},
    {"demosaicing_method": 5 | 0x2000},
    {"demosaicing_method": 0x1001}, {"demosaicing_method": 0x1002},
    {"demosaicing_method": 0x1000},
], ids=lambda p: "-".join(f"{k}={v:#x}" for k, v in p.items()))
def test_demosaic_reach_covers_a_perturbed_pixel(params):
    """A mosaic pixel moves no output farther than the reach the window
    grows by, derived from each pass's stencils (`Demosaic.reach`)."""
    xtrans = params.get("demosaicing_method", 0) & 0x1000
    raw, meta = _mosaic(XTRANS if xtrans else None)
    x = torch.from_numpy(raw[:72, :72] / 16383.0)
    spec = ImageSpec(width=72, height=72, colorspace=Colorspace.RAW,
                     channels=1,
                     cfa=CFAPattern.XTRANS if xtrans else CFAPattern.RGGB)
    op, plan, ctx = _exact_plan(meta, params, spec)
    c = {"scaler": torch.tensor(1.0)}
    far = max(_reach(lambda m: op.apply(m, c, plan, ctx), x, 36 + py, 36 + px)
              for py, px in ((0, 0), (1, 1), (2, 3)))
    assert 0 < far <= op.reach(plan, ctx)


def test_amaze_reach_below_and_its_window_from_the_first_row():
    """AMaZE's outputs read at most REACH mosaic rows below them; its
    recurrences carry rows above without bound, so a crop that starts at
    the frame's first row and ends REACH rows below the kept ones
    computes the frame's values there bit for bit."""
    from ansel_tpu_torch.kernels import amaze

    raw, _ = _mosaic(None)
    x = torch.from_numpy(raw / 16383.0)
    full = amaze.amaze_demosaic(x, CFAPattern.RGGB)
    for y1 in (40, 96, 150):
        part = amaze.amaze_demosaic(x[:y1 + amaze.REACH], CFAPattern.RGGB)
        assert torch.equal(part[:, :y1], full[:, :y1]), y1
    # a perturbed pixel moves no output more than REACH rows above it
    y = x.clone()
    y[120, 100] += 0.7
    moved = (amaze.amaze_demosaic(y, CFAPattern.RGGB) != full).any(0)
    rows = torch.nonzero(moved.any(1)).flatten()
    assert 0 < 120 - int(rows.min()) <= amaze.REACH


def test_sharded_denoiseprofile_matches_jax():
    """The port's bands against the JAX package's GSPMD-partitioned pipe
    on four virtual CPU devices: denoiseprofile's wavelets at the smoke's
    params, PPG demosaic."""
    raw, meta = _mosaic(None)
    ops = [("denoiseprofile", SPECIAL["denoiseprofile"]), PPG]
    call, _ = spatial_sharded_pipe(
        meta, _items(ansel_tpu_torch, ops),
        make_mesh(BANDS, devices=[torch.device("cpu")] * BANDS))
    got = call(raw).numpy()
    ref_call, _ = ref_batch.spatial_sharded_pipe(
        meta, _items(ansel_tpu, ops), ref_batch.make_mesh(BANDS, spatial=1))
    want = np.asarray(ref_call(raw))[:, :H, :W]
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= JAX_SHARDED_TOL


def test_windowed_amaze_keeps_the_jax_windows_r20(monkeypatch):
    """A plain `Pipeline(out_window=)` plans AMaZE's window as the JAX
    package plans it (18 px), computes what the JAX windowed pipe
    computes there, and keeps that pipe's gap to the whole frame (R20).
    The JAX pipe runs the port's AMaZE: the two packages' AMaZEs, fed
    the pipe's own input, take another branch here and there (a 1-ulp
    difference flips a comparison of stage 3 or of the escalations: 8e-4
    apart on this frame), which would hide the windows' gap."""
    from ansel_tpu.kernels import amaze as ref_amaze
    from ansel_tpu.pipeline import engine as ref_engine

    from ansel_tpu_torch.kernels import amaze

    def amaze_shared(x, cfa, scaler):
        def f(x, s):
            return amaze.amaze_demosaic(
                torch.from_numpy(np.array(x)), CFAPattern[cfa.name],
                torch.from_numpy(np.array(s))).numpy()
        return jax.pure_callback(
            f, jax.ShapeDtypeStruct((3,) + x.shape, jnp.float32), x, scaler)

    monkeypatch.setattr(ref_amaze, "amaze_demosaic", amaze_shared)
    monkeypatch.setattr(ref_engine, "_COMPILE_CACHE", {})
    raw, meta = _mosaic(None)
    ops = [("demosaic", {"demosaicing_method": 1})]
    win = (48, 0, 48, W)
    out = {}
    for key, w in (("window", win), ("frame", None)):
        port = engine.Pipeline(meta, _items(ansel_tpu_torch, ops),
                               device="cpu", out_window=w)
        ref = ansel_tpu.Pipeline(meta, _items(ansel_tpu, ops), out_window=w)
        assert [s.plan.spec_in.array_shape for s in port.stages] \
            == [s.plan.spec_in.array_shape for s in ref.stages]
        out[key] = (engine.CompiledPipe(port).output_array(raw),
                    ref_engine.CompiledPipe(ref).output_array(raw))
    got, want = out["window"]
    assert got.shape == want.shape == (3, 48, W)
    assert np.abs(got - want).max() <= WINDOWED_JAX_TOL
    # the window's gap to the whole frame, in both packages alike
    gap = np.abs(got - out["frame"][0][:, 48:96]).max()
    ref_gap = np.abs(want - out["frame"][1][:, 48:96]).max()
    assert gap > SHARDED_TOL and ref_gap > SHARDED_TOL
    assert abs(gap - ref_gap) <= WINDOWED_JAX_TOL
