"""The port's blend compositing (`ansel_tpu_torch/pipeline/blend.py`)
against `ansel_tpu/pipeline/blend.py` on the CPU: every blend mode in Lab
and in scene RGB and every mask class of `configs.blend_cases()` through
`compute_mask`, `apply_blend` and `apply_blend_pointwise` (the chain
kernel's blend record's plain twin, also as a packed chain of keep,
stage and blend records); the spatial mask classes (drawn, raster,
details, feathering, both mask blurs); the RAW blend; and a blended pipe
against the JAX package per op and with its fused chains in interpret
mode (R5), the JAX pipe handed the port's RCD twin (held against the
Pallas kernel in tests/test_torch_rcd.py; the JAX package's CPU RCD
differs on a border that a 48 x 64 frame does not leave out).

Inputs are seeded numpy draws: Lab with L in [0, 100] and a, b in [-80,
80]; scene RGB in [-0.05, 1.2].  Tolerances: values within 2e-6 of the
larger of 1 and the reference's magnitude (Lab's OVERLAY and SCREEN on
unscaled Lab reach ~1e4, R13); masks within 2e-6, but those that read
scene RGB's Jz, Cz or hz within JZ_TOL: XLA's and torch's float32 pow
give Jz within 4e-6 and hz within 2e-5 of each other, and a trapezoid
of 0.002 rises at 500 per unit; the blurred and
feathered masks within 1e-5 (torch's and XLA's sums of the box means and
the IIR's); the pipe within the JAX package's own gap between its
spatial and fused paths (`tests/test_blend_fusion.py`: mean 1e-5, max
5e-3)."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ansel_tpu
import ansel_tpu_torch
from ansel_tpu.color import matrices as ref_cm
from ansel_tpu.io.synthetic import synth_raw
from ansel_tpu.kernels import rcd as ref_rcd
from ansel_tpu.pipeline import blend as rb
from ansel_tpu.pipeline import engine as ref_engine
from ansel_tpu_torch.core.types import CFAPattern
from ansel_tpu_torch.io import configs
from ansel_tpu_torch.kernels import pointwise as pw
from ansel_tpu_torch.kernels import rcd
from ansel_tpu_torch.ops.base import PointwiseSpec
from ansel_tpu_torch.pipeline import blend as pb

torch.set_num_threads(1)

REL_TOL = 2e-6
MASK_TOL = 2e-6
JZ_TOL = 1e-3
SPATIAL_TOL = 1e-5
PIPE_MEAN_TOL, PIPE_MAX_TOL = 1e-5, 5e-3
H, W = 24, 40
CASES = configs.blend_cases()


def _pair(cst, seed):
    rng = np.random.default_rng(seed)
    if cst == pb.CS_LAB:
        def one():
            return np.stack([rng.uniform(0, 100, (H, W)),
                             rng.uniform(-80, 80, (H, W)),
                             rng.uniform(-80, 80, (H, W))]).astype(np.float32)
        return one(), one()
    return tuple(rng.uniform(-0.05, 1.2, (3, H, W)).astype(np.float32)
                 for _ in range(2))


def _close(got, want, tol=REL_TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    assert np.array_equal(np.isnan(got), np.isnan(want))
    d = np.abs(np.nan_to_num(got) - np.nan_to_num(want))
    assert d.max() <= tol * scale, (d.max(), scale)


def _both(kw):
    return pb.BlendParams(**kw), rb.BlendParams(**kw)


def _reads_jz(cst, kw):
    """Whether the mask reads scene RGB's Jz, Cz or hz."""
    bits = kw.get("blendif", 0) if kw.get("mask_mode", 0) & 4 else 0
    return cst == pb.CS_RGB_SCENE and bool(bits & 0x7700)


def share_rcd(monkeypatch):
    """The JAX pipe with the port's RCD twin."""
    def rcd_shared(x, cfa, scaler):
        def f(x, s):
            return rcd.rcd_demosaic(torch.from_numpy(np.array(x)),
                                    CFAPattern[cfa.name],
                                    torch.from_numpy(np.array(s))).numpy()
        return jax.pure_callback(
            f, jax.ShapeDtypeStruct((3,) + x.shape, jnp.float32), x, scaler)

    monkeypatch.setattr(ref_rcd, "rcd_demosaic", rcd_shared)


@pytest.mark.parametrize("label,cst,kw", CASES, ids=[c[0] for c in CASES])
def test_blend_case_matches_reference(label, cst, kw):
    a, b = _pair(cst, seed=len(label))
    bp, rbp = _both(kw)
    prm, rprm = pb.prepare_parameters(bp), rb.prepare_parameters(rbp)
    assert np.array_equal(prm, rprm)
    ta, tb, ja, jb = (torch.from_numpy(a), torch.from_numpy(b),
                      jnp.asarray(a), jnp.asarray(b))
    mtol, tol = (JZ_TOL, JZ_TOL) if _reads_jz(cst, kw) else (MASK_TOL,
                                                              REL_TOL)
    _close(pb.compute_mask(ta, tb, bp, prm, cst, pb.cm.WORK_Y),
           rb.compute_mask(ja, jb, rbp, rprm, cst, ref_cm.WORK_Y), mtol)
    _close(pb.apply_blend(ta, tb, bp, prm, cst, pb.cm.WORK_Y),
           rb.apply_blend(ja, jb, rbp, rprm, cst, ref_cm.WORK_Y), tol)
    assert pb.blend_fusable_pointwise(bp, cst)
    want = rb.apply_blend_pointwise(ja, jb, rbp, rprm, cst, ref_cm.WORK_Y)
    _close(pb.apply_blend_pointwise(ta, tb, bp, prm, cst, pb.cm.WORK_Y),
           want, tol)


# a stage between the keep and blend records: a 3x3 matrix
_M = torch.tensor([[0.9, 0.1, 0.05], [0.02, 1.1, -0.05], [0.0, 0.1, 0.95]])
_MID = PointwiseSpec(fn=lambda x, c: pb.tr.apply_matrix(x, c["M"]),
                     opcode=pw.OP_MATRIX, consts=("M",))


@pytest.mark.parametrize("label", ["lab-mode-0x0a", "rgb-mode-0x13",
                                   "rgb-many-curve", "lab-many-combine3",
                                   "rgb-mode-0x18-reverse"])
def test_chain_with_blend_records_matches_reference(label):
    """keep, a matrix stage, blend: the chain's plain twin against JAX's
    apply_blend_pointwise of the stage's input and output; the records'
    layout as the kernel reads it."""
    _, cst, kw = next(c for c in CASES if c[0] == label)
    bp, rbp = _both(kw)
    a, _ = _pair(cst, seed=7)
    keep, blend = pb.blend_specs(bp, cst)
    chain = pw.pack_chain([keep, _MID, blend], [{}, {"M": _M}, {}], "cpu")
    assert chain.reads_kept == (False, False, True)
    prog = chain.prog.view(-1, pw.RECORD).tolist()
    assert [r[0] for r in prog] == [pw.OP_KEEP, pw.OP_MATRIX, pw.OP_BLEND]
    assert prog[2][1] == 9 and tuple(prog[2][2:8]) == pb.blend_record(
        bp, cst)[0]
    ints, consts = pb.blend_record(bp, cst)
    rows = bin(ints[2]).count("1") + bin(ints[3]).count("1")
    assert len(consts) == pb.BLEND_FIXED_CONSTS + 6 * rows
    got = pw.pointwise_chain_reference(torch.from_numpy(a), chain)
    mid = pb.tr.apply_matrix(torch.from_numpy(a), _M).numpy()
    want = rb.apply_blend_pointwise(jnp.asarray(a), jnp.asarray(mid), rbp,
                                    rb.prepare_parameters(rbp), cst,
                                    ref_cm.WORK_Y)
    _close(got, want, JZ_TOL if _reads_jz(cst, kw) else REL_TOL)


def _spatial_inputs(cst):
    a, b = _pair(cst, seed=3)
    rng = np.random.default_rng(11)
    drawn = rng.uniform(0, 1, (H, W)).astype(np.float32)
    raster = rng.uniform(0, 1, (H, W)).astype(np.float32)
    rawdetail = rng.uniform(0, 0.02, (H, W)).astype(np.float32)
    return a, b, drawn, raster, rawdetail


SPATIAL = {
    "drawn": dict(mask_mode=3),
    "drawn-pos-inv": dict(mask_mode=3, mask_combine=5),
    "drawn-param-incl": dict(mask_mode=7, mask_combine=2, blendif=1,
                             blendif_parameters=(0.1, 0.3, 0.7, 0.9) * 16),
    "drawn-missing": dict(mask_mode=3, mask_id=99),
    "raster": dict(mask_mode=9),
    "raster-inverted": dict(mask_mode=9, raster_mask_invert=1),
    "raster-empty": dict(mask_mode=9),
    "details": dict(mask_mode=1, details=0.5),
    "details-negative": dict(mask_mode=1, details=-0.4),
    "feather": dict(mask_mode=3, feathering_radius=3.0),
    "feather-wide": dict(mask_mode=3, feathering_radius=9.0),
    "blur-fir": dict(mask_mode=3, blur_radius=2.0),
    "blur-iir": dict(mask_mode=3, blur_radius=6.0),
    "blur-curve": dict(mask_mode=3, blur_radius=1.5, contrast=0.3,
                       brightness=0.2),
}


@pytest.mark.parametrize("cst", [pb.CS_LAB, pb.CS_RGB_SCENE],
                         ids=["lab", "rgb"])
@pytest.mark.parametrize("name", sorted(SPATIAL))
def test_spatial_mask_class_matches_reference(name, cst):
    a, b, drawn, raster, rawdetail = _spatial_inputs(cst)
    kw = dict(SPATIAL[name], blend_cst=cst, opacity=80.0)
    bp, rbp = _both(kw)
    prm, rprm = pb.prepare_parameters(bp), rb.prepare_parameters(rbp)
    extra = dict(drawn=None if "missing" in name else drawn,
                 raster=None if "empty" in name else raster,
                 rawdetail=rawdetail)
    got = pb.compute_mask(torch.from_numpy(a), torch.from_numpy(b), bp, prm,
                          cst, pb.cm.WORK_Y,
                          **{k: None if v is None else torch.from_numpy(v)
                             for k, v in extra.items()})
    want = rb.compute_mask(jnp.asarray(a), jnp.asarray(b), rbp, rprm, cst,
                           ref_cm.WORK_Y,
                           **{k: None if v is None else jnp.asarray(v)
                              for k, v in extra.items()})
    _close(got, want, SPATIAL_TOL)
    assert not pb.blend_fusable_pointwise(bp, cst)


@pytest.mark.parametrize("mode", [0x18, 0x0A, 0x07 | 0x80000000, 0x13])
@pytest.mark.parametrize("drawn", [True, False])
def test_raw_blend_matches_reference(mode, drawn):
    rng = np.random.default_rng(mode & 0xFF)
    a, b, m = (rng.uniform(0, 1, (H, W)).astype(np.float32)
               for _ in range(3))
    kw = dict(mask_mode=3 if drawn else 1, blend_cst=pb.CS_RAW,
              blend_mode=mode, opacity=75.0, mask_combine=5 if drawn else 1,
              blend_parameter=0.25)
    bp, rbp = _both(kw)
    got = pb.apply_blend_raw(torch.from_numpy(a), torch.from_numpy(b), bp,
                             drawn=torch.from_numpy(m) if drawn else None)
    want = rb.apply_blend_raw(jnp.asarray(a), jnp.asarray(b), rbp,
                              drawn=jnp.asarray(m) if drawn else None)
    _close(got, want)


def _blendif(bl, chans, invert_chan=None, **kw):
    """A parametric NORMAL2 blend of `chans` {id: trapezoid} (the JAX
    package's fusion tests' `_blendif_bp`)."""
    blendif, prm = 0, [0.0] * (4 * bl.BLENDIF_SIZE)
    for i, t in chans.items():
        blendif |= 1 << i
        prm[4 * i:4 * i + 4] = t
    if invert_chan is not None:
        blendif |= 1 << (16 + invert_chan)
    return bl.BlendParams(mask_mode=bl.MASK_ENABLED | bl.MASK_PARAMETRIC,
                          blend_mode=bl.B_NORMAL2, opacity=85.0,
                          blendif=blendif, blendif_parameters=tuple(prm),
                          **kw)


# a blended pipe of the JAX package's fusion tests' classes
# (tests/test_blend_fusion.py): velvia under a parametric scene RGB mask
# (grey and the output's Jz, the mask curve), colorize in HUE, colisa
# under an inverted Lab mask in INCL mode, then in LAB_LIGHTNESS on a
# second instance
PIPES = {
    "fusion-classes": lambda pkg, bl: [
        pkg.HistoryItem("exposure", {"exposure": 0.6}),
        pkg.HistoryItem("velvia", {"strength": 50.0}, blend_params=_blendif(
            bl, {0: (0.05, 0.15, 0.6, 0.8), 12: (0.01, 0.05, 0.3, 0.5)},
            blend_cst=bl.CS_RGB_SCENE, contrast=0.4, brightness=-0.2)),
        pkg.HistoryItem("filmicrgb", {}),
        pkg.HistoryItem("colorize", {"saturation": 0.4, "lightness": 55.0},
                        blend_params=bl.BlendParams(
                            mask_mode=bl.MASK_ENABLED, blend_mode=bl.B_HUE,
                            opacity=100.0, blend_cst=bl.CS_LAB)),
        pkg.HistoryItem("colisa", {"contrast": 0.1}, blend_params=_blendif(
            bl, {1: (0.1, 0.2, 0.7, 0.9)}, invert_chan=1,
            mask_combine=bl.COMBINE_INCL, blend_cst=bl.CS_LAB)),
        pkg.HistoryItem("colisa", {"saturation": 0.2}, multi_priority=1,
                        blend_params=bl.BlendParams(
                            mask_mode=bl.MASK_ENABLED,
                            blend_mode=bl.B_LAB_LIGHTNESS, opacity=33.0,
                            blend_cst=bl.CS_LAB))],
}


@pytest.fixture(scope="module", params=sorted(PIPES))
def blended_pipe(request):
    raw, meta, _ = synth_raw(h=48, w=64, kind="gradients")
    hist = PIPES[request.param]
    pipe = ansel_tpu_torch.compile_pipeline(meta, hist(ansel_tpu_torch, pb),
                                            device="cpu")
    return pipe, pipe.output_array(raw), raw, meta, hist


def test_blended_stages_ride_the_chain(blended_pipe):
    """Every blend of these histories is per pixel, so each blended stage
    is wrapped in keep and blend records inside a chain."""
    pipe = blended_pipe[0]
    assert "blend" not in [k for k, *_ in pipe.steps]
    chains = [a for k, _, _, a in pipe.steps if k == "chain"]
    ops = [r[0] for c in chains for r in c.prog.view(-1, pw.RECORD).tolist()]
    n = sum(s.blend is not None for s in pipe.pipe.stages)
    assert n == 4 and ops.count(pw.OP_KEEP) == ops.count(pw.OP_BLEND) == n


@pytest.mark.parametrize("fused", [False, True], ids=["per-op", "fused"])
def test_blended_pipe_matches_the_jax_package(blended_pipe, fused,
                                              monkeypatch):
    pipe, got, raw, meta, hist = blended_pipe
    share_rcd(monkeypatch)
    monkeypatch.setattr(ref_engine, "_FORCE_FUSION_INTERPRET", fused)
    ref_engine._COMPILE_CACHE.clear()
    try:
        want = np.asarray(ansel_tpu.compile_pipeline(
            meta, hist(ansel_tpu, rb)).output_array(raw))
    finally:
        ref_engine._COMPILE_CACHE.clear()
    d = np.abs(got - want)
    assert d.mean() <= PIPE_MEAN_TOL and d.max() <= PIPE_MAX_TOL


def test_undecodable_or_inactive_blend_plans_as_none():
    raw, meta, _ = synth_raw(h=16, w=24)
    for blob in (b"\x01\x02", pb.BlendParams().codec.encode(
            pb.BlendParams())):
        pipe = ansel_tpu_torch.Pipeline(
            meta, [ansel_tpu_torch.HistoryItem("exposure", {},
                                               blend_params=blob)],
            device="cpu")
        assert all(s.blend is None and s.blend_static is None
                   for s in pipe.stages)


def test_blended_chain_splits_at_max_stages():
    """Blend records count against pointwise.MAX_STAGES: six blended
    stages after exposure and colorin take 2 + 6 x 3 = 20 records, so
    the chain splits where the next stage's three would pass 16."""
    raw, meta, _ = synth_raw(h=16, w=24, kind="gradients")
    bp = pb.BlendParams(mask_mode=pb.MASK_ENABLED, opacity=50.0)
    hist = [ansel_tpu_torch.HistoryItem("exposure", {"exposure": 0.5})] + [
        ansel_tpu_torch.HistoryItem("velvia", {"strength": 10.0 + k},
                                    multi_priority=k, blend_params=bp)
        for k in range(6)]
    pipe = ansel_tpu_torch.compile_pipeline(meta, hist, device="cpu")
    chains = [a for k, _, _, a in pipe.steps if k == "chain"]
    records = [c.prog.numel() // pw.RECORD for c in chains]
    assert max(records) <= pw.MAX_STAGES and sum(records) >= 20
    assert len(chains) >= 2
    flat = [r[0] for c in chains for r in c.prog.view(-1, pw.RECORD).tolist()]
    assert flat.count(pw.OP_KEEP) == flat.count(pw.OP_BLEND) == 6
    assert np.isfinite(pipe.output_array(raw)).all()
