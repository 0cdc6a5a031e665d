"""The port's CUDA kernels against their plain torch versions, on the card.

Every test needs a CUDA device and skips without one.  This file imports
neither JAX nor ansel_tpu, so it runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

import ansel_tpu_torch as port
from ansel_tpu_torch.core.params import params_class
from ansel_tpu_torch.core.types import (CFAPattern, Colorspace, ImageSpec,
                                        RawMeta)
from ansel_tpu_torch.io import configs
from ansel_tpu_torch.io.synthetic import synth_raw
from ansel_tpu_torch.kernels import (bgrid, diffuse, eaw, iir, markesteijn,
                                     nlm, sepblur, warp)
from ansel_tpu_torch.kernels import highlights_laplacian as hl
from ansel_tpu_torch.kernels import pointwise as pw
from ansel_tpu_torch.kernels import rcd
from ansel_tpu_torch.ops.base import pad_to
from ansel_tpu_torch.pixel.blur import _deriche_coeffs
from ansel_tpu_torch.pixel.nlmeans import search_offsets
from ansel_tpu_torch.pipeline import engine

torch.set_num_threads(2)

# The kernels repeat the plain versions' float32 operations in the same
# order (nvcc --fmad=false); the chain's powf/log2f/expf may differ from
# torch's by an ulp.  RCD and Markesteijn have no transcendental, use
# IEEE divisions and equal their twins bit for bit.
CHAIN_MAX_TOL, CHAIN_MEAN_TOL = 1e-4, 1e-6
# sepblur, EAW and NLM repeat their twins' float32 operations in the same
# order, and the fast exponentials are bit tricks; values are below ~2.5.
# The diffuse kernel too: its rsqrtf and expf are the calls torch.rsqrt
# and torch.exp make on the card.  sepblur, NLM, the IIR and the
# isotropic diffuse iteration have no transcendental and equal their
# twins bit for bit (max error 0); the anisotropic diffuse modes and the
# rest are held to STENCIL_TOL.
STENCIL_TOL = 1e-5

# ragged frames: a block's tile divides none of them
FRAMES = [(5, 7), (136, 400), (64, 1000)]
B3 = (1 / 16, 4 / 16, 6 / 16, 4 / 16, 1 / 16)


def _spacings(n):
    """1, 2, 4, ... up to the first spacing whose B3 reach (2 x spacing)
    passes n px."""
    out = [1]
    while 2 * out[-1] <= n:
        out.append(2 * out[-1])
    return out


SEP_CASES = [(hw, c, d) for hw in FRAMES for c in (None, 4)
             for d in _spacings(max(hw))]
EAW_CASES = [(hw, d.bit_length() - 1, v) for hw in FRAMES
             for v in ("dn", "atrous") for d in _spacings(max(hw))]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# smaller than a block's tile, ragged in both axes, exactly one tile and
# one pixel more, a frame ending mid-tile in both axes
@pytest.mark.parametrize("cfa", ["RGGB", "BGGR", "GRBG", "GBRG"])
@pytest.mark.parametrize("h,w,scaler", [
    (136, 400, 2.7), (5, 7, 1.0), (64, 1000, 0.5),
    (rcd.TILE_H, rcd.TILE_W, 1.0), (rcd.TILE_H + 1, rcd.TILE_W + 1, 1.3),
    (2 * rcd.TILE_H + 6, 3 * rcd.TILE_W + 6, 2.0)])
def test_rcd_kernel_matches_plain(cuda, cfa, h, w, scaler):
    rng = np.random.default_rng(h * w)
    x = torch.from_numpy((rng.uniform(0, 1, (h, w)) * scaler)
                         .astype(np.float32)).to(cuda)
    before = rcd.LAUNCHES
    got = rcd.rcd_demosaic(x, CFAPattern[cfa], scaler)
    assert rcd.LAUNCHES == before + 1
    want = rcd.rcd_demosaic_reference(x, CFAPattern[cfa], scaler)
    torch.cuda.synchronize()
    assert got.shape == (3, h, w)
    assert torch.equal(got, want)


@pytest.mark.parametrize("cfa", ["RGGB", "GBRG"])
def test_rcd_kernel_propagates_nan_like_plain(cuda, cfa):
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.uniform(0, 1, (70, 150)).astype(np.float32))
    x[3, 5] = x[40, 64] = float("nan")
    x[60, 140] = float("inf")
    x = x.to(cuda)
    got = rcd.rcd_demosaic(x, CFAPattern[cfa], 1.5)
    want = rcd.rcd_demosaic_reference(x, CFAPattern[cfa], 1.5)
    torch.cuda.synchronize()
    assert torch.isnan(want).any()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(got.nan_to_num(7.0), want.nan_to_num(7.0))


def test_rcd_kernel_refuses_bad_input(cuda):
    x = torch.zeros((16, 16), device=cuda)
    with pytest.raises(ValueError):
        rcd.rcd_demosaic(x.double(), CFAPattern.RGGB)
    with pytest.raises(ValueError):
        rcd.rcd_demosaic(x.t()[:, :8], CFAPattern.RGGB)
    with pytest.raises(ValueError):
        rcd.rcd_demosaic(x[None], CFAPattern.RGGB)


def _chain(items, cuda, lab_round_trip=False):
    _, meta, _ = synth_raw(h=64, w=256)
    pipe = port.Pipeline(meta, [port.HistoryItem(o, p) for o, p in items],
                         device=cuda)
    if lab_round_trip:
        at = [s.name for s in pipe.stages].index("channelmixerrgb") + 1
        spec = pipe.stages[at - 1].plan.spec_out
        to_lab = engine._CONVERT.plan_pair(spec, Colorspace.LAB)
        back = engine._CONVERT.plan_pair(to_lab.spec_out, Colorspace.WORK_RGB)
        pipe.stages[at:at] = [
            engine.PlannedOp("_convert", engine._CONVERT, to_lab, None),
            engine.PlannedOp("_convert", engine._CONVERT, back, None)]
    compiled = engine.CompiledPipe(pipe)
    chains = [a for kind, _, _, a in compiled.steps if kind == "chain"]
    assert len(chains) == 1
    return chains[0]


def _cmx(**kw):
    return [("channelmixerrgb", kw), ("filmicrgb", {})]


CHAINS = {
    "config1": list(configs.HISTORIES[1]),
    "cmx-bradford-v1": _cmx(adaptation=0, version=0,
                            saturation=(0.3, -0.2, 0.1, 0.0),
                            lightness=(0.1, 0.0, -0.1, 0.0)),
    "cmx-cat16-v2": _cmx(adaptation=1, version=1, gamut=1.7,
                         saturation=(0.3, -0.2, 0.1, 0.0)),
    "cmx-full-bradford-v3": _cmx(adaptation=2, version=2, clip=0,
                                 lightness=(0.2, -0.1, 0.0, 0.0),
                                 illuminant=1),
    "cmx-xyz-grey": _cmx(adaptation=3, grey=(0.3, 0.5, 0.2, 0.0),
                         gamut=0.0),
    "cmx-rgb-mix": _cmx(adaptation=4, red=(0.9, 0.1, 0.0, 0.0),
                        lightness=(0.0, 0.1, 0.0, 0.0)),
    "agx-v6-poly": [("filmicrgb", {"version": 5, "shadows": 0,
                                   "highlights": 1})],
    "agx-v10-poly": [("filmicrgb", {"version": 9, "shadows": 1,
                                    "highlights": 0})],
    "colorout-gamma": [("filmicrgb", {}), ("colorout", {"type": 2})],
    "colorout-linear": [("filmicrgb", {}), ("colorout", {"type": 4})],
}


@pytest.mark.parametrize("name", sorted(CHAINS) + ["lab-round-trip"])
def test_chain_kernel_matches_plain(cuda, name):
    """Every case through its specialised kernel (all but the Lab round
    trip have one) and through the interpreter, on a frame of whole
    pixel pairs and on an odd one: the two kernels equal each other bit
    for bit, and the plain twin within the chain's tolerance."""
    items = CHAINS.get(name, CHAINS["config1"])
    chain = _chain(items, cuda, lab_round_trip=name == "lab-round-trip")
    assert (chain.fixed >= 0) == (name != "lab-round-trip")
    rng = np.random.default_rng(5)
    for hw in [(64, 256), (5, 7)]:
        x = torch.from_numpy(rng.uniform(-0.2, 3.0, (3,) + hw)
                             .astype(np.float32)).to(cuda)
        before = pw.LAUNCHES
        got = pw.pointwise_chain(x, chain)
        interpreted = pw.pointwise_chain(x, dataclasses.replace(chain, fixed=-1))
        assert pw.LAUNCHES == before + 2
        want = pw.pointwise_chain_reference(x, chain)
        torch.cuda.synchronize()
        assert torch.isfinite(want).all()
        assert torch.equal(got, interpreted)
        d = (got - want).abs()
        assert d.max().item() <= CHAIN_MAX_TOL
        assert d.mean().item() <= CHAIN_MEAN_TOL


def test_chain_kernel_propagates_nan_like_plain(cuda):
    chain = _chain(CHAINS["config1"], cuda)
    x = torch.full((3, 8, 32), 0.5, device=cuda)
    x[0, 0, :4] = float("nan")
    x[1, 1, :4] = float("inf")
    x[2, 2, :4] = -float("inf")
    got = pw.pointwise_chain(x, chain)
    interpreted = pw.pointwise_chain(x, dataclasses.replace(chain, fixed=-1))
    want = pw.pointwise_chain_reference(x, chain)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(got.nan_to_num(7.0), interpreted.nan_to_num(7.0))
    d = (got - want).abs().nan_to_num(0.0)
    assert d.max().item() <= CHAIN_MAX_TOL


def test_chain_kernel_refuses_bad_input(cuda):
    chain = _chain(CHAINS["config1"], cuda)
    x = torch.zeros((3, 8, 32), device=cuda)
    with pytest.raises(ValueError):
        pw.pointwise_chain(x[:2], chain)
    with pytest.raises(ValueError):
        pw.pointwise_chain(x.transpose(1, 2), chain)
    cpu_chain = dataclasses.replace(chain, prog=chain.prog.cpu())
    with pytest.raises(ValueError):
        pw.pointwise_chain(x, cpu_chain)


BLEND_CASES = configs.blend_cases()


@pytest.mark.parametrize("label,cst,kw", BLEND_CASES,
                         ids=[c[0] for c in BLEND_CASES])
def test_blend_record_matches_plain(cuda, label, cst, kw):
    """Every blend mode in Lab and scene RGB and every mask class as a
    chain of keep, a matrix stage and blend records (the interpreter):
    the plain twin's float32 operations in the same order, so bit for bit
    but where a device function (cosf, sinf, powf in Jz) rounds otherwise
    than torch's, within the chain's tolerance."""
    rng = np.random.default_rng(len(label))
    if cst == 2:   # Lab
        x = np.stack([rng.uniform(0, 100, (37, 53)),
                      rng.uniform(-80, 80, (37, 53)),
                      rng.uniform(-80, 80, (37, 53))])
    else:
        x = rng.uniform(-0.05, 1.2, (3, 37, 53))
    x = torch.from_numpy(x.astype(np.float32)).to(cuda)
    chain = configs.blend_case_chain(cst, kw, cuda)
    before = pw.LAUNCHES
    got = pw.pointwise_chain(x, chain)
    assert pw.LAUNCHES == before + 1
    want = pw.pointwise_chain_reference(x, chain)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    scale = max(1.0, want.nan_to_num(0.0).abs().max().item())
    d = (got - want).abs().nan_to_num(0.0)
    assert d.max().item() <= CHAIN_MAX_TOL * scale
    assert d.mean().item() <= CHAIN_MEAN_TOL * scale


def test_config13_pipe_on_cuda_matches_cpu(cuda):
    """Config 13 at 192 x 288 on the card (RCD, the four chains with their
    blend records in their specialised programs, sepblur, the IIR) against
    the same pipe on the CPU, which runs every twin."""
    raw, meta, _ = synth_raw(h=192, w=288, kind="gradients")
    on_card = port.compile_pipeline(meta, configs.history(13), device=cuda,
                                    forms=configs.forms(13))
    chains = [a for k, _, _, a in on_card.steps if k == "chain"]
    assert len(chains) == 4 and all(c.fixed >= 0 for c in chains)
    rcd.LAUNCHES = pw.LAUNCHES = iir.LAUNCHES = sepblur.LAUNCHES = 0
    got = on_card.output_array(raw)
    assert (rcd.LAUNCHES, pw.LAUNCHES) == (1, 4)
    assert iir.LAUNCHES >= 2 and sepblur.LAUNCHES > 8
    want = port.compile_pipeline(meta, configs.history(13), device="cpu",
                                 forms=configs.forms(13)).output_array(raw)
    d = np.abs(got - want)
    assert d.max() <= 1.0 / 255.0 and d.mean() <= 1e-5


def test_pipe_on_cuda_matches_cpu(cuda):
    raw, meta, _ = synth_raw(h=144, w=400)
    hist = [port.HistoryItem(o, p) for o, p in CHAINS["config1"]]
    on_card = port.compile_pipeline(meta, hist, device=cuda)
    rcd.LAUNCHES = pw.LAUNCHES = 0
    got = on_card.output_array(raw)
    assert (rcd.LAUNCHES, pw.LAUNCHES) == (1, 1)
    want = port.compile_pipeline(meta, hist, device="cpu").output_array(raw)
    assert np.abs(got - want).max() <= 1.0 / 255.0


def _noisy(shape, seed, cuda):
    rng = np.random.default_rng(seed)
    x = rng.random(shape).astype(np.float32)
    x[..., shape[-2] // 4: shape[-2] // 2, shape[-1] // 4: shape[-1] // 2] += 1.5
    return torch.from_numpy(x).to(cuda)


@pytest.mark.parametrize("hw,c,d", SEP_CASES)
def test_sepblur_kernel_matches_plain(cuda, hw, c, d):
    x = _noisy(hw if c is None else (c,) + hw, d, cuda)
    before = sepblur.LAUNCHES
    got = sepblur.sep_blur(x, B3, d)
    assert sepblur.LAUNCHES == before + 1
    want = sepblur.sep_blur_reference(x, B3, d)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("c", [None, 4])
@pytest.mark.parametrize("d", [64, 127, 128, 256, 512])
def test_sepblur_kernel_takes_every_reach(cuda, c, d):
    """Reach 2d up to 1024, the highlights Laplacian's widest (5 taps at
    d = 512), on both forms: a shared strip below d = 256, two passes
    through a scratch plane from there on."""
    x = _noisy((120, 1504) if c is None else (c, 120, 1504), d + 1, cuda)
    before = sepblur.LAUNCHES
    got = sepblur.sep_blur(x, B3, d)
    assert sepblur.LAUNCHES == before + 1
    want = sepblur.sep_blur_reference(x, B3, d)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_sepblur_kernel_long_taps_and_refusals(cuda):
    x = _noisy((3, 64, 1000), 7, cuda)
    taps = [0.05, -0.1, 0.2, 0.3, 0.2, -0.1, 0.05, 0.1, 0.3]
    # 201 taps at d = 36 run 7 rows a block, on the kernel for any count
    for taps, d in ((taps, 9), (taps, 200), ([0.005] * 201, 36)):
        got = sepblur.sep_blur(x, taps, d)
        want = sepblur.sep_blur_reference(x, taps, d)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    with pytest.raises(ValueError):
        # one row of strip over 227 KB; no caller of the port asks for one
        sepblur.sep_blur(x, [0.001] * 513, 114)
    with pytest.raises(ValueError):
        sepblur.sep_blur(x.double(), B3, 1)
    with pytest.raises(ValueError):
        sepblur.sep_blur(x.transpose(1, 2), B3, 1)


@pytest.mark.parametrize("shape", [(37, 530), (2, 37, 530), (5, 300),
                                   (3, 5, 300)])
@pytest.mark.parametrize("n", [3, 5, 33])
@pytest.mark.parametrize("d", [1, 2, 7, 32, 127, 128, 512])
def test_sepblur_kernel_every_form(cuda, shape, n, d):
    """Both forms (a shared strip, two passes from d = 256), the
    templates of 16 and 8 rows, the residue-class tiling, frames shorter
    than d and than one block: equal to the twin bit for bit."""
    x = _noisy(shape, n * d, cuda)
    taps = np.random.default_rng(n).uniform(-0.2, 0.6, n).astype(np.float32)
    taps = [float(t) for t in taps]
    before = sepblur.LAUNCHES
    got = sepblur.sep_blur(x, taps, d)
    assert sepblur.LAUNCHES == before + 1
    want = sepblur.sep_blur_reference(x, taps, d)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("hw", [(5, 7), (37, 530), (300, 20)])
@pytest.mark.parametrize("scale", range(8))
@pytest.mark.parametrize("variant", [eaw.DN, eaw.ATROUS])
def test_eaw_kernel_every_form(cuda, hw, scale, variant):
    """Both tile forms (contiguous below d = 64, gathered from there) and
    the residue-class tiling, frames shorter and narrower than d: equal
    to the twin bit for bit."""
    x = _noisy((3,) + hw, scale + 1, cuda)
    const = float(np.float32(0.8 ** scale)) if variant == eaw.DN else 3.0
    fn = eaw.eaw_dn_coarse if variant == eaw.DN else eaw.eaw_atrous_coarse
    before = eaw.LAUNCHES
    got = fn(x, scale, const)
    assert eaw.LAUNCHES == before + 1
    want = eaw.eaw_coarse_reference(x, scale, const, variant)
    torch.cuda.synchronize()
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)


@pytest.mark.parametrize("hw,scale,variant", EAW_CASES)
def test_eaw_kernel_matches_plain(cuda, hw, scale, variant):
    x = _noisy((3,) + hw, scale, cuda)
    const = 1.0 / 1.25 ** (2 * scale) if variant == "dn" else 3.0
    fn = eaw.eaw_dn_coarse if variant == "dn" else eaw.eaw_atrous_coarse
    before = eaw.LAUNCHES
    got = fn(x, scale, const)
    assert eaw.LAUNCHES == before + 1
    want = eaw.eaw_coarse_reference(
        x, scale, const, eaw.DN if variant == "dn" else eaw.ATROUS)
    torch.cuda.synchronize()
    for g, w_ in zip(got, want):
        assert torch.isfinite(g).all()
        assert (g - w_).abs().max().item() <= STENCIL_TOL


@pytest.mark.parametrize("hw", FRAMES + [(1, 300), (300, 1)])
@pytest.mark.parametrize("variant,P,K,scattering", [
    (1, 1, 7, 0.0), (0, 2, 3, 0.0), (1, 1, 4, 0.3), (1, 8, 2, 0.0),
    (0, 8, 3, 0.0), (1, 1, 15, 0.0), (1, 1, 7, 1.0), (0, 3, 7, 1.0)])
def test_nlm_kernel_matches_plain(cuda, hw, variant, P, K, scattering):
    """Both paths: the resident search window, and the streamed one of a
    scattered lattice (reach 86 at K 7); P up to 8; 900 offsets (the first
    of K 15's 961)."""
    x = _noisy((3,) + hw, K, cuda)
    offs = search_offsets(K, scattering)[:nlm.MAX_OFFSETS]
    assert nlm.plan(P, nlm._reach(offs))[0] == (scattering < 1.0)
    if variant == 1:
        n = 2 * P + 1
        args = (torch.tensor(0.005, device=cuda), 0.1 * n * n, 1.0 / 1.1)
    else:
        args = (0.02, 0.0, 1.0)
    before = nlm.LAUNCHES
    got = nlm.nlm(x, offs, P, (1.0, 0.5, 0.7), *args, variant)
    assert nlm.LAUNCHES == before + 1
    want = nlm.nlm_reference(x, offs, P, (1.0, 0.5, 0.7), *args, variant)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


@pytest.mark.parametrize("scales", [11, 12])
def test_laplacian_reconstruct_past_reach_256_on_cuda(cuda, scales):
    """`scales` 11 and 12 blur at dilations up to 256 and 512 (reach 512
    and 1024) through the sepblur kernel; the card matches the CPU within
    the reconstruction's own tie tolerance (tests/test_torch_laplacian.py:
    a guided fit whose channel variances tie picks its channel by
    rounding, which moves a patch by up to 7.5e-4)."""
    rng = np.random.default_rng(scales)
    x = rng.uniform(0.05, 0.6, (72, 104)).astype(np.float32)
    x[20:44, 30:70] = rng.uniform(0.9, 1.2, (24, 40)).astype(np.float32)
    args = ([0.8, 0.85, 0.9], CFAPattern.RGGB, scales, 2, 0.0, 0.5)
    sepblur.LAUNCHES = 0
    got = hl.laplacian_reconstruct(torch.from_numpy(x).to(cuda), *args)
    n = scales - 2          # the scales of a x4 downsampled pyramid
    assert sepblur.LAUNCHES == 2 * 2 * n
    want = hl.laplacian_reconstruct(torch.from_numpy(x), *args)
    assert np.abs(got.cpu().numpy() - want.numpy()).max() <= 1e-3


def test_config2_pipe_on_cuda_matches_cpu(cuda):
    raw, meta, _ = synth_raw(h=160, w=240, kind="gradients")
    hist = configs.history(2)
    on_card = port.compile_pipeline(meta, hist)
    assert on_card.device.type == "cuda"
    for mod in (rcd, pw, sepblur, eaw, nlm):
        mod.LAUNCHES = 0
    got = on_card.output_array(raw)
    # 5 wavelet scales at this size; 30 iterations x 2 passes x 6 scales
    assert ((rcd.LAUNCHES, pw.LAUNCHES, eaw.LAUNCHES, nlm.LAUNCHES,
             sepblur.LAUNCHES) == (1, 1, 5, 1, 360))
    want = port.compile_pipeline(meta, hist, device="cpu").output_array(raw)
    assert np.abs(got - want).max() <= 1.0 / 255.0


IIR_CASES = [((5, 7), 0, None), ((1, 37, 53), 0, None), ((3, 64, 1000), 1, None),
             ((2, 136, 400), 2, None), ((2, 37, 53), 0, (0.0, 1.0)),
             ((2, 1376, 2064), 0, None)]


@pytest.mark.parametrize("shape,order,clip", IIR_CASES)
def test_iir_kernel_matches_plain(cuda, shape, order, clip):
    x = _noisy(shape, order, cuda)
    sigma = max(shape[-1] / 20.0, 1.0)
    coef = _deriche_coeffs(sigma, order)
    lo, hi = clip or (None, None)
    before = iir.LAUNCHES
    got = iir.gaussian_iir(x, coef, lo, hi)
    assert iir.LAUNCHES == before + 1
    want = iir.gaussian_iir_reference(x, coef, lo, hi)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    # the twin's float32 operations in the same order: bit for bit
    assert torch.equal(got, want)


def _same(a, b):
    """Equal bit for bit where finite or infinite, NaN at the same places."""
    return (torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))


# the kernel's chunks are 32 steps and each direction stops at half the
# 8-padded length: lengths 63, 64, 65 put that half at a chunk's end, 7,
# 8, 9 at the padding's; line counts of 1, 5, 17 and 47 fill no warp's 16
# lines (each pass's lines are the other side's length times the planes)
IIR_EDGE_SHAPES = [(1, 63, 64), (1, 64, 65), (1, 65, 63), (1, 7, 9),
                   (5, 8, 7), (1, 9, 1), (1, 1, 17), (1, 47, 127),
                   (3, 129, 33)]


@pytest.mark.parametrize("shape", IIR_EDGE_SHAPES)
@pytest.mark.parametrize("special", [None, "nan", "inf"])
@pytest.mark.parametrize("clip", [None, (0.0, 1.0)])
def test_iir_kernel_at_chunk_and_padding_edges(cuda, shape, special, clip):
    x = _noisy(shape, sum(shape), cuda)
    if special is not None:
        # one non-finite value and one of each sign later in the frame
        v = float("nan") if special == "nan" else float("inf")
        x[0, shape[1] // 2, shape[2] // 3] = v
        x[-1, -1, -1] = -float("inf")
    coef = _deriche_coeffs(max(shape[-1] / 5.0, 1.0), 0)
    lo, hi = clip or (None, None)
    got = iir.gaussian_iir(x, coef, lo, hi)
    want = iir.gaussian_iir_reference(x, coef, lo, hi)
    torch.cuda.synchronize()
    assert _same(got, want)


@pytest.mark.parametrize("shape", [(2, 64, 64), (1, 37, 100)])
def test_iir_kernel_on_an_unaligned_view(cuda, shape):
    """A width that is a multiple of 4 takes 16-byte copies when the planes
    are 16-byte aligned; a view one float into its storage takes the
    4-byte copies, with the same result."""
    n = int(np.prod(shape))
    flat = np.random.default_rng(n).random(n + 1).astype(np.float32)
    x = torch.from_numpy(flat).to(cuda)[1:].reshape(shape)
    coef = _deriche_coeffs(9.0, 1)
    got = iir.gaussian_iir(x, coef)
    want = iir.gaussian_iir_reference(x, coef)
    aligned = iir.gaussian_iir(x.clone(), coef)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(aligned, want)


def test_iir_kernel_refuses_bad_input(cuda):
    x = torch.zeros((2, 16, 16), device=cuda)
    coef = _deriche_coeffs(3.0)
    with pytest.raises(ValueError):
        iir.gaussian_iir(x.double(), coef)
    with pytest.raises(ValueError):
        iir.gaussian_iir(x.transpose(1, 2), coef)
    with pytest.raises(ValueError):
        iir.gaussian_iir(x, coef[:6])


def _diffuse_coeffs(scales, cuda, seed=1):
    rng = np.random.default_rng(seed)
    c = {"aniso": np.float32([1.5, 0.7, 2.0, 0.3]),
         "ABCD": rng.uniform(-0.05, 0.05, (scales, 4)),
         "strength": rng.uniform(0.9, 1.2, scales),
         "norm_reg": rng.uniform(0.1, 0.5, scales),
         "variance_threshold": 0.05}
    return {k: torch.as_tensor(np.float32(v), device=cuda)
            for k, v in c.items()}


DIFFUSE_CASES = [((5, 7), 1, (0, 0, 0, 0)), ((5, 7), 3, (1, 2, 0, 1)),
                 ((37, 50), 2, (2, 0, 1, 0)), ((37, 50), 5, (0, 2, 2, 1)),
                 ((136, 400), 4, (1, 1, 2, 2)), ((136, 400), 5, (0, 0, 0, 0)),
                 ((64, 1000), 3, (2, 1, 0, 2)), ((1376, 2064), 5, (1, 0, 2, 0))]
# for each S: a frame under the fused tiles' halo (14 px in the decompose,
# 7 in the PDE) and one that no tile (32 x 64) divides, isotropic and not
DIFFUSE_CASES += [(hw, s, modes) for s in range(1, 6)
                  for hw in ((3, 4), (1, 9), (97, 131))
                  for modes in ((0, 0, 0, 0), (1, 2, 2, 1))]


@pytest.mark.parametrize("hw,scales,modes", DIFFUSE_CASES)
def test_diffuse_kernel_matches_plain(cuda, hw, scales, modes):
    x = _noisy((3,) + hw, scales, cuda) * 0.5 + 0.05
    c = _diffuse_coeffs(scales, cuda, hw[0])
    before = diffuse.LAUNCHES
    got = diffuse.diffuse_iteration(x, c, scales, modes)
    assert diffuse.LAUNCHES == before + 1
    want = diffuse.diffuse_iteration_reference(x, c, scales, modes)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    if tuple(modes) == (0, 0, 0, 0):
        assert torch.equal(got, want)       # no transcendental: bit for bit
    else:
        assert (got - want).abs().max().item() <= STENCIL_TOL


def test_diffuse_kernel_refuses_bad_input(cuda):
    x = torch.rand((3, 16, 16), device=cuda)
    c = _diffuse_coeffs(2, cuda)
    with pytest.raises(ValueError):
        diffuse.diffuse_iteration(x, c, 6, (0, 0, 0, 0))
    with pytest.raises(ValueError):
        diffuse.diffuse_iteration(x, c, 2, (0, 3, 0, 0))
    with pytest.raises(ValueError):
        diffuse.diffuse_iteration(x[:2], c, 2, (0, 0, 0, 0))
    with pytest.raises(ValueError):
        diffuse.diffuse_iteration(x, {k: v.cpu() for k, v in c.items()}, 2,
                                  (0, 0, 0, 0))


def test_config3_pipe_on_cuda_matches_cpu(cuda):
    raw, meta, _ = synth_raw(h=160, w=240, kind="gradients")
    hist = configs.history(3)
    on_card = port.compile_pipeline(meta, hist)
    mods = (rcd, pw, sepblur, eaw, nlm, iir, diffuse)
    for mod in mods:
        mod.LAUNCHES = 0
    got = on_card.output_array(raw)
    # 4 chains; a 6-level pyramid at this size: 14 x 5 blurs
    assert [m.LAUNCHES for m in mods] == [1, 4, 70, 0, 0, 1, 4]
    want = port.compile_pipeline(meta, hist, device="cpu").output_array(raw)
    assert np.abs(got - want).max() <= 1.0 / 255.0


# tiny, odd, a 1000 x 1500-class frame; exactly one of the kernel's
# tiles, one pixel more, and a frame ending mid-tile in both axes
MARK_FRAMES = [(5, 7), (37, 101), (1002, 1499),
               (markesteijn.TILE_H, markesteijn.TILE_W),
               (markesteijn.TILE_H + 1, markesteijn.TILE_W + 1), (70, 45)]


def _shifted(dy, dx):
    """XTRANS6 with its period shifted by (dy, dx): a frame whose tile
    origins fall on other X-Trans phases."""
    return tuple(int(c) for c in np.roll(
        np.asarray(configs.XTRANS6).reshape(6, 6), (dy, dx), (0, 1))
        .reshape(-1))


def _mosaic(h, w, seed, smooth, pattern6=configs.XTRANS6):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    scene = np.stack([0.2 + 0.6 * xx / w, 0.3 + 0.5 * yy / h,
                      0.25 + 0.2 * np.sin(xx / 7.0)])
    if not smooth:
        scene = scene + 0.3 * rng.random(scene.shape)
    sel = np.asarray(pattern6).reshape(6, 6)[yy % 6, xx % 6]
    return np.take_along_axis(scene, sel[None], 0)[0].astype(np.float32)


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("smooth", [True, False])
@pytest.mark.parametrize("hw", MARK_FRAMES)
def test_markesteijn_kernel_matches_plain(cuda, hw, smooth, passes):
    x = torch.from_numpy(_mosaic(*hw, hw[0] + passes, smooth)).to(cuda)
    before = markesteijn.LAUNCHES
    got = markesteijn.xtrans_markesteijn(x, configs.XTRANS6, passes)
    assert markesteijn.LAUNCHES == before + 1
    want = markesteijn.xtrans_markesteijn_reference(x, configs.XTRANS6,
                                                    passes)
    torch.cuda.synchronize()
    assert got.shape == (3, *hw)
    assert torch.equal(got, want)


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("shift", [(1, 1), (2, 3), (3, 5), (4, 2), (5, 4),
                                   (0, 1), (1, 0)])
def test_markesteijn_kernel_every_phase(cuda, shift, passes):
    pattern6 = _shifted(*shift)
    x = torch.from_numpy(_mosaic(70, 101, sum(shift), False, pattern6)
                         ).to(cuda)
    got = markesteijn.xtrans_markesteijn(x, pattern6, passes)
    want = markesteijn.xtrans_markesteijn_reference(x, pattern6, passes)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("passes", [1, 3])
def test_markesteijn_kernel_propagates_nan_like_plain(cuda, passes):
    x = torch.from_numpy(_mosaic(70, 45, 3, False))
    x[10, 20] = x[40, 33] = float("nan")
    x = x.to(cuda)
    got = markesteijn.xtrans_markesteijn(x, configs.XTRANS6, passes)
    want = markesteijn.xtrans_markesteijn_reference(x, configs.XTRANS6,
                                                    passes)
    torch.cuda.synchronize()
    assert torch.isnan(want).any()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(got.nan_to_num(7.0), want.nan_to_num(7.0))


def test_markesteijn_kernel_refuses_bad_input(cuda):
    x = torch.zeros((12, 12), device=cuda)
    with pytest.raises(ValueError):
        markesteijn.xtrans_markesteijn(x, configs.XTRANS6, passes=2)
    with pytest.raises(ValueError):
        markesteijn.xtrans_markesteijn(x.double(), configs.XTRANS6)
    with pytest.raises(ValueError):
        markesteijn.xtrans_markesteijn(x, (3,) * 36)


def _lens_consts(model, tca, device):
    c = {"a": -0.02 if model != warp.DIST_POLY3 else 0.03, "b": 0.01,
         "c": -0.005, "scale": 0.98,
         "tca_r": [1.0005, 2e-4, -1e-4] if tca else [1.0, 0.0, 0.0],
         "tca_b": [0.9995, -2e-4, 1e-4] if tca else [1.0, 0.0, 0.0]}
    return warp.pack_consts({k: torch.tensor(v, dtype=torch.float32,
                                             device=device)
                             for k, v in c.items()})


@pytest.mark.parametrize("tca", [True, False])
@pytest.mark.parametrize("model", [warp.DIST_NONE, warp.DIST_POLY3,
                                   warp.DIST_PTLENS, warp.DIST_POLY5])
@pytest.mark.parametrize("hw", [(2, 3), (136, 400), (1000, 1504)])
def test_warp_kernel_matches_plain(cuda, hw, model, tca):
    h, w = hw
    rng = np.random.default_rng(h + model)
    x = torch.from_numpy(rng.uniform(0, 1, (3, h, w)).astype(np.float32)
                         ).to(cuda)
    k = _lens_consts(model, tca, cuda)
    flags = warp.MODIFY_DISTORTION | (warp.MODIFY_TCA if tca else 0)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    rn = float(np.hypot(cy, cx))
    before = warp.LAUNCHES
    got = warp.lens_warp(x, k, model, flags, cy, cx, rn)
    assert warp.LAUNCHES == before + 1
    want = warp.lens_warp_reference(x, k, model, flags, cy, cx, rn)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= STENCIL_TOL


def test_lens_vignetting_on_cuda_matches_cpu(cuda):
    raw, meta, scene = synth_raw(h=96, w=288, kind="gradients")
    raw, meta = configs.remosaic_xtrans(meta, scene)
    hist = [port.HistoryItem("lens", {"dist_a": -0.02, "tca_r": 1.0005,
                                      "tca_b": 0.9995, "vig_k1": -0.3,
                                      "vig_k2": 0.1, "vig_k3": -0.02})]
    got = port.compile_pipeline(meta, hist).output_array(raw)
    want = port.compile_pipeline(meta, hist, device="cpu").output_array(raw)
    assert np.abs(got - want).max() <= 1.0 / 255.0


def test_config4_pipe_on_cuda_matches_cpu(cuda):
    raw, meta, scene = synth_raw(h=96, w=288, kind="gradients")
    raw, meta = configs.remosaic_xtrans(meta, scene)
    hist = configs.history(4)
    on_card = port.compile_pipeline(meta, hist)
    mods = (rcd, pw, markesteijn, warp, sepblur, eaw, nlm, iir, diffuse)
    for mod in mods:
        mod.LAUNCHES = 0
    got = on_card.output_array(raw)
    assert [m.LAUNCHES for m in mods] == [0, 1, 1, 1, 0, 0, 0, 0, 0]
    want = port.compile_pipeline(meta, hist, device="cpu").output_array(raw)
    assert np.abs(got - want).max() <= 1.0 / 255.0


def _grid_case(D, C, ss, seed):
    """A random (D, C, gh, gw) grid and its z over a ragged frame near
    137 x 401 (no multiple of the kernel's 8 x 32 block), with z exactly
    at 0, at D - 1 and at integers in places."""
    gh, gw = 137 // ss + 1, 401 // ss + 1
    rng = np.random.default_rng(seed)
    G = (rng.random((D, C, gh, gw)) * 2.0 - 0.5).astype(np.float32)
    z = (rng.random((gh * ss, gw * ss)) * (D - 1)).astype(np.float32)
    z[0, :5], z[1, :5] = 0.0, D - 1
    z[2, :9] = np.arange(9) % D
    return G, z


@pytest.mark.parametrize("D", [4, 6, 32])
@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("ss", [1, 10, 15, 50, 100])
def test_bgrid_kernel_matches_plain(cuda, ss, C, D):
    G, z = _grid_case(D, C, ss, seed=ss * 100 + D * 3 + C)
    g, zz = torch.from_numpy(G).to(cuda), torch.from_numpy(z).to(cuda)
    before = bgrid.LAUNCHES
    got = bgrid.slice_grid(g, zz, ss)
    assert bgrid.LAUNCHES == before + 1
    want = bgrid.slice_grid_reference(g, zz, ss)
    torch.cuda.synchronize()
    assert got.shape == (C, G.shape[2] * ss, G.shape[3] * ss)
    # the same float32 operations in the same order: bit for bit
    assert torch.equal(got, want)


# (D, C, ss, frame near): a tile of 64 rows straddling grid rows at ss 15
# and 17 (17: the matrix taps), ss 1 at (32, 3) and (32, 1) (the direct
# path), ss 3 at (32, 1) (a 16-row tile), ss 4 at (32, 3) (direct) and
# (32, 1) (a 32-row tile), ss 100 with three channels; no frame is a
# multiple of the 128-column tile
BGRID_EDGE_CASES = [(32, 1, 15, (200, 300)), (32, 1, 17, (150, 270)),
                    (32, 3, 1, (70, 150)), (32, 1, 1, (90, 260)),
                    (32, 1, 3, (100, 390)), (32, 3, 4, (80, 200)),
                    (32, 1, 4, (100, 130)), (4, 3, 100, (200, 300)),
                    (6, 1, 50, (150, 450)), (4, 3, 10, (70, 135))]


@pytest.mark.parametrize("D,C,ss,hw", BGRID_EDGE_CASES)
def test_bgrid_kernel_edge_values_match_plain(cuda, D, C, ss, hw):
    """z below 0, above D - 1, exactly D - 1 and at the integers, NaN and
    +-inf; inf and NaN in the grid; every tile plan."""
    gh, gw = -(-hw[0] // ss), -(-hw[1] // ss)
    rng = np.random.default_rng(D * ss + C)
    G = (rng.random((D, C, gh, gw)) * 2.0 - 0.5).astype(np.float32)
    z = (rng.random((gh * ss, gw * ss)) * (D + 1) - 1.0).astype(np.float32)
    z[0, :5], z[1, :5] = 0.0, D - 1
    z[2, :9] = np.arange(9) % D
    z[3, :4] = [np.nan, np.inf, -np.inf, D - 1 + 1e-3]
    z[-1, -4:] = [-1e-3, D - 1, np.nan, D]
    G[0, 0, 0, 0], G[-1, -1, -1, -1] = np.inf, -np.inf
    G[D // 2, 0, gh // 2, gw // 2] = np.nan
    g, zz = torch.from_numpy(G).to(cuda), torch.from_numpy(z).to(cuda)
    plan = bgrid.slice_plan(D, C, gh, gw, ss)
    assert plan.smem <= bgrid.SLAB_BYTES
    got = bgrid.slice_grid(g, zz, ss)
    want = bgrid.slice_grid_reference(g, zz, ss)
    torch.cuda.synchronize()
    assert _same(got, want)


def test_bgrid_kernel_refuses_bad_input(cuda):
    g = torch.zeros((4, 1, 3, 5), device=cuda)
    z = torch.zeros((30, 50), device=cuda)
    bgrid.slice_grid(g, z, 10)
    with pytest.raises(ValueError):
        bgrid.slice_grid(g.double(), z, 10)
    with pytest.raises(ValueError):
        bgrid.slice_grid(g, z.double(), 10)
    with pytest.raises(ValueError):
        bgrid.slice_grid(g.transpose(2, 3).contiguous().transpose(2, 3), z,
                         10)
    with pytest.raises(ValueError):
        bgrid.slice_grid(g, torch.zeros((50, 30), device=cuda).t(), 10)
    with pytest.raises(ValueError):
        bgrid.slice_grid(g, z[:, :40], 10)
    with pytest.raises(ValueError):
        bgrid.slice_grid(g, z.cpu(), 10)


def test_config7_pipe_on_cuda_matches_cpu(cuda):
    raw, meta, _ = synth_raw(h=160, w=240, kind="gradients")
    hist = configs.history(7)
    on_card = port.compile_pipeline(meta, hist)
    mods = (rcd, pw, sepblur, bgrid, eaw, nlm, iir, diffuse, markesteijn,
            warp)
    for mod in mods:
        mod.LAUNCHES = 0
    got = on_card.output_array(raw)
    assert [m.LAUNCHES for m in mods] == [1, 3, 1, 5, 0, 0, 0, 0, 0, 0]
    want = port.compile_pipeline(meta, hist, device="cpu").output_array(raw)
    assert np.abs(got - want).max() <= 1.0 / 255.0


# the grid and blur-family ops off config 7's path: (op, params,
# input colorspace)
GRID_OPS = [
    ("lowpass", {}, "LAB"),
    ("lowpass", {"lowpass_algo": 1, "radius": 30.0}, "LAB"),
    ("shadhi", {}, "LAB"),
    ("sharpen", {"radius": 12.0}, "LAB"),
    ("highpass", {}, "LAB"),
    ("monochrome", {"a": 10.0, "size": 0.5}, "LAB"),
    ("colorreconstruct", {"threshold": 60.0, "precedence": 2}, "LAB"),
    ("soften", {}, "WORK_RGB"),
    ("bilat", {"mode": 0, "sigma_s": 8.0, "sigma_r": 10.0}, "LAB"),
]


@pytest.mark.parametrize("name,params,cs", GRID_OPS,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(GRID_OPS)])
def test_grid_and_blur_ops_on_cuda_match_cpu(cuda, name, params, cs):
    """Each op on the card (through the sepblur, IIR and grid kernels)
    against the same op on the CPU (their twins)."""
    from ansel_tpu_torch.ops.base import PlanContext, get_op

    h, w = 400, 600
    rng = np.random.default_rng(3)
    if cs == "LAB":
        x = np.stack([rng.uniform(0, 100, (h, w)),
                      rng.uniform(-40, 40, (h, w)),
                      rng.uniform(-40, 40, (h, w))]).astype(np.float32)
    else:
        x = rng.uniform(0, 1, (3, h, w)).astype(np.float32)
    op = get_op(name)
    p = params_class(name)(**params)
    ctx = PlanContext(meta=RawMeta(width=w, height=h))
    plan = op.plan(ctx, ImageSpec(width=w, height=h,
                                  colorspace=getattr(Colorspace, cs)), p)
    co = op.coeffs(ctx, plan, p)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        c = engine.coeffs_to_device([co], dev)[0]
        outs.append(op.apply(torch.from_numpy(x).to(dev), c, plan, ctx).cpu())
    torch.cuda.synchronize()
    scale = max(1.0, outs[1].abs().max().item())
    assert (outs[0] - outs[1]).abs().max().item() <= 1e-4 * scale


# --- config 8: rawdenoise, cacorrectrgb, nlmeans and the export ---------

HAT = (0.25, 0.5, 0.25)


@pytest.mark.parametrize("hw", [(37, 530), (500, 752), (2000, 3008)])
@pytest.mark.parametrize("d", [1, 2, 4, 8, 16])
def test_sepblur_kernel_on_rawdenoise_planes(cuda, hw, d):
    """rawdenoise's hat wavelet on the four CFA planes at its dilations
    (d = 16 reaches 16 rows a tap), config 8's (2000, 3008) among them."""
    gen = torch.Generator(device="cuda").manual_seed(d)
    x = torch.rand((4,) + hw, generator=gen, device="cuda")
    before = sepblur.LAUNCHES
    got = sepblur.sep_blur(x, HAT, d)
    assert sepblur.LAUNCHES == before + 1
    want = sepblur.sep_blur_reference(x, HAT, d)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(4000, 6016), (4, 4000, 6016), (37, 53),
                                   (4, 37, 54)])
def test_iir_kernel_on_cacorrectrgb_shapes(cuda, shape):
    """cacorrectrgb's sigma-5 Gaussian on a 2-D plane and on its four-plane
    stacks at 24 MP (w % 4 = 0: the 16-byte copies), and at widths that
    take the 4-byte ones."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.rand(shape, generator=gen, device="cuda") * 2.0
    coef = _deriche_coeffs(5.0)
    before = iir.LAUNCHES
    got = iir.gaussian_iir(x, coef)
    assert iir.LAUNCHES == before + 1
    want = iir.gaussian_iir_reference(x, coef)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("hw", [(5, 7), (136, 400), (1000, 1504)])
def test_nlm_kernel_on_the_nlmeans_op_call(cuda, hw):
    """The nlmeans op's call: variant 0, P 2, K 7, its Lab weights, on
    Lab-scaled values."""
    from ansel_tpu_torch.ops.nlmeans import _NORM32

    gen = torch.Generator(device="cuda").manual_seed(2)
    v = torch.rand((3,) + hw, generator=gen, device="cuda")
    v = v * torch.tensor([100.0, 80.0, 80.0], device="cuda")[:, None, None] \
        - torch.tensor([0.0, 40.0, 40.0], device="cuda")[:, None, None]
    args = (search_offsets(7), 2, _NORM32, 3000.0 / 51.0, 0.0, 1.0, 0)
    before = nlm.LAUNCHES
    got = nlm.nlm(v.contiguous(), *args)
    assert nlm.LAUNCHES == before + 1
    want = nlm.nlm_reference(v, *args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# the ops of config 8 on the card (through sepblur, the IIR and NLM where
# they use them) against the same ops on the CPU: (op, params, input)
CONFIG8_OPS = [
    ("hotpixels", {}, "RAW"),
    ("rawdenoise", {"threshold": 0.02}, "RAW"),
    ("cacorrect", {}, "RAW"),
    ("cacorrectrgb", {}, "CAMERA_RGB"),
    ("nlmeans", {}, "LAB"),
    ("defringe", {}, "LAB"),
    ("defringe", {"op_mode": 1}, "LAB"),
    ("bloom", {"threshold": 60.0}, "LAB"),
]


@pytest.mark.parametrize("name,params,cs", CONFIG8_OPS,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(CONFIG8_OPS)])
def test_config8_ops_on_cuda_match_cpu(cuda, name, params, cs):
    from ansel_tpu_torch.ops.base import PlanContext, get_op

    h, w = 400, 600
    rng = np.random.default_rng(8)
    if cs == "LAB":
        x = np.stack([rng.uniform(0, 100, (h, w)),
                      rng.uniform(-40, 40, (h, w)),
                      rng.uniform(-40, 40, (h, w))]).astype(np.float32)
    elif cs == "RAW":
        x = rng.uniform(0.05, 0.9, (h, w)).astype(np.float32)
    else:
        x = rng.uniform(0, 1, (3, h, w)).astype(np.float32)
    raw = cs == "RAW"
    op = get_op(name)
    p = params_class(name)(**params)
    ctx = PlanContext(meta=RawMeta(width=w, height=h))
    spec = ImageSpec(width=w, height=h, colorspace=getattr(Colorspace, cs),
                     channels=1 if raw else 3,
                     cfa=CFAPattern.RGGB if raw else None)
    plan = op.plan(ctx, spec, p)
    co = op.coeffs(ctx, plan, p)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        c = engine.coeffs_to_device([co], dev)[0]
        outs.append(op.apply(torch.from_numpy(x).to(dev), c, plan, ctx).cpu())
    torch.cuda.synchronize()
    scale = max(1.0, outs[1].abs().max().item())
    assert torch.isfinite(outs[0]).all()
    assert (outs[0] - outs[1]).abs().max().item() <= 1e-4 * scale


def test_config8_export_on_cuda_matches_cpu(cuda, tmp_path):
    """Config 8 from a sidecar with inactive blend blobs, through
    export_image on the card (launches pinned) and on the CPU."""
    from ansel_tpu_torch.io.xmp import XMPDocument, write_xmp
    from ansel_tpu_torch.pipeline.blend import BlendParams
    from ansel_tpu_torch.pipeline.export import export_image

    xmp = str(tmp_path / "config8.xmp")
    write_xmp(xmp, XMPDocument(history=[
        port.HistoryItem(op, dict(p), blend_params=BlendParams())
        for op, p in configs.HISTORIES[8]]))
    raw, meta, _ = synth_raw(h=256, w=384, kind="gradients")
    mods = (rcd, pw, sepblur, iir, nlm, eaw, diffuse, markesteijn, warp,
            bgrid)
    for mod in mods:
        mod.LAUNCHES = 0
    got = export_image(raw, meta, xmp_path=xmp)
    assert [m.LAUNCHES for m in mods] == [1, 3, 6, 7, 1, 0, 0, 0, 0, 0]
    want = export_image(raw, meta, xmp_path=xmp, device="cpu")
    assert got.shape == (3, 256, 384) and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1.0 / 255.0


def test_debug_perf_launches_the_chain_kernel_for_each_pixel_stage(cuda):
    """`-d perf` (`profiling.run_stages`) on config 1 schedules each
    stage as the export does: one chain-kernel launch for each per-pixel
    stage in each of its two calls (the warm-up and the timed one), and
    RCD once a call."""
    from ansel_tpu_torch.pipeline import profiling

    raw, meta, _ = synth_raw(h=256, w=384)
    pipe = engine.Pipeline(meta, configs.history(1))
    n = sum(pipe._chain_spec(s) is not None for s in pipe.stages)
    pw.LAUNCHES = rcd.LAUNCHES = 0
    reps = profiling.run_stages(pipe, raw, nan_scan=True, verbose=False)
    assert n >= 3
    assert pw.LAUNCHES == 2 * n and rcd.LAUNCHES == 2
    assert all(r.ms > 0 and r.nan == 0 and r.inf == 0 for r in reps)


# --- slice 11: clipping's map on the warp kernel, wide NLM lattices,
# config 9 -------------------------------------------------------------------

CLIP_CASES = {
    "rotate-crop": dict(configs.HISTORIES[9])["clipping"],
    "old-keystone": {"angle": -3.0, "cx": 0.1, "cw": 0.9, "k_type": 4,
                     "k_h": 0.1, "k_v": -0.05, "crop_auto": 0},
    "quad-keystone": {"angle": 1.0, "k_type": 0, "k_apply": 1, "kxa": 0.1,
                      "kya": 0.15, "kxb": 0.85, "kyb": 0.1, "kxc": 0.9,
                      "kyc": 0.9, "kxd": 0.15, "kyd": 0.85},
    "mirrored": {"angle": 4.0, "cw": -0.9, "ch": -0.8},
    # 45 degrees behind a strong quad keystone: some tiles' source boxes
    # overflow the warp's staging budget
    "rotate45-strong-keystone": {"angle": 45.0, "k_type": 0, "k_apply": 1,
                                 "kxa": 0.1, "kya": 0.1, "kxb": 0.9,
                                 "kyb": 0.4, "kxc": 0.9, "kyc": 0.6,
                                 "kxd": 0.1, "kyd": 0.9},
}


def _clip_args(case, h, w, org=(0, 0)):
    """(constants, k_apply, output shape) of clipping's map for a (h, w)
    frame, its input a window at `org` of RCD's output."""
    from ansel_tpu_torch.ops import clipping

    op = clipping.Clipping()
    p = dataclasses.replace(clipping.ClippingParams(), **CLIP_CASES[case])
    meta = RawMeta(width=w, height=h)
    full = ImageSpec(width=w, height=h, colorspace=Colorspace.CAMERA_RGB)
    plan = op.plan(engine.PlanContext(meta=meta), full, p)
    si = dataclasses.replace(full, org_y=org[0], org_x=org[1],
                             width=w - org[1], height=h - org[0], pad_w=0,
                             pad_h=0)
    so = plan.spec_out
    k, k_apply = clipping.clip_map(dict(plan.static), si, so)
    return torch.from_numpy(k), k_apply, (si.pad_h, si.pad_w), (so.pad_h,
                                                               so.pad_w)


@pytest.mark.parametrize("case", sorted(CLIP_CASES))
@pytest.mark.parametrize("hw,org", [((2, 3), (0, 0)), ((137, 401), (0, 0)),
                                    ((137, 401), (9, 27)),
                                    ((1000, 1504), (6, 24))])
def test_clip_warp_kernel_matches_plain(cuda, case, hw, org):
    """Clipping's map on odd frames and windowed inputs, bit for bit."""
    k, k_apply, (h, w), (oh, ow) = _clip_args(case, *hw, org)
    rng = np.random.default_rng(h + w)
    x = torch.from_numpy(rng.uniform(0, 1, (3, h, w)).astype(np.float32)
                         ).to(cuda)
    before = warp.LAUNCHES
    got = warp.clip_warp(x, k, k_apply, oh, ow)
    assert warp.LAUNCHES == before + 1
    want = warp.clip_warp_reference(x, k, k_apply, oh, ow)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (3, oh, ow)
    assert torch.equal(got, want)


def test_clip_warp_kernel_at_24_mp(cuda):
    """Config 9's map at its 4000 x 6016 frame."""
    k, k_apply, (h, w), (oh, ow) = _clip_args("rotate-crop", configs.BENCH_H,
                                              configs.BENCH_W)
    gen = torch.Generator(device=cuda).manual_seed(9)
    x = torch.rand((3, h, w), generator=gen, device=cuda)
    got = warp.clip_warp(x, k, k_apply, oh, ow)
    want = warp.clip_warp_reference(x, k, k_apply, oh, ow)
    assert torch.equal(got, want)
    assert (got == 0).float().mean().item() < 0.01


@pytest.mark.parametrize("hw", [(5, 7), (136, 400)])
@pytest.mark.parametrize("variant,P,K,launches", [
    (0, 1, 15, 2), (1, 1, 15, 2), (0, 2, 20, 2), (1, 2, 20, 2),
    (0, 9, 3, 1), (1, 9, 3, 1), (0, 12, 2, 1), (1, 12, 2, 1),
    (0, 97, 1, 1), (1, 130, 1, 1)])
def test_nlm_kernel_on_wide_lattices(cuda, hw, variant, P, K, launches):
    """Lattices past MAX_OFFSETS run in chunks carried in float32
    scratch, patch radii past MAX_P through the wide form, whose shared
    memory does not grow with P (97 and 130: past the 96 it used to
    take): bit for bit."""
    x = _noisy((3,) + hw, K, cuda)
    offs = search_offsets(K)
    if variant == 1:
        n = 2 * P + 1
        args = (torch.tensor(0.005, device=cuda), 0.1 * n * n, 1.0 / 1.1)
    else:
        args = (0.02, 0.0, 1.0)
    before = nlm.LAUNCHES
    got = nlm.nlm(x, offs, P, (1.0, 0.5, 0.7), *args, variant)
    assert nlm.LAUNCHES == before + launches
    want = nlm.nlm_reference(x, offs, P, (1.0, 0.5, 0.7), *args, variant)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


def test_config9_export_on_cuda_matches_cpu(cuda, tmp_path):
    """Config 9 at 160 x 240: a DNG with its GainMap, exported from its
    sidecar through the CLI on the card (launches pinned) and on the
    CPU."""
    from ansel_tpu_torch import cli
    from ansel_tpu_torch.io.encode import read_png16
    from ansel_tpu_torch.io.xmp import XMPDocument, write_xmp
    from ansel_tpu_torch.pipeline.blend import BlendParams
    from test_dng import opcode_list2_blob, write_dng

    h, w = 160, 240
    raw, _, _ = synth_raw(h=h, w=w, kind="gradients")
    mv, mh = configs.DNG9_MAP_POINTS
    blob = opcode_list2_blob(h, w, mv, mh, configs.gain_maps9())
    dng = str(tmp_path / "in.dng")
    write_dng(dng, configs.mosaic9(raw), black=256.0, white=16383.0,
              extra_tags=[(51009, 7, len(blob), blob)])
    xmp = str(tmp_path / "in.xmp")
    write_xmp(xmp, XMPDocument(history=[
        port.HistoryItem(op, dict(p), blend_params=BlendParams())
        for op, p in configs.HISTORIES[9]]))
    mods = (rcd, pw, warp, sepblur, iir, nlm, eaw, diffuse, markesteijn,
            bgrid)
    for mod in mods:
        mod.LAUNCHES = 0
    out = str(tmp_path / "card.png")
    assert cli.main([dng, xmp, out, "--bpp", "16", "--no-icc"]) == 0
    # no lens stage: the one warp launch is clipping's map
    launches = [m.LAUNCHES for m in mods]
    assert launches[0] == 1 and launches[1] >= 1 and launches[2] == 1
    assert launches[3:] == [0] * 7
    cpu = str(tmp_path / "cpu.png")
    assert cli.main([dng, xmp, cpu, "--bpp", "16", "--no-icc", "--device",
                     "cpu"]) == 0
    got, want = read_png16(out), read_png16(cpu)
    assert got.shape == want.shape
    assert np.abs(got.astype(np.int64) - want).max() / 65535.0 \
        <= 1.0 / 255.0


# --- the grading opcodes, config 10's chains and atrous -------------------

GRADING = [(name, kind, label, params)
           for name, kind, a, b in configs.GRADING_CASES
           for label, params in (("A", a), ("B", b))]


def _grading_input(kind, hw, cuda, seed=12):
    """Work RGB in [-0.05, 1.6] or Lab (L in [0, 100], a, b in +-80),
    some zeros."""
    rng = np.random.default_rng(seed)
    if kind == "lab":
        x = np.stack([rng.uniform(0.0, 100.0, hw), rng.uniform(-80, 80, hw),
                      rng.uniform(-80, 80, hw)])
    else:
        x = rng.uniform(-0.05, 1.6, (3,) + hw)
    x = x.astype(np.float32)
    x[:, 0, :3] = 0.0
    return torch.from_numpy(x).to(cuda)


@pytest.mark.parametrize("name,kind,label,params", GRADING,
                         ids=[f"{n}-{l}" for n, _, l, _ in GRADING])
def test_grading_opcode_matches_plain(cuda, name, kind, label, params):
    """Each opcode as a one-stage chain (the interpreter: no specialised
    program holds one), on a frame of whole tiles and an odd one, against
    its plain twin; both bounds scale with the output's largest magnitude
    (Lab outputs reach 100 and more), as chip_smoke.py's do."""
    meta = synth_raw(h=16, w=16)[1]
    for hw in [(64, 256), (5, 7)]:
        x = _grading_input(kind, hw, cuda)
        chain = configs.opcode_chain(meta, name, params, x.shape, cuda)
        assert chain.fixed == -1
        before = pw.LAUNCHES
        got = pw.pointwise_chain(x, chain)
        assert pw.LAUNCHES == before + 1
        want = pw.pointwise_chain_reference(x, chain)
        torch.cuda.synchronize()
        assert torch.isfinite(want).all() and torch.isfinite(got).all()
        assert (want - x).abs().max().item() > 1e-3
        scale = max(1.0, want.abs().max().item())
        d = (got - want).abs()
        assert d.max().item() <= CHAIN_MAX_TOL * scale, (d.max().item(), scale)
        assert d.mean().item() <= CHAIN_MEAN_TOL * scale, \
            (d.mean().item(), scale)


def _config10_calls(cuda, h=144, w=400):
    """Config 10 on the card at h x w: (pipe, output, the chain calls'
    (x, chain), the atrous EAW calls' (x, scale, sharpen), launches)."""
    raw, meta, _ = synth_raw(h=h, w=w, kind="gradients")
    pipe = port.compile_pipeline(meta, configs.history(10), device=cuda)
    calls = {"chain": [], "eaw": []}
    real_chain, real_eaw = pw.pointwise_chain, eaw.eaw_atrous_coarse

    def ch(x, c):
        calls["chain"].append((x, c))
        return real_chain(x, c)

    def ew(x, s, k):
        calls["eaw"].append((x, s, k))
        return real_eaw(x, s, k)

    pw.pointwise_chain, eaw.eaw_atrous_coarse = ch, ew
    rcd.LAUNCHES = pw.LAUNCHES = eaw.LAUNCHES = 0
    try:
        out = pipe.output_array(raw)
    finally:
        pw.pointwise_chain, eaw.eaw_atrous_coarse = real_chain, real_eaw
    launches = (rcd.LAUNCHES, pw.LAUNCHES, eaw.LAUNCHES)
    return pipe, out, raw, meta, calls, launches


def test_config10_chains_on_cuda(cuda):
    """Config 10's two chains run their specialised programs (with_pos in
    both: graduatednd in the first, vignette in the second), equal to the
    interpreter bit for bit and to the plain twins within the chain's
    tolerance; the pipe launches RCD once, the chain twice and the atrous
    EAW once a scale, and matches the CPU run within a display code."""
    pipe, out, raw, meta, calls, launches = _config10_calls(cuda)
    scales = [s for s in pipe.pipe.stages if s.name == "atrous"][0].plan.static
    assert launches == (1, 2, scales)
    assert len(calls["chain"]) == 2
    for x, chain in calls["chain"]:
        assert chain.fixed >= 0
        got = pw.pointwise_chain(x, chain)
        interpreted = pw.pointwise_chain(x, dataclasses.replace(chain,
                                                                fixed=-1))
        want = pw.pointwise_chain_reference(x, chain)
        torch.cuda.synchronize()
        assert torch.equal(got, interpreted)
        scale = max(1.0, want.abs().max().item())
        d = (got - want).abs()
        assert d.max().item() <= CHAIN_MAX_TOL * scale, (d.max().item(), scale)
        assert d.mean().item() <= CHAIN_MEAN_TOL * scale
    want = port.compile_pipeline(meta, configs.history(10),
                                 device="cpu").output_array(raw)
    assert np.abs(out - want).max() <= 1.0 / 255.0


def test_atrous_kernel_on_config10_arguments(cuda):
    """The EAW kernel's atrous variant on each scale config 10's atrous
    hands it (Lab, sharpen 0.00125), at 144 x 400, and at the 24 MP
    frame's shape on a Lab ramp with edges for the first three scales."""
    _, _, _, _, calls, _ = _config10_calls(cuda)
    assert calls["eaw"]
    rng = np.random.default_rng(4)
    big = np.stack([np.linspace(0, 100, 6016, dtype=np.float32)[None]
                    .repeat(4000, 0),
                    (40 * rng.standard_normal((4000, 6016))).astype(np.float32),
                    np.zeros((4000, 6016), np.float32)])
    big[:, 1000:2000, 2000:4000] += 20.0
    big = torch.from_numpy(big).to(cuda)
    cases = [(x, s, k) for x, s, k in calls["eaw"]] + [
        (big, s, calls["eaw"][0][2]) for s in range(3)]
    for x, s, k in cases:
        got = eaw.eaw_atrous_coarse(x, s, k)
        want = eaw.eaw_coarse_reference(x, s, k, eaw.ATROUS)
        torch.cuda.synchronize()
        for g, w_ in zip(got, want):
            assert (g - w_).abs().max().item() <= STENCIL_TOL * max(
                1.0, w_.abs().max().item())


# --- the legacy opcodes, config 11's chain, ashift's and liquify's maps ----

LEGACY = [(name, kind, i, params)
          for name, kind, sets in configs.LEGACY_CASES
          for i, params in enumerate(sets)
          if not (name == "colorchecker" and params["num_patches"] > 12)]
LEGACY_SPACE = {"lab": Colorspace.LAB, "rgb": Colorspace.WORK_RGB,
                "camera": Colorspace.CAMERA_RGB}


@pytest.mark.parametrize("name,kind,i,params", LEGACY,
                         ids=[f"{n}-{i}" for n, _, i, _ in LEGACY])
def test_legacy_opcode_matches_plain(cuda, name, kind, i, params):
    """Each legacy opcode (19-30) as a one-stage chain (the interpreter),
    on a frame of whole tiles and an odd one, against its plain twin, the
    bounds scaled as in test_grading_opcode_matches_plain."""
    meta = synth_raw(h=16, w=16)[1]
    for hw in [(64, 256), (5, 7)]:
        x = _grading_input("lab" if kind == "lab" else "rgb", hw, cuda)
        chain = configs.opcode_chain(meta, name, params, x.shape, cuda,
                                     LEGACY_SPACE[kind])
        assert chain.fixed == -1
        before = pw.LAUNCHES
        got = pw.pointwise_chain(x, chain)
        assert pw.LAUNCHES == before + 1
        want = pw.pointwise_chain_reference(x, chain)
        torch.cuda.synchronize()
        assert torch.isfinite(want).all() and torch.isfinite(got).all()
        # splittoningrgb with coinciding keys moves only the pixels within
        # 1e-4 of its key, which a 5 x 7 frame may miss
        if hw != (5, 7):
            assert (want - x).abs().max().item() > 1e-3
        scale = max(1.0, want.abs().max().item())
        d = (got - want).abs()
        assert d.max().item() <= CHAIN_MAX_TOL * scale, (d.max().item(), scale)
        assert d.mean().item() <= CHAIN_MEAN_TOL * scale, \
            (d.mean().item(), scale)


def _config11(h, w):
    """Config 11's history with liquify's path scaled to an h x w frame."""
    return [port.HistoryItem(op, {"nodes": configs.liquify_nodes(h, w)}
                             if op == "liquify" else dict(p))
            for op, p in configs.HISTORIES[11]]


def test_config11_on_cuda(cuda):
    """Config 11 at 144 x 400: RCD once, the warp twice (ashift's
    homography, liquify over its window; each map's count), the chain
    once through its specialised program (that program's count), equal
    to the interpreter bit for bit and to the twins within the chain's
    tolerance; the pipe matches the CPU run within a display code."""
    h, w = 144, 400
    raw, meta, _ = synth_raw(h=h, w=w, kind="gradients")
    pipe = port.compile_pipeline(meta, _config11(h, w), device=cuda)
    calls, real = [], pw.pointwise_chain
    pw.pointwise_chain = lambda x, c: calls.append((x, c)) or real(x, c)
    rcd.LAUNCHES = pw.LAUNCHES = warp.LAUNCHES = 0
    warp.MAP_LAUNCHES.clear()
    pw.PROGRAM_LAUNCHES.clear()
    try:
        out = pipe.output_array(raw)
    finally:
        pw.pointwise_chain = real
    assert (rcd.LAUNCHES, warp.LAUNCHES, pw.LAUNCHES) == (1, 2, 1)
    assert warp.MAP_LAUNCHES == {"homography": 1, "liquify": 1}
    (x, chain), = calls
    assert pw.PROGRAM_LAUNCHES == {chain.fixed: 1}
    records = chain.prog.view(-1, pw.RECORD)[:, :2].tolist()
    assert chain.fixed >= 0
    assert pw.FIXED[chain.fixed] == tuple(map(tuple, records))
    got = pw.pointwise_chain(x, chain)
    interpreted = pw.pointwise_chain(x, dataclasses.replace(chain, fixed=-1))
    want = pw.pointwise_chain_reference(x, chain)
    torch.cuda.synchronize()
    assert torch.equal(got, interpreted)
    d = (got - want).abs()
    assert d.max().item() <= CHAIN_MAX_TOL and d.mean().item() <= CHAIN_MEAN_TOL
    want = port.compile_pipeline(meta, _config11(h, w),
                                 device="cpu").output_array(raw)
    assert np.abs(out - want).max() <= 1.0 / 255.0


def _ashift_consts(params, h, w):
    from ansel_tpu_torch.ops.ashift import homography_consts

    op = port.ops.base.get_op("ashift")
    p = dataclasses.replace(op.default_params(None), **params)
    spec = ImageSpec(width=w, height=h, colorspace=Colorspace.CAMERA_RGB)
    plan = op.plan(port.ops.base.PlanContext(meta=None), spec, p)
    return torch.from_numpy(homography_consts(plan.static[0]))


ASHIFT_PARAMS = [dict(configs.HISTORIES[11][3][1]),
                 {"rotation": -2.0, "lensshift_h": -0.3, "shear": 0.05,
                  "aspect": 1.1, "orthocorr": 50.0}]


@pytest.mark.parametrize("hw", [(2, 3), (137, 401), (1000, 1504)])
@pytest.mark.parametrize("case", [0, 1])
def test_homography_warp_kernel_matches_plain(cuda, hw, case):
    """ashift's map on ragged frames, bit for bit (its twin's float32
    operations in the same order, true divisions, no transcendental)."""
    h, w = hw
    k = _ashift_consts(ASHIFT_PARAMS[case], h, w)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.uniform(size=(3, h, w)).astype(np.float32)
                         ).to(cuda)
    before = warp.LAUNCHES
    got = warp.homography_warp(x, k)
    assert warp.LAUNCHES == before + 1
    want = warp.homography_warp_reference(x, k)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _stamps(blob, cuda):
    from ansel_tpu_torch.ops import liquify

    c = liquify.Liquify()._warp_arrays(liquify.LiquifyParams(blob))
    return warp.pack_stamps({k: torch.from_numpy(np.asarray(v)).to(cuda)
                             for k, v in c.items()})


def _long_path(h, w):
    """A brush path of radius 12 px across the frame's width, two curved
    segments: some 750 stamps, three chunks of the kernel's shared
    buffer."""
    pts = [complex(0.05 * w, 0.5 * h), complex(0.5 * w, 0.4 * h),
           complex(0.95 * w, 0.55 * h)]
    blob = b""
    for k, pt in enumerate(pts):
        d = pt - pts[k - 1] if k else 0j
        blob += configs.liquify_node(
            configs.PATH_CURVE if k else configs.PATH_MOVE, k - 1,
            k + 1 if k < 2 else -1, pt, pt + 6j, pt + 12.0,
            configs.WARP_LINEAR,
            ctrl1=pt - d + d / 3.0 + 0.2j * d, ctrl2=pt - d / 3.0)
    return blob + b"\0" * (76 * configs.LIQUIFY_NODES - len(blob))


@pytest.mark.parametrize("hw,win,path", [
    ((96, 160), None, "config11"), ((137, 401), None, "config11"),
    ((600, 1000), None, "config11"), ((600, 1000), (5, 597, 3, 998),
                                      "config11"),
    ((600, 1000), None, "long")])
def test_liquify_warp_kernel_matches_plain(cuda, hw, win, path):
    """liquify's warp with config 11's path scaled to the frame (112
    stamps) and a long thin path (over 512 stamps: three chunks of the
    kernel's shared buffer), over the plan's window and a ragged one; bit
    for bit, and outside the window the input."""
    from ansel_tpu_torch.ops import liquify

    h, w = hw
    blob = (configs.liquify_nodes(h, w) if path == "config11"
            else _long_path(h, w))
    stamps = _stamps(blob, cuda)
    assert stamps.shape[0] > (512 if path == "long" else 100)
    if win is None:
        spec = ImageSpec(width=w, height=h, colorspace=Colorspace.CAMERA_RGB)
        plan = liquify.Liquify().plan(port.ops.base.PlanContext(meta=None),
                                      spec, liquify.LiquifyParams(blob))
        win = plan.static[4]
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.uniform(size=(3, h, w)).astype(np.float32)
                         ).to(cuda)
    before = warp.LAUNCHES
    got = warp.liquify_warp(x, stamps, win)
    assert warp.LAUNCHES == before + 1
    want = warp.liquify_warp_reference(x, stamps, win)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    y0, y1, x0, x1 = win
    mask = torch.ones((h, w), dtype=torch.bool, device=cuda)
    mask[y0:y1, x0:x1] = False
    assert torch.equal(got[:, mask], x[:, mask])
    assert (got - x).abs().max().item() > 1e-3


def test_warp_kernels_refuse_bad_input(cuda):
    x = torch.zeros((3, 8, 8), device=cuda)
    k = torch.zeros(8)
    with pytest.raises(ValueError):
        warp.homography_warp(x, k)
    stamps = torch.zeros((1, warp.STAMP), device=cuda)
    with pytest.raises(ValueError):
        warp.liquify_warp(x, stamps, (0, 9, 0, 8))
    with pytest.raises(ValueError):
        warp.liquify_warp(x, stamps.cpu(), (0, 8, 0, 8))


def test_prng_bits_on_cuda_equal_the_cpu(cuda):
    """JAX's generator on the card: the same keys and splits (hashed as
    tensors there), and the same bits, uniforms and ints as on the CPU
    (the int64 words are exact on both); the normal draw through erf_inv's
    log1p and sqrt within an ulp or two of values up to ~5."""
    from ansel_tpu_torch.pixel import prng

    key = prng.PRNGKey(0x5EED)
    assert prng.split(key, 30, device=cuda) == prng.split(key, 30)
    for shape in [(3, 137, 401), (1000, 1504)]:
        for fn in (prng.random_bits, prng.uniform):
            got = fn(key, shape, device=cuda).cpu()
            assert torch.equal(got, fn(key, shape))
        got = prng.uniform(key, shape, -0.5, 0.5, device=cuda).cpu()
        assert torch.equal(got, prng.uniform(key, shape, -0.5, 0.5))
        got = prng.randint(key, shape, 0, 4, device=cuda).cpu()
        assert torch.equal(got, prng.randint(key, shape, 0, 4))
        got = prng.normal(key, shape, device=cuda).cpu()
        want = prng.normal(key, shape)
        assert (got - want).abs().max().item() <= 1e-6


def _twins(monkeypatch):
    """Compose the plain twins: each kernel wrapper the config-12 pipe
    calls swapped for its plain version."""
    monkeypatch.setattr(rcd, "rcd_demosaic", rcd.rcd_demosaic_reference)
    monkeypatch.setattr(pw, "pointwise_chain", pw.pointwise_chain_reference)
    monkeypatch.setattr(sepblur, "sep_blur", sepblur.sep_blur_reference)


def test_config12_on_cuda(cuda, monkeypatch):
    """Config 12 at 144 x 400 on the card: RCD once, the chain four times
    (three chains and filmicrgb's AgX after its reconstruction, each its
    own program), sepblur 2 x 5 scales x 2 passes for the reconstruction
    and 3 for grain's box means; the output in [0, 1] and within a
    display code of the same pipe with every kernel's twin (the CPU is no
    yardstick here: hazeremoval's guided filter cancels on this frame,
    ROADMAP R12, so the card's and the CPU's cumulative sums part)."""
    h, w = 144, 400
    raw, meta, _ = synth_raw(h=h, w=w, kind="gradients")
    pipe = port.compile_pipeline(meta, configs.history(12), device=cuda)
    scales = pipe.pipe.stages[7].plan.static[5][0]
    assert pipe.pipe.stages[7].plan.static[5] == (5, 1)
    rcd.LAUNCHES = pw.LAUNCHES = sepblur.LAUNCHES = 0
    pw.PROGRAM_LAUNCHES.clear()
    out = pipe.output_array(raw)
    assert (rcd.LAUNCHES, pw.LAUNCHES, sepblur.LAUNCHES) == (
        1, 4, 4 * scales + 3)
    assert len(pw.PROGRAM_LAUNCHES) == 4 and -1 not in pw.PROGRAM_LAUNCHES
    assert np.isfinite(out).all() and out.min() >= 0.0 and out.max() <= 1.0
    _twins(monkeypatch)
    want = pipe.output_array(raw)
    assert np.abs(out - want).max() <= 1.0 / 255.0


def test_sepblur_kernel_on_hr_arguments(cuda):
    """filmicrgb's reconstruction hands sepblur (3, H, W) planes at
    dilations 1 to 2^(scales - 1); from 256 the kernel takes its two-pass
    form.  Bit-equal to the twin on a (3, 1000, 1504) frame of the
    reconstruction's own input."""
    x = torch.rand((3, 1000, 1504), device=cuda) * 3.0
    for d in (1, 2, 8, 64, 128, 256):
        got = sepblur.sep_blur(x, B3, d)
        want = sepblur.sep_blur_reference(x, B3, d)
        torch.cuda.synchronize()
        assert torch.equal(got, want), d


def test_config14_on_cuda_matches_cpu(cuda):
    """Config 14 at 192 x 288 on the card (RCD, its three chains, each its
    own program; the ICC profiles, LUTs and layer in torch) against the
    same pipe on the CPU, which runs every twin."""
    raw, meta, _ = synth_raw(h=192, w=288, kind="gradients")
    with configs.history_files(14) as hist:
        on_card = port.compile_pipeline(meta, hist, device=cuda)
        on_cpu = port.compile_pipeline(meta, hist, device="cpu")
    rcd.LAUNCHES = pw.LAUNCHES = 0
    pw.PROGRAM_LAUNCHES.clear()
    got = on_card.output_array(raw)
    assert (rcd.LAUNCHES, pw.LAUNCHES) == (1, 3)
    assert dict(pw.PROGRAM_LAUNCHES) == {2: 1, 17: 1, 12: 1}
    d = np.abs(got - on_cpu.output_array(raw))
    assert d.max() <= 1.0 / 255.0 and d.mean() <= 1e-5


@pytest.mark.parametrize("pipe_type,method,scale", [
    ("preview", None, 1.0), ("thumbnail", 7, 0.25)])
def test_fast_pipes_on_cuda_match_cpu(cuda, pipe_type, method, scale):
    """Config 1 in the PREVIEW pipe (a demosaic dict: PPG) and the
    THUMBNAIL pipe at scale 0.25 (a method-7 blob: bilinear): the chain
    once, in config 1's program, no RCD; against the CPU."""
    raw, meta, _ = synth_raw(h=192, w=288, kind="gradients")
    cls = params_class("demosaic")
    item = (port.HistoryItem("demosaic", {}) if method is None else
            port.HistoryItem("demosaic", cls.codec.encode(
                cls(demosaicing_method=method)), version=cls.op_version))
    hist = configs.history(1) + [item]
    kw = dict(pipe_type=pipe_type, scale=scale)
    on_card = port.compile_pipeline(meta, hist, device=cuda, **kw)
    rcd.LAUNCHES = pw.LAUNCHES = 0
    pw.PROGRAM_LAUNCHES.clear()
    got = on_card.output_array(raw)
    assert (rcd.LAUNCHES, pw.LAUNCHES) == (0, 1)
    assert dict(pw.PROGRAM_LAUNCHES) == {0: 1}
    want = port.compile_pipeline(meta, hist, device="cpu",
                                 **kw).output_array(raw)
    d = np.abs(got - want)
    assert d.max() <= 1.0 / 255.0 and d.mean() <= 1e-5


def test_config15_on_cuda_matches_its_twins(cuda, monkeypatch):
    """Config 15 at 128 x 256 on the card (the guided Laplacian's 360
    blurs, RCD under the dual blend, config 1's chain program; the dome
    core, VNG4 and the post passes in torch) against the same pipe on the
    card with each wrapper's plain twin: the Laplacian's 30 iterations
    amplify an ulp on this frame (ROADMAP R15), so the CPU's rounding is
    no yardstick for the whole pipe."""
    raw, meta, _ = synth_raw(h=128, w=256, kind="gradients")
    raw = configs.mosaic15(raw, meta)
    pipe = port.compile_pipeline(meta, configs.history(15), device=cuda)
    rcd.LAUNCHES = pw.LAUNCHES = sepblur.LAUNCHES = 0
    pw.PROGRAM_LAUNCHES.clear()
    got = pipe.output_array(raw)
    assert (rcd.LAUNCHES, pw.LAUNCHES, sepblur.LAUNCHES) == (1, 1, 360)
    assert dict(pw.PROGRAM_LAUNCHES) == {0: 1}
    monkeypatch.setattr(rcd, "rcd_demosaic", rcd.rcd_demosaic_reference)
    monkeypatch.setattr(sepblur, "sep_blur", sepblur.sep_blur_reference)
    monkeypatch.setattr(pw, "pointwise_chain", pw.pointwise_chain_reference)
    want = pipe.output_array(raw)
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0
    d = np.abs(got - want)
    assert d.max() <= 1.0 / 255.0 and d.mean() <= 1e-5


# the card against the CPU through the same torch code: CUDA divides by a
# Python float as a product with its reciprocal and rounds exp, log and
# pow otherwise, so values part by rounding; where a method decides by
# comparing two such values an ulp may flip the decision at a pixel
BRANCH_MEAN_TOL, BRANCH_MAX_TOL = 1e-6, 5e-2
BRANCH_PART_TOL, BRANCH_SHARE = 1e-4, 1e-3


def _branch_close(got, want):
    got, want = got.cpu(), want.cpu()
    assert torch.isfinite(got).all()
    d = (got - want).abs()
    scale = max(1.0, want.abs().max().item())
    assert d.max().item() <= BRANCH_MAX_TOL * scale
    assert d.mean().item() <= BRANCH_MEAN_TOL * scale
    assert (d > BRANCH_PART_TOL * scale).float().mean().item() <= BRANCH_SHARE


def _stage_pair(cuda, meta, raw, op, params):
    """The stage `op` of a pipe on one item, its input and coefficients on
    the card and on the CPU."""
    out = []
    for dev in (cuda, torch.device("cpu")):
        pipe = port.compile_pipeline(meta, [port.HistoryItem(op, params)],
                                     device=dev)
        i = [s.name for s in pipe.pipe.stages].index(op)
        x = torch.from_numpy(pad_to(raw, pipe.pipe.spec_in)).to(dev)
        x = pipe.pipe.trace_fn(0, i)(x, pipe.coeffs[:i])
        out.append((pipe.pipe.stages[i], x, pipe.coeffs[i], pipe.pipe.ctx))
    return out


@pytest.mark.parametrize("params,xtrans,launches", [
    ({"demosaicing_method": 1}, False, (0, 0)),            # AMaZE
    ({"demosaicing_method": 6, "lmmse_refine": 1}, False, (0, 0)),
    ({"demosaicing_method": 6, "lmmse_refine": 4}, False, (0, 0)),
    ({"demosaicing_method": 2}, False, (0, 0)),            # VNG4
    ({"demosaicing_method": 5, "green_eq": 3}, False, (1, 0)),
    ({"demosaicing_method": 5, "color_smoothing": 2}, False, (1, 0)),
    ({"demosaicing_method": 0x2005}, False, (1, 0)),       # RCD | DUAL
    ({"demosaicing_method": 0x1000}, True, (0, 0)),        # X-Trans VNG
    ({"demosaicing_method": 0x3001}, True, (0, 1)),        # X-Trans dual
], ids=["amaze", "lmmse-1", "lmmse-4", "vng4", "green-eq-3",
        "smoothing-2", "dual", "xtrans-vng", "xtrans-dual"])
def test_demosaic_branches_on_cuda_match_cpu(cuda, params, xtrans, launches):
    """One demosaic step alone at 96 x 132 on the card against the CPU;
    (RCD, Markesteijn) launches of the step."""
    raw, meta, scene = synth_raw(h=96, w=132, kind="gradients")
    if xtrans:
        raw, meta = configs.remosaic_xtrans(meta, scene)
    (st, x, c, ctx), (st_c, x_c, c_c, ctx_c) = _stage_pair(
        cuda, meta, raw, "demosaic", params)
    markesteijn.LAUNCHES = rcd.LAUNCHES = 0
    got = st.op.apply(x, c, st.plan, ctx)
    assert (rcd.LAUNCHES, markesteijn.LAUNCHES) == launches
    _branch_close(got, st_c.op.apply(x_c, c_c, st_c.plan, ctx_c))


@pytest.mark.parametrize("mode,xtrans", [(1, False), (2, False), (2, True),
                                         (4, True)],
                         ids=["lch", "inpaint", "xtrans-inpaint",
                              "xtrans-harmonic-clamp"])
def test_highlight_modes_on_cuda_match_cpu(cuda, mode, xtrans):
    """One highlights step alone on config 15's mosaic (X-Trans: config
    4's pattern clipped alike) on the card against the CPU; HARMONIC on
    X-Trans is the clamp."""
    raw, meta, scene = synth_raw(h=96, w=132, kind="gradients")
    if xtrans:
        raw, meta = configs.remosaic_xtrans(meta, scene)
    raw = configs.mosaic15(raw, meta)
    (st, x, c, ctx), (st_c, x_c, c_c, ctx_c) = _stage_pair(
        cuda, meta, raw, "highlights", {"mode": mode})
    got = st.op.apply(x, c, st.plan, ctx)
    _branch_close(got, st_c.op.apply(x_c, c_c, st_c.plan, ctx_c))
    assert (got - torch.minimum(x, c["clip"])).abs().max().item() > 0.0 \
        or mode == 4


def test_harmonic_dome_core_on_cuda_matches_cpu(cuda):
    """The dome core alone on config 15's highlights input and the card's
    Laplacian output, both handed to the CPU."""
    from ansel_tpu_torch.kernels import highlights_harmonic as hh

    raw, meta, _ = synth_raw(h=128, w=256, kind="gradients")
    raw = configs.mosaic15(raw, meta)
    (st, x, c, _), _ = _stage_pair(cuda, meta, raw, "highlights",
                                   {"mode": 4})
    rec = hl.laplacian_reconstruct(x, c["clips"], st.plan.spec_in.cfa, 8, 30,
                                   0.0, 0.5)
    got = hh.harmonic_dome_core(x, rec, c["clips"], st.plan.spec_in.cfa)
    want = hh.harmonic_dome_core(x.cpu(), rec.cpu(), c["clips"].cpu(),
                                 st.plan.spec_in.cfa)
    _branch_close(got, want)
    assert (got - rec).abs().max().item() > 0.05


def _spline_input(cuda, hw, seed):
    """A log-normal scene from deep shadow to ~10x over white, with
    negative, zero and grey pixels (tests/test_torch_filmic_versions.py's)."""
    rng = np.random.default_rng(seed)
    x = np.exp(rng.normal(-1.8, 1.7, (3,) + hw)).astype(np.float32)
    x[:, 0, : hw[1] // 4] = -0.02
    if hw[0] > 2:
        x[:, 1, : hw[1] // 4] = 0.0
        x[:, 2, : hw[1] // 4] = x[0, 2, : hw[1] // 4]
    return torch.from_numpy(x).to(cuda)


@pytest.mark.parametrize("version,method", configs.SPLINE_CASES,
                         ids=[f"v{v + 1}-{m}" for v, m in
                              configs.SPLINE_CASES])
def test_filmic_spline_opcode_matches_plain(cuda, version, method):
    """Opcode 33 (filmicrgb's spline route) as a one-stage chain, through
    its specialised program and the interpreter (equal bit for bit),
    against its plain twin on a frame of whole blocks and an odd one."""
    meta = synth_raw(h=16, w=16)[1]
    params = dict(configs.FILMIC16, version=version, preserve_color=method)
    for hw in [(64, 256), (5, 7)]:
        x = _spline_input(cuda, hw, version * 6 + method)
        chain = configs.opcode_chain(meta, "filmicrgb", params, x.shape,
                                     cuda)
        assert pw.FIXED[chain.fixed] == ((pw.OP_FILMIC_SPLINE, 0),)
        got = pw.pointwise_chain(x, chain)
        interp = pw.pointwise_chain(x, dataclasses.replace(chain, fixed=-1))
        want = pw.pointwise_chain_reference(x, chain)
        torch.cuda.synchronize()
        assert torch.equal(got, interp)
        assert torch.isfinite(got).all() and torch.isfinite(want).all()
        d = (got - want).abs()
        assert d.max().item() <= CHAIN_MAX_TOL
        assert d.mean().item() <= CHAIN_MEAN_TOL


def test_filmic_spline_after_a_reconstruction_on_cuda(cuda):
    """filmicrgb v5 with its highlight reconstruction planned and fired:
    the spline's one-stage program after it, against the stage with the
    twins."""
    raw, meta, _ = synth_raw(h=144, w=400, kind="gradients")
    hist = [port.HistoryItem(op, dict(p)) for op, p in configs.SPLINE_REC16]
    pipe = port.compile_pipeline(meta, hist, device=cuda)
    pw.PROGRAM_LAUNCHES.clear()
    got = pipe.output_array(raw)
    spline = pw.FIXED.index(((pw.OP_FILMIC_SPLINE, 0),))
    assert pw.PROGRAM_LAUNCHES[spline] == 1
    real = (sepblur.sep_blur, pw.pointwise_chain)
    sepblur.sep_blur = sepblur.sep_blur_reference
    pw.pointwise_chain = pw.pointwise_chain_reference
    try:
        want = pipe.output_array(raw)
    finally:
        sepblur.sep_blur, pw.pointwise_chain = real
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1.0 / 255.0


def test_config16_on_cuda_matches_its_twins(cuda, monkeypatch):
    """Config 16 at 144 x 400 on the card (RCD, the EAW decompose of the
    automatic profile's wavelets, the first chain, diffuse's 8-scale
    decompose on sepblur, the spline chain; the rest in torch) against the
    same pipe on the card with each wrapper's plain twin, and against the
    CPU."""
    raw, meta, _ = synth_raw(h=144, w=400, kind="gradients")
    raw, meta = configs.mosaic16(raw, meta), configs.meta16(meta)
    pipe = port.compile_pipeline(meta, configs.history(16), device=cuda)
    rcd.LAUNCHES = pw.LAUNCHES = sepblur.LAUNCHES = eaw.LAUNCHES = 0
    diffuse.LAUNCHES = 0
    got = pipe.output_array(raw)
    scales = pipe.pipe.stages[4].plan.static[0]
    assert (rcd.LAUNCHES, eaw.LAUNCHES, pw.LAUNCHES, sepblur.LAUNCHES,
            diffuse.LAUNCHES) == (1, scales, 2, 8, 0)
    cpu = port.compile_pipeline(meta, configs.history(16),
                                device="cpu").output_array(raw)
    monkeypatch.setattr(rcd, "rcd_demosaic", rcd.rcd_demosaic_reference)
    monkeypatch.setattr(sepblur, "sep_blur", sepblur.sep_blur_reference)
    monkeypatch.setattr(pw, "pointwise_chain", pw.pointwise_chain_reference)
    monkeypatch.setattr(eaw, "eaw_dn_coarse", lambda x, s, c:
                        eaw.eaw_coarse_reference(x, s, c, eaw.DN))
    want = pipe.output_array(raw)
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0
    for other in (want, cpu):
        d = np.abs(got - other)
        assert d.max() <= 1.0 / 255.0 and d.mean() <= 1e-5


# --- rawdenoiseai's U-Net, the scopes and config 17 ----------------------------

# the U-Net on the card (cuDNN, TF32 off) against oneDNN on the CPU: float32
# sums in other orders; relative to the largest output
UNET_REL_TOL = 1e-5
# the op on a mosaic in [0, 1]: the U-Net's residual and the anchor's sums.
# TF32 would move the mosaic by less than this (~6e-7 at 24 MP), so the
# precision is held by the test above: the spy on cuDNN's setting and
# UNET_REL_TOL on the net alone
NN_TOL = 1e-5


def test_unet_on_cuda_in_ieee_float32_matches_cpu(cuda, monkeypatch):
    """`unet_forward` runs its convolutions with cuDNN's TF32 off and
    puts the setting back after them."""
    from ansel_tpu_torch.io.anselnn import random_unet_ms
    from ansel_tpu_torch.kernels import unet

    seen = []
    real = torch.nn.functional.conv2d

    def spy(*a, **kw):
        seen.append(torch.backends.cudnn.conv.fp32_precision)
        return real(*a, **kw)

    monkeypatch.setattr(torch.nn.functional, "conv2d", spy)
    m = random_unet_ms(base=8, depth=2, seed=1).stage("fine")
    x = np.random.default_rng(1).uniform(0, 1, (8, 250, 374)).astype(
        np.float32)
    before = torch.backends.cudnn.conv.fp32_precision
    got = unet.unet_forward(m, torch.from_numpy(x).to(cuda)).cpu()
    assert torch.backends.cudnn.conv.fp32_precision == before
    assert seen and set(seen) == {"ieee"}
    want = unet.unet_forward(m, torch.from_numpy(x))
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= UNET_REL_TOL * scale


@pytest.mark.parametrize("xtrans", [False, True], ids=["bayer", "xtrans"])
@pytest.mark.parametrize("arch", ["unet", "unet-ms"])
def test_rawdenoiseai_on_cuda_matches_cpu(cuda, arch, xtrans):
    from ansel_tpu_torch.io import anselnn
    from ansel_tpu_torch.ops import rawdenoiseai as ai

    name = f"card-{arch}"
    ai.MODEL_REGISTRY[name] = (anselnn.random_unet_ms(seed=2)
                               if arch == "unet-ms"
                               else anselnn.random_unet(seed=2))
    raw, meta, scene = synth_raw(h=120, w=192, kind="gradients")
    if xtrans:
        raw, meta = configs.remosaic_xtrans(meta, scene)
    (st, x, c, ctx), (st_c, x_c, c_c, ctx_c) = _stage_pair(
        cuda, meta, raw, "rawdenoiseai", {"custom_model": name,
                                          "strength": 1.0})
    got = st.op.apply(x, c, st.plan, ctx).cpu()
    want = st_c.op.apply(x_c, c_c, st_c.plan, ctx_c)
    assert torch.isfinite(got).all()
    assert (got - x.cpu()).abs().max().item() > 1e-5
    assert (got - want).abs().max().item() <= NN_TOL


def test_scopes_on_cuda_equal_the_cpu(cuda):
    """The four scopes of config 1's output on the card, count for count
    against the same tensor on the CPU."""
    from ansel_tpu_torch.pipeline import histogram as scopes

    raw, meta, _ = synth_raw(h=200, w=720, kind="gradients")
    img = torch.from_numpy(port.compile_pipeline(
        meta, configs.history(1), device=cuda).output_array(raw)).to(cuda)
    for fn, kw in ((scopes.histogram_rgb, {}), (scopes.waveform, {}),
                   (scopes.waveform, {"out_cols": 70}),
                   (scopes.vectorscope, {})):
        got, want = fn(img, **kw), fn(img.cpu(), **kw)
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), want), fn.__name__
    s, s_cpu = scopes.stats(img), scopes.stats(img.cpu())
    for k in ("min", "max"):
        assert torch.equal(s[k].cpu(), s_cpu[k])


def test_config17_on_cuda_matches_its_twins(cuda, monkeypatch):
    """Config 17 at 144 x 400 on the card (rawdenoiseai's nets in cuDNN,
    RCD, config 1's chain) against the same pipe with each wrapper's
    plain twin, and against the CPU."""
    raw, meta, _ = synth_raw(h=144, w=400, kind="gradients")
    raw, meta = configs.mosaic16(raw, meta), configs.meta16(meta)
    with configs.model17(seed=0):
        pipe = port.compile_pipeline(meta, configs.history(17), device=cuda)
        cpu = port.compile_pipeline(meta, configs.history(17),
                                    device="cpu").output_array(raw)
    assert pipe.pipe.stages[1].plan.static == configs.MODEL17
    rcd.LAUNCHES = pw.LAUNCHES = 0
    got = pipe.output_array(raw)
    assert (rcd.LAUNCHES, pw.LAUNCHES) == (1, 1)
    monkeypatch.setattr(rcd, "rcd_demosaic", rcd.rcd_demosaic_reference)
    monkeypatch.setattr(pw, "pointwise_chain", pw.pointwise_chain_reference)
    want = pipe.output_array(raw)
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0
    for other in (want, cpu):
        d = np.abs(got - other)
        assert d.max() <= 1.0 / 255.0 and d.mean() <= 1e-5


def _virtual(n):
    return [torch.device("cuda", 0)] * n


def test_batch_pipeline_on_a_virtual_card_mesh(cuda):
    """Config 18 (a) at 128 x 256: four images over dp 2 on cuda:0, each
    equal to the single pipe's run, the kernels' launches counted from
    both shards' threads."""
    from ansel_tpu_torch.parallel.batch import BatchPipeline, make_mesh

    raw, meta, _ = synth_raw(h=128, w=256, kind="gradients")
    bp = BatchPipeline(meta, configs.history(1),
                       make_mesh(2, devices=_virtual(2)))
    batch = np.stack([raw * g for g in configs.GAINS18])
    rcd.LAUNCHES = pw.LAUNCHES = 0
    out = bp(batch)
    assert (rcd.LAUNCHES, pw.LAUNCHES) == (4, 4)
    one = port.compile_pipeline(meta, configs.history(1), device=cuda)
    for i in range(4):
        assert torch.equal(out[i], one(batch[i])), i


def test_spatial_pipeline_on_a_virtual_card_mesh(cuda):
    """Config 18 (b) at 768 x 256 over sp 2 on cuda:0: the denoise stack
    with its halo exchange and the sharded statistic, within 1/255 of the
    single pipe; RCD, EAW and NLM launched by both shards."""
    from ansel_tpu_torch.parallel.batch import make_mesh
    from ansel_tpu_torch.parallel.spatial import SpatialPipeline

    raw, meta, _ = synth_raw(h=768, w=256, kind="gradients")
    hist = configs.history(18)
    sp = SpatialPipeline(meta, hist, make_mesh(spatial=2,
                                               devices=_virtual(2)))
    rcd.LAUNCHES = eaw.LAUNCHES = nlm.LAUNCHES = 0
    got = sp(raw).cpu().numpy()
    assert rcd.LAUNCHES == 2 and nlm.LAUNCHES == 2
    assert eaw.LAUNCHES == 2 * sp.pipe.stages[[
        s.name for s in sp.pipe.stages].index("denoiseprofile")].plan.static[0]
    want = port.compile_pipeline(meta, hist, device=cuda).output_array(raw)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() < 1.0 / 255.0


def test_spatial_sharded_pipe_on_a_virtual_card_mesh(cuda):
    """Config 18 (c) at 256 x 384 over (dp 2, sp 2) on cuda:0, config 1's
    history: within 1e-5 of the single pipe."""
    from ansel_tpu_torch.parallel.batch import make_mesh, spatial_sharded_pipe

    raw, meta, _ = synth_raw(h=256, w=384, kind="gradients")
    call, pipe = spatial_sharded_pipe(
        meta, configs.history(1), make_mesh(4, spatial=2,
                                            devices=_virtual(4)))
    rcd.LAUNCHES = 0
    got = call(raw)
    assert rcd.LAUNCHES == 4
    want = port.CompiledPipe(pipe)(raw)[:, :256, :384]
    assert (got - want).abs().max().item() <= 1e-5


def test_spatial_sharded_pipe_frame_statistics_on_a_virtual_card_mesh(cuda):
    """Config 18 (c)'s second history at 256 x 384 over (dp 2, sp 2) on
    cuda:0: denoiseprofile's wavelets and green equilibration 2 read the
    whole frame, which every band computes; within 1e-5 of the single
    pipe, each band's kernels launched."""
    from ansel_tpu_torch.parallel.batch import make_mesh, spatial_sharded_pipe

    raw, meta, _ = synth_raw(h=256, w=384, kind="gradients")
    hist = [port.HistoryItem(op, dict(p))
            for op, p in configs.HISTORY18_FRAME]
    call, pipe = spatial_sharded_pipe(
        meta, hist, make_mesh(4, spatial=2, devices=_virtual(4)))
    rcd.LAUNCHES = eaw.LAUNCHES = 0
    got = call(raw)
    assert rcd.LAUNCHES == 4 and eaw.LAUNCHES == 4 * pipe.stages[[
        s.name for s in pipe.stages].index("denoiseprofile")].plan.static[0]
    want = port.CompiledPipe(pipe)(raw)[:, :256, :384]
    assert (got - want).abs().max().item() <= 1e-5


# --- slice 22: the warp's staged and direct tiles, sep_filter past 3-D ------

def _warp_case(kind, h, w, cuda):
    """(call, twin, positions, valid, input) of map `kind` on an (h, w)
    frame, with arguments whose source boxes overflow the staging budget
    on some tiles (`warp.TILE`): a 45-degree clipping behind a strong
    keystone, a strong ashift, a liquify stroke moving pixels by up to 300
    px."""
    gen = torch.Generator(device=cuda).manual_seed(22)
    x = torch.rand((3, h, w), generator=gen, device=cuda)
    if kind == "clip":
        k, k_apply, _, (oh, ow) = _clip_args("rotate45-strong-keystone", h,
                                             w)
        sy, sx, inside = warp.clip_coords(k, k_apply, oh, ow, cuda)
        return (lambda: warp.clip_warp(x, k, k_apply, oh, ow),
                lambda: warp.clip_warp_reference(x, k, k_apply, oh, ow),
                [(sy, sx)], inside, x)
    if kind == "homography":
        k = _ashift_consts({"rotation": 30.0, "lensshift_v": 1.0,
                            "lensshift_h": 1.0}, h, w)
        sy, sx, inside = warp.homography_coords(k, h, w, cuda)
        return (lambda: warp.homography_warp(x, k),
                lambda: warp.homography_warp_reference(x, k), [(sy, sx)],
                inside, x)
    from ansel_tpu_torch.ops import liquify

    pt = complex(w / 2, h / 2)
    blob = configs.liquify_node(configs.PATH_MOVE, -1, -1, pt, pt + 600,
                                pt + 150.0, configs.WARP_LINEAR)
    blob += b"\0" * (76 * configs.LIQUIFY_NODES - len(blob))
    stamps = _stamps(blob, cuda)
    spec = ImageSpec(width=w, height=h, colorspace=Colorspace.CAMERA_RGB,
                     pad_w=w, pad_h=h)
    win = liquify.Liquify().plan(port.ops.base.PlanContext(meta=None), spec,
                                 liquify.LiquifyParams(blob)).static[4]
    sy, sx, valid = warp.liquify_positions(stamps, win, h, w)
    return (lambda: warp.liquify_warp(x, stamps, win),
            lambda: warp.liquify_warp_reference(x, stamps, win), [(sy, sx)],
            valid, x)


@pytest.mark.parametrize("kind", ["clip", "homography", "liquify"])
@pytest.mark.parametrize("hw", [(600, 1000), (601, 999)])
def test_warp_staged_and_direct_tiles(cuda, kind, hw):
    """Maps whose tiles partly overflow the staging budget: one launch,
    bit for bit, the direct tiles the kernel counts those
    `warp.tile_plan` plans from the twin's positions, on a frame whose
    rows are 16-byte aligned and one whose are not."""
    call, twin, sets, valid, x = _warp_case(kind, *hw, cuda)
    warp.reset_direct_tiles()
    before = warp.LAUNCHES
    got = call()
    assert warp.LAUNCHES == before + 1
    direct = warp.direct_tiles()[kind]
    want = twin()
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    plan = warp.tile_plan(sets, valid, *hw, 3,
                          hw[1] % 4 == 0 and x.data_ptr() % 16 == 0)
    assert direct == int((~plan[4]).sum()) > 0


def test_sep_filter_on_a_4d_tensor(cuda):
    """sep_filter folds the leading axes of a 4-D tensor into one: one
    launch, bit for bit against the per-plane blurs and the twin."""
    from ansel_tpu_torch.pixel.shifts import sep_filter

    x = _noisy((2, 3, 136, 400), 4, cuda)
    before = sepblur.LAUNCHES
    got = sep_filter(x, B3, 4)
    assert sepblur.LAUNCHES == before + 1
    want = torch.stack([sepblur.sep_blur(p, B3, 4) for p in x])
    assert torch.equal(got, want)
    assert torch.equal(got, sepblur.sep_blur_reference(x, B3, 4))
