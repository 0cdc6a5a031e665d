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
