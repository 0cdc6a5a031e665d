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
from ansel_tpu_torch.core.types import CFAPattern, Colorspace
from ansel_tpu_torch.io.synthetic import synth_raw
from ansel_tpu_torch.kernels import pointwise as pw
from ansel_tpu_torch.kernels import rcd
from ansel_tpu_torch.pipeline import engine

torch.set_num_threads(2)

# The kernels repeat the plain versions' float32 operations in the same
# order (nvcc --fmad=false); RCD has no transcendental, the chain's
# powf/log2f/expf may differ from torch's by an ulp.
RCD_TOL = 1e-6
CHAIN_MAX_TOL, CHAIN_MEAN_TOL = 1e-4, 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("cfa", ["RGGB", "BGGR", "GRBG", "GBRG"])
@pytest.mark.parametrize("h,w,scaler", [(136, 400, 2.7), (5, 7, 1.0),
                                        (64, 1000, 0.5)])
def test_rcd_kernel_matches_plain(cuda, cfa, h, w, scaler):
    rng = np.random.default_rng(h * w)
    x = torch.from_numpy((rng.uniform(0, 1, (h, w)) * scaler)
                         .astype(np.float32)).to(cuda)
    before = rcd.LAUNCHES
    got = rcd.rcd_demosaic(x, CFAPattern[cfa], scaler)
    assert rcd.LAUNCHES == before + 1
    want = rcd.rcd_demosaic_reference(x, CFAPattern[cfa], scaler)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= RCD_TOL * scaler


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
    "config1": [("exposure", {"exposure": 0.5}), ("channelmixerrgb", {}),
                ("filmicrgb", {})],
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
    items = CHAINS.get(name, CHAINS["config1"])
    chain = _chain(items, cuda, lab_round_trip=name == "lab-round-trip")
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.uniform(-0.2, 3.0, (3, 64, 256))
                         .astype(np.float32)).to(cuda)
    before = pw.LAUNCHES
    got = pw.pointwise_chain(x, chain)
    assert pw.LAUNCHES == before + 1
    want = pw.pointwise_chain_reference(x, chain)
    torch.cuda.synchronize()
    assert torch.isfinite(want).all()
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
    want = pw.pointwise_chain_reference(x, chain)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
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
