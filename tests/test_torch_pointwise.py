"""The port's plain colour chain (ansel_tpu_torch/kernels/pointwise.py)
against the reference's fused chain: ansel_tpu plans config 1 and runs
stages 4-8 through `pallas_pointwise` in interpret mode; the port gets the
same coefficients through `interop.coeffs_from_reference`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ansel_tpu
import ansel_tpu_torch
from ansel_tpu.core.types import Colorspace as RefColorspace
from ansel_tpu.io.synthetic import synth_raw
from ansel_tpu.pipeline import engine as ref_engine
from ansel_tpu_torch import interop
from ansel_tpu_torch.core.types import Colorspace
from ansel_tpu_torch.io import configs
from ansel_tpu_torch.kernels import pointwise as pw
from ansel_tpu_torch.pipeline import engine

torch.set_num_threads(2)

# Same coefficients, same operand order; what differs is XLA's and
# torch's powf/log2/exp on the CPU (an ulp each), which the filmic spline
# and the gamut map amplify on steep parts of the curve.  The reference's
# own fused and per-op paths differ by 2.7e-5 max (mean 2.0e-7) here.
MAX_TOL, MEAN_TOL = 1e-4, 1e-6

CONFIG1 = list(configs.HISTORIES[1])


@pytest.fixture
def fusion_interpret():
    ref_engine._FORCE_FUSION_INTERPRET = True
    ref_engine._COMPILE_CACHE.clear()
    yield
    ref_engine._FORCE_FUSION_INTERPRET = False
    ref_engine._COMPILE_CACHE.clear()


def _pipes():
    _, meta, _ = synth_raw(h=64, w=512)
    ref = ansel_tpu.Pipeline(meta, [ansel_tpu.HistoryItem(o, p)
                                    for o, p in CONFIG1])
    port = ansel_tpu_torch.Pipeline(
        meta, [ansel_tpu_torch.HistoryItem(o, p) for o, p in CONFIG1],
        device="cpu")
    return ref, port


def _block():
    """A camera-RGB block with values below 0 and above 1."""
    rng = np.random.default_rng(11)
    return rng.uniform(-0.2, 3.0, (3, 64, 512)).astype(np.float32)


def _insert_lab_round_trip(pipe, planned_op, convert, work, lab, at):
    spec = pipe.stages[at - 1].plan.spec_out
    to_lab = convert.plan_pair(spec, lab)
    back = convert.plan_pair(to_lab.spec_out, work)
    pipe.stages[at:at] = [planned_op("_convert", convert, to_lab, None),
                          planned_op("_convert", convert, back, None)]


def _compare(ref, port, start, end, coeffs):
    x = _block()
    want = np.asarray(ref.trace_fn(start, end)(jnp.asarray(x), coeffs))
    got = port.trace_fn(start, end)(
        torch.from_numpy(x), interop.coeffs_from_reference(coeffs, "cpu"))
    d = np.abs(got.numpy() - want)
    assert np.isfinite(want).all()
    assert d.max() <= MAX_TOL and d.mean() <= MEAN_TOL, (d.max(), d.mean())


def test_chain_matches_pallas_interpret(fusion_interpret):
    ref, port = _pipes()
    assert [s.name for s in ref.stages[4:9]] == [
        "exposure", "colorin", "channelmixerrgb", "filmicrgb", "colorout"]
    _compare(ref, port, 4, 9, ref.coeffs()[4:9])


def test_chain_with_convert_stages_matches_pallas_interpret(
        fusion_interpret):
    ref, port = _pipes()
    coeffs = ref.coeffs()
    # a work -> Lab -> work round trip after channelmixerrgb
    _insert_lab_round_trip(ref, ref_engine.PlannedOp, ref_engine._CONVERT,
                           RefColorspace.WORK_RGB, RefColorspace.LAB, 7)
    _insert_lab_round_trip(port, engine.PlannedOp, engine._CONVERT,
                           Colorspace.WORK_RGB, Colorspace.LAB, 7)
    coeffs[7:7] = [None, None]
    assert [s.name for s in port.stages[4:11]] == [
        s.name for s in ref.stages[4:11]]
    steps = port.schedule(interop.coeffs_from_reference(coeffs[4:11], "cpu"),
                          4, 11)
    assert [(k, i, j) for k, i, j, _ in steps] == [("chain", 4, 11)]
    _compare(ref, port, 4, 11, coeffs[4:11])


def test_pack_chain_layout():
    _, port = _pipes()
    coeffs = interop.coeffs_from_reference(port.coeffs(), "cpu")
    specs = [s.op.pointwise_spec(s.plan, port.ctx) for s in port.stages[4:9]]
    chain = pw.pack_chain(specs, coeffs[4:9], "cpu")
    prog = chain.prog.view(5, pw.RECORD)
    assert prog[:, 0].tolist() == [pw.OP_EXPOSURE, pw.OP_MATRIX,
                                   pw.OP_CHANNELMIXERRGB, pw.OP_FILMIC_AGX,
                                   pw.OP_COLOROUT]
    # const offsets: exposure 2, colorin 9, channelmixerrgb 64 + 3 white,
    # filmic 25 + 4 matrices + Y row + 6 gamut folds, colorout 9
    assert prog[:, 1].tolist() == [0, 2, 11, 78, 148]
    assert chain.consts.numel() == 157
    assert chain.consts[:2].tolist() == [coeffs[4]["black"].item(),
                                         coeffs[4]["scale"].item()]
    # channelmixerrgb statics minus has_mix; filmic curve types
    assert prog[2, 2:9].tolist() == [1, 2, 1, 0, 0, 1, 0]
    assert prog[3, 2:4].tolist() == [3, 3]


def test_pack_chain_refuses_what_the_kernel_does_not_take():
    _, port = _pipes()
    coeffs = interop.coeffs_from_reference(port.coeffs(), "cpu")
    spec = port.stages[4].op.pointwise_spec(port.stages[4].plan, port.ctx)
    with pytest.raises(ValueError):
        pw.pack_chain([spec] * (pw.MAX_STAGES + 1),
                      [coeffs[4]] * (pw.MAX_STAGES + 1), "cpu")
    bad = type(spec)(fn=spec.fn, opcode=99, consts=spec.consts)
    with pytest.raises(ValueError):
        pw.pack_chain([bad], [coeffs[4]], "cpu")


def test_chain_wrapper_runs_the_plain_version_on_cpu():
    _, port = _pipes()
    coeffs = interop.coeffs_from_reference(port.coeffs(), "cpu")
    steps = port.schedule(coeffs[4:9], 4, 9)
    chain = steps[0][3]
    x = torch.from_numpy(_block())
    before = pw.LAUNCHES
    out = pw.pointwise_chain(x, chain)
    assert pw.LAUNCHES == before
    assert torch.equal(out, pw.pointwise_chain_reference(x, chain))
    with pytest.raises(ValueError):
        pw.pointwise_chain(x.to("meta"), chain)
