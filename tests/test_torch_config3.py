"""The port's config-3 slice (the heavy iterative stack, bench.py:39-46)
against ansel_tpu on the CPU: plan and coefficients, the whole slice
against the TPU form over the full frame and against the JAX package's
CPU pipe in the interior, and the fused chains.  The raw comes from
synth_raw and goes to both packages."""

import dataclasses
import enum

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ansel_tpu
import ansel_tpu_torch
from ansel_tpu.io.synthetic import synth_raw
from ansel_tpu.kernels.diffuse_pallas import diffuse_iteration_pallas
from ansel_tpu.kernels.iir_pallas import gaussian_iir_pallas
from ansel_tpu.kernels.rcd_pallas import rcd_demosaic_pallas
from ansel_tpu.ops.base import pad_to
from ansel_tpu.pixel import blur as ref_blur
from ansel_tpu_torch import interop
from ansel_tpu_torch.io import configs
from ansel_tpu_torch.kernels import diffuse, iir, sepblur

torch.set_num_threads(2)

STAGES = ["rawprepare", "temperature", "highlights", "demosaic", "exposure",
          "toneequal", "colorin", "diffuse", "filmicrgb", "_convert", "bilat",
          "_convert", "colorout"]
DISPLAY_QUANTUM = 1.0 / 255.0
# the TPU form: one frame; the JAX CPU pipe: a frame with an interior
# beyond the diffuse iteration's 93-px reach
H, W = 160, 240
HC, WC = 288, 416
RING = 96


def _hist(pkg):
    return configs.history(3, pkg.HistoryItem)


def _plain(v):
    if isinstance(v, enum.Enum):
        return v.value
    if dataclasses.is_dataclass(v):
        return tuple(_plain(getattr(v, f.name))
                     for f in dataclasses.fields(v))
    if isinstance(v, (tuple, list)):
        return tuple(_plain(x) for x in v)
    return v


def _tpu_form(raw, meta, monkeypatch):
    """ansel_tpu's config 3 as the TPU runs it: the Pallas RCD, diffuse
    and IIR kernels in interpret mode between its CPU stages (the TPU
    takes the Pallas IIR for planes of 1 MP or more, as config 3's 45 MP
    pair is; this frame's is not, so the test routes it there)."""
    def pallas_iir(x, sigma, order=0, vmin=None, vmax=None):
        return gaussian_iir_pallas(x, sigma, order, vmin, vmax,
                                   interpret=True)

    monkeypatch.setattr(ref_blur, "gaussian_iir", pallas_iir)
    ref = ansel_tpu.Pipeline(meta, _hist(ansel_tpu))
    co = ref.coeffs()
    x = ref.trace_fn(0, 3)(jnp.asarray(pad_to(raw, ref.spec_in)), co[0:3])
    x = rcd_demosaic_pallas(x, ref.stages[3].plan.spec_in.cfa,
                            co[3]["scaler"], interpret=True)
    x = ref.trace_fn(4, 7)(x, co[4:7])
    scales, iterations, modes, has_mask = ref.stages[7].plan.static
    assert not has_mask
    for _ in range(iterations):
        x = diffuse_iteration_pallas(x, co[7], scales, modes, interpret=True)
    x = ref.trace_fn(8, 13)(x, co[8:13])
    monkeypatch.undo()
    return ref, np.asarray(x)[:, :raw.shape[0], :raw.shape[1]]


@pytest.fixture(scope="module")
def slice3():
    """The port on the CPU, with the kernel launches it made; the
    reference's TPU form at H x W; both on a larger frame, the reference
    through its CPU CompiledPipe."""
    mp = pytest.MonkeyPatch()
    raw, meta, _ = synth_raw(h=H, w=W, kind="gradients")
    port = ansel_tpu_torch.compile_pipeline(meta, _hist(ansel_tpu_torch),
                                            device="cpu")
    mods = (diffuse, iir, sepblur)
    before = [m.LAUNCHES for m in mods]
    got = port.output_array(raw)
    launched = [m.LAUNCHES for m in mods] != before
    ref, tpu_form = _tpu_form(raw, meta, mp)

    raw_c, meta_c, _ = synth_raw(h=HC, w=WC, kind="gradients")
    got_c = ansel_tpu_torch.compile_pipeline(
        meta_c, _hist(ansel_tpu_torch), device="cpu").output_array(raw_c)
    cpu_form = ansel_tpu.compile_pipeline(
        meta_c, _hist(ansel_tpu)).output_array(raw_c)
    return port, ref, got, tpu_form, got_c, cpu_form, launched


def test_config3_plan_and_coeffs_equal_reference(slice3):
    port, ref = slice3[0].pipe, slice3[1]
    assert [s.name for s in port.stages] == [s.name for s in ref.stages]
    assert [s.name for s in port.stages] == STAGES
    for p, r in zip(port.stages, ref.stages):
        assert _plain(p.plan.spec_in) == _plain(r.plan.spec_in), p.name
        assert _plain(p.plan.static) == _plain(r.plan.static), p.name
    # 5 wavelet scales, 4 iterations, isotropic kernels, no mask
    assert port.stages[7].plan.static == (5, 4, (0, 0, 0, 0), False)
    for p, r in zip(port.coeffs(), ref.coeffs()):
        assert sorted(p or {}) == sorted(r or {})
        for k in p or {}:
            assert np.array_equal(np.asarray(p[k]), np.asarray(r[k])), k


def test_config3_matches_tpu_form_full_frame(slice3):
    _, _, got, tpu_form, _, _, launched = slice3
    assert not launched
    assert got.shape == tpu_form.shape == (3, H, W)
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0
    d = np.abs(got - tpu_form)
    assert d.max() <= DISPLAY_QUANTUM and d.mean() <= 1e-5


def test_config3_matches_cpu_pipe_interior(slice3):
    # the JAX CPU pipe re-pads at every diffuse blur (the kernels pad the
    # image once) and its RCD border differs from the Pallas one: drop a
    # ring wider than the iteration's 93-px reach
    got_c, cpu_form = slice3[4], slice3[5]
    assert got_c.shape == cpu_form.shape == (3, HC, WC)
    ring = (slice(None), slice(RING, -RING), slice(RING, -RING))
    assert np.abs(got_c[ring] - cpu_form[ring]).max() <= DISPLAY_QUANTUM


def test_config3_chains(slice3):
    port = slice3[0]
    assert port.fused_groups() == [["exposure"], ["colorin"],
                                   ["filmicrgb", "_convert"],
                                   ["_convert", "colorout"]]


def test_reference_coeffs_drive_the_port(slice3):
    """interop carries the reference's coefficients (factors, ABCD,
    strength, norm_reg, ...) into the port: the same pixels result."""
    port, ref = slice3[0], slice3[1]
    carried = interop.coeffs_from_reference(ref.coeffs(), "cpu")
    for k in (5, 7):   # toneequal, diffuse
        for name, v in carried[k].items():
            assert torch.equal(v, port.coeffs[k][name]), name
