"""The port's config-4 slice (X-Trans Markesteijn and lens with TCA,
bench.py:48-53) against ansel_tpu on the CPU: plan and coefficients, the
whole slice against the TPU form over the full frame and against the JAX
package's CPU pipe in the interior, and the fused chain.  The X-Trans raw
comes from synth_raw remosaicked as bench.py does, and goes to both
packages."""

import dataclasses
import enum

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_markesteijn import _pallas_op_by_op

import ansel_tpu
import ansel_tpu_torch
from ansel_tpu.io.synthetic import synth_raw
from ansel_tpu.ops.base import pad_to
from ansel_tpu_torch import interop
from ansel_tpu_torch.io import configs
from ansel_tpu_torch.kernels import markesteijn, warp

torch.set_num_threads(2)

STAGES = ["rawprepare", "temperature", "highlights", "demosaic", "lens",
          "exposure", "colorin", "filmicrgb", "colorout"]
DISPLAY_QUANTUM = 1.0 / 255.0
# 96 x 288: two Pallas tile rows, columns padded to 384; lens plans a
# displacement bound of 3 px, so the warp runs
H, W = 96, 288


def _hist(pkg):
    return configs.history(4, pkg.HistoryItem)


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
    """ansel_tpu's config 4 as the TPU runs it, with the lens warp in the
    form the port matches (the CPU gather): its CPU stages around the
    Pallas Markesteijn kernel's grid, each tile evaluated op by op (in
    interpret mode XLA fuses the tile and moves near-tie directions)."""
    ref = ansel_tpu.Pipeline(meta, _hist(ansel_tpu))
    co = ref.coeffs()
    x = ref.trace_fn(0, 3)(jnp.asarray(pad_to(raw, ref.spec_in)), co[0:3])
    rgb = _pallas_op_by_op(np.asarray(x), 1, monkeypatch)
    out = ref.trace_fn(4, 9)(jnp.asarray(rgb), co[4:9])
    return ref, np.asarray(out)[:, :raw.shape[0], :raw.shape[1]]


@pytest.fixture(scope="module")
def slice4():
    raw, meta, scene = synth_raw(h=H, w=W, kind="gradients")
    raw, meta = configs.remosaic_xtrans(meta, scene)
    port = ansel_tpu_torch.compile_pipeline(meta, _hist(ansel_tpu_torch),
                                            device="cpu")
    with pytest.MonkeyPatch.context() as mpatch:
        ref, tpu = _tpu_form(raw, meta, mpatch)
    return port, port.output_array(raw), ref, tpu, raw, meta


def test_plan_and_coeffs_equal_the_jax_package(slice4):
    port, _, ref, _, _, _ = slice4
    assert [s.name for s in port.pipe.stages] == STAGES
    assert ([s.name for s in ref.stages] == STAGES)
    for a, b in zip(port.pipe.stages, ref.stages):
        assert _plain(a.plan.spec_in) == _plain(b.plan.spec_in), a.name
        assert _plain(a.plan.static) == _plain(b.plan.static), a.name
    for a, b in zip(port.pipe.coeffs(), ref.coeffs()):
        assert (a is None) == (b is None)
        if a is not None:
            assert sorted(a) == sorted(b)
            for k in a:
                assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    assert port.pipe.spec_in.cfa is ansel_tpu_torch.CFAPattern.XTRANS


def test_bench_label_plans_one_pass(slice4):
    """ROADMAP R1: bench.py's 1024 | 2 plans Markesteijn 1-pass in both
    packages."""
    port, _, ref, _, _, _ = slice4
    i = STAGES.index("demosaic")
    assert port.pipe.stages[i].plan.static[0] == 0x1001
    assert ref.stages[i].plan.static[0] == 0x1001
    assert port.pipe.stages[i + 1].plan.static == (2, 11, 3, False)


def test_interop_carries_the_reference_coefficients(slice4):
    port, _, ref, _, _, _ = slice4
    got = interop.coeffs_from_reference(ref.coeffs(), "cpu")
    for a, b in zip(got, port.coeffs):
        assert (a is None) == (b is None)
        if a is not None:
            assert sorted(a) == sorted(b)
            for k in a:
                assert torch.equal(a[k], b[k]), k
    i = STAGES.index("lens")
    assert sorted(got[i]) == ["a", "b", "c", "scale", "tca_b", "tca_r", "vig"]
    assert got[i]["tca_r"].shape == (3,) and got[i]["vig"].shape == (3,)
    assert "scaler" in got[STAGES.index("demosaic")]


def test_one_chain_after_lens(slice4):
    port = slice4[0]
    assert port.fused_groups() == [["exposure", "colorin", "filmicrgb",
                                    "colorout"]]
    assert [k for k, *_ in port.steps] == ["stage"] * 5 + ["chain"]


# the port against the TPU form over the whole frame, borders included:
# the Markesteijn twin equals the Pallas tile body, the lens warp and the
# chain round within display precision (measured 2.2e-5).  Composed with
# the interpret-mode kernel instead, the fused XLA arithmetic moves
# near-tie directions and the slice differs by up to 0.36 at a few pixels
# (tests/test_torch_markesteijn.py holds that form with a statistical gate)
def test_slice_matches_the_tpu_form_full_frame(slice4):
    _, got, _, want, _, _ = slice4
    assert got.shape == want.shape == (3, H, W)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= DISPLAY_QUANTUM


# The JAX CPU pipe demosaics with the whole-image kernels/markesteijn.py,
# which fills the 2x2 greens differently (ROADMAP R2) and pads the frame
# its own way; inside a 16-px ring the two agree to display precision
# (measured 1.6e-5), on the ring they do not (0.52).
RING = 16


def test_slice_matches_the_jax_cpu_pipe_inside_the_ring(slice4):
    _, got, _, _, raw, meta = slice4
    want = np.asarray(ansel_tpu.compile_pipeline(meta, _hist(ansel_tpu))
                      .output_array(raw))
    err = np.abs(got - want)[:, RING:-RING, RING:-RING]
    assert err.max() <= DISPLAY_QUANTUM


def test_slice_runs_each_kernel_wrapper_once(monkeypatch):
    raw, meta, scene = synth_raw(h=48, w=96, kind="gradients")
    raw, meta = configs.remosaic_xtrans(meta, scene)
    calls = []
    for mod, name in ((markesteijn, "xtrans_markesteijn"),
                      (warp, "lens_warp")):
        real = getattr(mod, name)

        def spy(*args, _real=real, _name=name):
            calls.append(_name)
            return _real(*args)

        monkeypatch.setattr(mod, name, spy)
    ansel_tpu_torch.compile_pipeline(meta, _hist(ansel_tpu_torch),
                                     device="cpu").output_array(raw)
    assert calls == ["xtrans_markesteijn", "lens_warp"]


def test_xtrans_color_helpers_equal_the_jax_package():
    from ansel_tpu.ops import _bayer as ref_bayer
    from ansel_tpu_torch.ops import _bayer

    h, w = 13, 17
    vals = [2.0, 1.0, 1.5]
    got = _bayer.xtrans_color_select(torch.tensor(vals + [1.0]),
                                     configs.XTRANS6, h, w)
    want = ref_bayer.xtrans_color_select(vals, configs.XTRANS6, h, w)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(want))
