"""The port's noise-profile database (`io/noiseprofiles.py` and its copy of
noiseprofiles.json) and denoiseprofile's automatic profiles (a[1] <= 0,
the module's default params) against ansel_tpu on the CPU: the loaded
tables, the lookups (an exact ISO row, an ISO between two rows, a model
matched by substring, an unknown camera), and the op's plan,
coefficients and wavelet `apply` for each kind of lookup, with the
generic fallback's log line."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ansel_tpu
import ansel_tpu_torch
from ansel_tpu.io import noiseprofiles as ref_np
from ansel_tpu.io.synthetic import synth_raw
from ansel_tpu_torch.core import log
from ansel_tpu_torch.io import configs
from ansel_tpu_torch.io import noiseprofiles
from ansel_tpu_torch.pipeline import engine

torch.set_num_threads(1)

# the wavelet denoise against the JAX op, as tests/test_torch_denoise.py
# holds it (DP_TOL there)
DP_TOL = 2e-5
# (maker, model, iso): config 16's camera at its ISO row and between two
# rows, a model string that only contains a database model (matched by
# substring), a camera the database lacks
LOOKUPS = {
    "exact": ("Sony", "ILCE-7M3", 3200.0),
    "interpolated": ("Sony", "ILCE-7M3", 2500.0),
    "substring": ("SONY", "ILCE-7M3 (full frame)", 800.0),
    "unknown": ("Nobody", "Camera 1", 400.0),
}


def test_the_bundled_tables_are_the_jax_packages():
    port, ref = noiseprofiles.load(), ref_np.load()
    assert len(port) > 100 and port == ref


@pytest.mark.parametrize("case", sorted(LOOKUPS))
def test_find_is_the_jax_packages(case):
    got = noiseprofiles.find(*LOOKUPS[case])
    assert got == ref_np.find(*LOOKUPS[case])
    assert (got is None) == (case == "unknown")


def test_find_interpolates_linearly_in_iso():
    rows = noiseprofiles.load()[("sony", "ilce-7m3")]
    (i1, a1, b1), (i2, a2, b2) = next(
        (r, q) for r, q in zip(rows, rows[1:]) if r[0] >= 1600.0)
    a, b = noiseprofiles.find("Sony", "ILCE-7M3", 0.75 * i1 + 0.25 * i2)
    t = 0.25
    assert np.allclose(a, [(1 - t) * x + t * y for x, y in zip(a1, a2)],
                       rtol=1e-12, atol=0)
    assert np.allclose(b, [(1 - t) * x + t * y for x, y in zip(b1, b2)],
                       rtol=1e-12, atol=0)


def test_an_explicit_or_missing_database(tmp_path):
    path = tmp_path / "np.json"
    path.write_text('{"noiseprofiles": [{"maker": "Acme", "models": [{"model":'
                    ' "X1", "profiles": [{"iso": 100, "a": [1, 2, 3], "b":'
                    ' [4, 5, 6]}]}]}]}')
    assert noiseprofiles.find("acme", "x1", 50.0, str(path)) == (
        (1, 2, 3), (4, 5, 6))
    assert noiseprofiles.find("Sony", "ILCE-7M3", 100.0, str(path)) is None


def _pipes(case, h=64, w=200):
    _, meta, _ = synth_raw(h=h, w=w)
    maker, model, iso = LOOKUPS[case]
    meta = dataclasses.replace(meta, maker=maker, model=model, iso=iso)
    hist = [("denoiseprofile", {}), ("exposure", {"exposure": 0.5})]
    ref = ansel_tpu.Pipeline(
        meta, [ansel_tpu.HistoryItem(o, dict(p)) for o, p in hist])
    port = ansel_tpu_torch.Pipeline(
        meta, [ansel_tpu_torch.HistoryItem(o, dict(p)) for o, p in hist],
        device="cpu")
    i = [s.name for s in ref.stages].index("denoiseprofile")
    return ref, port, i


@pytest.mark.parametrize("case", sorted(LOOKUPS))
def test_automatic_profile_plans_and_denoises_like_the_jax_package(case):
    log.clear()
    ref, port, i = _pipes(case)
    assert [s.name for s in port.stages] == [s.name for s in ref.stages]
    ps, rs = port.stages[i], ref.stages[i]
    assert ps.params.a[1] <= 0                     # the automatic profile
    assert ps.plan.static == rs.plan.static
    pc, rc = port.coeffs()[i], ref.coeffs()[i]
    assert sorted(pc) == sorted(rc)
    for k in pc:
        assert np.array_equal(np.asarray(pc[k]), np.asarray(rc[k])), k
    generic = [m for _, _, m in log.records("always")
               if "GENERIC coefficients" in m]
    hit = noiseprofiles.find(*LOOKUPS[case])
    if hit is None:
        assert generic and "'Nobody Camera 1' iso 400.0" in generic[0]
    else:
        assert not generic
    rng = np.random.default_rng(len(case))
    yy, xx = np.mgrid[0:64, 0:200].astype(np.float32)
    base = np.stack([0.2 + 0.5 * xx / 200, 0.3 + 0.4 * yy / 64,
                     0.25 + 0.2 * (xx + yy) / 264])
    x = np.clip(base + rng.normal(0, 0.03, base.shape), 0,
                None).astype(np.float32)
    want = np.asarray(rs.op.apply(jnp.asarray(x), rc, rs.plan, ref.ctx))
    c = engine.coeffs_to_device([pc], "cpu")[0]
    got = ps.op.apply(torch.from_numpy(x), c, ps.plan, port.ctx).numpy()
    assert np.abs(got - x).mean() > 1e-4           # it denoised
    assert np.abs(got - want).max() <= DP_TOL


def test_config16_finds_its_camera():
    _, meta, _ = synth_raw(h=32, w=48)
    meta = configs.meta16(meta)
    assert (meta.maker, meta.model, meta.iso) == configs.SENSOR16
    assert noiseprofiles.find(meta.maker, meta.model, meta.iso) is not None
