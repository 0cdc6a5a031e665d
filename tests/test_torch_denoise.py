"""The port's denoise path against ansel_tpu: the fast exponentials bit for
bit, the EAW and NLM twins against their Pallas kernels in interpret mode
(full frame, borders included), and the denoiseprofile op's plan,
coefficients and pixels.  Inputs come from numpy seeds and go to both
packages as the same float32 arrays."""

import dataclasses
import enum

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ansel_tpu
import ansel_tpu_torch
from ansel_tpu.io.synthetic import synth_raw
from ansel_tpu.kernels.eaw_pallas import (eaw_atrous_coarse_pallas,
                                          eaw_dn_coarse_pallas)
from ansel_tpu.kernels.nlm_pallas import nlm_pallas
from ansel_tpu.pixel import fastmath as ref_fastmath
from ansel_tpu.pixel import nlmeans as ref_nlmeans
from ansel_tpu_torch.kernels import eaw, nlm
from ansel_tpu_torch.pipeline import engine
from ansel_tpu_torch.pixel import fastmath, nlmeans

torch.set_num_threads(2)

# EAW: the twin and the Pallas kernel do the same float32 operations in
# tap order and the weights are bit-exact; XLA's CPU code may fuse a
# product into the following sum (measured 7.2e-7 on values up to 2.5).
EAW_TOL = 2e-6
# NLM: as EAW, and the Pallas kernel sums the offsets grouped by dx where
# the twin keeps the lattice order (measured 8.3e-7 on values below 1).
NLM_TOL = 2e-6
# denoiseprofile on the same input: the XLA path divides by the EAW
# weight sum where the kernel (and the twin) multiply by its inverse, and
# the thresholds come from whole-frame sums taken in another order; the
# output is in sensor units below ~1.5.
DP_TOL = 2e-5

A_B = {"a": (4e-4,) * 3, "b": (1e-5,) * 3}
DP_MODES = {
    "wavelets-y0u0v0": dict(A_B, strength=2.0),
    "wavelets-rgb": dict(A_B, strength=1.5, wavelet_color_mode=0),
    "nlm": dict(A_B, strength=1.0, mode=0),
}


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _sweep(lo, hi, stated):
    rng = np.random.default_rng(int(hi))
    return np.concatenate([np.asarray(stated, np.float32),
                           rng.uniform(lo, hi, 20000).astype(np.float32)])


@pytest.mark.parametrize("name,xs", [
    # 2^-x for 0 < x < 126; 126.99 and above fall below the denormal cut
    ("dt_fast_mexp2f", _sweep(0.0, 130.0, [0.0, 1e-30, 1e-7, 0.5, 1.0,
                                           125.99, 126.0, 126.99, 127.0,
                                           255.0, 300.0, 1e6])),
    ("fast_mexp2f", _sweep(0.0, 130.0, [0.0, 1e-30, 1e-7, 0.5, 1.0, 125.99,
                                        126.0, 126.99, 127.0, 128.0])),
    # e^x for x in [-100, 0]; below -93.3 the bits go denormal, then 0
    ("dt_fast_expf", _sweep(-110.0, 0.0, [0.0, -1e-30, -1e-7, -1.0, -87.0,
                                          -93.3, -100.0, -103.0, -110.0])),
])
def test_fastmath_is_bit_exact(name, xs):
    ref = getattr(ref_fastmath, name)(jnp.asarray(xs))
    got = getattr(fastmath, name)(torch.from_numpy(xs))
    assert np.array_equal(_bits(got.numpy()), _bits(ref))


@pytest.fixture(scope="module")
def edge_image():
    """(3, 48, 100): narrower than the scale-6 halo of 128 px, with an
    edge so the weights differ from the plain B3."""
    rng = np.random.default_rng(3)
    x = rng.random((3, 48, 100)).astype(np.float32)
    x[:, 10:30, 20:60] += 1.5
    return x


@pytest.mark.parametrize("scale", range(7))
@pytest.mark.parametrize("variant", ["dn", "atrous"])
def test_eaw_twin_matches_pallas_full_frame(edge_image, scale, variant):
    if variant == "dn":
        const = 1.0 / 1.25 ** (2 * scale)
        ref = eaw_dn_coarse_pallas(jnp.asarray(edge_image), scale, const,
                                   interpret=True)
    else:
        const = 3.0
        ref = eaw_atrous_coarse_pallas(jnp.asarray(edge_image), scale, const,
                                       interpret=True)
    got = eaw.eaw_coarse_reference(torch.from_numpy(edge_image), scale, const,
                                   eaw.DN if variant == "dn" else eaw.ATROUS)
    for g, r in zip(got, ref):
        assert g.shape == r.shape == edge_image.shape
        assert np.abs(g.numpy() - np.asarray(r)).max() <= EAW_TOL


def _nlm_args(variant, P):
    if variant == 1:
        cw, n = 0.1, 2 * P + 1
        return (0.005, cw * n * n, 1.0 / (1.0 + cw))
    return (0.02, 0.0, 1.0)


@pytest.mark.parametrize("variant,P,K,scattering", [
    (1, 1, 7, 0.0),     # config 2's NLM pass
    (0, 2, 3, 0.0),     # the iop weighting
    (1, 1, 4, 0.3),     # a scattered lattice
])
def test_nlm_twin_matches_pallas_full_frame(variant, P, K, scattering):
    img = np.random.default_rng(K).random((3, 40, 90)).astype(np.float32)
    offs = tuple(ref_nlmeans._scatter(1.0, scattering, dy, dx)
                 for dy in range(-K, K + 1) for dx in range(-K, K + 1))
    norm = (1.0, 0.5, 0.7)
    args = _nlm_args(variant, P)
    ref = np.asarray(nlm_pallas(jnp.asarray(img), offs, P, norm, *args,
                                variant=variant, interpret=True))
    got = nlm.nlm_reference(torch.from_numpy(img), offs, P, norm, *args,
                            variant).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= NLM_TOL


@pytest.mark.parametrize("K,scattering,scale,decimate", [
    (7, 0.0, 1.0, False), (4, 0.5, 1.0, False), (3, 0.2, 0.5, False),
    (5, 0.0, 1.0, True)])
def test_search_lattice_equals_reference(K, scattering, scale, decimate):
    got = nlmeans.search_offsets(K, scattering, scale, decimate)
    ref = []
    dec = 1 if decimate else 0
    for dy in range(-K, K + 1):
        for dx in range(-K, K + 1):
            if dec:
                dec += 1
                if dec & 1:
                    continue
            ref.append(ref_nlmeans._scatter(scale, scattering, dy, dx))
    assert got == ref


def test_wrappers_run_the_plain_versions_on_cpu(edge_image):
    x = torch.from_numpy(edge_image)
    before = (eaw.LAUNCHES, nlm.LAUNCHES)
    c, d = eaw.eaw_dn_coarse(x, 2, 0.5)
    rc, rd = eaw.eaw_coarse_reference(x, 2, 0.5, eaw.DN)
    assert torch.equal(c, rc) and torch.equal(d, rd)
    offs = nlmeans.search_offsets(2)
    got = nlm.nlm(x, offs, 1, (1.0, 1.0, 1.0), 0.01, 0.9, 1 / 1.1, 1)
    want = nlm.nlm_reference(x, offs, 1, (1.0, 1.0, 1.0), 0.01, 0.9,
                             1 / 1.1, 1)
    assert torch.equal(got, want)
    assert (eaw.LAUNCHES, nlm.LAUNCHES) == before
    with pytest.raises(ValueError):
        eaw.eaw_dn_coarse(torch.zeros((3, 8, 8), device="meta"), 0, 1.0)
    with pytest.raises(ValueError):
        nlm.nlm(torch.zeros((3, 8, 8), device="meta"), offs, 1,
                (1.0, 1.0, 1.0), 0.01, 0.0, 1.0, 0)


def _plain(v):
    if isinstance(v, enum.Enum):
        return v.value
    if dataclasses.is_dataclass(v):
        return tuple(_plain(getattr(v, f.name))
                     for f in dataclasses.fields(v))
    if isinstance(v, (tuple, list)):
        return tuple(_plain(x) for x in v)
    return v


def _pipes(params, h=64, w=200):
    _, meta, _ = synth_raw(h=h, w=w)
    hist = [("denoiseprofile", params), ("exposure", {"exposure": 0.5})]
    ref = ansel_tpu.Pipeline(
        meta, [ansel_tpu.HistoryItem(o, dict(p)) for o, p in hist])
    port = ansel_tpu_torch.Pipeline(
        meta, [ansel_tpu_torch.HistoryItem(o, dict(p)) for o, p in hist],
        device="cpu")
    i = [s.name for s in ref.stages].index("denoiseprofile")
    return ref, port, i


@pytest.mark.parametrize("mode", sorted(DP_MODES))
def test_denoiseprofile_plan_and_coeffs_equal_reference(mode):
    ref, port, i = _pipes(DP_MODES[mode])
    assert [s.name for s in port.stages] == [s.name for s in ref.stages]
    for p, r in zip(port.stages, ref.stages):
        assert _plain(p.plan.spec_in) == _plain(r.plan.spec_in), p.name
        assert _plain(p.plan.static) == _plain(r.plan.static), p.name
    pc, rc = port.coeffs()[i], ref.coeffs()[i]
    assert sorted(pc) == sorted(rc)
    for k in pc:
        assert np.array_equal(np.asarray(pc[k]), np.asarray(rc[k])), k


@pytest.fixture(scope="module")
def dp_outputs():
    """Each mode's denoiseprofile apply, both packages, on one camera-RGB
    input (gradients plus noise, so the thresholds bite)."""
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:64, 0:200].astype(np.float32)
    base = np.stack([0.2 + 0.5 * xx / 200, 0.3 + 0.4 * yy / 64,
                     0.25 + 0.2 * (xx + yy) / 264])
    x = np.clip(base + rng.normal(0, 0.03, base.shape), 0, None)
    x = x.astype(np.float32)
    out = {}
    for mode, params in DP_MODES.items():
        ref, port, i = _pipes(params)
        rs, ps = ref.stages[i], port.stages[i]
        want = np.asarray(rs.op.apply(jnp.asarray(x), ref.coeffs()[i],
                                      rs.plan, ref.ctx))
        c = engine.coeffs_to_device([port.coeffs()[i]], "cpu")[0]
        got = ps.op.apply(torch.from_numpy(x), c, ps.plan, port.ctx).numpy()
        out[mode] = (x, got, want, ps.plan.static)
    return out


@pytest.mark.parametrize("mode", sorted(DP_MODES))
def test_denoiseprofile_apply_matches_reference(dp_outputs, mode):
    x, got, want, static = dp_outputs[mode]
    assert got.shape == want.shape == x.shape
    assert np.isfinite(got).all()
    assert np.abs(got - x).mean() > 1e-3  # it denoised
    if static[3]:
        # NLM: the XLA path edge-pads the d2 plane, the kernel the image
        # (nlm_pallas' documented ring of P px)
        P = static[4]
        got, want = got[:, P:-P, P:-P], want[:, P:-P, P:-P]
    assert np.abs(got - want).max() <= DP_TOL


def test_denoiseprofile_refuses_a_row_sharded_plan(dp_outputs, monkeypatch):
    """A row-sharded plan (`shard_geom`), which denoiseprofile refused
    until the multi-device layer was ported, now plans and runs: with two
    shards of 32 rows and a 16-row halo (each window the whole frame)
    each shard sums detail^2 over the rows it owns and the axis's psum
    adds them: per scale, the whole frame's statistic within relative
    1e-5, and each shard's owned rows the unsharded op's output within
    DP_TOL."""
    from ansel_tpu_torch.ops import denoiseprofile as dp_mod
    from ansel_tpu_torch.parallel import mesh as mesh_mod

    x = dp_outputs["wavelets-y0u0v0"][0]
    _, port, i = _pipes(DP_MODES["wavelets-y0u0v0"])
    s = port.stages[i]
    c = engine.coeffs_to_device([port.coeffs()[i]], "cpu")[0]
    frame_sums, shard_sums = [], {}
    real_dec, real_psum = dp_mod.eaw_dn_decompose, mesh_mod.psum

    def dec(*args):
        out = real_dec(*args)
        if not mesh_mod.in_shard("sp"):
            frame_sums.append(out[2])
        return out

    def psum(v, axis):
        out = real_psum(v, axis)
        shard_sums.setdefault(mesh_mod.axis_index(axis), []).append(out)
        return out

    monkeypatch.setattr(dp_mod, "eaw_dn_decompose", dec)
    monkeypatch.setattr(mesh_mod, "psum", psum)
    whole = s.op.apply(torch.from_numpy(x), c, s.plan, port.ctx)
    port.ctx.notes["shard_geom"] = dict(axis="sp", n=2, Hs=32, halo=16,
                                        H=64, Hw=64)
    mesh = mesh_mod.make_mesh(2, spatial=2,
                              devices=[torch.device("cpu")] * 2)
    outs = mesh_mod.run_shards(
        mesh, "sp", lambda xs: s.op.apply(xs, c, s.plan, port.ctx),
        [(torch.from_numpy(x),)] * 2)
    assert len(frame_sums) == s.plan.static[0] >= 4
    for k in (0, 1):
        assert len(shard_sums[k]) == len(frame_sums)
        for got, want in zip(shard_sums[k], frame_sums):
            assert torch.allclose(got, want, rtol=1e-5, atol=0)
        rows = slice(32 * k, 32 * (k + 1))
        assert (outs[k][:, rows] - whole[:, rows]).abs().max() <= DP_TOL
