"""The port's Markesteijn X-Trans demosaic (ansel_tpu_torch/kernels/
markesteijn.py) against ansel_tpu on the CPU: the Pallas kernel's tile
body evaluated op by op over its whole grid (exact), the Pallas kernel in
interpret mode (a statistical gate: its jit lets XLA fuse), the scalar
mirror of the reference, and the demosaic op's X-Trans planning.  Inputs
come from numpy seeds and go to both packages as the same float32 arrays."""

import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from mirrors import markesteijn_ref as mirror
from test_markesteijn_mirror import XTRANS6 as MIRROR_XTRANS6
from test_markesteijn_mirror import _mosaic as mirror_mosaic
from test_torch_rcd import _reach

import ansel_tpu
import ansel_tpu_torch
from ansel_tpu.io.synthetic import synth_raw
from ansel_tpu.kernels import markesteijn_pallas as mp
from ansel_tpu_torch import interop
from ansel_tpu_torch.io import configs
from ansel_tpu_torch.kernels import markesteijn as mk

torch.set_num_threads(2)

P6 = configs.XTRANS6


def _mosaic(h, w, seed, noisy):
    """A smooth scene (gradients and a sine) through XTRANS6, or the same
    plus uniform noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    scene = np.stack([0.2 + 0.6 * xx / w, 0.3 + 0.5 * yy / h,
                      0.25 + 0.2 * np.sin(xx / 7.0)])
    if noisy:
        scene = scene + 0.3 * rng.random(scene.shape)
    sel = np.asarray(P6).reshape(6, 6)[yy % 6, xx % 6]
    return np.take_along_axis(scene, sel[None], 0)[0].astype(np.float32)


def _pallas_op_by_op(raw, passes, monkeypatch):
    """xtrans_markesteijn_pallas's grid run by hand: each tile's buffer cut
    from the same edge-padded frame and its `_mark_tile` evaluated one
    operation at a time (pltpu.roll is jnp.roll there), so no compiler
    fuses or reassociates anything."""
    monkeypatch.setattr(mp, "pltpu", types.SimpleNamespace(
        roll=lambda a, shift, axis: jnp.roll(a, shift, axis)))
    h, w = raw.shape
    th, tw, bh, bw = mp.TILE_H, mp.TILE_W, mp.BORDER_H, mp.BORDER_W
    nh, nw = -(-h // th), -(-w // tw)
    cp = np.pad(raw, ((bh, nh * th + bh - h), (bw, nw * tw + bw - w)),
                mode="edge")
    out = np.zeros((3, nh * th, nw * tw), np.float32)
    for i in range(nh):
        for j in range(nw):
            buf = cp[i * th:i * th + mp.BUF_H, j * tw:j * tw + mp.BUF_W]
            planes = mp._mark_tile(jnp.asarray(buf), P6, passes)
            for c, v in enumerate(planes):
                out[c, i * th:(i + 1) * th, j * tw:(j + 1) * tw] = \
                    np.asarray(v)[bh:bh + th, bw:bw + tw]
    monkeypatch.undo()
    return np.maximum(out[:, :h, :w], 0.0)


def _twin(raw, passes):
    return mk.xtrans_markesteijn_reference(torch.from_numpy(raw), P6,
                                           passes).numpy()


# 47 x 389 spans one row of 2 Pallas tiles and neither side is a multiple
# of 6 or of the tile; 53 x 77 is smaller than one tile
@pytest.mark.parametrize("h,w,passes,noisy", [
    (47, 389, 1, False),
    (47, 389, 1, True),
    (53, 77, 3, False),
    (53, 77, 3, True),
])
def test_twin_equals_the_pallas_kernel_op_by_op(h, w, passes, noisy,
                                                monkeypatch):
    raw = _mosaic(h, w, seed=h + w + passes, noisy=noisy)
    want = _pallas_op_by_op(raw, passes, monkeypatch)
    got = _twin(raw, passes)
    assert got.shape == want.shape == (3, h, w)
    assert np.array_equal(got, want)


# XLA jits the interpret-mode kernel and fuses it: it contracts products
# into FMAs and turns divisions by 3 into products, which moves the
# discrete direction choices at some pixels (smooth mosaics have many near
# ties).  Measured: the median value is equal; the 99th percentile of the
# error 6.7e-3 (smooth, 1 pass) and 1.2e-7 (noisy, 1 and 3 passes); the
# mean 4.7e-4, 2.8e-5 and 5.0e-5.
@pytest.fixture(scope="module")
def interpret_pairs():
    pairs = []
    for h, w, passes, noisy in ((96, 384, 1, False), (96, 384, 1, True),
                                (48, 200, 3, True)):
        raw = _mosaic(h, w, seed=7 * h + w, noisy=noisy)
        want = np.asarray(mp.xtrans_markesteijn_pallas(
            jnp.asarray(raw), P6, passes=passes, interpret=True))
        pairs.append(((h, w, passes, noisy), _twin(raw, passes), want))
    return pairs


@pytest.mark.parametrize("case", [0, 1, 2])
def test_twin_matches_pallas_interpret(interpret_pairs, case):
    _, got, want = interpret_pairs[case]
    err = np.abs(got - want)
    assert got.shape == want.shape
    assert np.median(err) == 0.0
    assert np.percentile(err, 99) < 2e-2
    assert err.mean() < 2e-3


@pytest.mark.parametrize("passes", [1, 3])
def test_twin_matches_reference_mirror(passes):
    """The gate of tests/test_markesteijn_mirror.py."""
    raw = mirror_mosaic()
    want = mirror.markesteijn(raw, MIRROR_XTRANS6, passes=passes)
    got = mk.xtrans_markesteijn_reference(
        torch.from_numpy(raw), tuple(np.asarray(MIRROR_XTRANS6).reshape(-1)),
        passes).numpy()
    got = np.moveaxis(got, 0, -1)
    m = 16
    gi, wi = got[m:-m, m:-m], want[m:-m, m:-m]
    rel = np.abs(gi - wi) / np.maximum(np.abs(wi), 0.05)
    assert np.isfinite(gi).all()
    assert np.median(rel) < 1e-3, np.median(rel)
    assert np.percentile(rel, 95) < 0.02, np.percentile(rel, 95)
    assert rel.mean() < 5e-3, rel.mean()


def test_hex_tables_equal_the_jax_package():
    from ansel_tpu.kernels.markesteijn import build_hex_tables

    for pattern in (P6, tuple(np.roll(np.asarray(P6).reshape(6, 6), 1, 1)
                              .reshape(-1))):
        assert mk.build_hex_tables(pattern) == build_hex_tables(pattern)


def test_wrapper_runs_the_plain_version_on_cpu():
    x = torch.from_numpy(_mosaic(30, 42, seed=3, noisy=True))
    before = mk.LAUNCHES
    out = mk.xtrans_markesteijn(x, P6, 3)
    assert mk.LAUNCHES == before
    assert torch.equal(out, mk.xtrans_markesteijn_reference(x, P6, 3))


def test_wrapper_refuses_other_devices():
    with pytest.raises(ValueError):
        mk.xtrans_markesteijn(torch.zeros((12, 12), device="meta"), P6)


def _xtrans_meta():
    raw, meta, scene = synth_raw(h=60, w=96)
    return configs.remosaic_xtrans(meta, scene)


def _plans(pkg, meta, params):
    pipe = pkg.Pipeline(meta, [pkg.HistoryItem("demosaic", params)],
                        **({"device": "cpu"} if pkg is ansel_tpu_torch
                           else {}))
    st = next(s for s in pipe.stages if s.name == "demosaic")
    return st.plan.static, pipe.coeffs()[pipe.stages.index(st)]


# bench config 4's 1024 | 2 lacks the X-Trans flag: Markesteijn 1-pass
# (0x1001 = 4097), not the 3 passes its label says; RCD on X-Trans too
@pytest.mark.parametrize("method,planned", [
    (1024 | 2, 0x1001), (0x1001, 0x1001), (0x1002, 0x1002), (5, 0x1001),
    (0x1003, 0x1003)])
def test_xtrans_plan_and_coeffs_equal_the_jax_package(method, planned):
    _, meta = _xtrans_meta()
    params = {"demosaicing_method": method, "green_eq": 1}
    got = _plans(ansel_tpu_torch, meta, params)
    want = _plans(ansel_tpu, meta, params)
    assert got == want
    assert got[0][0] == planned and got[0][1] == 0   # green_eq forced off


@pytest.mark.parametrize("method,passes", [(1024 | 2, 1), (0x1002, 3)])
def test_demosaic_runs_the_planned_passes(method, passes, monkeypatch):
    raw, meta = _xtrans_meta()
    seen = []
    real = mk.xtrans_markesteijn

    def spy(x, pattern6, p):
        seen.append((tuple(pattern6), p))
        return real(x, pattern6, p)

    monkeypatch.setattr(mk, "xtrans_markesteijn", spy)
    pipe = ansel_tpu_torch.compile_pipeline(
        meta, [ansel_tpu_torch.HistoryItem(
            "demosaic", {"demosaicing_method": method})], device="cpu")
    out = pipe.output_array(raw)
    assert seen == [(P6, passes)]
    assert out.shape == (3, 60, 96) and np.isfinite(out).all()


def test_xtrans_passthrough_stacks_the_mosaic():
    """0x1003 through the demosaic stage of both packages on one mosaic."""
    _, meta = _xtrans_meta()
    params = {"demosaicing_method": 0x1003}
    port = ansel_tpu_torch.Pipeline(
        meta, [ansel_tpu_torch.HistoryItem("demosaic", params)], device="cpu")
    ref = ansel_tpu.Pipeline(meta, [ansel_tpu.HistoryItem("demosaic", params)])
    i = [s.name for s in port.stages].index("demosaic")
    assert [s.name for s in ref.stages].index("demosaic") == i
    x = _mosaic(60, 96, seed=1, noisy=True)
    coeffs = interop.coeffs_from_reference(port.coeffs(), "cpu")
    got = port.trace_fn(i, i + 1)(torch.from_numpy(x), coeffs[i:i + 1])
    want = ref.trace_fn(i, i + 1)(jnp.asarray(x), ref.coeffs()[i:i + 1])
    assert got.shape == (3, 60, 96)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("passes", [1, 3])
def test_reach_is_within_the_kernel_halo(passes):
    """A mosaic pixel at each of the 36 phases of the X-Trans period moves
    no output farther than the halo the kernel's plan loads (the plan
    derives it from the stencils' reads; perturbing shows less)."""
    rng = np.random.default_rng(passes)
    x = torch.from_numpy(rng.random((72, 72)).astype(np.float32))
    halo = mk.kernel_plan(P6, passes).halo
    far = [_reach(lambda m: mk.xtrans_markesteijn_reference(m, P6, passes),
                  x, 30 + py, 30 + px) for py in range(6) for px in range(6)]
    assert 0 < max(far) <= halo


def _garbage_but(planes, d, rng):
    """The buffers of a list with every one but d replaced by noise."""
    return [p if i == d else torch.from_numpy(
        rng.uniform(-5, 5, p.shape).astype(np.float32))
        for i, p in enumerate(planes)]


def _chains(x, passes, d=None, seed=0):
    """The twin's direction buffers (G, R, B, drv) before the vote; with d
    given, every other buffer is replaced by noise after each step."""
    rng = np.random.default_rng(seed)

    def keep(planes):
        return planes if d is None else _garbage_but(planes, d, rng)

    h, w = x.shape
    xp = F.pad(x[None, None], (mk.PAD,) * 4, mode="replicate")[0, 0]
    geo = mk._Geo(P6, h + 2 * mk.PAD, w + 2 * mk.PAD, x.device)
    gvals = [geo.hex_read(xp, k) for k in range(6)]
    gmin = functools.reduce(torch.minimum, gvals)
    gmax = functools.reduce(torch.maximum, gvals)
    G = keep(mk._green_dirs(geo, xp, gmin, gmax))
    R, B = (keep(p) for p in mk._one_set(geo, xp, G))
    if passes == 3:
        G2, R2, B2 = G, R, B
        for _ in range(2):
            G2 = keep(mk._green_recalc(geo, xp, G2, R2, B2, gmin, gmax))
            R2, B2 = (keep(p) for p in mk._one_set(geo, xp, G2))
        G, R, B = G + G2, R + R2, B + B2
    drv = [mk._derivative(G, R, B, i) for i in range(len(G))]
    return G, R, B, drv


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("d", range(4))
def test_direction_buffers_are_independent_before_the_vote(passes, d):
    """Buffer d's G, R, B and derivative (and, for 3 passes, those of the
    last set's buffer d) are unchanged when every other buffer is noise
    after every step: the kernel can run the four chains one at a time."""
    x = torch.from_numpy(_mosaic(42, 54, seed=11, noisy=True))
    want = _chains(x, passes)
    got = _chains(x, passes, d=d, seed=d)
    for i in ((d,) if passes == 1 else (d, 4 + d)):
        for g, w in zip(got, want):
            assert torch.equal(g[i], w[i])
    # the noise reached the other buffers
    assert not torch.equal(got[0][(d + 1) % 4], want[0][(d + 1) % 4])
