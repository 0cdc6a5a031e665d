"""The host-side launch plans of the port's redesigned CUDA kernels, on the
CPU: the diffuse iteration's fusion groups and shared memory per number
of scales, the NLM kernel's path (resident search window or streamed
offsets) per patch radius and reach, and the sepblur strip's form per tap
count and dilation, with every tap count and dilation that the port's
callers of `sep_blur` can ask for.  The libraries check each planned size
against their own on the card (tests/test_torch_cuda.py)."""

import math

import numpy as np
import pytest
import torch

import ansel_tpu_torch as port
from ansel_tpu_torch.io import configs
from ansel_tpu_torch.io.synthetic import synth_raw
from ansel_tpu_torch.kernels import diffuse, nlm, sepblur
from ansel_tpu_torch.kernels import highlights_laplacian as hl
from ansel_tpu_torch.pixel import blur
from ansel_tpu_torch.pixel.nlmeans import search_offsets

torch.set_num_threads(2)

SMEM_227K = 232448   # shared memory a block may have on an H100 (sm_90)


def _groups(plan, kind):
    """Scale lists of the plan's launches of one kind, in launch order."""
    out = []
    for k, first, count, _ in plan:
        if k == kind:
            step = 1 if kind == diffuse.DECOMPOSE else -1
            out.append(list(range(first, first + step * count, step)))
    return out


@pytest.mark.parametrize("scales", range(1, diffuse.MAX_SCALES + 1))
def test_diffuse_plan_covers_every_scale_once(scales):
    plan = diffuse.launch_plan(scales)
    kinds = [k for k, *_ in plan]
    # every decompose launch comes before the first PDE launch
    assert kinds == sorted(kinds)
    dec = _groups(plan, diffuse.DECOMPOSE)
    pde = _groups(plan, diffuse.PDE)
    assert sum(dec, []) == list(range(scales))
    assert sum(pde, []) == list(range(scales - 1, -1, -1))
    # the fine scales share one launch of each kind, coarser ones run alone
    fine = min(scales, diffuse.FUSED_SCALES)
    assert dec[0] == list(range(fine))
    assert pde[-1] == list(range(fine - 1, -1, -1))
    assert all(len(g) == 1 for g in dec[1:] + pde[:-1])
    for _, _, _, smem in plan:
        assert 0 < smem <= SMEM_227K == diffuse.MAX_SMEM


def test_diffuse_plan_at_config3():
    """Config 3 runs S = 5: 6 launches (15 before the redesign), with the
    shared bytes of each block written out from the kernel's buffers."""
    th, tw = diffuse.TILE_H, diffuse.TILE_W
    fine_dec = (th + 28) * (tw + 28) + (th + 24) * (tw + 28) \
        + (th + 24) * (tw + 24)
    fine_pde = 3 * (th + 14) * (tw + 14) + 2 * (th + 6) * (tw + 6) \
        + (th + 2) * (tw + 2)
    assert diffuse.launch_plan(5) == [
        (0, 0, 3, 4 * fine_dec),
        (0, 3, 1, 4 * ((th + 32) * (tw + 32) + th * (tw + 32))),
        (0, 4, 1, 4 * ((th + 64) * (tw + 64) + th * (tw + 64))),
        (1, 4, 1, 4 * 3 * (th + 32) * (tw + 32)),
        (1, 3, 1, 4 * 3 * (th + 16) * (tw + 16)),
        (1, 2, 3, 4 * fine_pde)]


# config 2's lattice (K 7) and a scattered one (K 7, scattering 1.0)
REACHES = sorted({0, 1, 2, 7, 15, 20, 21, 40, 86, 200, 32767,
                  nlm._reach(search_offsets(7, 1.0))})


@pytest.mark.parametrize("P", range(nlm.MAX_P + 1))
def test_nlm_plan_fits_every_patch_and_reach(P):
    for reach in REACHES:
        resident, smem = nlm.plan(P, reach)
        q = P + reach
        window = (nlm.TILE_H + 2 * q) * (nlm.tile_w(P) + 2 * q) * 16
        assert resident == (window <= nlm.RESIDENT_MAX)
        assert smem == (window if resident else 2 * (nlm.TILE_H + 2 * P)
                        * (nlm.tile_w(P) + 2 * P) * 16)
        assert 0 < smem <= SMEM_227K == nlm.MAX_SMEM
    # the reach decides the path: resident up to some reach, then streamed
    paths = [nlm.plan(P, r)[0] for r in REACHES]
    assert paths == sorted(paths, reverse=True) and paths[0]


def test_nlm_plan_for_config2_and_the_scattered_lattice():
    offs = search_offsets(7, 0.0)
    assert len(offs) == 225 and nlm._reach(offs) == 7
    # (32 + 16) x (60 + 16) pixels of 16 bytes: the whole search window
    assert nlm.plan(1, 7) == (True, 48 * 76 * 16)
    scattered = search_offsets(7, 1.0)
    assert nlm._reach(scattered) > 80
    assert nlm.plan(1, nlm._reach(scattered)) == (False, 2 * 34 * 62 * 16)


def _recorded_blurs(history, h, w):
    """(taps, dilation) of every sep_blur call of a config's pipe on the
    CPU at a small frame."""
    raw, meta, _ = synth_raw(h=h, w=w, kind="gradients")
    pipe = port.compile_pipeline(meta, history, device="cpu")
    calls, real = set(), sepblur.sep_blur
    sepblur.sep_blur = lambda x, taps, d=1: (
        calls.add((len(taps), d)) or real(x, taps, d))
    try:
        pipe.output_array(raw)
    finally:
        sepblur.sep_blur = real
    return calls


@pytest.fixture(scope="module")
def caller_pairs():
    """Every (taps, dilation) the port's callers of sep_blur can produce:
    the highlights Laplacian at each of its MAX_NUM_SCALES dilations, the
    box blur's windows up to the radius it sends there, the FIR Gaussian
    up to the sigma it takes, and what configs 2, 3 and 7 ask for."""
    pairs = {(5, 1 << s) for s in range(hl.MAX_NUM_SCALES)}
    pairs |= {(2 * r + 1, 1) for r in range(1, 8)}               # box_blur
    pairs.add((2 * math.ceil(4.0 * 4.0) + 1, 1))       # gaussian_blur, sigma 4
    for n in (2, 3, 7):
        pairs |= _recorded_blurs(configs.history(n), 96, 128)
    return sorted(pairs)


def test_sepblur_callers_are_known(caller_pairs):
    assert (5, 512) in caller_pairs and (33, 1) in caller_pairs
    # every recorded pair is one of the kinds listed above
    assert all(n == 5 or d == 1 for n, d in caller_pairs)


@pytest.mark.parametrize("kind", ["laplacian", "d1"])
def test_sepblur_admits_every_caller_pair(caller_pairs, kind):
    pairs = [(n, d) for n, d in caller_pairs if (d > 1) == (kind == "laplacian")]
    assert pairs
    for n, d in pairs:
        gather, smem = sepblur.plan(n, d)
        assert gather == (d >= sepblur.TILE_W)
        assert 0 < smem <= SMEM_227K == sepblur.MAX_SMEM, (n, d)


@pytest.mark.parametrize("d", [1, 64, 127, 128, 512, 4096])
def test_sepblur_strip_forms(d):
    gather, smem = sepblur.plan(5, d)
    cols = 5 * 128 if d >= 128 else 128 + 4 * d
    assert (gather, smem) == (d >= 128, 8 * cols * 4)
    # from d = TILE_W on, 20 KB whatever the reach
    assert smem <= 20480


def test_sepblur_refuses_only_strips_over_227k():
    # the widest strips the kernel takes, and the first it does not
    assert sepblur.plan(sepblur.MAX_TAPS, 1)[1] <= SMEM_227K
    assert sepblur.plan(201, 35)[1] <= SMEM_227K < sepblur.plan(201, 36)[1]
    assert sepblur.plan(55, 1000)[1] <= SMEM_227K < sepblur.plan(57, 1000)[1]


def test_box_and_gaussian_blurs_stay_within_the_listed_taps(monkeypatch):
    """The limits the caller list above rests on: box_blur sends radii up
    to 7 to sep_filter, gaussian_blur sigmas up to 4 at truncate 4."""
    x = torch.from_numpy(np.random.default_rng(0).random((2, 40, 50))
                         .astype(np.float32))
    seen, real = [], sepblur.sep_blur
    monkeypatch.setattr(sepblur, "sep_blur", lambda x, taps, d=1: (
        seen.append((len(taps), d)) or real(x, taps, d)))
    for r in range(1, 12):
        blur.box_blur(x, r)
    for sigma in (0.5, 1.0, 2.5, 4.0, 4.5, 9.0):
        blur.gaussian_blur(x, sigma)
    assert max(n for n, _ in seen) == 33 and {d for _, d in seen} == {1}
