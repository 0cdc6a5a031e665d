"""The host-side launch plans of the port's redesigned CUDA kernels, on the
CPU: the diffuse iteration's fusion groups and shared memory per number
of scales, the NLM kernel's path (resident search window or streamed
offsets) per patch radius and reach, the sepblur strip's form, rows and
template per tap count and dilation, with every tap count and dilation
that the port's callers of `sep_blur` can ask for, the EAW tile per
scale, the colour chain's choice between a specialised program and
the interpreter, the tiles, margins and shared bytes of the RCD and
Markesteijn kernels, the IIR kernel's split of each line into a forward
and a backward thread (against the twin's one-thread recursion) and its
blocks, and the grid slice's row and column tables, tiles and staged
slabs.  The libraries check each planned size, and the list of
specialised programs, against their own on the card
(tests/test_torch_cuda.py)."""

import math

import numpy as np
import pytest
import torch

import ansel_tpu_torch as port
from ansel_tpu_torch.io import configs
from ansel_tpu_torch.io.synthetic import synth_raw
from ansel_tpu_torch.kernels import (bgrid, diffuse, eaw, iir, markesteijn,
                                     nlm, rcd, sepblur)
from ansel_tpu_torch.kernels import highlights_laplacian as hl
from ansel_tpu_torch.kernels import pointwise as pw
from ansel_tpu_torch.pixel import blur
from ansel_tpu_torch.pixel.nlmeans import search_offsets

torch.set_num_threads(2)

SMEM_227K = 232448   # shared memory a block may have on an H100 (sm_90)
SMEM_SM = 233472     # shared memory of an SM; CUDA reserves 1 KB of it a block
# frames the main paths demosaic: configs 1, 2 and 7; config 3; config 4
# (6000 columns padded to 6016 by its pipe, and unpadded); a tiny one
DEMOSAIC_FRAMES = [(4000, 6016), (5504, 8320), (4000, 6000), (5, 7),
                   (33, 65)]


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
    the highlights Laplacian at each of its MAX_NUM_SCALES dilations,
    rawdenoise's 3-tap hat wavelet at each of its BANDS dilations, the
    box blur's windows up to the radius it sends there, the FIR Gaussian
    up to the sigma it takes, and what configs 2, 3, 7 and 8 ask for."""
    from ansel_tpu_torch.ops import rawdenoise

    pairs = {(5, 1 << s) for s in range(hl.MAX_NUM_SCALES)}
    pairs |= {(3, 1 << lev) for lev in range(rawdenoise.BANDS)}
    pairs |= {(2 * r + 1, 1) for r in range(1, 8)}               # box_blur
    pairs.add((2 * math.ceil(4.0 * 4.0) + 1, 1))       # gaussian_blur, sigma 4
    for n in (2, 3, 7, 8):
        pairs |= _recorded_blurs(configs.history(n), 96, 128)
    return sorted(pairs)


def test_sepblur_callers_are_known(caller_pairs):
    assert (5, 512) in caller_pairs and (33, 1) in caller_pairs
    assert (3, 16) in caller_pairs
    # every recorded pair is one of the kinds listed above
    assert all(n in (3, 5) or d == 1 for n, d in caller_pairs)
    assert all(d <= 16 for n, d in caller_pairs if n == 3)


@pytest.mark.parametrize("kind", ["laplacian", "d1"])
def test_sepblur_admits_every_caller_pair(caller_pairs, kind):
    pairs = [(n, d) for n, d in caller_pairs
             if (d > 1) == (kind == "laplacian")]
    assert pairs
    for n, d in pairs:
        p = sepblur.plan(n, d)
        assert p.two_pass == (d >= sepblur.TWO_PASS)
        # every caller's blur runs a template: on the strip, its vertical
        # window in registers over a full block of rows
        assert p.fixed and p.rows == (1 if p.two_pass else
                                      sepblur.rows_of(n)), (n, d)
        assert 0 <= p.smem <= SMEM_227K == sepblur.MAX_SMEM, (n, d)


@pytest.mark.parametrize("d", [1, 64, 127, 128, 512, 4096])
def test_sepblur_strip_forms(d):
    p = sepblur.plan(5, d)
    if d >= 256:
        # two passes through a scratch plane, no shared memory
        assert p == (True, 1, 256, 0, 0, True)
    else:
        # the least multiple of 256 columns that holds 4d + 256
        strip = -(-(4 * d + 256) // 256) * 256
        assert p == (False, 16, strip - 4 * d, strip, 16 * strip * 4, True)
        assert p.cols >= 256 and p.strip % sepblur.THREADS == 0
    # 80 KB at most, whatever the reach
    assert p.smem <= 81920


def test_sepblur_refuses_only_strips_over_227k():
    # the widest strips the kernel takes, and the first it does not: the
    # rows of a block shrink to fit, down to one
    assert sepblur.plan(sepblur.MAX_TAPS, 1).rows == 16
    last, first = sepblur.plan(513, 113), sepblur.plan(513, 114)
    assert last.rows == 1 and last.smem == SMEM_227K and first.rows == 0
    assert sepblur.plan(201, 36) == (False, 7, 480, 7680, 7 * 7680 * 4, False)
    # every template's strip fits below d = 256, at 16, 8 or 4 rows
    for n in range(3, sepblur.MAX_FIXED + 1, 2):
        p = sepblur.plan(n, sepblur.TWO_PASS - 1)
        assert p.fixed and p.rows == sepblur.rows_of(n) and p.smem <= SMEM_227K
    assert [sepblur.rows_of(n) for n in (3, 9, 11, 25, 27, 33)] == [
        16, 16, 8, 8, 4, 4]
    # from d = 256 on, two passes: no reach and no tap count is refused
    assert sepblur.plan(513, 1000) == (True, 1, 256, 0, 0, False)
    assert sepblur.plan(7, 256).two_pass and not sepblur.plan(7, 255).two_pass


@pytest.mark.parametrize("h", [1, 7, 100])
@pytest.mark.parametrize("d", [1, 3, 50, 300])
def test_sepblur_smem_by_rows_of_a_class(h, d):
    """A launch reserves the strip for no more rows than a residue class
    has."""
    for n in (5, 33, 201):
        p = sepblur.plan(n, d)
        got = sepblur.smem_bytes(p, h, d)
        assert got == 4 * p.strip * min(p.rows, -(-h // d)) <= p.smem


@pytest.mark.parametrize("scale", range(0, 25))
def test_eaw_plan_fits_every_scale(scale):
    d = 1 << scale
    gather, smem = eaw.plan(scale)
    assert gather == (d >= eaw.TILE_W)
    cols = 5 * eaw.TILE_W if gather else eaw.TILE_W + 4 * d
    assert smem == 16 * (eaw.TILE_H + 4) * cols
    assert 0 < smem <= 61440 < SMEM_227K == eaw.MAX_SMEM


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


def _config_chains(config):
    """Config `config`'s compiled pipe on a small CPU frame and its chain
    steps (i, j, Chain)."""
    raw, meta, scene = synth_raw(h=48, w=72, kind="gradients")
    if config in configs.XTRANS_CONFIGS:
        raw, meta = configs.remosaic_xtrans(meta, scene)
    pipe = port.compile_pipeline(meta, configs.history(config), device="cpu")
    return pipe, [(i, j, c) for kind, i, j, c in pipe.steps
                  if kind == "chain"]


@pytest.mark.parametrize("config", [1, 2, 3, 4, 7, 10, 12])
def test_pack_chain_picks_a_specialised_program(config):
    """Every chain the config builds has a kernel of its own: its
    (opcode, const offset) sequence is the chosen entry of FIXED, and the
    ints and consts that kernel takes by value are the interpreter's."""
    _, chains = _config_chains(config)
    assert chains
    for _, _, c in chains:
        recs = c.prog.view(-1, pw.RECORD).tolist()
        assert c.fixed >= 0
        assert pw.FIXED[c.fixed] == tuple((r[0], r[1]) for r in recs)
        assert list(c.host_ints) == [v for r in recs for v in r[2:]]
        assert list(c.host_consts) == c.consts.tolist()


def test_pack_chain_fixed_consts_hold_config10():
    """Config 10's second chain (colorbalancergb's 169 consts, three
    curves) needs more than the 256 consts the fixed programs once took:
    they take FIXED_CONSTS (4 KB), inside CUDA's 32764-byte parameters."""
    _, chains = _config_chains(10)
    sizes = [c.consts.numel() for _, _, c in chains]
    assert sizes[1] > 256 and max(sizes) <= pw.FIXED_CONSTS
    args = 8 + 8 + 8 + 4 + 4 * pw.MAX_STAGES * pw.STAGE_INTS \
        + 4 * pw.FIXED_CONSTS
    assert args <= 32764


def test_pack_chain_interprets_an_unlisted_program():
    """A sequence outside FIXED runs the interpreter.  filmicrgb alone is
    config 12's program (its stage after highlight reconstruction);
    channelmixerrgb alone is in no config."""
    pipe, ((i, j, c),) = _config_chains(1)
    specs = [pipe.pipe._chain_spec(s) for s in pipe.pipe.stages[i:j]]
    coeffs = [k for _, k, _ in c.stages]
    assert pw.pack_chain(specs, coeffs, "cpu").fixed == c.fixed >= 0
    assert pw.pack_chain(specs[:-1], coeffs[:-1], "cpu").fixed == -1
    assert pw.pack_chain(specs[::-1], coeffs[::-1], "cpu").fixed == -1
    ops = [sp.opcode for sp in specs]
    agx = ops.index(pw.OP_FILMIC_AGX)
    assert pw.FIXED[pw.pack_chain(specs[agx:agx + 1], coeffs[agx:agx + 1],
                                  "cpu").fixed] == ((pw.OP_FILMIC_AGX, 0),)
    mix = ops.index(pw.OP_CHANNELMIXERRGB)
    assert pw.pack_chain(specs[mix:mix + 1], coeffs[mix:mix + 1],
                         "cpu").fixed == -1


def _covers_once(h, w, blocks_y, blocks_x, th, tw):
    """Each pixel of an (h, w) frame lies in exactly one block's tile."""
    count = np.zeros((h, w), np.int32)
    for i in range(blocks_y):
        for j in range(blocks_x):
            count[i * th:(i + 1) * th, j * tw:(j + 1) * tw] += 1
    assert blocks_y * th >= h > (blocks_y - 1) * th
    assert blocks_x * tw >= w > (blocks_x - 1) * tw
    return bool((count == 1).all())


# RCD's steps: each intermediate and the offsets it reads of another
# (csrc/rcd.cu): the output reads r_nb/b_nb 3 px away, g 2, vh_disc at
# the pixel; and the planes that hold them in turn
RCD_READS = {
    "out": {"r_nb": 3, "b_nb": 3, "g": 2, "vh_disc": 0},
    "r_nb": {"c": 3, "g": 2, "pq_disc": 0},
    "b_nb": {"c": 3, "g": 2, "pq_disc": 0},
    "pq_disc": {"pq_dir": 1}, "pq_dir": {"hp": 1, "hq": 1},
    "hp": {"c": 3}, "hq": {"c": 3},
    "g": {"c": 4, "lpf": 2, "vh_disc": 0}, "vh_disc": {"vh_dir": 1},
    "vh_dir": {"hv": 1, "hh": 1}, "hv": {"c": 3}, "hh": {"c": 3},
    "lpf": {"c": 1},
}
RCD_PLANES = [["c"], ["hv", "vh_disc"], ["hh", "lpf", "hp", "pq_disc"],
              ["vh_dir", "g"], ["hq", "r_nb"], ["pq_dir", "b_nb"]]


def test_rcd_margins_follow_from_its_reads():
    """The margin of each intermediate is the farthest any later step
    reads it; the mosaic's is RCD's reach, the halo a block loads; each
    shared plane is as wide as the widest intermediate it holds."""
    need = {"out": 0}
    for step in RCD_READS:   # listed consumers first
        for src, off in RCD_READS[step].items():
            need[src] = max(need.get(src, 0), need[step] + off)
    assert need["c"] == rcd.HALO == rcd.MARGINS[0] == 10
    assert [max(need[v] for v in plane) for plane in RCD_PLANES] == \
        list(rcd.MARGINS)


@pytest.mark.parametrize("hw", DEMOSAIC_FRAMES)
def test_rcd_plan_tiles_every_pixel_once(hw):
    by, bx, smem = rcd.launch_plan(*hw)
    assert _covers_once(*hw, by, bx, rcd.TILE_H, rcd.TILE_W)
    # six planes, three blocks an SM
    assert smem == 4 * sum((rcd.TILE_H + 2 * m) * (rcd.TILE_W + 2 * m)
                           for m in rcd.MARGINS) == 66224
    assert 3 * (smem + 1024) <= SMEM_SM and smem <= SMEM_227K
    assert rcd.THREADS % 32 == 0


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("hw", DEMOSAIC_FRAMES)
def test_markesteijn_plan_tiles_every_pixel_once(hw, passes):
    by, bx, plan = markesteijn.launch_plan(*hw, configs.XTRANS6, passes)
    assert _covers_once(*hw, by, bx, markesteijn.TILE_H, markesteijn.TILE_W)
    assert plan.threads == markesteijn.THREADS[passes]
    assert 0 < plan.smem <= SMEM_227K == markesteijn.MAX_SMEM
    if passes == 1:   # two blocks an SM
        assert 2 * (plan.smem + 1024) <= SMEM_SM


@pytest.mark.parametrize("passes", [1, 3])
def test_markesteijn_plan_sizes_every_plane(passes):
    """The margins the plan derives for XTRANS6: each step's, the planes
    as wide as the widest step that writes them (R/B also the green step,
    which writes the first set's base), the mosaic's halo the widest
    read, the guard the farthest read past a plane, the counts and the
    kept values fitting where the two groups' G, R and B were, and the
    shared bytes written out."""
    plan = markesteijn.kernel_plan(configs.XTRANS6, passes)
    steps = dict(zip(markesteijn.STEPS[passes], plan.steps))
    mx, mg, mrb = plan.planes
    assert mx == plan.halo == (11 if passes == 1 else 23)
    assert mg == max(max(v) for k, v in steps.items() if k[0] in "GA")
    assert mrb == max(max(v) for k, v in steps.items() if k[0] in "SOF"
                      or k == "G1")
    assert all(m <= mx for m in plan.planes)
    # the green step covers the first set's solitary-green step
    assert all(g >= s_ for g, s_ in zip(steps["G1"], steps["S1"]))
    # the last set's final R/B reach the derivatives' 3 px and one more
    assert steps[markesteijn.STEPS[passes][-1]] == (4, 4, 4, 4)
    # the farthest read: three hex steps of 2 px
    assert plan.guard == 6 * (markesteijn.TILE_W + 2 * mx + 1)
    ndir = 4 if passes == 1 else 8

    def area(m):
        return (markesteijn.TILE_H + 2 * m) * (markesteijn.TILE_W + 2 * m)

    def rows(m):   # at the mosaic's row stride
        return (markesteijn.TILE_H + 2 * m) * (markesteijn.TILE_W + 2 * mx)

    # a G, R and B for each of the two thread groups; after the chains
    # the counts and one group's kept values (3 per pixel and direction)
    reused = 2 * (rows(mg) + 2 * rows(mrb))
    assert ndir * area(markesteijn.CNT_MARGIN) \
        + ndir // 2 * 3 * markesteijn.TILE_H * markesteijn.TILE_W <= reused
    floats = rows(mx) + reused + ndir * area(markesteijn.DRV_MARGIN)
    raw = 4 * (2 * plan.guard + floats + -(-rows(mx) // 4)) + 72 * 4 + 36
    assert plan.smem == -(-raw // 16) * 16


def test_markesteijn_in_place_steps_hold_for_every_xtrans_phase():
    """The kernel updates R/B and G in place; the pattern check that makes
    that exact passes every phase of the X-Trans layout and refuses a
    layout where it would not hold."""
    grid = np.asarray(configs.XTRANS6).reshape(6, 6)
    for dy in range(6):
        for dx in range(6):
            assert markesteijn.in_place_ok(tuple(
                int(c) for c in np.roll(grid, (dy, dx), (0, 1)).reshape(-1)))
    assert not markesteijn.in_place_ok((1,) * 36)
    assert not markesteijn.in_place_ok(tuple([0, 1, 2] * 12))


def test_markesteijn_plan_is_the_same_for_every_phase():
    """A shifted pattern is the same geometry at other coordinates: its
    plan needs no other margins."""
    base = markesteijn.kernel_plan(configs.XTRANS6, 3)
    grid = np.asarray(configs.XTRANS6).reshape(6, 6)
    for dy, dx in [(1, 0), (0, 1), (2, 5), (3, 3)]:
        shifted = tuple(int(c) for c in np.roll(grid, (dy, dx), (0, 1))
                        .reshape(-1))
        assert markesteijn.kernel_plan(shifted, 3).halo == base.halo


def _one_thread_vertical(v, coef):
    """The IIR twin's recursion as one thread runs it (the kernel's first
    design): forward, then backward adding to the forward values."""
    a0, a1, a2, a3, b1, b2, coefp, coefn = coef
    h = v.shape[-2]
    x0 = v[:, 0]
    xprev, y1 = x0, coefp * x0
    y2 = y1
    ys = []
    for i in range(h):
        xr = v[:, i]
        y = a0 * xr + a1 * xprev - b1 * y1 - b2 * y2
        ys.append(y)
        xprev, y2, y1 = xr, y1, y
    xn1 = xn2 = v[:, h - 1]
    z1 = coefn * xn1
    z2 = z1
    out = [None] * h
    for r in range(-(-h // iir.RB) * iir.RB - 1, -1, -1):
        z = a2 * xn1 + a3 * xn2 - b1 * z1 - b2 * z2
        if r < h:
            out[r] = ys[r] + z
        xn2, xn1 = xn1, v[:, min(r, h - 1)]
        z2, z1 = z1, z
    return torch.stack(out, dim=1)


@pytest.mark.parametrize("length", [1, 7, 8, 9, 1376, 2080])
@pytest.mark.parametrize("order", [0, 1, 2])
@pytest.mark.parametrize("clamp", [False, True])
def test_iir_split_recursions_add_up_to_the_one_thread_recursion(
        length, order, clamp):
    """The forward and backward recursions run apart (as the kernel's
    forward and backward lanes run them), then added, equal the twin's
    vertical pass and the recursion one thread runs, bit for bit."""
    rng = np.random.default_rng(length * 10 + order)
    v = torch.from_numpy(rng.uniform(-0.2, 1.3, (2, length, 3))
                         .astype(np.float32))
    if clamp:
        v = torch.clamp(v, 0.0, 1.0)
    coef = iir._f32(blur._deriche_coeffs(max(length / 6.0, 0.7), order))
    ys = iir._forward_reference(v, coef)
    zs = iir._backward_reference(v, coef)
    split = torch.stack([y + z for y, z in zip(ys, zs)], dim=1)
    assert torch.equal(split, iir._vertical_reference(v, coef))
    assert torch.equal(split, _one_thread_vertical(v, coef))


@pytest.mark.parametrize("length", [1, 7, 8, 9, 63, 64, 65, 1376, 2080])
def test_iir_in_place_combine_touches_each_position_twice(length):
    """The kernel's schedule: at step s the forward lane is at position s
    and the backward lane at P - 1 - s (P the 8-padded length); before
    P / 2 each stores its value, from P / 2 on each adds its partner's.
    Every position of the line is stored once before the halves' barrier
    and completed once after it, by the other direction."""
    P = -(-length // iir.RB) * iir.RB
    first, second = {}, {}
    for s in range(P):
        for bwd, pos in ((False, s), (True, P - 1 - s)):
            if pos < length:
                (first if s < P // 2 else second).setdefault(pos, []).append(bwd)
    assert sorted(first) == sorted(second) == list(range(length))
    assert all(len(first[p]) == len(second[p]) == 1
               and first[p][0] != second[p][0] for p in range(length))


@pytest.mark.parametrize("nhw", [(2, 1376, 2080), (1, 7, 9), (3, 33, 40),
                                 (1, 1, 1), (2, 1000, 17)])
def test_iir_plan_covers_every_line_once_per_direction(nhw):
    plan = iir.launch_plan(*nhw)
    assert [p[0] for p in plan] == ["columns", "rows"]
    n, h, w = nhw
    assert [(p[1], p[2]) for p in plan] == [(n * w, h), (n * h, w)]
    for _, lines, _, blocks, threads, smem in plan:
        assert threads == 32 and 0 < smem <= 48 * 1024
        seen = {False: [], True: []}
        for b in range(blocks):
            for lane in iir.block_lines(b, lines):
                if lane is not None:
                    seen[lane[1]].append(lane[0])
        assert sorted(seen[False]) == sorted(seen[True]) == list(range(lines))
    if nhw == (2, 1376, 2080):
        # config 3's pair puts work on all 132 SMs in both passes
        assert [p[3] for p in plan] == [260, 172]
        assert iir.latency_floor_ms(1376, 2080) == pytest.approx(0.02095,
                                                                 rel=1e-3)


def _twin_rows(gh, ss):
    """The twin's row weights, computed as slice_grid_reference does."""
    rows = torch.arange(gh * ss, dtype=torch.float32)
    gy = torch.clamp((rows + 0.5) / torch.full((), float(ss)) - 0.5, 0.0,
                     float(gh - 1))
    qa = torch.floor(gy)
    wa = torch.clamp(1.0 - torch.abs(gy - qa), min=0.0)
    wb = torch.clamp(1.0 - torch.abs(gy - (qa + 1.0)), min=0.0)
    ia = qa.long()
    return ia, (ia + 1).clamp(max=gh - 1), wa, wb


# (D, C) the callers of the slice can request: grid_filter clips D to
# [4, 32]; bilateral, bilat and bilateral_self slice one channel, shadhi
# and lowpass three with sigma_r 100 over [0, 100], which gives D = 4;
# (32, 3) is the largest slab any (D, C) of the kernel's could need
CALLER_DC = [(d, 1) for d in range(4, 33)] + [(4, 3), (32, 3)]
SLICE_SS = [1, 2, 10, 15, 16, 17, 50, 100]


@pytest.mark.parametrize("ss", SLICE_SS)
def test_bgrid_row_table_is_the_twins_row_weights(ss):
    gh = max(2, 300 // ss)
    table = bgrid.row_table(gh, ss)
    ia, ib, wa, wb = _twin_rows(gh, ss)
    assert np.array_equal(table[:, 0], ia.numpy())
    assert np.array_equal(table[:, 1], ib.numpy())
    assert np.array_equal(table[:, 2].view(np.float32), wa.numpy())
    assert np.array_equal(table[:, 3].view(np.float32), wb.numpy())


@pytest.mark.parametrize("ss", SLICE_SS)
def test_bgrid_slab_holds_every_tap_and_row_of_its_tile(ss):
    """Each tile's staged rows and columns hold every grid row (ia, ib) and
    column (i0, i1) its pixels read, and the slab fits the shared memory
    the kernel reserves, for every (D, C) the callers can request."""
    from ansel_tpu_torch.pixel.bilateralgrid import upsample_taps

    # a ragged frame: no multiple of 128 columns or of any tile's rows
    gh, gw = max(2, 1003 // ss), max(2, 1301 // ss)
    hp, wp = gh * ss, gw * ss
    i0, i1, _, _ = upsample_taps(gw, ss)
    rows = bgrid.row_table(gh, ss)
    cols = bgrid.col_ranges(gw, ss)
    assert len(cols) == -(-wp // bgrid.TILE_W)
    for t, (lo, hi) in enumerate(cols):
        x = slice(t * bgrid.TILE_W, (t + 1) * bgrid.TILE_W)
        assert lo == min(i0[x].min(), i1[x].min())
        assert hi == max(i0[x].max(), i1[x].max())
    staged = 0
    for D, C in CALLER_DC:
        plan = bgrid.slice_plan(D, C, gh, gw, ss)
        assert plan.rows in bgrid.TILE_ROWS
        if plan.plane_stride == 0:
            # the direct path: no slab, and none of the tiles would fit
            assert plan.smem == 0
            for th in bgrid.TILE_ROWS:
                first = np.arange(0, hp, th)
                last = np.minimum(first + th, hp) - 1
                r = int((rows[last, 1] - rows[first, 0]).max()) + 1
                q = int((cols[:, 1] - cols[:, 0]).max()) + 1
                stride = bgrid._plane_stride(r * q, C, q)
                assert r * q <= stride < r * q + 32
                assert 4 * D * C * stride > bgrid.SLAB_BYTES
            continue
        staged += 1
        assert plan.smem == 4 * D * C * plan.plane_stride
        assert plan.smem <= bgrid.SLAB_BYTES
        assert plan.slab_rows * plan.slab_cols <= plan.plane_stride
        if C % 2:
            # neighbouring bins' planes start (Q mod 32) | 1 banks apart
            assert C * plan.plane_stride % 32 == (plan.slab_cols % 32) | 1
        for lo, hi in cols:
            assert hi - lo + 1 <= plan.slab_cols
        for y0 in range(0, hp, plan.rows):
            tile = rows[y0:y0 + plan.rows]
            rlo, rhi = tile[0, 0], tile[-1, 1]
            assert rhi - rlo + 1 <= plan.slab_rows
            assert tile[:, :2].min() >= rlo and tile[:, :2].max() <= rhi
    # the grid's own classes stage: config 7's slices, lowpass's default
    if ss >= 10:
        assert staged == len(CALLER_DC)


def test_bgrid_plans_for_config7():
    """Config 7's five slices (bilateral's three at (32, 1), ss 15 on
    4005 x 6030; shadhi's at (4, 3), ss 100 on 4000 x 6100; bilat's at
    (6, 1), ss 50 on 4000 x 6050) stage a slab in 64-row tiles."""
    for D, C, gh, gw, ss in ((32, 1, 267, 402, 15), (4, 3, 40, 61, 100),
                             (6, 1, 80, 121, 50)):
        plan = bgrid.slice_plan(D, C, gh, gw, ss)
        assert plan.rows == 64 and 0 < plan.smem <= 16 * 1024
    # bilat mode 0 at its default sigma_s 0.5: ss 1 with 32 bins
    assert bgrid.slice_plan(32, 1, 2000, 2000, 1).smem == 0
    assert bgrid.slice_plan(32, 3, 2000, 2000, 1).smem == 0
