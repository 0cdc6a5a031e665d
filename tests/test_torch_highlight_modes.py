"""The port's highlight modes LCH, INPAINT and HARMONIC against ansel_tpu
on the CPU, and their X-Trans fall-throughs.

INPAINT is also held against a float64 sequential transcription of the
reference's interpolate_color (`_inpaint_seq`, copied from
tests/test_highlights.py): the JAX package's `lax.associative_scan` and
the port's doubling scan combine the ratio recurrence in other orders.
HARMONIC's functions are held one by one (`_lap5`, `_down2`, `_up2`,
`_masked_cg` at a fixed iteration count, the steering tensor, the steered
sweeps, one pyramid), then `harmonic_dome_core` and the op's mode.  On
X-Trans mosaics the JAX package routes LCH, LAPLACIAN and HARMONIC to
the clamp min(x, clip) (its apply reaches them on Bayer only); so does
the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ansel_tpu.core.params import params_class as ref_params_class
from ansel_tpu.core.types import CFAPattern as RefCFA
from ansel_tpu.core.types import Colorspace as RefCS
from ansel_tpu.core.types import ImageSpec as RefSpec
from ansel_tpu.core.types import RawMeta as RefMeta
from ansel_tpu.kernels import highlights_harmonic as ref_hh
from ansel_tpu.ops.base import PlanContext as RefCtx
from ansel_tpu.ops.base import get_op as ref_get_op
from ansel_tpu_torch.core.params import params_class
from ansel_tpu_torch.core.types import (CFAPattern, Colorspace, ImageSpec,
                                        RawMeta)
from ansel_tpu_torch.io.configs import XTRANS6
from ansel_tpu_torch.kernels import highlights_harmonic as hh
from ansel_tpu_torch.kernels import highlights_laplacian as hl_lap
from ansel_tpu_torch.ops import highlights as hl_op
from ansel_tpu_torch.ops.base import PlanContext, get_op

torch.set_num_threads(1)

H, W = 64, 128
CLIPS = (0.9, 0.95, 0.85)
# LCH and the clamp: the same float32 operations; torch's CPU sqrt may
# round an ulp otherwise than XLA's (measured 2.4e-7 on values to 1.3)
LCH_TOL = 1e-6
# INPAINT against JAX: the ratio recurrence combined in another order
# (doubling rounds against JAX's tree), values up to 1.2 (measured
# 1.2e-7)
INPAINT_TOL = 1e-5
# against the float64 sequential reference, as tests/test_highlights.py
# holds the JAX package
INPAINT_SEQ_TOL = 1e-4
# the stencils and resizes alone (measured 0 and 1.2e-7)
STENCIL_TOL = 1e-6
# CG: the frame sums (rs, p.Ap) reduce in another order and 40 to 80
# iterations amplify it (measured 1.2e-7 harmonic, 6.5e-6 biharmonic on
# values below 1)
CG_TOL = 2e-5
# the steering tensor (frame mean, exp, sqrt; measured 3.0e-7) and 50
# steered sweeps with the obstacle (measured 4.2e-7)
TENSOR_TOL = 1e-6
SWEEP_TOL = 1e-5
# one pyramid of domes (3 halvings, 40 + 80 iterations on each level;
# measured 3.8e-5 on values below 1) and the whole core on the mosaic
# (measured 4.8e-7); the JAX side runs under jit
PYRAMID_TOL = 1e-4
CORE_TOL = 1e-4


def _dome_mosaic(h=H, w=W, seed=11, top=1.0):
    """Noise under a bright blob clipped at `top`: every channel clips in
    the blob's core, one or two around it."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    blob = np.exp(-(((yy - h / 2) / (h / 5)) ** 2
                    + ((xx - w / 2) / (w / 6)) ** 2))
    x = rng.uniform(0.05, 0.8, (h, w)) + 1.4 * blob
    return np.minimum(x, top).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    d = np.abs(got - want)
    assert d.max() <= tol, (float(d.max()), np.argwhere(d > tol)[:4])


def _op_pair(mode, x, cfa, pmax=(1.0, 1.0, 1.0), win=None):
    """The highlights op of each package planned and applied on `x` (the
    JAX one under jit): -> (port output, JAX output, port roi, JAX roi)."""
    h, w = x.shape
    outs, rois = [], []
    for pkg in ("port", "ref"):
        if pkg == "port":
            Meta, Ctx, Spec, CS, C, op, pcls = (
                RawMeta, PlanContext, ImageSpec, Colorspace, CFAPattern,
                get_op("highlights"), params_class("highlights"))
        else:
            Meta, Ctx, Spec, CS, C, op, pcls = (
                RefMeta, RefCtx, RefSpec, RefCS, RefCFA,
                ref_get_op("highlights"), ref_params_class("highlights"))
        xt = XTRANS6 if cfa == "XTRANS" else None
        meta = Meta(width=w, height=h, cfa=C[cfa], xtrans=xt)
        ctx = Ctx(meta=meta, processed_maximum=pmax)
        spec = Spec(width=w, height=h, colorspace=CS.RAW, channels=1,
                    cfa=C[cfa], pad_w=w, pad_h=h)
        p = pcls(mode=mode, clip=1.0)
        plan = op.plan(ctx, spec, p)
        c = op.coeffs(ctx, plan, p)
        if win is not None:
            rois.append(op.roi_in(plan, ctx, win))
        c = {k: np.asarray(v, np.float32) for k, v in c.items()}
        if pkg == "port":
            outs.append(op.apply(_t(x), {k: _t(v) for k, v in c.items()},
                                 plan, ctx).numpy())
        else:
            fn = jax.jit(lambda a, cc: op.apply(a, cc, plan, ctx))
            outs.append(np.asarray(fn(jnp.asarray(x), c)))
    return outs[0], outs[1], rois


# --------------------------------------------------------------- LCH

@pytest.mark.parametrize("cfa", ["RGGB", "GBRG"])
def test_lch_matches_reference(cfa):
    x = _dome_mosaic(top=1.3)
    got, want, _ = _op_pair(hl_op.MODE_LCH, x, cfa)
    _close(got, want, LCH_TOL)
    assert np.abs(got - x).max() > 0.1          # it rebuilt the blob


def test_lch_window_has_its_halo():
    """LCH is local: a window reads a 6-px halo, as in the JAX package;
    INPAINT and the multiscale modes need the frame."""
    x = _dome_mosaic()
    win = (10, 20, 30, 40)
    for mode, want in ((hl_op.MODE_LCH, (4, 14, 42, 52)),
                       (hl_op.MODE_INPAINT, None)):
        planned = _op_pair(mode, x, "RGGB", win=win)[2]
        assert planned == [want, want]


# ------------------------------------------------------------ INPAINT

def _interpolate_color_seq(inp, out, clipmap, dim, dir_, other, pass_):
    """Direct sequential transcription of interpolate_color."""
    H, W = inp.shape
    ratio = 1.0
    rng = range(W) if (dim == 0 and dir_ == 1) else \
        range(W - 1, -1, -1) if (dim == 0) else \
        range(H) if dir_ == 1 else range(H - 1, -1, -1)
    for k in rng:
        i, j = (k, other) if dim == 0 else (other, k)
        ni, nj = (i + dir_, j) if dim == 0 else (i, j + dir_)
        clip0 = clipmap[j, i]
        # border
        if i == 0 or i == W - 1 or j == 0 or j == H - 1:
            if pass_ == 3:
                out[j, i] = inp[j, i]
            continue
        clip1 = clipmap[nj, ni] if 0 <= ni < W and 0 <= nj < H else clip0
        v = inp[j, i]
        nv = inp[nj, ni]
        if v < clip0 and v > 1e-5:
            if nv < clip1 and nv > 1e-5:
                if k & 1:
                    ratio = (3.0 * ratio + v / nv) / 4.0
                else:
                    ratio = (3.0 * ratio + nv / v) / 4.0
        if v >= clip0 - 1e-5:
            if nv >= clip1 - 1e-5:
                add = max(clip0, clip1)
            elif k & 1:
                add = nv * ratio
            else:
                add = nv / ratio
            if pass_ == 0:
                out[j, i] = add
            elif pass_ == 3:
                out[j, i] = (out[j, i] + add) / 4.0
            else:
                out[j, i] += add
        else:
            if pass_ == 3:
                out[j, i] = inp[j, i]


def _inpaint_seq(inp, clipmap):
    out = inp.copy()
    H, W = inp.shape
    for j in range(H):
        _interpolate_color_seq(inp, out, clipmap, 0, 1, j, 0)
        _interpolate_color_seq(inp, out, clipmap, 0, -1, j, 1)
    for i in range(W):
        _interpolate_color_seq(inp, out, clipmap, 1, 1, i, 2)
        _interpolate_color_seq(inp, out, clipmap, 1, -1, i, 3)
    return out


def _clip_map(cfa, h, w):
    if cfa == "XTRANS":
        pat = np.asarray(XTRANS6).reshape(6, 6)
        color = pat[np.arange(h)[:, None] % 6, np.arange(w)[None, :] % 6]
    else:
        c = CFAPattern[cfa]
        color = np.array([[c.color_at(y, x) for x in range(2)]
                          for y in range(2)])[np.arange(h)[:, None] % 2,
                                              np.arange(w)[None, :] % 2]
    return (0.995 * np.asarray(CLIPS))[color]


@pytest.mark.parametrize("cfa", ["RGGB", "XTRANS"])
def test_inpaint_matches_reference_and_sequential(cfa):
    h, w = 36, 60
    x = _dome_mosaic(h, w, seed=5, top=1.2)
    got, want, _ = _op_pair(hl_op.MODE_INPAINT, x, cfa, pmax=CLIPS)
    _close(got, want, INPAINT_TOL)
    seq = _inpaint_seq(x.astype(np.float64), _clip_map(cfa, h, w))
    assert np.allclose(got, seq, rtol=INPAINT_SEQ_TOL,
                       atol=INPAINT_SEQ_TOL), np.abs(got - seq).max()
    assert np.abs(got - x).max() > 0.05        # it inpainted the blob


@pytest.mark.parametrize("n", [1, 2, 7, 64, 100])
def test_linear_scan_matches_the_recurrence(n):
    rng = np.random.default_rng(n)
    a = rng.choice([0.75, 1.0], (3, n)).astype(np.float32)
    b = (rng.random((3, n)) * 0.5).astype(np.float32)
    for reverse in (False, True):
        aa, bb = hl_op._linear_scan(_t(a), _t(b), 1, reverse)
        r = np.ones(3)
        want = np.zeros((3, n))
        for k in (range(n - 1, -1, -1) if reverse else range(n)):
            r = a[:, k] * r + b[:, k]
            want[:, k] = r
        _close((aa + bb).numpy(), want, 1e-5)


# ----------------------------------------------------------- HARMONIC

@pytest.fixture(scope="module")
def rims():
    """The guided Laplacian's rim estimates on the dome mosaic (the
    port's, held against the JAX package's in test_torch_laplacian.py;
    the core's test hands both packages the same)."""
    x = _dome_mosaic()
    rec = hl_lap.laplacian_reconstruct(_t(x), torch.tensor(CLIPS),
                                       CFAPattern.RGGB, 8, 30, 0.0, 0.5)
    return x, rec.numpy()


def test_lap5_down2_up2_match_reference():
    u = np.random.default_rng(1).random((3, 37, 53)).astype(np.float32)
    _close(hh._lap5(_t(u[0])), ref_hh._lap5(jnp.asarray(u[0])), STENCIL_TOL)
    _close(hh._down2(_t(u)), ref_hh._down2(jnp.asarray(u)), STENCIL_TOL)
    _close(hh._up2(_t(u[:, :19, :27]), 37, 53),
           ref_hh._up2(jnp.asarray(u[:, :19, :27]), 37, 53), STENCIL_TOL)


def _hole_field(seed, h=40, w=56):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    f = (0.5 + 0.3 * np.sin(yy / 6.0) * np.cos(xx / 9.0)
         + 0.02 * rng.random((h, w))).astype(np.float32)
    hole = ((yy - h / 2) ** 2 / 90.0 + (xx - w / 2) ** 2 / 200.0) < 1.0
    return f, hole


@pytest.mark.parametrize("biharmonic,iters", [(False, 40), (True, 80)])
def test_masked_cg_matches_reference(biharmonic, iters):
    f, hole = _hole_field(2)
    u = np.where(hole, 0.5, f).astype(np.float32)
    got = hh._masked_cg(_t(u), _t(f), _t(hole), iters, biharmonic)
    want = ref_hh._masked_cg(jnp.asarray(u), jnp.asarray(f),
                             jnp.asarray(hole), iters, biharmonic)
    _close(got, want, CG_TOL)
    assert torch.equal(got[~_t(hole)], _t(f)[~_t(hole)])


def test_steering_and_steered_sweeps_match_reference():
    f, hole = _hole_field(3)
    steer = (f + 0.3 * (np.arange(56) > 30)).astype(np.float32)
    for got, want in zip(hh._adaptive_tensor(_t(steer)),
                         ref_hh._adaptive_tensor(jnp.asarray(steer))):
        _close(got, want, TENSOR_TOL)
    obs = np.full_like(f, 0.45)
    for iters, ob in ((1, None), (50, obs)):
        got = hh._masked_aniso_laplace(
            _t(f), _t(f), _t(hole), _t(steer), iters,
            obstacle=None if ob is None else _t(ob))
        want = ref_hh._masked_aniso_laplace(
            jnp.asarray(f), jnp.asarray(f), jnp.asarray(hole),
            jnp.asarray(steer), iters,
            obstacle=None if ob is None else jnp.asarray(ob))
        _close(got, want, SWEEP_TOL)


def test_pyramid_matches_reference():
    f, hole = _hole_field(4, 96, 120)
    valid = (1.0 - hole).astype(np.float32)
    field = np.where(hole, 0.0, f).astype(np.float32)
    nlev = hh.pyramid_levels(96, 120)
    # harmonic_dome_core's count in the JAX package
    assert nlev == int(np.ceil(np.log2(120 / ref_hh.COARSEST))) == 3
    got = hh._solve_pyramid(_t(field), _t(valid), _t(hole), nlev)
    want = jax.jit(lambda f_, v_, h_: ref_hh._solve_pyramid(
        f_, v_, h_, nlev))(field, valid, hole)
    _close(got, want, PYRAMID_TOL)


def test_harmonic_dome_core_matches_reference(rims):
    x, rec = rims
    got = hh.harmonic_dome_core(_t(x), _t(rec), torch.tensor(CLIPS),
                                CFAPattern.RGGB)
    want = jax.jit(lambda x_, r_: ref_hh.harmonic_dome_core(
        x_, r_, jnp.asarray(CLIPS), RefCFA.RGGB))(x, rec)
    _close(got, want, CORE_TOL)
    assert np.abs(got.numpy() - rec).max() > 0.05   # the domes moved it


def test_harmonic_mode_is_the_laplacian_then_the_core():
    """The op's HARMONIC mode runs the guided Laplacian at the op's
    scales and iterations, then the core on its output, with the plan's
    clips, which equal the JAX package's (the JAX op composes the same
    two functions, held above and in test_torch_laplacian.py)."""
    x = _dome_mosaic()
    op, ref = get_op("highlights"), ref_get_op("highlights")
    ctx = PlanContext(meta=RawMeta(width=W, height=H), processed_maximum=CLIPS)
    rctx = RefCtx(meta=RefMeta(width=W, height=H), processed_maximum=CLIPS)
    spec = ImageSpec(width=W, height=H, colorspace=Colorspace.RAW,
                     channels=1, cfa=CFAPattern.RGGB)
    rspec = RefSpec(width=W, height=H, colorspace=RefCS.RAW, channels=1,
                    cfa=RefCFA.RGGB)
    p = params_class("highlights")(mode=hl_op.MODE_HARMONIC)
    rp = ref_params_class("highlights")(mode=hl_op.MODE_HARMONIC)
    plan, rplan = op.plan(ctx, spec, p), ref.plan(rctx, rspec, rp)
    assert plan.static == rplan.static == (4, 8, 30, 0.0, 0.5)
    c, rc = op.coeffs(ctx, plan, p), ref.coeffs(rctx, rplan, rp)
    assert c == rc
    got = op.apply(_t(x), {k: torch.tensor(v) for k, v in c.items()},
                   plan, ctx)
    clips = torch.tensor(c["clips"])
    rec = hl_lap.laplacian_reconstruct(_t(x), clips, CFAPattern.RGGB, 8, 30,
                                       0.0, 0.5)
    assert torch.equal(got, hh.harmonic_dome_core(_t(x), rec, clips,
                                                  CFAPattern.RGGB))
    assert (got - rec).abs().max().item() > 0.05


@pytest.mark.parametrize("mode", [hl_op.MODE_LCH, hl_op.MODE_LAPLACIAN,
                                  hl_op.MODE_HARMONIC])
def test_xtrans_modes_fall_through_to_the_clamp(mode):
    x = _dome_mosaic(48, 72, top=1.3)
    got, want, _ = _op_pair(mode, x, "XTRANS")
    _close(got, want, 0.0)
    _close(got, np.minimum(x, np.float32(1.0)), 0.0)
