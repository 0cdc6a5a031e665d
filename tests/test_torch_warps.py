"""ashift's and liquify's warps against ansel_tpu on the CPU, and the
host code that comes with them.

* ashift (config 11's perspective correction, and a shear with an aspect
  change) and liquify (config 11's brush path and stamps, scaled to the
  frame) through the ops' `apply`, against the JAX ops' CPU form (a
  direct gather of the exact map), plan statics and coefficients equal;
* ROADMAP R11: ashift records a crop under `cropmode` 1 and, as in the
  JAX package, applies none: the output frame is the input frame;
* liquify's `decode_nodes` and `interpolate_paths` against JAX's on
  in-repo blobs (config 11's at two frames, a path of PATH_LINE nodes
  whose strengths cross the quadrants `_mix_warps` unwraps, the default
  blob), and the plan's window;
* `utils/neldermead.simplex` and `ops/ashift_fit` against JAX's copies
  on the images `tests/test_ashift_fit.py` builds."""

import dataclasses
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ansel_tpu.core.types import Colorspace as RefColorspace
from ansel_tpu.core.types import ImageSpec as RefImageSpec
from ansel_tpu.io.synthetic import synth_raw
from ansel_tpu.ops import ashift_fit as ref_af
from ansel_tpu.ops import base as ref_base
from ansel_tpu.ops import liquify as ref_liquify
from ansel_tpu.utils import neldermead as ref_nm
from ansel_tpu_torch.core.types import Colorspace, ImageSpec
from ansel_tpu_torch.io import configs
from ansel_tpu_torch.kernels import warp
from ansel_tpu_torch.ops import ashift_fit as af
from ansel_tpu_torch.ops import base
from ansel_tpu_torch.ops import liquify
from ansel_tpu_torch.pipeline import engine
from ansel_tpu_torch.utils import neldermead as nm

# one intra-op thread: with JAX initialised in the same process, torch's
# first two-thread `sqrt` on the CPU now and then returned the half of a
# (48, 128) plane that the second thread computes off by up to ~2.5e-4
# relative, which a later identical call does not repeat (measured: 3 of
# 32 fresh processes at two threads, 0 of 32 at one)
torch.set_num_threads(1)

# a frame with a padded array (the ops map the array, as in JAX)
H, W = 96, 160
# The port evaluates each map with the JAX CPU form's float32 operations
# in its order, and both sample with the same four-corner sum.  ashift
# measured 0 on both cases; liquify 7.7e-7 (config 11's path) and 1.7e-6
# (the line path, 187 overlapping stamps), on inputs in [0, 1]: XLA
# contracts the Horner steps' products and sums into FMAs, which moves
# the summed displacement by ~1e-6 px.
ASHIFT_TOL = 1e-6
LIQUIFY_TOL = 5e-6

ASHIFT_CASES = (dict(configs.HISTORIES[11][3][1]),
                {"rotation": -2.0, "lensshift_h": -0.3, "shear": 0.05,
                 "aspect": 1.1, "orthocorr": 50.0})


def _plain(v):
    if dataclasses.is_dataclass(v):
        return tuple(_plain(getattr(v, f.name)) for f in dataclasses.fields(v))
    if isinstance(v, (tuple, list)):
        return tuple(_plain(x) for x in v)
    return v


@pytest.fixture(scope="session")
def meta():
    return synth_raw(h=32, w=48)[1]


def _image(shape, seed=5):
    """(3, h, w) float32 in [0, 1]: a smooth gradient plus texture, so a
    displaced sample differs from the unwarped one."""
    rng = np.random.default_rng(seed)
    _, h, w = shape
    yy, xx = np.mgrid[0:h, 0:w]
    base_ = np.stack([0.5 + 0.4 * np.sin(xx / 7.0 + c) * np.cos(yy / 5.0)
                      for c in range(3)])
    return (0.8 * base_ + 0.2 * rng.uniform(size=(3, h, w))).astype(
        np.float32)


def _planned(pkg_base, pkg_types, op_name, params, meta):
    ImageSpec_, Colorspace_ = pkg_types
    spec = ImageSpec_(width=W, height=H, colorspace=Colorspace_.CAMERA_RGB)
    op = pkg_base.get_op(op_name)
    p = dataclasses.replace(op.default_params(meta), **params)
    ctx = pkg_base.PlanContext(meta=meta)
    plan = op.plan(ctx, spec, p)
    return op, ctx, plan, op.coeffs(ctx, plan, p)


def _both(op_name, params, meta):
    """Port and JAX op outputs on the same (3, H, 256) array."""
    rop, rctx, rplan, rc = _planned(ref_base, (RefImageSpec, RefColorspace),
                                    op_name, params, meta)
    op, ctx, plan, c = _planned(base, (ImageSpec, Colorspace), op_name,
                                params, meta)
    assert _plain(plan.static) == _plain(rplan.static)
    assert (c is None) == (rc is None)
    if c is not None:
        assert sorted(c) == sorted(rc)
        for k in c:
            assert np.array_equal(np.asarray(c[k], np.float32),
                                  np.asarray(rc[k], np.float32)), k
    x = _image(plan.spec_in.array_shape)
    dev = engine.coeffs_to_device([c], "cpu")[0]
    got = op.apply(torch.from_numpy(x), dev, plan, ctx).numpy()
    jc = None if rc is None else {k: jnp.asarray(np.asarray(v, np.float32))
                                  for k, v in rc.items()}
    want = np.asarray(rop.apply(jnp.asarray(x), jc, rplan, rctx))
    return x, got, want, plan


@pytest.mark.parametrize("params", ASHIFT_CASES, ids=["config11", "shear"])
def test_ashift_matches_the_jax_gather(params, meta):
    x, got, want, plan = _both("ashift", params, meta)
    assert got.shape == want.shape == x.shape
    assert np.abs(got - x).max() > 0.05           # not an identity
    assert (got == 0.0).any()                     # the outside mask
    assert np.abs(got - want).max() <= ASHIFT_TOL


def test_ashift_applies_no_crop(meta):
    """R11: cropmode 1 records (cl, ct, cr, cb) in the plan, as the JAX
    package does, and the output keeps the input frame."""
    params = dict(configs.HISTORIES[11][3][1])
    assert params["cropmode"] == 1
    x, got, want, plan = _both("ashift", params, meta)
    assert plan.static[1] == (0.03, 0.03, 0.97, 0.97)
    assert plan.spec_out == plan.spec_in
    assert got.shape == want.shape == x.shape


def test_ashift_homography_consts_round_as_jax(meta):
    """The nine float32 constants are the plan's 12-digit inverse rounded
    once, and the twin's map equals the JAX package's float32 map."""
    from ansel_tpu.ops.ashift import Ashift as RefAshift  # noqa: F401
    from ansel_tpu_torch.ops.ashift import homography_consts

    _, _, plan, _ = _planned(base, (ImageSpec, Colorspace), "ashift",
                             dict(configs.HISTORIES[11][3][1]), meta)
    k = homography_consts(plan.static[0])
    m = np.asarray(plan.static[0]).reshape(3, 3)
    assert k.dtype == np.float32
    assert np.array_equal(k, m.reshape(-1).astype(np.float32))
    sy, sx, _ = warp.homography_coords(torch.from_numpy(k), H, 256, "cpu")
    xs = jnp.arange(256, dtype=jnp.float32)[None, :]
    ys = jnp.arange(H, dtype=jnp.float32)[:, None]
    den = m[2, 0] * xs + m[2, 1] * ys + m[2, 2]
    den = jnp.where(jnp.abs(den) < 1e-9, 1e-9, den)
    want_x = (m[0, 0] * xs + m[0, 1] * ys + m[0, 2]) / den
    want_y = (m[1, 0] * xs + m[1, 1] * ys + m[1, 2]) / den
    assert np.abs(sx.numpy() - np.asarray(want_x)).max() <= 1e-4
    assert np.abs(sy.numpy() - np.asarray(want_y)).max() <= 1e-4


def _node(ptype, prev, nxt, pt, strength, radius, warp_type, status=0,
          control=(0.5, 0.5), c1=0j, c2=0j):
    return (struct.pack("<4i3bB", ptype, 0, 0, 0, prev, 0, nxt, 0)
            + struct.pack("<8fii", pt.real, pt.imag, strength.real,
                          strength.imag, radius.real, radius.imag,
                          control[0], control[1], warp_type, status)
            + struct.pack("<4f", c1.real, c1.imag, c2.real, c2.imag))


def _line_blob():
    """A PATH_MOVE then two PATH_LINE nodes whose strength vectors turn
    from the upper left to the lower left and back (the angle unwrapping
    of `_mix_warps`), with other falloff controls."""
    pts = [complex(40, 30), complex(100, 60), complex(130, 20)]
    dirs = [complex(-3, 4), complex(-4, -3), complex(-2, 5)]
    blob = b""
    for k, (pt, d) in enumerate(zip(pts, dirs)):
        blob += _node(1 if k == 0 else 2, k - 1, k + 1 if k < 2 else -1,
                      pt, pt + d, pt + 6.0 + 2.0j, 0, control=(0.2, 0.8))
    return blob + b"\0" * (76 * 100 - len(blob))


BLOBS = {"config11-24mp": configs.liquify_nodes(configs.BENCH_H,
                                                configs.BENCH_W),
         "config11-small": configs.liquify_nodes(H, W),
         "lines": _line_blob(),
         "default": b"\0" * (76 * 100)}


def _warps(mod, blob):
    return [(w.type, w.prev, w.next, w.point, w.strength, w.radius,
             w.control1, w.control2, w.warp_type, w.status)
            for w in mod.interpolate_paths(mod.decode_nodes(blob))]


@pytest.mark.parametrize("name", sorted(BLOBS))
def test_liquify_paths_match(name):
    blob = BLOBS[name]
    assert _warps(liquify, blob) == _warps(ref_liquify, blob)
    n = len(_warps(liquify, blob))
    assert n == {"config11-24mp": 112, "config11-small": 112,
                 "lines": 187, "default": 0}[name]
    if n:
        got = liquify.Liquify()._warp_arrays(liquify.LiquifyParams(blob))
        want = ref_liquify.Liquify()._warp_arrays(
            ref_liquify.LiquifyParams(blob))
        assert sorted(got) == sorted(want)
        for k in got:
            assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("name", ["config11-small", "lines"])
def test_liquify_matches_the_jax_gather(name, meta):
    x, got, want, plan = _both("liquify", {"nodes": BLOBS[name]}, meta)
    y0, y1, x0, x1 = plan.static[4]
    assert got.shape == want.shape == x.shape
    outside = np.ones(x.shape[1:], bool)
    outside[y0:y1, x0:x1] = False
    assert np.array_equal(got[:, outside], x[:, outside])
    assert np.abs(got - x).max() > 0.02           # not an identity
    assert np.abs(got - want).max() <= LIQUIFY_TOL


def test_liquify_twin_sums_what_the_kernel_skips():
    """The kernel skips, per tile, the stamps whose disc (grown by 1% and
    2 px) misses it; that skip adds -(+-0) to the sum.  The twin summed
    over the kept stamps only equals the twin over all of them."""
    p = liquify.LiquifyParams(BLOBS["config11-small"])
    c = {k: torch.from_numpy(np.asarray(v))
         for k, v in liquify.Liquify()._warp_arrays(p).items()}
    stamps = warp.pack_stamps(c)
    win = (40, 56, 64, 80)                        # one 16 x 16 tile
    full = warp.liquify_displacement(stamps, win)
    s = stamps.numpy()
    gx = np.maximum(np.maximum(win[2] - s[:, 0], s[:, 0] - (win[3] - 1)), 0)
    gy = np.maximum(np.maximum(win[0] - s[:, 1], s[:, 1] - (win[1] - 1)), 0)
    reach = s[:, 2] * np.float32(1.01) + np.float32(2.0)
    keep = gx * gx + gy * gy < reach * reach
    assert 0 < keep.sum() < len(s)
    kept = warp.liquify_displacement(stamps[torch.from_numpy(keep)], win)
    for a, b in zip(full, kept):
        assert torch.equal(a, b)


def test_neldermead_matches():
    def rosen(p):
        return (1 - p[0]) ** 2 + 100.0 * (p[1] - p[0] ** 2) ** 2

    def clamp(p):
        p[0] = min(p[0], 0.7)

    for constrain in (None, clamp):
        a, b = [-1.2, 1.0], [-1.2, 1.0]
        ia = nm.simplex(rosen, a, 2, 1e-12, 1.0, 2000, constrain)
        ib = ref_nm.simplex(rosen, b, 2, 1e-12, 1.0, 2000, constrain)
        assert (ia, a) == (ib, b)


def _grid_image(h=480, w=640, spacing=64, thickness=2):
    """tests/test_ashift_fit.py's white grid on a dark background."""
    img = np.full((h, w), 0.05, np.float32)
    for x in range(spacing, w - spacing // 2, spacing):
        img[:, x:x + thickness] = 0.9
    for y in range(spacing, h - spacing // 2, spacing):
        img[y:y + thickness, :] = 0.9
    return np.stack([img] * 3)


def _warped(img, p):
    """The grid through the port's ashift (its CPU twin), as
    tests/test_ashift_fit.py warps it through the JAX op."""
    op = base.get_op("ashift")
    h, w = img.shape[-2:]
    spec = ImageSpec(width=w, height=h, channels=3,
                     colorspace=Colorspace.CAMERA_RGB)
    ctx = base.PlanContext(meta=None)
    plan = op.plan(ctx, spec, p)
    return op.apply(torch.from_numpy(img), None, plan, ctx).numpy()


@pytest.mark.parametrize("kind", ["rotation", "keystone"])
def test_ashift_fit_matches(kind):
    img = _grid_image()
    if kind == "rotation":
        p, axis = af.AshiftParams(rotation=3.0), af.FIT_ROTATION_BOTH_LINES
    else:
        p, axis = af.AshiftParams(lensshift_v=0.4), af.FIT_VERTICALLY
    tilted = _warped(img, p)
    lines = af.detect_lines(tilted, max_dim=640)
    ref_lines = ref_af.detect_lines(tilted, max_dim=640)
    assert len(lines) == len(ref_lines) > 0
    for a, b in zip(lines, ref_lines):
        assert a.type == b.type
        assert np.array_equal(a.p1, b.p1) and np.array_equal(a.p2, b.p2)
    got = af.autofit(tilted, axis=axis)
    want = ref_af.autofit(tilted, axis=axis)
    assert _plain(got) == _plain(want)
    if kind == "rotation":
        assert abs(got.rotation + 3.0) < 0.4
    else:
        assert got.lensshift_v < -0.1
    with pytest.raises(af.FitError):
        af.autofit(np.full((3, 256, 256), 0.4, np.float32))
