"""The warp kernel's host-side tile planning and liquify's stamp
compaction, on the CPU.

`kernels/warp.tile_plan` is the kernel's decision for each 32 x 16
output tile of clipping's, ashift's and liquify's maps (lens's kernel
gathers a pixel a thread and stages nothing): the box of source rows and
columns its corners read, and whether that box's planes fit the staging
budget (staged in shared memory) or not (sampled directly).  For a
45-degree clipping, a quad keystone, config 11's ashift, and a liquify
stroke displacing 300 px (a displacement larger than a tile), a CPU
mirror of the staged sampling (each staged tile's box cut out of the
image and read at box-local corners, which must lie inside it) equals
the plain twin on every tile, bit for bit; the main paths' maps stage
every tile, and a 45-degree clipping with a strong keystone, a strong
ashift and the 300 px stroke leave some tiles direct.

Liquify's compaction: for each tile, the stamps the kernel keeps
(`_keep`, the kernel's float32 test of a grown disc against the tile's
window pixels), in their own order, give each pixel of the tile the
displacement `liquify_displacement` gives it over all stamps, bit for
bit (a stamp whose disc misses a pixel adds -(+-0))."""

import dataclasses

import numpy as np
import pytest
import torch

import ansel_tpu_torch as port
from ansel_tpu_torch.core.types import Colorspace, ImageSpec, RawMeta
from ansel_tpu_torch.io import configs
from ansel_tpu_torch.kernels import warp
from ansel_tpu_torch.ops import clipping, liquify
from ansel_tpu_torch.ops.ashift import homography_consts
from ansel_tpu_torch.pipeline import engine

torch.set_num_threads(1)

H, W = 200, 304
CLIP = {
    "rotate45": {"angle": 45.0},
    "quad-keystone": {"angle": 1.0, "k_type": 0, "k_apply": 1, "kxa": 0.1,
                      "kya": 0.15, "kxb": 0.85, "kyb": 0.1, "kxc": 0.9,
                      "kyc": 0.9, "kxd": 0.15, "kyd": 0.85},
    "rotate45-strong-keystone": {"angle": 45.0, "k_type": 0, "k_apply": 1,
                                 "kxa": 0.1, "kya": 0.1, "kxb": 0.9,
                                 "kyb": 0.4, "kxc": 0.9, "kyc": 0.6,
                                 "kxd": 0.1, "kyd": 0.9},
}
ASHIFT = {"config11": dict(configs.HISTORIES[11][3][1]),
          "strong": {"rotation": 30.0, "lensshift_v": 1.0,
                     "lensshift_h": 1.0}}
# the cases whose maps leave tiles to the direct path
DIRECT = {"clip-rotate45-strong-keystone", "ashift-strong", "liquify-300px"}


def _image(c, h, w, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random((c, h, w), dtype=np.float32))


def _clip_case(name):
    op = clipping.Clipping()
    p = dataclasses.replace(clipping.ClippingParams(), **CLIP[name])
    full = ImageSpec(width=W, height=H, colorspace=Colorspace.CAMERA_RGB)
    plan = op.plan(engine.PlanContext(meta=RawMeta(width=W, height=H)),
                   full, p)
    so = plan.spec_out
    k, k_apply = clipping.clip_map(dict(plan.static), full, so)
    k = torch.from_numpy(k)
    oh, ow = so.pad_h, so.pad_w
    x = _image(3, H, W, 2)
    sy, sx, inside = warp.clip_coords(k, k_apply, oh, ow, "cpu")
    return (x, warp.clip_warp_reference(x, k, k_apply, oh, ow), [(sy, sx)],
            inside)


def _ashift_case(name):
    op = port.ops.base.get_op("ashift")
    p = dataclasses.replace(op.default_params(None), **ASHIFT[name])
    spec = ImageSpec(width=W, height=H, colorspace=Colorspace.CAMERA_RGB)
    plan = op.plan(port.ops.base.PlanContext(meta=None), spec, p)
    k = torch.from_numpy(homography_consts(plan.static[0]))
    x = _image(3, H, W, 3)
    sy, sx, inside = warp.homography_coords(k, H, W, "cpu")
    return x, warp.homography_warp_reference(x, k), [(sy, sx)], inside


def _stroke_300px():
    """One linear stamp of radius 150 px pushing 600 px at its centre,
    whose falloff moves pixels by up to 300 px: its displacement changes
    by more than a tile across a tile."""
    pt = complex(W / 2, H / 2)
    blob = configs.liquify_node(configs.PATH_MOVE, -1, -1, pt, pt + 600,
                                pt + 150.0, configs.WARP_LINEAR)
    return blob + b"\0" * (76 * configs.LIQUIFY_NODES - len(blob))


def _stamps_and_window(blob):
    p = liquify.LiquifyParams(blob)
    c = liquify.Liquify()._warp_arrays(p)
    stamps = warp.pack_stamps({k: torch.from_numpy(np.asarray(v))
                               for k, v in c.items()})
    spec = ImageSpec(width=W, height=H, colorspace=Colorspace.CAMERA_RGB,
                     pad_w=W, pad_h=H)
    plan = liquify.Liquify().plan(port.ops.base.PlanContext(meta=None), spec,
                                  p)
    return stamps, plan.static[4]


def _liquify_case(blob):
    stamps, win = _stamps_and_window(blob)
    x = _image(3, H, W, 4)
    sy, sx, valid = warp.liquify_positions(stamps, win, H, W)
    return x, warp.liquify_warp_reference(x, stamps, win), [(sy, sx)], valid


CASES = {
    **{f"clip-{n}": (lambda n=n: _clip_case(n)) for n in CLIP},
    **{f"ashift-{n}": (lambda n=n: _ashift_case(n)) for n in ASHIFT},
    "liquify-config11": lambda: _liquify_case(configs.liquify_nodes(H, W)),
    "liquify-300px": lambda: _liquify_case(_stroke_300px()),
}


def _sample_box(stage, rows, cols, by0, bx0, ys, xs, h, w):
    """The kernel's staged read: the sampler's corner and weights, the four
    corners read from the box (rows x cols from (by0, bx0)), summed in the
    twin's order; every corner must lie inside the box."""
    iy, ix = warp.corners(ys, xs, h, w)
    ly, lx = iy - by0, ix - bx0
    assert bool(((ly >= 0) & (ly + 1 < rows) & (lx >= 0)
                 & (lx + 1 < cols)).all()), "a corner outside the staged box"
    y0, x0 = iy.float(), ix.float()
    fy = torch.clamp(ys - y0, 0.0, 1.0)
    fx = torch.clamp(xs - x0, 0.0, 1.0)
    flat = stage.reshape(-1)
    i = ly * cols + lx
    return (flat[i] * (1 - fy) * (1 - fx) + flat[i + 1] * (1 - fy) * fx
            + flat[i + cols] * fy * (1 - fx) + flat[i + cols + 1] * fy * fx)


@pytest.mark.parametrize("vec", [True, False], ids=["16B", "4B"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_staged_tiles_read_inside_their_box(case, vec):
    x, want, sets, valid = CASES[case]()
    c, h, w = x.shape
    th, tw, budget = warp.TILE
    y0, rows, x0, cols, staged = warp.tile_plan(sets, valid, h, w, c, vec)
    oh, ow = valid.shape
    assert staged.shape == (-(-oh // th), -(-ow // tw))
    if vec:
        assert bool((x0 % 4 == 0).all() and (cols % 4 == 0).all())
    assert bool((c * rows * cols <= budget)[staged].all())
    n_direct = int((~staged).sum())
    assert (n_direct > 0) == (case in DIRECT), n_direct
    seen = 0
    for ty, tx in staged.nonzero().tolist():
        r, k = int(rows[ty, tx]), int(cols[ty, tx])
        if r == 0:
            continue
        by0, bx0 = int(y0[ty, tx]), int(x0[ty, tx])
        ys0, xs0 = ty * th, tx * tw
        tile = (slice(ys0, min(ys0 + th, oh)), slice(xs0, min(xs0 + tw, ow)))
        m = valid[tile]
        stage = x[:, by0:by0 + r, bx0:bx0 + k]
        assert stage.shape[1:] == (r, k)
        for ch in range(c):
            ys, xs = sets[0]
            ys, xs = ys.expand(oh, ow)[tile][m], xs.expand(oh, ow)[tile][m]
            got = _sample_box(stage[ch], r, k, by0, bx0, ys, xs, h, w)
            assert torch.equal(got, want[ch][tile][m])
        seen += 1
    assert seen > 0


def _keep(stamps, box):
    """The kernel's keep flags, (K,) bool, of the stamps ((K, STAMP)
    float32) for a tile whose window pixels' centres span box = (y0, y1,
    x0, x1), inclusive: the stamp's disc, grown by 1% of its radius and 2
    px, reaches the box (in float32, as csrc/warp.cu's liquify_kernel
    tests it)."""
    f32 = torch.float32
    cy0, cy1, cx0, cx1 = (torch.tensor(float(v), dtype=f32) for v in box)
    cx, cy, r = (stamps[:, i] for i in range(3))
    zero = torch.zeros((), dtype=f32)
    gx = torch.maximum(torch.maximum(cx0 - cx, cx - cx1), zero)
    gy = torch.maximum(torch.maximum(cy0 - cy, cy - cy1), zero)
    reach = r * torch.tensor(1.01, dtype=f32) + 2.0
    return gx * gx + gy * gy < reach * reach


@pytest.mark.parametrize("case", ["config11", "300px"])
def test_liquify_compaction_keeps_the_stamp_order(case):
    blob = configs.liquify_nodes(H, W) if case == "config11" \
        else _stroke_300px()
    stamps, win = _stamps_and_window(blob)
    wy0, wy1, wx0, wx1 = win
    th, tw, _ = warp.TILE
    ax, ay, _, _ = warp.liquify_displacement(stamps, win)
    kept_some = skipped_some = False
    for ty0 in range(wy0 // th * th, wy1, th):
        for tx0 in range(wx0 // tw * tw, wx1, tw):
            ya, yb = max(ty0, wy0), min(ty0 + th, wy1)
            xa, xb = max(tx0, wx0), min(tx0 + tw, wx1)
            keep = _keep(stamps, (ya, yb - 1, xa, xb - 1))
            idx = keep.nonzero().flatten()
            assert bool((idx[1:] > idx[:-1]).all())
            kept_some |= bool(keep.any())
            skipped_some |= not bool(keep.all())
            region = (slice(ya - wy0, yb - wy0), slice(xa - wx0, xb - wx0))
            if not keep.any():
                assert bool((ax[region] == 0).all()
                            and (ay[region] == 0).all())
                continue
            tx, ty_, _, _ = warp.liquify_displacement(stamps[idx],
                                                      (ya, yb, xa, xb))
            assert torch.equal(tx, ax[region]) and torch.equal(ty_, ay[region])
    assert kept_some and (skipped_some or stamps.shape[0] == 1)

