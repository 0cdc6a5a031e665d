"""The port's raw-cleanup and blur-family ops against ansel_tpu on the CPU:
hotpixels, rawdenoise, cacorrect (on the mosaic), cacorrectrgb (camera
RGB), nlmeans, defringe (its three modes) and bloom (Lab).  For each, the
plan and the coefficients bit for bit and `apply` on a small seeded input
within a stated tolerance; then the legacy ladders of rawdenoise,
cacorrect and nlmeans, and the registry.  Inputs come from numpy seeds
and go to both packages as the same float32 arrays."""

import importlib
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ansel_tpu.core import types as ref_types
from ansel_tpu.core.params import params_class as ref_params_class
from ansel_tpu.ops import base as ref_base
from ansel_tpu_torch.core import types as port_types
from ansel_tpu_torch.core.params import params_class
from ansel_tpu_torch.ops import base as port_base
from ansel_tpu_torch.pipeline.engine import coeffs_to_device

torch.set_num_threads(2)

# cacorrect needs 3 tiles of 32 half-resolution rows and columns
H, W = 192, 256

# (id, module, op class, params, input), each with the error measured
# against the JAX package on its own scale (the mosaic in [0, 1], camera
# RGB in [0, ~1.3], Lab L in [0, 100] and a/b about +-40).  What the two
# packages round differently: the tile sums and the 6x6 solve of
# cacorrect (XLA's reduction order and LAPACK's), the IIR of cacorrectrgb
# (an eager recursion here, blocked products there) amplified by its
# log2/exp2 manifolds, defringe's blur and box means, and bloom's eight
# box means as cumulative sums; the JAX side runs jitted, so XLA also
# fuses products into sums.
# The NLM patch sums differ on a ring of P px at the border (the XLA path
# edge-pads the d2 plane, the kernel and its twin the image): nlmeans is
# held to the JAX op inside that ring and to the Pallas kernel in
# interpret mode on the whole frame.
TOL = {
    "hotpixels": 0.0,                   # 0
    "rawdenoise": 1e-6,                 # 2.4e-7
    "cacorrect": 1e-5,                  # 6.0e-7
    "cacorrectrgb": 1e-5,               # 1.3e-6
    "nlmeans": 1e-3,                    # 3.2e-4 (L near 100: ulp 7.6e-6)
    "defringe": 1e-4,                   # 1.9e-5
    "defringe-local": 1e-4,             # 1.7e-5
    "defringe-static": 1e-4,            # 2.9e-5
    "bloom": 2e-4,                      # 4.6e-5
}
CASES = [
    ("hotpixels", "hotpixels", "HotPixels", {}, "RAW"),
    ("rawdenoise", "rawdenoise", "RawDenoise", {"threshold": 0.02}, "RAW"),
    ("cacorrect", "cacorrect", "CACorrect", {}, "RAW"),
    ("cacorrectrgb", "cacorrectrgb", "CACorrectRGB", {}, "CAMERA_RGB"),
    ("nlmeans", "nlmeans", "NLMeans", {}, "LAB"),
    ("defringe", "defringe", "Defringe", {}, "LAB"),
    ("defringe-local", "defringe", "Defringe", {"op_mode": 1}, "LAB"),
    ("defringe-static", "defringe", "Defringe",
     {"op_mode": 2, "thresh": 5.0}, "LAB"),
    ("bloom", "bloom", "Bloom", {"threshold": 70.0}, "LAB"),
]


def _image(kind, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    base = 0.5 + 0.3 * np.sin(xx / 7.0) * np.cos(yy / 11.0)
    base[H // 3: H // 2, W // 4: W // 2] += 0.35            # an edge
    base += rng.normal(0.0, 0.03, (H, W))
    if kind == "RAW":
        # red sites see the scene a pixel to the right, blue a pixel
        # down (lateral CA); a dark patch with hot photosites
        mos = np.clip(base, 0.0, 1.0)
        shifted_r = np.roll(mos, -1, axis=1)
        shifted_b = np.roll(mos, -1, axis=0)
        mos[0::2, 0::2] = shifted_r[0::2, 0::2]
        mos[1::2, 1::2] = shifted_b[1::2, 1::2]
        mos[-40:, :60] = 0.06 + rng.uniform(0, 0.02, (40, 60))
        mos[-30:-10:6, 4:56:8] = 0.9
        return mos.astype(np.float32)
    if kind == "LAB":
        L = np.clip(base, 0.0, 1.0) * 100.0
        L[: H // 5, -W // 4:] = 97.0                         # near white
        a = rng.uniform(-40, 40, (H, W))
        a[H // 3: H // 2, W // 4: W // 4 + 3] = 80.0         # a fringe
        return np.stack([L, a, rng.uniform(-40, 40, (H, W))]) \
            .astype(np.float32)
    rgb = np.stack([np.roll(base, s, axis=1) * f
                    for s, f in ((1, 0.9), (0, 1.0), (-1, 0.7))])
    return np.clip(rgb + rng.normal(0.0, 0.02, rgb.shape), 0.0, 1.3) \
        .astype(np.float32)


def _pair(module, cls, params, kind):
    out = []
    for pkg, types, base, pcls in (
            ("ansel_tpu", ref_types, ref_base, ref_params_class),
            ("ansel_tpu_torch", port_types, port_base, params_class)):
        op = getattr(importlib.import_module(f"{pkg}.ops.{module}"), cls)()
        p = pcls(op.name)(**params)
        ctx = base.PlanContext(meta=types.RawMeta(width=W, height=H))
        raw = kind == "RAW"
        spec = types.ImageSpec(
            width=W, height=H, colorspace=getattr(types.Colorspace, kind),
            channels=1 if raw else 3,
            cfa=types.CFAPattern.RGGB if raw else None)
        plan = op.plan(ctx, spec, p)
        out.append((op, ctx, plan, op.coeffs(ctx, plan, p)))
    return out


@pytest.mark.parametrize("name,module,cls,params,kind", CASES,
                         ids=[c[0] for c in CASES])
def test_plan_and_coeffs_equal_the_jax_package(name, module, cls, params,
                                               kind):
    (_, _, rplan, rco), (_, _, pplan, pco) = _pair(module, cls, params, kind)
    assert pplan.static == rplan.static
    assert pplan.spec_out == pplan.spec_in
    assert (rco is None) == (pco is None)
    if rco is not None:
        assert sorted(rco) == sorted(pco)
        for k in rco:
            assert np.array_equal(np.asarray(pco[k]), np.asarray(rco[k])), k


@pytest.mark.parametrize("name,module,cls,params,kind", CASES,
                         ids=[c[0] for c in CASES])
def test_apply_matches_the_jax_package(name, module, cls, params, kind):
    (rop, rctx, rplan, rco), (pop, pctx, pplan, pco) = _pair(
        module, cls, params, kind)
    x = _image(kind, seed=len(name))
    want = np.asarray(jax.jit(lambda v: rop.apply(v, rco, rplan, rctx))(
        jnp.asarray(x)))
    c = coeffs_to_device([pco], "cpu")[0]
    got = pop.apply(torch.from_numpy(x), c, pplan, pctx).numpy()
    assert got.shape == want.shape == x.shape
    assert np.isfinite(got).all()
    assert np.abs(got - x).max() > 1e-3           # the op changed something
    if name == "nlmeans":
        P = pplan.static[0]
        got, want = got[:, P:-P, P:-P], want[:, P:-P, P:-P]
    assert np.abs(got - want).max() <= TOL[name]


def test_nlmeans_matches_the_pallas_kernel_on_the_whole_frame():
    """The op's patch average is the TPU's: the Pallas kernel in interpret
    mode, variant 0, blended as the op blends it."""
    from ansel_tpu.kernels.nlm_pallas import nlm_pallas
    from ansel_tpu.pixel.nlmeans import _scatter

    (_, _, rplan, rco), (pop, pctx, pplan, pco) = _pair(
        "nlmeans", "NLMeans", {}, "LAB")
    x = _image("LAB", seed=7)
    P, K, _ = rplan.static
    offs = tuple(_scatter(1.0, 0.0, dy, dx) for dy in range(-K, K + 1)
                 for dx in range(-K, K + 1))
    den = np.asarray(nlm_pallas(jnp.asarray(x), offs, P, rco["norm"],
                                rco["sharpness"], 0.0, 1.0, variant=0,
                                interpret=True))
    w = np.array([rco["luma"], rco["chroma"], rco["chroma"]],
                 np.float32).reshape(3, 1, 1)
    want = x * (1.0 - w) + den * w
    c = coeffs_to_device([pco], "cpu")[0]
    got = pop.apply(torch.from_numpy(x), c, pplan, pctx).numpy()
    assert np.abs(got - want).max() <= TOL["nlmeans"]


def test_cacorrect_passes_xtrans_and_small_frames_through():
    from ansel_tpu_torch.ops.cacorrect import CACorrect

    op = CACorrect()
    p = params_class("cacorrect")()
    ctx = port_base.PlanContext(meta=port_types.RawMeta(width=W, height=H))
    x = torch.from_numpy(_image("RAW", seed=3))
    xt = port_types.ImageSpec(width=W, height=H,
                              colorspace=port_types.Colorspace.RAW,
                              channels=1, cfa=port_types.CFAPattern.XTRANS)
    plan = op.plan(ctx, xt, p)
    assert plan.static == (False, 1)
    assert torch.equal(op.apply(x, None, plan, ctx), x)
    small = port_types.ImageSpec(width=128, height=128,
                                 colorspace=port_types.Colorspace.RAW,
                                 channels=1, cfa=port_types.CFAPattern.RGGB)
    plan = op.plan(ctx, small, p)
    assert plan.static == (True, 1)
    assert torch.equal(op.apply(x[:128, :128], None, plan, ctx),
                       x[:128, :128])


def _fields(p):
    return {k: getattr(p, k) for k in vars(p)}


@pytest.mark.parametrize("op,version,raw", [
    ("rawdenoise", 1, struct.pack("<f", 0.03)),
    ("cacorrect", 1, struct.pack("<ii", 3, 7)),
    ("nlmeans", 1, struct.pack("<2f", 0.3, 0.8)),
], ids=["rawdenoise-v1", "cacorrect-v1", "nlmeans-v1"])
def test_legacy_params_decode_like_reference(op, version, raw):
    from ansel_tpu.core.params import decode_blob as ref_decode
    from ansel_tpu_torch.core.params import decode_blob

    want = ref_decode(op, version, raw)
    got = decode_blob(op, version, raw)
    assert type(got).__name__ == type(want).__name__
    assert _fields(got) == _fields(want)
    assert got.op_version == want.op_version == params_class(op).op_version


@pytest.mark.parametrize("op", ["hotpixels", "rawdenoise", "cacorrect",
                                "cacorrectrgb", "nlmeans", "defringe",
                                "bloom"])
def test_ops_are_registered_with_the_reference_versions(op):
    from ansel_tpu.ops.base import all_ops as ref_all_ops
    from ansel_tpu_torch.ops.base import all_ops

    ref, port = ref_all_ops()[op], all_ops()[op]
    assert type(port).__name__ == type(ref).__name__
    assert params_class(op).op_version == ref_params_class(op).op_version
    assert port.input_colorspace == (
        None if ref.input_colorspace is None
        else getattr(port_types.Colorspace, ref.input_colorspace.name))
    assert port.window_halo == ref.window_halo
    meta = port_types.RawMeta(width=W, height=H)
    assert port.enabled_by_default(meta) == ref.enabled_by_default(
        ref_types.RawMeta(width=W, height=H))
    blob = ref_params_class(op)().codec.encode(ref_params_class(op)())
    assert params_class(op).codec.encode(params_class(op)()) == blob
