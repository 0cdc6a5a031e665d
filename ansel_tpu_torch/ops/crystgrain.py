"""crystgrain — silver-halide crystal grain.

Reference: `ansel/src/iop/crystgrain.c` (params v1 :56-66; crystal
coverage :301-314; per-layer kernel banks :401-524; capture prediction
and exposure normalisation :536-592; the per-layer simulation :612-706
and the colour sub-stacks :721-800).  Copied from
`ansel_tpu/ops/crystgrain.py`, with its documented deviation: each layer
is a mean-field parallel update (every seed of a layer prints at once
through dense crystal stencils, the layer's deposit capped by the light
left before it) where the reference depletes seed by seed in raster
order.  The kernel banks are built on the host (`build_banks`, numpy);
the seeds are JAX's generator's draws (`pixel/prng`, key 0x5EED), and
each stencil is a sum of shifted products in the JAX package's order.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.params import cfield, params
from ..core.types import Colorspace
from ..pixel import prng
from ..pixel.shifts import PaddedView
from .base import Op, OpPlan, PlanContext, register

MODE_MONO = 0
MODE_COLOR = 1
LAYER_KERNELS = 4
R_CAP = 15  # static footprint cap (grain_size ~<= 10 fully faithful)
CRYSTGRAIN_SEED = 0x5EED


@params(op="crystgrain", version=1)
@dataclasses.dataclass
class CrystGrainParams:
    mode: int = cfield("i", MODE_MONO)
    filling: float = cfield("f", 25.0)
    grain_size: float = cfield("f", 4.0)
    layers: int = cfield("i", 30)
    size_stddev: float = cfield("f", 0.25)
    layer_capture: float = cfield("f", 0.0)
    channel_correlation: float = cfield("f", 67.0)
    colorspace_saturation: float = cfield("f", 67.0)

    @classmethod
    def from_legacy(cls, version, raw):
        # crystgrain.c: versions 1/8/9 share the layout (legacy_params
        # is an identity copy); this module is registered v1 here
        if version in (8, 9):
            return cls.codec.decode(raw)
        return None


def _coverage_patch(radius_f, vertices, rotation, r):
    """Dense (2r+1, 2r+1) partial-coverage footprint
    (_crystal_coverage: regular-polygon signed distance + 0.5)."""
    dy, dx = np.mgrid[-r:r + 1, -r:r + 1]
    local_r = np.hypot(dx, dy)
    theta = np.arctan2(dy, dx)
    env = np.cos(np.pi / vertices) / np.cos(
        (2.0 * np.arcsin(np.cos(vertices * (theta + rotation))) + np.pi)
        / (2.0 * vertices))
    return np.clip(radius_f * env - local_r + 0.5, 0.0, 1.0)


def _seed_probability(filling, area):
    """filling% of the layer surface covered on average: p = f / A."""
    return float(np.clip(filling * 0.01 / max(area, 1e-6), 0.0, 1.0))


def build_banks(p: CrystGrainParams, kernel_scale: float, rng_seed: int):
    """Host-side layer kernel banks -> dict with per-kernel patches (each
    at its own radius) and the predicted stack exposure (the reference's
    flat-field recurrence).  Deterministic in (params, scale), so plan()
    and coeffs() build the same banks."""
    rng = np.random.default_rng(rng_seed)
    mean_size = max(p.grain_size * kernel_scale, 1.0)
    max_size = max(3.0 * mean_size, 1.0)

    layers = max(int(p.layers), 1)
    patches = [[None] * LAYER_KERNELS for _ in range(layers)]
    radii = np.zeros((layers, LAYER_KERNELS), np.int32)
    areas = np.zeros((layers, LAYER_KERNELS), np.float32)
    probs = np.zeros((layers, LAYER_KERNELS), np.float32)
    for li in range(layers):
        for k in range(LAYER_KERNELS):
            vertices = float(np.clip(6.0 + 1.5 * rng.standard_normal(),
                                     3.0, 10.0))
            rotation = 2.0 * np.pi * rng.random()
            size = float(np.clip(
                np.exp(np.log(mean_size)
                       + p.size_stddev * rng.standard_normal()),
                1.0, max_size))
            radius_f = max(0.5 * (size - 1.0), 0.5)
            r = int(min(math.ceil(radius_f + 0.5), R_CAP))
            patch = _coverage_patch(radius_f, vertices, rotation, r)
            area = float(patch.sum())
            patches[li][k] = patch
            radii[li, k] = r
            areas[li, k] = max(area, 1e-6)
            probs[li, k] = _seed_probability(p.filling, area)

    # layer capture normalization (crystgrain.c:1386 current_surface form)
    current_surface = float(areas.mean())
    layer_scale = p.layer_capture / max(float(layers), 1.0) \
        / max(current_surface, 1e-12)

    # flat-field remaining-light recurrence -> exposure compensation
    remaining = 1.0
    for li in range(layers):
        cap = 0.0
        for k in range(LAYER_KERNELS):
            a = areas[li, k]
            cap += probs[li, k] * a * min(remaining, a * layer_scale)
        remaining = max(remaining - cap / LAYER_KERNELS, 0.0)
    transmitted = 1.0 - remaining
    exposure = 1.0 / transmitted if transmitted > 1e-7 else 1.0

    return dict(patches=patches, radii=radii, areas=areas, probs=probs,
                layer_scale=np.float32(layer_scale),
                exposure=np.float32(exposure))


def _conv_patch(field, patch, r):
    """Dense stencil sum of shifted views, row by row and tap by tap;
    `patch` is a (2r+1, 2r+1) tensor of weights."""
    pv = PaddedView(field, r)
    out = None
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            t = patch[dy + r, dx + r] * pv.at(dy, dx)
            out = t if out is None else out + t
    return out


def simulate_field(image, banks, key, radii, corr_shared=None):
    """One grain stack over a scalar light field (H, W) -> printed field.
    `radii`: the per-(layer, kernel) footprint radii; `corr_shared`: the
    colour path's shared seed state."""
    patches = banks["patches"]
    areas, probs = banks["areas"], banks["probs"]
    layer_scale = banks["layer_scale"]
    layers = len(patches)
    shape, dev = tuple(image.shape), image.device

    result = torch.zeros_like(image)
    remaining = image
    keys = prng.split(key, layers)
    for li in range(layers):
        ku, kk = prng.split(keys[li])
        if corr_shared is not None:
            shared_u, shared_k, corr, kc = corr_shared
            shared = prng.uniform(kc[li], shape, device=dev) < corr
            u = torch.where(shared, shared_u[li],
                            prng.uniform(ku, shape, device=dev))
            kidx = torch.where(shared, shared_k[li],
                               prng.randint(kk, shape, 0, LAYER_KERNELS,
                                            device=dev))
        else:
            u = prng.uniform(ku, shape, device=dev)
            kidx = prng.randint(kk, shape, 0, LAYER_KERNELS, device=dev)

        deposit = torch.zeros_like(image)
        for k in range(LAYER_KERNELS):
            r = int(radii[li][k])
            seeds = (kidx == k) & (u < probs[li, k]) & (remaining > 0.0)
            patch = patches[li][k]
            inv_a = 1.0 / areas[li, k]
            # flat crystal tone: the smaller of the mean remaining light
            # and the scaled input over the footprint
            avg_rem = _conv_patch(remaining, patch, r) * inv_a
            avg_img = _conv_patch(image, patch, r) * layer_scale
            tone = torch.clamp(torch.minimum(avg_rem, avg_img), min=0.0) \
                * seeds.to(image.dtype)
            # splat back over the footprint (correlation = flipped conv)
            deposit = deposit + _conv_patch(tone, patch.flip((0, 1)), r)
        # mean-field cap: a layer deposits no more than the light left
        actual = torch.minimum(deposit, remaining)
        result = result + actual
        remaining = torch.clamp(remaining - actual, min=0.0)
    return result


@register
class CrystGrain(Op):
    name = "crystgrain"
    input_colorspace = Colorspace.WORK_RGB

    def enabled_by_default(self, meta):
        return False

    def plan(self, ctx: PlanContext, spec_in, p) -> OpPlan:
        if p.layers <= 0 or p.filling <= 0.0:
            return OpPlan(spec_in=spec_in, spec_out=spec_in, static=None)
        kernel_scale = max(1.0 / max(ctx.scale, 1e-6), 1e-6)
        banks = build_banks(p, kernel_scale, rng_seed=CRYSTGRAIN_SEED)
        radii = tuple(tuple(int(v) for v in row) for row in banks["radii"])
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=(p.mode, int(p.layers), radii,
                              round(p.filling, 4), round(p.grain_size, 4),
                              round(p.size_stddev, 4),
                              round(p.layer_capture, 4),
                              round(p.channel_correlation, 4)))

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p):
        if plan.static is None:
            return None
        kernel_scale = max(1.0 / max(ctx.scale, 1e-6), 1e-6)
        banks = build_banks(p, kernel_scale, rng_seed=CRYSTGRAIN_SEED)
        del banks["radii"]  # in the plan
        banks["corr"] = np.float32(
            np.clip(p.channel_correlation * 0.01, 0.0, 1.0))
        return banks

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        if plan.static is None:
            return x
        mode, _, radii = plan.static[:3]
        key = prng.PRNGKey(CRYSTGRAIN_SEED)
        if mode == MODE_MONO:
            from ..color import matrices as cm

            w = torch.as_tensor(np.asarray(cm.WORK_Y, np.float32),
                                device=x.device).reshape(3, 1, 1)
            lum = torch.sum(x * w, dim=0)
            printed = simulate_field(lum, c, key, radii) * c["exposure"]
            ratio = printed / torch.clamp(lum, min=1e-9)
            return x * ratio[None]
        # colour: shared geometry, decorrelated per channel
        layers = len(c["patches"])
        shape, dev = tuple(x.shape[1:]), x.device
        kshared, kc0, *chan_keys = prng.split(key, 5)
        shared_u = [prng.uniform(ku, shape, device=dev)
                    for ku in prng.split(kshared, layers)]
        shared_k = [prng.randint(kk, shape, 0, LAYER_KERNELS, device=dev)
                    for kk in prng.split(kc0, layers)]
        out = []
        for ch in range(3):
            kc = prng.split(chan_keys[ch], layers)
            printed = simulate_field(
                x[ch], c, chan_keys[ch], radii,
                corr_shared=(shared_u, shared_k, c["corr"], kc))
            out.append(printed * c["exposure"])
        return torch.stack(out)
