"""rawdenoiseai — CNN raw denoiser (U-Net on the mosaic).

Reference: `ansel/src/iop/rawdenoiseai.c` (params v1,
rawdenoiseai.c:159-176) + the inference engine `src/common/nn_model.{h,c}`.
Input planes (fine stage, rawdenoiseai.c:874-905): [mosaic, R/G/B one-hot,
sigma] with sigma = scale[c] * sqrt(a[c]*max(v,0) + b[c]) from the noise
profile variance line and the per-channel correction sliders; output is the
noise residual subtracted from the mosaic, blended by `strength`.

Planning, coefficients and both architectures follow
`ansel_tpu/ops/rawdenoiseai.py`: "unet" (single-scale) and "unet-ms" (a
coarse superpixel net guiding the fine net, rawdenoiseai.c:1317-1342),
with the low-band fusion anchor (rawdenoiseai.c:1195-1260).  Models load
from `.anselnn` files (`io/anselnn.py`, the format both packages share)
and resolve as in the JAX package: an entry of this package's
MODEL_REGISTRY, then `custom_model` under MODEL_SEARCH_PATH.  The plan
keeps the resolved model (`OpPlan.aux`) and its weights are
coefficients, so they reach the device once, when the pipe is built,
and a later change of the registry does not reach a planned pipe.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.params import cfield, params
from ..core.types import CFAPattern, Colorspace
from ..io.anselnn import NNModel, load_anselnn
from ..kernels.unet import unet_forward
from . import _bayer
from .base import Op, OpPlan, PlanContext, register

# host-side registry: name -> NNModel (tests and apps inject models here;
# the reference resolves shipped models from its data dir the same way)
MODEL_REGISTRY: Dict[str, NNModel] = {}
# the JAX package's directory: the file format is shared
MODEL_SEARCH_PATH = [os.path.expanduser("~/.config/ansel_tpu/models")]


@params(op="rawdenoiseai", version=1)
@dataclasses.dataclass
class RawDenoiseAIParams:
    strength: float = cfield("f", 0.85)
    version: int = cfield("i", 0)
    size: int = cfield("i", 0)
    noise_level: float = cfield("f", 1.0)
    sigma_red: float = cfield("f", 2.82)
    sigma_green: float = cfield("f", 3.94)
    sigma_blue: float = cfield("f", 2.96)
    scale_variant: int = cfield("i", 0)
    custom_model: str = cfield("s:128", "")


def _resolve_model(p: RawDenoiseAIParams) -> Optional[NNModel]:
    name = p.custom_model or f"v{p.version}_s{p.size}_sc{p.scale_variant}"
    if name in MODEL_REGISTRY:
        return MODEL_REGISTRY[name]
    if p.custom_model:
        for d in MODEL_SEARCH_PATH:
            path = os.path.join(d, p.custom_model)
            if os.path.exists(path):
                model = load_anselnn(path)
                MODEL_REGISTRY[name] = model
                return model
    return None


def reflect_pad_tail(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """`jnp.pad(x, ((0, ph), (0, pw)), mode="reflect")` on the last two
    axes: mirrored about the last row and column without repeating them,
    and mirrored again (period 2 (n - 1)) where the pad is longer than
    the axis, which `F.pad` refuses."""
    for axis, pad in ((-2, ph), (-1, pw)):
        if pad == 0:
            continue
        n = x.shape[axis]
        i = torch.arange(n + pad, device=x.device)
        if n > 1:
            i = i % (2 * (n - 1))
            i = torch.where(i >= n, 2 * (n - 1) - i, i)
        else:
            i = torch.zeros_like(i)
        x = torch.index_select(x, x.dim() + axis, i)
    return x


def _binned(p: torch.Tensor, s: int) -> torch.Tensor:
    """(H, W) -> (H/s, W/s) sums of s x s blocks."""
    h, w = p.shape
    return p.reshape(h // s, s, w // s, s).sum((1, 3))


def _selects(c, spec, meta, h, w, device):
    """The per-site planes of the coefficients a, b and scale."""
    out = []
    for key in ("a", "b", "scale"):
        v = c[key]
        if spec.cfa is CFAPattern.XTRANS:
            out.append(_bayer.xtrans_color_select(
                [v[0], v[1], v[2]], meta.xtrans, h, w, device))
        else:
            out.append(_bayer.color_select([v[0], v[1], v[2], v[1]],
                                           spec.cfa, h, w, device))
    return out


@register
class RawDenoiseAI(Op):
    name = "rawdenoiseai"
    input_colorspace = Colorspace.RAW

    def plan(self, ctx: PlanContext, spec_in, p: RawDenoiseAIParams) -> OpPlan:
        model = _resolve_model(p)
        key = None
        if model is not None:
            key = (p.custom_model
                   or f"v{p.version}_s{p.size}_sc{p.scale_variant}")
        return OpPlan(spec_in=spec_in, spec_out=spec_in, static=key,
                      aux=model)

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p: RawDenoiseAIParams):
        if plan.static is None:
            return None
        model = plan.aux
        # generic profile fallback (profiled values come from
        # noiseprofiles.json when available)
        a = np.full(3, 1e-4, np.float32)
        b = np.full(3, 1e-6, np.float32)
        scale = np.float32([p.sigma_red, p.sigma_green, p.sigma_blue]) \
            * p.noise_level
        out = {
            "a": a, "b": b, "scale": scale,
            "strength": np.float32(p.strength),
        }
        if model.has_coarse:
            out["weights_fine"] = dict(model.stage("fine").tensors)
            out["weights_coarse"] = dict(model.stage("coarse").tensors)
        else:
            out["weights"] = dict(model.tensors)
        return out

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        if plan.static is None:
            return x  # no model resolved: identity (reference disables)
        model = plan.aux
        spec = plan.spec_in
        h, w = spec.pad_h, spec.pad_w
        dev = x.device
        if spec.cfa is CFAPattern.XTRANS:
            masks = _bayer.xtrans_color_masks(ctx.meta.xtrans, h, w, dev)
        else:
            masks = _bayer.color_masks(spec.cfa, h, w, dev)
        a, b, sc = _selects(c, spec, ctx.meta, h, w, dev)
        var = a * torch.clamp(x, min=0.0) + b
        sigma = sc * torch.sqrt(torch.clamp(var, min=1e-12))
        planes = torch.stack([x, masks[0], masks[1], masks[2], sigma])

        if model.has_coarse:
            # multi-scale ("unet-ms"): denoise the superpixel-binned RGB
            # with the coarse net, inject the nearest-upsampled result as
            # guide planes 5-7 (rawdenoiseai.c:1317-1342)
            binf = model.bin_for(spec.cfa is CFAPattern.XTRANS)
            align = binf * (1 << model.stage("coarse").depth)
            ph2 = -(-h // align) * align
            pw2 = -(-w // align) * align
            xb = reflect_pad_tail(x, ph2 - h, pw2 - w)
            mb = reflect_pad_tail(masks, ph2 - h, pw2 - w)
            coarse_rgb, coarse_sig = [], []
            for ch in range(3):
                m = mb[ch]
                num = _binned(xb * m, binf)
                n = torch.clamp(_binned(m, binf), min=1.0)
                mean = num / n
                coarse_rgb.append(mean)
                cvar = (c["a"][ch] * torch.clamp(mean, min=0.0)
                        + c["b"][ch]) / n
                coarse_sig.append(c["scale"][ch] * torch.sqrt(
                    torch.clamp(cvar, min=1e-12)))
            coarse_in = torch.stack(coarse_rgb + coarse_sig)
            head = unet_forward(model.stage("coarse"), coarse_in,
                                weights=c["weights_coarse"])
            coarse_dn = coarse_in[:3] - head  # nn_residual
            guide = coarse_dn.repeat_interleave(binf, dim=1) \
                .repeat_interleave(binf, dim=2)[:, :h, :w]
            planes = torch.cat([planes, guide], dim=0)
            noise = unet_forward(model.stage("fine"), planes,
                                 weights=c["weights_fine"])[0]
        else:
            noise = unet_forward(model, planes, weights=c["weights"])[0]
        denoised = x - noise
        if model.anchor > 0:
            denoised = low_band_anchor(x, masks, sigma, denoised)
        s = c["strength"]
        return x * (1.0 - s) + denoised * s


# --- low-band fusion anchor (rawdenoiseai.c:1195-1260) ----------------------

_FUSION_FINEST = 16
_FUSION_COARSEST = 64
_FUSION_DENS = (0.25, 0.5, 0.25)
_FUSION_T = 2.5


def _blur3(p):
    """3x3 clamped-edge box mean."""
    from ..pixel.shifts import PaddedView

    pv = PaddedView(p, 1)
    return sum(pv.at(dy, dx) for dy in (-1, 0, 1)
               for dx in (-1, 0, 1)) / 9.0


def _blocksum(p, s):
    return _binned(p, s)


def upsample_linear(p, shape):
    """`jax.image.resize(p, shape, "linear")` of an (H, W) plane to a
    whole multiple of its size: half-pixel centres, the edge samples
    clamped."""
    return F.interpolate(p[None, None], size=tuple(shape), mode="bilinear",
                         align_corners=False)[0, 0]


def _up2(p):
    h, w = p.shape
    return upsample_linear(p, (h * 2, w * 2))


def low_band_anchor(x, onehot, sigma, denoised):
    """Hybrid low-band fusion (rawdenoiseai.c:1195-1260 /
    cfa.fuse_low_bands): anchor the denoised plane's 16/32/64-px bands to
    the measurement with structure/Wiener gates; hallucination-free at
    the coarsest band.  All tensors (H, W); onehot: (3, H, W)."""
    h, w = x.shape
    S = _FUSION_COARSEST
    ph, pw = -(-h // S) * S - h, -(-w // S) * S - w
    xs = reflect_pad_tail(x, ph, pw)
    ds = reflect_pad_tail(denoised, ph, pw)
    sg = reflect_pad_tail(sigma, ph, pw)
    ohs = reflect_pad_tail(onehot, ph, pw)

    # level-0 (16 px) M/D/V per channel
    levels = []  # [(M, D, V)] per level, each a list of 3 planes
    M0, D0, V0 = [], [], []
    for c in range(3):
        cnt = torch.clamp(_blocksum(ohs[c], _FUSION_FINEST), min=1.0)
        M0.append(_blocksum(xs * ohs[c], _FUSION_FINEST) / cnt)
        D0.append(_blocksum(ds * ohs[c], _FUSION_FINEST) / cnt)
        V0.append(_blocksum(sg * sg * ohs[c], _FUSION_FINEST) / cnt)
    levels.append((M0, D0, V0))
    nlev = 1
    s = _FUSION_FINEST
    while s < _FUSION_COARSEST:
        prev = levels[-1]
        levels.append(tuple(
            [_blocksum(pl, 2) / 4.0 for pl in group] for group in prev))
        nlev += 1
        s *= 2

    # floor fuse at the coarsest band (measurement-gated)
    Mc, Dc, Vc = levels[-1]
    Sc = _FUSION_FINEST << (nlev - 1)
    fused = []
    for c in range(3):
        vscale = 1.0 / (_FUSION_DENS[c] * Sc * Sc)
        mloc = Mc[c] - _blur3(Mc[c])
        structure = _blur3(mloc * mloc)
        vn = Vc[c] * vscale
        structure = torch.clamp(structure - _FUSION_T * vn, min=0.0)
        wgt = structure / (structure + vn + 1e-20)
        fused.append(wgt * Dc[c] + (1.0 - wgt) * Mc[c])

    # coarse-to-fine Wiener band fusion
    for k in range(nlev - 2, -1, -1):
        Mf, Df, Vf = levels[k]
        Mc_, Dc_, _ = levels[k + 1]
        sc = _FUSION_FINEST << k
        new_fused = []
        for c in range(3):
            upD = _up2(Dc_[c])
            upM = _up2(Mc_[c])
            upF = _up2(fused[c])
            band = (Df[c] - upD) - (Mf[c] - upM)
            acc = _blur3(band * band)
            vscale = (1.0 / (_FUSION_DENS[c] * sc * sc)
                      - 1.0 / (_FUSION_DENS[c] * 4.0 * sc * sc))
            vn = Vf[c] * vscale
            vm = torch.clamp(acc - _FUSION_T * vn, min=0.0)
            wgt = vn / (vn + vm + 1e-20)
            new_fused.append(upF + wgt * (Df[c] - upD)
                             + (1.0 - wgt) * (Mf[c] - upM))
        fused = new_fused

    # bilinear scatter of (fused - D16) onto the owning channel's sensels
    out = ds
    for c in range(3):
        corr = fused[c] - levels[0][1][c]
        up = upsample_linear(corr, ds.shape)
        out = out + ohs[c] * up
    return out[:h, :w]
