"""Guided filters (`ansel_tpu/pixel/guided.py`; reference
`src/pixel/guided_filter.c`, `src/pixel/fast_guided_filter.h`,
`src/pixel/eigf.h`).

The full-size filters: `guided_filter` (He et al.; hazeremoval, tonemap,
globaltonemap), `fast_guided_filter` (its (a, b) surface at a block-mean
downsample, upsampled as `jax.image.resize(..., "linear")` through
`pixel/resample.resize_bilinear`; colormapping) and `eigf` (the
exposure-independent variant).  Then toneequal's surface blurs:
`fast_surface_blur` (the guided filter at a 4x downsample) and
`eigf_surface_blur` (its (average, square) pair through
`pixel/blur.gaussian_iir`, the IIR kernel on the device).  Every box mean
is `pixel/blur.box_blur`: the sepblur kernel for radii up to 7,
cumulative sums beyond.
"""

from __future__ import annotations

import torch

from .blur import box_blur, gaussian_iir
from .resample import resize_bilinear
from .shifts import pad_tail


def guided_filter(guide: torch.Tensor, src: torch.Tensor, radius: int,
                  eps: float) -> torch.Tensor:
    """Classic guided filter on (H, W) planes."""
    mean_i = box_blur(guide, radius)
    mean_p = box_blur(src, radius)
    corr_ip = box_blur(guide * src, radius)
    corr_ii = box_blur(guide * guide, radius)
    # clamp: the box sums' float32 cancellation can push var below 0
    var_i = torch.clamp(corr_ii - mean_i * mean_i, min=0.0)
    cov_ip = corr_ip - mean_i * mean_p
    a = cov_ip / (var_i + eps)
    b = mean_p - a * mean_i
    return box_blur(a, radius) * guide + box_blur(b, radius)


def fast_guided_filter(guide: torch.Tensor, src: torch.Tensor, radius: int,
                       eps: float, scaling: int = 4) -> torch.Tensor:
    """Subsampled guided filter (fast_guided_filter.h:280-344): the (a, b)
    affine surface on a `scaling`-times block-mean downsample at radius /
    scaling, upsampled bilinearly and applied at full size."""
    if radius < 4 or scaling <= 1:
        return guided_filter(guide, src, radius, eps)
    s = int(scaling)
    H, W = guide.shape[-2:]
    Hp, Wp = -(-H // s) * s, -(-W // s) * s
    g = pad_tail(guide, Hp - H, Wp - W)
    p = pad_tail(src, Hp - H, Wp - W)
    gs = g.reshape(Hp // s, s, Wp // s, s).mean(dim=(1, 3))
    ps = p.reshape(Hp // s, s, Wp // s, s).mean(dim=(1, 3))
    r = max(1, radius // s)
    mean_i = box_blur(gs, r)
    mean_p = box_blur(ps, r)
    corr_ip = box_blur(gs * ps, r)
    corr_ii = box_blur(gs * gs, r)
    var_i = torch.clamp(corr_ii - mean_i * mean_i, min=0.0)
    cov_ip = corr_ip - mean_i * mean_p
    a = box_blur(cov_ip / (var_i + eps), r)
    b = box_blur(mean_p - (cov_ip / (var_i + eps)) * mean_i, r)
    a_full = resize_bilinear(a, (Hp, Wp))[..., :H, :W]
    b_full = resize_bilinear(b, (Hp, Wp))[..., :H, :W]
    return a_full * guide + b_full


def eigf(guide: torch.Tensor, src: torch.Tensor, radius: int,
         feathering: float) -> torch.Tensor:
    """Exposure-independent guided filter (eigf.h): the local variance
    normalised by the local mean squared."""
    mean_g = box_blur(guide, radius)
    mean_s = box_blur(src, radius)
    corr_gg = box_blur(guide * guide, radius)
    corr_gs = box_blur(guide * src, radius)
    var_g = torch.clamp(corr_gg - mean_g * mean_g, min=0.0)
    cov_gs = corr_gs - mean_g * mean_s
    norm = torch.clamp(mean_g * mean_g, min=1e-12)
    a = cov_gs / (var_g + feathering * norm)
    b = mean_s - a * mean_g
    return box_blur(a, radius) * guide + box_blur(b, radius)


def _upsample_node(x: torch.Tensor, s: int, axis: int) -> torch.Tensor:
    """Node-aligned integer-factor bilinear upsample on one axis:
    out[q*s + p] = (1 - p/s) * x[q] + (p/s) * x[q+1] (edge-clamped), the
    interpolate_bilinear mapping (fast_guided_filter.h:99-151) when
    out = s * in."""
    axis = axis % x.dim()
    n = x.shape[axis]
    nxt = torch.cat([x.narrow(axis, 1, n - 1), x.narrow(axis, n - 1, 1)],
                    dim=axis)
    phases = [(1.0 - p / s) * x + (p / s) * nxt for p in range(s)]
    stacked = torch.stack(phases, dim=axis + 1)
    shape = list(x.shape)
    shape[axis] *= s
    return stacked.reshape(shape)


def _axis_gather(x: torch.Tensor, n_out: int, axis: int) -> torch.Tensor:
    """interpolate_bilinear along one axis at a non-integer ratio."""
    n_in = x.shape[axis]
    pos = (torch.arange(n_out, dtype=torch.float32, device=x.device)
           * (n_in / n_out))
    prev = torch.clamp(torch.floor(pos).to(torch.int64), 0, n_in - 1)
    nxt = torch.clamp(prev + 1, 0, n_in - 1)
    w_next = torch.clamp(nxt.to(torch.float32) - pos, 0.0, 1.0)
    shape = [1] * x.dim()
    shape[axis] = n_out
    w_next = w_next.reshape(shape)
    a = torch.index_select(x, axis % x.dim(), prev)
    b = torch.index_select(x, axis % x.dim(), nxt)
    return w_next * a + (1.0 - w_next) * b


def _interp_node(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """interpolate_bilinear (fast_guided_filter.h:99-151) on the last two
    axes: decimation for an integer downsample, a phase unroll for an
    integer upsample, a gather along each axis otherwise."""
    in_h, in_w = x.shape[-2:]
    if (in_h, in_w) == (out_h, out_w):
        return x
    if (in_h >= out_h and in_w >= out_w
            and in_h % out_h == 0 and in_w % out_w == 0):
        return x[..., ::in_h // out_h, ::in_w // out_w]
    if (out_h >= in_h and out_w >= in_w
            and out_h % in_h == 0 and out_w % in_w == 0):
        return _upsample_node(_upsample_node(x, out_h // in_h, -2),
                              out_w // in_w, -1)
    return _axis_gather(_axis_gather(x, out_h, -2), out_w, -1)


def fast_surface_blur(image: torch.Tensor, radius: int, feathering,
                      iterations: int = 1,
                      geomean: bool = False) -> torch.Tensor:
    """fast_surface_blur (fast_guided_filter.h:269-365), no-quantization
    path: guided-filter variance analysis and (a, b) box means at a fixed
    4x downsample; the last (a, b) surface is upsampled and blended at
    full size, with geomean blending when asked."""
    H, W = image.shape[-2:]
    scaling = 4
    ds_radius = 1 if radius < 4 else int(radius // scaling)
    dh, dw = max(H // scaling, 1), max(W // scaling, 1)
    ds = _interp_node(image, dh, dw)
    ab = None
    for _ in range(iterations):
        mean_i = box_blur(ds, ds_radius)
        corr_ii = box_blur(ds * ds, ds_radius)
        var_i = torch.clamp(corr_ii - mean_i * mean_i, min=0.0)
        a = var_i / (var_i + feathering)
        b = mean_i - a * mean_i
        a = box_blur(a, ds_radius)
        b = box_blur(b, ds_radius)
        ab = (a, b)
        ds = a * ds + b
    a_f = _interp_node(ab[0], H, W)
    b_f = _interp_node(ab[1], H, W)
    lin = a_f * image + b_f
    if geomean:
        return torch.sqrt(torch.clamp(image * lin, min=0.0))
    return lin


def eigf_surface_blur(image: torch.Tensor, sigma: float, feathering,
                      iterations: int = 1,
                      geomean: bool = False) -> torch.Tensor:
    """fast_eigf_surface_blur (eigf.h:262-336), no-mask path: per
    iteration, downsample by clamp(sigma, 1, 4), Deriche average and
    variance at max(sigma / scaling, 1), upsample both and blend at full
    size with a = nvar / (nvar + feathering), nvar = var / max(avg * x,
    1e-6), b = avg - a * avg; geomean blending on the last iteration."""
    H, W = image.shape[-2:]
    scaling = min(max(float(sigma), 1.0), 4.0)
    ds_sigma = max(float(sigma) / scaling, 1.0)
    dh, dw = max(int(H / scaling), 1), max(int(W / scaling), 1)
    img = image
    for i in range(iterations):
        ds = _interp_node(img, dh, dw)
        blurred = gaussian_iir(torch.stack([ds, ds * ds]), ds_sigma)
        avg = blurred[0]
        var = torch.clamp(blurred[1] - avg * avg, min=0.0)
        avg_f = _interp_node(avg, H, W)
        var_f = _interp_node(var, H, W)
        norm = torch.clamp(avg_f * img, min=1e-6)
        nvar = var_f / norm
        a = nvar / (nvar + feathering)
        b = avg_f - a * avg_f
        lin = torch.clamp(img * a + b, min=1.17549435e-38)
        if geomean and i == iterations - 1:
            img = torch.sqrt(torch.clamp(img * lin, min=1.17549435e-38))
        else:
            img = lin
    return img
