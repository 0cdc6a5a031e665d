"""HSL <-> RGB of (3, H, W) tensors for the display-referred creative ops
(`ansel_tpu/ops/_hsl.py`; reference
src/common/colorspaces_inline_conversions.h)."""

from __future__ import annotations

import torch


def rgb_to_hsl(rgb: torch.Tensor):
    """(3, H, W) -> (h, s, l), each (H, W), h in [0, 1)."""
    mx = torch.amax(rgb, dim=0)
    mn = torch.amin(rgb, dim=0)
    l = (mx + mn) * 0.5
    d = mx - mn
    zero = torch.zeros_like(d)
    s = torch.where(
        d <= 1e-9, zero,
        torch.where(l < 0.5, d / torch.clamp(mx + mn, min=1e-9),
                    d / torch.clamp(2.0 - mx - mn, min=1e-9)))
    r, g, b = rgb[0], rgb[1], rgb[2]
    dd = torch.clamp(d, min=1e-9)
    h = torch.where(mx == r, (g - b) / dd % 6.0,
                    torch.where(mx == g, (b - r) / dd + 2.0,
                                (r - g) / dd + 4.0))
    h = torch.where(d <= 1e-9, zero, h / 6.0)
    return h, s, l


def hsl_to_rgb(h: torch.Tensor, s: torch.Tensor,
               l: torch.Tensor) -> torch.Tensor:
    c = (1.0 - torch.abs(2.0 * l - 1.0)) * s
    hp = (h % 1.0) * 6.0
    xv = c * (1.0 - torch.abs(hp % 2.0 - 1.0))
    m = l - c / 2.0
    z = torch.zeros_like(c)

    def pick(v0, v1, v2, v3, v4, v5):
        return torch.where(hp < 1, v0,
               torch.where(hp < 2, v1,
               torch.where(hp < 3, v2,
               torch.where(hp < 4, v3,
               torch.where(hp < 5, v4, v5)))))

    r = pick(c, xv, z, z, xv, c)
    g = pick(xv, c, c, xv, z, z)
    b = pick(z, z, xv, c, c, xv)
    return torch.stack([r + m, g + m, b + m])
