"""RCD Bayer demosaic: the CUDA kernel (`csrc/rcd.cu`) and its plain twin.

Both compute what `ansel_tpu/kernels/rcd_pallas.py:rcd_demosaic_pallas`
computes on the TPU: RCD (reference `ansel/src/iop/demosaic/rcd.c`) on
the mosaic normalised by `scaler` and edge-padded, cropped back, clamped
at 0 and multiplied by `scaler`.  RCD reads at most 10 px away, so an
even edge pad of 12 on every side gives the Pallas kernel's result
(its halo is 12 rows and 64 columns) at every pixel, borders included.

`rcd_demosaic` launches the kernel for a CUDA tensor and runs
`rcd_demosaic_reference` for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..core.types import CFAPattern

EPS = 1e-5
EPSSQ = 1e-10
PAD = 12  # even (keeps the CFA phase) and >= 10 (RCD's reach)

# launches of the CUDA kernel since the count was last set to 0
LAUNCHES = 0


def _cfa_code(cfa: CFAPattern) -> int:
    if cfa is None or cfa is CFAPattern.XTRANS:
        raise ValueError(f"RCD needs a Bayer pattern, got {cfa}")
    return sum(cfa.color_at(y, x) << (2 * (2 * y + x))
               for y in range(2) for x in range(2))


def _parity_masks(cfa: CFAPattern, h: int, w: int, device):
    """(h, w) boolean R/G/B site masks of a frame whose origin has the
    phase of `cfa`."""
    rp = torch.arange(h, device=device) % 2
    cp = torch.arange(w, device=device) % 2
    pos = rp[:, None] * 2 + cp[None, :]
    color = torch.tensor([cfa.color_at(y, x) for y in range(2)
                          for x in range(2)], device=device)[pos]
    return color == 0, color == 1, color == 2


def _sh(a, dy, dx):
    """_sh(a, dy, dx)[y, x] = a[y + dy, x + dx], wrapping at the frame
    edge; the wrapped values stay inside the ring the crop drops."""
    return torch.roll(a, shifts=(-dy, -dx), dims=(0, 1))


def _rcd_frame(c, cfa: CFAPattern):
    """All four RCD steps on one padded frame -> r, g, b (the Pallas
    kernel's `_rcd_tile`, operand for operand)."""
    is_r, is_g, is_b = _parity_masks(cfa, c.shape[0], c.shape[1], c.device)

    # Step 1: V/H discrimination
    hpf_v = (_sh(c, -3, 0) - _sh(c, -1, 0) - _sh(c, 1, 0) + _sh(c, 3, 0)
             - 3.0 * (_sh(c, -2, 0) + _sh(c, 2, 0)) + 6.0 * c) ** 2
    hpf_h = (_sh(c, 0, -3) - _sh(c, 0, -1) - _sh(c, 0, 1) + _sh(c, 0, 3)
             - 3.0 * (_sh(c, 0, -2) + _sh(c, 0, 2)) + 6.0 * c) ** 2
    v_stat = torch.clamp(_sh(hpf_v, -1, 0) + hpf_v + _sh(hpf_v, 1, 0),
                         min=EPSSQ)
    h_stat = torch.clamp(_sh(hpf_h, 0, -1) + hpf_h + _sh(hpf_h, 0, 1),
                         min=EPSSQ)
    vh_dir = v_stat / (v_stat + h_stat)

    def refine(d):
        nbh = 0.25 * (_sh(d, -1, -1) + _sh(d, -1, 1)
                      + _sh(d, 1, -1) + _sh(d, 1, 1))
        return torch.where(torch.abs(0.5 - d) < torch.abs(0.5 - nbh), nbh, d)

    vh_disc = refine(vh_dir)

    # Step 2: ratio-correcting binomial low-pass
    lpf = (c + 0.5 * (_sh(c, -1, 0) + _sh(c, 1, 0) + _sh(c, 0, -1)
                      + _sh(c, 0, 1))
           + 0.25 * (_sh(c, -1, -1) + _sh(c, -1, 1) + _sh(c, 1, -1)
                     + _sh(c, 1, 1)))

    # Step 3: green at non-green sites
    cn1, cs1 = _sh(c, -1, 0), _sh(c, 1, 0)
    cw1, ce1 = _sh(c, 0, -1), _sh(c, 0, 1)
    ns = torch.abs(cn1 - cs1)
    we = torch.abs(cw1 - ce1)
    n_g = EPS + ns + torch.abs(c - _sh(c, -2, 0)) \
        + torch.abs(cn1 - _sh(c, -3, 0)) \
        + torch.abs(_sh(c, -2, 0) - _sh(c, -4, 0))
    s_g = EPS + ns + torch.abs(c - _sh(c, 2, 0)) \
        + torch.abs(cs1 - _sh(c, 3, 0)) \
        + torch.abs(_sh(c, 2, 0) - _sh(c, 4, 0))
    w_g = EPS + we + torch.abs(c - _sh(c, 0, -2)) \
        + torch.abs(cw1 - _sh(c, 0, -3)) \
        + torch.abs(_sh(c, 0, -2) - _sh(c, 0, -4))
    e_g = EPS + we + torch.abs(c - _sh(c, 0, 2)) \
        + torch.abs(ce1 - _sh(c, 0, 3)) \
        + torch.abs(_sh(c, 0, 2) - _sh(c, 0, 4))
    two = lpf + lpf
    n_e = cn1 * two / (EPS + lpf + _sh(lpf, -2, 0))
    s_e = cs1 * two / (EPS + lpf + _sh(lpf, 2, 0))
    w_e = cw1 * two / (EPS + lpf + _sh(lpf, 0, -2))
    e_e = ce1 * two / (EPS + lpf + _sh(lpf, 0, 2))
    v_est = (s_g * n_e + n_g * s_e) / (n_g + s_g)
    h_est = (w_g * e_e + e_g * w_e) / (e_g + w_g)
    g = torch.where(is_g, c, vh_disc * h_est + (1.0 - vh_disc) * v_est)

    # Step 4.0/4.1: P/Q diagonal discrimination
    hpf_p = (_sh(c, -3, -3) - _sh(c, -1, -1) - _sh(c, 1, 1) + _sh(c, 3, 3)
             - 3.0 * (_sh(c, -2, -2) + _sh(c, 2, 2)) + 6.0 * c) ** 2
    hpf_q = (_sh(c, -3, 3) - _sh(c, -1, 1) - _sh(c, 1, -1) + _sh(c, 3, -3)
             - 3.0 * (_sh(c, -2, 2) + _sh(c, 2, -2)) + 6.0 * c) ** 2
    p_stat = torch.clamp(_sh(hpf_p, -1, -1) + hpf_p + _sh(hpf_p, 1, 1),
                         min=EPSSQ)
    q_stat = torch.clamp(_sh(hpf_q, -1, 1) + hpf_q + _sh(hpf_q, 1, -1),
                         min=EPSSQ)
    pq_disc = refine(p_stat / (p_stat + q_stat))

    # Step 4.2: opposite chroma at non-green sites
    def dg(dy, dx):
        return _sh(c, dy, dx) - _sh(g, dy, dx)

    nw = EPS + torch.abs(_sh(c, -1, -1) - _sh(c, 1, 1)) \
        + torch.abs(_sh(c, -1, -1) - _sh(c, -3, -3)) \
        + torch.abs(g - _sh(g, -2, -2))
    ne = EPS + torch.abs(_sh(c, -1, 1) - _sh(c, 1, -1)) \
        + torch.abs(_sh(c, -1, 1) - _sh(c, -3, 3)) \
        + torch.abs(g - _sh(g, -2, 2))
    sw = EPS + torch.abs(_sh(c, -1, 1) - _sh(c, 1, -1)) \
        + torch.abs(_sh(c, 1, -1) - _sh(c, 3, -3)) \
        + torch.abs(g - _sh(g, 2, -2))
    se = EPS + torch.abs(_sh(c, -1, -1) - _sh(c, 1, 1)) \
        + torch.abs(_sh(c, 1, 1) - _sh(c, 3, 3)) \
        + torch.abs(g - _sh(g, 2, 2))
    p_est = (nw * dg(1, 1) + se * dg(-1, -1)) / (nw + se)
    q_est = (ne * dg(1, -1) + sw * dg(-1, 1)) / (ne + sw)
    opp = g + (pq_disc * q_est + (1.0 - pq_disc) * p_est)
    zero = torch.zeros_like(c)
    r_nb = torch.where(is_r, c, torch.where(is_b, opp, zero))
    b_nb = torch.where(is_b, c, torch.where(is_r, opp, zero))

    # Step 4.3: chroma at green sites
    n1 = EPS + torch.abs(g - _sh(g, -2, 0))
    s1 = EPS + torch.abs(g - _sh(g, 2, 0))
    w1 = EPS + torch.abs(g - _sh(g, 0, -2))
    e1 = EPS + torch.abs(g - _sh(g, 0, 2))
    gn1, gs1 = _sh(g, -1, 0), _sh(g, 1, 0)
    gw1, ge1 = _sh(g, 0, -1), _sh(g, 0, 1)

    def at_green(p):
        sn = torch.abs(_sh(p, -1, 0) - _sh(p, 1, 0))
        ew = torch.abs(_sh(p, 0, -1) - _sh(p, 0, 1))
        ng = n1 + sn + torch.abs(_sh(p, -1, 0) - _sh(p, -3, 0))
        sg = s1 + sn + torch.abs(_sh(p, 1, 0) - _sh(p, 3, 0))
        wg = w1 + ew + torch.abs(_sh(p, 0, -1) - _sh(p, 0, -3))
        eg = e1 + ew + torch.abs(_sh(p, 0, 1) - _sh(p, 0, 3))
        v_e = (ng * (_sh(p, 1, 0) - gs1)
               + sg * (_sh(p, -1, 0) - gn1)) / (ng + sg)
        h_e = (eg * (_sh(p, 0, -1) - gw1)
               + wg * (_sh(p, 0, 1) - ge1)) / (eg + wg)
        return g + (vh_disc * h_e + (1.0 - vh_disc) * v_e)

    r = torch.where(is_g, at_green(r_nb), r_nb)
    b = torch.where(is_g, at_green(b_nb), b_nb)
    return r, g, b


def _scaler_tensor(scaler, device) -> torch.Tensor:
    return torch.as_tensor(scaler, dtype=torch.float32,
                           device=device).reshape(())


def rcd_demosaic_reference(x: torch.Tensor, cfa: CFAPattern,
                           scaler=1.0) -> torch.Tensor:
    """Plain torch RCD: (H, W) mosaic -> (3, H, W) camera RGB."""
    _cfa_code(cfa)
    h, w = x.shape
    s = _scaler_tensor(scaler, x.device)
    c = torch.clamp(x, min=0.0) / torch.clamp(s, min=1e-9)
    cp = F.pad(c[None], (PAD, PAD, PAD, PAD), mode="replicate")[0]
    r, g, b = _rcd_frame(cp, cfa)
    out = torch.stack([r, g, b])[:, PAD:PAD + h, PAD:PAD + w]
    return torch.clamp(out, min=0.0) * s


def _lib():
    from . import _build

    lib = _build.load("rcd")
    if not getattr(lib, "_typed", False):
        p = ctypes.c_void_p
        lib.rcd_demosaic.argtypes = [p, p, p, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, p, p]
        lib.rcd_demosaic.restype = ctypes.c_int
        lib.rcd_scratch_planes.argtypes = []
        lib.rcd_scratch_planes.restype = ctypes.c_int
        lib.rcd_pad.argtypes = []
        lib.rcd_pad.restype = ctypes.c_int
        if lib.rcd_pad() != PAD:
            raise RuntimeError("csrc/rcd.cu and kernels/rcd.py disagree on PAD")
        lib._typed = True
    return lib


def rcd_demosaic(x: torch.Tensor, cfa: CFAPattern, scaler=1.0) -> torch.Tensor:
    """(H, W) float32 mosaic -> (3, H, W) camera RGB.  A CPU tensor runs
    the plain version; a CUDA tensor launches csrc/rcd.cu."""
    if x.device.type == "cpu":
        return rcd_demosaic_reference(x, cfa, scaler)
    if x.device.type != "cuda":
        raise ValueError(f"rcd_demosaic: unsupported device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("rcd_demosaic: needs a contiguous 2-D float32 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    code = _cfa_code(cfa)
    h, w = x.shape
    if h < 1 or w < 1:
        raise ValueError(f"rcd_demosaic: empty mosaic {tuple(x.shape)}")
    global LAUNCHES
    lib = _lib()
    s = _scaler_tensor(scaler, x.device)
    out = torch.empty((3, h, w), dtype=torch.float32, device=x.device)
    scratch = torch.empty((lib.rcd_scratch_planes(), h + 2 * PAD, w + 2 * PAD),
                          dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.rcd_demosaic(x.data_ptr(), out.data_ptr(),
                              scratch.data_ptr(), h, w, code, s.data_ptr(),
                              stream)
    if rc != 0:
        raise RuntimeError(f"rcd_demosaic: CUDA launch failed ({rc})")
    LAUNCHES += 1
    return out
