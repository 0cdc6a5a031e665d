"""One diffuse-or-sharpen iteration: the CUDA kernel (`csrc/diffuse.cu`) and
its plain twin.

Both compute what `ansel_tpu/kernels/diffuse_pallas.py:
diffuse_iteration_pallas` computes on the TPU (reference
`src/iop/diffuse.c`): on a (3, H, W) image, an S-scale B3 a-trous
decompose (vertical pass first), then the coarse-to-fine anisotropic PDE
per channel and scale, operation for operation in the order of that
kernel's `_kernel` (not of the XLA path `ops/diffuse._pde_step`, which
splits the stencil and the energy sum differently).

Like the Pallas kernel, both edge-pad the image once, by the iteration's
reach 3 (2^S - 1), and run every stage on the padded frame: the result is
exactly the iteration of the edge-extended image.  (The JAX package's XLA
path re-pads at every blur, which differs inside that ring.)

`diffuse_iteration` launches the kernel for a CUDA tensor and runs
`diffuse_iteration_reference` for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from ..pixel.shifts import pad2d
from ._build import COUNT_LOCK

B3 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)
MAX_SCALES = 5
ISO = 0          # isotropy modes: ISO_ISOTROPE, ISO_ISOPHOTE, ISO_GRADIENT
FLT_MIN = 1e-8

# launch geometry of csrc/diffuse.cu, which checks every planned size
# against its own: the output tile of a block, the shared memory a block
# may have on sm_90, and the fine scales that share one launch of each
# kind (reach 2 (1 + 2 + 4) = 14 px in the decompose, 7 px in the PDE)
TILE_H, TILE_W = 32, 64
MAX_SMEM = 232448
FUSED_SCALES = 3
DECOMPOSE, PDE = 0, 1

# launches of the CUDA kernel since the count was last set to 0
LAUNCHES = 0


def halo(scales: int) -> int:
    """Reach of one iteration: 2 (2^S - 1) for the decompose, 2^S - 1 for
    the PDE."""
    return 3 * ((1 << scales) - 1)


def _sh(a, dy, dx):
    """a[..., y + dy, x + dx], wrapping at the padded frame's edge (the
    wrapped values stay in the ring that is cropped)."""
    if dy:
        a = torch.roll(a, -dy, -2)
    if dx:
        a = torch.roll(a, -dx, -1)
    return a


def _sum(terms):
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


def _sep_blur(p, scale):
    d = 1 << scale
    row = _sum([B3[k] * _sh(p, (k - 2) * d, 0) for k in range(5)])
    return _sum([B3[k] * _sh(row, 0, (k - 2) * d) for k in range(5)])


def _box9(p, d):
    rowp = _sh(p, 0, -d) + p + _sh(p, 0, d)
    return _sh(rowp, -d, 0) + rowp + _sh(rowp, d, 0)


def _conv_pieces(p, d, modes_pair, need_dir):
    out = {"c": p}
    if all(m == ISO for m in modes_pair) and not need_dir:
        l, r = _sh(p, 0, -d), _sh(p, 0, d)
        rowp = 0.5 * (l + r) + p
        out["iso"] = (0.5 * (_sh(rowp, -d, 0) + _sh(rowp, d, 0))
                      + rowp - 4.0 * p)
        return out
    l, r = _sh(p, 0, -d), _sh(p, 0, d)
    u, dn = _sh(p, -d, 0), _sh(p, d, 0)
    rd = l - r
    out["V"] = u + dn
    out["H"] = l + r
    out["D"] = _sh(rd, -d, 0) - _sh(rd, d, 0)
    if need_dir:
        out["gx"] = (dn - u) * 0.5
        out["gy"] = (r - l) * 0.5
    if any(m == ISO for m in modes_pair):
        out["iso"] = (0.25 * (_sh(out["H"], -d, 0) + _sh(out["H"], d, 0))
                      + 0.5 * (out["V"] + out["H"]) - 3.0 * p)
    return out


def _direction(gx, gy):
    """-> (cos^2, sin^2, cos*sin, magnitude), the angle 0 where the
    magnitude is 0 (ops/diffuse._direction's rsqrt form)."""
    m2 = gx * gx + gy * gy
    zero = (m2 == 0.0).to(gx.dtype)
    inv = torch.rsqrt(m2 + zero)
    cx = gx * inv + zero
    sy = gy * inv
    return cx * cx, sy * sy, cx * sy, m2 * inv


def _aniso_abc(c2, cs, c_sq, s_sq, mode):
    if mode == 1:  # ISO_ISOPHOTE
        return (c_sq + c2 * s_sq, c2 * c_sq + s_sq, (c2 - 1.0) * cs)
    return (c2 * c_sq + s_sq, c_sq + c2 * s_sq, (1.0 - c2) * cs)


def diffuse_iteration_reference(x: torch.Tensor, c, scales: int,
                                modes) -> torch.Tensor:
    """Plain torch, on all three channels at once: (3, H, W) -> (3, H, W).
    `c` holds the op's coefficients as tensors."""
    m = halo(scales)
    h, w = x.shape[-2:]
    vt = c["variance_threshold"]
    aniso = c["aniso"].reshape(4)
    norm_reg = c["norm_reg"].reshape(-1)
    strength = c["strength"].reshape(-1)
    abcd = c["ABCD"].reshape(-1, 4)

    cur = pad2d(x, m)
    HF = []
    for s in range(scales):
        low = _sep_blur(cur, s)
        HF.append(cur - low)
        cur = low

    need_g = modes[0] != ISO or modes[2] != ISO
    need_l = modes[1] != ISO or modes[3] != ISO
    buf = cur
    for s in range(scales - 1, -1, -1):
        d = 1 << s
        q = (HF[s] * (1.0 / (torch.clamp(buf - FLT_MIN, min=0.0)
                             + FLT_MIN))) ** 2
        energy = torch.clamp(vt + _box9(q, d) * norm_reg[s] - FLT_MIN,
                             min=0.0) + FLT_MIN
        inv_energy = 1.0 / energy
        pl_lf = _conv_pieces(buf, d, (modes[0], modes[1]), need_g)
        pl_hf = _conv_pieces(HF[s], d, (modes[2], modes[3]), need_l)
        if need_g:
            dir_g = _direction(pl_lf["gx"], pl_lf["gy"])
        if need_l:
            dir_l = _direction(pl_hf["gx"], pl_hf["gy"])
        update = None
        for k, src in enumerate((pl_lf, pl_lf, pl_hf, pl_hf)):
            if modes[k] == ISO:
                deriv = src["iso"]
            else:
                c_sq, s_sq, cs, mag = dir_g if k % 2 == 0 else dir_l
                c2 = torch.exp(-mag * aniso[k])
                a11, a22, a12 = _aniso_abc(c2, cs, c_sq, s_sq, modes[k])
                deriv = (0.5 * a12 * src["D"] + a22 * src["V"]
                         + a11 * src["H"] - 2.0 * (a11 + a22) * src["c"])
            contrib = abcd[s, k] * deriv
            update = contrib if update is None else update + contrib
        acc = HF[s] * strength[s] + update * inv_energy
        buf = torch.clamp(acc + buf, min=0.0)
    return buf[:, m:m + h, m:m + w].contiguous()


def decompose_smem(first: int, count: int) -> int:
    """Shared bytes of a decompose launch over scales first .. first +
    count - 1: the staged input with the group's reach, its vertical pass
    and, if more than one scale, the next scale's input."""
    halo = 2 * ((1 << (first + count)) - (1 << first))
    after = halo - (2 << first)
    width = TILE_W + 2 * halo
    n = (TILE_H + 2 * halo) * width + (TILE_H + 2 * after) * width
    if count > 1:
        n += (TILE_H + 2 * after) * (TILE_W + 2 * after)
    return 4 * n


def pde_smem(first: int, last: int) -> int:
    """Shared bytes of a PDE launch over scales first down to last: the
    LF input and each HF_s with the halo 2^(s+1) - 2^last, the second LF
    buffer, and the energy operand q over the input."""
    lo = 1 << last

    def area(e):
        return (TILE_H + 2 * e) * (TILE_W + 2 * e)

    n = 2 * area((2 << first) - lo)
    n += sum(area((2 << s) - lo) for s in range(last, first + 1))
    if first > last:
        n += area((1 << first) - lo)
    return 4 * n


def launch_plan(scales: int):
    """The iteration's launches as rows (kind, first scale, scale count,
    shared bytes): the decompose groups from scale 0 up, then the PDE
    groups from the coarsest scale down to 0 (scales first .. first -
    count + 1).  The scales below FUSED_SCALES share one launch of each
    kind; each coarser scale runs alone."""
    fine = min(scales, FUSED_SCALES)
    rows = [(DECOMPOSE, 0, fine)]
    rows += [(DECOMPOSE, s, 1) for s in range(fine, scales)]
    rows += [(PDE, s, 1) for s in range(scales - 1, fine - 1, -1)]
    rows.append((PDE, fine - 1, fine))
    return [(kind, s, n, decompose_smem(s, n) if kind == DECOMPOSE
             else pde_smem(s, s - n + 1)) for kind, s, n in rows]


def _lib():
    from . import _build

    lib = _build.load("diffuse")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.diffuse_iteration.argtypes = [p, p, p, p, p, p, p, i, i, i, i,
                                          i, p]
        lib.diffuse_iteration.restype = ctypes.c_int
        lib.diffuse_limits.argtypes = [p, p, p]
        lib.diffuse_limits.restype = None
        got = [ctypes.c_int() for _ in range(3)]
        lib.diffuse_limits(*[ctypes.byref(v) for v in got])
        if [v.value for v in got] != [TILE_H, TILE_W, MAX_SMEM]:
            raise RuntimeError("csrc/diffuse.cu and kernels/diffuse.py "
                               "disagree on the tile or shared memory")
        lib._typed = True
    return lib


def pack_consts(c, scales: int) -> torch.Tensor:
    """[variance_threshold, aniso(4), norm_reg(S), strength(S), ABCD(S x 4)]
    as one float32 tensor on the coefficients' device (the Pallas
    kernel's scalar-memory layout)."""
    return torch.cat([
        c["variance_threshold"].reshape(1).float(),
        c["aniso"].reshape(4).float(),
        c["norm_reg"].reshape(-1)[:scales].float(),
        c["strength"].reshape(-1)[:scales].float(),
        c["ABCD"].reshape(-1)[:scales * 4].float(),
    ]).contiguous()


def diffuse_iteration(x: torch.Tensor, c, scales: int, modes) -> torch.Tensor:
    """One diffuse iteration on a (3, H, W) float32 tensor, 1 <= scales <=
    MAX_SCALES, `modes` the four kernels' isotropy modes.  A CPU tensor
    runs the plain version; a CUDA tensor launches csrc/diffuse.cu."""
    if x.device.type == "cpu":
        return diffuse_iteration_reference(x, c, scales, modes)
    if x.device.type != "cuda":
        raise ValueError(f"diffuse: unsupported device {x.device}")
    if (x.dtype != torch.float32 or x.dim() != 3 or x.shape[0] != 3
            or not x.is_contiguous() or x.numel() == 0):
        raise ValueError("diffuse: needs a contiguous non-empty (3, H, W) "
                         f"float32 tensor, got {x.dtype} {tuple(x.shape)}")
    if not 1 <= scales <= MAX_SCALES:
        raise ValueError(f"diffuse: scales {scales} outside [1, {MAX_SCALES}]")
    modes = tuple(int(m) for m in modes)
    if len(modes) != 4 or any(m not in (0, 1, 2) for m in modes):
        raise ValueError(f"diffuse: bad isotropy modes {modes}")
    consts = pack_consts(c, scales)
    if consts.device != x.device or consts.numel() != 5 + 6 * scales:
        raise ValueError("diffuse: coefficients must be on the image's "
                         f"device with {scales} scales")
    global LAUNCHES
    lib = _lib()
    _, h, w = x.shape
    m = halo(scales)
    hp, wp = h + 2 * m, w + 2 * m
    lf = torch.empty((2, 3, hp, wp), dtype=x.dtype, device=x.device)
    hf = torch.empty((scales, 3, hp, wp), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    host_modes = (ctypes.c_int * 4)(*modes)
    plan = launch_plan(scales)
    host_plan = (ctypes.c_int * (4 * len(plan)))(*[v for row in plan
                                                   for v in row])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.diffuse_iteration(
            x.data_ptr(), out.data_ptr(), lf.data_ptr(), hf.data_ptr(),
            consts.data_ptr(), host_modes, host_plan, len(plan), h, w,
            scales, m, stream)
    if rc != 0:
        raise RuntimeError(f"diffuse: CUDA launch failed ({rc})")
    with COUNT_LOCK:
        LAUNCHES += 1
    return out
