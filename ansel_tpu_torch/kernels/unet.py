"""U-Net inference for the built-in CNN denoiser (`ansel_tpu/kernels/unet.py`).

Reference: `ansel/src/common/nn_model.c` — fixed "unet" topology
(nn_model.h:40-46): per encoder level two 3x3 conv + GELU and a 2x2
stride-2 down conv; two-conv bottleneck; decoder of nearest x2 upsample,
1x1 channel-reduction conv, skip concat, two 3x3 conv + GELU; final 3x3
head predicting the noise residual.

The JAX package computes these convolutions with
`lax.conv_general_dilated` outside any Pallas kernel, so their
counterpart is `F.conv2d`.  JAX asks for float32 accumulation, while
cuDNN runs float32 convolutions in TF32 by default: `unet_forward` runs
its own calls in `CONV_FP32` (`conv_fp32`) and restores the setting
after them.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from ..io.anselnn import NNModel


# cuDNN's float32 convolution mode for the net's calls: IEEE float32, as
# the JAX package asks for float32 accumulation (cuDNN's default is TF32)
CONV_FP32 = "ieee"


@contextlib.contextmanager
def conv_fp32(mode: str):
    """cuDNN's float32 convolutions in `mode` ("ieee" or "tf32") for the
    length of the block; the setting before it comes back after it."""
    conv = torch.backends.cudnn.conv
    old = conv.fp32_precision
    conv.fp32_precision = mode
    try:
        yield
    finally:
        conv.fp32_precision = old


def _conv(x, w, b, stride=1):
    """x: (C, H, W), w: (O, I, kh, kw) -> (O, H', W'), SAME padding for
    odd kernels, VALID on the zero-padded even frame for the 2x2 down
    conv."""
    kh = w.shape[2]
    if kh == 2:  # stride-2 down conv: pad to even then VALID
        x = F.pad(x, (0, x.shape[2] % 2, 0, x.shape[1] % 2))
        padding = 0
    else:
        padding = kh // 2
    y = F.conv2d(x[None], w, None, stride, padding)[0]
    return y + b.reshape(-1, 1, 1)


def _upsample2(x, target_hw):
    """nearest x2 (nn_model.h decoder contract), cropped to the skip."""
    y = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    return y[:, : target_hw[0], : target_hw[1]]


def unet_forward(model: NNModel, planes: torch.Tensor,
                 weights=None) -> torch.Tensor:
    """planes: (in_channels, H, W) -> noise prediction (out_channels, H, W).

    `weights`: the tensors by name on the planes' device (the op's
    coefficients); defaults to the model's host tensors moved there."""
    t = weights if weights is not None else {
        k: torch.as_tensor(v, device=planes.device)
        for k, v in model.tensors.items()}
    depth = model.depth

    def gelu(v):
        return F.gelu(v, approximate="tanh")

    with conv_fp32(CONV_FP32):
        x = planes
        skips = []
        for l in range(depth):
            x = gelu(_conv(x, t[f"enc.{l}.0.weight"], t[f"enc.{l}.0.bias"]))
            x = gelu(_conv(x, t[f"enc.{l}.2.weight"], t[f"enc.{l}.2.bias"]))
            skips.append(x)
            x = _conv(x, t[f"down.{l}.weight"], t[f"down.{l}.bias"],
                      stride=2)
        x = gelu(_conv(x, t["bot.0.weight"], t["bot.0.bias"]))
        x = gelu(_conv(x, t["bot.2.weight"], t["bot.2.bias"]))
        for i in range(depth):
            skip = skips[depth - 1 - i]
            x = _upsample2(x, skip.shape[1:])
            x = _conv(x, t[f"up.{i}.weight"], t[f"up.{i}.bias"])
            x = torch.cat([x, skip], dim=0)
            x = gelu(_conv(x, t[f"dec.{i}.0.weight"], t[f"dec.{i}.0.bias"]))
            x = gelu(_conv(x, t[f"dec.{i}.2.weight"], t[f"dec.{i}.2.bias"]))
        return _conv(x, t["head.weight"], t["head.bias"])
