"""The port's drawlayer (`ops/drawlayer.py`) against ansel_tpu on the CPU.

`plan().static` and `coeffs()` equal the JAX package's for a layer saved
as an HWC and as a CHW `.npz` and as an 8-bit RGBA or RGB PNG (read by
PIL in both, premultiplied alike; tests/test_torch_pil_images.py holds
the other forms and the port's PNG reader without PIL); a
missing named layer raises ValueError while planning in both packages
and an empty name plans a no-op.  `apply` composites the layer
source-over after `jax.image.resize`'s bilinear resize, upsampling and
downsampling (antialiased), within APPLY_TOL of the JAX op (measured
1.8e-7 on the downscale, 0 elsewhere: the resize's float32 products
summed in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ansel_tpu.core.params import params_class as ref_params_class
from ansel_tpu.core.types import Colorspace as RefCS
from ansel_tpu.core.types import ImageSpec as RefSpec
from ansel_tpu.core.types import RawMeta as RefMeta
from ansel_tpu.ops import base as ref_base
from ansel_tpu.ops import drawlayer as ref_drawlayer
from ansel_tpu_torch.core.params import params_class
from ansel_tpu_torch.core.types import Colorspace, ImageSpec, RawMeta
from ansel_tpu_torch.io import configs
from ansel_tpu_torch.ops import base, drawlayer

torch.set_num_threads(1)

APPLY_TOL = 2e-6
H, W = 40, 72


def _plan_both(name, h=H, w=W):
    p = params_class("drawlayer")(layer_name=name)
    rp = ref_params_class("drawlayer")(layer_name=name)
    ctx = base.PlanContext(meta=RawMeta(width=w, height=h))
    rctx = ref_base.PlanContext(meta=RefMeta(width=w, height=h))
    spec = ImageSpec(width=w, height=h, colorspace=Colorspace.WORK_RGB)
    rspec = RefSpec(width=w, height=h, colorspace=RefCS.WORK_RGB)
    op, rop = drawlayer.DrawLayer(), ref_drawlayer.DrawLayer()
    plan, rplan = op.plan(ctx, spec, p), rop.plan(rctx, rspec, rp)
    return ((op, ctx, plan, op.coeffs(ctx, plan, p)),
            (rop, rctx, rplan, rop.coeffs(rctx, rplan, rp)))


def _apply_both(port, ref, seed=0):
    op, ctx, plan, c = port
    rop, rctx, rplan, rc = ref
    spec = plan.spec_in
    x = np.random.default_rng(seed).uniform(0.0, 1.2, (
        3, spec.pad_h, spec.pad_w)).astype(np.float32)
    dev = None if c is None else {k: torch.from_numpy(v) for k, v in
                                  c.items()}
    got = op.apply(torch.from_numpy(x), dev, plan, ctx).numpy()
    want = np.asarray(rop.apply(jnp.asarray(x), rc, rplan, rctx))
    return got, want, x


@pytest.mark.parametrize("shape,layout", [
    ((24, 40), "hwc"), ((24, 40), "chw"), ((96, 300), "hwc"),
    ((40, 128), "chw")],
    ids=["upscale-hwc", "upscale-chw", "downscale", "same-size"])
def test_npz_layer_matches(tmp_path, shape, layout):
    rgba = configs.stroke14(int(shape[1]), shape)
    if layout == "chw":
        rgba = rgba.transpose(2, 0, 1)
    np.savez(tmp_path / "paint.npz", rgba=rgba)
    port, ref = _plan_both(str(tmp_path / "paint"))
    assert port[2].static == ref[2].static == (
        "layer", str(tmp_path / "paint")) + shape
    assert port[3].keys() == ref[3].keys() == {"rgba"}
    assert np.array_equal(port[3]["rgba"], ref[3]["rgba"])
    got, want, x = _apply_both(port, ref)
    assert np.abs(got - want).max() <= APPLY_TOL
    assert np.abs(got - x).max() > 0.05   # the stroke shows


@pytest.mark.parametrize("mode", ["RGBA", "RGB"])
def test_png_layer_matches(tmp_path, mode):
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (20, 36, len(mode)), dtype=np.uint8)
    Image.fromarray(img, mode).save(tmp_path / "paint.png")
    port, ref = _plan_both(str(tmp_path / "paint.png"))
    assert port[2].static == ref[2].static
    assert np.array_equal(port[3]["rgba"], ref[3]["rgba"])
    got, want, _ = _apply_both(port, ref)
    assert np.abs(got - want).max() <= APPLY_TOL


def test_missing_layer_raises_and_no_name_is_a_no_op(tmp_path):
    """A named layer that is missing, or a file neither reader takes,
    raises in each package."""
    (tmp_path / "paint.bmp").write_bytes(b"BM not a png")
    spec = ImageSpec(width=W, height=H, colorspace=Colorspace.WORK_RGB)
    rspec = RefSpec(width=W, height=H, colorspace=RefCS.WORK_RGB)
    for name in ("nowhere", "paint.bmp"):
        path = str(tmp_path / name)
        with pytest.raises(ValueError, match="not found"):
            drawlayer.DrawLayer().plan(
                base.PlanContext(meta=RawMeta(width=W, height=H)), spec,
                params_class("drawlayer")(layer_name=path))
        with pytest.raises(ValueError, match="not found"):
            ref_drawlayer.DrawLayer().plan(
                ref_base.PlanContext(meta=RefMeta(width=W, height=H)),
                rspec, ref_params_class("drawlayer")(layer_name=path))
    port, ref = _plan_both("")
    assert port[2].static is ref[2].static is None
    assert port[3] is ref[3] is None
    got, want, x = _apply_both(port, ref)
    assert np.array_equal(got, x) and np.array_equal(want, x)
