"""Hald CLUTs and drawlayer images in every form PIL writes, read by the
port (`io/lut3d_file.load_hald`, `ops/drawlayer._load_layer`) as the JAX
package reads them, through PIL, bit for bit: a 16-bit grey PNG, a
palette PNG, a grey PNG, an RGB and an RGBA PNG, a JPEG and a TIFF.  A
file PIL cannot read is a missing layer in both packages, and the same
OSError from both Hald loaders, which the lut3d op turns into the
identity in both.  With PIL hidden, the port's own PNG reader
(`read_png8`) reads the 8-bit RGB and RGBA PNGs alike and refuses the
rest as before: lut3d with NotImplementedError, drawlayer as a missing
layer."""

import sys

import numpy as np
import pytest
from PIL import Image

from ansel_tpu.core.params import params_class as ref_params_class
from ansel_tpu.io import lut3d_file as ref_file
from ansel_tpu.ops import drawlayer as ref_drawlayer
from ansel_tpu.ops import lut3d as ref_lut3d
from ansel_tpu_torch.core.params import params_class
from ansel_tpu_torch.io import lut3d_file
from ansel_tpu_torch.ops import drawlayer, lut3d

# a Hald CLUT of level 16: a 64 x 64 image
N = 64
# the forms PIL writes, by file name: how the RGB image becomes each
FORMS = {
    "grey16.png": lambda rgb: Image.fromarray(
        rgb[..., 1].astype(np.uint16) * 257),
    "palette.png": lambda rgb: Image.fromarray(rgb, "RGB").quantize(64),
    "grey.png": lambda rgb: Image.fromarray(rgb[..., 0], "L"),
    "rgb.png": lambda rgb: Image.fromarray(rgb, "RGB"),
    "rgba.png": lambda rgb: Image.fromarray(
        np.concatenate([rgb, rgb[..., :1] // 2 + 64], -1), "RGBA"),
    "hald.jpg": lambda rgb: Image.fromarray(rgb, "RGB"),
    "hald.tif": lambda rgb: Image.fromarray(rgb, "RGB"),
}
# the forms the port's PNG reader takes without PIL
PNG8 = ("rgb.png", "rgba.png")


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    d = tmp_path_factory.mktemp("pil-images")
    rgb = np.random.default_rng(14).integers(0, 256, (N, N, 3),
                                             dtype=np.uint8)
    paths = {}
    for name, make in FORMS.items():
        paths[name] = str(d / name)
        make(rgb).save(paths[name])
    paths["unreadable.png"] = str(d / "unreadable.png")
    with open(paths["unreadable.png"], "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n not an image")
    return paths


@pytest.fixture(scope="module")
def jax_reads(images):
    """The JAX package's Hald table and layer of each form, read through
    PIL."""
    return {name: (ref_file.load_hald(images[name]),
                   ref_drawlayer._load_layer(images[name], ""))
            for name in FORMS}


@pytest.fixture
def no_pil(monkeypatch):
    """`from PIL import Image` raises ImportError, as on a machine
    without PIL."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)


def _layer_both(path):
    return (drawlayer._load_layer(path, ""),
            ref_drawlayer._load_layer(path, ""))


@pytest.mark.parametrize("name", sorted(FORMS))
def test_hald_equals_the_jax_package(images, name):
    got = lut3d_file.load_hald(images[name])
    want = ref_file.load_hald(images[name])
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (16, 16, 16, 3)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", sorted(FORMS))
def test_layer_equals_the_jax_package(images, name):
    got, want = _layer_both(images[name])
    assert got.shape == want.shape == (4, N, N)
    assert np.array_equal(got, want)


def test_unreadable_file_in_both_packages(images):
    """A file PIL cannot read: a missing layer in both packages, the
    same OSError from both Hald loaders, and so the identity from both
    lut3d ops."""
    path = images["unreadable.png"]
    assert _layer_both(path) == (None, None)
    for loader in (lut3d_file.load_hald, ref_file.load_hald):
        with pytest.raises(OSError):
            loader(path)
    port = lut3d.Lut3D().plan(None, None, params_class("lut3d")(
        filepath=path))
    ref = ref_lut3d.Lut3D().plan(None, None, ref_params_class("lut3d")(
        filepath=path))
    assert port.static == ref.static


@pytest.mark.parametrize("name", sorted(FORMS))
def test_without_pil_the_png_reader_reads_or_refuses(images, jax_reads,
                                                     no_pil, name):
    """Without PIL the 8-bit RGB and RGBA PNGs read as the JAX package
    reads them through PIL; lut3d refuses every other form, drawlayer
    takes it for a missing layer."""
    path = images[name]
    if name in PNG8:
        hald, layer = jax_reads[name]
        assert np.array_equal(lut3d_file.load_hald(path), hald)
        assert np.array_equal(drawlayer._load_layer(path, ""), layer)
        return
    with pytest.raises(NotImplementedError):
        lut3d_file.load_hald(path)
    assert drawlayer._load_layer(path, "") is None
