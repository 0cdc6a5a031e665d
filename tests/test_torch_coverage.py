"""Which of ansel_tpu's registered ops the port has: one case per op of
`ansel_tpu.ops.base.all_ops()`.  A ported op is registered in the port
under the same name, with the same op class name, params version and
default params blob; each op not ported yet is an expected failure
(strict, so porting one without adding it to PORTED fails here).  The
count is printed and pinned, and so is the port's copy of the registry's
names (`ops.base.REFERENCE_OPS`)."""

import pytest

from ansel_tpu.core.params import params_class as ref_params_class
from ansel_tpu.ops.base import all_ops as ref_all_ops
from ansel_tpu_torch.core.params import params_class
from ansel_tpu_torch.ops.base import REFERENCE_OPS, all_ops

REF_OPS = ref_all_ops()
PORTED = frozenset({
    # slices 1-5
    "bilat", "bilateral", "channelmixerrgb", "colorin", "colorout",
    "colorreconstruct", "demosaic", "denoiseprofile", "diffuse", "exposure",
    "filmicrgb", "highlights", "highpass", "lens", "lowpass", "monochrome",
    "rawprepare", "shadhi", "sharpen", "soften", "temperature", "toneequal",
    # slice 10
    "bloom", "cacorrect", "cacorrectrgb", "defringe", "hotpixels",
    "nlmeans", "rawdenoise",
    # slice 11
    "clipping", "crop", "finalscale", "flip", "initialscale",
    "restorescans", "rotatepixels", "scalepixels",
    # the grading ops, atrous and zonesystem
    "atrous", "basecurve", "basicadj", "colorbalancergb", "colorzones",
    "graduatednd", "levels", "negadoctor", "rgbcurve", "rgblevels",
    "tonecurve", "vignette", "zonesystem",
    # the legacy pointwise ops and the last two warps
    "ashift", "colisa", "colorbalance", "colorchecker", "colorcontrast",
    "colorcorrection", "colorize", "liquify", "lowlight", "profile_gamma",
    "splittoning", "splittoningrgb", "velvia", "vibrance",
    # the generator's callers and the full-size guided filters' ops
    "censorize", "colormapping", "crystgrain", "dither", "globaltonemap",
    "grain", "hazeremoval", "tonemap",
    # the blend and mask machinery's ops and the sidecar's plumbing
    "gamma", "mask_manager", "retouch", "spots",
    # the sidecar machinery's last ops: a painted layer and 3D LUTs
    "drawlayer", "lut3d",
    # the last creative and export ops
    "blurs", "borders", "channelmixer", "colorequal", "colorprimaries",
    "filmic", "invert", "relight", "watermark",
    # the CNN raw denoiser
    "rawdenoiseai",
})


def _case(name):
    if name in PORTED:
        return name
    return pytest.param(name, marks=pytest.mark.xfail(
        strict=True, reason=f"{name} is not ported yet"))


@pytest.mark.parametrize("name", [_case(n) for n in sorted(REF_OPS)])
def test_op_is_ported(name):
    port = all_ops()
    assert name in port
    assert type(port[name]).__name__ == type(REF_OPS[name]).__name__
    ref_cls, cls = ref_params_class(name), params_class(name)
    assert cls.op_version == ref_cls.op_version
    assert cls.codec.encode(cls()) == ref_cls.codec.encode(ref_cls())


def test_coverage_count():
    port = all_ops()
    assert set(port) == PORTED
    assert set(port) <= set(REF_OPS)
    print(f"ansel_tpu_torch ports {len(port)}/{len(REF_OPS)} ops")
    assert (len(port), len(REF_OPS)) == (88, 88)


def test_reference_ops_are_pinned():
    """The port's copy of the registry's names (the planner refuses these
    and skips any other, as the JAX package skips what it does not
    register)."""
    assert REFERENCE_OPS == frozenset(REF_OPS)
