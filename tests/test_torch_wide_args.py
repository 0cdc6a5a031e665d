"""The repairs of F10 and F11 against ansel_tpu on the CPU: arguments that
the JAX package computes and the card's kernels used to refuse.

F10: NLM patch radii over 96.  `kernels/nlm.route` picks a form for every
patch radius and refuses none (the wide form streams its patch
distances, so its shared memory does not grow with P); the port's
`pixel/nlmeans.nlmeans` at P 97 and 130 on a seeded (3, 280, 300) image
over a 3 x 3 lattice, which the card runs through the wide form, equals
the JAX package's XLA scan (`nlmeans(..., force_xla=True)`) on the
interior, within NLM_TOL.  On the CPU the port runs the kernel's plain
twin, so this holds the twin; the card's kernel is held bit for bit
against the twin at P 97 and 130 in tests/test_torch_cuda.py.
F11: `sep_filter` on a tensor of more than three axes.  The port folds
the leading axes into one plane axis, so the sepblur wrapper, whose
kernel takes only (C, H, W) and (H, W), is handed a 3-D tensor; a seeded
(2, 3, 40, 56) tensor equals the per-plane 3-D results bit for bit and
the JAX package's `sep_filter` (its XLA chain for a 4-D tensor) within
SEP_TOL.

Tolerances: NLM_TOL, as in tests/test_torch_faults.py: the port sums
each offset's patch distances as its kernel does (column sums, then
rows, in order) where the XLA path box-sums them through cumulative
sums, so a weight's last bits differ; and the XLA path edge-pads the
patch distances where the port clamps the image, which differs on a
ring of P px (R7), so the comparison holds the interior (measured
2.4e-7 at P 97, 1.2e-7 at P 130).  SEP_TOL: both
take the same shifted adds in tap order; XLA's CPU compiler may contract
a product and a sum into one rounding (measured 0 here)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ansel_tpu.pixel import nlmeans as ref_nlmeans
from ansel_tpu.pixel import shifts as ref_shifts
from ansel_tpu_torch.kernels import nlm, sepblur
from ansel_tpu_torch.pixel import nlmeans, shifts
from ansel_tpu_torch.pixel.nlmeans import search_offsets

torch.set_num_threads(1)

NLM_TOL = 1e-5
SEP_TOL = 1e-6
B5 = (1 / 16, 4 / 16, 6 / 16, 4 / 16, 1 / 16)


@pytest.fixture(scope="module")
def frame():
    """A smooth seeded (3, 280, 300) image plus noise, values in [0, 1]."""
    rng = np.random.default_rng(10)
    yy, xx = np.mgrid[0:280, 0:300]
    img = np.stack([0.5 + 0.3 * np.sin(yy / (9.0 + 2 * i)) * np.cos(xx / 13.0)
                    for i in range(3)])
    return (img + 0.05 * rng.random(img.shape)).astype(np.float32)


@pytest.mark.parametrize("P", [0, 1, 8, 9, 96, 97, 130, 4096])
@pytest.mark.parametrize("K", [1, 7])
def test_nlm_route_takes_every_patch_radius(P, K):
    offsets = search_offsets(K)
    got = nlm.route(P, offsets)
    if P > nlm.MAX_P:
        assert got == "wide"
    else:
        assert got == ("resident" if nlm.plan(P, K)[0] else "streamed")


def test_nlm_route_refuses_a_negative_radius():
    with pytest.raises(ValueError):
        nlm.route(-1, search_offsets(1))


@pytest.mark.parametrize("P", [97, 130])
@pytest.mark.parametrize("center_weight", [-1.0, 0.5],
                         ids=["variant0", "variant1"])
def test_nlm_past_96_against_the_xla_scan(frame, P, center_weight):
    # on the card these lattices take the wide form, which raised past 96
    assert nlm.route(P, search_offsets(1)) == "wide"
    norm = (0.6, 0.3, 0.3)
    # a patch sums (2P + 1)^2 distances of ~1e-3: sharpness to match, so
    # the lattice's weights differ from 0 and 1
    sharp = 2.0 / (2 * P + 1) ** 2
    want = np.asarray(ref_nlmeans.nlmeans(
        jnp.asarray(frame), P, 1, sharp, norm, center_weight,
        force_xla=True))
    got = nlmeans.nlmeans(torch.from_numpy(frame), P, 1, sharp, norm,
                          center_weight).numpy()
    assert np.isfinite(got).all()
    inner = (slice(None), slice(P, -P), slice(P, -P))
    assert np.abs(got - frame)[inner].max() > 1e-3
    assert np.abs(got - want)[inner].max() <= NLM_TOL


@pytest.fixture(scope="module")
def stack4():
    rng = np.random.default_rng(11)
    return rng.random((2, 3, 40, 56), dtype=np.float32)


@pytest.fixture
def card_contract(monkeypatch):
    """The sepblur wrapper as the card runs it: the kernel takes a 2-D or
    3-D tensor and raises on any other (`kernels/sepblur.sep_blur`); the
    plain version computes."""
    def kernel(x, taps, dilation=1):
        if x.dim() not in (2, 3):
            raise ValueError(f"sep_blur: {x.dim()}-D tensor")
        return sepblur.sep_blur_reference(x, taps, dilation)

    monkeypatch.setattr(sepblur, "sep_blur", kernel)


@pytest.mark.parametrize("dilation", [1, 4])
def test_sep_filter_past_3d_per_plane(stack4, card_contract, dilation):
    x = torch.from_numpy(stack4)
    got = shifts.sep_filter(x, B5, dilation)
    want = torch.stack([shifts.sep_filter(x[i], B5, dilation)
                        for i in range(x.shape[0])])
    assert got.shape == x.shape
    assert torch.equal(got, want)
    five = shifts.sep_filter(x[None], B5, dilation)
    assert torch.equal(five[0], got)


@pytest.mark.parametrize("dilation", [1, 4])
def test_sep_filter_past_3d_against_jax(stack4, card_contract, dilation):
    got = shifts.sep_filter(torch.from_numpy(stack4), B5, dilation).numpy()
    want = np.asarray(ref_shifts.sep_filter(jnp.asarray(stack4), B5,
                                            dilation))
    assert np.abs(got - want).max() <= SEP_TOL
