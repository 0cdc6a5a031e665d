"""filmic rgb's spline route, colour sciences v1-v5, against ansel_tpu on
the CPU: for v1-v4 with each of the six preserve methods and for v5, the
plan and coefficients bit for bit, the chain stage's twin (the plain
torch `fn` through the CPU path of `pointwise_chain`) against the JAX
package's `_tonemap_pixel` (the body its fused chain runs, and its
`apply` without a reconstruction), and the kernel's interpreter
(`csrc/pointwise_chain.cu` up to its specialised programs, built for the
host with g++ as `scripts/chain_count.py` builds it) against the twin on
the same pixels.
Then the highlight reconstruction before a v5 tone map (the spline alone
as a one-stage program) and config 16's pairing with colorout (a
specialised program of its own).  Inputs come from a numpy seed: a
log-normal scene from deep shadow to ~10x over white, with negative,
zero and grey pixels."""

import importlib.util
import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ansel_tpu.core import types as ref_types
from ansel_tpu.core.params import params_class as ref_params_class
from ansel_tpu.ops import base as ref_base
from ansel_tpu.ops import filmicrgb as ref_filmic
from ansel_tpu_torch.core import types as port_types
from ansel_tpu_torch.core.params import params_class
from ansel_tpu_torch.kernels import pointwise as pw
from ansel_tpu_torch.ops import base as port_base
from ansel_tpu_torch.ops import filmicrgb as filmic
from ansel_tpu_torch.pipeline.engine import coeffs_to_device

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 24, 64
# the twin against the JAX body: XLA's and torch's log2/exp/pow differ in
# the last bit, and XLA's CPU jit fuses products into sums (measured
# 5.2e-6 on v1-v3's chroma path, whose outputs pass 1 before the gamut
# penalty; 2.5e-6 elsewhere)
JAX_TOL = 2e-5
# the host-built interpreter against the twin: glibc's log2f/expf/powf
# against torch's CPU ones (measured 7.2e-7); on the card the kernel
# equals its twin bit for bit (tests/test_torch_cuda.py, chip_smoke.py)
HOST_TOL = 5e-6
# (version, preserve method): v1-v4 with every method, v5 (which reads
# no method)
CASES = [(v, m) for v in range(4) for m in range(6)] + [(4, 0)]
IDS = [f"v{v + 1}-{m}" for v, m in CASES]


def _params(version, preserve):
    return dict(version=version, preserve_color=preserve,
                saturation=10.0 if version >= 3 else 15.0,
                white_point_source=4.5, contrast=1.3)


def _pair(version, preserve, pm=(1.0, 1.0, 1.0), **extra):
    out = []
    for types, base, pcls, mod in (
            (ref_types, ref_base, ref_params_class, ref_filmic),
            (port_types, port_base, params_class, filmic)):
        op = mod.FilmicRGB()
        p = pcls("filmicrgb")(**dict(_params(version, preserve), **extra))
        ctx = base.PlanContext(meta=types.RawMeta(width=W, height=H),
                               processed_maximum=pm)
        spec = types.ImageSpec(width=W, height=H,
                               colorspace=types.Colorspace.WORK_RGB)
        plan = op.plan(ctx, spec, p)
        out.append((op, ctx, plan, op.coeffs(ctx, plan, p)))
    return out


def _scene(seed=0):
    rng = np.random.default_rng(seed)
    x = np.exp(rng.normal(-1.8, 1.7, (3, H, W))).astype(np.float32)
    x[:, 0, :8] = -0.02               # negative channels
    x[:, 1, :8] = 0.0
    x[:, 2, :8] = x[0, 2, :8]         # greys
    x[1, 3, :16] *= 30.0              # past white in one channel
    return x


@pytest.fixture(scope="module")
def host_chain(tmp_path_factory):
    """The chain source up to its specialised programs, built for the host
    (chain_count.py's stand-in header and main, the main writing y)."""
    spec = importlib.util.spec_from_file_location(
        "chain_count", os.path.join(ROOT, "scripts", "chain_count.py"))
    cc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cc)
    tmp = str(tmp_path_factory.mktemp("chain_host"))
    lines = open(cc.SOURCE).read().splitlines()
    cut = next(i for i, ln in enumerate(lines)
               if "specialised programs" in ln)
    with open(os.path.join(tmp, "cuda_runtime.h"), "w") as f:
        f.write(cc.HOST_HEADER)
    main = cc.HOST_MAIN.replace(
        "  return 0;\n}",
        "  FILE* o = fopen(argv[2], \"wb\");\n"
        "  fwrite(y.data(), 4, y.size(), o);\n  fclose(o);\n"
        "  return 0;\n}")
    src = os.path.join(tmp, "chain_host.cpp")
    with open(src, "w") as f:
        f.write("\n".join(lines[:cut]) + "\n}  // namespace\n" + main)
    exe = os.path.join(tmp, "chain_host")
    subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-I",
                    tmp, "-o", exe, src], check=True)

    def run(x, chain):
        data, out = os.path.join(tmp, "in.bin"), os.path.join(tmp, "out.bin")
        prog = chain.prog.numpy().astype(np.int32)
        consts = chain.consts.numpy().astype(np.float32)
        flat = np.ascontiguousarray(x.reshape(3, -1), np.float32)
        with open(data, "wb") as f:
            for part in (np.int64(flat.shape[1]),
                         np.int32(prog.size // pw.RECORD),
                         np.int32(consts.size), prog, consts, flat):
                f.write(part.tobytes())
        subprocess.run([exe, data, out], check=True)
        return np.fromfile(out, np.float32).reshape(x.shape)

    return run


@pytest.mark.parametrize("version,preserve", CASES, ids=IDS)
def test_plan_and_coeffs_equal_the_jax_package(version, preserve):
    (_, _, rplan, rco), (_, _, pplan, pco) = _pair(version, preserve)
    assert pplan.static == rplan.static
    assert pplan.static[0] == version and pplan.static[5] is None
    assert sorted(pco) == sorted(rco)
    for k in rco:
        assert np.array_equal(np.asarray(pco[k], np.float32),
                              np.asarray(rco[k], np.float32)), k


@pytest.mark.parametrize("version,preserve", CASES, ids=IDS)
def test_spline_stage_matches_the_jax_package(version, preserve,
                                              host_chain):
    (rop, rctx, rplan, rco), (pop, pctx, pplan, pco) = _pair(version,
                                                             preserve)
    spec = pop.pointwise_spec(pplan, pctx)
    assert spec.opcode == pw.OP_FILMIC_SPLINE
    assert spec.ints == (pplan.static[2], pplan.static[3], version,
                         pplan.static[1])
    x = _scene(seed=version * 6 + preserve)
    c = coeffs_to_device([pco], "cpu")[0]
    chain = pw.pack_chain([spec], [c], "cpu")
    assert chain.consts.numel() == 57
    assert pw.FIXED[chain.fixed] == ((pw.OP_FILMIC_SPLINE, 0),)
    got = pw.pointwise_chain(torch.from_numpy(x), chain).numpy()
    rc = {k: jnp.asarray(np.asarray(v)) for k, v in rco.items()}
    body = np.asarray(jax.jit(lambda v: rop._tonemap_pixel(
        v, rc, rplan.static))(jnp.asarray(x)))
    assert np.isfinite(got).all()
    assert np.abs(got - body).max() <= JAX_TOL
    host = host_chain(x, chain)
    assert np.abs(host - got).max() <= HOST_TOL


def test_every_method_changes_the_v3_and_v4_outputs():
    """The preserve methods are not folded together: at v3 and at v4,
    every pair of methods gives another image."""
    x = torch.from_numpy(_scene(7))
    for version in (2, 3):
        outs = []
        for preserve in range(6):
            _, (pop, pctx, pplan, pco) = _pair(version, preserve)
            c = coeffs_to_device([pco], "cpu")[0]
            outs.append(pop.pointwise_spec(pplan, pctx).fn(x, c))
        for i in range(6):
            for j in range(i):
                assert (outs[i] - outs[j]).abs().max() > 1e-4, (version, i, j)


def test_v5_after_a_highlight_reconstruction_is_a_one_stage_program(
        monkeypatch):
    """With the reconstruction planned, the stage leaves the chain and its
    apply runs the reconstruction, then the spline alone as its own
    specialised program: against the JAX package's apply."""
    (rop, rctx, rplan, rco), (pop, pctx, pplan, pco) = _pair(
        4, 0, pm=(4.0, 4.0, 4.0), reconstruct_threshold=-3.0)
    assert rplan.static == pplan.static and pplan.static[5] is not None
    assert pop.pointwise_spec(pplan, pctx) is None
    x = _scene(3) * 2.0
    c = coeffs_to_device([pco], "cpu")[0]
    chains = []
    real = pw.pointwise_chain
    monkeypatch.setattr(pw, "pointwise_chain",
                        lambda v, ch: chains.append(ch) or real(v, ch))
    got = pop.apply(torch.from_numpy(x), c, pplan, pctx).numpy()
    (chain,) = chains
    assert pw.FIXED[chain.fixed] == ((pw.OP_FILMIC_SPLINE, 0),)
    rc = {k: jnp.asarray(np.asarray(v)) for k, v in rco.items()}
    want = np.asarray(jax.jit(lambda v: rop.apply(v, rc, rplan, rctx))(
        jnp.asarray(x)))
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= JAX_TOL
    no_rec = pop._tonemap_pixel(torch.from_numpy(x), c, pplan.static)
    assert np.abs(got - no_rec.numpy()).max() > 1e-3


def test_v5_and_colorout_are_a_program_of_their_own():
    """Config 16's second chain, [filmicrgb v5, colorout], packs as a
    specialised program (colorout's consts after the spline's 57)."""
    import ansel_tpu_torch
    from ansel_tpu_torch.io import configs
    from ansel_tpu_torch.io.synthetic import synth_raw

    _, meta, _ = synth_raw(h=32, w=48, kind="gradients")
    hist = [ansel_tpu_torch.HistoryItem(
        "filmicrgb", dict(dict(configs.HISTORIES[16])["filmicrgb"]))]
    pipe = ansel_tpu_torch.Pipeline(meta, hist, device="cpu")
    names = [s.name for s in pipe.stages]
    i = names.index("filmicrgb")
    assert names[i + 1] == "colorout"
    stages = pipe.stages[i:i + 2]
    specs = [s.op.pointwise_spec(s.plan, pipe.ctx) for s in stages]
    coeffs = coeffs_to_device(pipe.coeffs()[i:i + 2], "cpu")
    chain = pw.pack_chain(specs, coeffs, "cpu")
    assert pw.FIXED[chain.fixed] == ((pw.OP_FILMIC_SPLINE, 0),
                                     (pw.OP_COLOROUT, 57))
