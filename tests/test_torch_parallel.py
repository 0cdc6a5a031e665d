"""The port's multi-device layer (`ansel_tpu_torch/parallel/`) on virtual
CPU meshes (`make_mesh(devices=[cpu] * n)`), against its own
single-device pipe and the JAX package's `ansel_tpu/parallel` on the
JAX tests' eight virtual CPU devices: the mesh and its refusals,
`BatchPipeline` bit for bit and against JAX's, `spatial_sharded_pipe`,
the `SpatialPipeline` geometry (`required_halo`, `shard_h`, `halo`) for
every history of tests/test_spatial_shard.py, its output on the default
pipe and on the denoise stack, every refusal of tests/test_spatial_shard.py
and tests/test_multichip.py, and `dryrun_multichip` on the CPU."""

import os
import sys

import numpy as np
import pytest
import torch

import ansel_tpu
import ansel_tpu_torch
from ansel_tpu.io.synthetic import synth_raw
from ansel_tpu.parallel import batch as ref_batch
from ansel_tpu.parallel import spatial as ref_spatial
from ansel_tpu.pipeline import engine as ref_engine
from ansel_tpu_torch.entry import dryrun_multichip
from ansel_tpu_torch.io import configs
from ansel_tpu_torch.parallel import mesh as mesh_mod
from ansel_tpu_torch.parallel.batch import (BatchPipeline, make_mesh,
                                            spatial_sharded_pipe)
from ansel_tpu_torch.parallel.spatial import SpatialPipeline, required_halo
from ansel_tpu_torch.pipeline import engine

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_blend import share_rcd  # noqa: E402

torch.set_num_threads(1)

CPU = torch.device("cpu")
DISPLAY_QUANTUM = 1.0 / 255.0
# BatchPipeline against JAX's on PPG and the chain: the same float32
# operations per pixel, but XLA's and torch's powf/log2/exp on the CPU
# differ by an ulp, which filmicrgb's spline amplifies (4.3e-5 measured;
# tests/test_torch_pointwise.py's gate).  tests/test_multichip.py's 1e-6
# holds JAX against itself.
BATCH_JAX_TOL, BATCH_JAX_MEAN_TOL = 1e-4, 1e-6
# spatial_sharded_pipe and the shifted-window SpatialPipeline against the
# port's single pipe: the kept rows are computed by the same operations
# on the same values (0 measured on the CPU; JAX's gate is 1e-5)
SHARDED_TOL = 1e-5
# the denoise stack's rows against the single pipe: the per-scale
# variance is summed by shard and added, in another order than the whole
# frame's sum (6.0e-5 measured)
DENOISE_SHARDED_TOL = 2e-4
# against the JAX single pipe, handed the port's RCD (R3: the packages'
# CPU RCDs differ on a border that denoiseprofile's whole-frame
# statistic carries inwards): NLM's ring of its patch radius P = 2 px is
# dropped (the XLA path edge-pads the distance plane, the kernel the
# image), and the stack's nlmeans weights luma and chroma 50 (fractions
# of the denoised delta, so 50 times it) amplify float32 differences
# (1.46e-3 measured)
NLM_RING = 2

# tests/test_spatial_shard.py's histories: (ops, height, shards)
HISTORIES = {
    "default": ([("exposure", {"exposure": 0.5}), ("filmicrgb", {})],
                384, 8),
    "denoise-stack": (list(configs.HISTORIES[18]), 704, 2),
    "eaw-atrous": ([("rawdenoise", {"threshold": 0.02}),
                    ("exposure", {"exposure": 0.5}),
                    ("filmicrgb", {})], 768, 4),
    "cfa-aligned": ([("denoiseprofile", {"a": (4e-4,) * 3,
                                         "b": (1e-5,) * 3}),
                     ("exposure", {"exposure": 0.5})], 384, 2),
}
GLOBAL_OP = [("exposure", {"exposure": 0.5}),
             ("bilat", {"sigma_r": 100.0, "sigma_s": 100.0, "detail": 0.3}),
             ("filmicrgb", {})]


def cpus(n):
    return [CPU] * n


def items(pkg, ops):
    return [pkg.HistoryItem(op, dict(p)) for op, p in ops]


def single(meta, ops, raw):
    return engine.CompiledPipe(engine.Pipeline(
        meta, items(ansel_tpu_torch, ops), device="cpu")).output_array(raw)


def test_make_mesh_shapes():
    mesh = make_mesh(8, spatial=2, devices=cpus(8))
    assert mesh.shape == {"dp": 4, "sp": 2}
    assert len(mesh.axis_devices("dp")) == 4
    assert len(mesh.axis_devices("sp")) == 2
    assert len(mesh.axis_devices(("dp", "sp"))) == 8
    assert make_mesh(devices=cpus(4)).shape == {"dp": 4, "sp": 1}
    assert make_mesh(2, devices=cpus(4)).shape == {"dp": 2, "sp": 1}
    assert make_mesh(spatial=4, devices=cpus(4)).shape == {"dp": 1, "sp": 4}


def test_make_mesh_refusals(monkeypatch):
    with pytest.raises(ValueError, match="explicit devices"):
        make_mesh(5, devices=cpus(4))
    with pytest.raises(ValueError, match="rows of 3"):
        make_mesh(4, spatial=3, devices=cpus(4))
    # no card and no list: no mesh, and never the CPU in its place
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    # one card and no list: two shards raise rather than wrap onto it
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="explicit devices"):
        make_mesh(2)
    assert make_mesh(1).shape == {"dp": 1, "sp": 1}


def test_collectives_on_a_virtual_mesh():
    """ppermute and psum inside run_shards, and a shard's failure raised
    to the caller with the others released."""
    mesh = make_mesh(spatial=4, devices=cpus(4))
    rows = torch.arange(32.0).reshape(8, 4)

    def body(x):
        i = mesh_mod.axis_index("sp")
        up = mesh_mod.ppermute(x, "sp", [(k, k + 1) for k in range(3)])
        total = mesh_mod.psum(x.sum(dim=0), "sp")
        return up, total

    outs = mesh_mod.run_shards(mesh, "sp", body,
                               [(rows[2 * i:2 * i + 2],) for i in range(4)])
    for i, (up, total) in enumerate(outs):
        want_up = rows[2 * i - 2:2 * i] if i else torch.zeros(2, 4)
        assert torch.equal(up, want_up)
        assert torch.equal(total, rows.sum(dim=0))

    def fails(x):
        if mesh_mod.axis_index("sp") == 2:
            raise KeyError("shard 2")
        return mesh_mod.psum(x, "sp")

    with pytest.raises(KeyError, match="shard 2"):
        mesh_mod.run_shards(mesh, "sp", fails, [(rows,)] * 4)
    with pytest.raises(RuntimeError, match="no shard"):
        mesh_mod.axis_index("sp")


def test_map_shards_runs_each_shard_on_this_thread():
    """A body without collectives, shard after shard on the caller's
    thread, its index at hand, its results in shard order; a collective
    there raises."""
    mesh = make_mesh(spatial=4, devices=cpus(4))
    rows = torch.arange(32.0).reshape(8, 4)
    log = []

    def body(x, k):
        log.append(k)
        assert mesh_mod.axis_index("sp") == k
        return x * k

    outs = mesh_mod.map_shards(mesh, "sp", body,
                               [(rows[2 * k:2 * k + 2], k) for k in range(4)])
    assert log == [0, 1, 2, 3]
    for k, o in enumerate(outs):
        assert torch.equal(o, rows[2 * k:2 * k + 2] * k)
    with pytest.raises(ValueError, match="3 argument tuples for 4"):
        mesh_mod.map_shards(mesh, "sp", body, [(rows, 0)] * 3)
    with pytest.raises(RuntimeError, match="no collective runs there"):
        mesh_mod.map_shards(mesh, "sp", lambda x: mesh_mod.psum(x, "sp"),
                            [(rows,)] * 4)
    assert not mesh_mod.in_shard("sp")


def test_shards_take_turns():
    """One shard thread runs at a time, in shard order, handing over at
    each collective and at its end."""
    mesh = make_mesh(spatial=3, devices=cpus(3))
    log = []

    def body(x):
        i = mesh_mod.axis_index("sp")
        log.append((i, "a"))
        total = mesh_mod.psum(x, "sp")
        log.append((i, "b"))
        return total

    outs = mesh_mod.run_shards(mesh, "sp", body,
                               [(torch.full((2,), float(i)),)
                                for i in range(3)])
    assert all(torch.equal(o, torch.full((2,), 3.0)) for o in outs)
    assert log == [(0, "a"), (1, "a"), (2, "a"),
                   (0, "b"), (1, "b"), (2, "b")]


def test_batch_pipeline_equals_the_single_pipe_bit_for_bit():
    raw, meta, _ = synth_raw(h=64, w=128)
    ops = [("exposure", {"exposure": 0.5}), ("filmicrgb", {})]
    bp = BatchPipeline(meta, items(ansel_tpu_torch, ops),
                       make_mesh(4, devices=cpus(4)))
    batch = np.stack([raw * (1.0 + 0.01 * i) for i in range(8)])
    out = bp(batch)
    assert out.shape == (8,) + (3,) + bp.pipe.spec_out.array_shape[1:]
    one = engine.CompiledPipe(engine.Pipeline(
        meta, items(ansel_tpu_torch, ops), device="cpu"))
    for i in range(8):
        assert torch.equal(out[i], one(batch[i])), i


def test_batch_pipeline_matches_jax():
    """tests/test_multichip.py's fused case: PPG and the chain over four
    devices, each image against JAX's BatchPipeline (its pointwise
    fusion in Pallas interpret mode)."""
    raw, meta, _ = synth_raw(h=64, w=128)
    ops = [("demosaic", {"demosaicing_method": 0}),
           ("exposure", {"exposure": 0.4}),
           ("channelmixerrgb", {}),
           ("filmicrgb", {})]
    batch = np.stack([raw * (1.0 + 0.05 * i) for i in range(4)])
    got = BatchPipeline(meta, items(ansel_tpu_torch, ops),
                        make_mesh(4, devices=cpus(4)))(batch).numpy()
    old = ref_engine._FORCE_FUSION_INTERPRET
    ref_engine._FORCE_FUSION_INTERPRET = True
    try:
        want = np.asarray(ref_batch.BatchPipeline(
            meta, items(ansel_tpu, ops),
            ref_batch.make_mesh(4, spatial=1))(batch))
    finally:
        ref_engine._FORCE_FUSION_INTERPRET = old
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert d.max() <= BATCH_JAX_TOL and d.mean() <= BATCH_JAX_MEAN_TOL


def test_batch_rejects_a_spatial_mesh():
    _, meta, _ = synth_raw(h=64, w=128)
    with pytest.raises(ValueError, match="dp only"):
        BatchPipeline(meta, items(ansel_tpu_torch, [("filmicrgb", {})]),
                      make_mesh(8, spatial=2, devices=cpus(8)))


@pytest.mark.parametrize("config,h,w,spatial", [
    (None, 128, 128, 2),    # tests/test_multichip.py's case
    (1, 256, 384, 2),       # config 1's history, RCD at every band
    ("ppg", 64, 128, 2),    # __graft_entry__.py's phase 2: PPG (R18)
])
def test_spatial_sharded_pipe_matches_the_single_pipe(config, h, w, spatial):
    """Each band computes what the whole pipe computes on its rows; PPG's
    shifts wrap round the frame, so its top and bottom bands demosaic
    the whole frame (R18)."""
    raw, meta, _ = synth_raw(h=h, w=w, kind="gradients")
    if config == "ppg":
        hist = items(ansel_tpu_torch, [
            ("exposure", {"exposure": 0.5}), ("filmicrgb", {}),
            ("demosaic", {"demosaicing_method": 0})])
    elif config is None:
        hist = items(ansel_tpu_torch, [("filmicrgb", {})])
    else:
        hist = configs.history(config)
    call, pipe = spatial_sharded_pipe(
        meta, hist, make_mesh(4 * spatial, spatial=spatial,
                              devices=cpus(4 * spatial)))
    got = call(raw)
    want = engine.CompiledPipe(pipe)(raw)[:, :h, :w]
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= SHARDED_TOL


@pytest.mark.parametrize("name", sorted(HISTORIES))
def test_spatial_geometry_equals_jax(name):
    """required_halo, shard_h and halo as the JAX package plans them
    (planning only: JAX's shard_map is built, not compiled)."""
    ops, h, spatial = HISTORIES[name]
    _, meta, _ = synth_raw(h=h, w=256)
    assert required_halo(meta, items(ansel_tpu_torch, ops), 48) \
        == ref_spatial.required_halo(meta, items(ansel_tpu, ops), 48)
    got = SpatialPipeline(meta, items(ansel_tpu_torch, ops),
                          make_mesh(spatial=spatial, devices=cpus(spatial)))
    want = ref_spatial.SpatialPipeline(
        meta, items(ansel_tpu, ops), ref_batch.make_mesh(spatial=spatial))
    assert (got.shard_h, got.halo) == (want.shard_h, want.halo)
    assert got.halo > 0 and got.halo % 2 == 0


@pytest.fixture
def shared_rcd(monkeypatch):
    """The JAX pipes with the port's RCD twin (R3), compiled anew."""
    share_rcd(monkeypatch)
    monkeypatch.setattr(ref_engine, "_COMPILE_CACHE", {})


def test_spatial_pipeline_default_pipe_matches_jax(shared_rcd):
    """The default pipe at 384 x 256 over 8 virtual CPU shards: equal to
    the port's single pipe, and within the display quantum of JAX's
    SpatialPipeline on the same input."""
    ops, h, spatial = HISTORIES["default"]
    raw, meta, _ = synth_raw(h=h, w=256)
    raw = np.asarray(raw)
    sp = SpatialPipeline(meta, items(ansel_tpu_torch, ops),
                         make_mesh(spatial=spatial, devices=cpus(spatial)))
    got = sp(raw).numpy()
    assert np.abs(got - single(meta, ops, raw)).max() <= SHARDED_TOL
    want = np.asarray(ref_spatial.SpatialPipeline(
        meta, items(ansel_tpu, ops), ref_batch.make_mesh(spatial=spatial))(
            raw))[..., :h, :256]
    assert np.abs(got - want).max() < DISPLAY_QUANTUM


def test_denoise_stack_rowsharded(shared_rcd):
    """tests/test_spatial_shard.py's denoise stack at 704 x 256 over two
    shards (a 160-row halo, denoiseprofile's statistic summed over the
    shards): within DENOISE_SHARDED_TOL of the port's single pipe, and
    within the display quantum of the JAX single-device pipe outside
    NLM's ring."""
    ops, h, spatial = HISTORIES["denoise-stack"]
    raw, meta, _ = synth_raw(h=h, w=256)
    raw = np.asarray(raw)
    sp = SpatialPipeline(meta, items(ansel_tpu_torch, ops),
                         make_mesh(spatial=spatial, devices=cpus(spatial)))
    assert (sp.shard_h, sp.halo) == (352, 160)
    got = sp(raw).numpy()
    assert np.abs(got - single(meta, ops, raw)).max() <= DENOISE_SHARDED_TOL
    want = np.asarray(ansel_tpu.compile_pipeline(
        meta, items(ansel_tpu, ops)).output_array(raw))
    r = NLM_RING
    d = np.abs(got - want)[:, r:h - r, r:256 - r]
    assert d.max() < DISPLAY_QUANTUM, (d.max(), d.mean())


def test_global_op_rejected():
    _, meta, _ = synth_raw(h=384, w=256)
    with pytest.raises(ValueError, match="'bilat' demands the full frame"):
        SpatialPipeline(meta, items(ansel_tpu_torch, GLOBAL_OP),
                        make_mesh(spatial=8, devices=cpus(8)))


def test_indivisible_height_rejected():
    _, meta, _ = synth_raw(h=380, w=256)  # 380 / 8 = 47.5
    with pytest.raises(ValueError, match="must divide"):
        SpatialPipeline(meta, items(ansel_tpu_torch, [("exposure", {})]),
                        make_mesh(spatial=8, devices=cpus(8)))


def test_halo_over_half_a_shard_rejected():
    _, meta, _ = synth_raw(h=704, w=256)
    with pytest.raises(ValueError, match="more than half a shard"):
        SpatialPipeline(meta, items(ansel_tpu_torch,
                                    HISTORIES["denoise-stack"][0]),
                        make_mesh(spatial=8, devices=cpus(8)))


def test_dryrun_multichip_on_the_cpu():
    dryrun_multichip(4, device="cpu")
