"""Each configuration plans through the program's compile_pipeline, and
the plain reference matches the program's CPU path on it at a small
frame; the control (the reference rounded to bfloat16 between stages)
does not."""

import pytest
import torch

from rawbench import harness, reference, scene

CELLS = ["develop24.roll", "heavy45.roll"]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload", CELLS)
def test_configuration_plans_through_compile_pipeline(workload, small_cfg):
    cfg = small_cfg(workload)
    pipe = harness.build_pipe(cfg, "cpu")
    assert [s.name for s in pipe.pipe.stages] == cfg["pipe"]
    assert len(reference.stages(cfg["name"], cfg)) == len(cfg["pipe"])


def test_a_plan_unlike_the_configuration_is_refused(small_cfg):
    cfg = small_cfg("develop24.roll")
    cfg["pipe"] = cfg["pipe"][:-1]
    with pytest.raises(RuntimeError, match="plans"):
        harness.build_pipe(cfg, "cpu")


@pytest.mark.parametrize("seed", [3, 2**31 + 11])
@pytest.mark.parametrize("workload", CELLS)
def test_reference_matches_the_programs_cpu_path(workload, seed, small_cfg):
    cfg = small_cfg(workload)
    pipe = harness.build_pipe(cfg, "cpu")
    mosaic = scene.mosaic(cfg, seed, 1, "cpu")
    out = pipe.run_padded(mosaic)[:, :96, :160]
    ref = reference.run(cfg["name"], cfg, mosaic)
    # the stages agree exactly but for divisions by float32 constants the
    # reference takes as Python floats and filmic's powers (measured
    # 3.6e-6 at most on display values in [0, 1])
    assert harness.max_gap(out, ref) < 2e-5
    # the control reads far past the cell's limit
    low = reference.run(cfg["name"], cfg, mosaic, round_to=torch.bfloat16)
    assert harness.max_gap(low, ref) > 4 * cfg["limits"]["max_gap"]


def test_mosaics_repeat_from_the_seed_and_differ_between_images(small_cfg):
    cfg = small_cfg("develop24.roll")
    a = scene.mosaic(cfg, 2**31 + 5, 0, "cpu")
    assert torch.equal(a, scene.mosaic(cfg, 2**31 + 5, 0, "cpu"))
    assert not torch.equal(a, scene.mosaic(cfg, 2**31 + 5, 1, "cpu"))
    assert not torch.equal(a, scene.mosaic(cfg, 2**31 + 6, 0, "cpu"))
    assert a.shape == (96, 256) and a.dtype == torch.float32
    # the specular patch clips: some sites at the white level
    assert float(a.max()) >= cfg["camera"]["white"]
