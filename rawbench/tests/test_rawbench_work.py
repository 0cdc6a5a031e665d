"""The work each configuration freezes gives the least times the
roofline shares are taken against, and the readers find it by the
stage's name."""

import pytest

from rawbench import harness, work


def frozen(config, stage):
    entry = {c["name"]: c for c in harness.load_bench()["configs"]}[config]
    return work.frozen(harness.load_config(entry), stage)


def ms(config, stage, pixels):
    w, _, times = frozen(config, stage)
    return 1e3 * work.least_seconds(w, pixels, times)


@pytest.mark.parametrize("config", ["develop24", "heavy45"])
def test_rcd_at_24mp_is_bound_by_its_operations(config):
    # 330 operations a pixel at 67 TFLOP/s; its bytes take 0.115 ms
    assert ms(config, "demosaic", 4000 * 6016) == pytest.approx(
        0.1185, abs=5e-4)
    assert frozen(config, "demosaic")[1] == ("demosaic",)


def test_chain_of_config_1_at_24mp():
    assert ms("develop24", "chain", 4000 * 6016) == pytest.approx(
        0.393, abs=5e-4)
    assert frozen("develop24", "chain")[1] == (
        "exposure", "colorin", "channelmixerrgb", "filmicrgb", "colorout")


@pytest.mark.parametrize("width,bound", [(8320, 0.646), (8256, 0.641)])
def test_diffuse_iteration_at_45mp(width, bound):
    # 0.646 ms an iteration on the 8320 columns the program pads to; the
    # benchmark counts the frame's 8256, and the configuration's 4 passes
    assert ms("heavy45", "diffuse", 5504 * width) == pytest.approx(
        4 * bound, abs=2e-3)
    assert frozen("heavy45", "diffuse")[2] == 4


def test_bytes_count_once_per_step_and_operations_per_pass():
    w = work.Work(ops=1, mufu=0, bytes_in=4000, bytes_out=4000)
    one = work.least_seconds(w, 10**6)
    assert work.least_seconds(w, 10**6, times=4) == one


def test_share_without_a_device_time_reads_nothing():
    rcd = work.Work(ops=330, mufu=9, bytes_in=4, bytes_out=12)
    assert work.share(rcd, 100, None) is None
    assert work.share(rcd, 100, 0.0) is None
    assert work.share(rcd, 10**6, 1.0) == pytest.approx(
        100.0 * 330e6 / 67e12)


@pytest.mark.parametrize("reader,config,reads", [
    ("chain_roofline", "develop24", True),
    ("chain_roofline", "heavy45", False),
    ("diffuse_roofline", "develop24", False),
    ("diffuse_roofline", "heavy45", True),
    ("demosaic_roofline", "heavy45", True),
])
def test_a_reader_reads_only_what_the_configuration_freezes(reader, config,
                                                            reads):
    entry = {c["name"]: c for c in harness.load_bench()["configs"]}[config]
    cfg = harness.load_config(entry)
    steps = [((name,), 1e-3) for name in cfg["pipe"]]
    r = harness.Readings(cfg=cfg, pixels=10**6, roll=None, steps=steps)
    value = harness.load_reader(reader)(r)
    assert (value is not None) == reads
    if reads:
        assert 0 < value < 100
    # without step times nothing is read
    r.steps = None
    assert harness.load_reader(reader)(r) is None
