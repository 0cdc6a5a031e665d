"""A rehearsal of whole runs on the CPU at a small frame: the result
line's shape, the check, and the faults of the timed path that it has to
catch; the modules a run loads; the command's refusal without a card."""

import json
import os
import subprocess
import sys

import pytest
import torch

from rawbench import harness

ROOT = harness.ROOT
BENCH = harness.load_bench()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(workload, cfg, trace=False, seconds=1.5, seed=2**31 + 3, mix=None):
    lines = []
    res = harness.run_cell(workload, seed, seconds, trace, device="cpu",
                           cfg=cfg, mix=mix, log=lines.append)
    return res, lines


def listed(group, workload):
    return {m["name"] for m in BENCH[group]
            if workload in m.get("workloads", [workload])}


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload, trace, small_cfg):
    res, lines = run(workload, small_cfg(workload), trace)
    assert res["correct"] is True and res["failed"] == 0
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "check"
    names = set(res["metrics"])
    if trace:
        # the host-clock readings; the device's need the card
        host = {m["name"] for m in BENCH["per_layer"]
                if m["source"] == "host_clock"}
        assert names == listed("per_layer", workload) & host
    else:
        assert names == listed("end_to_end", workload)
        assert "setup_s" in names and len(names) >= 2
    assert any(line.startswith("[setup]") for line in lines)
    json.dumps(res, allow_nan=False)


def _alter_one_pixel(monkeypatch):
    from ansel_tpu_torch.pipeline import engine

    real = engine.CompiledPipe.run_padded

    def run_padded(self, raw):
        out = real(self, raw).clone()
        out[1, 40, 60] += 0.25
        return out

    monkeypatch.setattr(engine.CompiledPipe, "run_padded", run_padded)


def _chain_returns_its_input(monkeypatch):
    from ansel_tpu_torch.kernels import pointwise

    monkeypatch.setattr(pointwise, "pointwise_chain", lambda x, chain: x)


def _another_images_answer(monkeypatch):
    from ansel_tpu_torch.pipeline import engine

    real = engine.CompiledPipe.run_padded
    last = {}

    def run_padded(self, raw):
        out = real(self, raw)
        prev, last["out"] = last.get("out", out), out
        return prev

    monkeypatch.setattr(engine.CompiledPipe, "run_padded", run_padded)


FAULTS = {
    "an answer altered where it is produced": _alter_one_pixel,
    "a step that returns its state unchanged": _chain_returns_its_input,
    "another image's answer handed back": _another_images_answer,
}


# a roll whose images each have their own exposure, uploaded from the host
# and downloaded to it: every path of the generator at once
EDITED = {"arrivals": "sets", "set_size": 3, "rate": 40.0, "roll_images": 4,
          "source": "host", "sink": "host",
          "edits": [["exposure", "exposure", [-0.5, 0.25, 1.0]]]}


def test_a_roll_of_edits_from_the_host_is_correct(small_cfg):
    res, _ = run("develop24.roll", small_cfg("develop24.roll"), mix=EDITED)
    assert res["correct"] is True and res["attempted"] > 3


def _pasted_edit(monkeypatch):
    # the program plans every image with the configuration's own history
    real = harness.plan

    def plan(meta, history, device):
        return real(meta, harness.load_config(
            {"file": "rawbench/configs/develop24.json"})["history"], device)

    monkeypatch.setattr(harness, "plan", plan)


def test_an_image_given_the_wrong_edit_is_not_correct(small_cfg,
                                                      monkeypatch):
    _pasted_edit(monkeypatch)
    res, _ = run("develop24.roll", small_cfg("develop24.roll"), mix=EDITED)
    assert res["correct"] is False


def test_a_mix_given_to_a_run_is_checked(small_cfg):
    with pytest.raises(ValueError):
        run("develop24.roll", small_cfg("develop24.roll"),
            mix=dict(EDITED, arrivals="burst"))


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_timed_path_is_not_correct(workload, fault, small_cfg,
                                            monkeypatch):
    FAULTS[fault](monkeypatch)
    res, _ = run(workload, small_cfg(workload))
    assert res["correct"] is False
    assert res["check"]["max_gap"]["value"] > \
        res["check"]["max_gap"]["limit"]


def _script(body):
    return subprocess.run([sys.executable, "-c", body], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))


def test_a_rehearsal_loads_nothing_of_jax_or_the_jax_package():
    proc = _script(
        "import json, sys, torch\n"
        "sys.path.insert(0, '.')\n"
        "from rawbench import harness\n"
        "bench = harness.load_bench()\n"
        "for wl in [w['name'] for w in bench['workloads']]:\n"
        "    cfg = harness.load_config(harness.cell_of(bench, wl)[1])\n"
        "    cfg['frame'] = {'height': 96, 'width': 160,\n"
        "                    'pad_height': 96, 'pad_width': 256}\n"
        "    harness.run_cell(wl, 5, 1.5, True, device='cpu', cfg=cfg,\n"
        "                     log=lambda s: None)\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "      if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'ansel_tpu',\n"
        "                             'ansel_tpu_torch'))))\n")
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert loaded and all(m.split(".")[0] == "ansel_tpu_torch"
                          for m in loaded)


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ansel_tpu_torch_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxlike", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "ansel_tpu.ops", sys)
    assert harness.forbidden_modules() == ["ansel_tpu.ops"]


def test_the_command_refuses_without_a_card(card_absent):
    proc = subprocess.run(
        [sys.executable, "rawbench/run.py", "--workload", "develop24.roll",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


@pytest.fixture
def card_absent():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


@pytest.mark.parametrize("workload", CELLS)
def test_control_readings_separate_on_the_cpu(workload, small_cfg):
    # the card test's readings at the small frame: the program's gap
    # under the limit, the control's over it
    from rawbench import control

    cfg = small_cfg(workload)
    got = control.readings(workload, [2**31 + 7], [2**31 + 7], 1.0,
                           device="cpu", cfg=cfg, emit=lambda s: None)
    assert max(got["program"]) <= cfg["limits"]["max_gap"]
    assert min(got["control"]) > cfg["limits"]["max_gap"]
