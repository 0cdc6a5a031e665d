"""The control layer (`ansel_tpu_torch/control/`): the scheduler's five
queues, the droppable thumbnail queue, the serialized export queue, the
reserved device worker and the signal bus, each case run on the port and
on ansel_tpu's copy with the same jobs, so that both behave alike
(tests/test_control.py's cases); conf and the structured log on the
port; and the CUDA kernels' first build off the main thread
(`kernels/_build.py`), with a stand-in for nvcc that builds an empty
shared library with gcc."""

import importlib
import os
import stat
import sys
import threading
import time

import pytest
import torch

from ansel_tpu_torch.kernels import _build

torch.set_num_threads(1)

PACKAGES = ["ansel_tpu", "ansel_tpu_torch"]


def _control(pkg):
    return (importlib.import_module(f"{pkg}.control"),
            importlib.import_module(f"{pkg}.control.jobs"))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_jobs_run_and_report(pkg):
    control, jobs = _control(pkg)
    s = control.Scheduler(workers=2)
    try:
        job = s.dispatch(lambda j: 41 + 1, description="math")
        assert job.wait(5.0)
        assert job.state is jobs.JobState.FINISHED and job.result == 42
        bad = s.dispatch(lambda j: 1 / 0)
        assert bad.wait(5.0)
        assert bad.state is jobs.JobState.FAILED
        assert isinstance(bad.error, ZeroDivisionError)
    finally:
        s.shutdown()


def _peak(s, jobs_mod, n, **kw):
    """Run n jobs of 50 ms on the scheduler; -> the most that ran at once
    and the thread names they ran on."""
    active, peak, names = [], [], []
    lock = threading.Lock()

    def work(job):
        with lock:
            active.append(1)
            peak.append(len(active))
            names.append(threading.current_thread().name)
        time.sleep(0.05)
        with lock:
            active.pop()

    js = [s.dispatch(work, **kw) for _ in range(n)]
    for j in js:
        assert j.wait(10.0)
        assert j.state is jobs_mod.JobState.FINISHED
    return max(peak), set(names)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_export_queue_is_serialized(pkg):
    control, jobs = _control(pkg)
    s = control.Scheduler(workers=4)
    try:
        peak, _ = _peak(s, jobs, 4, queue_id=jobs.QUEUE_USER_EXPORT)
        assert peak == 1
    finally:
        s.shutdown()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_device_jobs_are_serialized_on_the_device_worker(pkg):
    """Device jobs from every queue run one at a time on the one device
    worker; host jobs beside them run on the generic workers."""
    control, jobs = _control(pkg)
    s = control.Scheduler(workers=3)
    try:
        peak, names = _peak(s, jobs, 6, device=True,
                            queue_id=jobs.QUEUE_USER_BG)
        assert peak == 1 and names == {"device-worker"}
        peak, names = _peak(s, jobs, 3, queue_id=jobs.QUEUE_USER_FG)
        assert "device-worker" not in names
    finally:
        s.shutdown()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_droppable_queue_replaces_stale_thumbnails(pkg):
    control, jobs = _control(pkg)
    s = control.Scheduler(workers=1)
    try:
        blocker = threading.Event()
        s.dispatch(lambda j: blocker.wait(5.0))  # occupy the worker
        j1 = s.dispatch(lambda j: "old", queue_id=jobs.QUEUE_SYSTEM_FG,
                        drop_key="thumb:42")
        j2 = s.dispatch(lambda j: "new", queue_id=jobs.QUEUE_SYSTEM_FG,
                        drop_key="thumb:42")
        j3 = s.dispatch(lambda j: "other", queue_id=jobs.QUEUE_SYSTEM_FG,
                        drop_key="thumb:43")
        blocker.set()
        assert j2.wait(5.0) and j3.wait(5.0)
        assert (j2.result, j3.result) == ("new", "other")
        assert j1.state is jobs.JobState.CANCELLED
    finally:
        s.shutdown()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_queues_run_in_priority_order(pkg):
    """With the one generic worker busy, queued jobs then run USER_FG,
    SYSTEM_FG, USER_BG, USER_EXPORT, SYSTEM_BG (jobs.h:52-60)."""
    control, jobs = _control(pkg)
    s = control.Scheduler(workers=1)
    order = []
    try:
        blocker = threading.Event()
        s.dispatch(lambda j: blocker.wait(5.0))
        time.sleep(0.2)     # the worker holds the blocker
        qids = [jobs.QUEUE_SYSTEM_BG, jobs.QUEUE_USER_EXPORT,
                jobs.QUEUE_USER_BG, jobs.QUEUE_SYSTEM_FG,
                jobs.QUEUE_USER_FG]
        js = [s.dispatch(lambda j, q=q: order.append(q), queue_id=q)
              for q in qids]
        blocker.set()
        for j in js:
            assert j.wait(5.0)
        assert order == sorted(qids)
    finally:
        s.shutdown()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_cancel_before_run(pkg):
    control, jobs = _control(pkg)
    s = control.Scheduler(workers=1)
    try:
        blocker = threading.Event()
        s.dispatch(lambda j: blocker.wait(5.0))
        j = s.dispatch(lambda j: "ran")
        j.cancel()
        blocker.set()
        assert j.wait(5.0)
        assert j.state is jobs.JobState.CANCELLED and j.result is None
    finally:
        s.shutdown()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_signals_pub_sub(pkg):
    control, _ = _control(pkg)
    bus = control.SignalBus()
    got = []
    h = bus.connect("HISTORY_CHANGED", lambda **kw: got.append(kw))
    bus.emit("HISTORY_CHANGED", imgid=7)
    bus.disconnect("HISTORY_CHANGED", h)
    bus.emit("HISTORY_CHANGED", imgid=8)
    assert got == [{"imgid": 7}]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_scheduler_emits_job_signals(pkg):
    control, jobs = _control(pkg)
    bus = control.SignalBus()
    events = []
    bus.connect("JOB_STARTED", lambda **kw: events.append("started"))
    bus.connect("JOB_FINISHED", lambda **kw: events.append(
        kw["job"].state))
    s = control.Scheduler(workers=1, signals=bus)
    try:
        job = s.dispatch(lambda j: None)
        assert job.wait(5.0)
        time.sleep(0.05)
        assert events == ["started", jobs.JobState.FINISHED]
    finally:
        s.shutdown()


def test_signal_names_equal_the_jax_package():
    from ansel_tpu.control import signals as ref
    from ansel_tpu_torch.control import signals

    assert signals.SIGNALS == ref.SIGNALS


def test_conf_resolution_order(tmp_path, monkeypatch):
    """runtime > env > file > default (common/conf.c semantics)."""
    from ansel_tpu_torch.core import conf

    conf.register("test.knob", 10)
    assert conf.get_int("test.knob") == 10
    rc = tmp_path / "rc"
    rc.write_text("test.knob=20\n")
    conf.load_file(str(rc))
    assert conf.get_int("test.knob") == 20
    monkeypatch.setenv("ANSEL_TPU_TEST_KNOB", "30")
    assert conf.get_int("test.knob") == 30
    conf.set("test.knob", 40)
    assert conf.get_int("test.knob") == 40
    conf.save_file(str(tmp_path / "rc2"))
    assert "test.knob=40" in (tmp_path / "rc2").read_text()


def test_structured_log_ring_and_domains(capsys):
    from ansel_tpu_torch.core import log

    log.clear()
    log.log("perf", "hidden")         # domain disabled -> ring only
    log.enable("perf")
    log.log("perf", "stage timing", op="exposure", ms=1.5)
    log.disable("perf")
    recs = log.records("perf")
    assert len(recs) == 2
    assert "op=exposure" in recs[1][2]
    err = capsys.readouterr().err
    assert "hidden" not in err and "stage timing" in err


# --- the kernels' first build off the main thread ----------------------------

_FAKE_NVCC = """#!{python}
# stands in for nvcc: logs the call, then builds an empty shared library
# with gcc at the path after -o, slowly enough that builds overlap
import subprocess, sys, time
out = sys.argv[sys.argv.index("-o") + 1]
with open({log!r}, "a") as f:
    f.write(out + "\\n")
time.sleep(0.3)
subprocess.run(["gcc", "-shared", "-fPIC", "-x", "c", "-", "-o", out],
               input=b"int ansel_stub(void) {{ return 7; }}\\n", check=True)
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    log = tmp_path / "nvcc.log"
    exe = tmp_path / "nvcc"
    exe.write_text(_FAKE_NVCC.format(python=sys.executable, log=str(log)))
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "nvcc", lambda: str(exe))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    return log


def test_kernels_first_built_on_the_device_worker(fake_nvcc):
    """Device jobs load a kernel while the main thread builds them all:
    every load gets the one library object, each call of the compiler
    writes its own temporary file, and none is left behind."""
    from ansel_tpu_torch.control import Scheduler

    s = Scheduler(workers=2)
    try:
        js = [s.dispatch(lambda j, n=n: _build.load(n), device=True)
              for n in ("rcd", "rcd", "pointwise_chain", "rcd")]
        _build.build_all()
        for j in js:
            assert j.wait(30.0)
            assert j.error is None, j.error
        libs = [j.result for j in js]
        assert libs[0] is libs[1] is libs[3] is _build.load("rcd")
        assert libs[2] is _build.load("pointwise_chain")
        assert libs[0].ansel_stub() == 7
    finally:
        s.shutdown()
    built = sorted(os.listdir(_build.BUILD_DIR))
    assert len(built) == len(_build.KERNELS)
    assert not [f for f in built if ".tmp." in f]
    outs = fake_nvcc.read_text().split()
    assert len(outs) == len(set(outs))   # no two calls share a file
