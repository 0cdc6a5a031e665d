"""Job scheduler: priority queues + worker pool + a reserved device
worker (`ansel_tpu/control/jobs.py`, copied: host Python only).

Reference: `ansel/src/control/jobs.{c,h}` — 5 priority queues
(jobs.h:52-60): USER_FG, SYSTEM_FG (droppable: newer jobs replace
queued ones, used for thumbnails), USER_BG, USER_EXPORT (serialized:
one at a time), SYSTEM_BG; N generic workers + one reserved darkroom
worker (jobs.c:645-671, jobs.h:38-39); job states, cancel, wait,
progress (jobs.h:41-95).

As in the JAX package, the reference's reserved darkroom worker becomes
the single DEVICE worker: every job flagged `device=True` (pipeline
builds and renders on the card) is serialized onto its thread, while
generic workers handle host-side work (decode, encode, DB, IO).  The
CUDA kernels a device job launches load on that thread at first use
(`kernels/_build.load`, under a lock).  A job's exception is kept on
the job (`Job.error`) for its caller to re-raise.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
import threading
from typing import Any, Callable, List, Optional

QUEUE_USER_FG = 0
QUEUE_SYSTEM_FG = 1     # droppable
QUEUE_USER_BG = 2
QUEUE_USER_EXPORT = 3   # serialized
QUEUE_SYSTEM_BG = 4


class JobState(enum.Enum):
    INITIALIZED = 0
    QUEUED = 1
    RUNNING = 2
    FINISHED = 3
    CANCELLED = 4
    FAILED = 5


_seq = itertools.count()


@dataclasses.dataclass(order=True)
class Job:
    sort_key: tuple = dataclasses.field(init=False)
    fn: Callable[["Job"], Any] = dataclasses.field(compare=False)
    queue_id: int = dataclasses.field(default=QUEUE_USER_BG,
                                      compare=False)
    description: str = dataclasses.field(default="", compare=False)
    device: bool = dataclasses.field(default=False, compare=False)
    drop_key: Optional[str] = dataclasses.field(default=None,
                                                compare=False)
    state: JobState = dataclasses.field(default=JobState.INITIALIZED,
                                        compare=False)
    result: Any = dataclasses.field(default=None, compare=False)
    error: Optional[BaseException] = dataclasses.field(default=None,
                                                       compare=False)
    progress: float = dataclasses.field(default=0.0, compare=False)
    _done: threading.Event = dataclasses.field(
        default_factory=threading.Event, compare=False)
    _cancel: threading.Event = dataclasses.field(
        default_factory=threading.Event, compare=False)

    def __post_init__(self):
        self.sort_key = (self.queue_id, next(_seq))

    def cancel(self):
        self._cancel.set()
        if self.state in (JobState.INITIALIZED, JobState.QUEUED):
            self.state = JobState.CANCELLED
            self._done.set()

    @property
    def cancelled(self) -> bool:
        return self._cancel.is_set()

    def set_progress(self, frac: float):
        self.progress = max(0.0, min(float(frac), 1.0))

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)


class JobQueue:
    """One priority bucket; SYSTEM_FG drops stale jobs by drop_key."""

    def __init__(self, droppable: bool = False):
        self.droppable = droppable
        self._jobs: List[Job] = []
        self._lock = threading.Lock()

    def put(self, job: Job):
        with self._lock:
            if self.droppable and job.drop_key is not None:
                for old in self._jobs:
                    if old.drop_key == job.drop_key:
                        old.cancel()
                self._jobs = [j for j in self._jobs
                              if j.state is JobState.QUEUED]
            job.state = JobState.QUEUED
            self._jobs.append(job)

    def pop(self) -> Optional[Job]:
        with self._lock:
            while self._jobs:
                job = self._jobs.pop(0)
                if job.state is JobState.QUEUED:
                    return job
            return None

    def __len__(self):
        with self._lock:
            return sum(j.state is JobState.QUEUED for j in self._jobs)


class Scheduler:
    """Worker pool over the 5 queues + one reserved device worker."""

    def __init__(self, workers: int = None, signals=None):
        from ..core import conf as conf_mod

        if workers is None:
            workers = conf_mod.get_int("control.workers", 4)
        self.queues = {
            QUEUE_USER_FG: JobQueue(),
            QUEUE_SYSTEM_FG: JobQueue(droppable=True),
            QUEUE_USER_BG: JobQueue(),
            QUEUE_USER_EXPORT: JobQueue(),
            QUEUE_SYSTEM_BG: JobQueue(),
        }
        self.signals = signals
        self._wake = threading.Condition()
        self._shutdown = False
        self._export_busy = threading.Lock()
        self._threads = [
            threading.Thread(target=self._worker, args=(False,),
                             daemon=True, name=f"worker-{i}")
            for i in range(max(1, workers))]
        self._threads.append(threading.Thread(
            target=self._worker, args=(True,), daemon=True,
            name="device-worker"))
        for t in self._threads:
            t.start()

    def dispatch(self, fn, queue_id: int = QUEUE_USER_BG,
                 description: str = "", device: bool = False,
                 drop_key: Optional[str] = None) -> Job:
        job = Job(fn=fn, queue_id=queue_id, description=description,
                  device=device, drop_key=drop_key)
        self.queues[queue_id].put(job)
        with self._wake:
            self._wake.notify_all()
        return job

    def _next_job(self, device_worker: bool) -> Optional[Job]:
        for qid in (QUEUE_USER_FG, QUEUE_SYSTEM_FG, QUEUE_USER_BG,
                    QUEUE_USER_EXPORT, QUEUE_SYSTEM_BG):
            q = self.queues[qid]
            with q._lock:
                for i, job in enumerate(q._jobs):
                    if job.state is not JobState.QUEUED:
                        continue
                    if job.device != device_worker:
                        continue
                    if qid == QUEUE_USER_EXPORT \
                            and self._export_busy.locked():
                        continue
                    q._jobs.pop(i)
                    return job
        return None

    def _worker(self, device_worker: bool):
        while True:
            with self._wake:
                job = self._next_job(device_worker)
                if job is None:
                    if self._shutdown:
                        return
                    self._wake.wait(timeout=0.1)
                    continue
            serialized = job.queue_id == QUEUE_USER_EXPORT
            if serialized:
                self._export_busy.acquire()
            try:
                if job.cancelled:
                    job.state = JobState.CANCELLED
                else:
                    job.state = JobState.RUNNING
                    if self.signals:
                        self.signals.emit("JOB_STARTED", job=job)
                    try:
                        job.result = job.fn(job)
                        job.state = (JobState.CANCELLED if job.cancelled
                                     else JobState.FINISHED)
                    except BaseException as e:  # noqa: BLE001
                        job.error = e
                        job.state = JobState.FAILED
            finally:
                if serialized:
                    self._export_busy.release()
                job._done.set()
                if self.signals:
                    self.signals.emit("JOB_FINISHED", job=job)
                with self._wake:
                    self._wake.notify_all()

    def shutdown(self, wait: bool = True):
        self._shutdown = True
        with self._wake:
            self._wake.notify_all()
        if wait:
            for t in self._threads:
                t.join(timeout=5.0)
