"""Control layer: job scheduler, signals, progress (`ansel_tpu/control`,
copied; reference `src/control/jobs.{c,h}`, `signal.{c,h}`,
`progress.h`)."""

from .jobs import Job, JobQueue, Scheduler  # noqa: F401
from .signals import SignalBus  # noqa: F401
