"""Batch export: collection -> scheduler export queue -> files
(`ansel_tpu/library/export.py`, on the port's render).

Reference: the export flow `src/libs/export.c` + `control/jobs/
export_jobs.c` (serialized USER_EXPORT queue, filename template from
variables.c, per-image progress) driving `imageio_core.c` writes.

As in the JAX package, each image is one `device=True` job on the
serialized USER_EXPORT queue: decode, render and encode run inside it on
the device worker's thread, one image at a time (the reference's
reserved-worker discipline).  The render runs on the CUDA card unless
the caller passes `device="cpu"`; a job's exception is re-raised here.
"""

from __future__ import annotations

import os
from typing import List, Optional

from ..control.jobs import QUEUE_USER_EXPORT, Scheduler
from .collections import Collection
from .db import Library
from .variables import expand


def batch_export(lib: Library, collection: Collection, out_dir: str,
                 template: str = "$(FILE_NAME)",
                 settings=None, scheduler: Optional[Scheduler] = None,
                 fmt: str = "jpg", device="cuda") -> List[str]:
    """Export every image in the collection; -> written paths."""
    from ..io.rawfile import load_raw
    from ..io.xmp import parse_xmp
    from ..pipeline.export import ExportSettings, export_image

    settings = settings or ExportSettings(format=fmt)
    own = scheduler is None
    sched = scheduler or Scheduler(workers=2)
    os.makedirs(out_dir, exist_ok=True)
    written: List[str] = []
    jobs = []
    for seq, imgid in enumerate(collection.run(lib)):
        path = lib.image_path(imgid)
        xmp = lib.xmp_path(imgid)
        name = expand(template, lib, imgid, sequence=seq)
        out_path = os.path.join(out_dir, f"{name}.{settings.format}")

        def run(job, path=path, xmp=xmp, out_path=out_path):
            raw, meta = load_raw(path)
            history = parse_xmp(xmp).history if os.path.exists(xmp) \
                else None
            job.set_progress(0.3)
            export_image(raw, meta, history=history,
                         output_path=out_path, settings=settings,
                         device=device)
            job.set_progress(1.0)
            return out_path

        jobs.append(sched.dispatch(run, queue_id=QUEUE_USER_EXPORT,
                                   description=f"export {name}",
                                   device=True))
    for j in jobs:
        j.wait()
        if j.error is not None:
            if own:
                sched.shutdown()
            raise j.error
        written.append(j.result)
    if own:
        sched.shutdown()
    if sched.signals:
        sched.signals.emit("EXPORT_FINISHED", paths=written)
    return written
