"""Diffuse or sharpen: the least time of its iterations on the frame,
from the work the configuration freezes under `work.diffuse` (passes
included), over the device time of the pipe step that runs the diffuse
stage, in %."""

from rawbench import work


def read(r):
    return work.stage_share(r, "diffuse")
