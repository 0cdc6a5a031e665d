"""The demosaic's least time on the frame, from the work the
configuration freezes under `work.demosaic` (RCD's in both of today's
configurations), over the device time of the pipe step that runs the
demosaic stage, in %."""

from rawbench import work


def read(r):
    return work.stage_share(r, "demosaic")
