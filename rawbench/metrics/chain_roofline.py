"""The per-pixel chain's least time on the frame, from the work the
configuration freezes under `work.chain` (`rawbench/work.py`), over the
device time of the pipe steps that run its stages, in %.  A
configuration that freezes no chain reads nothing here."""

from rawbench import work


def read(r):
    return work.stage_share(r, "chain")
