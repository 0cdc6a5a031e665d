"""The yardstick of the roofline shares: the work of each stage, frozen
here and counted from the frame's shape, and the card's peaks.

The work of a configuration's stages is frozen in its own file,
`configs/<config>.json`, under `work`: per stage the pipe stages it
covers, its float32 operations and MUFU operations a pixel, its bytes
read and written a pixel, and the passes it makes (`times`).  A share
is the least time the card could take for that work over the device
time of the steps that run those stages.  The least time is the largest
of three: the float32 operations at the published float32 rate, the
special-function (MUFU) operations at the SFU rate, and the bytes, each
input byte read once and each output byte written once, at the HBM
rate.  The counts are of the work the algorithm needs on the image's
pixels, not of what a build issues: a kernel that fuses multiplies and
adds does the same work in fewer instructions, and a share of the
issue rate would pass 100% for it.
"""

from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3.
# The SFU rate: 132 SMs x 16 special-function results a clock x 1.98 GHz.
PEAK_FLOPS = 67e12
PEAK_SFU = 132 * 16 * 1.98e9
PEAK_BYTES = 3.35e12


@dataclasses.dataclass(frozen=True)
class Work:
    """Per pixel: float32 operations, MUFU operations, bytes read and
    written once."""

    ops: float
    mufu: float
    bytes_in: float
    bytes_out: float


def least_seconds(work: Work, pixels: int, times: int = 1) -> float:
    """Least time of `times` passes of `work` over `pixels`, each byte
    of the stage's input read once and of its output written once."""
    return max(work.ops * pixels * times / PEAK_FLOPS,
               work.mufu * pixels * times / PEAK_SFU,
               (work.bytes_in + work.bytes_out) * pixels / PEAK_BYTES)


def share(work: Work, pixels: int, device_seconds: float,
          times: int = 1):
    """The roofline share in %, or None without a device time."""
    if not device_seconds or device_seconds <= 0:
        return None
    return 100.0 * least_seconds(work, pixels, times) / device_seconds


def frozen(cfg: dict, stage: str):
    """-> (Work, the pipe stages it covers, passes) of a stage frozen in
    the configuration's file, or None where it freezes none."""
    w = cfg.get("work", {}).get(stage)
    if w is None:
        return None
    return (Work(ops=w["ops"], mufu=w["mufu"], bytes_in=w["bytes_in"],
                 bytes_out=w["bytes_out"]),
            tuple(w["stages"]), int(w.get("times", 1)))


def stage_share(r, stage: str):
    """The roofline share (%) of a stage frozen in the run's
    configuration, over the device time of the steps that run it; None
    where the configuration freezes no such stage or no step was
    timed."""
    f = frozen(r.cfg, stage)
    if f is None:
        return None
    w, stages, times = f
    return share(w, r.pixels, r.step_seconds(*stages), times)
