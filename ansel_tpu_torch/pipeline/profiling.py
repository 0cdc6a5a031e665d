"""Per-stage timing and NaN scan — the `-d perf` / `-d nan` runners
(`ansel_tpu/pipeline/profiling.py`).

Reference: per-module perf lines `pixelpipe_hb.c:727-756` (dt_show_times
around each node dispatch) and the `-d nan` post-module NaN/Inf scan
`pixelpipe_hb.c:759-831` (counts NaNs/Infs + min/max per module, prints
one line per offender).

The production path runs consecutive per-pixel stages as one chain;
these runners split the pipe at every stage and schedule each alone with
the engine's own `Pipeline.schedule`, so a per-pixel stage still runs as
a one-stage chain (on the card, one launch of the chain kernel) and
every other stage through `Op.apply`, as the export runs it (a blended
stage with its blend, the raster side-band and raw-detail plane carried
from stage to stage).  On the
card a stage is timed between CUDA events after one warm-up call; on the
CPU with `perf_counter`.  Numbers are upper bounds of what the chained
pipe spends on a stage (each stage reads and writes its own frame), and
the right tool for finding the hot or broken module.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from ..ops import base as ops_base
from . import engine as engine_mod


@dataclasses.dataclass
class StageReport:
    name: str
    ms: float
    shape: tuple
    nan: int = 0
    inf: int = 0
    vmin: float = 0.0
    vmax: float = 0.0

    def line(self) -> str:
        s = f"[perf] {self.name:<18} {self.ms:8.2f} ms  {self.shape}"
        if self.nan or self.inf:
            s += f"  !! NaN={self.nan} Inf={self.inf}"
        return s


def _time_ms(fn, device: torch.device, repeats: int):
    """(last result, ms per call) of `fn` after one warm-up call."""
    y = fn()
    if device.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(repeats):
            y = fn()
        b.record()
        b.synchronize()
        return y, a.elapsed_time(b) / repeats
    t0 = time.perf_counter()
    for _ in range(repeats):
        y = fn()
    return y, (time.perf_counter() - t0) / repeats * 1e3


def run_stages(pipe: engine_mod.Pipeline, raw: np.ndarray,
               nan_scan: bool = False, repeats: int = 1,
               verbose: bool = True) -> List[StageReport]:
    """Run one stage at a time on the pipe's device; -> per-stage timings
    (and NaN statistics)."""
    coeffs = engine_mod.coeffs_to_device(pipe.coeffs(), pipe.device)
    x = torch.from_numpy(np.ascontiguousarray(ops_base.pad_to(
        np.asarray(raw, np.float32), pipe.spec_in))).to(pipe.device)
    reports: List[StageReport] = []
    carry = {}
    for i, (s, c) in enumerate(zip(pipe.stages, coeffs)):
        steps = pipe.schedule([c], i, i + 1)
        y, ms = _time_ms(lambda: pipe.run_steps(x, steps, carry),
                         pipe.device, repeats)
        rep = StageReport(s.name, ms, tuple(y.shape))
        if nan_scan:
            # reduce on the device; read back four scalars
            finite = torch.isfinite(y)
            inf = torch.tensor(float("inf"), device=y.device)
            rep.nan = int(torch.isnan(y).sum())
            rep.inf = int(torch.isinf(y).sum())
            rep.vmin = float(torch.where(finite, y, inf).min())
            rep.vmax = float(torch.where(finite, y, -inf).max())
        reports.append(rep)
        if verbose:
            print(rep.line())
        x = y
    if verbose:
        total = sum(r.ms for r in reports)
        print(f"[perf] {'TOTAL (stage-split)':<18} {total:8.2f} ms")
    return reports


def nan_report(reports: List[StageReport]) -> Optional[str]:
    """First offending stage, or None if the pipe is clean."""
    for r in reports:
        if r.nan or r.inf:
            return (f"{r.name}: {r.nan} NaN / {r.inf} Inf "
                    f"(finite range [{r.vmin:g}, {r.vmax:g}])")
    return None
