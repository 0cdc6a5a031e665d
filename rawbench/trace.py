"""Reading a torch.profiler window of the roll: the device operations,
the device's busy time, and what the host was doing while the device
sat idle (the benchmark's own `rawbench.*` ranges around the program's
calls)."""

from __future__ import annotations

import collections
import dataclasses

ENQUEUE = "rawbench.enqueue"
WAIT = "rawbench.wait"


@dataclasses.dataclass
class Window:
    """A traced window: device operations as (name, start_s, end_s), the
    host's labelled ranges as (label, start_s, end_s), the window's span
    (s) and the images submitted in it."""

    device_ops: list
    host: list
    start: float
    end: float
    images: int

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def kernels(self) -> list:
        return [op for op in self.device_ops
                if not op[0].startswith(("Memcpy", "Memset"))]

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, clipped to the
        window."""
        spans = sorted((max(a, self.start), min(b, self.end))
                       for _, a, b in self.device_ops
                       if b > self.start and a < self.end)
        merged = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def idle_gaps(self) -> list:
        """[(what the host did, idle seconds)], the most first: the idle
        time under the host's labelled ranges, the rest as `other`."""
        gaps, t = [], self.start
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if t < self.end:
            gaps.append((t, self.end))
        out = collections.Counter()
        for a, b in gaps:
            covered = 0.0
            for label, ha, hb in self.host:
                o = min(b, hb) - max(a, ha)
                if o > 0:
                    out[label.split(".", 1)[-1]] += o
                    covered += o
            out["other"] += max(0.0, (b - a) - covered)
        return sorted(out.items(), key=lambda kv: -kv[1])

    def top_ops(self, n: int = 10) -> list:
        total = collections.Counter()
        for name, a, b in self.device_ops:
            total[name] += b - a
        return [[k[:96], v] for k, v in total.most_common(n)]


def from_profile(prof, images: int) -> Window:
    """Collect a finished torch.profiler run.  Device operations are the
    events on the CUDA device but the profiler's echo of the host's
    labelled ranges; the window runs from the first enqueue to the end of
    the last wait."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for ev in prof.events():
        rng = ev.time_range
        a, b = rng.start * 1e-6, rng.end * 1e-6
        if ev.name.startswith("rawbench."):
            if ev.device_type != cuda:
                host.append((ev.name, a, b))
            continue
        if ev.device_type == cuda:
            dev.append((ev.name, a, b))
    if not host:
        raise RuntimeError("the profile holds none of the harness's ranges")
    start = min(a for label, a, _ in host if label == ENQUEUE)
    end = max(b for label, _, b in host if label == WAIT)
    return Window(dev, host, start, end, images)
