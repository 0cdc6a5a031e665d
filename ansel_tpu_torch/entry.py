"""The entry point of the port, the counterpart of `entry()` in the
repository's `__graft_entry__.py`.

    fn, (raw_padded, coeffs) = entry()          # on the CUDA card
    out = fn(raw_padded, coeffs)                 # (3, H, W_padded) display RGB

The flagship pipe at 256 x 384: a synthetic gradients raw and the
history exposure +0.5, filmicrgb, with the mandatory modules the planner
adds.  `fn(raw_padded, coeffs)` runs `Pipeline.run_steps(raw_padded,
pipe.schedule(coeffs))` on the device the arguments live on, `coeffs`
being the pipe's device coefficients.  `entry(device="cpu")` builds it
on the CPU, where every kernel runs its plain twin.

`dryrun_multichip` is not ported: the multi-device path waits for its
own slice (ROADMAP Queue 1 item 12).
"""

from __future__ import annotations

import torch

from .io.synthetic import synth_raw
from .ops.base import pad_to
from .pipeline.engine import HistoryItem, Pipeline, coeffs_to_device


def _build(h: int, w: int):
    raw, meta, _ = synth_raw(h=h, w=w, kind="gradients")
    history = [
        HistoryItem("exposure", {"exposure": 0.5}),
        HistoryItem("filmicrgb", {}),
    ]
    return raw, meta, history


def entry(device="cuda"):
    """-> (fn, (raw_padded, coeffs)), both arguments on `device`."""
    raw, meta, history = _build(256, 384)
    pipe = Pipeline(meta, history, device=device)
    coeffs = coeffs_to_device(pipe.coeffs(), pipe.device)
    raw_padded = torch.from_numpy(pad_to(raw, pipe.spec_in)).to(pipe.device)
    return pipe.trace_fn(), (raw_padded, coeffs)


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print(tuple(out.shape), out.dtype, out.device)
