"""The benchmark's one load generator.  A traffic mix is a data file,
`rawbench/traffic/<name>.json`; every key of it is a parameter here:

- `arrivals`: `closed` keeps `in_flight` images handed to the program
  (when the oldest is ready the next is handed over: a roll handed over
  whole, exported as fast as the card goes); `sets` is an open loop in
  which `set_size` images arrive together at a fixed period, `rate`
  images a second on average (a set of frames that lands at once and
  has to come back developed).
- `roll_images`: the distinct mosaics the images cycle through.
- `edits` (optional): a list of [op, parameter, [values]]; each of the
  roll's images takes one value of each from the seed, so its history
  is its own and the program plans it anew.  Without it the
  configuration's history is pasted onto the whole roll.
- `source`: `device` (mosaics made in device memory) or `host` (mosaics
  in pinned host memory, uploaded by each image's call).
- `sink`: `device` (outputs stay there and are dropped once ready) or
  `host` (each output is copied to host memory before it counts as
  ready).

An image's latency runs from its arrival (in the closed loop, the
moment it is handed over) to the moment the host sees it ready.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ARRIVALS = ("closed", "sets")
PLACES = ("device", "host")
# the open loop hands the program at most this many images at once; an
# arrival past it waits at the door, its latency counting from arrival
MAX_OUTSTANDING = 32
# between arrivals the open loop asks whether the oldest image is ready
# this often: an image is seen ready at most this late, and a traced
# window records a few queries a millisecond, not one a microsecond
POLL_S = 50e-6


def load(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return checked(json.load(f), name)


def checked(mix: dict, name: str = "mix") -> dict:
    """The mix with its defaults, or ValueError for one this generator
    cannot drive."""
    mix = {"source": "device", "sink": "device", "edits": [], **mix}
    if mix.get("arrivals") not in ARRIVALS:
        raise ValueError(f"traffic {name}: arrivals must be one of "
                         f"{ARRIVALS}, not {mix.get('arrivals')!r}")
    need = ("in_flight",) if mix["arrivals"] == "closed" \
        else ("set_size", "rate")
    for key in need + ("roll_images",):
        if not float(mix.get(key, 0)) > 0:
            raise ValueError(f"traffic {name}: {key} must be positive")
    for key in ("source", "sink"):
        if mix[key] not in PLACES:
            raise ValueError(f"traffic {name}: {key} must be one of "
                             f"{PLACES}")
    for edit in mix["edits"]:
        if len(edit) != 3 or not edit[2]:
            raise ValueError(f"traffic {name}: an edit is [op, parameter, "
                             "[values]]")
    return mix


@dataclasses.dataclass
class Roll:
    """What one drive saw: per image handed over inside the window its
    latency (s) and the host's time in the program's call (s), the
    images handed over, those ready inside the window, the window's
    length (s), and the outputs kept for the check as (image, output)."""

    latencies: list
    enqueue: list
    submitted: int
    completed: int
    window_s: float
    kept: list


def drive(mix: dict, submit, wait, done, seconds: float = None,
          max_images: int = None, keep_at=(), span=None,
          clock=time.perf_counter) -> Roll:
    """Drive `submit(i) -> (output, ready)` by the mix's arrivals until
    `seconds` have passed (or `max_images` were submitted), then wait
    for the rest.  `wait(ready)` blocks until an image is ready;
    `done(ready)` tells without blocking, so that an image is retired
    when it is ready and not only when the queue is full (the open loop
    polls it between arrivals).  The
    first image submitted at or after each of `keep_at` (seconds into
    the window) has its output kept.  `span(label)`, if given, is a
    context around each call (`enqueue`, `wait`)."""
    span = span or (lambda label: contextlib.nullcontext())
    closed = mix["arrivals"] == "closed"
    if closed:
        limit = int(mix["in_flight"])
    else:
        set_size = int(mix["set_size"])
        period = set_size / float(mix["rate"])
        limit = MAX_OUTSTANDING
    keep_at = sorted(keep_at)
    queue = collections.deque()
    lat, enq, kept = [], [], []
    n = completed = 0
    t0 = clock()
    close = t0 + seconds if seconds is not None else float("inf")

    def retire():
        # every image handed over in the window has its latency, also
        # one that is ready after the close; the rate counts those ready
        # inside it
        nonlocal completed
        t_arr, _, _ = queue.popleft()
        t_done = clock()
        lat.append(t_done - t_arr)
        completed += t_done <= close

    while True:
        if queue and done(queue[0][2]):
            retire()
            continue
        t_arr = clock() if closed else t0 + (n // set_size) * period
        if t_arr >= close or (max_images is not None and n >= max_images):
            break
        if len(queue) >= limit:
            with span("wait"):
                wait(queue[0][2])
            retire()
            continue
        if clock() < t_arr:
            # the open loop between arrivals: retire the oldest once ready,
            # asking the device every POLL_S
            with span("wait"):
                poll = now = clock()
                while now < t_arr:
                    if queue and now >= poll:
                        if done(queue[0][2]):
                            break
                        poll = now + POLL_S
                    now = clock()
            continue
        t_sub = clock()
        with span("enqueue"):
            out, ready = submit(n)
        enq.append(clock() - t_sub)
        while keep_at and t_sub - t0 >= keep_at[0]:
            keep_at.pop(0)
            if not kept or kept[-1][0] != n:
                kept.append((n, out))
        queue.append((t_arr, out, ready))
        n += 1
    while queue:
        with span("wait"):
            wait(queue[0][2])
        retire()
    window = seconds if seconds is not None else clock() - t0
    return Roll(lat, enq, n, completed, window, kept)
