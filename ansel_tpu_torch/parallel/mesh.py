"""The device mesh of one process, and the shards that run on it.

The JAX package's mesh is one process's devices (`make_mesh` reshapes
`jax.devices()`, `ansel_tpu/parallel/batch.py:30-38`), and `shard_map`
runs one body on each, with `ppermute` and `psum` inside that body.  The
port keeps that single-controller shape with PyTorch's own idiom for
several devices in one process (`torch.nn.parallel`'s replicate,
scatter, parallel_apply, gather):

  * `Mesh` is a (dp, sp) grid of `torch.device`s with the axis names
    "dp" and "sp".  `make_mesh` takes the machine's CUDA cards.  A list
    passed as `devices=` may name a device more than once: a virtual
    mesh, the counterpart of the JAX tests' virtual CPU devices, by which
    one card, or the CPU, carries several shards.  Asking for more
    shards than there are cards without such a list raises; a mesh never
    wraps by itself.
  * `run_shards(mesh, axis, body, args)` runs `body(*args[i])` for each
    shard i along the axis on a worker thread of its own (kept by the
    mesh), on CUDA each on a stream of its own, and returns the results
    in shard order.  The threads take turns (one runs at a time, handing
    over at each collective and at its end): the host enqueues, the
    streams overlap on the device (`SpatialPipeline`).  `map_shards`
    runs a body that holds no collective on this thread, one shard after
    another, each on its stream (`BatchPipeline`, `spatial_sharded_pipe`).
  * Inside a body, `axis_index(axis)` is the shard's index; in one that
    `run_shards` runs, `ppermute` and `psum` are the axis's collectives:
    a copy to the neighbour shard, and a sum of the shards' tensors on
    the first shard's device sent back to each.  Each one synchronises
    the shards' threads with a barrier and their streams with CUDA
    events, and keeps what a shard published from reuse by its stream
    until every reader's copy has run.

Not torch.distributed across processes: NCCL puts one rank on a card,
so a machine with one card could never run the halo exchange; a gloo
process per shard costs seconds a test; and the JAX package has no
multi-host path to mirror.
"""

from __future__ import annotations

import contextlib
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

AXES = ("dp", "sp")

_LOCAL = threading.local()   # .axes: {axis key: (_Group, shard index)}
_BUILT = threading.Event()   # the kernels were built before any shard ran


def _key(axis):
    return axis if isinstance(axis, str) else tuple(axis)


class Mesh:
    """A (dp, sp) grid of devices; `shape` maps each axis name to its
    size, as a JAX mesh's does."""

    def __init__(self, grid: Sequence[Sequence], axis_names=AXES):
        rows = [[torch.device(d) for d in row] for row in grid]
        if not rows or not rows[0] or any(len(r) != len(rows[0])
                                          for r in rows):
            raise ValueError(f"a mesh needs a full grid of devices: {grid}")
        self.devices = np.empty((len(rows), len(rows[0])), dtype=object)
        for i, row in enumerate(rows):
            for j, dev in enumerate(row):
                self.devices[i, j] = dev
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self._streams = {}
        self._pools = {}
        self._lock = threading.Lock()

    def axis_devices(self, axis) -> List[torch.device]:
        """The devices of `axis` in shard order: "dp" or "sp" at index 0
        of the other axis (the other rows would hold replicas, which the
        port does not run), or ("dp", "sp") for all of them, row-major."""
        key = _key(axis)
        if key == self.axis_names:
            return list(self.devices.flat)
        if key == self.axis_names[0]:
            return list(self.devices[:, 0])
        if key == self.axis_names[1]:
            return list(self.devices[0, :])
        raise ValueError(f"the mesh has no axis {axis!r}")

    def stream(self, axis, i: int) -> Optional[torch.cuda.Stream]:
        """Shard i's CUDA stream on `axis` (made once), None on the CPU."""
        dev = self.axis_devices(axis)[i]
        if dev.type != "cuda":
            return None
        with self._lock:
            s = self._streams.get((_key(axis), i))
            if s is None:
                s = self._streams[(_key(axis), i)] = torch.cuda.Stream(dev)
        return s

    def pool(self, axis) -> ThreadPoolExecutor:
        """The worker threads of `axis`, one a shard, made once and kept,
        so that a call sets up no thread."""
        n = len(self.axis_devices(axis))
        with self._lock:
            ex = self._pools.get(_key(axis))
            if ex is None:
                ex = self._pools[_key(axis)] = ThreadPoolExecutor(
                    max_workers=n, thread_name_prefix=f"shard-{_key(axis)}")
        return ex


def make_mesh(n_devices: Optional[int] = None, spatial: int = 1,
              devices=None) -> Mesh:
    """A mesh of `n_devices` devices (all of them by default) in rows of
    `spatial`: the machine's CUDA cards, or `devices`, which may repeat a
    device (a virtual mesh).  Raises where more devices are asked for
    than `devices` (or the machine) holds."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device; a mesh on the CPU is built "
                "from an explicit list, e.g. devices=[torch.device('cpu')] "
                "* n")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        where = f"the machine has {len(devices)} CUDA card(s)"
    else:
        devices = [torch.device(d) for d in devices]
        where = f"devices= lists {len(devices)}"
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"make_mesh: {n_devices} devices asked for, {where}; a "
                "mesh with more shards than devices is built only from an "
                "explicit devices= list that repeats them")
        devices = devices[:n_devices]
    n = len(devices)
    if n == 0 or spatial < 1 or n % spatial:
        raise ValueError(f"make_mesh: {n} devices do not form rows of "
                         f"{spatial}")
    return Mesh([devices[r * spatial:(r + 1) * spatial]
                 for r in range(n // spatial)])


def virtual_devices(n: int, device="cuda") -> List[torch.device]:
    """`n` shards' devices on `device`'s kind: the CUDA cards in turn
    (a card carries several shards where there are fewer cards than n),
    or the CPU n times.  The explicit list of a virtual mesh."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return [dev] * n
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           "available")
    if dev.index is not None:
        return [dev] * n
    cards = torch.cuda.device_count()
    return [torch.device("cuda", i % cards) for i in range(n)]


# --- inside a body ------------------------------------------------------------
def _shard(axis):
    axes = getattr(_LOCAL, "axes", None) or {}
    try:
        return axes[_key(axis)]
    except KeyError:
        raise RuntimeError(f"no shard of axis {axis!r} runs in this thread; "
                           "collectives run inside run_shards") from None


def in_shard(axis) -> bool:
    """True inside a body that `run_shards` runs over `axis`."""
    return _key(axis) in (getattr(_LOCAL, "axes", None) or {})


def axis_index(axis) -> int:
    """This shard's index along `axis` (`jax.lax.axis_index`)."""
    return _shard(axis)[1]


def _group(axis):
    group, i = _shard(axis)
    if group is None:
        raise RuntimeError(f"the shards of axis {axis!r} run one after "
                           "another (map_shards): no collective runs there")
    return group, i


def ppermute(x: torch.Tensor, axis, perm) -> torch.Tensor:
    """`jax.lax.ppermute`: shard b gets shard a's `x` for each (a, b) in
    `perm`, a shard that is no pair's b gets zeros."""
    group, i = _group(axis)
    return group.ppermute(x, perm, i)


def psum(x: torch.Tensor, axis) -> torch.Tensor:
    """`jax.lax.psum`: the shards' `x` summed in shard order on the first
    shard's device, a copy on each shard's device."""
    group, i = _group(axis)
    return group.psum(x, i)


class _Round:
    """One collective's exchange: what each shard published with its
    stream's event, and each reader's event after its copy."""

    def __init__(self, n: int):
        self.values = [None] * n
        self.events = [None] * n
        self.done = [None] * n
        self.result = None
        self.left = 0


class _Turns:
    """A barrier whose shards take turns: one shard thread runs at a time,
    in shard order, and gives its turn to the next at each barrier and
    when its body ends.  Torch gives up the GIL around each operation, so
    threads that run at once trade it operation by operation: on one H100
    four threads enqueueing config 1's bands took about four times as
    long as one thread enqueueing the four (`scripts/mesh_profile.py`'s
    (c) against its bands from one thread).  The kernels stay
    asynchronous, so the shards' streams still overlap on the device."""

    def __init__(self, n: int):
        self.n = n
        # a condition a shard, on one lock: a hand-over wakes the one
        # shard whose turn it is
        lock = threading.Lock()
        self._cv = [threading.Condition(lock) for _ in range(n)]
        self._turn = 0
        self._running = [True] * n
        self._arrived = 0
        self._generation = 0
        self._broken = False

    def _pass(self, i):
        for d in range(1, self.n + 1):
            j = (i + d) % self.n
            if self._running[j]:
                self._turn = j
                self._cv[j].notify()
                break

    def _until(self, i, ready):
        self._cv[i].wait_for(lambda: self._broken or ready())
        if self._broken:
            raise threading.BrokenBarrierError

    def start(self, i):
        with self._cv[i]:
            self._until(i, lambda: self._turn == i)

    def wait(self, i):
        """Every shard's arrival, then shard i's turn."""
        with self._cv[i]:
            generation = self._generation
            self._arrived += 1
            if self._arrived == self.n:
                self._arrived = 0
                self._generation += 1
            self._pass(i)
            self._until(i, lambda: self._generation != generation
                        and self._turn == i)

    def finish(self, i):
        with self._cv[i]:
            self._running[i] = False
            self._pass(i)

    def abort(self):
        with self._cv[0]:
            self._broken = True
            for cv in self._cv:
                cv.notify_all()


class _Group:
    """The shards of one axis in one `run_shards` call."""

    def __init__(self, devices, streams):
        self.devices = devices
        self.streams = streams
        self.n = len(devices)
        self.barrier = _Turns(self.n)
        self._lock = threading.Lock()
        self._rounds = {}
        self._count = [0] * self.n

    def _event(self, i):
        if self.streams[i] is None:
            return None
        e = torch.cuda.Event()
        e.record(self.streams[i])
        return e

    def _enter(self, i, value):
        """Publish `value` as shard i's part of its next collective; ->
        the round, once every shard has published."""
        k = self._count[i]
        self._count[i] += 1
        with self._lock:
            r = self._rounds.setdefault(k, _Round(self.n))
        r.values[i] = value
        r.events[i] = self._event(i)
        self.barrier.wait(i)
        return k, r

    def _fetch(self, v, event, i):
        """`v`, published with `event`, copied onto shard i's device on
        its stream (a cross-device copy runs between both devices'
        current streams, after this stream's wait)."""
        if event is not None:
            self.streams[i].wait_event(event)
        return v.to(self.devices[i], copy=True)

    def _leave(self, k, r, i):
        """Shard i's reads are enqueued: once every shard's are, each
        stream waits for all of them, so what it published is not
        reused before they ran."""
        r.done[i] = self._event(i)
        self.barrier.wait(i)
        s = self.streams[i]
        if s is not None:
            for e in r.done:
                s.wait_event(e)
        with self._lock:
            r.left += 1
            if r.left == self.n:
                del self._rounds[k]

    def ppermute(self, x, perm, i):
        k, r = self._enter(i, x)
        src = [a for a, b in perm if b == i]
        out = (self._fetch(r.values[src[0]], r.events[src[0]], i) if src
               else torch.zeros_like(x))
        self._leave(k, r, i)
        return out

    def psum(self, x, i):
        k, r = self._enter(i, x)
        if i == 0:
            total = x.clone()
            for j in range(1, self.n):
                total = total + self._fetch(r.values[j], r.events[j], 0)
            r.result = (total, self._event(0))
        self.barrier.wait(i)
        out = r.result[0] if i == 0 else self._fetch(*r.result, i)
        self._leave(k, r, i)
        return out


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)


def _record(obj, stream):
    """Mark the CUDA tensors in `obj` on `stream`'s device as used by
    it, so the caching allocator does not reuse their memory before
    `stream`'s work on them has run."""
    for t in _tensors(obj):
        if t.device == stream.device:
            t.record_stream(stream)


def _streams_in(mesh, axis, args):
    """The shards' streams along `axis` (None on the CPU), each waiting
    for the work this thread queued on its device, `args[i]` marked as
    used by shard i's stream."""
    devices = mesh.axis_devices(axis)
    if len(args) != len(devices):
        raise ValueError(f"{len(args)} argument tuples for "
                         f"{len(devices)} shards")
    streams = [mesh.stream(axis, i) for i in range(len(devices))]
    for dev, s, a in zip(devices, streams, args):
        if s is not None:
            s.wait_stream(torch.cuda.current_stream(dev))
            _record(a, s)
    return streams


def _streams_out(mesh, axis, streams, results):
    """This thread's current streams wait for the shards' streams, and
    mark the results as used by them."""
    for dev, s, res in zip(mesh.axis_devices(axis), streams, results):
        if s is not None:
            main = torch.cuda.current_stream(dev)
            main.wait_stream(s)
            _record(res, main)


def map_shards(mesh: Mesh, axis, body: Callable, args: Sequence) -> list:
    """`body(*args[i])` for each shard i along `axis`, one after another
    on this thread, on CUDA each on the shard's stream: for a body that
    holds no collective (`axis_index` holds there).  The results in
    shard order, ready on this thread's current streams."""
    streams = _streams_in(mesh, axis, args)
    results = []
    before = getattr(_LOCAL, "axes", None)
    try:
        for i, (s, a) in enumerate(zip(streams, args)):
            _LOCAL.axes = dict(before or {})
            _LOCAL.axes[_key(axis)] = (None, i)
            ctx = (torch.cuda.stream(s) if s is not None
                   else contextlib.nullcontext())
            with ctx:
                results.append(body(*a))
    finally:
        _LOCAL.axes = before
    _streams_out(mesh, axis, streams, results)
    return results


def run_shards(mesh: Mesh, axis, body: Callable, args: Sequence) -> list:
    """`body(*args[i])` for each shard i along `axis`, each on a worker
    thread of its own (`Mesh.pool`; on CUDA on the shard's stream, which
    first waits for the work this thread queued on its device), the
    results in shard order, ready on this thread's current streams.  The
    first exception a shard raises is raised here; the other shards'
    collectives are released."""
    devices = mesh.axis_devices(axis)
    n = len(devices)
    streams = _streams_in(mesh, axis, args)
    if any(s is not None for s in streams) and not _BUILT.is_set():
        # every kernel built and loaded before a shard launches one
        from ..kernels import _build

        _build.build_all()
        _BUILT.set()
    group = _Group(devices, streams)
    key = _key(axis)
    results: list = [None] * n
    errors: list = [None] * n

    def work(i):
        before = getattr(_LOCAL, "axes", None)
        _LOCAL.axes = dict(before or {})
        _LOCAL.axes[key] = (group, i)
        try:
            group.barrier.start(i)
            ctx = (torch.cuda.stream(streams[i]) if streams[i] is not None
                   else contextlib.nullcontext())
            with ctx:
                results[i] = body(*args[i])
            group.barrier.finish(i)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors[i] = e
            group.barrier.abort()
        finally:
            _LOCAL.axes = before

    # n tasks on a pool of n threads: every shard has a thread, as the
    # collectives' barriers need
    for f in [mesh.pool(axis).submit(work, i) for i in range(n)]:
        f.result()
    raised = [e for e in errors if e is not None]
    if raised:
        first = next((e for e in raised
                      if not isinstance(e, threading.BrokenBarrierError)),
                     raised[0])
        raise first
    _streams_out(mesh, axis, streams, results)
    return results
