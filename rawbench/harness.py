"""One run of one cell: set-up, the measured window, the traced window,
the per-layer readings, and the check of the outputs against the plain
reference.  Everything a cell needs is found by name: its entry in
BENCHMARK.json, `configs/<config>.json` (with the frozen work of its
stages), `traffic/<traffic>.json` (the load generator's parameters),
`reference/<config>.py` and `metrics/<metric>.py`.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

from rawbench import loadgen

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TRACE_SECONDS = 2.0     # the traced window
STEP_REPS = 5           # images timed step by step, the median kept
FORBIDDEN = ("jax", "jaxlib", "flax", "ansel_tpu")


def load_bench(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_config(entry: dict) -> dict:
    """A configuration's file, found by its entry in BENCHMARK.json."""
    with open(os.path.join(ROOT, entry["file"])) as f:
        return json.load(f)


def cell_of(bench: dict, workload: str):
    """-> (cell entry, configuration entry)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"rawbench: no workload {workload!r} in "
                         f"BENCHMARK.json ({', '.join(cells)})")
    cell = cells[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return cell, cfg


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out[0] if out else "unknown"


def load_reader(name: str):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"rawbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Readings:
    """What the per-layer readers read: the configuration, the pixels of
    its frame, the measured window's roll, the traced window, and each
    pipe step's device seconds as (stage names, seconds)."""

    cfg: dict
    pixels: int
    roll: object
    window: object = None
    steps: list = None

    def step_seconds(self, *stages):
        """Device seconds of the steps that run any of `stages`, or None
        where no step does or steps were not timed."""
        if not self.steps:
            return None
        hit = [t for names, t in self.steps if set(names) & set(stages)]
        return sum(hit) if hit else None


def raw_meta(cfg: dict):
    """The program's RawMeta of the configuration's frame and camera."""
    from ansel_tpu_torch.core.types import CFAPattern, RawMeta

    fr, cam = cfg["frame"], cfg["camera"]
    return RawMeta(width=fr["width"], height=fr["height"],
                   cfa=CFAPattern[cam["cfa"]],
                   black_levels=(float(cam["black"]),) * 4,
                   white_point=float(cam["white"]),
                   wb_coeffs=tuple(float(v) for v in cam["wb"]),
                   cam_to_xyz=tuple(float(v) for v in cam["cam_to_xyz"]),
                   maker="rawbench", model=cfg["name"])


def plan(meta, history: list, device: str):
    """The program's plan of a history given as [op, params] pairs."""
    from ansel_tpu_torch.pipeline.engine import HistoryItem, \
        compile_pipeline

    return compile_pipeline(
        meta, [HistoryItem(op=op, params=dict(p)) for op, p in history],
        device=device)


def build_pipe(cfg: dict, device: str):
    """Plan the configuration's history through the program's
    `compile_pipeline`; the planned stages and padded input are held to
    the configuration file's."""
    fr = cfg["frame"]
    pipe = plan(raw_meta(cfg), cfg["history"], device)
    spec = pipe.pipe.spec_in
    names = [s.name for s in pipe.pipe.stages]
    if names != cfg["pipe"]:
        raise RuntimeError(f"{cfg['name']}: the program plans {names}, the "
                           f"configuration states {cfg['pipe']}")
    if (spec.pad_h, spec.pad_w) != (fr["pad_height"], fr["pad_width"]):
        raise RuntimeError(f"{cfg['name']}: the program takes a "
                           f"{spec.pad_h} x {spec.pad_w} mosaic, the "
                           f"configuration states {fr['pad_height']} x "
                           f"{fr['pad_width']}")
    return pipe


def histories(cfg: dict, mix: dict, seed: int):
    """The history of each of the roll's images: the configuration's,
    with each of the mix's `edits` set to a value drawn from the seed;
    None where the mix pastes one edit onto the whole roll."""
    if not mix["edits"]:
        return None
    rng = np.random.default_rng([seed % 2**64, 0x65646974])
    out = []
    for _ in range(int(mix["roll_images"])):
        hist = [[op, dict(p)] for op, p in cfg["history"]]
        for op, key, values in mix["edits"]:
            value = values[int(rng.integers(len(values)))]
            hits = [p for o, p in hist if o == op]
            if not hits:
                raise ValueError(f"{cfg['name']}: an edit of {op}, which "
                                 "the history does not hold")
            hits[0][key] = value
        out.append(hist)
    return out


def step_times(pipe, mosaic, reps: int = STEP_REPS) -> list:
    """Each step's device seconds between CUDA events around
    `Pipeline.run_steps` on that step alone, the median of `reps`
    images: [(stage names, seconds)]."""
    import torch

    p = pipe.pipe
    names = [tuple(s.name for s in p.stages[i:j])
             for _, i, j, _ in pipe.steps]
    samples = [[] for _ in pipe.steps]
    for _ in range(reps):
        cur, carry, marks = mosaic, {}, []
        for step in pipe.steps:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            cur = p.run_steps(cur, [step], carry)
            b.record()
            marks.append((a, b))
        torch.cuda.synchronize()
        for k, (a, b) in enumerate(marks):
            samples[k].append(a.elapsed_time(b) * 1e-3)
    return [(n, statistics.median(s)) for n, s in zip(names, samples)]


def max_gap(out, ref) -> float:
    """The widest gap between the program's display image and the
    reference's; a value that is not finite on either side is infinite."""
    import torch

    d = (out.float() - ref.float()).abs()
    if not bool(torch.isfinite(d).all()):
        return math.inf
    return float(d.max())


def check(cfg: dict, config: str, mosaics: list, kept: list, roll_n: int,
          hists=None, device: str = "cuda") -> list:
    """The gap of each kept output from the reference on its mosaic and
    history, both on `device`; the reference is run once per distinct
    image."""
    from rawbench import reference

    h, w = cfg["frame"]["height"], cfg["frame"]["width"]
    by_image = {}
    for n, out in kept:
        by_image.setdefault(n % roll_n, []).append(out)
    gaps = []
    for k, outs in sorted(by_image.items()):
        cfg_k = cfg if hists is None else dict(cfg, history=hists[k])
        ref = reference.run(config, cfg_k, mosaics[k].to(device))
        gaps += [max_gap(out.to(device)[:, :h, :w], ref) for out in outs]
        del ref
    return gaps


def keep_times(seed: int, n: int, seconds: float) -> list:
    rng = np.random.default_rng([seed % 2**64, 0x636865636B])
    return sorted(rng.uniform(0.0, seconds, size=n).tolist())


class Exporter:
    """The program and the roll as the mix hands it over: `submit(n)`
    calls the program on image n (its mosaic and history, cycling
    through the roll), `done` and `wait` tell when its output is ready."""

    def __init__(self, cfg: dict, pipe, mosaics: list, mix: dict,
                 hists=None, device: str = "cuda"):
        import torch

        self.pipe, self.mix, self.hists = pipe, mix, hists
        self.device, self.meta = device, raw_meta(cfg)
        self.cuda = device == "cuda"
        if mix["source"] == "host":
            mosaics = [m.cpu().pin_memory() if self.cuda else m.cpu()
                       for m in mosaics]
        self.mosaics = mosaics
        self.torch = torch

    def submit(self, n: int):
        k = n % len(self.mosaics)
        raw = self.mosaics[k]
        if self.mix["source"] == "host":
            raw = raw.to(self.device, non_blocking=True)
        pipe = self.pipe if self.hists is None \
            else plan(self.meta, self.hists[k], self.device)
        out = pipe.run_padded(raw)
        if self.mix["sink"] == "host":
            host = self.torch.empty(out.shape, dtype=out.dtype,
                                    pin_memory=self.cuda)
            host.copy_(out, non_blocking=True)
            out = host
        if not self.cuda:
            return out, None
        ready = self.torch.cuda.Event()
        ready.record()
        return out, ready

    @staticmethod
    def done(ready) -> bool:
        return ready is None or ready.query()

    @staticmethod
    def wait(ready):
        if ready is not None:
            ready.synchronize()

    def drive(self, **kw):
        return loadgen.drive(self.mix, self.submit, self.wait, self.done,
                             **kw)


def warmup_images(mix: dict) -> int:
    """Images that warm up every shape and plan a cell's window uses: a
    full queue and one more, and each of the roll's histories."""
    depth = int(mix["in_flight"] if mix["arrivals"] == "closed"
                else mix["set_size"])
    return max(depth + 1, int(mix["roll_images"]) if mix["edits"] else 0)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float = None, bench: dict = None,
             cfg: dict = None, mix: dict = None, log=None) -> dict:
    """One run of a cell -> the result line's object.  `cfg` and `mix`
    replace the configuration's and the traffic's files (the CPU tests
    run a small frame); `log` takes the lines for standard error."""
    t0 = time.perf_counter() if t0 is None else t0
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    parts = {}
    mark = [t0]

    def part(name):
        now = time.perf_counter()
        parts[name] = now - mark[0]
        mark[0] = now

    import torch

    import ansel_tpu_torch  # noqa: F401  (the program's import time)
    from rawbench import scene
    from rawbench import trace as tracemod

    part("imports")
    bench = bench or load_bench()
    cell, centry = cell_of(bench, workload)
    cfg = cfg or load_config(centry)
    mix = loadgen.checked(mix, "given") if mix is not None \
        else loadgen.load(cell["traffic"])
    roll_n = int(mix["roll_images"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device == "cuda":
        torch.zeros(1, device=device)
        torch.cuda.synchronize()
    part("cuda_context")
    if device == "cuda":
        from ansel_tpu_torch.kernels import _build

        _build.build_all()
    part("kernels")
    pipe = build_pipe(cfg, device)
    hists = histories(cfg, mix, seed)
    part("plan")
    mosaics = scene.roll(cfg, seed, roll_n, device)
    if device == "cuda":
        torch.cuda.synchronize()
    part("inputs")
    drv = Exporter(cfg, pipe, mosaics, mix, hists, device)
    mosaics = drv.mosaics
    drv.drive(max_images=warmup_images(mix))
    part("warmup")
    setup_s = time.perf_counter() - t0

    roll = drv.drive(seconds=seconds, keep_at=keep_times(
        seed, int(cfg["check_images"]), seconds))
    if not roll.completed:
        raise RuntimeError(f"{workload}: no image completed in the "
                           f"{seconds} s window")
    readings = Readings(cfg=cfg, pixels=cfg["frame"]["height"]
                        * cfg["frame"]["width"], roll=roll)
    result_device = {"platform": "gpu" if device == "cuda" else device,
                     "kind": (torch.cuda.get_device_name(0)
                              if device == "cuda" else device),
                     "count": 1}
    breakdown = None
    if trace and device == "cuda":
        from torch.profiler import ProfilerActivity, profile, \
            record_function

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            troll = drv.drive(seconds=TRACE_SECONDS, span=lambda label:
                              record_function(f"rawbench.{label}"))
        readings.window = tracemod.from_profile(prof, troll.submitted)
        del prof
        readings.steps = step_times(pipe, mosaics[0].to(device))
        result_device["busy_s"] = readings.window.busy_s()
        result_device["window_s"] = readings.window.window_s
        breakdown = {"device_ops": readings.window.top_ops(),
                     "idle_gaps": [[k, v] for k, v in
                                   readings.window.idle_gaps()[:10]]}
    if device == "cuda":
        torch.cuda.synchronize()
        result_device["memory_peak_bytes"] = \
            int(torch.cuda.max_memory_allocated())
    else:
        result_device["memory_peak_bytes"] = 0

    metrics = {}
    if trace:
        for m in bench["per_layer"]:
            if workload not in m.get("workloads", [workload]):
                continue
            value = load_reader(m["name"])(readings)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        e2e = {"img_per_s": lambda: roll.completed / roll.window_s,
               "image_p95_ms": lambda: 1e3 * float(
                   np.percentile(roll.latencies, 95)),
               "setup_s": lambda: setup_s}
        for m in bench["end_to_end"]:
            if workload in m.get("workloads", [workload]):
                metrics[m["name"]] = {"value": float(e2e[m["name"]]()),
                                      "unit": m["unit"]}

    # the check, once the window has closed and the peak has been read:
    # the program's pipe is let go, its kept outputs judged
    del drv, pipe
    t_check = time.perf_counter()
    gaps = check(cfg, centry["name"], mosaics, roll.kept, roll_n, hists,
                 device)
    t_check = time.perf_counter() - t_check
    gap = max(gaps, default=math.inf)
    limit = cfg["limits"].get("max_gap")
    failed = sum(1 for g in gaps if not math.isfinite(g))
    correct = limit is not None and gap <= limit

    card = card_name() if device == "cuda" else "cpu"
    log(f"[card] {card} | {workload} seed {seed}: {roll.submitted} images "
        f"submitted, {roll.completed} completed in {roll.window_s:.1f} s")
    log("[setup] " + ", ".join(f"{k} {v:.3f} s" for k, v in parts.items())
        + f"; setup_s {setup_s:.3f}")
    if readings.steps:
        log("[steps] " + "; ".join(f"{'+'.join(n)} {1e3 * t:.3f} ms"
                                   for n, t in readings.steps))
    log(f"[check] {len(roll.kept)} outputs against the reference in "
        f"{t_check:.2f} s")
    result = {"correct": bool(correct), "attempted": roll.submitted,
              "failed": failed, "metrics": metrics,
              "device": result_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["card"] = card
    # JSON has no infinity: a gap that is not finite reads 1e30
    result["check"] = {"max_gap": {"value": gap if math.isfinite(gap)
                                   else 1e30, "limit": limit}}
    return result
