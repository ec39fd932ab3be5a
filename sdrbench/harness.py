"""The benchmark's run of one cell, driven by the files that name it.

``BENCHMARK.json`` names a cell's configuration and traffic.  Everything
that belongs to one of them is a file found by its name:

- ``configs/<config>.json``: the deployment, with the ``system`` that
  builds the program (``systems/<system>.py``), the ``reference`` that
  judges it (``reference/<reference>.py``), the ``capture`` kind
  (``captures/<kind>.py``) and the ``limits`` of the comparison;
- ``traffic/<traffic>.json``: how blocks reach the program (see
  `TRAFFIC_KINDS`);
- ``metrics/<metric>.py``: one reader a metric, ``read(run)``, which
  returns a number or None when there is nothing to read; a metric
  ``<name>.<part>`` with no file of its own is read by ``<name>.py``.

`run_cell` makes the capture on the device from the seed and stages it
in pinned host memory, warms up the cell's own shapes, drives the
program for the window, reads the metrics and checks a sample of the
window's blocks, drawn from the seed, against the plain reference.  A
traced run drives the same untraced window first, for the host clock's
metrics, and then a window under the profiler, for the device trace's.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent

TRAFFIC_KINDS = ("closed_loop", "paced")


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell ``name``: its entry, configuration, traffic and metrics."""
    man = manifest(root)
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    wl = cells[name]
    entry = {c["name"]: c for c in man["configs"]}[wl["config"]]
    cfg = json.loads((root / entry["file"]).read_text())
    traffic = json.loads(
        (root / "sdrbench" / "traffic" / f"{wl['traffic']}.json").read_text())
    if traffic["kind"] not in TRAFFIC_KINDS:
        raise ValueError(f"unknown traffic kind {traffic['kind']!r}")
    e2e = [m for m in man["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in man["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in moved
                              else [])]
    return {"name": name, "root": root, "workload": wl, "config": cfg,
            "traffic": traffic, "end_to_end": e2e, "per_layer": layer}


def module(kind: str, name: str):
    """``sdrbench/<kind>/<name>.py`` (systems, reference, captures)."""
    return importlib.import_module(f"sdrbench.{kind}.{name}")


def reader(metric: str, root: Path = ROOT):
    """``metrics/<metric>.py``'s ``read``, else that of the file named by
    the part before the metric's first dot."""
    path = root / "sdrbench" / "metrics" / f"{metric}.py"
    if not path.exists():
        path = path.with_name(f"{metric.split('.')[0]}.py")
    spec = importlib.util.spec_from_file_location(
        f"sdrbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Run:
    """What a run recorded, for the metric readers.

    ``window_s``: the measured window on the host clock; ``blocks``: the
    blocks whose every output reached the host in it; ``latency_s``: per
    block, its completion less its due time (paced traffic);
    ``call_s``: per call, the host clock around the entry's call until
    it returns; ``handoff_s``: per call, from the hand-off (before the
    copy to the device) to the entry's return; ``counters``: the
    program's counters over the window; ``traced``: in a traced run, the
    record of the window under the profiler, whose ``trace`` is the
    reduced profile (`sdrbench.trace.Trace`), else None."""

    def __init__(self, cell: dict, system):
        self.traffic = cell["traffic"]
        self.system = system
        self.setup_s = None
        self.window_s = None
        self.blocks = 0
        self.block_len = system.block_len
        self.samplerate = system.samplerate
        self.latency_s: list[float] = []
        self.call_s: list[float] = []
        self.handoff_s: list[float] = []
        self.counters: dict = {}
        self.trace = None
        self.traced = None


class Sample:
    """Blocks of a stream of unknown length, drawn from the seed: block
    index -> its outputs.  A call's first block is the one its carried
    state feeds, and its last the one a short call leaves out, so the
    ``k`` blocks are drawn in equal shares from calls' first blocks, last
    blocks and the rest, each share a uniform sample (a reservoir)."""

    def __init__(self, k: int, seed: int, per_call: int):
        self.rng = np.random.default_rng([int(seed), 0x5EED])
        strata = ((0,) if per_call == 1 else (0, 1) if per_call == 2
                  else (0, 1, 2))
        self.quota = {c: k // len(strata) for c in strata}
        self.seen = dict.fromkeys(strata, 0)
        self.per_call = per_call
        self.held: dict[int, dict] = {c: {} for c in strata}

    @property
    def kept(self) -> dict[int, dict]:
        return {i: o for held in self.held.values() for i, o in held.items()}

    def offer(self, index: int, outputs: dict, i: int) -> None:
        """Offer block ``index``, row ``i`` of the call's host ``outputs``."""
        c = 0 if i == 0 else 1 if i == self.per_call - 1 else 2
        held, seen = self.held[c], self.seen[c]
        self.seen[c] += 1
        if len(held) >= self.quota[c]:
            r = int(self.rng.integers(0, seen + 1))
            if r >= self.quota[c]:
                return
            del held[sorted(held)[r]]
        held[index] = {n: t[i].clone() for n, t in outputs.items()}


def stage_capture(cell: dict, seed: int, device, k: int) -> tuple:
    """The capture, made on ``device`` from the seed, as ``(blocks, host)``:
    ``host`` (blocks + k, block_len) complex64, pinned on a card, with the
    first ``k`` blocks repeated at the end so that any ``k`` consecutive
    blocks of the loop are one contiguous copy."""
    cfg, traffic = cell["config"], cell["traffic"]
    block = int(cfg["block_len"])
    nb = round(float(traffic["capture_s"]) * float(cfg["samplerate"]) / block)
    cap = module("captures", cfg["capture"]["kind"]).make(
        cfg, nb * block, seed, device).reshape(nb, block)
    reps = -(-(nb + k) // nb)
    host = torch.empty((nb + k, block), dtype=torch.complex64,
                       pin_memory=torch.device(device).type == "cuda")
    host[:nb].copy_(cap)
    del cap
    host[nb:] = host[:nb].repeat(reps, 1)[:k]
    return nb, host


class Driver:
    """One stream through the program: hand-off, call, fetch."""

    def __init__(self, system, entry: str, k: int, device, host_in):
        self.system, self.entry, self.k = system, entry, k
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.host_in = host_in
        self.nb = host_in.shape[0] - k
        self.x = torch.empty((k, system.block_len), dtype=torch.complex64,
                             device=self.device)
        self.out = {n: torch.empty((k,) + tuple(s), dtype=torch.float32,
                                   pin_memory=self.cuda)
                    for n, s in system.outputs.items()}
        self.done = torch.cuda.Event() if self.cuda else None
        self.state = system.init_state()
        self.position = 0  # stream position of the next block

    def step(self, mark=None) -> tuple[float, float]:
        """Blocks ``position .. position + k`` through the entry, every
        output on the host when it returns.  Returns the host clock from
        the hand-off to the entry's return, and in the entry's call.
        ``mark(name)`` labels the phases for the profiler."""
        mark = mark or _no_mark
        h = time.perf_counter()
        j = self.position % self.nb
        with mark("sdrbench.h2d"):
            self.x.copy_(self.host_in[j:j + self.k], non_blocking=True)
        with mark("sdrbench.call"):
            c0 = time.perf_counter()
            self.state, out = self.system.call(self.entry, self.state,
                                               self.x)
            c1 = time.perf_counter()
        with mark("sdrbench.fetch"):
            for n, t in out.items():
                self.out[n].copy_(t, non_blocking=True)
        with mark("sdrbench.wait"):
            if self.cuda:
                self.done.record()
                self.done.synchronize()
        self.position += self.k
        return c1 - h, c1 - c0


def _no_mark(name):
    return contextlib.nullcontext()


def _wait_until(t: float) -> None:
    """Spin until host time ``t``.  The generator keeps its schedule to
    the microsecond and its CPU awake: a sleep's wake-up delay and the
    idle core's slower start spread the latency tail between runs (p95's
    spread 20 % sleeping, 8 % spinning, six runs each on one H100
    host)."""
    while time.perf_counter() < t:
        pass


def closed_loop(run: Run, drv: Driver, seconds: float, sample: Sample,
                mark=None) -> None:
    """Calls back to back until ``seconds`` have passed; the window ends
    when the last call's outputs are on the host."""
    t0 = time.perf_counter()
    while True:
        first = drv.position
        handoff, call = drv.step(mark)
        t = time.perf_counter()
        run.handoff_s.append(handoff)
        run.call_s.append(call)
        for i in range(drv.k):
            sample.offer(first + i, drv.out, i)
        run.blocks += drv.k
        if t - t0 >= seconds:
            break
    run.window_s = t - t0


def paced(run: Run, drv: Driver, seconds: float, sample: Sample,
          mark=None) -> None:
    """Blocks handed off as the radio would deliver them: block ``i`` of
    the window is due when its last sample arrives, ``t0 + (i+1) *
    block_len / samplerate``, for every block due within
    ``seconds``.  A block's latency runs from its due time until all its
    outputs are on the host; a late hand-off counts in it."""
    mark = mark or _no_mark
    period = drv.k * drv.system.block_len / drv.system.samplerate
    n = max(1, int(seconds / period + 1e-9))
    t0 = time.perf_counter()
    for i in range(n):
        due = t0 + (i + 1) * period
        with mark("sdrbench.pace"):
            _wait_until(due)
        first = drv.position
        handoff, call = drv.step(mark)
        done = time.perf_counter()
        run.handoff_s.append(handoff)
        run.call_s.append(call)
        run.latency_s.append(done - due)
        for j in range(drv.k):
            sample.offer(first + j, drv.out, j)
        run.blocks += drv.k
    run.window_s = done - t0


LOOPS = {"closed_loop": closed_loop, "paced": paced}


def measure(cell: dict, seed: int, seconds: float, trace: bool, device,
            t_start: float, system=None) -> tuple[Run, Sample, int, object]:
    """Set-up, warm-up and the window.  Returns the run, the sampled
    blocks, the capture's length in blocks and its host copy."""
    cfg, traffic = cell["config"], cell["traffic"]
    entry, k = traffic["entry"], int(traffic["blocks_per_call"])
    if system is None:
        system = module("systems", cfg["system"]).System(cfg, device)
    run = Run(cell, system)
    nb, host = stage_capture(cell, seed, device, k)
    drv = Driver(system, entry, k, device, host)
    for _ in range(int(traffic["warmup_calls"])):
        drv.step()
    if drv.cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    sample = Sample(int(traffic["check_blocks"]), seed, k)
    gc.collect()
    gc.freeze()
    loop = LOOPS[traffic["kind"]]
    run.setup_s = time.perf_counter() - t_start
    _window(run, lambda: loop(run, drv, seconds, sample))
    if trace:
        from . import trace as tracing

        tr = run.traced = Run(cell, system)
        window = min(seconds, float(traffic.get("trace_s", seconds)))
        _window(tr, lambda: setattr(tr, "trace", tracing.traced(
            lambda mark: loop(tr, drv, window, sample, mark))))
    gc.unfreeze()
    run.memory_peak_bytes = (torch.cuda.max_memory_allocated()
                             if drv.cuda else 0)
    return run, sample, nb, host


def _window(run: Run, drive) -> None:
    """``drive()`` the window, recording the program's counters over it."""
    before = run.system.counters()
    drive()
    after = run.system.counters()
    run.counters = {n: (after[n] - before[n]
                        if after.get(n) is not None
                        and before.get(n) is not None else None)
                    for n in after}


def check(cell: dict, sample: Sample, nb: int, host, device,
          control: str | None = None) -> dict:
    """Each sampled block against the plain reference, run from rest over
    the block and the ``warm_blocks`` before it (the looped capture's
    blocks at those stream positions): ``{number: {"value", "limit"}}``
    and whether every number is within its limit.  With ``control`` (a
    precision of the reference's), the reference computed in it stands
    in the program's place on the same blocks."""
    cfg, traffic = cell["config"], cell["traffic"]
    ref = module("reference", cfg["reference"])
    warm = int(traffic.get("warm_blocks", 1))
    worst: dict[str, float] = {}
    for index in sorted(sample.kept):
        got = sample.kept[index]
        lo = max(0, index - warm)
        rows = [(p % nb) for p in range(lo, index + 1)]
        blocks = host[rows].to(device)
        want = ref.run(cfg, blocks)
        if control is None:
            got = {n: t[None] for n, t in got.items()}
        else:
            got = {n: t[-1:] for n, t in ref.run(cfg, blocks,
                                                 control).items()}
        gaps = ref.gaps(cfg, got, {n: t[-1:] for n, t in want.items()})
        for name, value in gaps.items():
            worst[name] = max(worst.get(name, 0.0), float(value))
    limits = cfg["limits"]
    numbers = {n: {"value": v, "limit": limits.get(n)}
               for n, v in worst.items()}
    ok = bool(sample.kept) and all(
        d["limit"] is not None and d["value"] <= d["limit"]
        for d in numbers.values())
    return {"correct": ok, "numbers": numbers, "blocks": sorted(sample.kept)}


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float, log=None) -> dict:
    """One run of ``cell``: the result line's object, the numbers compared
    last (``checks``)."""
    log = log or (lambda *a: None)
    run, sample, nb, host = measure(cell, seed, seconds, trace, device,
                                    t_start)
    specs = cell["per_layer"] if trace else cell["end_to_end"]
    metrics = {}
    for m in specs:
        value = reader(m["name"], cell["root"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(run.memory_peak_bytes)}
    windows = [run] + ([run.traced] if run.traced else [])
    out = {"correct": False, "attempted": sum(w.blocks for w in windows),
           "failed": 0, "metrics": metrics, "device": dev}
    if run.traced is not None:
        t = run.traced.trace
        dev["busy_s"] = t.busy_s
        dev["window_s"] = t.window_s
        out["breakdown"] = {"device_ops": t.device_ops(),
                            "idle_gaps": t.idle_gaps()}
    for w in windows:
        log(f"window {w.window_s} s, {w.blocks} blocks, counters "
            f"{w.counters}" + (" (traced)" if w.trace else ""))
    # the program's state is freed before the reference runs on the card
    for w in windows:
        w.system = w.trace = None
    run.traced = None
    del run
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    verdict = check(cell, sample, nb, host, device)
    out["correct"] = verdict["correct"]
    out["failed"] = 0 if verdict["correct"] else len(verdict["blocks"])
    out["checks"] = verdict["numbers"]
    log(f"checked blocks {verdict['blocks']}")
    return out
