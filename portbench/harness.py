"""The benchmark harness: resolve a cell from ``BENCHMARK.json``, make its
inputs from the seed, warm up, measure a closed-loop window, read the
per-layer metrics of a traced window, and judge what the window returned
against the plain reference.

A cell (an entry of ``workloads``) names a configuration, whose file
(``configs``' ``file``) names its generator, ``generators/<name>.py``,
and gives its parameters, and a traffic mix, ``traffic/<name>.json``,
which names its entry, ``entries/<entry>.py`` (the call the window makes
and the index of each eigenvalue it returns), and its loop,
``loops/<loop>.py`` (how the calls are issued), and gives the sizes, the
keyword arguments (``knobs``) the entry point takes, the pool of
distinct inputs the window cycles through and how much of the window's
output is checked.  A per-layer metric is the module
``metrics/<name>.py`` and its ``read(window)``.  A new cell,
configuration, generator, entry, loop or metric is a new file and a new
entry; every module is found by its name.

Only this module and the metric readers import the program
(``repro_torch``), and only its public entry points, its counters and
its kernels' names.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


class HarnessError(RuntimeError):
    """A run that cannot give a result (no card, a plan built inside the
    window, a forbidden module loaded); no result line is printed."""


# ---------------------------------------------------------------- cells

@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list        # BENCHMARK.json entries reported by this cell
    per_layer: list
    root: Path = ROOT       # the checkout whose modules the cell loads


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of the BENCHMARK.json of the checkout ``root``,
    with its configuration and traffic files read."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise HarnessError(f"no workload {name!r} in BENCHMARK.json "
                           f"(it has {sorted(work)})")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / HERE.relative_to(ROOT) / "traffic"
                          / f"{w['traffic']}.json").read_text())
    return Cell(name, int(w["chips"]), config, traffic,
                [m for m in bench["end_to_end"] if applies(m, name)],
                [m for m in bench["per_layer"] if applies(m, name)], root)


def load_module(kind: str, name: str, root: Path = ROOT):
    """The module ``<kind>/<name>.py`` of the benchmark's folder in the
    checkout ``root``: a generator, an entry, a loop or a metric reader."""
    path = root / HERE.relative_to(ROOT) / kind / f"{name}.py"
    if not path.is_file():
        raise HarnessError(f"no {kind} module {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str, root: Path = ROOT):
    """The metric reader ``metrics/<name>.py`` of the checkout ``root``."""
    return load_module("metrics", name, root)


# -------------------------------------------------------------- workload

class Workload:
    """The inputs of a cell on the device and the call the window makes.

    Pool entry p holds ``batch`` (default 1) problems of size n, made by
    the configuration's generator; call i of the entry module
    (``traffic["entry"]``) solves pool entry i % pool.  ``knobs`` are the
    traffic's ``knobs`` with the caller's over them (the control passes
    the program's float32 path here); the entry passes them to the entry
    point as they are.
    """

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 knobs: dict | None = None, root: Path = ROOT):
        import torch
        from repro_torch import core
        from portbench.inputs import make_problems
        self.core = core
        self.traffic = traffic
        self.seed = seed
        self.entry = load_module("entries", traffic["entry"], root)
        self.n = int(traffic["n"])
        self.pool = int(traffic["pool"])
        self.per_call = int(traffic.get("batch", 1))
        self.k = int(traffic.get("k", self.n))
        self.device = device
        self.knobs = {**traffic.get("knobs", {}), **(knobs or {})}
        generator = load_module("generators", config["generator"], root)
        d, e = make_problems(generator, config["params"], self.n,
                             self.pool * self.per_call, seed)
        self.d_host = d.reshape(self.pool, self.per_call, self.n)
        self.e_host = e.reshape(self.pool, self.per_call, self.n - 1)
        self.d = torch.as_tensor(self.d_host, device=device)
        self.e = torch.as_tensor(self.e_host, device=device)
        if hasattr(self.entry, "prepare"):
            self.entry.prepare(self)

    def call(self, i: int):
        """Call i through the entry point; returns its eigenvalues, one
        row a problem of pool entry i % pool (or one row, unstacked)."""
        return self.entry.call(self, i)

    def indices(self, i: int) -> np.ndarray:
        """The index (0-based, ascending) of each eigenvalue call i
        returns: (problems a call, eigenvalues a problem)."""
        return np.asarray(self.entry.indices(self, i))

    def sync(self) -> None:
        sync(self.device)

    def free(self) -> None:
        del self.d, self.e


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# ----------------------------------------------------------------- stats

def p95_nearest_rank(values) -> float:
    """The 95th percentile by nearest rank: the ceil(0.95 N)-th smallest."""
    s = sorted(values)
    if not s:
        raise ValueError("no samples")
    rank = max(1, math.ceil(0.95 * len(s)))
    return s[rank - 1]


def rate(done: int, seconds: float) -> float:
    return done / seconds


class Reservoir:
    """A uniform sample of ``size`` of the window's returned calls,
    drawn from the seed whatever their number (Algorithm R):
    ``offer(i, take)`` keeps call i's output, ``take()``, in place of a
    kept one when the draw says so."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng(np.random.SeedSequence([seed, 2]))
        self.kept: dict = {}
        self.seen = 0

    def offer(self, i: int, take) -> None:
        seen, self.seen = self.seen, self.seen + 1
        if seen < self.size:
            self.kept[i] = take()
            return
        j = int(self.rng.integers(0, seen + 1))
        if j < self.size:
            victim = sorted(self.kept)[j]
            del self.kept[victim]
            self.kept[i] = take()


# ---------------------------------------------------------------- window

@dataclasses.dataclass
class Window:
    """What a measured window did, and what the metric readers read."""
    calls: int
    failed_calls: int
    problems: int           # problems whose eigenvalues were returned
    attempted: int
    seconds: float
    latencies: list         # seconds of every call
    kept: dict              # call index -> output on the host
    peak_bytes: int
    workload: Workload
    trace: object = None    # devtrace.DeviceTrace of a traced window
    thread: int = 0         # the Kineto thread of the calls

    def calls_by_pool(self) -> dict:
        out: dict = {}
        for i in range(self.calls):
            p = i % self.workload.pool
            out[p] = out.get(p, 0) + 1
        return out


def plan_counts() -> tuple:
    from repro_torch.core import plan_cache_stats
    s = plan_cache_stats()
    return (s["misses"], s["range_misses"], s["executor_traces"],
            s["range_executor_traces"])


class Recorder:
    """What a loop reports as its calls end: ``done(i, out, t0)`` for a
    call that returned (its latency runs from t0, on perf_counter, to
    now, its output is offered to the reservoir), ``failed(i, exc, t0)``
    for one that raised; ``span()`` wraps a call in the traced window."""

    def __init__(self, work: Workload, reservoir: Reservoir, trace: bool):
        import torch
        self.work = work
        self.reservoir = reservoir
        self.latencies: list = []
        self.problems = 0
        self.failures = 0
        self.span = (functools.partial(torch.profiler.record_function,
                                       "portbench.call")
                     if trace else contextlib.nullcontext)

    def done(self, i: int, out, t0: float) -> None:
        self.latencies.append(time.perf_counter() - t0)
        self.problems += self.work.per_call
        self.reservoir.offer(i, lambda: out.detach().to("cpu"))

    def failed(self, i: int, exc: Exception, t0: float) -> None:
        self.latencies.append(time.perf_counter() - t0)
        self.failures += 1
        print(f"[portbench] call {i} raised {type(exc).__name__}: {exc}",
              file=sys.stderr)


def measure(work: Workload, seconds: float, seed: int, check_calls: int,
            trace: bool, loop) -> Window:
    """Drive the loop module ``loop`` for ``seconds``, every call through
    the workload, and gather what the window did."""
    import torch
    cuda = torch.device(work.device).type == "cuda"
    record = Recorder(work, Reservoir(check_calls, seed), trace)
    plans = plan_counts()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=acts)
        prof.__enter__()
    t0_ns = time.time_ns()
    start = time.perf_counter()
    loop.drive(work, start + seconds, record)
    end = time.perf_counter()
    t1_ns = time.time_ns()
    calls = len(record.latencies)
    window = Window(calls=calls, failed_calls=record.failures,
                    problems=record.problems,
                    attempted=calls * work.per_call, seconds=end - start,
                    latencies=record.latencies, kept=record.reservoir.kept,
                    peak_bytes=(torch.cuda.max_memory_allocated()
                                if cuda else 0),
                    workload=work)
    if prof is not None:
        from portbench import devtrace
        t_read = time.perf_counter()
        prof.__exit__(None, None, None)
        window.trace = devtrace.from_profiler(prof, t0_ns, t1_ns)
        print(f"[portbench] trace stopped and read in "
              f"{time.perf_counter() - t_read:.1f} s", file=sys.stderr)
        window.thread = next((ev.thread for ev in window.trace.host
                              if ev.name == "portbench.call"), 0)
    if plan_counts() != plans:
        raise HarnessError("a plan was built inside the measured window "
                           f"(misses and traces {plans} -> "
                           f"{plan_counts()}): the warm-up missed a shape")
    return window


# ----------------------------------------------------------------- check

def check(window: Window, traffic: dict, limit: float, seed: int,
          device) -> dict:
    """Judge the sampled calls' outputs with the plain reference: every
    returned eigenvalue of a kept call against ``limit``, and
    ``check["graded"]`` positions of each of its problems graded."""
    import torch
    from portbench import reference
    work = window.workload
    spec = traffic["check"]
    rng = np.random.default_rng(np.random.SeedSequence([seed, 3]))
    ds, es, lams, index, graded = [], [], [], [], []
    for i, out in sorted(window.kept.items()):
        p = i % work.pool
        lam = out.to(torch.float64).numpy()
        want = work.indices(i)
        if lam.size != want.size:               # every value counts missed
            return {"err_eps": reference.BEYOND, "graded": 0,
                    "missed": len(window.kept) * want.size,
                    "checked": len(window.kept) * want.size}
        lam = lam.reshape(want.shape)
        ds.append(work.d_host[p])
        es.append(work.e_host[p])
        lams.append(lam)
        index.append(want)
        graded.append(np.stack([
            reference.graded_positions(lam.shape[1], int(spec["graded"]),
                                       rng)
            for _ in range(work.per_call)]))
    if not lams:                        # no call returned: nothing to judge
        return {"err_eps": reference.BEYOND, "missed": 0, "checked": 0,
                "graded": 0}
    return reference.certify(np.concatenate(ds), np.concatenate(es),
                             np.concatenate(lams), np.concatenate(index),
                             np.concatenate(graded), limit, device)


# ------------------------------------------------------------------- run

def device_line() -> str:
    """The card's name, power limit and clocks, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,clocks.mem,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi not read ({exc})"


def forbidden_loaded() -> list:
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             t_start: float, device="cuda", knobs: dict | None = None,
             log=None) -> dict:
    """Set up, measure and judge one run; returns the result object."""
    import torch
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    seed = int(seed) % (1 << 64)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    traffic = cell.traffic
    work = Workload(cell.config, traffic, seed, device, knobs, cell.root)
    loop = load_module("loops", traffic.get("loop", "closed"), cell.root)
    for i in range(int(traffic.get("warmup_calls", work.pool))):
        work.call(i)
    sync(device)
    setup_s = time.perf_counter() - t_start
    window = measure(work, seconds, seed, int(traffic["check"]["calls"]),
                     trace, loop)
    bad = forbidden_loaded()
    if bad:
        raise HarnessError(f"modules {bad} are loaded after the window")
    cuda = torch.device(device).type == "cuda"
    result = {"correct": False, "attempted": window.attempted,
              "failed": window.attempted - window.problems, "metrics": {},
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": (torch.cuda.get_device_name()
                                  if cuda else "cpu"),
                         "count": 1,
                         "memory_peak_bytes": int(window.peak_bytes)}}
    log(f"[portbench] {cell.name}: {window.calls} calls, "
        f"{window.problems} problems in {window.seconds:.3f} s "
        f"(calls a quarter of the window: {quarters(window)}); peak "
        f"{window.peak_bytes / 2**20:.1f} MiB; {model_line(work)}")
    if trace:
        tr = window.trace
        log(f"[portbench] trace: {tr.counts()} events in "
            f"{tr.window_s:.3f} s; device busy {tr.busy_s:.4f} s")
        result["metrics"] = read_per_layer(cell, window, log)
        result["device"]["busy_s"] = tr.busy_s
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_device_ops(),
                               "idle_gaps": tr.idle_gaps(window.thread)}
    else:
        values = {
            "problems_per_s": rate(window.problems, window.seconds),
            "call_p95_ms": (p95_nearest_rank(window.latencies) * 1e3
                            if window.latencies else None),
            "peak_mem_mib": window.peak_bytes / 2**20,
            "setup_s": setup_s,
        }
        for m in cell.end_to_end:
            if values.get(m["name"]) is not None:
                result["metrics"][m["name"]] = {"value": values[m["name"]],
                                                "unit": m["unit"]}
    work.free()
    window.trace = None
    if cuda:
        torch.cuda.empty_cache()
    limit = float(cell.config["guarantee"]["error_eps_tinf"])
    verdict = check(window, traffic, limit, seed, device)
    checks = {
        "err_eps": {"value": verdict["err_eps"], "limit": limit},
        "missed": {"value": verdict["missed"], "limit": 0},
        "failed_calls": {"value": window.failed_calls, "limit": 0},
    }
    result["correct"] = bool(
        verdict["checked"] > 0 and verdict["err_eps"] <= limit
        and verdict["missed"] == 0 and window.failed_calls == 0)
    log(f"[portbench] checked {verdict['checked']} eigenvalues of "
        f"{len(window.kept)} calls, graded {verdict['graded']}")
    result["checks"] = checks
    return result


def quarters(window: Window) -> list:
    """Calls that started in each quarter of the window: a rate that
    drifts within a run shows here."""
    out, t = [0, 0, 0, 0], 0.0
    for lat in window.latencies:
        out[min(3, int(4 * t / window.seconds))] += 1
        t += lat
    return out


def model_line(work: Workload) -> str:
    """The program's own model of the call's device memory, printed
    beside the measured peak, where the entry module gives one."""
    model = getattr(work.entry, "model", None)
    return model(work) if model else "no workspace model"


def read_per_layer(cell: Cell, window: Window, log) -> dict:
    out = {}
    for m in cell.per_layer:
        value = load_reader(m["name"]).read(window)
        if value is None:
            log(f"[portbench] {m['name']}: nothing to read")
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def check_lines(checks: dict) -> list:
    """Each number compared beside its limit, one line each."""
    from portbench import reference
    lines = []
    for name, c in checks.items():
        value = (reference.limit_reading(c["value"]) if name == "err_eps"
                 else c["value"])
        lines.append(f"check {name} {value} limit {c['limit']}")
    return lines
