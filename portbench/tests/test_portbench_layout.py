"""BENCHMARK.json resolves to its files and keeps to the benchmark's
contract; no module of the benchmark imports JAX or the JAX package; a
new cell, configuration or metric is found by its name alone."""

import ast
import json
import re
import shutil
import subprocess
import sys
import time

import pytest

from portbench import harness

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert (ROOT / BENCH["command"][1]).is_file()


def test_entries_resolve_to_their_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"]
        assert conf["reduced"] == c["reduced"]
        assert conf["dtype"] == "float64"
        assert len(conf["source"]) <= 200
        assert "assumed" in conf
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(configs)
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert callable(harness.load_module(
            "generators", cell.config["generator"]).make)
        entry = harness.load_module("entries", cell.traffic["entry"])
        assert callable(entry.call) and callable(entry.indices)
        assert callable(harness.load_module(
            "loops", cell.traffic.get("loop", "closed")).drive)
        assert w["chips"] == 1
    for m in BENCH["per_layer"]:
        assert callable(harness.load_reader(m["name"]).read)


def test_every_data_file_and_module_is_named_by_the_benchmark():
    """Nothing under the benchmark's folders of configurations, traffic,
    generators, entries, loops and readers lies there unused."""
    named = {ROOT / c["file"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"])
        named |= {
            ROOT / "portbench/traffic" / f"{w['traffic']}.json",
            ROOT / "portbench/generators" / f"{cell.config['generator']}.py",
            ROOT / "portbench/entries" / f"{cell.traffic['entry']}.py",
            ROOT / "portbench/loops" / f"{cell.traffic.get('loop', 'closed')}.py"}
    named |= {ROOT / "portbench/metrics" / f"{m['name']}.py"
              for m in BENCH["per_layer"]}
    for kind in ("configs", "traffic", "generators", "entries", "loops",
                 "metrics"):
        for path in (ROOT / "portbench" / kind).iterdir():
            if path.name != "__pycache__":
                assert path in named, f"{path} is named by no entry"


def test_names_units_and_lines_keep_to_the_contract():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            for key in ("why", "layer", "source"):
                if key in entry and group != "end_to_end":
                    text = entry[key]
                    assert 1 <= len(text) <= 200 and "\n" not in text
                    assert "\t" not in text
    for group in ("configs", "workloads"):
        assert len({n for g, n in names if g == group}) == len(BENCH[group])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    cells = {w["name"] for w in BENCH["workloads"]}
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(cells)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
    for cell in cells:
        got = {m["name"] for m in BENCH["end_to_end"]
               if harness.applies(m, cell)}
        assert "setup_s" in got and len(got) >= 2
        assert any(harness.applies(m, cell) for m in BENCH["per_layer"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    sources = sorted((ROOT / "portbench").rglob("*.py"))
    assert sources
    for path in sources:
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)
    # The port's own name begins with the JAX package's: names are
    # compared whole.
    assert "repro_torch".split(".")[0] not in FORBIDDEN


# New files of a later PR: a generator, an entry that returns eigenvalues
# at indices that are not contiguous, a loop, a metric reader.
NEW_GENERATOR = """
import numpy as np


def make(n, rng, params):
    d = np.full(n, params["a"] + rng.uniform(-1, 1))
    return d, np.full(n - 1, params["b"])
"""
NEW_ENTRY = """
import numpy as np
import torch


def call(work, i):
    p, k, n = i % work.pool, work.k, work.n
    f = work.core.eigvalsh_tridiagonal_range
    lo = f(work.d[p, 0], work.e[p, 0], il=0, iu=k - 1, device=work.device,
           **work.knobs)
    hi = f(work.d[p, 0], work.e[p, 0], il=n - k, iu=n - 1,
           device=work.device, **work.knobs)
    return torch.cat([lo, hi])


def indices(work, i):
    return np.r_[0:work.k, work.n - work.k:work.n][None]
"""
NEW_LOOP = """
import time


def drive(work, deadline, record):
    for i in range(work.traffic["calls"]):
        t0 = time.perf_counter()
        with record.span():
            out = work.call(i)
            work.sync()
        record.done(i, out, t0)
"""


def _new_files(root):
    """A checkout at ``root`` with the benchmark and the files and entries
    that a later PR adds for a new configuration, generator, entry, loop,
    two traffic mixes (one with knobs) and a metric: nothing else."""
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("tune_cache"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = root / "portbench"
    (pb / "generators/toeplitz.py").write_text(NEW_GENERATOR)
    (pb / "entries/ends.py").write_text(NEW_ENTRY)
    (pb / "loops/counted.py").write_text(NEW_LOOP)
    (pb / "configs/toeplitz.json").write_text(json.dumps(
        {"name": "toeplitz", "generator": "toeplitz", "dtype": "float64",
         "params": {"a": 0.5, "b": 0.25},
         "guarantee": {"error_eps_tinf": 64}, "reduced": []}))
    (pb / "traffic/ends4.json").write_text(json.dumps(
        {"entry": "ends", "loop": "counted", "calls": 3, "n": 48, "k": 4,
         "pool": 2, "knobs": {"polish": 3},
         "check": {"calls": 2, "graded": 8}}))
    (pb / "traffic/bisect8.json").write_text(json.dumps(
        {"entry": "batch", "n": 64, "batch": 8, "pool": 2,
         "knobs": {"method": "bisect"}, "check": {"calls": 1, "graded": 4}}))
    (pb / "metrics/calls_per_problem.py").write_text(
        "def read(window):\n    return window.calls / window.problems\n")
    bench["configs"].append({"name": "toeplitz", "source": "test",
                             "file": "portbench/configs/toeplitz.json",
                             "reduced": [], "why": "test"})
    bench["workloads"] += [
        {"name": "toeplitz.ends4", "config": "toeplitz", "traffic": "ends4",
         "chips": 1, "why": "test"},
        {"name": "uniform.bisect8", "config": "uniform",
         "traffic": "bisect8", "chips": 1, "why": "test"}]
    bench["per_layer"].append({"name": "calls_per_problem", "unit": "1",
                               "better": "lower", "source":
                               "program_counter", "layer": "front door",
                               "moves": "problems_per_s",
                               "workloads": ["uniform.bisect8"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def _recording(monkeypatch, name):
    """Record the keyword arguments of the program's entry point ``name``
    as the harness calls it."""
    from repro_torch import core
    seen, entry = [], getattr(core, name)

    def wrapped(*args, **kwargs):
        seen.append(kwargs)
        return entry(*args, **kwargs)
    monkeypatch.setattr(core, name, wrapped)
    return seen


def test_harness_finds_a_new_cell_configuration_and_metric_by_name(
        tmp_path):
    _new_files(tmp_path)
    cell = harness.load_cell("uniform.bisect8", root=tmp_path)
    assert cell.traffic["n"] == 64
    assert [m["name"] for m in cell.per_layer] == ["calls_per_problem"]
    reader = harness.load_reader("calls_per_problem", root=tmp_path)
    assert reader.read(type("W", (), {"calls": 3, "problems": 24})) == 0.125
    with pytest.raises(harness.HarnessError):
        harness.load_cell("no.such.cell", root=tmp_path)
    with pytest.raises(harness.HarnessError):
        harness.load_module("entries", "no_such_entry", root=tmp_path)


def test_a_new_cell_runs_from_new_files_alone(tmp_path, monkeypatch):
    """A configuration with a new generator, a traffic mix with a new
    entry, a new loop and knobs: a whole run on the program's CPU path,
    judged by the reference at the indices the entry names."""
    _new_files(tmp_path)
    seen = _recording(monkeypatch, "eigvalsh_tridiagonal_range")
    cell = harness.load_cell("toeplitz.ends4", root=tmp_path)
    res = harness.run_cell(cell, 2**31 + 5, 5.0, False, time.perf_counter(),
                           device="cpu", log=lambda msg: None)
    assert res["correct"], res["checks"]
    assert res["attempted"] == 3            # the loop's own count
    assert seen and all(kw["polish"] == 3 for kw in seen)


def test_traffic_knobs_reach_the_entry_point_under_the_callers(
        tmp_path, monkeypatch):
    _new_files(tmp_path)
    seen = _recording(monkeypatch, "eigvalsh_tridiagonal")
    cell = harness.load_cell("uniform.bisect8", root=tmp_path)
    res = harness.run_cell(cell, 9, 0.2, False, time.perf_counter(),
                           device="cpu", log=lambda msg: None)
    assert res["correct"], res["checks"]
    assert seen and all(kw["method"] == "bisect" for kw in seen)
    seen.clear()
    import torch
    res = harness.run_cell(cell, 9, 0.2, False, time.perf_counter(),
                           device="cpu", knobs={"dtype": torch.float32},
                           log=lambda msg: None)
    assert all(kw["method"] == "bisect" and kw["dtype"] == torch.float32
               for kw in seen)
    assert not res["correct"]


def test_run_refuses_without_a_card_and_prints_no_result(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the refusal runs where none is")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "portbench/run.py"), "--workload",
         BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA card" in proc.stderr


def test_run_fails_in_a_checkout_without_the_program(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("tune_cache"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=tmp_path)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
