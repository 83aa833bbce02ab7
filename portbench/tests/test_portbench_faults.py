"""A run of each cell, driven past the harness's look for a card on the
program's CPU path at a small size, with the timed path broken
underneath: ``correct`` has to come out false for each fault the cell
can have, and true with nothing broken.  The control (the program's
float32 path in the float64 path's place) has to fail as well, on the
CPU and, where a card is visible, on the card."""

import json
import time

import pytest
import torch

from portbench import harness, reference
from repro_torch.core import plan

# Each cell of BENCHMARK.json at a size the CPU holds, by its entry point.
SMALL = {
    "batch": {"n": 96, "batch": 4, "pool": 2},
    "range": {"n": 96, "k": 8, "pool": 3, "warmup_calls": 3},
}
CELLS = sorted(w["name"] for w in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"])


def _cell(name):
    cell = harness.load_cell(name)
    cell.traffic.update(SMALL[cell.traffic["entry"]])
    return cell


def _run(name, device="cpu", knobs=None):
    return harness.run_cell(_cell(name), 2**31 + 77, 0.3, False,
                            time.perf_counter(), device=device,
                            knobs=knobs, log=lambda msg: None)


def _state_unchanged(lam, d, il):
    """The eigenvalues left as the state the solve started from: the
    sorted diagonal."""
    s = torch.sort(d.to(lam.dtype), dim=-1).values
    return s if il is None else s[:, il:il + lam.shape[-1]]


def _half_batch(lam, d, il):
    """Half of the batch left out: the first half's answers stand in for
    the second half's."""
    h = lam.shape[0] // 2
    return torch.cat([lam[:h], lam[:lam.shape[0] - h]])


def _answer_altered(lam, d, il):
    """One eigenvalue of each problem moved by 1e-12 where it is made."""
    lam = lam.clone()
    lam[:, lam.shape[-1] // 2] += 1e-12
    return lam


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered}


def _break(monkeypatch, fault):
    solve, sliced = plan.SolvePlan.execute, plan.RangePlan.execute

    def solve_broken(self, d, e, orig_n=None):
        res = solve(self, d, e, orig_n)
        d = torch.as_tensor(d).reshape(res.eigenvalues.shape[0], -1)
        return res._replace(eigenvalues=fault(res.eigenvalues, d, None))

    def sliced_broken(self, d, e, il, k=None):
        lam = sliced(self, d, e, il, k)
        d = torch.as_tensor(d).reshape(lam.shape[0], -1)
        return fault(lam, d, int(il))

    monkeypatch.setattr(plan.SolvePlan, "execute", solve_broken)
    monkeypatch.setattr(plan.RangePlan, "execute", sliced_broken)


@pytest.mark.parametrize("name", CELLS)
def test_an_unbroken_run_is_correct(name):
    res = _run(name)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"
    assert res["checks"]["err_eps"]["value"] <= 64


@pytest.mark.parametrize("name, fault", [
    (name, fault) for name in CELLS for fault in sorted(FAULTS)
    if fault != "half_batch" or harness.load_cell(name).traffic["entry"]
    == "batch"])
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    _break(monkeypatch, FAULTS[fault])
    res = _run(name)
    assert not res["correct"], res["checks"]
    assert res["checks"]["missed"]["value"] > 0


def test_a_call_that_raises_is_counted_and_not_correct(monkeypatch):
    def boom(self, d, e, orig_n=None):
        raise RuntimeError("planted")
    name = next(name for name in CELLS
                if harness.load_cell(name).traffic["entry"] == "batch")
    _run(name)                  # the plan exists before the window
    monkeypatch.setattr(plan.SolvePlan, "execute", boom)
    cell = _cell(name)
    cell.traffic["warmup_calls"] = 0
    res = harness.run_cell(cell, 5, 0.2, False, time.perf_counter(),
                           device="cpu", log=lambda msg: None)
    assert not res["correct"]
    assert res["failed"] == res["attempted"] > 0
    assert res["checks"]["failed_calls"]["value"] > 0


def _control(name, device):
    res = _run(name, device=device, knobs={"dtype": torch.float32})
    assert not res["correct"]
    err = res["checks"]["err_eps"]["value"]
    assert 2.0 ** 16 <= err <= reference.BEYOND


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_on_the_cpu(name):
    _control(name, "cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible")
    _control(name, "cuda")
