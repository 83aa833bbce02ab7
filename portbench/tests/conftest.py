"""Tests of the benchmark harness (run with ``python -m pytest -q
portbench/tests`` from the root of the checkout; the repo's own test
run, ``testpaths = tests``, does not collect them).  CPU tests drive the
harness through the program's CPU path at small sizes; tests marked
``gpu`` decide inside the test whether a card is visible."""

import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
# The program reads tuned knobs from here: an empty directory, so every
# route takes the built-in defaults, as in a benchmark run.
os.environ["REPRO_TUNE_CACHE"] = tempfile.mkdtemp(prefix="portbench-tune-")
