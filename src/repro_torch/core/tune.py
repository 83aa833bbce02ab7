"""Backend-aware knob defaults for the port.

Only the defaults table of ``repro.core.tune`` is ported so far; the
on-device knob search and its persistent tuning cache come in a later
slice, so every ``None`` knob resolves to this table.

The port routes by *device*, not by a process-wide backend: a CPU tensor
runs the plain torch versions and a CUDA tensor runs the hand-written
kernels, in the same process.  So the table has one row per device type
and callers pick the row of the device their tensors live on.
"""

from __future__ import annotations

import threading

import torch

_LOCK = threading.Lock()
_BACKEND: str | None = None

# Largest merge size K the resident kernel (csrc/resident_merge.cu) takes.
# Each CTA of it keeps one merge lane's O(K) vectors in shared memory: d,
# z (then zhat), d[origin] and tau, plus the r selected rows, i.e.
# (4 + r) * K * itemsize bytes.  The worst case on the main path is r = 3
# rows in float64: 7 * K * 8 = 56 K bytes.  A Hopper block can use at most
# 232,448 bytes of dynamic shared memory, so K <= 4150; merge sizes are
# 2 * leaf * 2^l, and K = 2048 (114,688 bytes, two CTAs to an SM) is the
# threshold.
RESIDENT_THRESHOLD_CUDA = 2048

# Sturm chains whose issue time still fits under one chain's latency on
# the card: the bisection tree (csrc/sturm_count.cu) counts this many node
# chains in about the time of one.  132 SMs x 128 issue slots a cycle x
# 1.926 GHz x 77.61 ns (one row of the chain, the chain probe) / 37.62
# instructions a row of the tree's loop (its SASS), about 67k
# (chip_smoke.py's ``[2 bound] bisection tree`` line re-derives it).  On
# an H100 the depths it gives (8 for a k = 64 range solve, 6 for the
# edges probes of B = 64 x 4096, 4 for ``method="bisect"`` at n = 4096)
# were also the fastest per halving of all depths 1-8
# (scripts/time_merge_kernels.py --kernels sturm --sweep).
BISECT_CHAINS_CUDA = 67000

# Deepest bisection tree one launch counts (kernels/sturm_count.MAX_DEPTH).
MAX_BISECT_DEPTH = 8

_DEFAULTS = {
    # CPU: the plain torch versions.  As in the JAX package, everything
    # streams (stream_threshold 0) and the resident single-dispatch merge
    # is off (resident_threshold 0): on the CPU its dense (K, K) tile is
    # pure memory overhead.
    # bisect_chains 0: the CPU's bisection runs one halving a sweep (depth
    # 1), the plain host loop of the JAX package.
    "cpu": {"leaf": 32, "chunk": 256, "stream_threshold": 0,
            "resident_threshold": 0, "deflate_budget": 64, "niter": 16,
            "bisect_chains": 0},
    # CUDA: the hand-written kernels tile the pole axis themselves and
    # have no dense mode, so stream_threshold selects nothing there (0).
    # resident_threshold is the shared-memory fit derived above, and
    # bisect_chains the chain count under one chain's latency.
    "cuda": {"leaf": 32, "chunk": 256, "stream_threshold": 0,
             "resident_threshold": RESIDENT_THRESHOLD_CUDA,
             "deflate_budget": 64, "niter": 16,
             "bisect_chains": BISECT_CHAINS_CUDA},
}


def pinned_backend() -> str:
    """``"cuda"`` when a CUDA card is visible, else ``"cpu"``; probed once
    and pinned for the life of the process."""
    global _BACKEND
    if _BACKEND is None:
        with _LOCK:
            if _BACKEND is None:
                _BACKEND = "cuda" if torch.cuda.is_available() else "cpu"
    return _BACKEND


def backend_defaults(backend: str | None = None) -> dict:
    """The knob-defaults row of ``backend`` (a device type, ``"cuda"`` or
    ``"cpu"``; None: :func:`pinned_backend`)."""
    backend = backend or pinned_backend()
    if backend not in _DEFAULTS:
        raise ValueError(f"no knob defaults for device type {backend!r}; "
                         f"the port runs on {tuple(_DEFAULTS)}")
    return dict(_DEFAULTS[backend])


def bisect_depth(brackets: int, chains: int) -> int:
    """Halvings a bisection launch takes for ``brackets`` brackets when
    ``chains`` chains cost the time of one: the deepest tree whose
    brackets * (2^m - 1) node chains fit, m = floor(log2(chains /
    brackets + 1)), within [1, MAX_BISECT_DEPTH]."""
    m = (chains // max(1, brackets) + 1).bit_length() - 1
    return max(1, min(MAX_BISECT_DEPTH, m))


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    None means the card: entry points run on ``cuda`` unless the caller
    asks for the CPU.  With no card visible that is an error, never a
    quiet fallback to the CPU.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "visible; pass device='cpu' to run the plain torch path")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device={device!r} but no CUDA device is "
                               f"visible")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', got "
                         f"device={device!r}")
    return dev
