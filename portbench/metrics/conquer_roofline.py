"""conquer_roofline: the conquer kernels' share of their roofline (kernel
table rows 1-3: csrc/resident_merge.cu, secular_roots.cu and
fused_update.cu with its weight pass), in percent.

The bound is the yardstick's: at each merge level the roots of every
node and, below the root, its two boundary rows, counted at that level's
K and kprime with 16 secular iterations.  kprime comes from the
program's deflation gauge in a pass after the window over the same
inputs (the gauge costs a host transfer a level, so never inside the
window); the gauge keeps each level's sum of kprime, and the sum of
kprime^2 is taken at its least, (sum kprime)^2 / nodes.  The share is
the bound of every call in the traced window over these kernels' device
time in it.
"""

import sys

from portbench import yardstick

KERNELS = ("resident_merge_kernel", "secular_roots_kernel", "rows_kernel",
           "weights_kernel")


def call_bound_s(events, problems: int) -> float:
    """The bound of one call from its deflation events (level,
    sum of kprime, poles) over ``problems`` problems."""
    levels: dict = {}
    for level, kprime_sum, poles in events:
        acc = levels.setdefault(int(level), [0.0, 0])
        acc[0] += kprime_sum
        acc[1] += poles
    if not levels:
        return 0.0
    top = max(levels)
    N = levels[top][1] // problems          # the root: one node a problem
    bound = 0.0
    for level, (kprime_sum, poles) in levels.items():
        K = N >> (top - level)
        bound += yardstick.conquer_level_bound_s(
            kprime_sum, poles // K, K, root=level == top)
    return bound


def read(window):
    if window.trace is None:
        return None
    seconds = window.trace.kernel_seconds(KERNELS)
    if seconds <= 0:
        return None
    from repro_torch.core import SOLVE_COUNTER
    work = window.workload
    bound = 0.0
    for p, calls in window.calls_by_pool().items():
        start = len(SOLVE_COUNTER.deflation_events())
        with SOLVE_COUNTER.measure(deflation=True):
            work.call(p)
        events = SOLVE_COUNTER.deflation_events(start)
        bound += calls * call_bound_s(events, work.per_call)
        if p == 0:
            ratios = " ".join(f"{k / poles:.3f}" for _, k, poles in events)
            print(f"[portbench] conquer_roofline: kprime / K by level of "
                  f"pool entry 0: {ratios}", file=sys.stderr)
    print(f"[portbench] conquer_roofline: bound {bound:.6f} s over "
          f"{seconds:.6f} s of conquer kernels", file=sys.stderr)
    return 100.0 * bound / seconds if bound > 0 else None
