"""sturm_ms_per_problem: device milliseconds of the Sturm path's kernels
(csrc/sturm_count.cu: the count sweep, the split Newton sweep and the
bisection tree) per range solve."""

KERNELS = ("count_kernel", "newton_split_kernel", "tree_kernel")


def read(window):
    if window.trace is None or not window.problems:
        return None
    seconds = window.trace.kernel_seconds(KERNELS)
    return seconds * 1e3 / window.problems if seconds > 0 else None
