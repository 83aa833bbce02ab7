"""chain_ms_per_problem: device milliseconds of the deflation chain
(csrc/deflate_chain.cu: the deciding kernel and the split route's
rotation list) per problem solved."""

KERNELS = ("deflate_chain_kernel", "apply_rotations_kernel")


def read(window):
    if window.trace is None or not window.problems:
        return None
    seconds = window.trace.kernel_seconds(KERNELS)
    return seconds * 1e3 / window.problems if seconds > 0 else None
