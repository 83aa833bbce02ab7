"""leaf_ms_per_problem: device milliseconds of the leaf solve (the
batched dense ``torch.linalg.eigh`` of br_dc._leaf_solve: every kernel,
copy and memset launched under ``aten::linalg_eigh``) per problem."""


def read(window):
    if window.trace is None or not window.problems:
        return None
    seconds = window.trace.seconds_under("aten::linalg_eigh")
    return seconds * 1e3 / window.problems if seconds > 0 else None
