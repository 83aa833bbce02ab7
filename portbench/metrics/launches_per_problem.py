"""launches_per_problem: device kernel launches in the traced window per
problem solved (the merge head's and the front door's launches, the
kernels', the leaf library's); an exact count."""


def read(window):
    trace = window.trace
    if trace is None or not window.problems:
        return None
    launches = len(trace.kernels())
    return launches / window.problems if launches else None
