"""device_idle_pct: the share of the traced window in which no kernel,
memcpy or memset ran on the card (100 minus the union of their
intervals, so that overlapping streams count once and copies count)."""


def read(window):
    trace = window.trace
    if trace is None or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
