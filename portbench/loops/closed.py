"""The closed loop: one caller, the next call issued once the last has
returned with its results synchronized, until the deadline."""

import time


def drive(work, deadline, record):
    i = 0
    while True:
        t0 = time.perf_counter()
        if t0 >= deadline:
            break
        try:
            with record.span():
                out = work.call(i)
                work.sync()
        except Exception as exc:  # a failed call is counted, not fatal
            work.sync()
            record.failed(i, exc, t0)
        else:
            record.done(i, out, t0)
        i += 1
