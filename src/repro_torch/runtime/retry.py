"""Retry wrapper for transient failures (preemption, flaky interconnect):
port copy of ``repro.runtime.retry``.

Wraps a step-ish callable; on a transient exception it backs off, invokes
the optional recovery hook (e.g. restore-from-checkpoint), and retries.
Non-transient exceptions propagate immediately.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, Optional, Type

TRANSIENT_DEFAULT: tuple = (OSError, RuntimeError)


def retry_transient(fn: Callable, *, retries: int = 3, backoff_s: float = 1.0,
                    transient: Iterable[Type[BaseException]] = TRANSIENT_DEFAULT,
                    on_retry: Optional[Callable[[int, BaseException], None]] = None):
    transient = tuple(transient)

    def wrapped(*args, **kwargs):
        delay = backoff_s
        for attempt in range(retries + 1):
            try:
                return fn(*args, **kwargs)
            except transient as exc:
                if attempt == retries:
                    raise
                if on_retry:
                    on_retry(attempt, exc)
                time.sleep(delay)
                delay *= 2
        raise AssertionError("unreachable")

    return wrapped
