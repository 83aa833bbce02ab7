"""Hang detection for long-running jobs: port copy of
``repro.runtime.watchdog`` (the same heartbeat file protocol).

The trainer beats once per step; a daemon thread checks the gap.  On a
multi-pod deployment the heartbeat file is on shared storage and an
external supervisor (or the other pods) restarts the hung worker -- here
the escalation hook is injectable (default: log loudly), and the heartbeat
file protocol is the real artifact.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Optional


class Watchdog:
    def __init__(self, heartbeat_path: str, *, timeout_s: float = 300.0,
                 check_every_s: float = 5.0,
                 on_hang: Optional[Callable[[float], None]] = None):
        self.path = heartbeat_path
        self.timeout_s = timeout_s
        self.check_every_s = check_every_s
        self.on_hang = on_hang or self._default_hang
        self._last_beat = time.monotonic()
        self._step = -1
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.hang_count = 0

    def _default_hang(self, silent_for: float):
        print(f"[watchdog] NO HEARTBEAT for {silent_for:.0f}s "
              f"(last step {self._step}) -- escalate/restart", flush=True)

    def beat(self, step: int, **info):
        self._last_beat = time.monotonic()
        self._step = step
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"step": step, "time": time.time(), **info}, f)
        os.replace(tmp, self.path)

    def _loop(self):
        while not self._stop.wait(self.check_every_s):
            silent = time.monotonic() - self._last_beat
            if silent > self.timeout_s:
                self.hang_count += 1
                self.on_hang(silent)

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
