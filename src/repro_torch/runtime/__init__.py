"""Runtime support of the port, copies of ``repro.runtime``: the
deterministic chaos harness (``faults.py``), the watchdog's heartbeat
protocol (``watchdog.py``), the straggler monitor (``straggler.py``) and
the transient-error retry wrapper (``retry.py``) the serving engine runs
on."""

from repro_torch.runtime.watchdog import Watchdog
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.runtime.retry import retry_transient
from repro_torch.runtime.faults import (FaultSpec, InjectedDeterministicError,
                                        InjectedTransientError,
                                        configure_faults, fault_stats,
                                        faults_enabled, reset_faults)

__all__ = ["FaultSpec", "InjectedDeterministicError",
           "InjectedTransientError", "StragglerMonitor", "Watchdog",
           "configure_faults", "fault_stats", "faults_enabled",
           "reset_faults", "retry_transient"]
