"""Runtime support of the port: the deterministic chaos harness
(``faults.py``, a copy of ``repro.runtime.faults``).  The watchdog,
straggler monitor and retry helpers come with the serving layer."""

from repro_torch.runtime.faults import (FaultSpec, InjectedDeterministicError,
                                        InjectedTransientError,
                                        configure_faults, fault_stats,
                                        faults_enabled, reset_faults)

__all__ = ["FaultSpec", "InjectedDeterministicError",
           "InjectedTransientError", "configure_faults", "fault_stats",
           "faults_enabled", "reset_faults"]
