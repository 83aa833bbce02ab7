"""Eigensolver-as-a-service on the port: a coalescing micro-batch front
end over the plan core (from ``repro.serve``).

Request lifecycle: ``submit -> route -> coalesce -> flush -> demux``.
Concurrent requests are routed to their bucketed plan keys
(``repro_torch.core.request``), grouped per key by the
:class:`CoalescingScheduler`, launched as shared batched solves by the
:class:`ServeEngine` (two CUDA streams, pinned staging, watchdog
heartbeats, straggler monitoring, transient-error retry,
poisoned-request isolation), and demuxed back onto per-request futures --
bit-for-bit the sync API's answers, at coalesced throughput.  Requests
run on the card unless they say ``device="cpu"``.
"""

from repro_torch.core.request import (KINDS, METHODS, SolveRequest,
                                      SolveResult, execute_request,
                                      route_request)
from repro_torch.serve.client import EigensolverClient
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.metrics import ServeMetrics, bucket_label
from repro_torch.serve.scheduler import (CoalescingScheduler, PendingRequest,
                                         QueueFull, SchedulerClosed,
                                         ServeConfig)

__all__ = [
    "CoalescingScheduler", "EigensolverClient", "KINDS", "METHODS",
    "PendingRequest", "QueueFull", "SchedulerClosed", "ServeConfig",
    "ServeEngine", "ServeMetrics", "SolveRequest", "SolveResult",
    "bucket_label", "execute_request", "route_request",
]
