"""Client facade: the eigensolver as a service, sync or async (port
copy of ``repro.serve.client``).

    from repro_torch.serve import EigensolverClient

    with EigensolverClient(max_batch=64, max_wait_us=2000) as client:
        lam = client.solve(d, e)                        # sync, blocks
        fut = client.solve_async(d, e)                  # -> Future
        res = client.solve_batch(D, E, return_boundary=True)
        top = client.solve_range(d, e, select="i", il=n-32, iu=n-1)
        print(client.metrics()["buckets"])

Every call builds the same :class:`~repro_torch.core.request.SolveRequest`
the sync API builds (``device=`` included: the card unless the caller
passes ``device="cpu"``), submits it to the coalescing scheduler, and
(for the sync variants) blocks on the returned future -- concurrent
callers' requests coalesce into shared launches and the results are
bit-for-bit what the sync API returns, tensors on the request's device.
``prewarm=...`` builds the expected buckets' plans (and, on the card, the
kernels) before the first request (see
:func:`repro_torch.core.plan.prewarm`).
"""

from __future__ import annotations

from concurrent.futures import Future

from repro_torch.core import plan as _plan
from repro_torch.core.request import SolveRequest, SolveResult
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.scheduler import CoalescingScheduler, ServeConfig


def _robust_kw(knobs: dict) -> dict:
    """Lift the request attributes out of **knobs into their SolveRequest
    fields (they are not solver knobs): ``certify`` joins the route key so
    certified requests coalesce together; ``deadline_ms`` arms the
    engine's expiry checks; ``device`` is where the request runs (its
    route key's device: CPU and card traffic never coalesce)."""
    return {"certify": bool(knobs.pop("certify", False)),
            "deadline_ms": knobs.pop("deadline_ms", None),
            "device": knobs.pop("device", None)}


class EigensolverClient:
    """Owns one scheduler + engine pair; thread-safe for any number of
    submitting threads.  Construction knobs mirror :class:`ServeConfig`;
    close() (or the context manager) drains queued work before returning.
    """

    def __init__(self, *, prewarm=None, config: ServeConfig | None = None,
                 **config_kwargs):
        if config is not None and config_kwargs:
            raise ValueError("pass either config or individual knobs")
        self.config = config or ServeConfig(**config_kwargs)
        self.metrics_sink = ServeMetrics()
        self.scheduler = CoalescingScheduler(self.config, self.metrics_sink)
        self.engine = ServeEngine(self.scheduler, self.config,
                                  self.metrics_sink)
        if prewarm is not None:
            _plan.prewarm(prewarm)
        self.engine.start()

    # ------------------------------------------------------------ submit

    def submit(self, request: SolveRequest) -> Future:
        """The async front door: returns a Future[SolveResult]."""
        return self.scheduler.submit(request)

    # ------------------------------------------------- convenience forms

    def solve_async(self, d, e, method: str = "br",
                    return_boundary: bool = False, **knobs) -> Future:
        return self.submit(SolveRequest(
            d=d, e=e, kind="full", method=method,
            return_boundary=return_boundary, **_robust_kw(knobs),
            knobs=knobs))

    def solve(self, d, e, method: str = "br", **knobs):
        """All eigenvalues of one problem -- the service's sync mirror of
        ``eigvalsh_tridiagonal``; returns the (n,) spectrum (a tensor on
        the request's device)."""
        return self.solve_async(d, e, method=method, **knobs) \
            .result().eigenvalues

    def solve_batch_async(self, d, e, method: str = "br",
                          return_boundary: bool = False, **knobs) -> Future:
        return self.submit(SolveRequest(
            d=d, e=e, kind="batch", method=method,
            return_boundary=return_boundary, **_robust_kw(knobs),
            knobs=knobs))

    def solve_batch(self, d, e, method: str = "br",
                    return_boundary: bool = False, **knobs) -> SolveResult:
        """(B, n) stacked problems; returns the full SolveResult (with
        boundary rows when requested) like ``eigvalsh_tridiagonal_batch``."""
        return self.solve_batch_async(
            d, e, method=method, return_boundary=return_boundary,
            **knobs).result()

    def solve_range_async(self, d, e, *, select: str = "i", il=None,
                          iu=None, vl=None, vu=None, **knobs) -> Future:
        return self.submit(SolveRequest(
            d=d, e=e, kind="range", select=select, il=il, iu=iu, vl=vl,
            vu=vu, **_robust_kw(knobs), knobs=knobs))

    def solve_range(self, d, e, *, select: str = "i", il=None, iu=None,
                    vl=None, vu=None, **knobs):
        """Selected eigenvalues -- the service's sync mirror of
        ``eigvalsh_tridiagonal_range``."""
        return self.solve_range_async(
            d, e, select=select, il=il, iu=iu, vl=vl, vu=vu,
            **knobs).result().eigenvalues

    # --------------------------------------------------------- lifecycle

    def metrics(self) -> dict:
        """Per-bucket serving metrics + plan-cache stats (see
        :meth:`repro_torch.serve.metrics.ServeMetrics.snapshot`)."""
        return self.metrics_sink.snapshot()

    def close(self) -> None:
        """Stop intake, drain queued flushes, join the worker."""
        self.engine.stop()

    def __enter__(self) -> "EigensolverClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
