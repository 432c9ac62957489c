"""AsyncEcoreService: the ``asyncio`` facade over ``EcoreService``.

The sync service resolves ``concurrent.futures.Future``s from two places —
inline (a full batch flushes during ``submit``) and the background flusher
thread (a deadline expires).  This facade bridges both to awaitables: each
submit wraps the service future in an ``asyncio`` future of the RUNNING
loop, and completion crosses the thread boundary through
``loop.call_soon_threadsafe``, the only asyncio API that is safe to call
from a foreign thread.  An awaiting task wakes when the flusher serves its
batch, with no polling on either side.

Submissions run inline on the loop thread, so decision order is
submission order; the injectable ``clock`` and ``wake()`` pass through.
A FULL batch serves inline during ``submit``; ``drain``/``close`` run in
the default executor, since they block on backend work.

Errors: the facade's only consumption plane is futures, so the underlying
service is built with ``buffer_errors=False`` — a backend error fails
exactly the awaited futures of its batch (and a direct ``drain`` caller),
never the event loop.
"""
from __future__ import annotations

import asyncio
import time
from concurrent.futures import Future
from typing import Callable, List, Optional, Sequence

from repro_torch.core.policy import Observation, RouteDecision, RouteRequest
from repro_torch.serving.service import EcoreService, Served


class AsyncEcoreService:
    """``async submit -> Served`` over any routing policy: the same
    policies, queues, backends and observation plane as the sync
    service."""

    def __init__(self, policy, backend_factory: Callable[[RouteDecision],
                                                         object], *,
                 max_wait_ms: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self._svc = EcoreService(policy, backend_factory,
                                 max_wait_ms=max_wait_ms, clock=clock,
                                 retain_results=False, buffer_errors=False)

    # ------------------------------------------------------------- bridge

    @staticmethod
    def _bridge(cfut: "Future[Served]") -> "asyncio.Future[Served]":
        loop = asyncio.get_running_loop()
        afut: "asyncio.Future[Served]" = loop.create_future()

        def _done(f: "Future[Served]") -> None:
            # fires in the flusher thread, the loop thread (inline flush)
            # or any thread calling drain/close
            def _copy() -> None:
                if afut.cancelled():
                    return
                exc = f.exception()
                if exc is not None:
                    afut.set_exception(exc)
                else:
                    afut.set_result(f.result())
            loop.call_soon_threadsafe(_copy)

        cfut.add_done_callback(_done)
        return afut

    # ------------------------------------------------------------- submit

    def submit_nowait(self, req: RouteRequest) -> "asyncio.Future[Served]":
        """Route + enqueue now (inline, in order); returns an awaitable
        that resolves when the request's batch flushes.  A failing submit
        (an inline flush whose backend raises, a routing error) comes back
        as a FAILED future, never as a throw into the coroutine."""
        loop = asyncio.get_running_loop()
        try:
            return self._bridge(self._svc.submit(req))
        except Exception as exc:
            # this runs on the loop thread (get_running_loop above), so the
            # future may be completed directly
            afut: "asyncio.Future[Served]" = loop.create_future()
            afut.set_exception(exc)
            return afut

    def submit_batch_nowait(self, reqs: Sequence[RouteRequest]
                            ) -> List["asyncio.Future[Served]"]:
        """One ``decide_batch`` call for the whole workload.  Raises when
        the BATCH cannot be submitted (routing or caller errors come before
        any future exists); a backend error after enqueue is carried by
        the affected futures."""
        return [self._bridge(f) for f in self._svc.submit_batch(reqs)]

    async def submit(self, req: RouteRequest) -> Served:
        """Submit and await completion (gather many to pipeline a stream)."""
        return await self.submit_nowait(req)

    async def submit_batch(self, reqs: Sequence[RouteRequest]) -> List[Served]:
        futs = self.submit_batch_nowait(reqs)
        return list(await asyncio.gather(*futs))

    def observe(self, obs: Observation) -> None:
        """The single feedback plane (same as the sync service)."""
        self._svc.observe(obs)

    # -------------------------------------------------------------- drain

    async def drain(self) -> None:
        """Flush every pending partial batch (in the default executor) so
        all awaited futures resolve.  A flush error propagates here AND to
        the affected futures."""
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, self._svc.drain)

    async def close(self) -> None:
        """Flush, resolve every outstanding future, stop the flusher.
        Idempotent; afterwards ``submit`` resolves to a failed future
        carrying ``ServiceClosed``."""
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, self._svc.close)

    async def __aenter__(self) -> "AsyncEcoreService":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    # ------------------------------------------------------------- mirror

    def wake(self) -> None:
        """Manual-clock tests: make the flusher re-check deadlines now."""
        self._svc.wake()

    def stats(self) -> dict:
        return self._svc.stats()

    @property
    def policy(self):
        return self._svc.policy

    @property
    def deadline_flushes(self) -> int:
        return self._svc.deadline_flushes
