"""EcoreService: ONE request-centric serving surface over a routing policy.

Maps the paper's Fig. 3 pipeline onto typed stages:

  estimate + route  the policy's ``decide`` / ``decide_batch`` turn a
                    ``RouteRequest`` (frame or prompt + complexity signal)
                    into a ``RouteDecision`` (the (model, device) pair and
                    the costs known at decision time);
  dispatch          the service owns one ``DispatchQueue`` per routed
                    (model, device) pair and lazily builds backends through
                    ``backend_factory``; ``submit`` enqueues and returns a
                    ``Future[Served]`` that resolves when the request's
                    batch flushes (full batch, deadline expiry, ``drain``
                    or ``close``);
  observe           ``observe(Observation)`` is the single feedback plane:
                    measured latency/energy/quality EWMA-fold into the
                    policy's profile, closing the routing loop.  The
                    scanned closed loop folds its observations inside
                    ``decide_scan`` instead and hands ``submit_batch``
                    pre-routed decisions.

With ``max_wait_ms`` a background flusher thread watches the oldest
pending request of every queue and serves a PARTIAL batch once its
deadline expires.  It waits on a condition, never sleeps: the clock is
injectable, tests drive a manual clock and call ``wake()`` after
advancing it (the flusher also re-checks on a short real-time tick).
``flusher=False`` keeps the deadlines but leaves WHEN to the caller
(``next_deadline`` / ``flush_due``).

``serve_batch`` runs under the service lock, so decisions, flushes and
observations are serialized — batching, not intra-service parallelism, is
the throughput lever.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.policy import Observation, RouteDecision, RouteRequest
from repro_torch.serving.engine import DispatchQueue, Request, Result


@dataclasses.dataclass
class Served:
    """One completed request: what was asked, where it went, what came back."""
    request: RouteRequest
    decision: RouteDecision
    result: Result


class ServiceClosed(RuntimeError):
    """The service was closed: raised by ``submit``/``submit_batch`` after
    ``close()``, and set on any future still pending when ``close()``
    finishes flushing."""


class EcoreService:
    """Request-centric serving: ``submit -> Future``, ``results``,
    ``drain``, ``close``, with deadline-bounded threaded flushing."""

    #: real-time re-check tick of the flusher (a safety net under manual
    #: clocks and the wake granularity under the real one)
    FLUSH_TICK_S = 0.05

    def __init__(self, policy,
                 backend_factory: Callable[[RouteDecision], object], *,
                 max_wait_ms: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 retain_results: bool = True,
                 buffer_errors: bool = True,
                 flusher: bool = True):
        self.policy = policy
        self.max_wait_ms = max_wait_ms
        self._factory = backend_factory
        self._clock = clock
        # a caller that only consumes futures passes retain_results=False,
        # so a long-lived service keeps no per-request state
        self._retain = retain_results
        # flusher-thread backend errors re-raise at drain()/close(); a
        # futures-only caller passes buffer_errors=False (the futures
        # already carry every error)
        self._buffer_errors = buffer_errors
        self._cond = threading.Condition()
        #: one queue per ROUTED PAIR — the same model on two devices must
        #: not collapse onto one backend
        self._queues: Dict[Tuple[str, str], DispatchQueue] = {}
        #: uid -> (request, decision, future, submit time, queue key)
        self._inflight: Dict[int, Tuple[RouteRequest, RouteDecision,
                                        Future, float, Tuple[str, str]]] = {}
        self._completed: List[Served] = []
        # two latency planes per request, bounded: queue wait (submit ->
        # the flush's trigger: deadline, full batch or drain) and service
        # (trigger -> completion)
        self._queue_wait_ms: Deque[float] = collections.deque(maxlen=4096)
        self._service_ms: Deque[float] = collections.deque(maxlen=4096)
        self._errors: Deque[Exception] = collections.deque(maxlen=16)
        self.flusher_passes = 0
        self._closed = False
        self._flusher: Optional[threading.Thread] = None
        if max_wait_ms is not None and flusher:
            self._flusher = threading.Thread(target=self._flush_loop,
                                             name="ecore-flusher",
                                             daemon=True)
            self._flusher.start()

    # ------------------------------------------------------------ submit

    def submit(self, req: RouteRequest) -> "Future[Served]":
        """Route one request and enqueue it on its backend's dispatch
        queue."""
        with self._cond:
            self._ensure_open()
            fut = self._enqueue(req, self.policy.decide(req))
            self._cond.notify_all()   # a new deadline for the flusher
            return fut

    def submit_batch(self, reqs: Sequence[RouteRequest],
                     decisions: Optional[Sequence[RouteDecision]] = None
                     ) -> List["Future[Served]"]:
        """Route a whole workload in one ``decide_batch`` call and enqueue
        every request.  ``decisions`` (optional, one per request) enqueues
        PRE-ROUTED requests instead: the scanned closed loop decides — and
        folds its observations — inside ``DetectionPolicy.decide_scan``, so
        the service must dispatch exactly those decisions rather than
        re-deciding against the already-updated profile."""
        with self._cond:
            self._ensure_open()
            if decisions is None:
                decisions = self.policy.decide_batch(list(reqs))
            elif len(decisions) != len(reqs):
                raise ValueError(
                    f"{len(decisions)} decisions for {len(reqs)} requests")
            futs = [self._enqueue(r, d) for r, d in zip(reqs, decisions)]
            self._cond.notify_all()
            return futs

    def observe(self, obs: Observation) -> None:
        """Fold measured signals into the policy's profile (next decisions
        see them immediately)."""
        with self._cond:
            self.policy.observe(obs)

    # ------------------------------------------------------------ results

    def results(self) -> List[Served]:
        """Completed requests since the last ``results``/``drain`` call."""
        with self._cond:
            out, self._completed = self._completed, []
            return out

    def drain(self) -> List[Served]:
        """Flush every pending partial batch and return all unconsumed
        completions.  Raises the first backend error the flusher thread
        caught since the last drain."""
        with self._cond:
            self._flush_all()
            if self._errors:
                raise self._errors.popleft()
            out, self._completed = self._completed, []
            return out

    def close(self) -> None:
        """Flush whatever is pending (results resolve, backend errors
        become future exceptions, anything still unresolved fails with
        ``ServiceClosed``), stop the flusher thread, then re-raise the
        first flush error.  Idempotent; completions remain readable via
        ``results()``."""
        exc = None
        with self._cond:
            if self._closed:
                return
            try:
                self._flush_all()
            except Exception as e:
                exc = e
            if exc is None and self._errors:
                exc = self._errors.popleft()
            for uid, (_, _, fut, _, _) in list(self._inflight.items()):
                del self._inflight[uid]
                fut.set_exception(ServiceClosed(
                    f"EcoreService closed with request uid {uid} unserved"))
            self._closed = True
            self._cond.notify_all()
        if self._flusher is not None:
            self._flusher.join(timeout=5.0)
        if exc is not None:
            raise exc

    def __enter__(self) -> "EcoreService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def wake(self) -> None:
        """Make the flusher re-check deadlines now (manual-clock tests call
        this after advancing their clock)."""
        with self._cond:
            self._cond.notify_all()

    def next_deadline(self) -> Optional[float]:
        """Earliest pending ``max_wait_ms`` expiry across all queues, or
        None when nothing is batched (or no deadline is set)."""
        with self._cond:
            deadlines = [d for q in self._queues.values()
                         if (d := q.next_deadline()) is not None]
            return min(deadlines) if deadlines else None

    def flush_due(self, now: Optional[float] = None) -> int:
        """Flush every queue whose deadline has expired by ``now``
        (default: the clock) — the flusher thread's pass, called
        synchronously.  Returns the number of queues flushed."""
        with self._cond:
            return self._flush_due_locked(self._clock() if now is None
                                          else now)

    @property
    def pending_requests(self) -> int:
        """Requests enqueued but not yet flushed."""
        with self._cond:
            return sum(len(q.pending) for q in self._queues.values())

    @property
    def deadline_flushes(self) -> int:
        """Partial batches served because a deadline expired (inline or by
        the flusher), counted on the queues."""
        return sum(q.deadline_flushes for q in self._queues.values())

    def stats(self) -> Dict:
        with self._cond:
            return {
                "backends": len(self._queues),
                "serve_calls": sum(q.calls for q in self._queues.values()),
                "served": sum(q.served for q in self._queues.values()),
                "deadline_flushes": self.deadline_flushes,
                "queue_wait_ms": list(self._queue_wait_ms),
                "service_ms": list(self._service_ms),
            }

    # ----------------------------------------------------------- internals

    def _ensure_open(self) -> None:
        if self._closed:
            raise ServiceClosed("EcoreService is closed")

    def _enqueue(self, req: RouteRequest,
                 decision: RouteDecision) -> "Future[Served]":
        if req.uid in self._inflight:
            raise ValueError(f"request uid {req.uid} is already in flight")
        key = decision.pair
        q = self._queues.get(key)
        if q is None:
            q = DispatchQueue(self._factory(decision),
                              max_wait_ms=self.max_wait_ms,
                              clock=self._clock)
            self._queues[key] = q
        fut: "Future[Served]" = Future()
        self._inflight[req.uid] = (req, decision, fut, self._clock(), key)
        self._dispatch(key, lambda: q.submit(
            Request(uid=req.uid, prompt=req.payload,
                    max_new_tokens=req.max_new_tokens,
                    group=decision.group)))
        return fut

    def _dispatch(self, key: Tuple[str, str], fn,
                  t_trigger: Optional[float] = None) -> None:
        """Run one queue operation that may serve a batch.  ``t_trigger``
        is when the flush became due (default: now); queue wait ends there.
        A backend error must not dangle futures: every inflight future of
        the failing backend gets the exception, then it propagates."""
        if t_trigger is None:
            t_trigger = self._clock()
        try:
            results = fn()
        except Exception as exc:
            for uid, (_, _, fut, _, k) in list(self._inflight.items()):
                if k == key:
                    del self._inflight[uid]
                    fut.set_exception(exc)
            raise
        self._complete(results, t_trigger)

    def _complete(self, results: List[Result], t_trigger: float) -> None:
        t_done = self._clock()
        for res in results:
            req, decision, fut, t_submit, _ = self._inflight.pop(res.uid)
            self._queue_wait_ms.append(max(t_trigger - t_submit, 0.0) * 1e3)
            self._service_ms.append((t_done - t_trigger) * 1e3)
            served = Served(request=req, decision=decision, result=res)
            if self._retain:
                self._completed.append(served)
            fut.set_result(served)

    def _flush_all(self) -> None:
        first_exc = None
        # one trigger for the whole drain: a queue flushed later must not
        # book earlier queues' serve time as its own queue wait
        t_trigger = self._clock()
        for key, q in self._queues.items():
            try:
                self._dispatch(key, q.flush, t_trigger)
            except Exception as exc:  # futures already carry it; drain the
                first_exc = first_exc or exc        # healthy queues anyway
        if first_exc is not None:
            raise first_exc

    def _flush_loop(self) -> None:
        with self._cond:
            while not self._closed:
                self.flusher_passes += 1
                deadlines = [d for q in self._queues.values()
                             if (d := q.next_deadline()) is not None]
                if not deadlines:
                    # idle: submit()/close() notify
                    self._cond.wait()
                    continue
                wait_s = min(deadlines) - self._clock()
                if wait_s > 0:
                    self._cond.wait(min(wait_s, self.FLUSH_TICK_S))
                    continue
                self._flush_due_locked(self._clock())

    def _flush_due_locked(self, now: float) -> int:
        """Flush the queues whose deadline expired by ``now``; the caller
        holds ``_cond``.  A backend error is carried by its futures (and
        kept for drain()/close() when ``buffer_errors``); the other queues
        are still served."""
        flushed = 0
        for key, q in list(self._queues.items()):
            nd = q.next_deadline()
            if nd is not None and nd <= now:
                q.deadline_flushes += 1
                flushed += 1
                try:
                    # the wait ended when the deadline expired
                    self._dispatch(key, q.flush, nd)
                except Exception as exc:
                    if self._buffer_errors:
                        self._errors.append(exc)
        return flushed
