"""EcoreService: ONE request-centric serving surface over a routing policy.

Maps the paper's Fig. 3 pipeline onto typed stages:

  estimate + route  the policy's ``decide`` / ``decide_batch`` turn a
                    ``RouteRequest`` (frame + complexity signal) into a
                    ``RouteDecision`` (the (model, device) pair and the
                    costs known at decision time);
  dispatch          the service owns one ``DispatchQueue`` per routed
                    (model, device) pair and lazily builds backends through
                    ``backend_factory``; ``submit`` enqueues and returns a
                    ``Future[Served]`` that resolves when the request's
                    batch flushes (full batch, ``drain`` or ``close``);
  observe           ``observe(Observation)`` is the single feedback plane:
                    measured latency/energy/quality EWMA-fold into the
                    policy's profile, closing the routing loop.  The
                    scanned closed loop folds its observations inside
                    ``decide_scan`` instead and hands ``submit_batch``
                    pre-routed decisions.

``serve_batch`` runs under the service lock, so decisions, flushes and
observations are serialized.  The JAX package's deadline flushing
(``max_wait_ms`` and its background flusher thread) waits for the slice
that ports the traffic plane, its only user.
"""
from __future__ import annotations

import dataclasses
import threading
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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
    ``drain``, ``close``."""

    def __init__(self, policy,
                 backend_factory: Callable[[RouteDecision], object]):
        self.policy = policy
        self._factory = backend_factory
        self._lock = threading.Lock()
        #: one queue per ROUTED PAIR — the same model on two devices must
        #: not collapse onto one backend
        self._queues: Dict[Tuple[str, str], DispatchQueue] = {}
        #: uid -> (request, decision, future, queue key)
        self._inflight: Dict[int, Tuple[RouteRequest, RouteDecision,
                                        Future, Tuple[str, str]]] = {}
        self._completed: List[Served] = []
        self._closed = False

    def submit(self, req: RouteRequest) -> "Future[Served]":
        """Route one request and enqueue it on its backend's dispatch
        queue."""
        with self._lock:
            self._ensure_open()
            return self._enqueue(req, self.policy.decide(req))

    def submit_batch(self, reqs: Sequence[RouteRequest],
                     decisions: Optional[Sequence[RouteDecision]] = None
                     ) -> List["Future[Served]"]:
        """Route a whole workload in one ``decide_batch`` call and enqueue
        every request.  ``decisions`` (optional, one per request) enqueues
        PRE-ROUTED requests instead: the scanned closed loop decides — and
        folds its observations — inside ``DetectionPolicy.decide_scan``, so
        the service must dispatch exactly those decisions rather than
        re-deciding against the already-updated profile."""
        with self._lock:
            self._ensure_open()
            if decisions is None:
                decisions = self.policy.decide_batch(list(reqs))
            elif len(decisions) != len(reqs):
                raise ValueError(
                    f"{len(decisions)} decisions for {len(reqs)} requests")
            return [self._enqueue(r, d) for r, d in zip(reqs, decisions)]

    def observe(self, obs: Observation) -> None:
        """Fold measured signals into the policy's profile (next decisions
        see them immediately)."""
        with self._lock:
            self.policy.observe(obs)

    def results(self) -> List[Served]:
        """Completed requests since the last ``results``/``drain`` call."""
        with self._lock:
            out, self._completed = self._completed, []
            return out

    def drain(self) -> List[Served]:
        """Flush every pending partial batch and return all unconsumed
        completions."""
        with self._lock:
            self._flush_all()
            out, self._completed = self._completed, []
            return out

    def close(self) -> None:
        """Flush whatever is pending (results resolve, backend errors
        become future exceptions, anything still unresolved fails with
        ``ServiceClosed``), then re-raise the first flush error.
        Idempotent; completions remain readable via ``results()``."""
        exc = None
        with self._lock:
            if self._closed:
                return
            try:
                self._flush_all()
            except Exception as e:
                exc = e
            for uid, (_, _, fut, _) in list(self._inflight.items()):
                del self._inflight[uid]
                fut.set_exception(ServiceClosed(
                    f"EcoreService closed with request uid {uid} unserved"))
            self._closed = True
        if exc is not None:
            raise exc

    def __enter__(self) -> "EcoreService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

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
            q = DispatchQueue(self._factory(decision))
            self._queues[key] = q
        fut: "Future[Served]" = Future()
        self._inflight[req.uid] = (req, decision, fut, key)
        self._dispatch(key, lambda: q.submit(
            Request(uid=req.uid, prompt=req.payload,
                    max_new_tokens=req.max_new_tokens,
                    group=decision.group)))
        return fut

    def _dispatch(self, key: Tuple[str, str], fn) -> None:
        """Run one queue operation that may serve a batch.  A backend
        error must not dangle futures: every inflight future of the
        failing backend gets the exception, then it propagates."""
        try:
            results = fn()
        except Exception as exc:
            for uid, (_, _, fut, k) in list(self._inflight.items()):
                if k == key:
                    del self._inflight[uid]
                    fut.set_exception(exc)
            raise
        for res in results:
            req, decision, fut, _ = self._inflight.pop(res.uid)
            served = Served(request=req, decision=decision, result=res)
            self._completed.append(served)
            fut.set_result(served)

    def _flush_all(self) -> None:
        first_exc = None
        for key, q in self._queues.items():
            try:
                self._dispatch(key, q.flush)
            except Exception as exc:  # futures already carry it; drain the
                first_exc = first_exc or exc        # healthy queues anyway
        if first_exc is not None:
            raise first_exc
