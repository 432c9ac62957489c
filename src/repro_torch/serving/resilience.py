"""Resilience plane: deadline, bounded retry, and hedged re-dispatch.

``EcoreService`` is exactly as reliable as its backends: a thrown batch
fails every co-batched future.  On an edge fleet devices drop off, stall
and return garbage (``serving/faults.py`` injects all three), so
``ResilientService`` wraps the dispatch plane with three recovery moves:

  * **deadline**   — a completed request whose modeled ``time_ms`` exceeds
                     ``RetryPolicy.deadline_ms`` is a MISS, not a success,
                     and is retried elsewhere
  * **retry**      — failed attempts re-dispatch up to ``max_retries``
                     times with exponential backoff and deterministic
                     per-(uid, attempt) jitter, scheduled on the service's
                     INJECTABLE clock: the retrier thread waits on a
                     condition, never sleeps, so manual-clock tests stay
                     instant and deterministic
  * **hedging**    — a retry re-routes to the RUNNER-UP feasible pair of
                     the request's group under Algorithm 1's ranking
                     (``runner_up_route``), excluding every pair that
                     already failed this request

Lock discipline: the wrapper NEVER calls into the inner service while
holding its own condition.  Inner futures resolve under the inner service
lock and their done-callbacks take ours, so holding ours across an inner
call would deadlock against the flusher thread.  Every dispatch happens
outside the lock; the lock only guards bookkeeping.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, FrozenSet, List, Optional, Sequence, Set

import numpy as np

from repro_torch.core.policy import Observation, RouteDecision, RouteRequest
from repro_torch.core.router import runner_up_route
from repro_torch.serving.faults import uniform_u32
from repro_torch.serving.service import EcoreService, Served, ServiceClosed


class DeadlineExceeded(RuntimeError):
    """The request completed but too late (modeled ``time_ms`` over the
    deadline), or its retry budget ran out of deadline."""

    def __init__(self, uid: int, time_ms: float, deadline_ms: float):
        super().__init__(f"request uid {uid}: {time_ms:.1f} ms exceeds "
                         f"the {deadline_ms:.1f} ms deadline")
        self.uid = uid
        self.time_ms = time_ms
        self.deadline_ms = deadline_ms


class CorruptResult(RuntimeError):
    """The backend answered, but the result fails validation (NaN modeled
    time — the fault plane's corruption marker)."""

    def __init__(self, uid: int, backend: str):
        super().__init__(f"request uid {uid}: corrupt result from "
                         f"{backend!r} (non-finite time_ms)")
        self.uid = uid
        self.backend = backend


class RetriesExhausted(RuntimeError):
    """Every attempt failed; ``__cause__`` carries the last failure."""

    def __init__(self, uid: int, attempts: int, last: BaseException):
        super().__init__(f"request uid {uid} failed after {attempts} "
                         f"attempts: {last}")
        self.uid = uid
        self.attempts = attempts


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """How hard to try: deadline, retry budget, backoff shape, hedging."""
    deadline_ms: Optional[float] = None  # modeled per-request deadline
    max_retries: int = 2                 # re-dispatches after the 1st try
    backoff_ms: float = 10.0             # first retry delay
    backoff_mult: float = 2.0            # exponential growth per attempt
    jitter: float = 0.5                  # +[0, jitter) fraction, per (uid,
    #                                      attempt) hash — deterministic
    hedge: bool = True                   # re-route retries to the runner-up

    def delay_s(self, uid: int, attempt: int) -> float:
        """Backoff before retry ``attempt`` (1-based), jittered by the
        fault plane's splitmix32 hash of (uid, attempt)."""
        base = self.backoff_ms * self.backoff_mult ** (attempt - 1)
        u = uniform_u32(uid, attempt) / 4294967296.0
        return base * (1.0 + self.jitter * u) / 1e3


@dataclasses.dataclass
class _Attempt:
    """Bookkeeping for one in-flight request across its attempts."""
    req: RouteRequest
    decision: RouteDecision
    future: "Future[Served]"
    t_first: float                       # injectable-clock submit time
    attempts: int = 1
    excluded: Set = dataclasses.field(default_factory=set)
    due: float = 0.0                     # retry-due time when queued


#: reroute hook: (request, failed decision, excluded pairs) -> decision or
#: None (None = retry the original pair)
RerouteFn = Callable[[RouteRequest, RouteDecision, FrozenSet],
                     Optional[RouteDecision]]


class ResilientService:
    """``EcoreService`` + deadline/retry/hedging.  Same surface (``submit``
    -> ``Future[Served]``, ``observe``, ``drain``, ``close``), but a
    returned future only fails after the whole recovery budget is spent."""

    RETRY_TICK_S = 0.05  # real-time safety tick (as FLUSH_TICK_S)

    def __init__(self, policy,
                 backend_factory: Callable[[RouteDecision], object], *,
                 retry: RetryPolicy = RetryPolicy(),
                 max_wait_ms: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 reroute: Optional[RerouteFn] = None):
        self.policy = policy
        self.retry = retry
        self._clock = clock
        self._reroute = reroute if reroute is not None else self._runner_up
        # futures are the only consumption plane: the inner service
        # neither buffers errors nor retains results
        self._inner = EcoreService(policy, backend_factory,
                                   max_wait_ms=max_wait_ms, clock=clock,
                                   retain_results=False, buffer_errors=False)
        self._cond = threading.Condition()
        self._recs: Dict[int, _Attempt] = {}   # uid -> live request
        self._pending: List[_Attempt] = []     # subset waiting out backoff
        self._closed = False
        self.retries = 0
        self.hedges = 0
        self.deadline_misses = 0
        self.completed = 0
        self.failed = 0
        self._retrier = threading.Thread(target=self._retry_loop,
                                         name="ecore-retrier", daemon=True)
        self._retrier.start()

    # ------------------------------------------------------------- submit

    def submit(self, req: RouteRequest) -> "Future[Served]":
        with self._cond:
            self._ensure_open()
            decision = self.policy.decide(req)
            rec = _Attempt(req=req, decision=decision, future=Future(),
                           t_first=self._clock())
            self._recs[req.uid] = rec
        self._dispatch(rec, decision)   # outside the lock
        return rec.future

    def submit_batch(self, reqs: Sequence[RouteRequest]
                     ) -> List["Future[Served]"]:
        """Route the workload in one ``decide_batch`` call; every request
        still recovers independently."""
        reqs = list(reqs)
        with self._cond:
            self._ensure_open()
            decisions = self.policy.decide_batch(reqs)
            recs = []
            for req, decision in zip(reqs, decisions):
                rec = _Attempt(req=req, decision=decision, future=Future(),
                               t_first=self._clock())
                self._recs[req.uid] = rec
                recs.append(rec)
        for rec in recs:
            self._dispatch(rec, rec.decision)
        return [rec.future for rec in recs]

    def observe(self, obs: Observation) -> None:
        self._inner.observe(obs)

    # -------------------------------------------------------------- pump

    def drain(self) -> None:
        """Dispatch every backoff-pending retry NOW, flush the inner
        service, and repeat while any outer future is unresolved.  Each
        round moves every unresolved request on by one attempt, so it ends
        within ``max_retries + 1`` rounds of the last submit."""
        while self._unresolved():
            with self._cond:
                due, self._pending = list(self._pending), []
            for rec in due:
                self._redispatch(rec)
            try:
                self._inner.drain()
            except Exception:
                # the failed batch's futures already ran _on_done, which
                # rescheduled or failed each request: the outer futures
                # carry the outcome, and the pump goes on
                pass

    def _unresolved(self) -> bool:
        with self._cond:
            return bool(self._pending or self._recs)

    def close(self) -> None:
        """Finish what can finish (one full drain), then stop the retrier,
        close the inner service, and fail anything left with
        ``ServiceClosed``.  Idempotent."""
        with self._cond:
            if self._closed:
                return
        self.drain()
        with self._cond:
            self._closed = True
            leftovers = list(self._recs.values())
            self._recs.clear()
            self._pending.clear()
            self._cond.notify_all()
        self._retrier.join(timeout=5.0)
        self._inner.close()
        for rec in leftovers:
            rec.future.set_exception(ServiceClosed(
                f"ResilientService closed with request uid "
                f"{rec.req.uid} unresolved"))

    def __enter__(self) -> "ResilientService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def wake(self) -> None:
        """Manual-clock tests: re-check retry timers and flush deadlines."""
        with self._cond:
            self._cond.notify_all()
        self._inner.wake()

    def stats(self) -> Dict:
        with self._cond:
            out = {"retries": self.retries, "hedges": self.hedges,
                   "deadline_misses": self.deadline_misses,
                   "completed": self.completed, "failed": self.failed,
                   "pending": len(self._recs)}
        out["inner"] = self._inner.stats()
        return out

    # ---------------------------------------------------------- internals

    def _ensure_open(self) -> None:
        if self._closed:
            raise ServiceClosed("ResilientService is closed")

    def _runner_up(self, req: RouteRequest, decision: RouteDecision,
                   excluded: FrozenSet) -> Optional[RouteDecision]:
        """Default hedge: Algorithm 1's runner-up feasible pair for the
        request's group, minus every pair that already failed it.  Needs a
        table-backed policy (the detection face); None otherwise, and the
        retry goes to the same pair."""
        table = getattr(self.policy, "table", None)
        router = getattr(self.policy, "router", None)
        if table is None or router is None or not excluded:
            return None
        count = decision.est_complexity
        if count is None:
            count = req.true_complexity
        if count is None:
            return None
        entry = runner_up_route(int(count), table, router.delta,
                                exclude=excluded,
                                group_rules=self.policy.rules)
        if entry is None:
            return None
        return RouteDecision(
            uid=req.uid, pair=entry.pair, group=entry.group,
            est_complexity=decision.est_complexity,
            time_ms=entry.time_ms, energy_mwh=entry.energy_mwh,
            score=entry.map_pct)

    def _dispatch(self, rec: _Attempt, decision: RouteDecision) -> None:
        """One attempt.  MUST be called without holding ``self._cond``."""
        try:
            cfut = self._inner.submit_batch([rec.req],
                                            decisions=[decision])[0]
        except Exception as exc:
            # an inline full-batch flush failed during submit: recover
            # through the same path as a failed callback
            self._attempt_failed(rec, exc)
            return
        cfut.add_done_callback(lambda f, r=rec: self._on_done(r, f))

    def _on_done(self, rec: _Attempt, cfut: "Future[Served]") -> None:
        # runs wherever the inner future resolves: the flusher thread, an
        # inline flush, or drain/close
        exc = cfut.exception()
        if exc is not None:
            self._attempt_failed(rec, exc)
            return
        served = cfut.result()
        failure = self._validate(served)
        if failure is not None:
            self._attempt_failed(rec, failure)
            return
        with self._cond:
            self._recs.pop(rec.req.uid, None)
            self.completed += 1
            self._cond.notify_all()
        rec.future.set_result(served)

    def _validate(self, served: Served) -> Optional[Exception]:
        t_ms = served.result.time_ms
        if t_ms is not None and not np.isfinite(t_ms):
            return CorruptResult(served.request.uid, served.result.backend)
        dl = self.retry.deadline_ms
        if dl is not None and t_ms is not None and t_ms > dl:
            return DeadlineExceeded(served.request.uid, t_ms, dl)
        return None

    def _attempt_failed(self, rec: _Attempt, failure: Exception) -> None:
        fail_outer: Optional[Exception] = None
        with self._cond:
            if rec.req.uid not in self._recs:
                return      # already resolved (close raced a late callback)
            if isinstance(failure, DeadlineExceeded):
                self.deadline_misses += 1
            budget_left = rec.attempts <= self.retry.max_retries
            dl = self.retry.deadline_ms
            # no retry for a request whose deadline already passed on the
            # (injectable) clock
            if (dl is not None and budget_left
                    and (self._clock() - rec.t_first) * 1e3 > dl):
                budget_left = False
                failure = DeadlineExceeded(
                    rec.req.uid, (self._clock() - rec.t_first) * 1e3, dl)
            if not budget_left or self._closed:
                self._recs.pop(rec.req.uid, None)
                self.failed += 1
                fail_outer = RetriesExhausted(rec.req.uid, rec.attempts,
                                              failure)
                fail_outer.__cause__ = failure
            else:
                if self.retry.hedge:
                    rec.excluded.add(rec.decision.pair)
                rec.due = (self._clock()
                           + self.retry.delay_s(rec.req.uid, rec.attempts))
                rec.attempts += 1
                self._pending.append(rec)
            self._cond.notify_all()
        if fail_outer is not None:
            rec.future.set_exception(fail_outer)

    def _redispatch(self, rec: _Attempt) -> None:
        """Retry one request: hedge to the runner-up pair when enabled and
        one exists, else the original pair.  Called without the lock."""
        decision = None
        if self.retry.hedge:
            decision = self._reroute(rec.req, rec.decision,
                                     frozenset(rec.excluded))
        hedged = decision is not None and decision.pair != rec.decision.pair
        if decision is None:
            decision = rec.decision
        with self._cond:
            if rec.req.uid not in self._recs:
                return
            rec.decision = decision
            self.retries += 1
            if hedged:
                self.hedges += 1
        self._dispatch(rec, decision)

    def _retry_loop(self) -> None:
        for_now = self._wait_due()
        while for_now:
            for rec in for_now:
                self._redispatch(rec)      # outside the lock
            for_now = self._wait_due()

    def _wait_due(self) -> List[_Attempt]:
        """Condition-wait until a retry is due on the injectable clock (or
        a wake); returns the due retries, or [] once closed."""
        with self._cond:
            while not self._closed:
                if not self._pending:
                    self._cond.wait()
                    continue
                now = self._clock()
                due = [r for r in self._pending if r.due <= now]
                if due:
                    for r in due:
                        self._pending.remove(r)
                    return due
                wait_s = min(r.due for r in self._pending) - now
                self._cond.wait(min(wait_s, self.RETRY_TICK_S))
            return []
