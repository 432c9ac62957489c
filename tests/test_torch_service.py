"""The port's deadline-flushing dispatch queue and service, its asyncio
facade, and its fault and resilience planes against the JAX package's,
on the CPU.

Each scenario runs once through each package on the same inputs and
returns a trace of what it observed; the traces must be equal (and hold
the values the JAX tests assert).  Times come from an injectable manual
clock, so no sleep decides an assertion: a test that must know the
flusher looked waits on the clock's own read count, and every wait
(``result``, ``wait_for``, the read count) has a timeout of at most 10 s.
Detections from real detectors are held within the detector tests' bar
(boxes atol 1e-4, scores atol 1e-6, rtol 1e-5).
"""
import asyncio
import threading
import types

import jax
import numpy as np
import pytest
import torch

from repro.core import policy as jax_policy
from repro.core import profiles as jax_profiles
from repro.core import router as jax_router
from repro.detection import devices as jax_devices
from repro.detection.detectors import DETECTOR_CONFIGS as JAX_CONFIGS
from repro.detection.detectors import init_detector as jax_init_detector
from repro.serving import aio as jax_aio
from repro.serving import backend as jax_backend
from repro.serving import engine as jax_engine
from repro.serving import faults as jax_faults
from repro.serving import pool as jax_pool
from repro.serving import resilience as jax_resilience
from repro.serving import service as jax_service
from repro_torch.core import policy, profiles, router
from repro_torch.detection import devices
from repro_torch.serving import (aio, backend, engine, faults, pool,
                                 resilience, service)

torch.set_num_threads(1)

TIMEOUT = 10.0


def _ns(policy, profiles, router, devices, aio, backend, engine, faults,
        pool, resilience, service, table):
    return types.SimpleNamespace(
        Entry=profiles.ProfileEntry, table=table, pool=pool,
        policy=policy, router=router, devices=devices, engine=engine,
        service=service, aio=aio, faults=faults, backend=backend,
        resilience=resilience)


PKGS = {
    "jax": _ns(jax_policy, jax_profiles, jax_router, jax_devices, jax_aio,
               jax_backend, jax_engine, jax_faults, jax_pool,
               jax_resilience, jax_service, jax_profiles.ProfileTable),
    "torch": _ns(policy, profiles, router, devices, aio, backend, engine,
                 faults, pool, resilience, service,
                 lambda entries: profiles.ProfileTable(entries, device="cpu")),
}


def _both(scenario, *args):
    """Run ``scenario`` through both packages; the traces must agree."""
    want = scenario(PKGS["jax"], *args)
    got = scenario(PKGS["torch"], *args)
    assert got == want
    return got


class ManualClock:
    """A clock the test advances by hand; every read is counted, so a test
    can wait (with a timeout) until a background thread has looked."""

    def __init__(self):
        self.t = 100.0
        self.reads = 0
        self._cv = threading.Condition()

    def __call__(self):
        with self._cv:
            self.reads += 1
            self._cv.notify_all()
            return self.t

    def advance_ms(self, ms):
        with self._cv:
            self.t += ms / 1e3

    def wait_reads(self, more):
        with self._cv:
            goal = self.reads + more
            assert self._cv.wait_for(lambda: self.reads >= goal, TIMEOUT)


class _Stub:
    """A backend answering instantly; ``fail`` makes it raise."""

    def __init__(self, p, name="stub", max_batch=4, fail=False):
        self.p, self.name, self.max_batch, self.fail = p, name, max_batch, fail
        self.batch_sizes = []

    def serve_batch(self, requests):
        if self.fail:
            raise RuntimeError("backend exploded")
        self.batch_sizes.append(len(requests))
        return [self.p.engine.Result(
            uid=r.uid, tokens=np.asarray([r.uid], np.int32), prefill_s=.01,
            decode_s=.01, backend=self.name, batch_size=len(requests),
            time_ms=10.0) for r in requests]

    def profile_row(self):
        return {"kind": "stub", "model": self.name,
                "max_batch": self.max_batch}


def _pool_policy(p, delta=5.0, alpha=0.1, flat=False):
    # 'small' degrades with the bucket, 'big' holds: routing varies by length
    entries = [p.Entry(a, "pod", b, 80.0 if flat else score - drop * b, 1.0,
                       energy)
               for a, score, drop, energy in (("small", 80.0, 3.0, 1.0),
                                              ("big", 84.0, 1.0, 5.0))
               for _, _, b in p.pool.LENGTH_BUCKETS]
    return p.policy.PoolPolicy(p.pool.ServingPool(p.table(entries),
                                                  delta=delta), alpha=alpha)


def _req(p, uid, plen):
    return p.policy.RouteRequest(uid=uid, complexity=plen,
                                 payload=np.arange(8), max_new_tokens=4)


def _failing_small(p, max_batch=4):
    return lambda d: _Stub(p, d.backend, max_batch,
                           fail=d.backend == "small")


# -------------------------------------------------------- dispatch queue

def _queue_trace(p):
    clock = ManualClock()
    be = _Stub(p, max_batch=4)
    q = p.engine.DispatchQueue(be, max_wait_ms=50.0, clock=clock)
    req = lambda uid, n=4: p.engine.Request(uid=uid, prompt=np.zeros(n))
    out = [q.next_deadline(), q.submit(req(0)), q.submit(req(1)),
           round(q.next_deadline() - 100.0, 9)]
    clock.advance_ms(49.9)
    out.append(q.poll())
    clock.advance_ms(0.2)
    out.append([r.uid for r in q.poll()])
    out += [q.deadline_flushes, q.next_deadline()]
    q.submit(req(2))
    clock.advance_ms(60)
    out.append([r.uid for r in q.submit(req(3, 6))])   # inline deadline
    out += [q.deadline_flushes, q.calls, be.batch_sizes]
    for uid in range(4, 8):                             # full batch
        got = q.submit(req(uid))
    out += [[r.uid for r in got], q.deadline_flushes]
    plain = p.engine.DispatchQueue(_Stub(p, max_batch=4))
    out += [plain.submit(req(9)), plain.next_deadline(), plain.poll(),
            [r.uid for r in plain.flush()]]
    return out


def test_dispatch_queue_deadlines_equal_jax():
    trace = _both(_queue_trace)
    assert trace[3] == pytest.approx(100.05 - 100.0)
    assert trace[5] == [0, 1] and trace[6] == 1
    assert trace[8] == [2, 3] and trace[9] == 2


# -------------------------------------------- service: threaded flusher

@pytest.mark.threads
def test_threaded_flusher_serves_deadline_expired_partial_batch(
        monkeypatch):
    """Nothing is served before max_wait_ms (the flusher has looked), the
    partial batch goes out after the deadline expires, and nobody calls
    the cooperative ``poll()``."""
    def no_poll(self):
        raise AssertionError("cooperative poll() must never be called")

    def scenario(p):
        monkeypatch.setattr(p.engine.DispatchQueue, "poll", no_poll)
        clock = ManualClock()
        be = _Stub(p, max_batch=4)
        svc = p.service.EcoreService(_pool_policy(p), lambda d: be,
                                     max_wait_ms=50.0, clock=clock)
        futs = [svc.submit(_req(p, i, 64)) for i in range(2)]
        out = [[f.done() for f in futs]]
        clock.advance_ms(49.9)
        svc.wake()
        clock.wait_reads(3)                     # the flusher looked
        out += [[f.done() for f in futs], svc.deadline_flushes]
        clock.advance_ms(0.2)
        svc.wake()
        out.append([f.result(timeout=TIMEOUT).result.uid for f in futs])
        stats = svc.stats()
        out += [be.batch_sizes, svc.deadline_flushes, stats["serve_calls"],
                stats["served"], round(stats["queue_wait_ms"][0], 6)]
        svc.close()
        out.append(svc._flusher.is_alive())     # close joined the thread
        return out

    trace = _both(scenario)
    assert trace[:4] == [[False] * 2, [False] * 2, 0, [0, 1]]
    assert trace[4:8] == [[2], 1, 1, 2]
    assert trace[8] == pytest.approx(50.0)   # submit -> the deadline
    assert trace[9] is False


@pytest.mark.threads
def test_flusher_thread_survives_backend_errors():
    def scenario(p):
        clock = ManualClock()
        svc = p.service.EcoreService(_pool_policy(p), _failing_small(p),
                                     max_wait_ms=50.0, clock=clock)
        bad = svc.submit(_req(p, 0, 64))            # -> failing 'small'
        good = svc.submit(_req(p, 1, 600_000))      # -> healthy 'big'
        clock.advance_ms(51)
        svc.wake()
        out = [type(bad.exception(timeout=TIMEOUT)).__name__,
               good.result(timeout=TIMEOUT).result.uid]
        out += [svc.deadline_flushes, svc._flusher.is_alive()]
        with pytest.raises(RuntimeError, match="backend exploded"):
            svc.drain()
        out.append([s.result.uid for s in svc.results()])
        svc.close()                                 # error consumed
        return out

    assert _both(scenario) == ["RuntimeError", 1, 2, True, [1]]


@pytest.mark.threads
def test_deadline_flushed_detections_equal_solo_serving_and_jax():
    """A deadline-flushed batch of real detector runs returns what solo
    serving returns, and what the JAX service returns for the same
    weights and frames."""
    from repro.detection.scenes import drifting_dataset
    from repro_torch.detection.detectors import params_from_jax
    jp = jax.tree_util.tree_map(np.asarray, jax_init_detector(
        JAX_CONFIGS["ssd_v1"], jax.random.PRNGKey(3)))
    jp["head"]["b2"] = jp["head"]["b2"] + 0.3
    frames = [s.image for s in drifting_dataset(3, seed=5)]

    def scenario(p):
        params = jp if p is PKGS["jax"] else params_from_jax(jp)
        kw = {} if p is PKGS["jax"] else {"device": "cpu"}
        be = p.backend.DetectorBackend("ssd_v1", "orin_nano", params,
                                       max_batch=8, **kw)
        table = p.devices.nominal_profile_table(**kw)
        pol = p.policy.DetectionPolicy(p.router.OracleRouter(table, 5.0),
                                       table)
        clock = ManualClock()
        svc = p.service.EcoreService(pol, lambda d: be, max_wait_ms=20.0,
                                     clock=clock)
        futs = [svc.submit(p.policy.RouteRequest(uid=i, payload=f,
                                                 true_complexity=2))
                for i, f in enumerate(frames)]
        done = [f.done() for f in futs]
        clock.advance_ms(21)
        svc.wake()
        served = [f.result(timeout=TIMEOUT) for f in futs]
        svc.close()
        solo = [be.serve_batch([p.engine.Request(uid=i, prompt=f)])[0]
                for i, f in enumerate(frames)]
        return done, served, solo, svc.deadline_flushes

    jdone, jserved, _, jflushes = scenario(PKGS["jax"])
    done, served, solo, flushes = scenario(PKGS["torch"])
    assert done == jdone == [False] * 3 and flushes == jflushes == 1
    assert sum(len(s.result.detections[1]) for s in served) > 0
    for s, one, js in zip(served, solo, jserved):
        assert s.result.batch_size == 3 and s.decision.pair == \
            js.decision.pair
        for got in (one.detections, js.result.detections):
            _assert_detections_close(s.result.detections, got)


def _assert_detections_close(got, want):
    """The detector tests' bar: boxes atol 1e-4, scores atol 1e-6 (rtol
    1e-5), classes equal (a batch of 3 and a batch of 1 may round a
    convolution differently)."""
    (b1, s1, c1), (b2, s2, c2) = got, want
    np.testing.assert_allclose(b1, b2, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(s1, s2, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(c1, c2)


def test_service_closed_is_structured_and_terminal():
    def scenario(p):
        make = lambda d: _Stub(p, d.backend, 4)
        svc = p.service.EcoreService(_pool_policy(p), make)
        fut = svc.submit(_req(p, 0, 64))
        svc.close()                         # flushes: the future resolves
        out = [fut.result(TIMEOUT).result.uid]
        svc.close()                         # idempotent
        for submit in (lambda: svc.submit(_req(p, 1, 64)),
                       lambda: svc.submit_batch([_req(p, 1, 64)])):
            with pytest.raises(p.service.ServiceClosed):
                submit()
        with p.service.EcoreService(_pool_policy(p), make) as ctx:
            pass
        with pytest.raises(p.service.ServiceClosed):
            ctx.submit(_req(p, 2, 64))
        return out

    assert _both(scenario) == [0]


@pytest.mark.threads
@pytest.mark.parametrize("buffered", [True, False])
def test_buffer_errors_toggle_controls_drain_reraise(buffered):
    def scenario(p):
        clock = ManualClock()
        svc = p.service.EcoreService(_pool_policy(p), _failing_small(p),
                                     max_wait_ms=50.0, clock=clock,
                                     buffer_errors=buffered)
        bad = svc.submit_batch([_req(p, 0, 64), _req(p, 1, 64)])
        clock.advance_ms(51)
        svc.wake()
        out = [type(f.exception(timeout=TIMEOUT)).__name__ for f in bad]
        if buffered:
            with pytest.raises(RuntimeError, match="backend exploded"):
                svc.drain()
        else:
            out.append(svc.drain())         # no re-raise, no double report
        svc.close()
        return out

    want = ["RuntimeError"] * 2 + ([] if buffered else [[]])
    assert _both(scenario) == want


@pytest.mark.threads
def test_queue_wait_excludes_service_time():
    """Queue wait ends when the flush TRIGGERS (the deadline's expiry),
    service time covers trigger -> completion, on the same clock."""
    def scenario(p):
        clock = ManualClock()
        svc = p.service.EcoreService(_pool_policy(p),
                                     lambda d: _Stub(p, d.backend, 4),
                                     max_wait_ms=50.0, clock=clock)
        fut = svc.submit(_req(p, 0, 64))
        clock.advance_ms(200)               # the flusher came late
        svc.wake()
        fut.result(timeout=TIMEOUT)
        stats = svc.stats()
        svc.close()
        return [round(v, 6) for v in stats["queue_wait_ms"]
                + stats["service_ms"]]

    assert _both(scenario) == [pytest.approx(50.0), pytest.approx(150.0)]


def test_inline_full_batch_flush_has_zero_queue_wait():
    def scenario(p):
        svc = p.service.EcoreService(_pool_policy(p),
                                     lambda d: _Stub(p, d.backend, 2),
                                     clock=ManualClock())
        assert svc._flusher is None         # no deadline -> no thread
        svc.submit(_req(p, 0, 64))
        svc.submit(_req(p, 1, 64))          # fills the batch: inline flush
        stats = svc.stats()
        svc.close()
        return stats["queue_wait_ms"] + stats["service_ms"]

    assert _both(scenario) == [0.0] * 4


def test_flush_due_drives_deadlines_without_a_thread():
    """``flusher=False``: a virtual-time caller reads ``next_deadline``,
    advances its clock there and calls ``flush_due``."""
    def scenario(p):
        clock = ManualClock()
        svc = p.service.EcoreService(_pool_policy(p),
                                     lambda d: _Stub(p, d.backend, 4),
                                     max_wait_ms=30.0, clock=clock,
                                     flusher=False)
        assert svc._flusher is None
        futs = [svc.submit(_req(p, 0, 64))]
        clock.advance_ms(10)
        futs.append(svc.submit(_req(p, 1, 600_000)))   # another queue
        out = [svc.pending_requests, round(svc.next_deadline() - 100.0, 9),
               svc.flush_due(), svc.flush_due(100.0 + 0.030)]
        out += [[f.done() for f in futs], svc.pending_requests,
                round(svc.next_deadline() - 100.0, 9)]
        clock.advance_ms(30)
        out += [svc.flush_due(), [f.done() for f in futs],
                svc.next_deadline(), svc.deadline_flushes]
        svc.close()
        return out

    assert _both(scenario) == [2, pytest.approx(0.03), 0, 1, [True, False],
                               1, pytest.approx(0.04), 1, [True, True],
                               None, 2]


def test_pool_policy_observe_derives_bucket_from_true_complexity():
    def scenario(p):
        pol = _pool_policy(p, alpha=0.5, flat=True)
        pol.observe(p.policy.Observation(pair=("small", "pod"), map_pct=0.0,
                                         true_complexity=1024))
        table = pol.pool.table
        return [table.entry(("small", "pod"), b).map_pct for b in (0, 1)]

    assert _both(scenario) == [80.0, 40.0]


def test_service_backend_error_and_duplicate_uid():
    def scenario(p):
        svc = p.service.EcoreService(_pool_policy(p),
                                     _failing_small(p, max_batch=2))
        f0 = svc.submit(_req(p, 0, 64))             # 'small', pending
        with pytest.raises(ValueError, match="already in flight"):
            svc.submit(_req(p, 0, 64))
        with pytest.raises(RuntimeError, match="backend exploded"):
            svc.submit(_req(p, 1, 64))              # fills the batch
        f2 = svc.submit(_req(p, 2, 600_000))        # healthy 'big'
        out = [type(f0.exception()).__name__,
               [s.result.uid for s in svc.drain()], f2.done()]
        svc.close()
        return out

    assert _both(scenario) == ["RuntimeError", [2], True]


# ------------------------------------------------------------- asyncio

def _served_key(s):
    return (s.request.uid, s.decision.pair, s.decision.group,
            s.result.backend, s.result.batch_size, s.result.tokens.tolist())


@pytest.mark.asyncio
def test_async_submit_await_equals_sync_and_jax():
    plens = [1, 100, 2049, 600_000, 64, 8193]

    def scenario(p):
        reqs = [_req(p, i, n) for i, n in enumerate(plens)]
        with p.service.EcoreService(_pool_policy(p),
                                    lambda d: _Stub(p, d.backend, 2)) as sv:
            futs = [sv.submit(r) for r in reqs]
            sv.drain()
            want = [_served_key(f.result(TIMEOUT)) for f in futs]

        async def drive():
            async with p.aio.AsyncEcoreService(
                    _pool_policy(p), lambda d: _Stub(p, d.backend, 2)) as svc:
                futs = [svc.submit_nowait(r) for r in reqs]
                await asyncio.wait_for(svc.drain(), TIMEOUT)
                return await asyncio.wait_for(asyncio.gather(*futs), TIMEOUT)

        got = [_served_key(s) for s in asyncio.run(drive())]
        assert got == want
        return got

    trace = _both(scenario)
    assert {k[1][0] for k in trace} == {"small", "big"}


@pytest.mark.asyncio
def test_async_submit_batch_is_one_decide_batch_call(monkeypatch):
    def scenario(p):
        scalar = []
        orig = p.policy.PoolPolicy.decide
        monkeypatch.setattr(p.policy.PoolPolicy, "decide",
                            lambda self, r: scalar.append(r.uid)
                            or orig(self, r))

        async def drive():
            async with p.aio.AsyncEcoreService(
                    _pool_policy(p), lambda d: _Stub(p, d.backend, 4)) as svc:
                served = await asyncio.wait_for(
                    svc.submit_batch([_req(p, i, 64) for i in range(4)]),
                    TIMEOUT)
                return served, svc.stats()

        served, stats = asyncio.run(drive())
        return [s.result.uid for s in served], scalar, stats["serve_calls"]

    assert _both(scenario) == ([0, 1, 2, 3], [], 1)


@pytest.mark.asyncio
@pytest.mark.threads
def test_deadline_flush_wakes_awaiting_tasks():
    def scenario(p):
        clock = ManualClock()
        be = _Stub(p, max_batch=4)

        async def drive():
            svc = p.aio.AsyncEcoreService(_pool_policy(p), lambda d: be,
                                          max_wait_ms=50.0, clock=clock)
            try:
                futs = [svc.submit_nowait(_req(p, i, 64)) for i in range(2)]
                await asyncio.sleep(0)          # let any completion land
                out = [[f.done() for f in futs]]
                clock.advance_ms(50.1)
                svc.wake()
                served = await asyncio.wait_for(asyncio.gather(*futs),
                                                TIMEOUT)
                return out + [[s.result.uid for s in served],
                              be.batch_sizes, svc.deadline_flushes]
            finally:
                await asyncio.wait_for(svc.close(), TIMEOUT)

        return asyncio.run(drive())

    assert _both(scenario) == [[False, False], [0, 1], [2], 1]


@pytest.mark.asyncio
@pytest.mark.threads
def test_backend_error_fails_awaited_future_not_the_loop():
    def scenario(p):
        clock = ManualClock()

        async def drive():
            svc = p.aio.AsyncEcoreService(_pool_policy(p), _failing_small(p),
                                          max_wait_ms=50.0, clock=clock)
            bad = svc.submit_nowait(_req(p, 0, 64))
            good = svc.submit_nowait(_req(p, 1, 600_000))
            clock.advance_ms(51)
            svc.wake()
            with pytest.raises(RuntimeError, match="backend exploded"):
                await asyncio.wait_for(bad, TIMEOUT)
            out = [(await asyncio.wait_for(good, TIMEOUT)).result.uid]
            again = svc.submit_nowait(_req(p, 2, 600_000))
            clock.advance_ms(51)
            svc.wake()
            out.append((await asyncio.wait_for(again, TIMEOUT)).result.uid)
            await asyncio.wait_for(svc.close(), TIMEOUT)   # no re-raise
            return out

        return asyncio.run(drive())

    assert _both(scenario) == [1, 2]


@pytest.mark.asyncio
def test_inline_flush_backend_error_comes_back_as_failed_future():
    def scenario(p):
        async def drive():
            async with p.aio.AsyncEcoreService(
                    _pool_policy(p),
                    lambda d: _Stub(p, d.backend, 2, fail=True)) as svc:
                f0 = svc.submit_nowait(_req(p, 0, 64))
                f1 = svc.submit_nowait(_req(p, 1, 64))   # inline boom
                out = []
                for f in (f1, f0):
                    with pytest.raises(RuntimeError,
                                       match="backend exploded"):
                        await asyncio.wait_for(f, TIMEOUT)
                    out.append(f.done())
                return out

        return asyncio.run(drive())

    assert _both(scenario) == [True, True]


@pytest.mark.asyncio
def test_async_observe_closes_the_loop():
    def scenario(p):
        async def drive():
            async with p.aio.AsyncEcoreService(
                    _pool_policy(p, alpha=0.3, flat=True),
                    lambda d: _Stub(p, d.backend, 1)) as svc:
                first = await asyncio.wait_for(svc.submit(_req(p, 0, 100)),
                                               TIMEOUT)
                for _ in range(30):     # 'small' measured far costlier
                    svc.observe(p.policy.Observation(pair=("small", "pod"),
                                                     energy_mwh=50.0))
                second = await asyncio.wait_for(svc.submit(_req(p, 1, 100)),
                                                TIMEOUT)
                return [first.decision.backend, second.decision.backend]

        return asyncio.run(drive())

    assert _both(scenario) == ["small", "big"]


@pytest.mark.asyncio
@pytest.mark.parametrize("how", ["close", "aexit"])
def test_closed_facade_fails_submits_structured(how):
    def scenario(p):
        async def drive():
            svc = p.aio.AsyncEcoreService(_pool_policy(p),
                                          lambda d: _Stub(p, d.backend, 1))
            if how == "aexit":
                async with svc:
                    first = await asyncio.wait_for(
                        svc.submit(_req(p, 0, 64)), TIMEOUT)
            else:
                first = await asyncio.wait_for(svc.submit(_req(p, 0, 64)),
                                               TIMEOUT)
                await asyncio.wait_for(svc.close(), TIMEOUT)
                await asyncio.wait_for(svc.close(), TIMEOUT)  # idempotent
            with pytest.raises(p.service.ServiceClosed):
                await asyncio.wait_for(svc.submit(_req(p, 1, 64)), TIMEOUT)
            return first.result.uid

        return asyncio.run(drive())

    assert _both(scenario) == 0


# -------------------------------------------------------------- faults

@pytest.mark.parametrize("seed", [0, 3, 5, 7])
@pytest.mark.parametrize("kind", ["error", "stall", "corrupt"])
def test_fault_spec_fires_on_the_jax_uids(kind, seed):
    uids = range(3000)
    for rate in (0.0, 0.05, 0.3, 0.4, 1.0):
        want = [jax_faults.FaultSpec(kind, rate=rate, seed=seed).fires(u)
                for u in uids]
        got = [faults.FaultSpec(kind, rate=rate, seed=seed).fires(u)
               for u in uids]
        assert got == want
    assert 0 < sum(got) < len(got) or rate in (0.0, 1.0)


@pytest.mark.parametrize("window", [(10, 20), (5, None), (0, 0)])
def test_crash_window_and_spec_checks_equal_jax(window):
    start, end = window
    want = jax_faults.FaultSpec("crash_window", start=start, end=end)
    got = faults.FaultSpec("crash_window", start=start, end=end)
    assert [got.fires(u) for u in range(40)] == \
        [want.fires(u) for u in range(40)]
    assert faults.FAULT_KINDS == jax_faults.FAULT_KINDS
    for bad, match in ((dict(kind="meteor"), "unknown fault kind"),
                       (dict(kind="error", rate=1.5), "probability")):
        with pytest.raises(ValueError, match=match):
            faults.FaultSpec(**bad)


def _fault_trace(p):
    specs = [p.faults.FaultSpec("stall", rate=0.5, seed=1, stall_ms=500.0),
             p.faults.FaultSpec("corrupt", rate=0.3, seed=2)]
    fb = p.faults.FaultyBackend(_Stub(p, max_batch=8), specs)
    reqs = [p.engine.Request(uid=u, prompt=np.zeros(4)) for u in range(40)]
    out = []
    for i in range(0, 40, 8):
        out += [(r.uid, r.time_ms, r.tokens.tolist(), r.detections)
                for r in fb.serve_batch(reqs[i:i + 8])]
    err = p.faults.FaultyBackend(_Stub(p), [
        p.faults.FaultSpec("error", rate=0.5, seed=4),
        p.faults.FaultSpec("crash_window", start=30, end=33)])
    raised = []
    for i in range(0, 40, 4):
        try:
            err.serve_batch(reqs[i:i + 4])
            raised.append(None)
        except p.faults.InjectedFault as exc:
            raised.append((exc.kind, exc.uid, str(exc)))
    return out, fb.injected, raised, err.injected, fb.profile_row()


def test_faulty_backend_rewrites_results_like_jax():
    out, injected, raised, err_injected, row = _fault_trace(PKGS["torch"])
    jout, jinjected, jraised, jerr_injected, jrow = _fault_trace(PKGS["jax"])
    assert [o[:1] + o[2:] for o in out] == [o[:1] + o[2:] for o in jout]
    np.testing.assert_array_equal([o[1] for o in out], [o[1] for o in jout])
    assert injected == jinjected and injected["corrupt"] > 0
    assert raised == jraised and err_injected == jerr_injected
    assert row == jrow == {"kind": "stub", "model": "stub", "max_batch": 8,
                           "faults": ["stall", "corrupt"]}


def test_make_backend_faulty_prefix_equals_jax():
    kw = dict(max_batch=2, faults=[faults.FaultSpec("error", rate=1.0)])
    fb = backend.make_backend("faulty:detector", "yolov8_n", "pi5_tpu",
                              run_fn=backend.null_run, device="cpu", **kw)
    jfb = jax_backend.make_backend(
        "faulty:detector", "yolov8_n", "pi5_tpu", max_batch=2,
        run_fn=jax_backend.null_run,
        faults=[jax_faults.FaultSpec("error", rate=1.0)])
    assert (fb.name, fb.max_batch, fb.profile_row()) == \
        (jfb.name, jfb.max_batch, jfb.profile_row())
    with pytest.raises(faults.InjectedFault):
        fb.serve_batch([engine.Request(uid=0, prompt=np.zeros((4, 4)))])
    clean = backend.make_backend("faulty:detector", "yolov8_n", "pi5_tpu",
                                 max_batch=2, run_fn=backend.null_run,
                                 device="cpu")
    res = clean.serve_batch([engine.Request(uid=0,
                                            prompt=np.zeros((4, 4)))])[0]
    assert np.isfinite(res.time_ms) and clean.profile_row()["faults"] == []


@pytest.mark.parametrize("jitter,mult", [(0.5, 2.0), (0.0, 3.0), (1.0, 1.5)])
def test_retry_delay_equals_jax(jitter, mult):
    kw = dict(backoff_ms=10.0, backoff_mult=mult, jitter=jitter)
    got, want = resilience.RetryPolicy(**kw), jax_resilience.RetryPolicy(**kw)
    for uid in (0, 1, 42, 43, 7, 10 ** 6):
        for attempt in (1, 2, 3, 5):
            assert got.delay_s(uid, attempt) == want.delay_s(uid, attempt)


# ---------------------------------------------------------- resilience

def _storm(p, n, device="orin_nano"):
    """error + stall + crash window on one device, uid-deterministic (the
    storm of ``tests/test_faults.py``)."""
    return {device: [
        p.faults.FaultSpec("error", rate=0.4, seed=3),
        p.faults.FaultSpec("stall", rate=0.3, seed=5, stall_ms=10_000.0),
        p.faults.FaultSpec("crash_window", start=n // 2,
                           end=n // 2 + n // 5)]}


class _Seen:
    """Counts each uid's appearances in serve_batch calls: its attempts."""

    def __init__(self, inner, seen):
        self.inner, self.seen = inner, seen
        self.name, self.max_batch = inner.name, inner.max_batch

    def serve_batch(self, requests):
        for r in requests:
            self.seen[r.uid] = self.seen.get(r.uid, 0) + 1
        return self.inner.serve_batch(requests)

    def profile_row(self):
        return self.inner.profile_row()


def _factory(p, faults_by_device, seen):
    kw = {} if p is PKGS["jax"] else {"device": "cpu"}

    def factory(decision):
        model, device = decision.pair
        return _Seen(p.backend.make_backend(
            "faulty:detector", model, device, max_batch=4,
            run_fn=p.backend.null_run,
            faults=faults_by_device.get(device, []), **kw), seen)
    return factory


def _policy(p, delta=2.0):
    kw = {} if p is PKGS["jax"] else {"device": "cpu"}
    table = p.devices.nominal_profile_table(**kw)
    return p.policy.DetectionPolicy(p.router.OracleRouter(table, delta),
                                    table)


def _reqs(p, n, seed=1):
    rng = np.random.default_rng(seed)
    return [p.policy.RouteRequest(uid=u, payload=np.zeros((4, 4), np.float32),
                                  true_complexity=int(rng.integers(1, 20)))
            for u in range(n)]


def _outcomes(futs, seen, deadline=None):
    """Per uid: (served pair, attempts, exception type, within deadline)."""
    out = []
    for f in futs:
        exc = f.exception(timeout=TIMEOUT)
        uid = (exc.uid if exc is not None and hasattr(exc, "uid")
               else None if exc is not None else f.result().request.uid)
        pair = None if exc is not None else f.result().decision.pair
        t = None if exc is not None else f.result().result.time_ms
        ok = (t is not None and np.isfinite(t)
              and (deadline is None or t <= deadline))
        out.append((uid, pair, seen.get(uid, 0),
                    None if exc is None else type(exc).__name__, ok))
    return out


def _resilient_run(p, n, faults_by_device, retry, jump_s=None):
    seen = {}
    fake = [0.0]
    svc = p.resilience.ResilientService(
        _policy(p), _factory(p, faults_by_device, seen),
        clock=lambda: fake[0], retry=retry)
    futs = [svc.submit(r) for r in _reqs(p, n)]
    if jump_s is not None:
        fake[0] = jump_s
    svc.drain()
    outcomes = _outcomes(futs, seen, retry.deadline_ms)
    stats = svc.stats()
    svc.close()
    causes = [type(f.exception().__cause__).__name__ if f.exception()
              else None for f in futs]
    stats.pop("inner")
    return outcomes, stats, causes


@pytest.mark.threads
def test_storm_outcomes_equal_jax_and_the_bare_service_fails():
    """The fault storm: every uid's outcome (served pair, attempts,
    exception type) and the retry counters equal the JAX resilient
    service's; goodput under the deadline is >= 0.99 resilient and < 0.5
    bare."""
    n, deadline = 400, 500.0

    def scenario(p):
        retry = p.resilience.RetryPolicy(deadline_ms=deadline, max_retries=3)
        outcomes, stats, _ = _resilient_run(p, n, _storm(p, n), retry)
        seen = {}
        bare = p.service.EcoreService(
            _policy(p), _factory(p, _storm(p, n), seen), clock=lambda: 0.0,
            retain_results=False, buffer_errors=False)
        futs, inline = [], 0
        for r in _reqs(p, n):
            try:
                futs.append(bare.submit(r))
            except p.faults.InjectedFault:
                inline += 1
        try:
            bare.drain()
        except p.faults.InjectedFault:   # a partial batch's error, re-raised
            inline += 1
        bare.close()
        bare_ok = sum(o[-1] for o in _outcomes(futs, seen, deadline))
        return outcomes, stats, bare_ok, inline

    outcomes, stats, bare_ok, inline = _both(scenario)
    goodput = sum(o[-1] for o in outcomes) / n
    assert goodput >= 0.99 and stats["failed"] == 0
    assert stats["retries"] > 0 and stats["hedges"] > 0
    assert bare_ok / n < 0.5 and inline > 0
    assert max(o[2] for o in outcomes) > 1


def _single(p, fault_for, retry_kw, jump_s=None):
    pol = _policy(p)
    favorite = pol.decide(_reqs(p, 1)[0]).pair
    if fault_for == "all":
        devs = {e.device for e in pol.table.entries}
        faults_by_device = {d: [p.faults.FaultSpec("error", rate=1.0)]
                            for d in devs}
    else:
        faults_by_device = {favorite[1]: [fault_for(p)]}
    outcomes, stats, causes = _resilient_run(
        p, 1, faults_by_device, p.resilience.RetryPolicy(**retry_kw), jump_s)
    runner_up = p.router.runner_up_route(
        int(_reqs(p, 1)[0].true_complexity), pol.table, pol.router.delta,
        exclude=[favorite])
    return favorite, runner_up.pair, outcomes, stats, causes


SINGLE = {
    "hedge": (lambda p: p.faults.FaultSpec("error", rate=1.0),
              dict(max_retries=2), None),
    "exhausted": ("all", dict(max_retries=2), None),
    "stall": (lambda p: p.faults.FaultSpec("stall", rate=1.0,
                                           stall_ms=10_000.0),
              dict(deadline_ms=500.0, max_retries=2), None),
    "corrupt": (lambda p: p.faults.FaultSpec("corrupt", rate=1.0),
                dict(max_retries=2), None),
    "wall_clock": ("all", dict(deadline_ms=500.0, max_retries=5), 10.0),
}


@pytest.mark.threads
@pytest.mark.parametrize("case", list(SINGLE))
def test_recovery_moves_equal_jax(case):
    """One request through each recovery move: the hedge lands on
    Algorithm 1's runner-up, an exhausted budget fails with the last
    failure chained, a stall past the deadline and a corrupt answer are
    retried elsewhere, and a deadline passed on the clock stops retry
    scheduling."""
    fault_for, retry_kw, jump = SINGLE[case]
    favorite, runner_up, outcomes, stats, causes = _both(
        lambda p: _single(p, fault_for, retry_kw, jump))
    (_, pair, attempts, exc, ok), = outcomes
    if case in ("hedge", "stall", "corrupt"):
        assert exc is None and pair != favorite and ok
        assert stats["retries"] >= 1
    if case == "hedge":
        assert pair == runner_up and stats["hedges"] >= 1
    if case == "stall":
        assert stats["deadline_misses"] >= 1
    if case == "exhausted":
        assert (exc, attempts, causes) == ("RetriesExhausted", 3,
                                           ["InjectedFault"])
    if case == "wall_clock":
        assert exc == "RetriesExhausted" and attempts < 6
        assert causes == ["DeadlineExceeded"]


@pytest.mark.threads
def test_resilient_close_is_idempotent_and_structured():
    def scenario(p):
        seen = {}
        make = lambda: p.resilience.ResilientService(
            _policy(p), _factory(p, {}, seen), clock=lambda: 0.0)
        svc = make()
        fut = svc.submit(_reqs(p, 1)[0])
        svc.close()
        out = [fut.result(timeout=TIMEOUT).result.time_ms is not None]
        svc.close()
        with pytest.raises(p.service.ServiceClosed):
            svc.submit(_reqs(p, 1)[0])
        with make() as ctx:
            futs = ctx.submit_batch(_reqs(p, 3))
        out.append([f.result(TIMEOUT).request.uid for f in futs])
        with pytest.raises(p.service.ServiceClosed):
            ctx.submit(_reqs(p, 1)[0])
        return out

    assert _both(scenario) == [True, [0, 1, 2]]
