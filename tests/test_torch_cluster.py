"""The port's cluster plane (shard selection, ``EcoreCluster``,
``Autoscaler``) and its thread-safe kernel launch counters, against the
JAX package's, on the CPU.

Shard picks are held bit-equal to both packages' scalar references and to
the JAX package's jitted ``select_pods``.  Each cluster scenario runs once
through each package with the stubs of ``tests/test_cluster.py`` and
``tests/test_traffic.py`` and returns a trace: per-uid pod, pair, backend
and batch size, and the ``stats()`` keys that do not depend on the wall
clock; the traces must be equal.  The degradation scenario resolves its
threaded futures in any order, so each package is held to the JAX test's
bounds instead (at most ``pod_fail_after - 1`` failures); so is the
all-pods-dead scenario (each uid fails with one of two errors).
"""
import functools
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch
from _propcheck import given, settings, st

from repro.core import policy as jax_policy
from repro.core import estimators as jax_est
from repro.core import profiles as jax_profiles
from repro.core import router as jax_router
from repro.detection import devices as jax_devices
from repro.detection import scenes as jax_scenes
from repro.serving import backend as jax_backend
from repro.serving import cluster as jax_cluster
from repro.serving import engine as jax_engine
from repro.serving import pool as jax_pool
from repro_torch.core import estimators, policy, profiles, router
from repro_torch.detection import devices
from repro_torch.kernels import _build
from repro_torch.kernels.canny_fused import ops as canny_ops
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rglru_scan import ops as lru_ops
from repro_torch.kernels.sobel import ops as sobel_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.serving import backend, cluster, engine, pool

torch.set_num_threads(1)

TIMEOUT = 10.0
MODES = ("least_loaded", "rendezvous")

PKGS = {
    "jax": types.SimpleNamespace(
        policy=jax_policy, router=jax_router, est=jax_est, engine=jax_engine,
        pool=jax_pool, backend=jax_backend, cluster=jax_cluster,
        Cluster=jax_cluster.EcoreCluster, table=jax_profiles.ProfileTable,
        nominal=jax_devices.nominal_profile_table, kw={}),
    "torch": types.SimpleNamespace(
        policy=policy, router=router, est=estimators, engine=engine, pool=pool,
        backend=backend, cluster=cluster,
        Cluster=functools.partial(cluster.EcoreCluster, device="cpu"),
        table=lambda entries: profiles.ProfileTable(entries, device="cpu"),
        nominal=functools.partial(devices.nominal_profile_table,
                                  device="cpu"),
        kw={"device": "cpu"}),
}


def _both(scenario, *args):
    """Run ``scenario`` through both packages; the traces must agree."""
    want = scenario(PKGS["jax"], *args)
    got = scenario(PKGS["torch"], *args)
    assert got == want
    return got


# --------------------------------------------------- shard-selection parity

def _picks_all(uids, depths, mode, alive=None):
    """The port's picks on the CPU, after checking them against both
    scalar references."""
    got = cluster.select_pods(uids, depths, mode, alive, device="cpu")
    assert got.dtype == np.int64
    np.testing.assert_array_equal(
        got, cluster.select_pods_reference(uids, depths, mode, alive))
    np.testing.assert_array_equal(
        got, jax_cluster.select_pods_reference(uids, depths, mode, alive))
    return got


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("pods,n,dead", [
    (1, 5, None), (2, 64, None), (2, 64, 0), (4, 2048, None), (4, 2048, 1),
    (6, 2048, None), (6, 2048, 1), (7, 64, None), (7, 64, 0), (7, 64, 6)])
def test_select_pods_bit_equal_to_both_packages(mode, pods, n, dead):
    """bench_cluster's 2048 uids among them; the JAX package's jitted
    selection gives the same picks."""
    rng = np.random.default_rng(1)
    uids = rng.integers(0, 2**31, size=n)
    depths = rng.integers(0, 9, size=pods)
    alive = None
    if dead is not None:
        alive = np.ones(pods, bool)
        alive[dead] = False
    got = _picks_all(uids, depths, mode, alive)
    np.testing.assert_array_equal(
        got, np.asarray(jax_cluster.select_pods(uids, depths, mode, alive)))
    if alive is not None:
        assert alive[got].all()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("pods", [2, 3, 4, 6])
def test_select_pods_all_dead_equal_to_both_packages(mode, pods):
    """Every pod masked: the picks are the references' and the JAX
    package's jitted selection's (all 0, the first minimum or maximum)."""
    rng = np.random.default_rng(pods)
    uids = rng.integers(0, 2**31, size=64)
    depths = rng.integers(0, 9, size=pods)
    alive = np.zeros(pods, bool)
    got = _picks_all(uids, depths, mode, alive)
    np.testing.assert_array_equal(
        got, np.asarray(jax_cluster.select_pods(uids, depths, mode, alive)))
    np.testing.assert_array_equal(got, np.zeros(len(uids), np.int64))


@settings(max_examples=80, deadline=None)
@given(uids=st.lists(st.integers(0, 2**32 - 1), min_size=1, max_size=24),
       repeat=st.integers(1, 3),
       depths=st.lists(st.integers(0, 20), min_size=1, max_size=7),
       dead=st.lists(st.integers(0, 6), min_size=0, max_size=3),
       mode_idx=st.integers(0, 1))
def test_select_pods_parity_property(uids, repeat, depths, dead, mode_idx):
    """Any uids (duplicates included), depths, pod counts and masks."""
    uids = (uids * repeat)[:48]
    alive = np.ones(len(depths), bool)
    alive[[d for d in dead if d < len(depths)]] = False
    if not alive.any():
        alive[-1] = True
    _picks_all(uids, depths, MODES[mode_idx], alive)
    _picks_all(uids, depths, MODES[mode_idx])


@pytest.mark.parametrize("seed", range(6))
def test_closed_form_least_loaded_is_the_sequential_greedy(seed):
    """The sort over (level, pod) slots picks what one argmin per uid over
    the running depths picks, ties to the lowest pod index."""
    rng = np.random.default_rng(seed)
    pods = int(rng.integers(1, 9))
    depths = rng.integers(-3, 40, size=pods) * int(rng.integers(0, 3))
    alive = rng.random(pods) < 0.7
    alive[rng.integers(pods)] = True
    n = int(rng.integers(1, 300))
    running, want = depths.astype(int).tolist(), []
    for _ in range(n):
        p = min((p for p in range(pods) if alive[p]),
                key=lambda p: (running[p], p))
        running[p] += 1
        want.append(p)
    got = cluster.select_pods(np.arange(n), depths, "least_loaded", alive,
                              device="cpu")
    assert got.tolist() == want


def test_select_pods_shapes_and_errors():
    assert cluster.select_pods([], [0, 0], device="cpu").shape == (0,)
    assert cluster.select_pods(np.arange(8), np.zeros(4, int),
                               device="cpu").tolist() == [0, 1, 2, 3] * 2
    assert cluster.select_pods(np.arange(3), [2, 0, 1],
                               device="cpu").tolist() == [1, 1, 2]
    for fn in (functools.partial(cluster.select_pods, device="cpu"),
               cluster.select_pods_reference):
        with pytest.raises(ValueError, match="unknown shard mode"):
            fn([1], [0, 0], "hash_ring")


def test_rendezvous_stable_and_spread():
    uids = np.arange(256)
    first = _picks_all(uids, np.zeros(4, int), "rendezvous")
    np.testing.assert_array_equal(
        first, _picks_all(uids, np.full(4, 7), "rendezvous"))
    assert (np.bincount(first, minlength=4) > 32).all()
    three = _picks_all(uids, np.zeros(3, int), "rendezvous")
    assert (three != first).mean() < 0.5


def test_default_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU, so the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cluster.select_pods([1], [0, 0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cluster.EcoreCluster(lambda i: None, lambda d: None)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: this test runs the shard "
                    "selection on the card, and this machine has no GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("pods", [4, 6])
@pytest.mark.parametrize("dead", [None, 1])
def test_select_pods_on_the_card_equals_reference(cuda, mode, pods, dead):
    uids = np.random.default_rng(1).integers(0, 2**31, size=2048)
    depths = np.random.default_rng(pods).integers(0, 9, size=pods)
    alive = None if dead is None else np.arange(pods) != dead
    np.testing.assert_array_equal(
        cluster.select_pods(uids, depths, mode, alive, device=cuda),
        cluster.select_pods_reference(uids, depths, mode, alive))


# ---------------------------------------------------- launch counters

@pytest.mark.threads
@pytest.mark.parametrize("ops", [canny_ops, sobel_ops, flash_ops, decode_ops,
                                 ssd_ops, lru_ops],
                         ids=lambda m: m.__name__.split(".")[-2])
def test_launch_counter_exact_under_8_threads(ops):
    """Pods launch the Canny kernel from their own threads: a count bumped
    from 8 threads at a short switch interval reads the exact total."""
    saved, interval = ops.launches, sys.getswitchinterval()
    per_thread, threads = 5000, 8
    ops.launches = 0
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [
            _build.count_launch(ops.__name__) for _ in range(per_thread)])
            for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(TIMEOUT)
        assert not any(w.is_alive() for w in workers)
        assert ops.launches == per_thread * threads
    finally:
        sys.setswitchinterval(interval)
        ops.launches = saved


# ------------------------------------------------------------ cluster plane

class _Stub:
    """A backend answering instantly; ``fail`` makes it raise."""

    def __init__(self, p, name="stub", max_batch=4, fail=False):
        self.p, self.name, self.max_batch, self.fail = p, name, max_batch, fail

    def serve_batch(self, requests):
        if self.fail:
            raise RuntimeError("backend exploded")
        return [self.p.engine.Result(
            uid=r.uid, tokens=np.asarray([r.uid], np.int32), prefill_s=.01,
            decode_s=.01, backend=self.name, batch_size=len(requests))
            for r in requests]

    def profile_row(self):
        return {"kind": "stub", "model": self.name,
                "max_batch": self.max_batch}


def _pool_policy(p, alpha=0.1, pools=None):
    entries = [(a, "pod", b, score - drop * b, 1.0, energy)
               for a, score, drop, energy in (("small", 80.0, 3.0, 1.0),
                                              ("big", 84.0, 1.0, 5.0))
               for _, _, b in p.pool.LENGTH_BUCKETS]
    entry = (jax_profiles.ProfileEntry if p is PKGS["jax"]
             else profiles.ProfileEntry)
    sp = p.pool.ServingPool(p.table([entry(*e) for e in entries]), delta=5.0)
    if pools is not None:
        pools.append(sp)
    return p.policy.PoolPolicy(sp, alpha=alpha)


def _req(p, uid, plen=64):
    return p.policy.RouteRequest(uid=uid, complexity=plen,
                                 payload=np.arange(8), max_new_tokens=4)


STATS = ("pods", "max_pods", "retired", "shard_mode", "shard_counts",
         "backends", "serve_calls", "served", "deadline_flushes",
         "stale_observations", "alive", "availability", "resubmitted")


def _stats(c):
    s = c.stats()
    return {k: s[k] for k in STATS}


def _served(cl, futs):
    """Per uid: (pod, pair, backend, batch size)."""
    out = {}
    for f in futs:
        s = f.result(timeout=TIMEOUT)
        out[s.request.uid] = (cl.owner_of(s.request.uid), s.decision.pair,
                              s.result.backend, s.result.batch_size)
    return out


@pytest.mark.threads
@pytest.mark.parametrize("shard", MODES)
@pytest.mark.parametrize("max_batch", [1, 2, 8])
def test_batch_and_scalar_sharding_equal_jax(shard, max_batch):
    """``submit_batch`` (selection on the device) and per-request
    ``submit`` (the scalar reference) over mixed prompt lengths."""
    def scenario(p):
        out = []
        for batched in (True, False):
            with p.Cluster(lambda i: _pool_policy(p),
                           lambda d: _Stub(p, d.backend, max_batch),
                           pods=3, shard=shard) as cl:
                reqs = [_req(p, u, (64, 900, 5000)[u % 3]) for u in range(13)]
                futs = (cl.submit_batch(reqs) if batched
                        else [cl.submit(r) for r in reqs])
                cl.drain()
                out += [_served(cl, futs), _stats(cl), cl.queue_depths()]
        return out

    trace = _both(scenario)
    assert sum(trace[1]["shard_counts"]) == 13
    if shard == "rendezvous":    # assignment depends on the uid alone
        assert ({u: v[0] for u, v in trace[0].items()}
                == {u: v[0] for u, v in trace[3].items()})
    assert trace[2] == trace[5] == [0, 0, 0]


def test_observe_folds_into_owning_pod_equal_jax():
    def scenario(p):
        pools = []
        with p.Cluster(lambda i: _pool_policy(p, alpha=1.0, pools=pools),
                       lambda d: _Stub(p, d.backend, 8), pods=2) as cl:
            f0, f1 = cl.submit(_req(p, 0)), cl.submit(_req(p, 1))
            cl.drain()
            out = [f0.result(TIMEOUT).request.uid,
                   f1.result(TIMEOUT).request.uid, cl.owner_of(0),
                   cl.owner_of(1)]
            energy = lambda: [sp.table.entry(("small", "pod"), 0).energy_mwh
                              for sp in pools]
            Obs = p.policy.Observation
            cl.observe(Obs(pair=("small", "pod"), uid=1, energy_mwh=99.0))
            out.append(energy())
            cl.observe(Obs(pair=("small", "pod"), energy_mwh=50.0))
            out.append(energy())
            cl.observe(Obs(pair=("small", "pod"), uid=999, energy_mwh=1e-3))
            out += [energy(), _stats(cl)]
        return out

    trace = _both(scenario)
    assert trace[2:4] == [0, 1]
    assert trace[4] == [1.0, 99.0] and trace[5] == trace[6] == [50.0, 50.0]
    assert trace[7]["stale_observations"] == 1


def test_submit_errors_do_not_leak_depth_equal_jax():
    def scenario(p):
        out = []
        with p.Cluster(lambda i: _pool_policy(p),
                       lambda d: _Stub(p, d.backend, 1, fail=True),
                       pods=2) as cl:
            with pytest.raises(RuntimeError, match="backend exploded"):
                cl.submit(_req(p, 0))
            out.append(cl.queue_depths())
            with pytest.raises(RuntimeError, match="backend exploded"):
                cl.submit_batch([_req(p, u) for u in range(1, 5)])
            out += [cl.queue_depths(), _stats(cl)]
        return out

    assert _both(scenario)[:2] == [[0, 0], [0, 0]]


def test_drain_flushes_partial_batches_equal_jax():
    def scenario(p):
        with p.Cluster(lambda i: _pool_policy(p),
                       lambda d: _Stub(p, d.backend, 8), pods=2) as cl:
            futs = cl.submit_batch([_req(p, u) for u in range(5)])
            pending = [f.done() for f in futs]
            drained = sorted(s.request.uid for s in cl.drain())
            return [pending, drained, [f.done() for f in futs],
                    _served(cl, futs), _stats(cl)]

    trace = _both(scenario)
    assert trace[0] == [False] * 5 and trace[1] == list(range(5))


def test_cluster_validation_equal_jax():
    def scenario(p):
        out = []
        for kw in ({"pods": 0}, {"shard": "hash_ring"},
                   {"pods": 4, "max_pods": 2}):
            with pytest.raises(ValueError) as e:
                p.Cluster(lambda i: _pool_policy(p), lambda d: None, **kw)
            out.append(str(e.value))
        return out

    _both(scenario)


class _Pinned:
    """Per-pod policy routing everything to ONE pair; the model names the
    pod, so a Served's backend says who served it."""
    batchable = True

    def __init__(self, p, pair):
        self.p, self.pair, self.observed = p, pair, []

    def decide(self, req):
        return self.p.policy.RouteDecision(uid=req.uid, pair=self.pair,
                                           group=0)

    def decide_batch(self, reqs):
        return [self.decide(r) for r in reqs]

    def observe(self, obs):
        self.observed.append(obs)


def test_masked_pod_takes_no_new_work_equal_jax():
    def scenario(p):
        with p.Cluster(lambda i: _pool_policy(p),
                       lambda d: _Stub(p, d.backend, 1), pods=2) as cl:
            cl.mark_pod_failed(0)
            futs = cl.submit_batch([_req(p, u) for u in range(6)])
            cl.drain()
            return [_served(cl, futs), _stats(cl)]

    trace = _both(scenario)
    assert trace[1]["alive"] == [False, True]
    assert trace[1]["availability"] == 0.5
    assert trace[1]["shard_counts"] == [0, 6]


@pytest.mark.threads
@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_failed_pod_masked_and_requests_resubmitted(pkg):
    """Pod 0's device dies: after ``pod_fail_after`` consecutive errors it
    is masked out, its failed requests move to survivors, and uid-keyed
    observations fold into the pod that served (the JAX test's bounds)."""
    p = PKGS[pkg]
    n, fail_after = 40, 2
    pols = [_Pinned(p, (f"m{i}", "dead" if i == 0 else "ok"))
            for i in range(3)]
    cl = p.Cluster(lambda i: pols[i],
                   lambda d: _Stub(p, d.backend, 1,
                                   fail=d.pair[1] == "dead"),
                   pods=3, pod_fail_after=fail_after)
    futs = cl.submit_batch([_req(p, u) for u in range(n)])
    cl.drain()
    served = [f.result(TIMEOUT) for f in futs
              if f.exception(TIMEOUT) is None]
    stats = cl.stats()
    assert len(served) >= n - (fail_after - 1)
    assert stats["alive"] == [False, True, True]
    assert stats["availability"] == pytest.approx(2 / 3)
    assert stats["resubmitted"] >= 1
    assert not any(s.result.backend == "m0" for s in served)
    for s in served:
        cl.observe(p.policy.Observation(pair=s.decision.pair,
                                        uid=s.request.uid, time_ms=1.0))
    assert cl.stats()["stale_observations"] == 0
    assert not pols[0].observed
    for i in (1, 2):
        assert ({o.uid for o in pols[i].observed}
                == {s.request.uid for s in served
                    if s.result.backend == f"m{i}"})
    cl.close()


@pytest.mark.threads
def test_all_pods_dead_raises_no_live_pods_equal_jax():
    """Which error a uid gets depends on whether its resubmission (an
    executor thread) ran before the other pod was masked (the submitting
    thread), so each package is held to what both guarantee: every uid
    fails with the backend's ``RuntimeError`` or ``NoLivePods``, both pods
    end dead, availability 0, and a later submit raises ``NoLivePods``."""
    def scenario(p):
        cl = p.Cluster(lambda i: _Pinned(p, (f"m{i}", "dead")),
                       lambda d: _Stub(p, d.backend, 1, fail=True),
                       pods=2, pod_fail_after=1)
        futs = cl.submit_batch([_req(p, u) for u in range(6)])
        cl.drain()
        outcomes = [type(f.exception(TIMEOUT)).__name__ for f in futs]
        stats = _stats(cl)
        with pytest.raises(p.cluster.NoLivePods):
            cl.submit(_req(p, 100))
        cl.close()
        return outcomes, {k: stats[k] for k in (
            "pods", "max_pods", "retired", "shard_mode", "alive",
            "availability")}

    traces = {pkg: scenario(PKGS[pkg]) for pkg in PKGS}
    for outcomes, stats in traces.values():
        assert len(outcomes) == 6
        assert set(outcomes) <= {"RuntimeError", "NoLivePods"}
        assert stats["alive"] == [False, False]
        assert stats["availability"] == 0.0
    assert traces["torch"][1] == traces["jax"][1]


# ------------------------------------------------------ fleet elasticity

def _detection_cluster(p, clock, pods=2, max_pods=4, **kw):
    """``tests/test_traffic.py``'s cluster: oracle routing at δ = 5 over
    null detector backends, on a manual clock without flusher threads."""
    def policy_for(i):
        table = p.nominal()
        return p.policy.DetectionPolicy(p.router.OracleRouter(table, 5.0),
                                        table)

    def factory(d):
        return p.backend.make_backend("detector", d.pair[0], d.pair[1], None,
                                      max_batch=4,
                                      run_fn=p.backend.null_run, **p.kw)
    return p.Cluster(policy_for, factory, pods=pods, max_pods=max_pods,
                     clock=clock, flusher=False, retain_results=False, **kw)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _det_req(p, uid, count=1):
    return p.policy.RouteRequest(uid=uid, payload=np.zeros((8, 8),
                                                           np.float32),
                                 true_complexity=count)


def test_retire_add_and_max_pods_equal_jax():
    def scenario(p):
        out = []
        cl = _detection_cluster(p, _Clock(), pods=3, max_pods=3)
        try:
            out += [cl.live_pods(), cl.retire_pod(), cl.live_pods(),
                    _stats(cl)["retired"], cl.can_add_pod(), cl.add_pod(),
                    cl.live_pods(), _stats(cl)["retired"], len(cl.pods),
                    cl.can_add_pod()]
            with pytest.raises(RuntimeError, match="max_pods"):
                cl.add_pod()
        finally:
            cl.close()
        cl = _detection_cluster(p, _Clock(), pods=2, max_pods=3)
        try:
            out += [cl.add_pod(), len(cl.pods), cl.can_add_pod()]
        finally:
            cl.close()
        return out

    assert _both(scenario) == [[0, 1, 2], 2, [0, 1], [2], True, 2,
                               [0, 1, 2], [], 3, False, 2, 3, False]


def test_never_retires_the_last_pod_and_retired_gets_no_work_equal_jax():
    def scenario(p):
        cl = _detection_cluster(p, _Clock(), pods=2, max_pods=2)
        try:
            cl.retire_pod(1)
            with pytest.raises(ValueError, match="last live pod"):
                cl.retire_pod()
            with pytest.raises(ValueError, match="not live"):
                cl.retire_pod(1)
            futs = [cl.submit(_det_req(p, u, u % 9)) for u in range(8)]
            cl.drain()
            return [[(f.result(TIMEOUT).request.uid,
                      f.result(TIMEOUT).decision.pair) for f in futs],
                    [cl.owner_of(u) for u in range(8)], _stats(cl)]
        finally:
            cl.close()

    trace = _both(scenario)
    assert trace[1] == [0] * 8 and trace[2]["shard_counts"] == [8, 0]


def test_autoscaler_events_equal_jax():
    """``tests/test_traffic.py``'s scale-up and scale-down scenario."""
    def scenario(p):
        clock = _Clock()
        cl = _detection_cluster(p, clock, pods=2, max_pods=4)
        auto = p.cluster.Autoscaler(cl, clock, min_pods=2, max_pods=4,
                                    high_backlog_per_pod=5.0,
                                    low_backlog_per_pod=1.0, cooldown_s=1.0)
        out = []
        try:
            for dt, backlog in ((0, 4), (0, 20), (0, 20), (1, 20), (1, 100),
                                (1, 0), (1, 0), (1, 0)):
                clock.t += dt
                out.append(auto.tick(backlog))
            out += [cl.live_pods(), auto.events]
            for kw in ({"high_backlog_per_pod": 2.0,
                        "low_backlog_per_pod": 2.0}, {"min_pods": 0}):
                with pytest.raises(ValueError) as e:
                    p.cluster.Autoscaler(cl, clock, **kw)
                out.append(str(e.value))
        finally:
            cl.close()
        return out

    trace = _both(scenario)
    assert trace[:8] == [None, "add", None, "add", None, "retire", "retire",
                         None]
    assert trace[8] == [0, 1]


@pytest.mark.threads
@pytest.mark.parametrize("shard", MODES)
def test_ed_pods_over_scenes_equal_jax(shard):
    """Phase 24's cluster at a small size: 4 pods, each ED and Algorithm 1
    (δ = 5), over 64 drifting scenes through ``submit_batch``; every uid's
    pod is the scalar reference's pick."""
    frames = [(s.image, s.count)
              for s in jax_scenes.drifting_dataset(64, seed=4)]

    def scenario(p):
        def policy_for(i):
            t = p.nominal()
            return p.policy.DetectionPolicy(
                p.router.GreedyEstimateRouter(t, 5.0), t,
                p.est.EdgeDetectionEstimator(**p.kw))

        def factory(d):
            return p.backend.make_backend(
                "detector", d.pair[0], d.pair[1], None, max_batch=8,
                run_fn=p.backend.null_run, **p.kw)

        with p.Cluster(policy_for, factory, pods=4, shard=shard) as cl:
            futs = cl.submit_batch([p.policy.RouteRequest(
                uid=u, payload=img, true_complexity=n)
                for u, (img, n) in enumerate(frames)])
            cl.drain()
            out = {}
            for f in futs:
                s = f.result(TIMEOUT)
                out[s.request.uid] = (cl.owner_of(s.request.uid),
                                      s.decision.pair,
                                      s.decision.est_complexity,
                                      s.result.batch_size)
            return [out, _stats(cl)]

    trace = _both(scenario)
    want = cluster.select_pods_reference(range(64), np.zeros(4, int), shard)
    assert [trace[0][u][0] for u in range(64)] == want.tolist()
    assert sum(trace[1]["shard_counts"]) == 64


def test_realtime_scale_equal_jax_and_occupies_the_wall_clock():
    """``realtime_scale`` sleeps for the modeled busy time (x scale) after
    serving; the results equal the JAX backend's, and the default 0.0
    serves the same results."""
    def scenario(p, scale):
        be = p.backend.DetectorBackend("ssd_v1", "orin_nano", None,
                                       max_batch=4, run_fn=p.backend.null_run,
                                       realtime_scale=scale, **p.kw)
        reqs = [p.engine.Request(uid=u, prompt=np.zeros((8, 8), np.float32))
                for u in range(4)]
        t0 = time.perf_counter()
        res = be.serve_batch(reqs)
        wall = time.perf_counter() - t0
        return ([(r.uid, r.time_ms, r.energy_mwh, r.batch_size, r.backend)
                 for r in res], wall)

    for scale in (0.0, 1.0):
        got, wall = scenario(PKGS["torch"], scale)
        want, _ = scenario(PKGS["jax"], scale)
        assert got == want
        assert wall >= sum(r[1] for r in got) / 1e3 * scale
