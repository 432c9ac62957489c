"""The port's traffic plane (arrivals, SLO sketches, tenants, the
``LoadDriver``) over its cluster, against the JAX package's, on the CPU.

Arrival streams, sketch quantiles, window records and autoscaler events
are held equal.  In a whole episode a cluster drain completes the pods'
last batches from several threads, so float sums (energy) may add up in
another order: there an integer must be exactly equal, and a float that
is not bit-equal is held to 1e-12 relative, the failure naming the
quantity that differs.  Everything rides the manual clock, no flusher
threads.
"""
import json
import math
import pathlib
import types

import numpy as np
import pytest
import torch
from _propcheck import given, settings, st

import repro.traffic as jax_tr
from repro.core import estimators as jax_est
from repro.core import policy as jax_policy
from repro.core import router as jax_router
from repro.detection import devices as jax_devices
from repro.detection import scenes as jax_scenes
from repro.detection.detectors import DETECTOR_CONFIGS as JAX_CONFIGS
from repro.serving import backend as jax_backend
from repro.serving import cluster as jax_cluster
import repro_torch.traffic as tr
from repro_torch.core import estimators, policy, router
from repro_torch.core.energy import mwh_to_joules
from repro_torch.detection import devices, scenes
from repro_torch.detection.detectors import params_from_jax
from repro_torch.serving import backend, cluster

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
PATTERNS = tuple(tr.ARRIVAL_PATTERNS)

PKGS = {
    "jax": types.SimpleNamespace(
        tr=jax_tr, policy=jax_policy, router=jax_router, est=jax_est,
        devices=jax_devices, scenes=jax_scenes, backend=jax_backend,
        cluster=jax_cluster, kw={}),
    "torch": types.SimpleNamespace(
        tr=tr, policy=policy, router=router, est=estimators,
        devices=devices, scenes=scenes, backend=backend, cluster=cluster,
        kw={"device": "cpu"}),
}


def assert_close(got, want, where="record"):
    """Integers, strings and structure equal; floats bit-equal or within
    1e-12 relative; the message names the quantity that differs."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), where
        for k in want:
            assert_close(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), f"{where}: length"
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, f"{where}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, float) and (
            got == want or math.isclose(got, want, rel_tol=1e-12,
                                        abs_tol=0.0)), \
            f"{where}: {got!r} != {want!r} beyond 1e-12 relative"
    else:
        assert type(got) is type(want) and got == want, \
            f"{where}: {got!r} != {want!r}"


# ------------------------------------------------------------- arrivals

@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("seed", [0, 3, 7, 11])
@pytest.mark.parametrize("t0", [0.0, 100.25])
def test_arrival_streams_bit_equal_to_jax(pattern, seed, t0):
    for rate, dur in ((20.0, 4.0), (401.0729503567944, 12.0)):
        got = tr.make_arrivals(pattern, rate, dur, seed=seed, t0=t0)
        want = jax_tr.make_arrivals(pattern, rate, dur, seed=seed, t0=t0)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_generator_knobs_and_errors_equal_jax():
    def trace(t):
        out = [t.flash_crowd_arrivals(10.0, 10.0, spike_hz=80.0,
                                      spike_start_s=4.0, spike_len_s=2.0,
                                      seed=5),
               t.diurnal_arrivals(30.0, 40.0, amplitude=0.9, period_s=10.0,
                                  phase=1.0, seed=2, t0=3.0),
               t.poisson_arrivals(0.0, 10.0), t.poisson_arrivals(5.0, 0.0)]
        errors = []
        for call in (lambda: t.make_arrivals("burst", 1.0, 1.0),
                     lambda: t.flash_crowd_arrivals(10.0, 10.0, spike_hz=5.0),
                     lambda: t.diurnal_arrivals(10.0, 10.0, amplitude=1.5)):
            with pytest.raises(ValueError) as e:
                call()
            errors.append(str(e.value))
        return [a.tobytes() for a in out], errors

    assert trace(tr) == trace(jax_tr)


def test_manual_clock_equal_jax():
    def trace(t):
        clock = t.ManualClock(5.0)
        out = [clock(), clock.advance(1.5), clock.advance_to(6.0),
               clock.advance_to(10.0)]
        with pytest.raises(ValueError):
            clock.advance(-0.1)
        return out

    assert trace(tr) == trace(jax_tr) == [5.0, 6.5, 6.5, 10.0]


# ------------------------------------------------------------ SLO plane

def _sketch_trace(t, values, split):
    a, b, whole = (t.LatencySketch(rel_err=0.01) for _ in range(3))
    for i, v in enumerate(values):
        (a if i < split else b).add(float(v))
        whole.add(float(v))
    merged = a.merge(b)
    qs = (0.0, 0.1, 0.5, 0.9, 0.95, 0.99, 1.0)
    return ([whole.quantile(q) for q in qs], [merged.quantile(q) for q in qs],
            whole.count, merged.count, whole.mean)


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**16), n=st.integers(1, 400),
       split=st.integers(0, 400))
def test_latency_sketch_quantiles_and_merges_equal_jax(seed, n, split):
    rng = np.random.default_rng(seed)
    values = np.concatenate([rng.lognormal(3.0, 1.2, n),
                             np.zeros(n // 7), np.full(n // 9, 5e-4)])
    got = _sketch_trace(tr, values, split)
    assert got == _sketch_trace(jax_tr, values, split)
    assert got[0] == got[1]


def test_latency_sketch_validation_equal_jax():
    def trace(t):
        out = []
        for call in (lambda: t.LatencySketch(rel_err=1.5),
                     lambda: t.LatencySketch().add(-1.0),
                     lambda: t.LatencySketch().add(float("nan")),
                     lambda: t.LatencySketch().quantile(1.5),
                     lambda: t.LatencySketch().merge(
                         t.LatencySketch(rel_err=0.05))):
            with pytest.raises(ValueError) as e:
                call()
            out.append(str(e.value))
        return out

    assert trace(tr) == trace(jax_tr)


def _slo_trace(t):
    slo = t.WindowedSLO(window_s=0.5)
    rng = np.random.default_rng(4)
    for uid in range(300):
        arr = float(rng.uniform(0, 5))
        start = arr + float(rng.exponential(0.05))
        done = start + float(rng.exponential(0.01))
        c = t.Completion(uid=uid, tenant=("cam", "llm")[uid % 2],
                         t_arrival=arr, t_start=start, t_done=done,
                         service_ms=(done - start) * 1e3,
                         energy_mwh=float(rng.uniform(0, 0.01)),
                         deadline_ms=(None, 60.0)[uid % 2],
                         ok=uid % 13 != 0, pod=uid % 3)
        slo.record(c)
    return (slo.window_records(), slo.summary(), c.queue_wait_ms, c.e2e_ms,
            c.within_deadline)


def test_windowed_slo_records_equal_jax():
    got = _slo_trace(tr)
    assert got == _slo_trace(jax_tr)
    recs, summary = got[0], got[1]
    assert sum(r["n"] for r in recs) == summary["completions"] == 300
    assert summary["failed"] == 24
    assert mwh_to_joules(1.0) == 3.6


# ------------------------------------------------------------- tenants

def _tenant_trace(p, scene_images):
    arr = np.linspace(0.0, 2.0, 40)
    det = p.tr.detector_tenant("cam", arr, seed=1, deadline_ms=80.0,
                               scene_images=scene_images)
    llm = p.tr.llm_tenant("llm", arr + 0.01, seed=2)
    merged = p.tr.merge_tenants([det, llm])
    return [(m.t, m.tenant, m.deadline_ms, m.request.uid,
             m.request.complexity, m.request.true_complexity,
             m.request.max_new_tokens,
             np.asarray(m.request.payload).tobytes()) for m in merged]


@pytest.mark.parametrize("scene_images", [False, True])
def test_tenants_equal_jax(scene_images):
    """Counts, uids and payloads (rendered scenes included)."""
    got = _tenant_trace(PKGS["torch"], scene_images)
    assert got == _tenant_trace(PKGS["jax"], scene_images)
    assert [g[3] for g in got] == list(range(80))


# ------------------------------------------- entry [9]: bench_load replay

def _load_settings(p):
    """bench_load's rate and deadline, from the nominal profile's mean
    service time over 256 draws of ``COUNT_PROBS`` (seed 0)."""
    rng = np.random.default_rng(0)
    table = p.devices.nominal_profile_table(**p.kw)
    mix = rng.choice(len(p.scenes.COUNT_PROBS), p=p.scenes.COUNT_PROBS,
                     size=256)
    mean_ms = float(np.mean([p.router.greedy_route(int(c), table,
                                                   5.0).time_ms
                             for c in mix]))
    return 0.5 * 2 * 1e3 / mean_ms, 4.0 * (20.0 + mean_ms)


def _load_episode(p, pattern, autoscale, duration_s=12.0):
    """One cell of bench_load: 2 pods (up to 6 with the autoscaler,
    watermarks 10 and 1, cooldown 0.5 s), oracle routing at δ = 5 over
    null detectors (max_batch 4), max_wait_ms 20, arrivals seed 7, tenant
    seed 1, 2 s windows."""
    steady_hz, deadline_ms = _load_settings(p)

    def policy_for(i):
        t = p.devices.nominal_profile_table(**p.kw)
        return p.policy.DetectionPolicy(p.router.OracleRouter(t, 5.0), t)

    def backend_for(d):
        return p.backend.make_backend("detector", d.pair[0], d.pair[1], None,
                                      max_batch=4, run_fn=p.backend.null_run,
                                      **p.kw)

    clock = p.tr.ManualClock()
    cl = p.cluster.EcoreCluster(policy_for, backend_for, pods=2, max_pods=6,
                                max_wait_ms=20.0, clock=clock,
                                retain_results=False, flusher=False, **p.kw)
    auto = p.cluster.Autoscaler(
        cl, clock, min_pods=2, max_pods=6, high_backlog_per_pod=10.0,
        low_backlog_per_pod=1.0, cooldown_s=0.5) if autoscale else None
    work = p.tr.merge_tenants([p.tr.detector_tenant(
        "cams", p.tr.make_arrivals(pattern, steady_hz, duration_s, seed=7),
        seed=1, deadline_ms=deadline_ms)])
    driver = p.tr.LoadDriver(cl, clock, autoscaler=auto, window_s=2.0)
    try:
        driver.run(work)
    finally:
        cl.close()
    return {"summary": driver.slo.summary(),
            "windows": driver.slo.window_records(),
            "autoscaler_events": auto.events if auto else [],
            "requests": len(work)}


#: entry [9]'s headline numbers: completions, goodput, p99 (ms)
ENTRY9 = {"poisson_fixed": (4858, 1.0, 26.6),
          "poisson_autoscaled": (4858, 1.0, 26.6),
          "flash_fixed": (7688, 0.3736, 6265.2),
          "flash_autoscaled": (7688, 0.6510, 3370.3)}


@pytest.mark.parametrize("cell", list(ENTRY9))
def test_entry9_replay_equal_jax_at_full_size(cell):
    """bench_load's four runs at full size (12 s virtual): the port's
    summary, window records and autoscaler events equal the JAX
    package's, and entry [9] of BENCH_gateway.json."""
    pattern, fleet = cell.split("_")
    got = _load_episode(PKGS["torch"], pattern, fleet == "autoscaled")
    assert_close(got, _load_episode(PKGS["jax"], pattern,
                                    fleet == "autoscaled"), cell)
    entry = json.loads((REPO / "BENCH_gateway.json").read_text())[9]["load"]
    assert_close(got, entry["runs"][cell], f"entry9.{cell}")
    n, goodput, p99 = ENTRY9[cell]
    s = got["summary"]
    assert (s["completions"], round(s["goodput_fraction"], 4),
            round(s["p99_ms"], 1)) == (n, goodput, p99)


def test_entry9_settings_equal_jax():
    got = _load_settings(PKGS["torch"])
    assert got == _load_settings(PKGS["jax"])
    entry = json.loads((REPO / "BENCH_gateway.json").read_text())[9]["load"]
    assert got == (entry["settings"]["steady_hz"],
                   entry["settings"]["deadline_ms"])


# --------------------------------------- a replay whose pods do real work

class _Recording:
    """Keeps every served result by uid in front of a backend."""

    def __init__(self, inner, seen):
        self.inner, self.seen = inner, seen
        self.name, self.max_batch = inner.name, inner.max_batch

    def serve_batch(self, requests):
        out = self.inner.serve_batch(requests)
        for r in out:
            self.seen[r.uid] = r
        return out

    def profile_row(self):
        return self.inner.profile_row()


def _np_detector(cfg, seed):
    """Seeded detector weights in the JAX package's layout (HWIO kernels
    at its init's scale, drawn with numpy), the head's bias raised by 0.3
    so that boxes come out."""
    rng = np.random.default_rng(seed)

    def conv(kh, kw, cin, cout):
        w = np.clip(rng.standard_normal((kh, kw, cin, cout)), -2, 2)
        return (w / math.sqrt(kh * kw * cin)).astype(np.float32)

    params, cin = {"convs": []}, 1
    for c in cfg.channels:
        params["convs"].append({"w1": conv(3, 3, cin, c),
                                "b1": np.zeros(c, np.float32),
                                "w2": conv(3, 3, c, c),
                                "b2": np.zeros(c, np.float32)})
        cin = c
    out = 5 + len(scenes.CLASSES)
    params["head"] = {"w1": conv(3, 3, cin, cfg.head_channels),
                      "b1": np.zeros(cfg.head_channels, np.float32),
                      "w2": conv(1, 1, cfg.head_channels, out),
                      "b2": np.full(out, 0.3, np.float32)}
    return params


def _real_replay(p, jax_params, duration_s):
    """ED and Algorithm 1 (δ = 5) on the per-request path, seeded
    detectors, max_batch 4, max_wait_ms 20, 2 pods up to 6, a flash crowd
    of rendered 64x64 scenes at bench_load's steady rate."""
    steady_hz, deadline_ms = _load_settings(p)
    params = (jax_params if p is PKGS["jax"] else
              {m: params_from_jax(v) for m, v in jax_params.items()})
    decisions, served = {}, {}

    def policy_for(i):
        t = p.devices.nominal_profile_table(**p.kw)
        pol = p.policy.DetectionPolicy(
            p.router.GreedyEstimateRouter(t, 5.0), t,
            p.est.EdgeDetectionEstimator(**p.kw))
        decide = pol.decide

        def keep(req):
            d = decide(req)
            decisions[d.uid] = (i, d.pair, d.est_complexity)
            return d
        pol.decide = keep
        return pol

    def backend_for(d):
        return _Recording(p.backend.DetectorBackend(
            *d.pair, params[d.pair[0]], max_batch=4, **p.kw), served)

    clock = p.tr.ManualClock()
    cl = p.cluster.EcoreCluster(policy_for, backend_for, pods=2, max_pods=6,
                                max_wait_ms=20.0, clock=clock,
                                retain_results=False, flusher=False, **p.kw)
    auto = p.cluster.Autoscaler(cl, clock, min_pods=2, max_pods=6,
                                high_backlog_per_pod=10.0,
                                low_backlog_per_pod=1.0, cooldown_s=0.5)
    work = p.tr.merge_tenants([p.tr.detector_tenant(
        "cams", p.tr.make_arrivals("flash", steady_hz, duration_s, seed=7),
        seed=1, deadline_ms=deadline_ms, scene_images=True)])
    driver = p.tr.LoadDriver(cl, clock, autoscaler=auto, window_s=0.05)
    try:
        driver.run(work)
    finally:
        cl.close()
    return ({"summary": driver.slo.summary(),
             "windows": driver.slo.window_records(),
             "autoscaler_events": auto.events, "requests": len(work)},
            decisions, served)


def test_real_work_replay_equal_jax():
    """Rendered scenes through the ED estimator and seeded detectors: per-
    uid decisions, the SLO summary, window records and autoscaler events
    equal the JAX package's, and each detection matches one of the JAX
    package's within the detector tests' bar (boxes atol 1e-4, scores atol
    1e-6, rtol 1e-5; classes equal).  0.25 s virtual (about
    a hundred requests) keeps the JAX detectors' compiles inside the test's
    budget."""
    jax_params = {m: _np_detector(JAX_CONFIGS[m], i) for i, m in
                  enumerate(("ssd_v1", "ssd_lite", "yolov8_n", "yolov8_s"))}
    got, dec, served = _real_replay(PKGS["torch"], jax_params, 0.25)
    want, jdec, jserved = _real_replay(PKGS["jax"], jax_params, 0.25)
    assert_close(got, want, "replay")
    assert dec == jdec and served.keys() == jserved.keys()
    assert len(served) == got["requests"] == got["summary"]["completions"]
    assert got["summary"]["failed"] == 0 and got["requests"] > 80
    for uid, r in served.items():
        (b1, s1, c1), (b2, s2, c2) = r.detections, jserved[uid].detections
        # every detection has its match in the other package (scores this
        # close may sort either way)
        match = ((np.abs(b1[:, None] - b2[None]) <= 1e-4
                  + 1e-5 * np.abs(b2[None])).all(-1)
                 & (np.abs(s1[:, None] - s2[None]) <= 1e-6
                    + 1e-5 * np.abs(s2[None]))
                 & (c1[:, None] == c2[None]))
        assert len(s1) == len(s2), uid
        assert match.any(1).all() and match.any(0).all(), uid
        assert r.batch_size == jserved[uid].batch_size
