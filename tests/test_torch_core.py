"""The port's profile state, Algorithm 1, closed loop and gateway against
the JAX package's, on the CPU.

The JAX tests hold the tensorized router and the scan to equal decisions
(ties included: the first minimum wins) and allclose states; the gateway
to equal pair histograms.  The port is held to the same bars.
"""
import numpy as np
import pytest
import torch
from _propcheck import given, settings, st

from repro.core import closed_loop as jax_loop
from repro.core import profiles as jax_profiles
from repro.core import router as jax_router
from repro.core.estimators import EdgeDetectionEstimator as JaxED
from repro.core.gateway import Gateway as JaxGateway
from repro.detection import devices as jax_devices
from repro.detection import scenes as jax_scenes
from repro.detection.detectors import DETECTOR_CONFIGS as JAX_CONFIGS
from repro_torch.core import closed_loop, profiles, router
from repro_torch.core.estimators import EdgeDetectionEstimator
from repro_torch.core.gateway import Gateway
from repro_torch.detection import devices, scenes
from repro_torch.detection.detectors import params_from_jax

torch.set_num_threads(1)

TESTBED_MODELS = ("ssd_v1", "ssd_lite", "yolov8_n", "yolov8_s")


def _tables(entries=None):
    """The same profile in both packages (the nominal testbed by
    default); the port's lives on the CPU."""
    if entries is None:
        return (jax_devices.nominal_profile_table(),
                devices.nominal_profile_table(device="cpu"))
    return (jax_profiles.ProfileTable(
                [jax_profiles.ProfileEntry(*e) for e in entries]),
            profiles.ProfileTable([profiles.ProfileEntry(*e)
                                   for e in entries], device="cpu"))


def _assert_states_close(jax_state, state):
    for name in ("map_pct", "time_ms", "energy_mwh"):
        np.testing.assert_allclose(getattr(state, name).numpy(),
                                   np.asarray(getattr(jax_state, name)),
                                   rtol=1e-6)
    np.testing.assert_array_equal(state.fails.numpy(),
                                  np.asarray(jax_state.fails))


# ---------------------------------------------------------- Algorithm 1

@pytest.mark.parametrize("delta", [0.0, 5.0, 10.0, 100.0])
def test_route_batch_matches_jax(delta):
    jt, tt = _tables()
    counts = list(range(12))
    got = router.route_batch(counts, tt, delta)
    np.testing.assert_array_equal(got, jax_router.route_batch(counts, jt,
                                                              delta))
    assert [tt.entries[i] for i in got] == \
        [router.greedy_route(c, tt, delta) for c in counts]


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 10_000), delta=st.sampled_from([0.0, 1.0, 3.0]))
def test_route_batch_ties_break_like_jax(seed, delta):
    """Coarse random profiles (values on a 1-unit grid) are full of ties
    in both mAP and energy; both routers take the first minimum."""
    rng = np.random.default_rng(seed)
    entries = [(f"m{p % 3}", f"d{p}", g, float(rng.integers(50, 54)), 1.0,
                float(rng.integers(1, 4)))
               for p in range(5) for g in range(5)]
    jt, tt = _tables(entries)
    counts = rng.integers(0, 8, 16)
    np.testing.assert_array_equal(router.route_batch(counts, tt, delta),
                                  jax_router.route_batch(counts, jt, delta))


def test_route_batch_rejects_unprofiled_groups_like_jax():
    entries = [("m", "d", 0, 50.0, 1.0, 1.0), ("m", "d", 1, 50.0, 1.0, 1.0)]
    jt, tt = _tables(entries)
    with pytest.raises(ValueError) as jax_err:
        jax_router.route_batch([0, 3], jt, 5.0)
    with pytest.raises(ValueError) as err:
        router.route_batch([0, 3], tt, 5.0)
    assert str(err.value) == str(jax_err.value)


def test_pure_state_folds_match_jax():
    jt, tt = _tables()
    js, ts = jt.as_state(), tt.as_state()
    for pair, row, failed in ((0, 2, True), (0, 2, True), (3, 1, False),
                              (5, 4, True)):
        js = jax_profiles.observe_state(js, pair, row, time_ms=99.0,
                                        energy_mwh=7.0, map_pct=41.0,
                                        alpha=0.3)
        ts = profiles.observe_state(ts, pair, row, time_ms=99.0,
                                    energy_mwh=7.0, map_pct=41.0, alpha=0.3)
        js = jax_profiles.quarantine_state(js, pair, row, failed)
        ts = profiles.quarantine_state(ts, pair, row, failed)
    js = jax_profiles.probe_state(js, 5, True)
    ts = profiles.probe_state(ts, 5, True)
    _assert_states_close(js, ts)
    jt.load_state(js)
    tt.load_state(ts)
    assert [(e.map_pct, e.time_ms, e.energy_mwh) for e in jt.entries] == \
        [(e.map_pct, e.time_ms, e.energy_mwh) for e in tt.entries]


# --------------------------------------------------------- closed loop

# the nominal testbed routes everything to pi5_tpu pairs, so drift there
# is what moves traffic
@pytest.mark.parametrize("scenario,delta,explore,quarantine", [
    ("thermal", 5.0, 0, None),
    ("thermal", 10.0, 0, None),
    ("background", 10.0, 7, None),
    ("dropout", 10.0, 5, 2),
])
def test_scan_stream_matches_jax(scenario, delta, explore, quarantine):
    jt, tt = _tables()
    ja, ta = jt.as_arrays(), tt.as_arrays()
    assert ja.pairs == ta.pairs
    T = 160
    counts = np.random.default_rng(0).integers(0, 7, T)
    fleet = devices.drift_scenario(scenario, "pi5_tpu", start=10)
    if scenario == "dropout":   # a hard dropout: inf costs, the breaker
        fleet = devices.DriftingFleet([devices.DriftEvent(
            "pi5_tpu", "dropout", start=10, end=60, hard=True)])
    meas = closed_loop.measurements_from_fleet(ta.pairs, T, fleet)
    jmeas = jax_loop.StreamMeasurements(meas.time_ms, meas.energy_mwh)
    expl = np.full(T, -1)
    if explore:
        expl[explore - 1::explore] = np.arange(T // explore) % len(ta.pairs)
    js, jd = jax_loop.scan_stream(ja.state, counts, jmeas, arrays=ja,
                                  delta=delta, explore_pairs=expl,
                                  quarantine_after=quarantine)
    ts, td = closed_loop.scan_stream(ta.state, counts, meas, arrays=ta,
                                     delta=delta, explore_pairs=expl,
                                     quarantine_after=quarantine)
    for f in ("pair_idx", "group_row", "entry_idx", "explored"):
        np.testing.assert_array_equal(getattr(td, f), getattr(jd, f))
    assert len(set(td.pair_idx.tolist())) > 1
    _assert_states_close(js, ts)


def test_scan_stream_reads_nothing_back_per_step():
    """The loop's per-step values stay on the device: no op in it reads a
    tensor back to the host (``aten._local_scalar_dense`` is what a 0-dim
    index or ``.item()`` turns into — a sync per step on the GPU)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountReads(TorchDispatchMode):
        reads = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten._local_scalar_dense.default:
                CountReads.reads += 1
            return func(*args, **(kwargs or {}))

    _, tt = _tables()
    ta = tt.as_arrays()
    meas = closed_loop.measurements_from_fleet(
        ta.pairs, 12, devices.drift_scenario("thermal", "pi5_tpu"))
    with CountReads():
        closed_loop.scan_stream(ta.state, np.arange(12) % 6, meas, arrays=ta,
                                delta=10.0, explore_pairs=np.arange(12) % 3,
                                quarantine_after=2)
    assert CountReads.reads == 0


def test_scan_stream_on_an_empty_stream():
    _, tt = _tables()
    ta = tt.as_arrays()
    meas = closed_loop.measurements_from_fleet(ta.pairs, 0)
    state, trace = closed_loop.scan_stream(ta.state, [], meas, arrays=ta,
                                           delta=5.0)
    assert trace.pair_idx.shape == (0,)
    torch.testing.assert_close(state.map_pct, ta.state.map_pct)


# ------------------------------------------------------------- gateway

def _numpy_detector(cfg, rng):
    """A detector in the JAX package's pytree layout (HWIO), drawn with
    numpy; the head's bias lifts some cells over the 0.5 threshold."""
    def conv(k, cin, cout):
        w = np.clip(rng.normal(size=(k, k, cin, cout)), -2, 2)
        return (w / np.sqrt(k * k * cin)).astype(np.float32)

    convs, cin = [], 1
    for c in cfg.channels:
        convs.append({"w1": conv(3, cin, c), "b1": np.zeros(c, np.float32),
                      "w2": conv(3, c, c), "b2": np.zeros(c, np.float32)})
        cin = c
    head = {"w1": conv(3, cin, cfg.head_channels),
            "b1": np.zeros(cfg.head_channels, np.float32),
            "w2": conv(1, cfg.head_channels, 8),
            "b2": np.full(8, 0.3, np.float32)}
    return {"convs": convs, "head": head}


@pytest.fixture(scope="module")
def detectors():
    """The same seeded weights in both packages."""
    rng = np.random.default_rng(0)
    jax_params = {m: _numpy_detector(JAX_CONFIGS[m], rng)
                  for m in TESTBED_MODELS}
    return jax_params, {m: params_from_jax(p) for m, p in jax_params.items()}


PATHS = {"scanned": dict(adapt=True), "batched": dict(adapt=False),
         # per-frame closed loop: measured mAP folds back, frame by frame
         "scalar": dict(adapt=True, adapt_map=True),
         "explored": dict(adapt=True, explore_every=7)}


@pytest.mark.parametrize("path,delta,drifting", [
    ("scanned", 5.0, "orin_nano"), ("batched", 5.0, "orin_nano"),
    ("scanned", 10.0, "pi5_tpu"), ("batched", 10.0, "pi5_tpu"),
    ("scalar", 10.0, "pi5_tpu"), ("explored", 10.0, "pi5_tpu")])
def test_gateway_matches_jax(detectors, path, delta, drifting):
    jax_params, params = detectors
    jt, tt = _tables()
    kw, adapt = PATHS[path], PATHS[path]["adapt"]
    jax_gw = JaxGateway(jax_router.GreedyEstimateRouter(jt, delta), jt,
                        jax_params, JaxED(),
                        fleet=jax_devices.drift_scenario("thermal", drifting),
                        max_batch=32, **kw)
    gw = Gateway(router.GreedyEstimateRouter(tt, delta), tt, params,
                 EdgeDetectionEstimator(device="cpu"),
                 fleet=devices.drift_scenario("thermal", drifting),
                 max_batch=32, device="cpu", **kw)
    assert gw.policy.scannable == (path in ("scanned", "explored"))
    assert gw.policy.batchable == (path == "batched")
    want = jax_gw.process_stream(jax_scenes.drifting_dataset(48, seed=4))
    got = gw.process_stream(scenes.drifting_dataset(48, seed=4))
    assert got.pair_histogram == want.pair_histogram
    if adapt and delta == 10.0:   # the drift (or exploration) moved traffic
        assert len(got.pair_histogram) > 1
    for f in ("map_pct", "backend_energy_mwh", "backend_time_ms",
              "gateway_energy_mwh", "gateway_time_ms"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-6)
    assert got.map_pct > 0
    if adapt:
        _assert_states_close(jt.as_state(), tt.as_state())


def test_entry_points_need_a_gpu_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU, so the default device works")
    from repro_torch.core.estimators import SSDFrontEndEstimator
    from repro_torch.detection.detectors import (DETECTOR_CONFIGS,
                                                 init_detector)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        devices.nominal_profile_table()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EdgeDetectionEstimator()
    detector = init_detector(DETECTOR_CONFIGS["ssd_v1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SSDFrontEndEstimator(detector)
    path = str(tmp_path / "profile.json")
    devices.nominal_profile_table(device="cpu").to_json(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        profiles.ProfileTable.from_json(path)
    assert SSDFrontEndEstimator(detector, device="cpu").device.type == "cpu"
    assert profiles.ProfileTable.from_json(path, device="cpu").device.type \
        == "cpu"


def test_detector_backend_edge_stage_and_costs_match_jax():
    """The serving plane's backend on ragged frames: the Canny edge stage
    (one call per size group) and the fleet costs charged per uid."""
    from repro.serving.backend import DetectorBackend as JaxBackend
    from repro.serving.backend import null_run as jax_null_run
    from repro.serving.engine import Request as JaxRequest
    from repro_torch.serving.backend import DetectorBackend, null_run
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(3)
    frames = [rng.random(s, np.float32) for s in ((64, 64), (40, 72),
                                                  (64, 64))]
    jb = JaxBackend("ssd_v1", "pi5_tpu", max_batch=3, run_fn=jax_null_run,
                    fleet=jax_devices.drift_scenario("thermal", "pi5_tpu"),
                    edge_stage=True)
    tb = DetectorBackend("ssd_v1", "pi5_tpu", max_batch=3, run_fn=null_run,
                         fleet=devices.drift_scenario("thermal", "pi5_tpu"),
                         edge_stage=True, device="cpu")
    want = jb.serve_batch([JaxRequest(uid=10 * i, prompt=f)
                           for i, f in enumerate(frames)])
    got = tb.serve_batch([Request(uid=10 * i, prompt=f)
                          for i, f in enumerate(frames)])
    assert tb.edge_density == jb.edge_density
    assert [(r.uid, r.time_ms, r.energy_mwh) for r in got] == \
        [(r.uid, r.time_ms, r.energy_mwh) for r in want]
    assert tb.profile_row() == jb.profile_row()


def test_service_flushes_partial_batches_and_closes():
    """``EcoreService`` without a GPU: full batches serve on submit,
    ``drain`` serves the partial rest, a backend error reaches every
    future of its queue, and a closed service refuses work."""
    from repro_torch.core.policy import RouteDecision, RouteRequest
    from repro_torch.serving.backend import DetectorBackend, null_run
    from repro_torch.serving.service import EcoreService, ServiceClosed

    class Fixed:
        def decide(self, req):
            return RouteDecision(uid=req.uid, pair=("ssd_v1", "pi5"))

    def factory(decision):
        return DetectorBackend(*decision.pair, max_batch=2, run_fn=null_run,
                               device="cpu")

    frame = np.zeros((8, 8), np.float32)
    svc = EcoreService(Fixed(), factory)
    futs = [svc.submit(RouteRequest(uid=i, payload=frame)) for i in range(3)]
    assert [f.done() for f in futs] == [True, True, False]
    assert sorted(s.request.uid for s in svc.results() + svc.drain()) == \
        [0, 1, 2]
    bad = EcoreService(Fixed(), lambda d: DetectorBackend(
        *d.pair, max_batch=2, run_fn=lambda p, x: 1 / 0, device="cpu"))
    fut = bad.submit(RouteRequest(uid=0, payload=frame))
    with pytest.raises(ZeroDivisionError):
        bad.close()
    assert isinstance(fut.exception(), ZeroDivisionError)
    svc.close()
    with pytest.raises(ServiceClosed):
        svc.submit(RouteRequest(uid=9, payload=frame))
