"""The port's baseline routers, SF and OB estimators, fleet elasticity and
profile io against the JAX package's, on the CPU.

Bars: routing decisions are held equal, ties included (the JAX tests'
bar); episode energies and times within 1e-5 relative; profile states
bit for bit where the JAX tests demand it (add/retire round trip) and to
1e-6 relative after a scan (as ``tests/test_torch_core.py``).
"""
import numpy as np
import pytest
import torch
from _propcheck import given, settings, st

from repro.core import estimators as jax_est
from repro.core import profiles as jax_profiles
from repro.core import router as jax_router
from repro.core.gateway import Gateway as JaxGateway
from repro.detection import devices as jax_devices
from repro.detection import scenes as jax_scenes
from repro.detection.detectors import DETECTOR_CONFIGS as JAX_CONFIGS
from repro_torch.core import estimators, profiles, router
from repro_torch.core.gateway import Gateway
from repro_torch.detection import devices, scenes
from repro_torch.detection.detectors import DETECTOR_CONFIGS as TORCH_CONFIGS
from repro_torch.detection.detectors import params_from_jax

torch.set_num_threads(1)

TESTBED_MODELS = ("ssd_v1", "ssd_lite", "yolov8_n", "yolov8_s")
ROUTERS = ("greedy", "Orc", "RR", "Rnd", "LE", "LI", "HM", "HMG", "Wgt",
           "Par")


def _router(mod, name, table, delta):
    """Router ``name`` of package router module ``mod`` (Rnd: seed 0)."""
    return {"greedy": mod.GreedyEstimateRouter, "Orc": mod.OracleRouter,
            "RR": mod.RoundRobinRouter, "Rnd": mod.RandomRouter,
            "LE": mod.LowestEnergyRouter, "LI": mod.LowestInferenceRouter,
            "HM": mod.HighestMAPRouter, "HMG": mod.HighestMAPPerGroupRouter,
            "Wgt": mod.WeightedRouter, "Par": mod.ParetoRouter}[name](
                table, delta)


def _random_entries(seed):
    """A profile over 3 models x 3 devices x 5 groups with values from
    small sets (exact in f32, so ties are common); a few (pair, group)
    rows are left out, never a whole group."""
    rng = np.random.default_rng(seed)
    out = []
    for g in range(5):
        for m in range(3):
            for d in range(3):
                if rng.random() < 0.15 and (m, d) != (0, 0):
                    continue
                out.append((f"m{m}", f"d{d}", g,
                            float(rng.choice([50.0, 52.5, 55.0, 60.0])),
                            float(rng.choice([1.0, 2.0, 4.0])),
                            float(rng.choice([0.25, 0.5, 1.0, 1.5]))))
    return out


def _tables(entries=None):
    if entries is None:
        return (jax_devices.nominal_profile_table(),
                devices.nominal_profile_table(device="cpu"))
    return (jax_profiles.ProfileTable(
                [jax_profiles.ProfileEntry(*e) for e in entries]),
            profiles.ProfileTable([profiles.ProfileEntry(*e)
                                   for e in entries], device="cpu"))


# -------------------------------------------------------------- routers

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", ROUTERS)
def test_router_sequences_equal_jax(name, seed):
    """Every router's pair sequence over a count stream (estimated and
    true counts drawn apart) equals the JAX router's, ties included."""
    jt, tt = _tables(_random_entries(seed))
    rng = np.random.default_rng(100 + seed)
    est, true = rng.integers(0, 9, 40), rng.integers(0, 9, 40)
    delta = float(rng.choice([0.0, 2.5, 5.0, 20.0]))
    jr, tr = _router(jax_router, name, jt, delta), _router(router, name, tt,
                                                          delta)
    assert (tr.name, tr.batchable, tr.uses_estimate, tr.uses_ground_truth) \
        == (jr.name, jr.batchable, jr.uses_estimate, jr.uses_ground_truth)
    want = [jr.route(estimated_count=int(e), true_count=int(t))
            for e, t in zip(est, true)]
    got = [tr.route(estimated_count=int(e), true_count=int(t))
           for e, t in zip(est, true)]
    assert got == want
    jr.reset()
    tr.reset()
    assert tr.route_batch(estimated_counts=est, true_counts=true) == \
        jr.route_batch(estimated_counts=est, true_counts=true)


@pytest.mark.parametrize("seed", [0, 7])
def test_random_router_reseeds_like_jax(seed):
    jt, tt = _tables()
    jr = jax_router.RandomRouter(jt, 5.0, seed=seed)
    tr = router.RandomRouter(tt, 5.0, seed=seed)
    first = [tr.route() for _ in range(50)]
    assert first == [jr.route() for _ in range(50)]
    assert len(set(first)) > 1
    tr.reset()
    jr.reset()
    assert [tr.route() for _ in range(50)] == first == \
        [jr.route() for _ in range(50)]


@pytest.mark.parametrize("name", ["Wgt", "Par"])
def test_multi_objective_routers_follow_observe_like_jax(name):
    """``observe`` mutates the table between decisions: the weighted
    router's normalizers and the Pareto front move with it."""
    jt, tt = _tables()
    jr, tr = _router(jax_router, name, jt, 10.0), _router(router, name, tt,
                                                          10.0)
    rng = np.random.default_rng(5)
    pairs = tt.pairs()
    got, want = [], []
    for step in range(60):
        c = int(rng.integers(0, 7))
        got.append(tr.route(estimated_count=c))
        want.append(jr.route(estimated_count=c))
        pair = pairs[int(rng.integers(len(pairs)))]
        scale = float(rng.choice([0.2, 1.0, 5.0]))
        e = tt.entry(pair, 0)
        for t in (tt, jt):
            t.observe_pair(pair, time_ms=e.time_ms * scale,
                           energy_mwh=e.energy_mwh / scale, alpha=0.5)
    assert got == want
    assert len(set(got)) > 1


@settings(max_examples=40, deadline=None)
@given(st.lists(st.tuples(st.sampled_from([0.5, 1.0, 2.0, 3.0]),
                          st.sampled_from([1.0, 2.0, 4.0])),
                min_size=1, max_size=9))
def test_pareto_front_equals_jax(costs):
    jt = [jax_profiles.ProfileEntry(f"m{i}", "d", 0, 50.0, t, e)
          for i, (e, t) in enumerate(costs)]
    tt = [profiles.ProfileEntry(f"m{i}", "d", 0, 50.0, t, e)
          for i, (e, t) in enumerate(costs)]
    want = [e.model for e in jax_router.pareto_front(jt)]
    assert [e.model for e in router.pareto_front(tt)] == want
    assert want


@pytest.mark.parametrize("count", range(7))
@pytest.mark.parametrize("delta", [2.0, 10.0])
def test_runner_up_route_equals_jax(count, delta):
    jt, tt = _tables()
    greedy = router.greedy_route(count, tt, delta)
    assert router.runner_up_route(count, tt, delta, exclude=[]) == greedy
    feasible = router.feasible_for_count(count, tt, delta)
    assert feasible == [profiles.ProfileEntry(*e.__dict__.values())
                        for e in jax_router.feasible_for_count(count, jt,
                                                               delta)]
    excluded = []
    for _ in range(len(feasible)):
        got = router.runner_up_route(count, tt, delta, exclude=excluded)
        want = jax_router.runner_up_route(count, jt, delta,
                                          exclude=excluded)
        assert (got.pair, got.group) == (want.pair, want.group)
        excluded.append(got.pair)
    assert router.runner_up_route(count, tt, delta, exclude=excluded) is None
    assert jax_router.runner_up_route(count, jt, delta,
                                      exclude=excluded) is None


# ----------------------------------------------------------- estimators

def _numpy_detector(cfg, rng, head_bias=0.3):
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
            "b2": np.full(8, head_bias, np.float32)}
    return {"convs": convs, "head": head}


@pytest.fixture(scope="module")
def detectors():
    """The same seeded weights in both packages."""
    rng = np.random.default_rng(0)
    jax_params = {m: _numpy_detector(JAX_CONFIGS[m], rng)
                  for m in TESTBED_MODELS}
    return jax_params, {m: params_from_jax(p) for m, p in jax_params.items()}


@pytest.mark.parametrize("head_bias", [0.0, 0.3])
def test_sf_counts_equal_jax(head_bias):
    """SF over scenes, with the head scaled so some cells clear 0.5: the
    per-frame and batched counts and the gateway FLOPs equal the JAX
    estimator's (the raw scores agree within the detector test's bar)."""
    jp = _numpy_detector(JAX_CONFIGS["ssd_v1"], np.random.default_rng(1),
                         head_bias)
    jp["head"]["w2"] = jp["head"]["w2"] * 2.0
    imgs = np.stack([s.image for s in scenes.drifting_dataset(12, seed=3)])
    je = jax_est.SSDFrontEndEstimator(jp, "ssd_v1")
    te = estimators.SSDFrontEndEstimator(params_from_jax(jp), "ssd_v1",
                                         device="cpu")
    assert (te.name, te.batchable) == (je.name, je.batchable)
    counts, flops = te.estimate_batch(imgs)
    want_counts, want_flops = je.estimate_batch(imgs)
    np.testing.assert_array_equal(counts, want_counts)
    np.testing.assert_array_equal(flops, want_flops)
    assert counts.sum() > 0
    assert [te.estimate(im) for im in imgs[:4]] == \
        [je.estimate(im) for im in imgs[:4]]


def test_ob_sequence_equals_jax():
    je, te = jax_est.OutputBasedEstimator(3), estimators.OutputBasedEstimator(3)
    img = np.zeros((8, 8), np.float32)
    trace = []
    for est in (je, te):
        out = [est.estimate(img)]
        est.observe(5)
        out.append(est.estimate(img))
        est.observe_batch([2, 9, 4])
        out.append(est.estimate(img))
        est.observe_batch([])
        out.append(est.estimate(img))
        est.reset()
        out.append(est.estimate(img))
        trace.append(out)
    assert trace[0] == trace[1] == [(3, 0.0), (5, 0.0), (4, 0.0), (4, 0.0),
                                    (3, 0.0)]
    assert (te.name, te.batchable) == (je.name, je.batchable)


EPISODES = [(e, r) for e in ("ED", "SF", "OB") for r in ("greedy", "Wgt",
                                                         "Par")] + \
    [(None, r) for r in ("RR", "Rnd", "LE", "LI", "HM", "HMG")] + \
    [("GT", "Orc")]


@pytest.mark.parametrize("est,name", EPISODES)
def test_gateway_episodes_equal_jax(detectors, est, name):
    """The paper's routing comparison on 48 drifting scenes: every
    (estimator, router) row's pair histogram equals the JAX gateway's, its
    energies and times within 1e-5 relative."""
    jax_params, params = detectors
    jt, tt = _tables()
    jest = {"ED": lambda: jax_est.EdgeDetectionEstimator(),
            "SF": lambda: jax_est.SSDFrontEndEstimator(jax_params["ssd_v1"]),
            "OB": jax_est.OutputBasedEstimator,
            "GT": jax_est.OracleEstimator, None: lambda: None}[est]()
    test = {"ED": lambda: estimators.EdgeDetectionEstimator(device="cpu"),
            "SF": lambda: estimators.SSDFrontEndEstimator(params["ssd_v1"],
                                                          device="cpu"),
            "OB": estimators.OutputBasedEstimator,
            "GT": estimators.OracleEstimator, None: lambda: None}[est]()
    jgw = JaxGateway(_router(jax_router, name, jt, 5.0), jt, jax_params,
                     jest, fleet=jax_devices.drift_scenario("thermal"),
                     max_batch=32)
    gw = Gateway(_router(router, name, tt, 5.0), tt, params, test,
                 fleet=devices.drift_scenario("thermal"), max_batch=32,
                 device="cpu")
    assert gw.policy.batchable == jgw.policy.batchable
    want = jgw.process_stream(jax_scenes.drifting_dataset(48, seed=4))
    got = gw.process_stream(scenes.drifting_dataset(48, seed=4))
    assert got.pair_histogram == want.pair_histogram
    assert sum(got.pair_histogram.values()) == 48
    assert (got.router, got.estimator) == (want.router, want.estimator)
    for f in ("map_pct", "backend_energy_mwh", "backend_time_ms",
              "gateway_energy_mwh", "gateway_time_ms"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-5)


# ------------------------------------------------------------- profiles

def _decide_all(state, arrays, delta=5.0):
    lo, hi, rr = router.rules_arrays(router.DEFAULT_GROUP_RULES,
                                     arrays.row_of, state.map_pct.device)
    g, col, ok = router.decide_state(state, torch.arange(9), delta, lo, hi,
                                     rr)
    return list(zip(g.tolist(), col.tolist(), ok.tolist()))


def _jax_decide_all(state, arrays, delta=5.0):
    import jax.numpy as jnp
    lo, hi, rr = jax_router.rules_arrays(jax_router.DEFAULT_GROUP_RULES,
                                         arrays.row_of)
    return [tuple(int(v) if i < 2 else bool(v) for i, v in enumerate(
        jax_router.decide_state(state, jnp.int32(c), 5.0, lo, hi, rr)))
        for c in range(9)]


@pytest.mark.parametrize("kw", [
    dict(map_pct=99.0, time_ms=0.01, energy_mwh=1e-9),
    dict(map_pct=10.0, time_ms=1e6, energy_mwh=1e6),
    dict(map_pct=np.linspace(40.0, 70.0, 5), time_ms=1.0, energy_mwh=0.004),
    dict(map_pct=52.0, time_ms=2.0, energy_mwh=0.0037, pair_idx=11)])
def test_add_pair_then_decide_equals_jax(kw):
    from repro.core import add_pair as jax_add_pair
    jt, tt = _tables()
    ja, ta = jt.as_arrays(), tt.as_arrays()
    jgrown, jidx = jax_add_pair(ja.state, **kw)
    grown, idx = profiles.add_pair(ta.state, **kw)
    assert idx == jidx and isinstance(idx, int)
    for f in profiles.ProfileState._fields:
        np.testing.assert_array_equal(getattr(grown, f).numpy(),
                                      np.asarray(getattr(jgrown, f)))
    assert _decide_all(grown, ta) == _jax_decide_all(jgrown, ja)


def test_add_then_retire_pair_restores_decisions_bit_for_bit():
    _, tt = _tables()
    ta = tt.as_arrays()
    base = _decide_all(ta.state, ta)
    grown, idx = profiles.add_pair(ta.state, map_pct=99.0, time_ms=0.01,
                                   energy_mwh=1e-9)
    assert idx == len(ta.pairs)
    assert _decide_all(grown, ta) != base            # the new pair wins
    shrunk = profiles.retire_pair(grown, torch.tensor([idx]))
    assert _decide_all(shrunk, ta) == base
    assert not shrunk.valid[:, -1].any()
    assert (shrunk.pair_id[:, -1] == -1).all()
    assert torch.isinf(shrunk.time_ms[:, -1]).all()
    same = profiles.retire_pair(ta.state, 10_000)    # unknown: identity
    for a, b in zip(same, ta.state):
        assert torch.equal(a, b)


@pytest.mark.parametrize("retired", [0, 3])
def test_retire_pair_inside_scan_stream_equals_jax(retired):
    """A pair retired with a tensor index (no host read) leaves the scan's
    decisions and state equal to the JAX scan over the JAX retire."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro.core import closed_loop as jax_loop
    from repro.core import retire_pair as jax_retire
    from repro_torch.core import closed_loop

    class CountReads(TorchDispatchMode):
        reads = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten._local_scalar_dense.default:
                CountReads.reads += 1
            return func(*args, **(kwargs or {}))

    jt, tt = _tables()
    ja, ta = jt.as_arrays(), tt.as_arrays()
    with CountReads():
        state = profiles.retire_pair(ta.state, torch.tensor([retired]))
    assert CountReads.reads == 0
    counts = np.random.default_rng(2).integers(0, 8, 96)
    fleet = devices.drift_scenario("thermal", "pi5_tpu")
    meas = closed_loop.measurements_from_fleet(ta.pairs, 96, fleet)
    js, jd = jax_loop.scan_stream(
        jax_retire(ja.state, retired), counts,
        jax_loop.StreamMeasurements(meas.time_ms, meas.energy_mwh),
        arrays=ja, delta=10.0)
    ts, td = closed_loop.scan_stream(state, counts, meas, arrays=ta,
                                     delta=10.0)
    np.testing.assert_array_equal(td.pair_idx, jd.pair_idx)
    assert retired not in set(td.pair_idx.tolist())
    for f in ("map_pct", "time_ms", "energy_mwh"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=1e-6)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_profile_json_reads_back_in_the_other_package(tmp_path, writer):
    """Either package's ``to_json`` writes the same bytes, and the other
    package reads them back into equal entries."""
    jt, tt = _tables(_random_entries(4))
    mine, other = tmp_path / "a.json", tmp_path / "b.json"
    src, dst = (jt, tt) if writer == "jax" else (tt, jt)
    src.to_json(str(mine))
    dst.to_json(str(other))
    assert mine.read_text() == other.read_text()
    back = (profiles.ProfileTable.from_json(str(mine), device="cpu")
            if writer == "jax" else
            jax_profiles.ProfileTable.from_json(str(mine)))
    assert [tuple(e.__dict__.values()) for e in back.entries] == \
        [tuple(e.__dict__.values()) for e in src.entries]


def test_table_entry_mean_map_and_with_state_equal_jax():
    jt, tt = _tables(_random_entries(6))
    for pair in tt.pairs():
        assert tt.mean_map(pair) == jt.mean_map(pair)
    for e in tt.entries:
        assert tt.entry(e.pair, e.group).__dict__ == \
            jt.entry(e.pair, e.group).__dict__
    with pytest.raises(KeyError):
        tt.entry(("nope", "d0"), 0)
    ts = tt.as_state()
    moved = profiles.observe_state(ts, 1, 0, time_ms=50.0, energy_mwh=9.0,
                                   map_pct=10.0, alpha=0.5)
    jmoved = jax_profiles.observe_state(jt.as_state(), 1, 0, time_ms=50.0,
                                        energy_mwh=9.0, map_pct=10.0,
                                        alpha=0.5)
    other, jother = tt.with_state(moved), jt.with_state(jmoved)
    assert other.device == tt.device and other is not tt
    assert [tuple(e.__dict__.values()) for e in other.entries] == \
        [tuple(e.__dict__.values()) for e in jother.entries]
    assert tt.version == 0                     # the source is untouched


def _adaptive_energies(pkg, counts, delta=5.0, alpha=0.15):
    """The JAX package's ``adaptive`` benchmark episode (static profile,
    closed loop, scanned closed loop, oracle) run through one package:
    energies, times and the closed loop's picks."""
    jax = pkg == "jax"
    dev_mod = jax_devices if jax else devices
    rt = jax_router if jax else router
    from repro.core import closed_loop as jax_loop
    from repro_torch.core import closed_loop
    loop = jax_loop if jax else closed_loop
    configs = JAX_CONFIGS if jax else TORCH_CONFIGS
    table = (lambda: dev_mod.nominal_profile_table()) if jax else \
        (lambda: dev_mod.nominal_profile_table(device="cpu"))
    steps = len(counts)
    modal = int(np.argmax(np.bincount(counts)))
    favorite = rt.greedy_route(modal, table(), delta).device
    fleet = dev_mod.drift_scenario("thermal", device=favorite,
                                   start=steps // 4)

    def cost(e, t):
        return fleet.cost(e.device, configs[e.model].flops, t)

    def episode(adapt):
        tab, energy, time_ms, picks = table(), 0.0, 0.0, []
        for t, c in enumerate(counts):
            e = rt.greedy_route(int(c), tab, delta)
            picks.append(e.pair)
            t_ms, e_mwh = cost(e, t)
            energy, time_ms = energy + e_mwh, time_ms + t_ms
            if adapt:
                tab.observe_pair(e.pair, time_ms=t_ms, energy_mwh=e_mwh,
                                 alpha=alpha)
        return energy, time_ms, picks

    oracle = [0.0, 0.0]
    for t, c in enumerate(counts):
        e = min(rt.feasible_for_count(int(c), table(), delta),
                key=lambda e: cost(e, t)[1])
        oracle = [oracle[0] + cost(e, t)[1], oracle[1] + cost(e, t)[0]]
    arrays = table().as_arrays()
    meas = loop.measurements_from_fleet(arrays.pairs, steps, fleet)
    trace = loop.scan_stream(arrays.state, counts, meas, arrays=arrays,
                             delta=delta, alpha=alpha)[1]
    scanned = float(np.asarray(meas.energy_mwh)[np.arange(steps),
                                                np.asarray(trace.pair_idx)]
                    .sum())
    static, closed = episode(False), episode(True)
    return {"static": static[:2], "closed_loop": closed[:2],
            "oracle": tuple(oracle), "scanned_energy": scanned,
            "scanned_picks": [arrays.pairs[j] for j in trace.pair_idx],
            "picks": closed[2]}


def test_adaptive_benchmark_episode_equals_jax():
    """``BENCH_gateway.json`` entry [5] (``adaptive``, 400 steps) as a
    parity test: the static, closed-loop, scanned and oracle episodes give
    the JAX package's energies and times (within 1e-5 relative) and its
    picks; the scanned loop's picks equal the scalar loop's."""
    counts = np.random.default_rng(7).choice(
        len(scenes.COUNT_PROBS), p=scenes.COUNT_PROBS, size=400)
    got, want = _adaptive_energies("torch", counts), \
        _adaptive_energies("jax", counts)
    assert got["picks"] == want["picks"] == got["scanned_picks"]
    for k in ("static", "closed_loop", "oracle"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
    np.testing.assert_allclose(got["scanned_energy"], got["closed_loop"][0],
                               rtol=1e-5)
    assert got["static"][0] > got["closed_loop"][0] > got["oracle"][0]
