"""The port's detector training, datasets, optimizer, checkpoints and
offline profiling against the JAX package's, on the CPU.

Scenes, targets, the schedule and the profile's modeled costs are held
equal; the loss at the detector tests' bar and its gradients within rtol
1e-4, atol 1e-6 x each tensor's largest gradient; the AdamW update within
rtol 1e-6; ten steps of the training loop within rtol 1e-3 of the JAX
loop's losses (conv backward sums in another order, and Adam amplifies
that where v is tiny, so trained weights are never compared across
frameworks).  ``profile_pairs`` over the same JAX-trained weights equals
the JAX table, mAP under the near-threshold rule (a group whose frames put
an objectness within atol 1e-6 + rtol 1e-5 of 0.5 may differ).
"""
import copy
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jax_ckpt
from repro.detection import scenes as jax_scenes
from repro.detection import train as jax_train
from repro.detection.detectors import DETECTOR_CONFIGS as JAX_CONFIGS
from repro.detection.detectors import detection_loss as jax_loss
from repro.detection.detectors import detector_forward as jax_forward
from repro.detection.detectors import encode_targets as jax_encode
from repro.detection.detectors import init_detector as jax_init
from repro.optim import adamw as jax_adamw
from repro_torch.checkpoint import ckpt
from repro_torch.core import (EdgeDetectionEstimator, Gateway,
                              GreedyEstimateRouter, HighestMAPPerGroupRouter,
                              LowestEnergyRouter, OracleEstimator,
                              OracleRouter, OutputBasedEstimator,
                              SSDFrontEndEstimator)
from repro_torch.detection import scenes
from repro_torch.detection import train
from repro_torch.detection.detectors import (DETECTOR_CONFIGS,
                                             detection_loss, encode_targets,
                                             init_detector, params_from_jax,
                                             params_to_jax)
from repro_torch.optim import adamw

torch.set_num_threads(1)

DATASETS = [("full_dataset", (7,), 0), ("full_dataset", (30,), 42),
            ("balanced_sorted_dataset", (), 1),
            ("balanced_sorted_dataset", (6,), 32),
            ("video_dataset", (60,), 2), ("video_dataset", (200,), 33)]


def _jax_params(name, seed=0):
    init = jax.jit(jax_init, static_argnums=0)
    return jax.tree_util.tree_map(
        np.array, init(JAX_CONFIGS[name], jax.random.PRNGKey(seed)))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _leaves(t, f"{path}/{i}")
    else:
        yield path, np.asarray(tree)


# ------------------------------------------------------------- datasets

@pytest.mark.parametrize("name,args,seed", DATASETS)
def test_datasets_are_the_jax_packages(name, args, seed):
    want = getattr(jax_scenes, name)(*args, seed=seed)
    got = getattr(scenes, name)(*args, seed=seed)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.image.dtype == b.image.dtype == np.float32
        assert a.image.tobytes() == b.image.tobytes()
        np.testing.assert_array_equal(a.boxes, b.boxes)
        np.testing.assert_array_equal(a.classes, b.classes)
        assert a.classes.dtype == b.classes.dtype
        assert a.count == b.count


def test_balanced_sorted_structure():
    ds = scenes.balanced_sorted_dataset(per_group=5, seed=0)
    assert len(ds) == 25
    groups = [min(s.count, 4) for s in ds]
    assert groups == sorted(groups)
    assert groups[:5] == [0] * 5


def test_video_temporal_continuity():
    ds = scenes.video_dataset(n_frames=60, seed=0)
    counts = [s.count for s in ds]
    assert max(abs(a - b) for a, b in zip(counts, counts[1:])) <= 1
    for s in ds:
        assert s.count == len(s.boxes) == len(s.classes)
        assert (s.boxes[:, :2] >= 0).all() and (s.boxes[:, 2:] <= 64).all()


def test_encode_targets_exact():
    for s in jax_scenes.full_dataset(40, seed=5):
        for a, b in zip(encode_targets(s.boxes, s.classes),
                        jax_encode(s.boxes, s.classes)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------ loss and gradients

def _grads_as_jax(model):
    g = copy.deepcopy(model)
    for p, q in zip(g.parameters(), model.parameters()):
        p.data = q.grad
    return params_to_jax(g)


@pytest.mark.parametrize("name,seed", [("ssd_v1", 0), ("ssd_lite", 3),
                                       ("yolov8_n", 1)])
def test_loss_and_gradients_match_jax(name, seed):
    np_params = _jax_params(name, seed)
    batch_scenes = jax_scenes.full_dataset(8, seed=seed + 7)
    want_loss, want_g = jax.jit(jax.value_and_grad(jax_loss))(
        np_params, jax_train._batch_from_scenes(batch_scenes))
    model = params_from_jax(np_params, name)
    loss = detection_loss(model, train.batch_from_scenes(batch_scenes,
                                                         "cpu"))
    loss.backward()
    loss = loss.detach()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5,
                               atol=1e-5)
    got = dict(_leaves(_grads_as_jax(model)))
    want = dict(_leaves(jax.tree_util.tree_map(np.asarray, want_g)))
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k], w, rtol=1e-4,
                                   atol=1e-6 * np.abs(w).max(), err_msg=k)


def test_params_round_trip_and_named_config():
    np_params = _jax_params("ssd_lite", 2)
    model = params_from_jax(np_params, "ssd_lite")
    assert model.cfg is not DETECTOR_CONFIGS["ssd_lite"]
    assert model.cfg == DETECTOR_CONFIGS["ssd_lite"]
    assert model.cfg.flops == DETECTOR_CONFIGS["ssd_lite"].flops
    for (ka, a), (kb, b) in zip(_leaves(params_to_jax(model)),
                                _leaves(np_params)):
        assert ka == kb
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        params_from_jax(np_params, "yolov8_n")


# --------------------------------------------------------------- AdamW

def _opt_trees(seed):
    rng = np.random.default_rng(seed)
    shapes = {"w": (3, 3, 2, 4), "b": (4,), "m": (5, 6), "s": ()}
    return {k: np.asarray(rng.normal(0, 1, s), np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("clip_norm,gscale", [(1.0, 50.0), (1.0, 1e-3),
                                              (None, 1.0)])
def test_adamw_update_matches_jax(clip_norm, gscale):
    """30 steps across warmup and cosine on the same gradients, decay only
    on the ndim >= 2 tensors.  Unclipped (gscale 1e-3 keeps the norm under
    the clip) the parameters and moments are bit-equal to the JAX update's.
    Clipped (gscale 50), the norm sums in another order (its f32 value
    within 1e-6 relative), the scale moves by an ulp, and a parameter that
    passes near 0 moves by a few ulps: rtol 1e-6 + atol 1e-6 x the largest
    |value| among the parameters (the first moments, the second)."""
    cfg_kw = dict(peak_lr=1e-2, warmup_steps=10, total_steps=30,
                  weight_decay=0.1, clip_norm=clip_norm)
    p0 = _opt_trees(0)
    jp = {k: jax.numpy.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    jcfg, tcfg = (jax_adamw.AdamWConfig(**cfg_kw),
                  adamw.AdamWConfig(**cfg_kw))
    jopt, topt = jax_adamw.init_opt_state(jp), adamw.init_opt_state(tp)
    clipped = gscale > 1
    for i in range(30):
        g = {k: np.asarray(v * gscale, np.float32)
             for k, v in _opt_trees(100 + i).items()}
        jp, jopt, jm = jax_adamw.adamw_update(
            jcfg, jp, {k: jax.numpy.asarray(v) for k, v in g.items()}, jopt)
        tp, topt, tm = adamw.adamw_update(
            tcfg, tp, {k: torch.from_numpy(v) for k, v in g.items()}, topt)
        assert int(topt.step) == int(jopt.step) == i + 1
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6, atol=0)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for got, want in ((tp, jp), (topt.mu, jopt.mu), (topt.nu, jopt.nu)):
            scale = max(float(np.abs(np.asarray(w)).max())
                        for w in want.values())
            for k in p0:
                if clipped:
                    np.testing.assert_allclose(
                        got[k].numpy(), np.asarray(want[k]), rtol=1e-6,
                        atol=1e-6 * scale, err_msg=k)
                else:
                    np.testing.assert_array_equal(
                        got[k].numpy(), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("kw", [
    dict(peak_lr=1.0, end_lr=0.1, warmup_steps=10, total_steps=100),
    dict(peak_lr=5e-3, warmup_steps=20, total_steps=700,
         weight_decay=1e-4),
    dict(peak_lr=5e-3, warmup_steps=20, total_steps=250,
         weight_decay=1e-4)])
def test_cosine_lr_equals_jax_at_every_step(kw):
    """Against the reference's formula op by op: equal through the warmup;
    on the cosine equal at >= 98 % of the steps and within rtol 1e-6 at the
    others, where XLA's f32 cos is an ulp off the correctly rounded value
    the port takes (1 + cos then loses bits near cos = -1)."""
    jcfg, tcfg = jax_adamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    steps = range(kw["total_steps"] + 2)
    want = np.array([float(jax_adamw.cosine_lr(jcfg, jax.numpy.asarray(
        s, jax.numpy.int32))) for s in steps], np.float32)
    got = np.array([float(adamw.cosine_lr(tcfg, torch.tensor(
        s, dtype=torch.int32))) for s in steps], np.float32)
    warm = kw["warmup_steps"] + 1
    np.testing.assert_array_equal(got[:warm], want[:warm])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert (got != want).mean() <= 0.02


def test_adamw_minimizes_quadratic():
    params = {"w": torch.tensor([3.0, -2.0])}
    opt = adamw.init_opt_state(params)
    cfg = adamw.AdamWConfig(peak_lr=0.2, warmup_steps=5, total_steps=100,
                            weight_decay=0.0)
    for _ in range(100):
        params, opt, _ = adamw.adamw_update(cfg, params,
                                            {"w": 2 * params["w"]}, opt)
    assert float(params["w"].square().sum()) < 1e-2
    assert int(opt.step) == 100


def test_cosine_schedule_shape():
    cfg = adamw.AdamWConfig(peak_lr=1.0, end_lr=0.1, warmup_steps=10,
                            total_steps=100)
    lrs = [float(adamw.cosine_lr(cfg, torch.tensor(s))) for s in range(101)]
    assert lrs[0] == 0.0
    assert abs(lrs[10] - 1.0) < 1e-6
    assert lrs[100] <= 0.1 + 1e-6
    assert all(a >= b - 1e-9 for a, b in zip(lrs[10:], lrs[11:]))


def test_grad_clipping_reports_the_norm_before_clipping():
    params = [torch.zeros(3)]
    opt = adamw.init_opt_state(params)
    new, _, m = adamw.adamw_update(adamw.AdamWConfig(total_steps=10),
                                   params, [torch.full((3,), 1e6)], opt)
    assert float(m["grad_norm"]) > 1e5
    assert isinstance(new, list) and new[0].shape == (3,)


# ------------------------------------------------------------ the loop

def test_ten_training_steps_match_the_jax_loop():
    """ssd_v1 from the same JAX init on the same batches (``seed + 17``),
    the reference's settings: losses within rtol 1e-3 at every step."""
    steps, np_params = 10, _jax_params("ssd_v1", 0)
    opt_cfg = jax_adamw.AdamWConfig(peak_lr=5e-3, warmup_steps=20,
                                    total_steps=steps, weight_decay=1e-4)

    @jax.jit
    def step(params, opt, batch):
        loss, grads = jax.value_and_grad(jax_loss)(params, batch)
        params, opt, _ = jax_adamw.adamw_update(opt_cfg, params, grads, opt)
        return params, opt, loss

    params, opt = np_params, jax_adamw.init_opt_state(np_params)
    rng, want = np.random.default_rng(17), []
    for _ in range(steps):
        batch = jax_train._batch_from_scenes(
            [jax_scenes.make_scene(rng) for _ in range(16)])
        params, opt, loss = step(params, opt, batch)
        want.append(float(loss))
    got = train.fit_detector(params_from_jax(np_params, "ssd_v1"),
                             steps=steps, seed=0)
    assert got.shape == (steps,)
    np.testing.assert_allclose(got, want, rtol=1e-3)


def test_train_detector_defaults_to_the_card():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.train_detector(DETECTOR_CONFIGS["ssd_v1"], steps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.profile_pairs({}, [])


# --------------------------------------------- checkpoints and profiling

@pytest.fixture(scope="module")
def jax_ssd_v1():
    """ssd_v1 trained 150 steps by the JAX package (mAP > 0 in groups
    1-4 of ``full_dataset(80, seed=42)``), as numpy."""
    return jax.tree_util.tree_map(np.asarray, jax_train.train_detector(
        JAX_CONFIGS["ssd_v1"], steps=150, seed=0))


def test_checkpoints_cross_both_ways(jax_ssd_v1, tmp_path):
    x = np.random.default_rng(0).random((3, 64, 64, 1), np.float32)
    jpath = str(tmp_path / "jax" / "ssd_v1.npz")
    jax_ckpt.save(jpath, jax_ssd_v1)
    model = train.load_detector(jpath, "ssd_v1", device="cpu")
    assert model.cfg == DETECTOR_CONFIGS["ssd_v1"]
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jax_forward)(jax_ssd_v1, x))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the port's own detector, saved by the port, loaded by the JAX package
    mine = init_detector(DETECTOR_CONFIGS["ssd_v1"], seed=5)
    tpath = str(tmp_path / "torch" / "ssd_v1.npz")
    ckpt.save(tpath, params_to_jax(mine))
    back = jax_ckpt.load(tpath, jax_init(JAX_CONFIGS["ssd_v1"],
                                         jax.random.PRNGKey(0)))
    with torch.no_grad():
        got = mine(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_forward(back, x)),
                               rtol=1e-5, atol=1e-5)
    # torch leaves restore as tensors, numpy ones as numpy
    tree = {"a": torch.zeros(2, 3), "c": [np.ones(4, np.float32)]}
    ckpt.save(str(tmp_path / "t.npz"), tree)
    like = ckpt.load(str(tmp_path / "t.npz"), tree)
    assert isinstance(like["a"], torch.Tensor)
    assert isinstance(like["c"][0], np.ndarray)
    with pytest.raises(ValueError):
        ckpt.load(tpath, params_to_jax(init_detector(
            DETECTOR_CONFIGS["ssd_lite"])))
    with pytest.raises(ValueError):
        jax_ckpt.load(tpath, jax_init(JAX_CONFIGS["ssd_lite"],
                                      jax.random.PRNGKey(0)))


def _near_half(score):
    return np.abs(score - 0.5) <= 1e-6 + 1e-5 * 0.5


def test_profile_pairs_equals_the_jax_table(jax_ssd_v1):
    pairs = [("ssd_v1", "pi5_tpu"), ("ssd_v1", "orin_nano"),
             ("ssd_v1", "pi3")]
    val = jax_scenes.full_dataset(80, seed=42)
    want = jax_train.profile_pairs({"ssd_v1": jax_ssd_v1}, pairs,
                                   val_scenes=val)
    model = params_from_jax(jax_ssd_v1, "ssd_v1")
    got = train.profile_pairs({"ssd_v1": model}, pairs,
                              val_scenes=scenes.full_dataset(80, seed=42),
                              device="cpu")
    imgs = np.stack([s.image for s in val])[..., None]
    with torch.no_grad():
        a = torch.sigmoid(model(torch.from_numpy(imgs))[..., 0]).numpy()
    b = 1 / (1 + np.exp(-np.asarray(jax.jit(jax_forward)(jax_ssd_v1,
                                                         imgs))[..., 0]))
    near_groups = {min(s.count, 4) for s, x, y in zip(val, a, b)
                   if _near_half(x).any() or _near_half(y).any()}
    assert len(got.entries) == len(want.entries) == 15
    assert any(0 < e.map_pct < 100 for e in got.entries)
    for e, w in zip(got.entries, want.entries):
        assert (e.model, e.device, e.group) == (w.model, w.device, w.group)
        assert (e.time_ms, e.energy_mwh) == (w.time_ms, w.energy_mwh)
        if e.group not in near_groups:
            assert e.map_pct == w.map_pct


# ------------------------------------ the port's own trained testbed

@pytest.fixture(scope="module")
def testbed():
    """The port's CPU-trained two-detector testbed: tests/test_system.py's
    fixture (250 steps, seeds 0 and 1, three pairs, full_dataset(80, 42)).

    Its weights are the port's own (torch's seeded init, oneDNN's
    gradients), not the JAX package's, so every bar below is a relation
    of tests/test_system.py, not an equality with the JAX results: HMG's
    mAP >= LE's - 2, LE <= Orc <= HMG in backend energy, ED's mAP >=
    Orc's - 10 and ED's gateway energy > Orc's, OB cheaper than ED at the
    gateway on video, SF's mAP and gateway energy > 0, Orc at δ = 0
    within 5 mAP of HMG, and Orc's energy not rising over δ = 0, 10, 100."""
    params = {
        "ssd_v1": train.train_detector(DETECTOR_CONFIGS["ssd_v1"],
                                       steps=250, seed=0, device="cpu"),
        "yolov8_n": train.train_detector(DETECTOR_CONFIGS["yolov8_n"],
                                         steps=250, seed=1, device="cpu"),
    }
    table = train.profile_pairs(
        params, [("ssd_v1", "pi5_tpu"), ("ssd_v1", "orin_nano"),
                 ("yolov8_n", "pi5_aihat")],
        val_scenes=scenes.full_dataset(80, seed=42), device="cpu")
    return params, table


def _run(testbed, router_cls, estimator, stream, delta=5.0):
    params, table = testbed
    return Gateway(router_cls(table, delta), table, params, estimator,
                   device="cpu").process_stream(stream)


def test_profile_table_structure(testbed):
    _, table = testbed
    assert len(table.pairs()) == 3
    assert {e.group for e in table.entries} == {0, 1, 2, 3, 4}
    assert all(e.energy_mwh > 0 and e.time_ms > 0 for e in table.entries)
    assert any(0 < e.map_pct < 100 for e in table.entries)


def test_hmg_upper_bounds_accuracy(testbed):
    stream = scenes.full_dataset(40, seed=11)
    hmg = _run(testbed, HighestMAPPerGroupRouter, None, stream)
    le = _run(testbed, LowestEnergyRouter, None, stream)
    assert hmg.map_pct >= le.map_pct - 2.0
    assert le.backend_energy_mwh <= hmg.backend_energy_mwh + 1e-9


def test_oracle_between_le_and_hmg(testbed):
    stream = scenes.full_dataset(40, seed=12)
    hmg = _run(testbed, HighestMAPPerGroupRouter, None, stream)
    orc = _run(testbed, OracleRouter, OracleEstimator(), stream)
    le = _run(testbed, LowestEnergyRouter, None, stream)
    assert le.backend_energy_mwh <= orc.backend_energy_mwh <= \
        hmg.backend_energy_mwh + 1e-9


def test_ed_router_close_to_oracle(testbed):
    stream = scenes.full_dataset(40, seed=13)
    orc = _run(testbed, OracleRouter, OracleEstimator(), stream)
    ed = _run(testbed, GreedyEstimateRouter,
              EdgeDetectionEstimator(device="cpu"), stream)
    assert ed.map_pct >= orc.map_pct - 10.0
    assert ed.gateway_energy_mwh > orc.gateway_energy_mwh


def test_ob_cheap_on_video(testbed):
    video = scenes.video_dataset(n_frames=50, seed=3)
    ob = _run(testbed, GreedyEstimateRouter, OutputBasedEstimator(), video)
    ed = _run(testbed, GreedyEstimateRouter,
              EdgeDetectionEstimator(device="cpu"), video)
    assert ob.gateway_energy_mwh < ed.gateway_energy_mwh
    assert ob.map_pct > 0


def test_sf_estimator_runs(testbed):
    params, _ = testbed
    sf = SSDFrontEndEstimator(params["ssd_v1"], "ssd_v1", device="cpu")
    stats = _run(testbed, GreedyEstimateRouter, sf,
                 scenes.full_dataset(15, seed=14))
    assert stats.map_pct > 0
    assert stats.gateway_energy_mwh > 0


def test_delta_zero_matches_hmg_choices(testbed):
    stream = scenes.full_dataset(30, seed=15)
    hmg = _run(testbed, HighestMAPPerGroupRouter, None, stream)
    orc0 = _run(testbed, OracleRouter, OracleEstimator(), stream, delta=0.0)
    assert abs(orc0.map_pct - hmg.map_pct) < 5.0


def test_delta_sweep_monotone_energy(testbed):
    stream = scenes.full_dataset(30, seed=16)
    energies = [_run(testbed, OracleRouter, OracleEstimator(), stream,
                     delta=d).backend_energy_mwh for d in (0.0, 10.0, 100.0)]
    assert energies[0] >= energies[1] >= energies[2]


def test_train_all_caches_and_default_testbed_reads_back(testbed, tmp_path,
                                                         monkeypatch):
    """``train_all`` trains what its cache lacks and loads what it holds
    (here the testbed's two detectors, saved as the JAX package saves);
    ``default_testbed`` writes the profile once and reads it back."""
    params, _ = testbed
    cache = tmp_path / "detectors"
    for name, model in params.items():
        ckpt.save(str(cache / f"{name}.npz"), params_to_jax(model))
    trained = []
    monkeypatch.setattr(
        train, "train_detector",
        lambda cfg, **kw: trained.append(cfg.name) or init_detector(cfg))
    out = train.train_all(str(cache), steps=2, device="cpu")
    assert sorted(out) == sorted(DETECTOR_CONFIGS)
    assert sorted(trained) == sorted(set(DETECTOR_CONFIGS) - set(params))
    assert sorted(os.listdir(cache)) == sorted(f"{n}.npz"
                                               for n in DETECTOR_CONFIGS)
    x = torch.from_numpy(np.random.default_rng(1).random((2, 64, 64, 1),
                                                         np.float32))
    with torch.no_grad():
        for name, model in params.items():
            assert out[name].cfg == DETECTOR_CONFIGS[name]
            torch.testing.assert_close(out[name](x), model(x), rtol=0,
                                       atol=0)
    path = str(tmp_path / "profile.json")
    _, table = train.default_testbed(str(cache), path, device="cpu")
    assert os.path.exists(path)
    _, again = train.default_testbed(str(cache), path, device="cpu")
    assert again.entries == table.entries


@pytest.mark.cuda
def test_training_on_the_card_follows_the_cpu():
    """Five steps of ssd_v1 from one init on the card and on the CPU:
    losses within rtol 1e-4 (full f32 convolutions on both)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: this test trains on the card, and "
                    "this machine has no GPU")
    cfg = DETECTOR_CONFIGS["ssd_v1"]
    cpu = train.fit_detector(init_detector(cfg, 0), steps=5)
    card = train.fit_detector(init_detector(cfg, 0).cuda(), steps=5)
    np.testing.assert_allclose(card, cpu, rtol=1e-4)


@pytest.mark.cuda
def test_adamw_update_on_the_card_equals_the_cpu():
    """30 unclipped steps on the same parameters and gradients: the card's
    multi-tensor update equals the CPU's bit for bit (true divisions, the
    f64 roundings of sqrt, pow and cos)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: this test runs the update on the "
                    "card, and this machine has no GPU")
    cfg = adamw.AdamWConfig(peak_lr=1e-2, warmup_steps=10, total_steps=30,
                            weight_decay=0.1, clip_norm=None)
    out = {}
    for dev in ("cpu", "cuda"):
        p = {k: torch.from_numpy(v).to(dev) for k, v in _opt_trees(0).items()}
        opt = adamw.init_opt_state(p)
        for i in range(30):
            g = {k: torch.from_numpy(v).to(dev)
                 for k, v in _opt_trees(100 + i).items()}
            p, opt, _ = adamw.adamw_update(cfg, p, g, opt)
        out[dev] = p
    for k in out["cpu"]:
        torch.testing.assert_close(out["cuda"][k].cpu(), out["cpu"][k],
                                   rtol=0, atol=0)

