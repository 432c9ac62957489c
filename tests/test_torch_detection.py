"""The port's detection face against the JAX package's: scenes, the device
fleet, the detector family (same weights carried across) and decoding."""
import jax
import numpy as np
import pytest
import torch

from repro.detection import devices as jax_devices
from repro.detection import scenes as jax_scenes
from repro.detection.detectors import DETECTOR_CONFIGS as JAX_CONFIGS
from repro.detection.detectors import decode_detections as jax_decode
from repro.detection.detectors import detector_forward as jax_forward
from repro.detection.detectors import init_detector as jax_init
from repro.detection.train import run_detector as jax_run
from repro_torch.detection import devices, scenes
from repro_torch.detection.detectors import (DETECTOR_CONFIGS, _same,
                                             decode_detections,
                                             detector_forward,
                                             init_detector, params_from_jax)
from repro_torch.detection.train import run_detector

torch.set_num_threads(1)

TESTBED_MODELS = ("ssd_v1", "ssd_lite", "yolov8_n", "yolov8_s")


def _jax_params(name, seed=0):
    """The JAX package's seeded init, as numpy (jitted: eager
    truncated_normal compiles op by op)."""
    init = jax.jit(jax_init, static_argnums=0)
    return jax.tree_util.tree_map(
        np.array, init(JAX_CONFIGS[name], jax.random.PRNGKey(seed)))


def test_scenes_are_the_jax_packages():
    for a, b in zip(jax_scenes.drifting_dataset(12, seed=4),
                    scenes.drifting_dataset(12, seed=4)):
        np.testing.assert_array_equal(a.image, b.image)
        np.testing.assert_array_equal(a.boxes, b.boxes)
        assert a.count == b.count


def test_fleet_and_nominal_table_are_the_jax_packages():
    jt = jax_devices.nominal_profile_table()
    tt = devices.nominal_profile_table(device="cpu")
    assert [dataclass_tuple(e) for e in jt.entries] == \
        [dataclass_tuple(e) for e in tt.entries]
    for name in ("thermal", "background", "dropout"):
        jf = jax_devices.drift_scenario(name)
        tf = devices.drift_scenario(name)
        for d in ("orin_nano", "pi5"):
            np.testing.assert_array_equal(jf.cost_profile(d, 1e6, 300),
                                          tf.cost_profile(d, 1e6, 300))


def dataclass_tuple(e):
    return (e.model, e.device, e.group, e.map_pct, e.time_ms, e.energy_mwh)


@pytest.mark.parametrize("size,k,stride,want", [
    (64, 3, 2, (0, 1)), (63, 3, 2, (1, 1)), (64, 3, 1, (1, 1)),
    (8, 1, 1, (0, 0))])
def test_same_padding_is_xlas(size, k, stride, want):
    assert _same(size, k, stride) == want


@pytest.mark.parametrize("name", TESTBED_MODELS)
def test_forward_matches_jax_on_the_same_weights(name):
    np_params = _jax_params(name, seed=3)
    model = params_from_jax(np_params)
    assert model.cfg.channels == DETECTOR_CONFIGS[name].channels
    x = np.random.default_rng(0).random((3, 64, 64, 1), np.float32)
    want = np.asarray(jax.jit(jax_forward)(np_params, x))
    with torch.no_grad():
        got = detector_forward(model, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 8, 8, 8)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_run_detector_and_decode_match_jax():
    np_params = _jax_params("ssd_lite", seed=1)
    # scale the head so some cells clear the 0.5 objectness threshold
    np_params["head"]["b2"] = np_params["head"]["b2"] + 0.2
    imgs = np.stack([s.image for s in scenes.drifting_dataset(6, seed=2)])
    want = jax_run(np_params, imgs)
    got = run_detector(params_from_jax(np_params), imgs, device="cpu")
    assert sum(len(s) for _, s, _ in got) > 0
    for (b1, s1, c1), (b2, s2, c2) in zip(got, want):
        np.testing.assert_allclose(b1, b2, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(s1, s2, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(c1, c2)
    raw = np.random.default_rng(1).normal(0, 2, (8, 8, 8)).astype(np.float32)
    for a, b in zip(decode_detections(raw), jax_decode(raw)):
        np.testing.assert_array_equal(a, b)


def test_seeded_init_is_reproducible_and_truncated():
    a = init_detector(DETECTOR_CONFIGS["yolov8_n"], seed=7)
    b = init_detector(DETECTOR_CONFIGS["yolov8_n"], seed=7)
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0)
        if n.endswith("weight"):
            fan_in = p[0].numel()
            assert p.abs().max() <= 2.0 / fan_in ** 0.5 + 1e-6
