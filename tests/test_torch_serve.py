"""The port's serve driver (``repro_torch.launch.serve``) and its examples
(``repro_torch.examples``) against the JAX package's, on the CPU.

Both drivers run with the same deterministic stub ``Backend`` (tokens from
the prompt, times from the batch's shape and call count), monkeypatched
into each module, so every printed line is a function of routing,
batching and the closed loop: the lines are held equal with the wall-clock
fields stripped (as sorted lists where pod threads order them), and the
port's ``--rate`` lines labelled ``measured on`` are set aside.  One run
serves real reduced backends, f32, with the JAX weights carried across by
``params_from_jax``: routes and tokens equal.  The detection examples run
on a seeded two-detector testbed in both packages; their stats are held
at the detector tests' bar (histograms equal, floats within 1e-5
relative).
"""
import dataclasses
import importlib.util
import json
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from test_torch_core import _numpy_detector

from repro.core import profiles as jax_profiles
from repro.detection import devices as jax_devices
from repro.launch import serve as jax_serve
from repro.serving import engine as jax_engine
from repro.serving import pool as jax_pool
from repro_torch.core import profiles
from repro_torch.detection import devices
from repro_torch.detection.detectors import DETECTOR_CONFIGS, params_from_jax
from repro_torch.launch import serve
from repro_torch.models import params_from_jax as llm_params_from_jax
from repro_torch.serving import engine, pool

torch.set_num_threads(1)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
TWO_ARCHS = ["--archs", "qwen2.5-3b", "mamba2-370m"]


class _Stub:
    """A deterministic backend of either package (``result`` is that
    package's ``Result``): tokens from the prompt, prefill time from the
    prompt length and the call count, decode time from the batch size."""

    params = None

    def __init__(self, result, name, max_batch):
        self.result, self.name, self.max_batch = result, name, max_batch
        self.calls = 0

    def serve_batch(self, requests):
        self.calls += 1
        b, n = len(requests), len(requests[0].prompt)
        prefill = 1e-3 * (n + 5 * (self.calls % 3))
        return [self.result(uid=r.uid, tokens=(np.asarray(r.prompt[:6]) % 97
                                               ).astype(np.int32),
                            prefill_s=prefill, decode_s=2e-3 * b,
                            backend=self.name, batch_size=b)
                for r in requests]


def _stub(result):
    return lambda name, cfg, *a, max_batch=8, **kw: _Stub(result, name,
                                                          max_batch)


WALL = [(re.compile(r" in \d+\.\ds via "), " in <wall>s via "),
        (re.compile(r"\(\d+\.\ds wall\)"), "(<wall>s wall)")]


def _lines(text):
    out = []
    for line in text.splitlines():
        for pat, sub in WALL:
            line = pat.sub(sub, line)
        out.append(line)
    return out


def _drive(monkeypatch, capsys, argv, *, backends=None, port_flags=()):
    """(reference lines, port lines, port's measured lines) of one argv
    (the port's run on the CPU, with ``port_flags`` too), with stub
    backends unless ``backends`` gives the two factories."""
    ref_be, port_be = backends or (_stub(jax_engine.Result),
                                   _stub(engine.Result))
    monkeypatch.setattr(jax_serve, "Backend", ref_be)
    monkeypatch.setattr(serve, "Backend", port_be)
    argv = argv + ["--dryrun-artifact", "/nonexistent"]
    assert jax_serve.main(argv) == 0
    want = _lines(capsys.readouterr().out)
    assert serve.main(argv + ["--device", "cpu", *port_flags]) == 0
    got = _lines(capsys.readouterr().out)
    measured = [ln for ln in got if ln.startswith("measured on cpu")]
    return want, [ln for ln in got if ln not in measured], measured


CLOSED = [[], ["--adapt"], ["--async"], ["--async", "--adapt"],
          ["--max-batch", "3", "--delta", "18.5"],
          ["--pods", "2", "--shard", "least_loaded"],
          ["--pods", "2", "--shard", "rendezvous"]]


@pytest.mark.parametrize("flags", CLOSED,
                         ids=lambda f: " ".join(f) or "default")
def test_closed_loop_prints_the_references_lines(monkeypatch, capsys,
                                                 flags):
    argv = ["--requests", "20", "--max-batch", "4"] + flags
    want, got, measured = _drive(monkeypatch, capsys, argv)
    assert not measured
    assert sum(ln.startswith("req ") for ln in got) == 20
    if "--pods" in flags:   # pods serve from their own threads
        want, got = sorted(want), sorted(got)
    assert got == want


@pytest.mark.parametrize("pattern", ["poisson", "diurnal", "flash"])
@pytest.mark.parametrize("pods", [1, 2])
def test_open_loop_prints_the_references_slos(monkeypatch, capsys, pattern,
                                              pods):
    argv = ["--rate", "20", "--duration", "4", "--pattern", pattern,
            "--pods", str(pods), "--max-wait-ms", "25", "--delta", "10",
            "--deadline-ms", "40"]
    want, got, measured = _drive(monkeypatch, capsys, argv)
    assert got == want
    assert any(ln.startswith("summary: ") for ln in got)
    # wall time, one line per backend, tokens/s
    assert measured[0].startswith("measured on cpu: replay wall time")
    assert measured[-1].endswith("tokens/s") and len(measured) >= 3


@pytest.mark.parametrize("argv", [
    ["--pods", "0"], ["--async", "--pods", "2"], ["--duration", "5"],
    ["--pattern", "flash"], ["--deadline-ms", "10"], ["--rate", "0"],
    ["--rate", "5", "--async"], ["--rate", "5", "--adapt"],
    ["--shard", "random"]], ids=" ".join)
def test_bad_flags_exit_2_in_both(argv):
    for main in (jax_serve.main, serve.main):
        with pytest.raises(SystemExit) as exc:
            main(argv + ["--device", "cpu"] if main is serve.main else argv)
        assert exc.value.code == 2


def test_main_needs_a_gpu_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU, so the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--requests", "2"])


def _entries(table):
    return [(e.model, e.device, e.group, e.map_pct, e.time_ms,
             e.energy_mwh) for e in table.entries]


def test_profile_out_crosses_both_ways(monkeypatch, capsys, tmp_path):
    ref_out, port_out = tmp_path / "ref.json", tmp_path / "port.json"
    monkeypatch.setattr(jax_serve, "Backend", _stub(jax_engine.Result))
    monkeypatch.setattr(serve, "Backend", _stub(engine.Result))
    argv = ["--requests", "16", "--max-batch", "2", "--adapt",
            "--dryrun-artifact", "/nonexistent"] + TWO_ARCHS
    assert jax_serve.main(argv + ["--profile-out", str(ref_out)]) == 0
    assert serve.main(argv + ["--profile-out", str(port_out),
                              "--device", "cpu"]) == 0
    assert f"wrote adapted routing profile to {port_out}" in \
        capsys.readouterr().out
    port_read = jax_profiles.ProfileTable.from_json(str(port_out))
    ref_read = profiles.ProfileTable.from_json(str(ref_out), device="cpu")
    np.testing.assert_allclose(
        np.array([e[3:] for e in _entries(port_read)]),
        np.array([e[3:] for e in _entries(ref_read)]), rtol=1e-6)
    assert [e[:3] for e in _entries(port_read)] == \
        [e[:3] for e in _entries(ref_read)]
    pristine = _entries(serve.synthetic_pool_table(TWO_ARCHS[1:],
                                                   device="cpu"))
    assert _entries(port_read) != pristine   # the observations landed
    assert np.isfinite([e[3:] for e in _entries(port_read)]).all()


def test_pool_table_from_dryrun_equals_the_reference(tmp_path):
    rows = [dict(arch="qwen2.5-3b", mesh="16x16", shape="prefill_32k",
                 status="ok", t_step_s=0.25, energy_j=900.0,
                 params_active=3_100_000_000),
            dict(arch="mamba2-370m", mesh="16x16", shape="prefill_32k",
                 status="ok", t_step_s=0.03, energy_j=70.0,
                 params_active=370_000_000),
            dict(arch="llama3-8b", mesh="16x16", shape="prefill_32k",
                 status="failed"),
            dict(arch="llama3-8b", mesh="2x2", shape="prefill_32k",
                 status="ok", t_step_s=1.0, energy_j=10.0,
                 params_active=8_000_000_000),
            dict(arch="recurrentgemma-2b", mesh="16x16", shape="decode_32k",
                 status="ok", t_step_s=0.5, energy_j=50.0,
                 params_active=2_700_000_000)]
    path = tmp_path / "dryrun.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    for kw in ({}, {"shapes": ("prefill_32k", "decode_32k")},
               {"mesh": "2x2"}):
        want = _entries(jax_pool.pool_table_from_dryrun(str(path), **kw))
        got = _entries(pool.pool_table_from_dryrun(str(path), device="cpu",
                                                   **kw))
        assert got == want and got


def test_driver_reads_the_dryrun_artifact(monkeypatch, capsys, tmp_path):
    path = tmp_path / "dryrun.jsonl"
    path.write_text("".join(json.dumps(dict(
        arch=a, mesh="16x16", shape="prefill_32k", status="ok",
        t_step_s=t, energy_j=e, params_active=n)) + "\n" for a, t, e, n in (
            ("qwen2.5-3b", 0.2, 900.0, 3_100_000_000),
            ("mamba2-370m", 0.05, 400.0, 370_000_000),
            ("llama3-8b", 0.4, 2000.0, 8_000_000_000))))
    monkeypatch.setattr(jax_serve, "Backend", _stub(jax_engine.Result))
    monkeypatch.setattr(serve, "Backend", _stub(engine.Result))
    argv = ["--requests", "12", "--dryrun-artifact", str(path)] + TWO_ARCHS
    assert jax_serve.main(argv) == 0
    want = _lines(capsys.readouterr().out)
    assert serve.main(argv + ["--device", "cpu"]) == 0
    got = _lines(capsys.readouterr().out)
    assert got == want
    assert got[0] == f"pool profile from {path}: 2 backends"


def _f32(get_config):
    return lambda arch: dataclasses.replace(get_config(arch),
                                            activ_dtype="float32")


def test_reduced_backends_route_and_decode_as_the_reference(monkeypatch,
                                                            capsys):
    """Real reduced backends (f32) in both drivers, the port's weights the
    JAX backends' own: every request's route and tokens equal."""
    served = _drive_reduced(monkeypatch, capsys, ["--requests", "8",
                                                  "--max-new", "4"]
                            + TWO_ARCHS)
    assert {b for b, _ in served.values()} == {"qwen2.5-3b", "mamba2-370m"}


def test_whisper_beside_llama_routes_and_decodes_as_the_reference(
        monkeypatch, capsys):
    """``--archs whisper-small llama3-8b --delta 25.8 --reduced``: bucket 0
    (whisper-small's 46.58 within 25.8 of the capped 72.0) goes to
    whisper-small, every longer bucket to llama3-8b; each whisper batch
    draws its frames (enc_seq of them) at the driver's max_seq of 96.
    Routes and tokens equal the reference driver's."""
    served = _drive_reduced(monkeypatch, capsys, [
        "--archs", "whisper-small", "llama3-8b", "--delta", "25.8",
        "--requests", "16", "--max-new", "4"])
    assert {b for b, _ in served.values()} == {"whisper-small", "llama3-8b"}


def _drive_reduced(monkeypatch, capsys, argv):
    """Both drivers over ``argv`` with real reduced backends (f32): the
    routes of every request equal, each request served once and its
    tokens equal.  Returns the port's {uid: (backend, tokens)}."""
    monkeypatch.setattr(jax_serve, "get_config", _f32(jax_serve.get_config))
    monkeypatch.setattr(serve, "get_config", _f32(serve.get_config))
    jax_built, served = {}, {}

    def ref_backend(name, cfg, **kw):
        jax_built[name] = jax_engine.Backend(name, cfg, **kw)
        return jax_built[name]

    class Recorded(engine.Backend):
        def serve_batch(self, requests):
            out = super().serve_batch(requests)
            served.update({r.uid: (r.backend, r.tokens) for r in out})
            return out

    def port_backend(name, cfg, params, **kw):
        assert kw["max_seq"] == 96 and kw["device"] == torch.device("cpu")
        params = llm_params_from_jax(cfg, jax.tree_util.tree_map(
            np.asarray, jax_built[name].params), device="cpu")
        return Recorded(name, cfg, params, **kw)

    want_served = {}
    real_serve = jax_engine.Backend.serve_batch

    def ref_serve(self, requests):
        out = real_serve(self, requests)
        want_served.update({r.uid: (r.backend, r.tokens) for r in out})
        return out

    monkeypatch.setattr(jax_engine.Backend, "serve_batch", ref_serve)
    want, got, _ = _drive(monkeypatch, capsys, argv,
                          backends=(ref_backend, port_backend),
                          port_flags=["--reduced"])
    route = re.compile(r"^req +(\d+) len= *(\d+) bucket=(\d) -> (\S+)")
    assert [route.match(ln).groups() for ln in got if route.match(ln)] == \
        [route.match(ln).groups() for ln in want if route.match(ln)]
    n = int(argv[argv.index("--requests") + 1])
    assert sorted(served) == sorted(want_served) == list(range(n))
    for uid, (backend, tokens) in served.items():
        assert backend == want_served[uid][0]
        np.testing.assert_array_equal(tokens, np.asarray(want_served[uid][1]))
    return served


def test_pods_share_one_parameter_set_per_arch(monkeypatch, capsys):
    built = []

    class Counted(engine.Backend):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

    monkeypatch.setattr(serve, "Backend", Counted)
    assert serve.main(["--requests", "16", "--pods", "3", "--reduced",
                       "--device", "cpu", "--dryrun-artifact",
                       "/nonexistent"] + TWO_ARCHS) == 0
    capsys.readouterr()
    by_arch = {}
    for be in built:
        by_arch.setdefault(be.name, []).append(be)
    assert sum(len(b) for b in by_arch.values()) > len(by_arch)
    for backends in by_arch.values():
        assert all(be.params is backends[0].params for be in backends)


# ------------------------------------------------------------- examples

def _reference_example(name):
    spec = importlib.util.spec_from_file_location(f"_ref_example_{name}",
                                                  EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_load_test_prints_the_references_lines(capsys):
    from repro_torch.examples import load_test
    _reference_example("load_test").main()
    want = capsys.readouterr().out
    load_test.main(["--device", "cpu"])
    assert capsys.readouterr().out == want
    assert "autoscaler: " in want


def test_async_cluster_pairs_and_shards_equal_the_reference(capsys):
    from repro_torch.examples import async_cluster
    _reference_example("async_cluster").main()
    want = capsys.readouterr().out
    async_cluster.main(["--device", "cpu"])
    assert capsys.readouterr().out == want
    assert "shard_counts=" in want


def _routes(text):
    pat = re.compile(r"^req (\d+) \(len +(\d+)\) -> (\S+) +bucket=(\d)")
    return [pat.match(ln).groups() for ln in text.splitlines()
            if pat.match(ln)]


def test_service_quickstart_routes_equal_the_reference(capsys):
    from repro_torch.examples import service_quickstart
    _reference_example("service_quickstart").main()
    want = _routes(capsys.readouterr().out)
    service_quickstart.main(["--device", "cpu", "--reduced"])
    got = _routes(capsys.readouterr().out)
    assert got == want and len(got) == 6


def test_serve_pool_routes_equal_the_reference(monkeypatch, capsys):
    from repro_torch.examples import serve_pool
    monkeypatch.setattr(jax_serve, "Backend", _stub(jax_engine.Result))
    monkeypatch.setattr(serve, "Backend", _stub(engine.Result))
    # the reference script's own default argv
    _reference_example("serve_pool").main(["--requests", "16"])
    want = _lines(capsys.readouterr().out)
    serve_pool.main(["--requests", "16", "--device", "cpu"])
    assert _lines(capsys.readouterr().out) == want
    assert sum(ln.startswith("req ") for ln in want) == 16


@pytest.fixture(scope="module")
def two_detectors():
    """(JAX testbed, port testbed): ssd_v1 and yolov8_s drawn with one
    seed, carried across by ``params_from_jax``, and the nominal profile of
    their testbed pairs in each package."""
    rng = np.random.default_rng(5)
    jax_params = {m: _numpy_detector(DETECTOR_CONFIGS[m], rng)
                  for m in ("ssd_v1", "yolov8_s")}
    pairs = [p for p in devices.TESTBED_PAIRS if p[0] in jax_params]
    return ((jax_params, jax_devices.nominal_profile_table(pairs)),
            ({m: params_from_jax(p, m) for m, p in jax_params.items()},
             devices.nominal_profile_table(pairs, device="cpu")))


class _Spied:
    """A ``Gateway`` class whose episodes' stats land in ``stats``."""

    def __init__(self, gateway_cls):
        self.stats = []
        spy = self

        class Gateway(gateway_cls):
            def process_stream(self, stream):
                out = super().process_stream(stream)
                spy.stats.append(out)
                return out
        self.cls = Gateway


@pytest.mark.parametrize("name", ["quickstart", "video_stream"])
def test_detection_examples_equal_the_reference(monkeypatch, capsys,
                                                two_detectors, name):
    port = importlib.import_module(f"repro_torch.examples.{name}")
    ref = _reference_example(name)
    (jax_tb, port_tb), args = two_detectors, []
    monkeypatch.setattr(ref, "default_testbed", lambda *a, **kw: jax_tb)

    def port_testbed(cache_dir, profile, *a, device, **kw):
        args.append((cache_dir, profile, device))
        return port_tb

    monkeypatch.setattr(port, "default_testbed", port_testbed)
    spies = _Spied(ref.Gateway), _Spied(port.Gateway)
    monkeypatch.setattr(ref, "Gateway", spies[0].cls)
    monkeypatch.setattr(port, "Gateway", spies[1].cls)
    ref.main()
    port.main(["--device", "cpu", "--cache-dir", "x", "--profile", "y"])
    capsys.readouterr()
    assert args == [("x", "y", "cpu")]
    want, got = spies[0].stats, spies[1].stats
    assert len(got) == len(want) == 3
    n = 60 if name == "quickstart" else 150
    for g, w in zip(got, want):
        assert g.pair_histogram == w.pair_histogram
        assert sum(g.pair_histogram.values()) == n
        for f in ("map_pct", "backend_energy_mwh", "backend_time_ms",
                  "gateway_energy_mwh", "gateway_time_ms"):
            np.testing.assert_allclose(getattr(g, f), getattr(w, f),
                                       rtol=1e-5)
    assert any(s.map_pct > 0 for s in got)


# ------------------------------------------------- on a GPU (cuda marker)

@pytest.mark.cuda
def test_driver_on_the_card(capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU for the CUDA kernels")
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    ssd_ops.launches = 0
    assert serve.main(["--requests", "4", "--archs", "mamba2-370m",
                       "--dryrun-artifact", "/nonexistent"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert sum(ln.startswith("req ") and "mamba2-370m" in ln
               for ln in lines) == 4
    assert ssd_ops.launches >= 1
