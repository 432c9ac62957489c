#!/usr/bin/env python3
"""Build and run the PyTorch port of ECORE (``src/repro_torch``) on one
NVIDIA GPU, and check it.

    python3 chip_smoke.py

Phases, each printed as it ends; any failure exits non-zero:

1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc each,
   started together);
3. the Canny kernel against its plain PyTorch version on the card, exact
   equality, on the geometries of the JAX package's Canny tests, a
   >4096-wide frame, the gateway's batch, 1080p, 4K and a ragged batch;
4. the Sobel kernel against its plain version: magnitude within 1e-5 and
   at least 99.9 % of directions equal;
5. the detection gateway's main path through ``Gateway.process_stream``
   on 256 scenes, scanned closed loop and batched open loop, with every
   kernel launch count set to 0 just before each path and read just after;
6. the same 64-scene scanned episode on the GPU and on the CPU: equal
   decisions and pair histograms;
7. kernel and plain-version times (CUDA events: the median of 20 samples,
   each 10 back-to-back calls), and each kernel's device time from the
   profiler.

It then prints one JSON line per kernel, the card line, and last
``{"ok": true, "device": {...}}``.  It imports nothing of JAX or of the
JAX package ``repro``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: the card's peaks (NVIDIA H100 SXM data sheet): device memory bytes/s and
#: f32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

#: f32 operations per pixel, counted from the plain versions: blur 2 x (5
#: mul + 4 add); Sobel 2 x (2 mul + 4 add/sub), magnitude 2 mul + 1 add +
#: sqrt, direction atan2 + div + round (one each); NMS thin 1 mul
SOBEL_OPS_PER_PX = 12 + 4 + 3
CANNY_OPS_PER_PX = 18 + SOBEL_OPS_PER_PX + 1


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", flush=True)
    sys.exit(1)


def phase(name: str, t0: float) -> None:
    print(f"[phase] {name}: ok ({time.perf_counter() - t0:.2f} s)",
          flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def rand(shape, seed):
    import numpy as np
    return np.random.default_rng(seed).random(shape, np.float32)


def median_ms(fn, reps: int = 20, inner: int = 10) -> float:
    """Median over ``reps`` samples of the CUDA-event time of ``inner``
    back-to-back calls, per call, after a warm-up call.  Back to back, the
    host's wrapper overhead hides behind the device's queue whenever the
    kernel is the slower of the two."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    times.sort()
    return times[len(times) // 2]


def device_ms(fn, kernel: str, reps: int = 10):
    """Device time per call of the kernel whose name contains ``kernel``,
    from the profiler's trace of ``reps`` calls (None when the trace has
    no such kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.self_device_time_total for e in prof.key_averages()
          if kernel in e.key]
    return sum(us) / reps / 1e3 if us else None


def synced(fn):
    """(result, host seconds) of ``fn()`` ending in a device sync."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def bound_ms(n_px: int, bytes_per_px: int, ops_per_px: int):
    t_bytes = n_px * bytes_per_px / HBM_BYTES_PER_S * 1e3
    t_ops = n_px * ops_per_px / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> None:
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             "a checkout of the repository")
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an "
             "NVIDIA GPU")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import _build
    from repro_torch.kernels.canny_fused import ops as canny_ops
    from repro_torch.kernels.canny_fused import ref as canny_ref
    from repro_torch.kernels.sobel import ops as sobel_ops
    from repro_torch.kernels.sobel import ref as sobel_ref

    # 1 -------------------------------------------------------------- card
    t0 = time.perf_counter()
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    phase("1 card", t0)

    # 2 ------------------------------------------------------------- build
    t0 = time.perf_counter()
    seconds = _build.build()
    for name, s in seconds.items():
        log = (_build.BUILD_DIR / f"lib{name}.log").read_text()
        usage = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"built lib{name}.so in {s:.1f} s: {' | '.join(usage)}")
    phase("2 build", t0)
    dev = torch.device("cuda")

    # 3 ----------------------------------------------- Canny kernel vs plain
    t0 = time.perf_counter()
    shapes = [(1, 32, 32), (3, 64, 64), (1, 96, 64), (2, 40, 56),
              (1, 37, 41), (1, 64, 200), (2, 80, 600), (1, 48, 31),
              (1, 48, 65), (1, 48, 63), (1, 48, 64),
              (1, 24, 4224), (32, 64, 64), (256, 64, 64), (8, 1080, 1920),
              (1, 2160, 3840)]
    for shape in shapes:
        x = torch.from_numpy(rand(shape, sum(shape))).to(dev)
        for lo, hi in ((0.6, 1.0), (0.2, 0.5)):
            got = canny_ops.canny_edge(x, lo, hi)
            want = canny_ref.canny_edge(x, lo, hi)
            torch.cuda.synchronize()
            bad = int((got != want).sum())
            if bad:
                fail(f"canny kernel differs from its plain version at "
                     f"{shape} lo={lo} hi={hi}: {bad} pixels")
    print(f"canny: kernel == plain version on {len(shapes)} shapes x 2 "
          f"thresholds (tolerance: exact equality)")
    frames = [rand((1080, 1920), 1), rand((720, 1280), 2), rand((64, 64), 3),
              rand((1080, 1920), 4)]
    got = canny_ops.canny_edge_batch(frames)
    for f, g in zip(frames, got):
        want = canny_ref.canny_edge(torch.from_numpy(f)[None].to(dev))[0]
        if g.shape != f.shape or not np.array_equal(g, want.cpu().numpy()):
            fail(f"ragged canny_edge_batch differs at frame {f.shape}")
    print("canny: ragged 1080p/720p/64x64 batch == plain version per frame")
    phase("3 canny kernel", t0)

    # 4 ----------------------------------------------- Sobel kernel vs plain
    t0 = time.perf_counter()
    sobel_err = 0.0
    for shape in [(1, 32, 32), (3, 64, 64), (256, 64, 64), (8, 1080, 1920)]:
        x = torch.from_numpy(rand(shape, 7)).to(dev)
        m1, d1 = sobel_ops.sobel_grad(x)
        m2, d2 = sobel_ref.sobel_grad(x)
        err = float((m1 - m2).abs().max())
        same = float((d1 == d2).float().mean())
        print(f"sobel {shape}: max |mag err| {err:.3g} (tolerance 1e-5), "
              f"directions equal {same:.6f} (tolerance >= 0.999)")
        if err > 1e-5 or same < 0.999 or d1.dtype != torch.int32:
            fail(f"sobel kernel disagrees with its plain version at {shape}")
        sobel_err = max(sobel_err, err)
    phase("4 sobel kernel", t0)

    # 5 ------------------------------------------------ the gateway, on cuda
    from repro_torch.core.estimators import EdgeDetectionEstimator
    from repro_torch.core.gateway import Gateway
    from repro_torch.core.router import GreedyEstimateRouter
    from repro_torch.detection import scenes as sc
    from repro_torch.detection.detectors import DETECTOR_CONFIGS, init_detector
    from repro_torch.detection.devices import (drift_scenario,
                                               nominal_profile_table)

    models = ("ssd_v1", "ssd_lite", "yolov8_n", "yolov8_s")
    params = {m: init_detector(DETECTOR_CONFIGS[m], seed=i)
              for i, m in enumerate(models)}
    scenes = sc.drifting_dataset(256, seed=4)

    def episode(adapt, stream, device, delta=5.0, drifting="orin_nano"):
        table = nominal_profile_table(device=device)
        gw = Gateway(GreedyEstimateRouter(table, delta), table, params,
                     EdgeDetectionEstimator(device=device), adapt=adapt,
                     fleet=drift_scenario("thermal", drifting),
                     max_batch=32, device=device)
        return gw, gw.process_stream(stream)

    t0 = time.perf_counter()
    episode(True, scenes[:32], "cuda")        # warm-up: cuDNN, allocator
    main_launches = {"canny_fused": 0, "sobel": 0}
    for adapt, name in ((True, "scanned closed loop"),
                        (False, "batched open loop")):
        canny_ops.launches = 0
        sobel_ops.launches = 0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        gw, stats = episode(adapt, scenes, "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        n_canny, n_sobel = canny_ops.launches, sobel_ops.launches
        main_launches["canny_fused"] += n_canny
        main_launches["sobel"] += n_sobel
        state_dev = gw.table.as_state().map_pct.device
        print(f"gateway {name}: {len(scenes)} scenes in {wall:.3f} s; "
              f"canny launches {n_canny}, sobel launches {n_sobel}; "
              f"profile state on {state_dev}")
        print(f"  {stats}")
        if n_canny < 1:
            fail(f"the {name} never launched the canny kernel")
        if state_dev.type != "cuda":
            fail(f"the {name}'s profile state is on {state_dev}")
        if sum(stats.pair_histogram.values()) != len(scenes):
            fail(f"the {name} served {stats.pair_histogram}")
        if not all(np.isfinite(v) for v in (
                stats.map_pct, stats.backend_energy_mwh,
                stats.backend_time_ms, stats.gateway_energy_mwh)):
            fail(f"the {name} produced non-finite stats: {stats}")
    # where the scanned episode's time goes, stage by stage (outside the
    # counted main-path runs)
    from repro_torch.core.closed_loop import measurements_from_fleet
    from repro_torch.detection.canny import _label_count
    from repro_torch.detection.train import run_detector
    images = np.stack([s.image for s in scenes])
    edges, t_canny = synced(lambda: canny_ops.canny_edge(images).cpu())
    counts, t_count = synced(lambda: [_label_count(e)
                                      for e in edges.numpy()])
    table = nominal_profile_table()
    arrays = table.as_arrays()
    meas = measurements_from_fleet(arrays.pairs, len(scenes),
                                   drift_scenario("thermal"))
    from repro_torch.core.closed_loop import scan_stream
    _, t_scan = synced(lambda: scan_stream(
        arrays.state, counts, meas, arrays=arrays, delta=5.0))
    _, t_det = synced(lambda: [run_detector(params["yolov8_n"],
                                            images[i:i + 32])
                               for i in range(0, len(images), 32)])
    print(f"breakdown of the scanned episode ({len(scenes)} scenes): canny "
          f"launch + copies {t_canny * 1e3:.2f} ms, host component count "
          f"{t_count * 1e3:.1f} ms, scan_stream {t_scan * 1e3:.1f} ms, "
          f"detector batches {t_det * 1e3:.1f} ms")
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, t_prof = synced(lambda: episode(True, scenes, "cuda"))
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in kernels)
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
        print(f"profiler (scanned episode, {t_prof:.3f} s under the "
              f"profiler): device busy {busy_us / 1e3:.2f} ms = "
              f"{busy_us / 1e6 / t_prof:.2%} of the wall time, "
              f"{sum(e.count for e in kernels)} device ops; top: " + "; ".join(
                  f"{e.key[:40]} {e.self_device_time_total / 1e3:.2f} ms "
                  f"x{e.count}" for e in top))
    except Exception as exc:  # the profiler is untried on this machine
        print(f"profiler: not measured ({type(exc).__name__}: {exc})")
    phase("5 gateway", t0)

    # 6 ------------------------------------ the same episode on cuda and cpu
    t0 = time.perf_counter()
    from repro_torch.core.policy import DetectionPolicy, RouteRequest
    short = scenes[:64]
    reqs = [RouteRequest(uid=i, payload=s.image, true_complexity=s.count)
            for i, s in enumerate(short)]
    # delta 10 with drift on the pair the router favours: traffic moves
    for delta, drifting in ((5.0, "orin_nano"), (10.0, "pi5_tpu")):
        traces, hists = {}, {}
        for device in ("cuda", "cpu"):
            table = nominal_profile_table(device=device)
            policy = DetectionPolicy(
                GreedyEstimateRouter(table, delta), table,
                EdgeDetectionEstimator(device=device), adapt=True)
            meas = measurements_from_fleet(table.as_arrays().pairs,
                                           len(reqs),
                                           drift_scenario("thermal", drifting))
            traces[device] = [(d.pair, d.est_complexity)
                              for d in policy.decide_scan(reqs, meas)]
            hists[device] = episode(True, short, device, delta,
                                    drifting)[1].pair_histogram
        if traces["cuda"] != traces["cpu"] or hists["cuda"] != hists["cpu"]:
            fail(f"delta={delta}: the scanned episode differs between cuda "
                 f"and cpu: {hists}")
        print(f"delta={delta}: cuda == cpu over {len(reqs)} decisions; "
              f"pairs {hists['cuda']}")
    phase("6 cuda vs cpu", t0)

    # 7 ------------------------------------------------------------ timing
    t0 = time.perf_counter()
    for shape in [(256, 64, 64), (32, 64, 64), (8, 1080, 1920),
                  (1, 2160, 3840)]:
        x = torch.from_numpy(rand(shape, 11)).to(dev)
        n_px = x.numel()
        k = median_ms(lambda: canny_ops.canny_edge(x))
        p = median_ms(lambda: canny_ref.canny_edge(x))
        b, by = bound_ms(n_px, 5, CANNY_OPS_PER_PX)
        dk = device_ms(lambda: canny_ops.canny_edge(x), "canny_kernel")
        print(f"time canny {shape}: kernel {k:.4f} ms (device time "
              f"{dk} ms), plain {p:.4f} ms, bound {b:.4f} ms ({by})")
        ks = median_ms(lambda: sobel_ops.sobel_grad(x))
        ps = median_ms(lambda: sobel_ref.sobel_grad(x))
        bs, bys = bound_ms(n_px, 12, SOBEL_OPS_PER_PX)
        ds = device_ms(lambda: sobel_ops.sobel_grad(x), "sobel_kernel")
        print(f"time sobel {shape}: kernel {ks:.4f} ms (device time "
              f"{ds} ms), plain {ps:.4f} ms, bound {bs:.4f} ms ({bys})")
        if shape == (256, 64, 64):   # the gateway's batch on the main path
            x_main = x
            rows = {"canny": (k, p, b, by), "sobel": (ks, ps, bs, bys)}
    canny_err = int((canny_ops.canny_edge(x_main)
                     != canny_ref.canny_edge(x_main)).sum())
    m1, _ = sobel_ops.sobel_grad(x_main)
    m2, _ = sobel_ref.sobel_grad(x_main)
    sobel_err = max(sobel_err, float((m1 - m2).abs().max()))
    if canny_err or sobel_err > 1e-5:
        fail(f"kernels disagree at the main path's shape: canny {canny_err} "
             f"pixels, sobel {sobel_err}")
    phase("7 timing", t0)

    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.") or m == "repro"
                    or m.startswith("repro."))
    if leaked:
        fail(f"imported the JAX package or JAX: {leaked}")
    kernels = [
        {"name": "canny_fused", "route": "cuda",
         "source": "src/repro_torch/csrc/canny_fused.cu",
         "replaces": "src/repro/kernels/canny_fused/canny_fused.py:271",
         "launches": main_launches["canny_fused"],
         "max_abs_err": canny_err, "ms": rows["canny"][0],
         "plain_ms": rows["canny"][1], "bound_ms": rows["canny"][2],
         "bound_by": rows["canny"][3], "library_ms": None},
        {"name": "sobel", "route": "cuda",
         "source": "src/repro_torch/csrc/sobel.cu",
         "replaces": "src/repro/kernels/sobel/sobel.py:43",
         "launches": main_launches["sobel"],
         "max_abs_err": sobel_err, "ms": rows["sobel"][0],
         "plain_ms": rows["sobel"][1], "bound_ms": rows["sobel"][2],
         "bound_by": rows["sobel"][3], "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
