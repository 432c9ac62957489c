#!/usr/bin/env python3
"""Where the port's detector training spends its time on one NVIDIA GPU,
and whether it repeats run to run.

    python3 tools/training_probe.py

Run from a checkout of the repository on a machine with a GPU; it builds
nothing.  For the smallest and the largest detector (ssd_v1, yolov8_m) it
prints:

- the reference's 700-step run on the card (deterministic cuDNN, as
  ``chip_smoke.py``'s phase 26 trains), and the time that drawing and
  uploading the same run's 700 batches of 16 scenes takes alone, with the
  host's share of the run;
- one training step's call time (CUDA events) and device time (profiler);

then whether two 100-step runs of yolov8_m from one init are bit-equal,
with cuDNN's default algorithms and with ``cudnn.deterministic`` on, and
what each run takes.  The card's name and power limit come first.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from chip_smoke import (TRAIN_STEPS, card_line, device_total_ms,  # noqa: E402
                        fail, median_ms)

MODELS = ("ssd_v1", "yolov8_m")


def host_share(dev) -> None:
    """A full training run beside the same run's batches drawn alone."""
    import numpy as np
    import torch
    from repro_torch.detection import scenes as sc
    from repro_torch.detection.detectors import DETECTOR_CONFIGS, init_detector
    from repro_torch.detection.train import batch_from_scenes, fit_detector
    for name in MODELS:
        model = init_detector(DETECTOR_CONFIGS[name], 0).to(dev)
        torch.backends.cudnn.deterministic = True
        try:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fit_detector(model, steps=TRAIN_STEPS)
            torch.cuda.synchronize()
            t_train = time.perf_counter() - t1
        finally:
            torch.backends.cudnn.deterministic = False
        rng = np.random.default_rng(17)
        t1 = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            batch_from_scenes([sc.make_scene(rng) for _ in range(16)], dev)
        torch.cuda.synchronize()
        t_host = time.perf_counter() - t1
        print(f"train {name}: {TRAIN_STEPS} steps in {t_train:.2f} s; "
              f"drawing and uploading its {TRAIN_STEPS} batches alone "
              f"{t_host:.2f} s, {t_host / t_train:.1%} of the run")


def step_device_time(dev) -> None:
    """One training step's call time and device time."""
    import numpy as np
    from repro_torch.detection import scenes as sc
    from repro_torch.detection.detectors import DETECTOR_CONFIGS, init_detector
    from repro_torch.detection.train import batch_from_scenes, train_step
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    rng = np.random.default_rng(0)
    batch = batch_from_scenes([sc.make_scene(rng) for _ in range(16)], dev)
    cfg = AdamWConfig(peak_lr=5e-3, warmup_steps=20, total_steps=TRAIN_STEPS,
                      weight_decay=1e-4)
    for name in MODELS:
        model = init_detector(DETECTOR_CONFIGS[name], 0).to(dev)
        state = [init_opt_state(dict(model.named_parameters()))]

        def step():
            state[0] = train_step(model, state[0], batch, cfg)[0]
        call = median_ms(step, reps=10, inner=5)
        busy = device_total_ms(step)
        print(f"train step {name}: {call:.4f} ms a call, device time "
              f"{busy} ms")


def reproducibility(dev) -> None:
    """Two 100-step runs of yolov8_m from one init, with and without
    ``cudnn.deterministic``."""
    import torch
    from repro_torch.detection.detectors import DETECTOR_CONFIGS, init_detector
    from repro_torch.detection.train import fit_detector
    for det in (False, True):
        runs = []
        for _ in range(2):
            model = init_detector(DETECTOR_CONFIGS["yolov8_m"], 0).to(dev)
            torch.backends.cudnn.deterministic = det
            try:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                losses = fit_detector(model, steps=100)
                secs = time.perf_counter() - t1
            finally:
                torch.backends.cudnn.deterministic = False
            runs.append((losses, [p.detach().clone()
                                  for p in model.parameters()], secs))
        (l1, w1, s1), (l2, w2, s2) = runs
        same = (l1 == l2).all() and all(torch.equal(a, b)
                                        for a, b in zip(w1, w2))
        drift = max(float((a - b).abs().max()) for a, b in zip(w1, w2))
        print(f"reproducibility, cudnn.deterministic={det}: two 100-step "
              f"yolov8_m runs {'bit-equal' if same else 'differ'} (max "
              f"|weight diff| {drift:.3g}, last losses {l1[-1]:.6f} / "
              f"{l2[-1]:.6f}); {s1:.2f} s and {s2:.2f} s")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an "
             "NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card_line()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    dev = torch.device("cuda")
    host_share(dev)
    step_device_time(dev)
    reproducibility(dev)


if __name__ == "__main__":
    main()
