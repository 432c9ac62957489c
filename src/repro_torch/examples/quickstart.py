"""Quickstart: route a stream of scenes through the ECORE gateway.

  PYTHONPATH=src python -m repro_torch.examples.quickstart
  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

Trains (or loads cached) detectors, builds the profiling table, and compares
the paper's proposed ED router against the accuracy-centric (HMG) and
energy-centric (LE) baselines on a small scene stream — the 60-second
version of the paper's Figure 6 experiment.  ``--cache-dir`` and
``--profile`` name the testbed's checkpoints and profile (default: the
JAX package's ``artifacts/`` paths; either package's files load).
"""
import argparse

from repro_torch.core import (EdgeDetectionEstimator, Gateway,
                              GreedyEstimateRouter, HighestMAPPerGroupRouter,
                              LowestEnergyRouter)
from repro_torch.detection.scenes import full_dataset
from repro_torch.detection.train import default_testbed


def testbed_args(argv):
    """(device, cache dir, profile path) from the detection examples'
    flags."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cache-dir", default="artifacts/detectors")
    ap.add_argument("--profile", default="artifacts/profile_table.json")
    args = ap.parse_args(argv)
    return args.device, args.cache_dir, args.profile


def main(argv=None):
    dev, cache_dir, profile = testbed_args(argv)
    print("loading testbed (first run trains 8 detectors, ~10 min) ...")
    params, table = default_testbed(cache_dir, profile, verbose=True,
                                    device=dev)
    scenes = full_dataset(60, seed=1)
    print(f"\nrouting {len(scenes)} scenes, delta_mAP = 5\n")

    for router, est, label in [
        (HighestMAPPerGroupRouter(table, 5.0), None, "HMG (accuracy-centric)"),
        (GreedyEstimateRouter(table, 5.0), EdgeDetectionEstimator(device=dev),
         "ED (ECORE, proposed)"),
        (LowestEnergyRouter(table, 5.0), None, "LE (energy floor)"),
    ]:
        stats = Gateway(router, table, params, est,
                        device=dev).process_stream(scenes)
        print(f"{label:26s} mAP={stats.map_pct:5.1f}  "
              f"energy={stats.total_energy_mwh:7.4f} mWh  "
              f"latency={stats.total_time_ms:6.0f} ms")
        for pair, n in sorted(stats.pair_histogram.items()):
            print(f"    {pair:26s} x{n}")
    print("\nED should sit near HMG's accuracy at a fraction of its energy.")


if __name__ == "__main__":
    main()
