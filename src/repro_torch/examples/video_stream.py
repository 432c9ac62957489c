"""Video-stream routing: the Output-Based (OB) estimator on temporal data.

  PYTHONPATH=src python -m repro_torch.examples.video_stream
  PYTHONPATH=src python -m repro_torch.examples.video_stream --device cpu

Reproduces the paper's Insight #3: on temporally-correlated streams, reusing
the previous frame's detected object count (OB) routes as accurately as
running an estimator per frame (ED), at near-zero gateway overhead.  Takes
``quickstart``'s ``--device``, ``--cache-dir`` and ``--profile``.
"""
from repro_torch.core import (EdgeDetectionEstimator, Gateway,
                              GreedyEstimateRouter, OracleEstimator,
                              OracleRouter, OutputBasedEstimator)
from repro_torch.detection.scenes import video_dataset
from repro_torch.detection.train import default_testbed
from repro_torch.examples.quickstart import testbed_args


def main(argv=None):
    dev, cache_dir, profile = testbed_args(argv)
    params, table = default_testbed(cache_dir, profile, device=dev)
    frames = video_dataset(n_frames=150, seed=4)
    counts = [s.count for s in frames]
    print(f"{len(frames)} frames; object counts drift: "
          f"{counts[:10]} ... {counts[-10:]}\n")

    for router, est, label in [
        (OracleRouter(table, 5.0), OracleEstimator(), "Orc (ideal)"),
        (GreedyEstimateRouter(table, 5.0), OutputBasedEstimator(), "OB"),
        (GreedyEstimateRouter(table, 5.0), EdgeDetectionEstimator(device=dev),
         "ED"),
    ]:
        stats = Gateway(router, table, params, est,
                        device=dev).process_stream(frames)
        print(f"{label:12s} mAP={stats.map_pct:5.1f}  "
              f"backendE={stats.backend_energy_mwh:7.4f} mWh  "
              f"gatewayE={stats.gateway_energy_mwh:8.5f} mWh  "
              f"latency={stats.total_time_ms:6.0f} ms")
    print("\nOB ~ Orc accuracy with ~zero gateway energy (Insight #3).")


if __name__ == "__main__":
    main()
