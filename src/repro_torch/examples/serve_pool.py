"""End-to-end serving driver: ECORE routing over a pool of LLM backends.

  PYTHONPATH=src python -m repro_torch.examples.serve_pool --requests 16
  PYTHONPATH=src python -m repro_torch.examples.serve_pool \
      --device cpu --reduced

The gateway buckets each request by prompt length (the serving analog of
the object count) and greedily picks the lowest-energy backend within the
delta accuracy tolerance; the requests are then served, batched prefill +
greedy decode, by the chosen architectures at full published width on the
GPU (``--reduced`` serves their reduced variants).  A thin wrapper over
``repro_torch.launch.serve``, which takes every flag; see
``service_quickstart`` for the service API in isolation.
"""
import sys

from repro_torch.launch.serve import main as serve_main


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    return serve_main(argv or ["--requests", "16"])


if __name__ == "__main__":
    sys.exit(main())
