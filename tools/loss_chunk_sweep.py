#!/usr/bin/env python3
"""The skip rule's count of a ``train_4k`` step (``dryrun.train_step_bytes``:
the step's peak bytes on the meta device, two micro-batches of one
4096-token sequence) at each loss-head chunk size, and without remat.

    PYTHONPATH=src python3 tools/loss_chunk_sweep.py \\
        qwen2.5-3b,recurrentgemma-2b 0,256,512,1024,2048,4096

The first argument names the archs, the second the chunk sizes
(``models.model.LOSS_CHUNK_ROWS``); 0 runs the step with ``remat=False``.
The meta device holds no data, so a full-size step runs on any CPU in
5-15 s and allocates nothing of its size.
"""
from __future__ import annotations

import dataclasses
import sys
import time

from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.models import model
from repro_torch.models.base import INPUT_SHAPES


def main(argv) -> None:
    archs, chunks = argv[0].split(","), [int(c) for c in argv[1].split(",")]
    shape = INPUT_SHAPES["train_4k"]
    for arch in archs:
        for chunk in chunks:
            cfg = get_config(arch)
            if chunk:
                model.LOSS_CHUNK_ROWS = chunk
            else:
                cfg = dataclasses.replace(cfg, remat=False)
            dryrun.train_step_bytes.cache_clear()
            t0 = time.perf_counter()
            peak = dryrun.train_step_bytes(cfg, shape)
            print(f"{arch} chunk {chunk or 'none (remat off)'}: "
                  f"{peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB) in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
