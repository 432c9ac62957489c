#!/usr/bin/env python3
"""Times one tree's flash-attention kernel, or its backward, at the main
path's shapes, so that two versions can be compared in turns on one card.

    python3 tools/flash_ab.py SRC LABEL [backward | decode]

SRC is the ``src`` directory of a tree of the port (this checkout's, or a
``git archive`` of another commit unpacked into a git-ignored directory),
LABEL names it in the output.  Run from the repository's root on a
machine with a GPU, once per tree and in turns (parent, change, change,
parent), each in a process of its own:

    git archive HEAD~1 src/repro_torch | tar -x -C artifacts/parent
    for t in parent change change parent; do
        src=src; [ $t = parent ] && src=artifacts/parent/src
        python3 tools/flash_ab.py $src $t
        python3 tools/flash_ab.py $src $t backward
    done

It builds that tree's ``flash_attention`` library (``flash_attention_bwd``
with ``backward``), prints its ptxas report (registers and spills per
kernel) and, for each shape, one JSON line: the call time (CUDA events,
the median of back-to-back calls) and the device time (profiler).  The
forward runs at ``SHAPES``; shapes without the causal mask need a tree
whose wrapper takes ``causal``.  The backward runs ``_launch_backward``
at the bf16 shapes of ``chip_smoke.FLASH_BWD`` (phase 43), its device
time the sum of its two kernels, each also apart.  ``decode`` times the
flash-decode kernel (``decode_attention``) at ``DECODE``'s bf16 shapes,
and again with its softmax statistics where the tree's wrapper takes
``stats``.
"""
from __future__ import annotations

import inspect
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(Path(sys.argv[1]).resolve()), str(ROOT)]

import torch  # noqa: E402

from chip_smoke import (FLASH_BWD, card_line, device_ms,  # noqa: E402
                        median_ms, randn)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402

#: (name, (B, H, KV, S, T, D), options): the causal prefills of the dense
#: models, then whisper-small's unmasked encoder and cross-attention
SHAPES = [("llama3-8b", (8, 32, 8, 1024, 1024, 128), {}),
          ("deepseek-7b", (8, 32, 32, 1024, 1024, 128), {}),
          ("llava-next-34b", (4, 56, 8, 3904, 3904, 128), {}),
          ("llama3-8b-swa", (1, 32, 8, 12288, 12288, 128), {"window": 4096}),
          ("gemma2-9b", (2, 16, 8, 6144, 6144, 256),
           {"window": 4096, "softcap": 50.0}),
          ("granite-moe-1b-a400m", (8, 16, 8, 256, 256, 64), {}),
          ("whisper-small decoder", (8, 12, 12, 128, 128, 64), {}),
          ("whisper-small encoder", (8, 12, 12, 1500, 1500, 64),
           {"causal": False}),
          ("whisper-small cross", (8, 12, 12, 128, 1500, 64),
           {"causal": False})]


def ptxas(name: str, label: str) -> None:
    """Build ``lib<name>.so`` of the tree and print its ptxas report: each
    kernel's registers and spilled bytes."""
    _build.build([name])
    log = (_build.BUILD_DIR / f"lib{name}.log").read_text()
    entry = re.compile(r"Compiling entry function '\w*?(flash_\w+?)I(\w+?)EEv")
    report, kernel, spilled = [], "?", "?"
    for ln in log.splitlines():
        found = entry.search(ln)
        if found:  # the last flash_ name: the first is the file's namespace
            fn = "flash_" + found.group(1).rsplit("flash_", 1)[1]
            args = found.group(2).replace("Li", "").replace("ELb", ",")
            kernel = f"{fn}<{args.replace('E', '')}>"
        spill = re.search(r"(\d+) bytes spill stores", ln)
        regs = re.search(r"Used (\d+) registers", ln)
        if spill:
            spilled = spill.group(1)
        if regs:
            report.append(f"{kernel} {regs.group(1)} regs {spilled} B spill")
    print(label, "ptxas:", "; ".join(report))


def forward(label: str, dev) -> None:
    ptxas("flash_attention", label)
    takes_causal = "causal" in ops.attention.__kwdefaults__
    for name, (b, h, kv, s, t, d), kw in SHAPES:
        if "causal" in kw and not takes_causal:
            continue
        q, k, v = randn([(b, h, s, d), (b, kv, t, d), (b, kv, t, d)],
                        torch.bfloat16, 23, dev)
        call = median_ms(lambda: ops.attention(q, k, v, **kw), reps=10,
                         inner=5)
        dev_ms = device_ms(lambda: ops.attention(q, k, v, **kw),
                           "flash_kernel", reps=5)
        print(json.dumps({"tree": label, "shape": name, "call_ms": call,
                          "device_ms": dev_ms}))


def backward(label: str, dev) -> None:
    ptxas("flash_attention_bwd", label)
    for name, (b, h, kv, s, t, d), dt, kw in FLASH_BWD:
        if dt != "bfloat16":
            continue
        q, k, v, do = randn([(b, h, s, d), (b, kv, t, d), (b, kv, t, d),
                             (b, h, s, d)], torch.bfloat16, 43 + s, dev)
        opts = (kw.get("causal", True), kw.get("window"), kw.get("softcap"))
        call = median_ms(lambda: ops._launch_backward(q, k, v, do, *opts),
                         reps=5, inner=2)
        parts = {}
        dev_ms = device_ms(lambda: ops._launch_backward(q, k, v, do, *opts),
                           "flash_bwd", reps=3, per_call=2, parts=parts)
        print(json.dumps({"tree": label, "shape": name,
                          "dims": [b, h, kv, s, t, d], "call_ms": call,
                          "device_ms": dev_ms, "kernels_ms": parts}))
        del q, k, v, do
        torch.cuda.empty_cache()


#: (name, (B, H, KV, T, D)): one decode step over a full cache of T rows
#: at the dry run's decode_32k batches a card (at 16 x 16: 8 rows), and a
#: 16-way sequence shard of llama3-8b's
DECODE = [("llama3-8b decode_32k", (8, 32, 8, 32768, 128)),
          ("llama3-8b, one of 16 sequence shards", (8, 32, 8, 2048, 128)),
          ("gemma2-9b decode_32k", (8, 16, 8, 32768, 256)),
          ("qwen2.5-3b decode_32k", (8, 16, 2, 32768, 128))]


def decode(label: str, dev) -> None:
    from repro_torch.kernels.decode_attention import ops as dec
    _build.build(["decode_attention"])
    has_stats = "stats" in inspect.signature(dec.decode).parameters
    for name, (b, h, kv, t, d) in DECODE:
        q, k, v = randn([(b, h, d), (b, kv, t, d), (b, kv, t, d)],
                        torch.bfloat16, 29, dev)
        lengths = torch.full((b,), t, dtype=torch.int32, device=dev)
        for stats in (False, True) if has_stats else (False,):
            kw = {"stats": True} if stats else {}
            fn = lambda: dec.decode(q, k, v, lengths, **kw)  # noqa: E731
            call = median_ms(fn, reps=10, inner=10)
            dev_ms = device_ms(fn, "decode_kernel", reps=5)
            print(json.dumps({"tree": label, "shape": name, "stats": stats,
                              "call_ms": call, "device_ms": dev_ms}))


def main() -> None:
    label = sys.argv[2]
    print(card_line())
    dev = torch.device("cuda")
    if sys.argv[3:] == ["backward"]:
        backward(label, dev)
    elif sys.argv[3:] == ["decode"]:
        decode(label, dev)
    else:
        forward(label, dev)


if __name__ == "__main__":
    main()
