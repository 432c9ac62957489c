#!/usr/bin/env python3
"""Times one tree's SSD backward kernel at phase 46's shapes and digests
its forward's outputs, so that two versions can be compared in turns on
one card.

    python3 tools/ssd_bwd_ab.py SRC LABEL

SRC is the ``src`` directory of a tree of the port (this checkout's, or a
``git archive`` of another commit unpacked into a git-ignored directory),
LABEL names it in the output.  Run from the repository's root on a
machine with a GPU, once per tree and in turns (parent, change, change,
parent), each in a process of its own:

    git archive PARENT src/repro_torch | tar -x -C artifacts/parent
    for t in parent change change parent; do
        src=src; [ $t = parent ] && src=artifacts/parent/src
        python3 tools/ssd_bwd_ab.py $src $t
    done

It builds that tree's ``ssd_scan`` and ``ssd_scan_bwd`` libraries and
prints their ptxas report (registers and spilled bytes per kernel); then,
for each case of ``chip_smoke.SSD_BWD`` (phase 46: the inputs drawn as
there), one JSON line: the call time of ``_launch_backward`` (CUDA
events, the median of back-to-back calls), its device time (profiler)
with each of its six kernels apart, and each gradient's largest error
against the plain backward in f64 as a share of phase 46's bar (4 times
the f32 plain backward's own largest error + 1e-7, + 2^-8 of each value
in bf16); last, the SHA-256 of the forward's outputs (y and the final
state) for fixed inputs in bf16 and f32, equal across trees whose
forward computes the same bits.
"""
from __future__ import annotations

import hashlib
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(Path(sys.argv[1]).resolve()), str(ROOT)]

import torch  # noqa: E402

from chip_smoke import (SSD_BWD, card_line, device_ms,  # noqa: E402
                        median_ms, ssd_inputs)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ssd_scan import ops, ref  # noqa: E402

NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD")
#: the forward's digests: (shape, chunk, dtype, element offset of x, B, C)
FORWARD = [((8, 512, 32, 64, 128), 256, torch.bfloat16, 0),
           ((2, 130, 4, 64, 128), 64, torch.bfloat16, 1),
           ((8, 512, 32, 64, 128), 256, torch.float32, 0)]


def ptxas(label: str) -> None:
    """Build the tree's SSD libraries and print each kernel's registers
    and spilled bytes."""
    _build.build(["ssd_scan", "ssd_scan_bwd"])
    for name in ("ssd_scan", "ssd_scan_bwd"):
        log = (_build.BUILD_DIR / f"lib{name}.log").read_text()
        report, kernel, spilled = [], "?", "?"
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                kernel = re.findall(r"\d+(ssd_[a-z_0-9]+)", ln)[-1]
                kernel += ("<bf16>" if "I13__nv_bfloat16E" in ln
                           else "<f32>" if "IfE" in ln else "")
            spill = re.search(r"(\d+) bytes spill stores", ln)
            regs = re.search(r"Used (\d+) registers", ln)
            if spill:
                spilled = spill.group(1)
            if regs:
                report.append(f"{kernel} {regs.group(1)} regs {spilled} B "
                              "spill")
        print(label, f"ptxas {name}:", "; ".join(report), flush=True)


def bar_shares(got, args, chunk, ds, dtype):
    """Each gradient's largest error against the f64 plain backward as a
    share of phase 46's bar."""
    want, plain = (ref.ssd_backward_reference(
        *(t.to(f) for t in args), chunk=chunk,
        d_state=None if ds is None else ds.to(f))
        for f in (torch.float64, torch.float32))
    rel = 2.0 ** -8 if dtype == torch.bfloat16 else 0.0
    shares = {}
    for name, g, w, p in zip(NAMES, got, want, plain):
        e32 = float((p.double() - w).abs().max())
        bar = 4 * e32 + 1e-7 + rel * w.abs()
        shares[name] = float(((g.double() - w).abs() / bar).max())
    return shares


def backward(label: str, dev) -> None:
    for name, shape, chunk, dt, kw in SSD_BWD:
        dtype = getattr(torch, dt)
        x, dtv, A, B, C, D = ssd_inputs(shape, 46 + sum(shape), dev, dtype,
                                        not kw.get("jax"),
                                        kw.get("offset", 0))
        gen = torch.Generator(device=dev).manual_seed(sum(shape))
        dy = torch.randn(x.shape, generator=gen, device=dev).to(dtype)
        ds = (torch.randn(shape[0], shape[2], shape[3], shape[4],
                          generator=gen, device=dev)
              if kw.get("d_state") else None)
        q = min(chunk, shape[1])
        args = (x, dtv, A, B, C, D)

        def call():
            return ops._launch_backward(*args, dy, ds, q)
        shares = bar_shares(call(), args + (dy,), chunk, ds, dtype)
        ms = median_ms(call, reps=10, inner=3)
        parts = {}
        dev_ms = device_ms(call, "ssd_bwd", reps=3, per_call=6, parts=parts)
        print(json.dumps({"tree": label, "case": name, "dims": shape,
                          "chunk": chunk, "dtype": dt,
                          "d_state": ds is not None, "call_ms": ms,
                          "device_ms": dev_ms, "kernels_ms": parts,
                          "bar_share": shares}), flush=True)
        del x, dtv, A, B, C, D, dy, ds, args
        torch.cuda.empty_cache()


def forward_digests(label: str, dev) -> None:
    for shape, chunk, dtype, offset in FORWARD:
        x, dtv, A, B, C, D = ssd_inputs(shape, 7, dev, dtype, True, offset)
        y, state = ops._launch(x, dtv, A, B, C, D, min(chunk, shape[1]))
        torch.cuda.synchronize()
        digest = hashlib.sha256()
        for t in (y, state):
            digest.update(t.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes())
        print(json.dumps({"tree": label, "forward": shape, "chunk": chunk,
                          "dtype": str(dtype), "offset": offset,
                          "sha256": digest.hexdigest()}), flush=True)


def main() -> None:
    label = sys.argv[2]
    print(card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    ptxas(label)
    backward(label, dev)
    forward_digests(label, dev)


if __name__ == "__main__":
    main()
