#!/usr/bin/env python3
"""Times one tree's Sobel kernel at ``chip_smoke.py``'s phase-7 shapes,
warm and with a cold L2, so that two versions can be compared in turns on
one card, and hashes its outputs, so that they can be compared bit for bit.

    python3 tools/sobel_ab.py SRC LABEL

SRC is the ``src`` directory of a tree of the port (this checkout's, or a
``git archive`` of another commit unpacked into a git-ignored directory),
LABEL names it in the output.  Run from the repository's root on a
machine with a GPU, once per tree and in turns (parent, change, change,
parent), each in a process of its own:

    mkdir -p artifacts/parent
    git archive HEAD~1 src/repro_torch | tar -x -C artifacts/parent
    for t in parent change change parent; do
        src=src; [ $t = parent ] && src=artifacts/parent/src
        python3 tools/sobel_ab.py $src $t
    done

It builds that tree's ``libsobel.so`` and prints its ptxas report
(registers and spills per kernel).  Where the toolkit has ``cuobjdump``,
it counts each kernel's SASS instructions per pixel: those of its row
loop (the span of its longest backward branch) over the pixels that span
computes (one ``FRND``, the direction's rounding, a pixel), or of its
whole body when it has no loop; the slow paths of the IEEE division and
square root, subroutines past the body, are left out.  Then for each
shape one JSON line: the call time (``chip_smoke.median_ms``), the
device time warm (``device_ms``) and with the L2 flushed before every
launch (a 128 MB buffer written between launches; only the Sobel
kernel's own time counts), the byte bound and the share of it each
reaches, the share of the call the host takes, the kernel launched, and a
SHA-256 of the ``mag`` and ``dir`` bytes for phase 7's seed: equal digests
across trees show equal outputs.
"""
from __future__ import annotations

import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(Path(sys.argv[1]).resolve()), str(ROOT)]

import torch  # noqa: E402

from chip_smoke import (SOBEL_OPS_PER_PX, bound_ms, card_line,  # noqa: E402
                        device_ms, median_ms, rand)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.sobel import ops  # noqa: E402

#: phase 7's shapes: the gateway's batch, a smaller one, 8 1080p frames, 4K
SHAPES = [(256, 64, 64), (32, 64, 64), (8, 1080, 1920), (1, 2160, 3840)]
#: bytes written between launches for a cold L2 (the H100's holds 50 MB)
FLUSH_BYTES = 128 << 20
#: lane-instructions a pixel the card can issue at the byte bound's pace
BUDGET_PER_PX = 120


def ptxas(label: str) -> None:
    """Build ``libsobel.so`` of the tree and print each kernel's registers
    and spilled bytes."""
    _build.build(["sobel"])
    log = (_build.BUILD_DIR / "libsobel.log").read_text()
    report, kernel, spilled = [], "?", "?"
    for ln in log.splitlines():
        found = re.search(r"Compiling entry function '(\w+)'", ln)
        if found:
            kernel = found.group(1)
        spill = re.search(r"(\d+) bytes spill stores", ln)
        regs = re.search(r"Used (\d+) registers", ln)
        if spill:
            spilled = spill.group(1)
        if regs:
            report.append(f"{kernel} {regs.group(1)} regs {spilled} B spill")
    print(label, "ptxas:", "; ".join(report))


def _cuobjdump():
    found = shutil.which("cuobjdump")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/cuobjdump")
    return str(default) if default.exists() else None


def sass_per_pixel(label: str) -> dict:
    """{mangled kernel name: SASS instructions per pixel} of the tree's
    library (empty without ``cuobjdump``)."""
    tool = _cuobjdump()
    if tool is None:
        print(label, "sass: no cuobjdump in this toolkit")
        return {}
    out = subprocess.run([tool, "-sass", str(_build.library_path("sobel"))],
                         capture_output=True, text=True, check=True).stdout
    result = parse_sass(out)
    print(label, "sass:", json.dumps(result))
    return result


def parse_sass(out: str) -> dict:
    """{mangled kernel name: its loop's (or body's) instructions, pixels and
    instructions a pixel} of ``cuobjdump -sass`` output."""
    result = {}
    for chunk in re.split(r"\n\s*Function : ", out)[1:]:
        name = chunk.split()[0]
        ins = []  # (address, text)
        labels = {}
        for ln in chunk.splitlines():
            lab = re.match(r"\s*(\.L_x_\d+):", ln)
            if lab:
                labels[lab.group(1)] = None
                continue
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.+?)\s*;", ln)
            if m:
                addr = int(m.group(1), 16)
                for k, v in labels.items():
                    if v is None:
                        labels[k] = addr
                ins.append((addr, m.group(2)))
        # the body ends at the first branch to itself (the trap after EXIT)
        end = len(ins)
        for i, (addr, text) in enumerate(ins):
            tgt = _target(text, labels)
            if "BRA" in text and tgt == addr:
                end = i
                break
        body = ins[:end]
        loops = [(tgt, addr) for addr, text in body if "BRA" in text
                 for tgt in [_target(text, labels)]
                 if tgt is not None and tgt < addr]
        if loops:
            lo, hi = max(loops, key=lambda t: t[1] - t[0])
            span = [t for a, t in body if lo <= a <= hi]
        else:
            span = [t for _, t in body]
        # a pixel's direction: rintf's FRND, or F2I rounding to nearest
        px = (sum(1 for t in span if re.match(r"(@\S+ )?FRND\b", t))
              or sum(1 for t in span if re.match(r"(@\S+ )?F2I\.NTZ\b", t)))
        result[name] = {"instructions": len(span), "pixels": px,
                        "per_pixel": len(span) / px if px else None,
                        "loop": bool(loops)}
    return result


def _target(text: str, labels: dict):
    m = re.search(r"BRA\s+(?:\S+\s+)?`?\(?(\.L_x_\d+)\)?", text)
    if m:
        return labels.get(m.group(1))
    m = re.search(r"BRA\s+(?:\S+\s+)?(0x[0-9a-f]+)", text)
    return int(m.group(1), 16) if m else None


def _mangled(key: str) -> str:
    """The fragment of the mangled name of the kernel the profiler calls
    ``key``: its template arguments as the Itanium ABI writes them."""
    m = re.search(r"sobel_kernel<([^>]*)>", key)
    if not m:
        return "sobel_kernel"
    args = [a.strip() for a in m.group(1).split(",")]
    return "sobel_kernelI" + "".join(
        f"Lb{int(a == 'true')}E" if a in ("true", "false") else f"Li{a}E"
        for a in args) + "E"


def launched_kernel(fn):
    """The profiler's name of the Sobel kernel that ``fn`` launches (None
    when three traces in a row lost it, as short traces on the H100
    machine do at random)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        keys = [e.key for e in prof.key_averages()
                if "sobel_kernel" in e.key]
        if keys:
            return keys[0]
    return None


def main() -> None:
    label = sys.argv[2]
    print(card_line())
    dev = torch.device("cuda")
    ptxas(label)
    sass = sass_per_pixel(label)
    flush = torch.empty(FLUSH_BYTES // 4, device=dev)
    for shape in SHAPES:
        x = torch.from_numpy(rand(shape, 11)).to(dev)
        call = median_ms(lambda: ops.sobel_grad(x))
        warm = device_ms(lambda: ops.sobel_grad(x), "sobel_kernel")
        cold = device_ms(lambda: (flush.fill_(1.0), ops.sobel_grad(x)),
                         "sobel_kernel")
        bound, by = bound_ms(x.numel(), 12, SOBEL_OPS_PER_PX)
        mag, direction = ops.sobel_grad(x)
        torch.cuda.synchronize()
        digest = hashlib.sha256(mag.cpu().numpy().tobytes()
                                + direction.cpu().numpy().tobytes())
        key = launched_kernel(lambda: ops.sobel_grad(x))
        frag = _mangled(key) if key else None
        per_px = [v["per_pixel"] for k, v in sass.items()
                  if frag and frag in k]
        print(json.dumps({
            "tree": label, "shape": list(shape), "call_ms": call,
            "device_ms": warm, "device_ms_cold": cold, "bound_ms": bound,
            "bound_by": by,
            "share_warm": bound / warm if warm else None,
            "share_cold": bound / cold if cold else None,
            "host_share": 1 - warm / call if warm else None,
            "kernel": key and re.search(r"sobel_kernel(<[^>]*>)?",
                                        key).group(0),
            "sass_per_px": per_px[0] if per_px else None,
            "budget_per_px": BUDGET_PER_PX,
            "sha256": digest.hexdigest()}), flush=True)


if __name__ == "__main__":
    main()
