#!/usr/bin/env python3
"""How much of phase 43's bar the flash backward kernel takes, element by
element, at a set of shapes: on a machine with a GPU, from the
repository's root,

    python3 tools/flash_bwd_shares.py [SRC]

SRC is the ``src`` directory of the tree of the port to measure (default
this checkout's; another commit's: ``git archive <commit> src/repro_torch``
unpacked under the git-ignored ``artifacts/``).

For each (B, H, KV, S, T, D) and options of ``SHAPES`` it runs
``_launch_backward`` on seeded bf16 inputs and, for dq, dk and dv, prints
the largest share of the bar (``chip_smoke.flash_bwd_check``'s: 4 times
the f32 plain backward's own largest error against f64, plus 1e-7, plus
2^-8 of each value; a share over 1 fails it), the same share of the f32
plain backward rounded to bf16 (what a kernel that rounds once from
exact sums would take), and the element where the kernel's share is
largest: its f64 value, the kernel's, and their difference beside the
bf16 rounding of the f64 value.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SRC = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else ROOT / "src"
sys.path[:0] = [str(SRC), str(ROOT)]

import torch  # noqa: E402

from chip_smoke import card_line, flash_bwd_plain, randn  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402

#: recurrentgemma-2b's local layer over a 4096-token training sequence
#: (G = 10) with and without its window, shorter, at G = 2 and at D = 128;
#: qwen2.5-3b's (G = 8); recurrentgemma-2b's phase-47 batch; gemma2-9b's
#: windowed softcapped layer (G = 2)
SHAPES = [((1, 10, 1, 4096, 4096, 256), {"window": 2048}),
          ((1, 10, 1, 4096, 4096, 256), {}),
          ((1, 10, 1, 2048, 2048, 256), {"window": 1024}),
          ((1, 10, 1, 1024, 1024, 256), {"window": 512}),
          ((1, 2, 1, 4096, 4096, 256), {"window": 2048}),
          ((1, 10, 1, 4096, 4096, 128), {"window": 2048}),
          ((1, 16, 2, 4096, 4096, 128), {}),
          ((8, 10, 1, 128, 128, 256), {"window": 2048}),
          ((2, 16, 8, 6144, 6144, 256), {"window": 4096, "softcap": 50.0})]


def shares(shape, kw, dev):
    """One line per gradient of the kernel at ``shape`` and ``kw``."""
    b, h, kv, s, t, d = shape
    q, k, v, do = randn([(b, h, s, d), (b, kv, t, d), (b, kv, t, d),
                         (b, h, s, d)], torch.bfloat16, 48, dev)
    opts = (kw.get("causal", True), kw.get("window"), kw.get("softcap"))
    got = ops._launch_backward(q, k, v, do, *opts)
    want = flash_bwd_plain(*(x.double() for x in (q, k, v, do)), **kw)
    plain32 = flash_bwd_plain(*(x.float() for x in (q, k, v, do)), **kw)
    lines = []
    for part, g, w, p in zip("qkv", got, want, plain32):
        e32 = float((p.double() - w).abs().max())
        bar = 4 * e32 + 1e-7 + 2.0 ** -8 * w.abs()
        share = (g.double() - w).abs() / bar
        rounded = float(((p.bfloat16().double() - w).abs() / bar).max())
        i = int(share.argmax())
        wi, gi = float(w.flatten()[i]), float(g.flatten()[i])
        ri = float((w.bfloat16().double() - w).abs().flatten()[i])
        at = [int(x) for x in torch.unravel_index(torch.tensor(i), w.shape)]
        lines.append(f"d{part}: share {float(share.max()):.3f} (the f32 plain "
                     f"backward rounded to bf16: {rounded:.3f}); worst at "
                     f"{at}: f64 {wi:.6g}, kernel {gi:.6g}, difference "
                     f"{abs(gi - wi):.3g} (bf16 rounding {ri:.3g})")
    return lines


def main() -> None:
    print(f"{card_line()}; the port from {SRC}", flush=True)
    _build.build(["flash_attention", "flash_attention_bwd"])
    dev = torch.device("cuda")
    for shape, kw in SHAPES:
        t0 = time.perf_counter()
        lines = shares(shape, kw, dev)
        print(f"{shape} {kw} ({time.perf_counter() - t0:.1f} s)\n  "
              + "\n  ".join(lines), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
