#!/usr/bin/env python3
"""What ``chip_smoke.py``'s LM training phases do not measure on every
run, on one NVIDIA GPU.

    python3 tools/lm_train_probe.py
    python3 tools/lm_train_probe.py mamba2-370m [SRC LABEL]

Run from a checkout of the repository on a machine with a GPU; it builds
the kernels it runs.  The card's name and power limit come first; then,
with no arguments:

- where one training step of qwen2.5-3b at full width and depth (8 x 128
  tokens, f32 masters, bf16 layers, ``launch/steps.py``'s step) spends
  its time: the mean call time of 3 steps (host clock ending in a sync),
  then 2 steps under the profiler, their device time inside the loss
  (forward) and the optimizer (profiler ranges around ``loss_fn`` and
  ``adamw_update``; the backward is the rest of the busy time: autograd
  launches it from its own thread, outside any range of the step's), by
  kind of kernel (the flash kernel and its backward, matrix products,
  elementwise passes, the rest) and the device's busy share;
- what the build's ``--fmad=false`` costs the flash backward kernel: the
  kernel built with and without it, timed in turns (CUDA events; with,
  without, without, with) at qwen2.5-3b's and llama3-8b's shapes in
  bf16, and the two builds' largest difference.

With ``mamba2-370m``: the same breakdown of one mamba2-370m training step
at phase 47's shape (8 x 512 tokens, full width and depth), the SSD
kernel's forward and its backward apart, for the tree whose ``src``
directory is SRC (default this checkout's; a ``git archive`` of another
commit unpacked into a git-ignored directory), named LABEL in the output.
"""
from __future__ import annotations

import contextlib
import ctypes
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SRC = Path(sys.argv[2]).resolve() if len(sys.argv) > 2 else ROOT / "src"
sys.path[:0] = [str(ROOT), str(SRC)]

from chip_smoke import card_line, fail, in_range, median_ms, randn  # noqa: E402

#: kinds of kernel, by a piece of their names (the first that matches)
KINDS = (("flash backward", ("flash_bwd",)), ("flash", ("flash_kernel",)),
         ("SSD backward", ("ssd_bwd",)), ("SSD", ("ssd_kernel",)),
         ("matrix products", ("nvjet", "gemm", "Gemm", "xmma", "cutlass",
                              "gemv")),
         ("elementwise", ("elementwise", "reduce_kernel")))


def step_breakdown(dev, arch="qwen2.5-3b", seq=128, tree="") -> None:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import DataConfig, TokenStream
    from repro_torch.launch import steps
    from repro_torch.models import init_params
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    cfg = get_config(arch)
    params = init_params(cfg, device=dev, keep_f32=True)
    opt = init_opt_state(params)
    stream = TokenStream(cfg, DataConfig(seq_len=seq, batch_size=8))
    batches = [b for b, _ in zip(stream.batches(dev), range(7))]
    step = steps.make_train_step(cfg, AdamWConfig(warmup_steps=2,
                                                  total_steps=10))
    for b in batches[:2]:
        params, opt, _ = step(params, opt, b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[2:5]:
        params, opt, _ = step(params, opt, b)
    torch.cuda.synchronize()
    call = (time.perf_counter() - t0) / 3
    ranges = {"forward (loss)": (steps, "loss_fn"),
              "optimizer": (steps, "adamw_update")}
    with contextlib.ExitStack() as undo:
        for label, (module, attr) in ranges.items():
            undo.callback(setattr, module, attr, getattr(module, attr))
            setattr(module, attr, in_range(label, getattr(module, attr)))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in batches[5:]:
                params, opt, _ = step(params, opt, b)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / 2
    averages = prof.key_averages()
    kernels = [e for e in averages if e.device_type == DeviceType.CUDA
               and e.key not in ranges]
    busy = sum(e.self_device_time_total for e in kernels) / 2e3
    kinds = {}
    for e in kernels:
        kind = next((k for k, names in KINDS
                     if any(n in e.key for n in names)), "the rest")
        kinds[kind] = kinds.get(kind, 0.0) + e.self_device_time_total / 2e3
    inside = {label: sum(e.device_time_total for e in averages
                         if e.key == label
                         and e.device_type == DeviceType.CPU) / 2e3
              for label in ranges}
    inside["backward (the rest)"] = busy - sum(inside.values())
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    print(f"{arch} train step, 8 x {seq} tokens{tree}: {call * 1e3:.1f} ms "
          f"a call (3 steps); under the profiler {wall * 1e3:.1f} ms, device "
          f"busy {busy:.1f} ms = {busy / (wall * 1e3):.1%}; by range: " +
          ", ".join(f"{k} {v:.1f} ms" for k, v in inside.items()) +
          "; by kind: " + ", ".join(f"{k} {v:.1f} ms"
                                    for k, v in sorted(kinds.items())) +
          "; top: " + "; ".join(
              f"{e.key[:44]} {e.self_device_time_total / 2e3:.2f} ms "
              f"x{e.count // 2}" for e in top))


def fmad_cost(dev) -> None:
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fl_ops
    lib = _build.BUILD_DIR / "libflash_attention_bwd_fmad.so"
    flags = [f for f in _build.NVCC_FLAGS if f != "--fmad=false"]
    out = subprocess.run([_build._nvcc(), *flags, "-o", str(lib),
                          str(_build.CSRC / "flash_attention_bwd.cu")],
                         capture_output=True, text=True)
    if out.returncode:
        fail(f"nvcc without --fmad=false failed:\n{out.stdout}{out.stderr}")
    fused = getattr(ctypes.CDLL(str(lib)), "flash_attention_bwd")
    fused.argtypes, fused.restype = list(fl_ops._BWD_ARGTYPES), ctypes.c_int
    key = ("flash_attention_bwd", "flash_attention_bwd")
    plain = _build.function(*key, fl_ops._BWD_ARGTYPES)
    for label, (b, h, kv, s, d) in (("qwen2.5-3b", (8, 16, 2, 128, 128)),
                                    ("llama3-8b", (2, 32, 8, 1024, 128))):
        q, k, v, do = randn([(b, h, s, d), (b, kv, s, d), (b, kv, s, d),
                             (b, h, s, d)], torch.bfloat16, 7, dev)
        times, outs = {}, {}
        for name, fn in (("--fmad=false", plain), ("fused", fused),
                         ("fused", fused), ("--fmad=false", plain)):
            _build._functions[key] = fn
            outs[name] = fl_ops._launch_backward(q, k, v, do, True, None,
                                                 None)
            times.setdefault(name, []).append(median_ms(
                lambda: fl_ops._launch_backward(q, k, v, do, True, None,
                                                None), reps=5, inner=3))
        _build._functions[key] = plain
        diff = max(float((a.float() - c.float()).abs().max())
                   for a, c in zip(outs["--fmad=false"], outs["fused"]))
        print(f"flash backward {label} {(b, h, kv, s, d)} bf16: with "
              f"--fmad=false {times['--fmad=false']} ms, without "
              f"{times['fused']} ms (in turns: with, without, without, "
              f"with); largest difference of the two builds {diff:.3g}")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("no GPU: this probe runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import _build
    print(card_line(), flush=True)
    dev = torch.device("cuda")
    if sys.argv[1:2] == ["mamba2-370m"]:
        _build.build(["ssd_scan", "ssd_scan_bwd"])
        step_breakdown(dev, "mamba2-370m", 512,
                       f" ({sys.argv[3]})" if len(sys.argv) > 3 else "")
        return
    _build.build(["flash_attention", "flash_attention_bwd"])
    step_breakdown(dev)
    torch.cuda.empty_cache()
    fmad_cost(dev)


if __name__ == "__main__":
    main()
