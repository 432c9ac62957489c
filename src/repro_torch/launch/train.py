"""End-to-end training driver.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
      --steps 50 --d-model 128 --batch 8 --seq 128 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
      --full --steps 20 --batch 8 --seq 128          # on the card

The port of ``repro.launch.train``, with the same flags and printed lines,
plus ``--device`` (default ``cuda``; without a GPU pass ``--device cpu``).
It trains a REDUCED variant of the chosen architecture by default; pass
``--full`` to train the exact published config on the one device (the
port has no production mesh).  ``--layers`` is parsed and, as in the
reference, never read.  The parameters are f32 masters (the reference's
``pdtype``), the batches come from ``data/tokens.py``'s ``TokenStream``
and ``--save`` writes them through ``checkpoint/ckpt.py``.  After the
reference's lines it prints the device, the step time, tokens/s and the
peak device memory.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.data.tokens import DataConfig, TokenStream
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import init_params
from repro_torch.optim.adamw import AdamWConfig, init_opt_state, tree_leaves


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--d-model", type=int, default=None)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--full", action="store_true",
                    help="train the exact assigned config on the device")
    ap.add_argument("--save", default=None, help="checkpoint path (.npz)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if not args.full:
        overrides = {}
        if args.d_model:
            overrides["d_model"] = args.d_model
        cfg = cfg.reduced(**overrides)
    print(f"arch={cfg.name} family={cfg.family} layers={cfg.num_layers} "
          f"d_model={cfg.d_model} vocab={cfg.vocab_size}")

    opt_cfg = AdamWConfig(peak_lr=args.lr,
                          warmup_steps=min(20, args.steps // 5 + 1),
                          total_steps=args.steps)
    params = init_params(cfg, seed=0, device=dev, keep_f32=True)
    opt_state = init_opt_state(params)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"params: {n_params/1e6:.1f}M")

    stream = TokenStream(cfg, DataConfig(seq_len=args.seq,
                                         batch_size=args.batch))
    step_fn = make_train_step(cfg, opt_cfg)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    t_first = None
    for i, batch in enumerate(stream.batches(dev)):
        if i >= args.steps:
            break
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if i % args.log_every == 0 or i == args.steps - 1:
            m = {k: float(x) for k, x in metrics.items()}
            print(f"step {i:4d} loss={m['loss']:.4f} ce={m['ce']:.4f} "
                  f"lr={m['lr']:.2e} gnorm={m['grad_norm']:.2f} "
                  f"({time.time()-t0:.1f}s)")
        if i == 0:
            _sync(dev)
            t_first = time.time()
    _sync(dev)
    t_end = time.time()
    if args.save:
        ckpt.save(args.save, params)
        print(f"saved {args.save}")
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"device: {dev} ({name})")
    if t_first is not None and args.steps > 1:
        step_s = (t_end - t_first) / (args.steps - 1)
        print(f"step time: {step_s * 1e3:.1f} ms (mean of steps 1-"
              f"{args.steps - 1}; step 0 {(t_first - t0) * 1e3:.1f} ms); "
              f"{args.batch * args.seq / step_s:.0f} tokens/s")
    if dev.type == "cuda":
        print(f"peak device memory: "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    else:
        print("peak device memory: not measured (cpu)")
    return 0


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


if __name__ == "__main__":
    raise SystemExit(main())
