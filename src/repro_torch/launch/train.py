"""End-to-end training driver.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
      --steps 50 --d-model 128 --batch 8 --seq 128 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
      --full --steps 20 --batch 8 --seq 128          # on the card
  PYTHONPATH=src torchrun --nnodes 32 --nproc-per-node 8 \\
      --rdzv-endpoint HOST:PORT -m repro_torch.launch.train \\
      --arch llama3-8b --full --batch 256 --seq 4096 # on 256 cards

The port of ``repro.launch.train``, with the same flags and printed lines,
plus ``--device`` (default ``cuda``; without a GPU pass ``--device cpu``).
It trains a REDUCED variant of the chosen architecture by default; pass
``--full`` to train the exact published config.  Run alone it trains on
one device.  Under ``torchrun`` (its ``WORLD_SIZE`` above 1) each process
joins the NCCL process group and drives the card ``LOCAL_RANK`` as its
rank of the reference's production mesh (``launch/mesh.py``): 16 x 16
(data x model) for a world of 256, 2 x 16 x 16 for 512; another world
size raises.  The parameters and AdamW moments are then the rank's
shards (``models.init_shards``), every rank draws the same global batch
and the step takes its rows (``launch/steps.py``); rank 0 prints.
``--layers`` is parsed and, as in the reference, never read.  The
parameters are f32 masters (the reference's ``pdtype``), the batches
come from ``data/tokens.py``'s ``TokenStream`` and ``--save`` writes them
through ``checkpoint/ckpt.py`` (one device only).  After the reference's
lines it prints the device, the step time, tokens/s and the peak device
memory.
"""
from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.data.tokens import DataConfig, TokenStream
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import init_params
from repro_torch.models.model import init_shards
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
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        return _train(args, resolve_device(args.device), None, print)
    dev = resolve_device(torch.device("cuda", int(os.environ["LOCAL_RANK"])))
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", device_id=dev)
    try:
        mesh = make_production_mesh(multi_pod=world == 512)
        say = print if dist.get_rank() == 0 else (lambda *a, **k: None)
        return _train(args, dev, mesh, say)
    finally:
        dist.destroy_process_group()


def _train(args, dev, mesh, say) -> int:
    """The run on ``dev``; on ``mesh`` one rank's, printing through
    ``say``."""

    cfg = get_config(args.arch)
    if not args.full:
        overrides = {}
        if args.d_model:
            overrides["d_model"] = args.d_model
        cfg = cfg.reduced(**overrides)
    say(f"arch={cfg.name} family={cfg.family} layers={cfg.num_layers} "
        f"d_model={cfg.d_model} vocab={cfg.vocab_size}")

    opt_cfg = AdamWConfig(peak_lr=args.lr,
                          warmup_steps=min(20, args.steps // 5 + 1),
                          total_steps=args.steps)
    if mesh is None:
        params = init_params(cfg, seed=0, device=dev, keep_f32=True)
    else:
        params = init_shards(cfg, mesh, seed=0, device=dev, keep_f32=True)
    n_params = sum(x.numel() for x in tree_leaves(
        init_params(cfg, device="meta")))
    opt_state = init_opt_state(params)
    say(f"params: {n_params/1e6:.1f}M")

    stream = TokenStream(cfg, DataConfig(seq_len=args.seq,
                                         batch_size=args.batch))
    step_fn = make_train_step(cfg, opt_cfg, mesh=mesh)
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
            say(f"step {i:4d} loss={m['loss']:.4f} ce={m['ce']:.4f} "
                f"lr={m['lr']:.2e} gnorm={m['grad_norm']:.2f} "
                f"({time.time()-t0:.1f}s)")
        if i == 0:
            _sync(dev)
            t_first = time.time()
    _sync(dev)
    t_end = time.time()
    if args.save and mesh is None:
        ckpt.save(args.save, params)
        print(f"saved {args.save}")
    elif args.save:
        say(f"not saved: {args.save} would hold rank 0's shards only")
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    say(f"device: {dev} ({name})" + ("" if mesh is None else
                                     f", rank 0 of {mesh.size()}"))
    if t_first is not None and args.steps > 1:
        step_s = (t_end - t_first) / (args.steps - 1)
        say(f"step time: {step_s * 1e3:.1f} ms (mean of steps 1-"
            f"{args.steps - 1}; step 0 {(t_first - t0) * 1e3:.1f} ms); "
            f"{args.batch * args.seq / step_s:.0f} tokens/s")
    if dev.type == "cuda":
        say(f"peak device memory: "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    else:
        say("peak device memory: not measured (cpu)")
    return 0


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


if __name__ == "__main__":
    raise SystemExit(main())
