#!/usr/bin/env python3
"""Where the bf16 gradient gap of a rematerialised training step comes
from: the layers' recompute, or the loss head's chunks and their table
casts.

    python3 tools/remat_head_probe.py [ARCH]

Run from the repository's root on a machine with a GPU.  ARCH (default
granite-moe-1b-a400m, ``chip_smoke.py`` phase 49's) at full width and
depth, bf16 layers over f32 masters, phase 49's 8 x 512 tokens, one loss
and gradient in five forms:

- ``kept``: no checkpoint, the head one product over every row (phase
  49's reference);
- ``remat``: checkpointed blocks and the head in checkpointed chunks, each
  chunk casting the table from its f32 master (the shipped form);
- ``remat, table cast once``: the same with the table cast once outside
  the chunks, its chunks' gradients summed in bf16 (the form before it);
- ``kept layers, chunked head`` and ``kept layers, chunked head, table
  cast once``: the layers kept, the head as in the two remat forms, so
  that against them only the layers' recompute differs.

It prints one JSON line a comparison: the worst leaf's largest error as a
share of its largest |value|, that leaf, the embedding table's share and
how many leaves are bit-equal; the card's name and power limit first.
"""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import MOE_TRAIN_ARGV, card_line, leaf_error  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models import cast_params, init_params  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.optim.adamw import tree_leaves, tree_paths  # noqa: E402


def loss(masters, cfg, data, layers_remat: bool, head: str):
    """The loss of ``data`` with the layers checkpointed or kept and the
    head ``whole``, ``chunks`` (each casting the f32 table) or ``once``
    (chunks of a table cast once)."""
    c = dataclasses.replace(cfg, remat=layers_remat)
    keep = {"blocks"} if layers_remat else set()
    if head == "chunks":
        keep.add("embed")
    p = dict(cast_params(c, {k: v for k, v in masters.items()
                             if k not in keep}),
             **{k: masters[k] for k in keep})
    x, aux = model._hidden(p, c, data["tokens"], None, True)
    table, labels = p["embed"]["table"], data["labels"]
    total = (model._head_nll(table, c, x, labels) if head == "whole"
             else model._chunked_nll(table, c, x, labels))
    ce = total / torch.clamp((labels != -1).sum(), min=1)
    return ce + model.AUX_WEIGHT * aux


def grads(masters, cfg, data, layers_remat, head):
    leaves = tree_leaves(masters)
    for x in leaves:
        x.requires_grad_(True)
    g = torch.autograd.grad(loss(masters, cfg, data, layers_remat, head),
                            leaves)
    for x in leaves:
        x.requires_grad_(False)
    return g


def compare(name, got, want, paths) -> None:
    worst, where, equal, table = 0.0, None, 0, 0.0
    for path, a, w in zip(paths, got, want):
        if torch.equal(a, w):
            equal += 1
            continue
        err, scale = leaf_error(a, w)
        if path == "embed/table":
            table = err / scale
        if err / scale > worst:
            worst, where = err / scale, path
    print(json.dumps({"compared": name, "worst_share": worst,
                      "worst_leaf": where, "table_share": table,
                      "bit_equal_leaves": equal, "leaves": len(paths)}),
          flush=True)


def main() -> None:
    arch = sys.argv[1] if len(sys.argv) > 1 else "granite-moe-1b-a400m"
    print(card_line())
    _build.build(["flash_attention", "flash_attention_bwd"])
    cfg = get_config(arch)
    b = int(MOE_TRAIN_ARGV[MOE_TRAIN_ARGV.index("--batch") + 1])
    s = int(MOE_TRAIN_ARGV[MOE_TRAIN_ARGV.index("--seq") + 1])
    masters = init_params(cfg, seed=49, device="cuda", keep_f32=True)
    paths = tree_paths(masters)
    rng = np.random.default_rng(49)
    data = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))
                                ).cuda() for k in ("tokens", "labels")}
    forms = {"kept": (False, "whole"), "remat": (True, "chunks"),
             "remat, table cast once": (True, "once"),
             "kept layers, chunked head": (False, "chunks"),
             "kept layers, chunked head, table cast once": (False, "once")}
    kept = grads(masters, cfg, data, *forms["kept"])
    for pair in (("kept layers, chunked head", "remat"),
                 ("kept layers, chunked head, table cast once",
                  "remat, table cast once")):
        base = grads(masters, cfg, data, *forms[pair[0]])
        compare(f"{pair[0]} against kept", base, kept, paths)
        other = grads(masters, cfg, data, *forms[pair[1]])
        compare(f"{pair[1]} against kept", other, kept, paths)
        compare(f"{pair[1]} against {pair[0]}", other, base, paths)
        del base, other
        torch.cuda.empty_cache()
    once = grads(masters, cfg, data, *forms["remat, table cast once"])
    compare("remat, table cast once against remat", once,
            grads(masters, cfg, data, *forms["remat"]), paths)


if __name__ == "__main__":
    main()
