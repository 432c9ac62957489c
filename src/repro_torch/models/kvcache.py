"""Decode-time caches: the K/V of attention layers and the recurrent state
of Mamba-2 and RG-LRU layers.

Layout: ``AttnCache.k`` / ``.v`` are [layers, B, KV, T, hd] for the dense
family, so that one layer's slice [B, KV, T, hd] is what the flash-decode
kernel reads: for a (batch, KV head), the cache rows lie contiguously along
T.  The JAX package keeps [n, B, W, KV, hd] with a ring buffer and a
``pos_buf`` of the position held in each slot; for ``"attn"`` layers
W == max_seq and the ring never wraps, so slot == position and the valid
rows of every batch row are exactly [0, pos).  The port keeps no
``pos_buf``: the decode kernel's ``lengths = pos + 1`` says the same.

The other layouts keep one entry per layer, in layer order, in a list
(the JAX package stacks each block slot on a leading layer dim):

- ``"ssm"``: an ``SSMState``, ``ssm`` [B, H, P, N] in f32 and ``conv``
  [B, K-1, ch] in the activation dtype;
- ``"rec"``: a ``RecState``, ``h`` [B, W] in f32 and ``conv`` [B, K-1, W];
- ``"local"`` (sliding-window attention): an ``AttnCache`` of this layer's
  K/V [B, KV, T, hd] with T = max_seq rows in position order.  The JAX
  ring holds min(window, max_seq) rows and wraps; the kernels' ``window``
  mask over the position-ordered rows reads exactly the ring's key set
  (positions > pos - window) at every position, wrapped or not.  Only the
  memory differs, and not at all up to max_seq = window.

The cache is written in place by ``prefill`` and ``decode_step``.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from .base import ModelConfig
from .rglru import rec_init_state
from .ssm import ssm_init_state


class AttnCache(NamedTuple):
    k: torch.Tensor  # [n, B, KV, T, hd] (one layer's entry: [B, KV, T, hd])
    v: torch.Tensor


def init_cache(cfg: ModelConfig, bsz: int, max_seq: int, dtype,
               device) -> Dict[str, Any]:
    """Zeroed cache for ``decode_step``; ``pos`` (a Python int) counts the
    tokens so far.  ``max_seq`` sizes the attention caches only."""
    kv_shape = (bsz, cfg.num_kv_heads, max_seq, cfg.head_dim)
    if cfg.block_layout == ("attn",):
        shape = (cfg.n_blocks,) + kv_shape
        return {"pos": 0, "blocks": {"s0": AttnCache(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device))}}

    def entry(kind):
        if kind == "ssm":
            return ssm_init_state(cfg, bsz, dtype, device)
        if kind == "rec":
            return rec_init_state(cfg, bsz, dtype, device)
        return AttnCache(k=torch.zeros(kv_shape, dtype=dtype, device=device),
                         v=torch.zeros(kv_shape, dtype=dtype, device=device))

    return {"pos": 0, "blocks": {"s0": [entry(k) for k in cfg.layer_kinds]}}
