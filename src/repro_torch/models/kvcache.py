"""Decode-time caches: the K/V of the dense family's global-attention
layers, and the recurrent state of the ``ssm`` family's Mamba-2 layers.

Layout: ``AttnCache.k`` / ``.v`` are [layers, B, KV, T, hd], so that one
layer's slice [B, KV, T, hd] is what the flash-decode kernel reads: for a
(batch, KV head), the cache rows lie contiguously along T.  The JAX
package keeps [n, B, W, KV, hd] with a ring buffer and a ``pos_buf`` of
the position held in each slot; for ``"attn"`` layers W == max_seq and
the ring never wraps, so slot == position and the valid rows of every
batch row are exactly [0, pos).  The port keeps no ``pos_buf``: the
decode kernel's ``lengths = pos + 1`` says the same.  Sliding-window
(``"local"``) layers, whose ring does wrap, are not ported.

An ``("ssm",)`` config keeps one ``SSMState`` per layer instead, in a
list (the JAX package stacks them on a leading layer dim): ``ssm``
[B, H, P, N] in f32 and ``conv`` [B, K-1, ch] in the activation dtype.

The cache is written in place by ``prefill`` and ``decode_step``.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from .base import ModelConfig
from .ssm import ssm_init_state


class AttnCache(NamedTuple):
    k: torch.Tensor  # [n, B, KV, T, hd]
    v: torch.Tensor  # [n, B, KV, T, hd]


def init_cache(cfg: ModelConfig, bsz: int, max_seq: int, dtype,
               device) -> Dict[str, Any]:
    """Zeroed cache of a config with the ``("attn",)`` or ``("ssm",)``
    layout for ``decode_step``; ``pos`` (a Python int) counts the tokens
    so far.  ``max_seq`` sizes the attention cache only."""
    if cfg.block_layout == ("ssm",):
        return {"pos": 0, "blocks": {"s0": [
            ssm_init_state(cfg, bsz, dtype, device)
            for _ in range(cfg.n_blocks)]}}
    shape = (cfg.n_blocks, bsz, cfg.num_kv_heads, max_seq, cfg.head_dim)
    return {"pos": 0, "blocks": {"s0": AttnCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device))}}
