"""Decode-time KV cache of the dense family's global-attention layers.

Layout: ``AttnCache.k`` / ``.v`` are [layers, B, KV, T, hd], so that one
layer's slice [B, KV, T, hd] is what the flash-decode kernel reads: for a
(batch, KV head), the cache rows lie contiguously along T.  The JAX
package keeps [n, B, W, KV, hd] with a ring buffer and a ``pos_buf`` of
the position held in each slot; for ``"attn"`` layers W == max_seq and
the ring never wraps, so slot == position and the valid rows of every
batch row are exactly [0, pos).  The port keeps no ``pos_buf``: the
decode kernel's ``lengths = pos + 1`` says the same.  Sliding-window
(``"local"``) layers, whose ring does wrap, are not ported.

The cache is written in place by ``prefill`` and ``decode_step``.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from .base import ModelConfig


class AttnCache(NamedTuple):
    k: torch.Tensor  # [n, B, KV, T, hd]
    v: torch.Tensor  # [n, B, KV, T, hd]


def init_cache(cfg: ModelConfig, bsz: int, max_seq: int, dtype,
               device) -> Dict[str, Any]:
    """Zeroed cache of a config with the ``("attn",)`` layout for
    ``decode_step``; ``pos`` (a Python int) counts the tokens so far."""
    shape = (cfg.n_blocks, bsz, cfg.num_kv_heads, max_seq, cfg.head_dim)
    return {"pos": 0, "blocks": {"s0": AttnCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device))}}
