"""Decode-time caches: the K/V (or MLA's latent rows) of attention layers
and the recurrent state of Mamba-2 and RG-LRU layers.

Layout: ``AttnCache.k`` / ``.v`` are [layers, B, KV, T, hd] for the
``("attn",)`` layout without MLA (the dense, moe and vlm families), so
that one layer's slice [B, KV, T, hd] is what
the flash-decode kernel reads: for a (batch, KV head), the cache rows lie
contiguously along T.  The JAX package keeps [n, B, W, KV, hd] with a ring
buffer and a ``pos_buf`` of the position held in each slot; for ``"attn"``
layers W == max_seq and the ring never wraps, so slot == position and the
valid rows of every batch row are exactly [0, pos).  The port keeps no
``pos_buf``: the decode kernel's ``lengths = pos + 1`` says the same, and
a config with a global layer raises past max_seq
(``bounded_by_max_seq``).

The other layouts keep one entry per layer, in layer order, in a list
(the JAX package stacks each block slot on a leading layer dim):

- ``"ssm"``: an ``SSMState``, ``ssm`` [B, H, P, N] in f32 and ``conv``
  [B, K-1, ch] in the activation dtype;
- ``"rec"``: a ``RecState``, ``h`` [B, W] in f32 and ``conv`` [B, K-1, W];
- ``"attn"``: an ``AttnCache`` of this layer's K/V [B, KV, max_seq, hd] in
  position order, as above; with MLA (``cfg.use_mla``), an ``MLACache``
  of this layer's latent rows, ``c`` [B, max_seq, r] and ``kr`` [B,
  max_seq, dr] in the activation dtype, position p at row p (the JAX
  package's ``MLACache``);
- ``"local"`` (sliding-window attention): an ``AttnCache`` of this
  layer's K/V [B, KV, R, hd], a ring: position p lives in slot p % R, and
  the ring wraps without bound.  ``R = ring_rows(cfg, max_seq)`` is the
  row count that holds exactly the JAX ring's key set once the new token
  is written.  The JAX ring has W = min(window, max_seq) slots, and its
  decode (``attention_decode_v2``) attends the old ring plus the new
  token, masking the slot about to be overwritten (position pos - W) only
  when it lies outside the window.  So it attends the last W positions
  when W == window, and the last W + 1 when max_seq < window.  R = window
  or max_seq + 1 rows, written at pos % R before the decode kernel reads
  them, give that key set with every row valid, so the kernel reads the
  ring's first min(pos + 1, R) rows with no window and no ``pos_buf``.

The encdec family (whisper) keeps the decoder's self-attention K/V
stacked as above, [dec_layers, B, KV, max_seq, hd], and the
cross-attention K/V of every decoder layer, ``cross_k`` / ``cross_v``
[dec_layers, B, KV, enc_seq, hd] in the activation dtype, computed once
from the encoder's output in prefill and read at every decode step.  The
JAX package allocates the same rows as [dec_layers, B, enc_seq, KV, hd];
the port keeps them in the layout of its other K/V caches, the one the
kernels read with each (batch, KV head)'s rows contiguous.

The cache is written in place by ``prefill`` and ``decode_step``.

On a mesh (``init_cache(..., mesh)``) a rank holds its shard of each
attention layer's K/V by ``sharding.specs.decode_cache_layout``: its KV
heads (``kv``: the KV heads divide the 'model' axis), its rows of every
head (``seq``: rank r the rows [r T/m, (r+1) T/m) of T), or all of them
(``none``); the caller passes the rank's batch rows.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from repro_torch.sharding import specs

from .base import ModelConfig
from .rglru import rec_init_state
from .ssm import ssm_init_state


class AttnCache(NamedTuple):
    k: torch.Tensor  # [n, B, KV, T, hd] (one layer's entry: [B, KV, T, hd])
    v: torch.Tensor


class MLACache(NamedTuple):
    c: torch.Tensor   # [B, T, kv_lora_rank]
    kr: torch.Tensor  # [B, T, qk_rope_dim]


def ring_rows(cfg: ModelConfig, max_seq: int) -> int:
    """Rows of a ``"local"`` layer's ring: the window, or max_seq + 1 when
    max_seq is shorter (the JAX ring's key set, see the module
    docstring)."""
    window = cfg.sliding_window
    return window if max_seq >= window else max_seq + 1


def bounded_by_max_seq(cfg: ModelConfig) -> bool:
    """True if ``cfg`` has a global ``"attn"`` layer, whose cache holds
    max_seq positions in order: such a config takes at most max_seq
    positions.  A ``"local"`` ring, an SSM or an RG-LRU state takes any
    length, as in the JAX package."""
    return "attn" in cfg.layer_kinds


def init_cache(cfg: ModelConfig, bsz: int, max_seq: int, dtype,
               device, mesh=None) -> Dict[str, Any]:
    """Zeroed cache for ``decode_step``; ``pos`` (a Python int) counts the
    tokens so far.  ``max_seq`` sizes the attention caches only.  On
    ``mesh`` the K/V are this rank's shard (the module docstring); ``bsz``
    is the rank's batch."""
    def kv(rows, *layers):
        """K/V of ``rows`` rows, [*layers, B, KV, rows, hd]."""
        heads = cfg.num_kv_heads
        if mesh is not None:
            m = specs.axis_sizes(mesh).get("model", 1)
            layout = specs.decode_cache_layout(heads, rows, mesh)
            heads //= m if layout == "kv" else 1
            rows //= m if layout == "seq" else 1
        shape = (*layers, bsz, heads, rows, cfg.head_dim)
        return AttnCache(k=torch.zeros(shape, dtype=dtype, device=device),
                         v=torch.zeros(shape, dtype=dtype, device=device))

    if cfg.family == "encdec":
        cross = kv(cfg.enc_seq, cfg.dec_layers)
        return {"pos": 0, "max_seq": max_seq,
                "blocks": {"s0": kv(max_seq, cfg.dec_layers)},
                "cross_k": cross.k, "cross_v": cross.v}
    if cfg.block_layout == ("attn",) and not cfg.use_mla:
        return {"pos": 0, "max_seq": max_seq,
                "blocks": {"s0": kv(max_seq, cfg.n_blocks)}}

    def entry(kind):
        if kind == "ssm":
            return ssm_init_state(cfg, bsz, dtype, device)
        if kind == "rec":
            return rec_init_state(cfg, bsz, dtype, device)
        if kind == "attn" and cfg.use_mla:
            return MLACache(*(torch.zeros((bsz, max_seq, n), dtype=dtype,
                                          device=device)
                              for n in (cfg.kv_lora_rank, cfg.qk_rope_dim)))
        return kv(max_seq if kind == "attn" else ring_rows(cfg, max_seq))

    return {"pos": 0, "max_seq": max_seq,
            "blocks": {"s0": [entry(k) for k in cfg.layer_kinds]}}
