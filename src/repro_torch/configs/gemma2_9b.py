"""Gemma2-9B [arXiv:2408.00118]: alternating local/global attention,
logit softcaps, sandwich norms, GeGLU, gemma-scaled embeddings.

42 layers = 21 x (local window-4096, global) pairs.  ``gemma2-9b-swa``
makes every layer sliding-window (all-local): its cache is a ring of at
most 4096 rows a layer, whatever the length.
"""
import dataclasses

from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256_000,
    sliding_window=4096,
    block_layout=("local", "attn"),
    attn_softcap=50.0,
    final_softcap=30.0,
    post_norm=True,
    mlp_variant="geglu",
    embed_scale=True,
    rope_theta=10_000.0,
    source="arXiv:2408.00118 (Gemma 2)",
)

SWA_VARIANT = dataclasses.replace(
    CONFIG, name="gemma2-9b-swa", block_layout=("local",))
