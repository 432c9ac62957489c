"""Llama-3-8B [arXiv:2407.21783]: dense GQA kv=8, 128k vocab.

``llama3-8b-swa`` puts a 4096 sliding window on every layer: its cache is
a ring of at most 4096 rows a layer, whatever the length.
"""
import dataclasses

from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128_256,
    block_layout=("attn",),
    mlp_variant="swiglu",
    rope_theta=500_000.0,
    source="arXiv:2407.21783 (Llama 3 8B)",
)

SWA_VARIANT = dataclasses.replace(
    CONFIG, name="llama3-8b-swa", block_layout=("local",), sliding_window=4096)
