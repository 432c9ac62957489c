"""Qwen2.5-3B [hf:Qwen/Qwen2.5-0.5B family]: GQA kv=2, QKV bias."""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    head_dim=128,
    d_ff=11008,
    vocab_size=151_936,
    qkv_bias=True,
    block_layout=("attn",),
    mlp_variant="swiglu",
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen2.5-3B (arch per assigned spec; QKV bias per Qwen2)",
)
