"""Granite-3.0-1B-A400M [hf:ibm-granite/granite-3.0-1b-a400m-base] —
32-expert top-8 MoE, GQA kv=8, expert d_ff=512."""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    moe_d_ff=512,
    num_experts=32,
    moe_top_k=8,
    num_shared_experts=0,
    vocab_size=49_155,
    block_layout=("attn",),
    mlp_variant="swiglu",
    rope_theta=10_000.0,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
