"""DeepSeek-7B [arXiv:2401.02954]: llama-architecture dense, MHA (kv=32)."""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=102_400,
    block_layout=("attn",),
    mlp_variant="swiglu",
    rope_theta=10_000.0,
    source="arXiv:2401.02954 (DeepSeek LLM 7B)",
)
