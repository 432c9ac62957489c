"""RecurrentGemma-2B [arXiv:2402.19427]: the Griffin hybrid of RG-LRU
recurrences and local attention.

26 layers, 1:2 attention:recurrence: 8 x (rec, rec, local) blocks, then a
trailing (rec, rec) pair (18 recurrent and 8 attention layers).  MQA (one
KV head of 256), sliding window 2048, GeGLU MLP, gemma-scaled embeddings.
"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    lru_width=2560,
    conv_width=4,
    sliding_window=2048,
    block_layout=("rec", "rec", "local"),
    trailing_layout=("rec", "rec"),
    mlp_variant="geglu",
    embed_scale=True,
    rope_theta=10_000.0,
    source="arXiv:2402.19427 (RecurrentGemma); Griffin arXiv:2402.19427",
)
