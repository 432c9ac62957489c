"""Mamba2-370M [arXiv:2405.21060]: attention-free SSD (state-space duality).

48 layers, d=1024, expand 2 (d_inner 2048), headdim 64 (32 SSD heads),
state 128, depthwise conv width 4, chunked scan (chunk 256).
"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=1,   # unused (attention-free)
    num_kv_heads=1,
    head_dim=64,
    d_ff=0,        # mamba block has no separate MLP
    vocab_size=50_280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_chunk=256,
    block_layout=("ssm",),
    source="arXiv:2405.21060 (Mamba-2 370m)",
)
