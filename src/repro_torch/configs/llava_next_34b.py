"""LLaVA-NeXT-34B [hf:llava-hf/llava-v1.6] — VLM; vision tower STUBBED.

Language backbone: 60L, d=7168, 56 heads GQA kv=8 (Yi-34B-class).  AnyRes
tiling produces up to 2880 patch embeddings which arrive PRECOMPUTED
[B, 2880, 1152] (a SigLIP-dim stub, ``data/tokens.py::modality_inputs``)
and pass through a learned linear projector before being prepended to
text tokens.
"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64_000,
    num_prefix_embeds=2880,
    vision_dim=1152,
    block_layout=("attn",),
    mlp_variant="swiglu",
    rope_theta=5_000_000.0,
    source="hf:llava-hf/llava-v1.6 (34B backbone; anyres tiling)",
)
