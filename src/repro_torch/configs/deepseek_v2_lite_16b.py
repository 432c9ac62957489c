"""DeepSeek-V2-Lite-16B [arXiv:2405.04434] — MLA + fine-grained MoE.

MLA: kv_lora_rank 512, rope dim 64, nope dim 128, v dim 128 (16 heads).
MoE: 64 routed experts top-6 + 2 shared experts, expert d_ff 1408.
The published V2-Lite has 64 routed + 2 shared experts, as the JAX
package's config has them.  All 27 layers are MoE (the published model's
first layer is a dense MLP; the JAX package unifies it for its layer scan,
<1% FLOP delta, and the port keeps its layers).
"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    moe_d_ff=1408,
    num_experts=64,
    moe_top_k=6,
    num_shared_experts=2,
    use_mla=True,
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    vocab_size=102_400,
    block_layout=("attn",),
    mlp_variant="swiglu",
    rope_theta=10_000.0,
    source="arXiv:2405.04434 (DeepSeek-V2-Lite)",
)
