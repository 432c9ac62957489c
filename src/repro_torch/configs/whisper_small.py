"""Whisper-small [arXiv:2212.04356] — enc-dec; conv/mel frontend STUBBED.

12 encoder + 12 decoder layers (the published small config), d=768, 12
heads.  Precomputed frame embeddings [B, 1500, 768]
(``data/tokens.py::modality_inputs``) stand in for the mel-spectrogram and
conv feature extractor.  Sinusoidal absolute positions (no RoPE), GELU MLP.
"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    num_layers=24,  # 12 enc + 12 dec
    enc_layers=12,
    dec_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51_865,
    enc_seq=1500,
    vision_dim=768,  # stub frame-embedding dim
    mlp_variant="gelu",
    use_rope=False,
    block_layout=("attn",),
    source="arXiv:2212.04356 (Whisper small: 12+12 layers)",
)
