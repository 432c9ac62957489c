"""Model configuration: the JAX package's ``ModelConfig`` with torch dtypes.

One dataclass covers every family of ``repro.models`` and keeps all its
fields, so a config compares field for field with the reference.  The port
runs every family, in the layouts and variants of the configs it
registers (``models/model.py::check_config`` raises for the rest).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # attention details
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    sliding_window: Optional[int] = None  # window for 'local' layers
    # block layout: tuple of sub-layer kinds per block.
    # kinds: 'attn' (global), 'local' (sliding window), 'rec' (RG-LRU), 'ssm'
    block_layout: Tuple[str, ...] = ("attn",)
    trailing_layout: Tuple[str, ...] = ()

    # mlp
    mlp_variant: str = "swiglu"  # swiglu | geglu | gelu
    tie_embeddings: bool = False
    post_norm: bool = False      # gemma2 sandwich norms
    embed_scale: bool = False    # gemma family: embeddings scaled by sqrt(d)
    use_rope: bool = True        # whisper uses sinusoidal abs positions instead
    vision_dim: int = 1152       # raw vision/audio embedding dim before projector

    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_capacity_factor: float = 2.0

    # MLA (deepseek-v2)
    use_mla: bool = False
    kv_lora_rank: int = 512
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128

    # SSM (mamba2)
    ssm_state: int = 128
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

    # RG-LRU (recurrentgemma)
    lru_width: int = 0  # 0 -> d_model
    conv_width: int = 4

    # enc-dec (whisper)
    enc_layers: int = 0
    dec_layers: int = 0
    enc_seq: int = 1500

    # vlm
    num_prefix_embeds: int = 0

    # numerics
    param_dtype: str = "float32"
    activ_dtype: str = "bfloat16"
    norm_eps: float = 1e-6

    # training
    remat: bool = True

    # citation of the source model card / paper for this config
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.num_heads, 1))
        if self.lru_width == 0:
            object.__setattr__(self, "lru_width", self.d_model)
        n_block_layers = (len(self.block_layout) * self.n_blocks
                          + len(self.trailing_layout))
        if self.family not in ("encdec",) and n_block_layers != self.num_layers:
            raise ValueError(
                f"{self.name}: block layout {self.block_layout}x{self.n_blocks}"
                f"+{self.trailing_layout} covers {n_block_layers} layers, "
                f"config says {self.num_layers}")

    @property
    def n_blocks(self) -> int:
        return ((self.num_layers - len(self.trailing_layout))
                // len(self.block_layout))

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """The sub-layer kind of every layer, in order: the block layout
        ``n_blocks`` times, then the trailing layout."""
        return self.block_layout * self.n_blocks + self.trailing_layout

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def adtype(self) -> torch.dtype:
        return getattr(torch, self.activ_dtype)

    @property
    def d_inner(self) -> int:  # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def is_subquadratic(self) -> bool:
        """True if no sub-layer performs unbounded full attention."""
        if self.family == "encdec":
            return False
        return "attn" not in set(self.block_layout) | set(self.trailing_layout)

    def reduced(self, **overrides) -> "ModelConfig":
        """A smoke-test-sized variant of the same family (<=2 blocks, small
        dims): the JAX package's ``reduced``, value for value."""
        small = dict(
            num_layers=len(self.block_layout) + len(self.trailing_layout),
            d_model=min(self.d_model, 128),
            num_heads=min(self.num_heads, 4),
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            head_dim=32,
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            sliding_window=(min(self.sliding_window, 16)
                            if self.sliding_window else None),
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            moe_top_k=min(self.moe_top_k, 2) if self.moe_top_k else 0,
            moe_d_ff=min(self.moe_d_ff, 64) if self.moe_d_ff else 0,
            kv_lora_rank=64,
            qk_rope_dim=16,
            qk_nope_dim=32,
            v_head_dim=32,
            ssm_state=16,
            ssm_headdim=16,
            ssm_chunk=8,
            lru_width=min(self.lru_width, 128),
            enc_layers=min(self.enc_layers, 2) if self.enc_layers else 0,
            dec_layers=min(self.dec_layers, 2) if self.dec_layers else 0,
            enc_seq=16,
            num_prefix_embeds=(min(self.num_prefix_embeds, 8)
                               if self.num_prefix_embeds else 0),
            remat=False,
        )
        if self.num_kv_heads and self.num_kv_heads == self.num_heads:
            small["num_kv_heads"] = small["num_heads"]  # keep MHA archs MHA
        if self.family == "encdec":
            small["num_layers"] = small["enc_layers"] + small["dec_layers"]
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One of the four assigned workload shapes."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
