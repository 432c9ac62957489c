"""The LLM face's models: the dense, moe, vlm, ssm, hybrid and encdec
families."""
from .base import ModelConfig  # noqa: F401
from .kvcache import AttnCache, init_cache  # noqa: F401
from .model import (decode_step, forward, init_params,  # noqa: F401
                     params_from_jax, prefill)
