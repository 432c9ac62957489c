"""The LLM face's models: the dense, moe, vlm, ssm, hybrid and encdec
families."""
from .base import ModelConfig  # noqa: F401
from .kvcache import AttnCache, init_cache  # noqa: F401
from .model import (cast_params, decode_step, forward,  # noqa: F401
                    init_params, loss_fn, params_from_jax, prefill)
