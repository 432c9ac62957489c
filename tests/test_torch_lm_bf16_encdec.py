"""LM training's loss and gradients in bf16 for the encdec family
(whisper-small), the port against the JAX package run op by op
(``jax.disable_jit``), on the CPU (``tests/test_torch_lm_loss.py`` has
the helpers and the bars)."""
import test_torch_lm_loss as lm
import torch

torch.set_num_threads(1)


def test_bf16_loss_and_gradients_equal_jax_op_by_op():
    lm.check_loss_and_grads("whisper-small", "bfloat16")
