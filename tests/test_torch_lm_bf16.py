"""LM training's loss and gradients in bf16, the port against the JAX
package run op by op (``jax.disable_jit``), on the CPU: the dense and vlm
families (``tests/test_torch_lm_loss.py`` has the helpers and the bars).
The other families' bf16 cases are in ``tests/test_torch_lm_bf16_*.py``,
one file each: the reference's first op-by-op pass compiles every
primitive it meets, which takes most of a minute a family."""
import pytest
import test_torch_lm_loss as lm
import torch

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", ["llama3-8b", "llava-next-34b"])
def test_bf16_loss_and_gradients_equal_jax_op_by_op(arch):
    lm.check_loss_and_grads(arch, "bfloat16")
