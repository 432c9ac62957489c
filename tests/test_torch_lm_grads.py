"""LM training's loss and gradients in the port against the JAX package,
on the CPU: the other five of the ten archs in f32
(``tests/test_torch_lm_loss.py`` has the helpers, the bars and the first
five archs)."""
import pytest
import test_torch_lm_loss as lm
import torch

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", lm.ARCHS[5:])
def test_loss_and_gradients_equal_jax(arch, monkeypatch):
    lm.check_arch(arch, monkeypatch)
