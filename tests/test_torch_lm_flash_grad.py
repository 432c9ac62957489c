"""The gradient of ``kernels.flash_attention``: the plain backward
(``ref.mha_backward_reference``) against the vjp of the JAX package's
``mha_reference`` and against autograd through the port's plain version,
on the CPU; the backward kernel (``csrc/flash_attention_bwd.cu``) against
the plain backward on a GPU (marked ``cuda``; skipped on a machine without
one).

Bars.  The plain backward in f32 against ``jax.vjp`` in f32: the JAX
kernel tests' f32 atol 2e-5 with rtol 1e-2.  The kernel against the plain
backward computed in f64 from the same inputs: within four times the f32
plain backward's own largest error against that f64 result (plus 1e-7),
and for bf16 inputs also the rounding of the output to bf16 (2^-8 of
each value); two calls give equal bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import mha_reference as jax_mha
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref

torch.set_num_threads(1)

#: (B, H, KV, S, T, D) and the options: MQA, GQA and MHA, D = 32, 64, 128
#: and 256, causal with S != T, not causal with a window, softcaps; every
#: row sees some column
CASES = [((1, 2, 1, 128, 128, 64), {}),
         ((2, 4, 2, 100, 100, 64), {"window": 32}),
         ((1, 4, 4, 96, 96, 128), {"softcap": 30.0}),
         ((1, 10, 1, 70, 70, 256), {"window": 64, "softcap": 20.0}),
         ((2, 4, 2, 48, 80, 32), {}),
         ((1, 4, 2, 90, 60, 64), {"causal": False, "window": 70}),
         ((2, 8, 2, 37, 150, 128), {"causal": False, "softcap": 5.0})]


def _draw(shape, seed, dtype=np.float32):
    b, h, kv, s, t, d = shape
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(x).astype(dtype)
            for x in ((b, h, s, d), (b, kv, t, d), (b, kv, t, d),
                      (b, h, s, d))]


@pytest.mark.parametrize("shape,kw", CASES)
def test_plain_backward_equals_the_vjp_of_the_jax_oracle(shape, kw):
    q, k, v, do = _draw(shape, sum(shape))
    _, vjp = jax.vjp(lambda a, b, c: jax_mha(a, b, c, **kw),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    got = flash_ref.mha_backward_reference(
        *map(torch.from_numpy, (q, k, v, do)), **kw)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=1e-2, err_msg=f"d{name}")


@pytest.mark.parametrize("shape,kw", CASES[:4])
def test_cpu_attention_is_differentiated_through_the_plain_version(shape,
                                                                   kw):
    """On CPU tensors ``ops.attention`` is the plain version, which
    autograd differentiates: in f64, equal to the plain backward within
    1e-12, and no kernel launch is counted."""
    q, k, v, do = (torch.from_numpy(x) for x in _draw(shape, 1, np.float64))
    before = flash_ops.backward_launches
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    out = flash_ops.attention(q, k, v, **kw)
    got = torch.autograd.grad(out, (q, k, v), do)
    want = flash_ref.mha_backward_reference(q.detach(), k.detach(),
                                            v.detach(), do, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-12)
    assert flash_ops.backward_launches == before


def test_plain_version_computes_in_f64_for_f64_inputs():
    q, k, v, _ = _draw((1, 2, 1, 40, 40, 64), 2, np.float64)
    got = flash_ref.mha_reference(*map(torch.from_numpy, (q, k, v)))
    assert got.dtype == torch.float64
    want = flash_ref.mha_reference(*(torch.from_numpy(x).float()
                                     for x in (q, k, v)))
    assert float((got - want.double()).abs().max()) < 1e-5


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the backward kernel runs on the "
                    "card, and this machine has no GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def kernel_close(name, got, q, k, v, do, **kw):
    """Hold the kernel's (dq, dk, dv) to the plain backward in f64 at the
    module docstring's bar."""
    want = flash_ref.mha_backward_reference(
        *(x.double() for x in (q, k, v, do)), **kw)
    plain = flash_ref.mha_backward_reference(
        *(x.float() for x in (q, k, v, do)), **kw)
    rel = 2.0 ** -8 if q.dtype == torch.bfloat16 else 0.0
    for part, g, w, p in zip("qkv", got, want, plain):
        assert g.dtype == q.dtype and g.shape == w.shape
        e32 = float((p.double() - w).abs().max())
        err = (g.double() - w).abs()
        bar = 4 * e32 + 1e-7 + rel * w.abs()
        assert bool((err <= bar).all()), (
            f"{name} d{part}: off by up to {float(err.max())} (the f32 "
            f"plain backward's own error {e32})")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kw", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_matches_the_plain_backward(cuda, shape, kw, dtype):
    q, k, v, do = (torch.from_numpy(x).to(cuda, dtype)
                   for x in _draw(shape, sum(shape)))
    flash_ops.backward_launches = 0
    runs = []
    for _ in range(2):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = flash_ops.attention(*leaves, **kw)
        runs.append(torch.autograd.grad(out, leaves, do))
    torch.cuda.synchronize()
    assert flash_ops.backward_launches == 2
    kernel_close(f"{shape} {kw} {dtype}", runs[0], q, k, v, do, **kw)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_backward_kernel_reads_the_models_strided_views(cuda):
    """The model passes q, k, v as [B, S, H, D] activations transposed to
    [B, H, S, D], and autograd hands back dO in that layout."""
    b, s, h, kv, d = 2, 130, 8, 2, 128
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn(b, s, n, d, generator=gen, device=cuda,
                           dtype=torch.bfloat16).requires_grad_()
               for n in (h, kv, kv))
    out = flash_ops.attention(*(x.transpose(1, 2) for x in (q, k, v)))
    do = torch.randn(b, s, h * d, generator=gen, device=cuda,
                     dtype=torch.bfloat16)
    got = torch.autograd.grad(out.transpose(1, 2).reshape(b, s, -1),
                              (q, k, v), do)
    t = lambda x: x.detach().transpose(1, 2)
    kernel_close("strided", [g.transpose(1, 2) for g in got], t(q), t(k),
                 t(v), do.view(b, s, h, d).transpose(1, 2))

