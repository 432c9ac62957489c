"""The port's attention kernels, ``kernels.flash_attention`` and
``kernels.decode_attention``: the plain versions against the JAX oracles
(``mha_reference``, ``decode_reference``) and the Pallas kernels in
interpret mode on the CPU, and the CUDA kernels against the plain versions
on a GPU (marked ``cuda``; skipped on a machine without one).

The bar is the JAX one (``tests/test_kernels.py``'s ``tol_for``): atol
2e-5 in f32 and 2e-2 in bf16, rtol 1e-2.  The bf16 flash kernel (tensor
cores) is also held to the plain version computed in f32 within the
output's rounding to bf16 plus 1e-4 (``chip_smoke.py`` phase 12), and the
f32 flash kernel to the bits of the CUDA-core kernel it has always been.  Inputs are drawn with numpy from
a seed and rounded to the dtype by JAX, so both frameworks see the same
values.
"""
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.decode_attention import \
    decode_attention as pallas_decode
from repro.kernels.decode_attention.ref import decode_reference as jax_decode
from repro.kernels.flash_attention.flash_attention import \
    flash_attention as pallas_flash
from repro.kernels.flash_attention.ref import mha_reference as jax_mha
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention import ref as decode_ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
#: the grids of tests/test_kernels.py: MQA, GQA, MHA (d=128) x f32/bf16 x
#: {none, window, softcap}, and recurrentgemma-2b's MQA group of 10 heads
#: of 256
FLASH_SHAPES = [(1, 2, 1, 128, 64), (2, 4, 2, 256, 64), (1, 4, 4, 128, 128),
                (1, 10, 1, 128, 256)]
FLASH_KW = [{}, {"window": 64}, {"softcap": 30.0}]
DECODE_SHAPES = [(2, 4, 2, 256, 64), (1, 8, 1, 512, 128),
                 (2, 10, 1, 256, 256)]
DECODE_KW = [{}, {"window": 128}, {"softcap": 25.0}]


def tol_for(dtype: str) -> float:
    return 2e-2 if dtype == "bfloat16" else 2e-5


def _inputs(shapes, dtype: str, seed: int):
    """The same values as JAX arrays and as CPU torch tensors."""
    rng = np.random.default_rng(seed)
    jx = [jnp.asarray(rng.standard_normal(s, np.float32), DTYPES[dtype][0])
          for s in shapes]
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        DTYPES[dtype][1]) for a in jx]
    return jx, tx


def _close(got, want, dtype):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol_for(dtype), rtol=1e-2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode, and this machine has no GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# ------------------------------------------------------ plain vs JAX, flash

@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kw", FLASH_KW, ids=["plain", "window", "softcap"])
def test_flash_plain_matches_jax_oracle_and_pallas(shape, dtype, kw):
    b, h, kv, s, d = shape
    (jq, jk, jv), (q, k, v) = _inputs(
        [(b, h, s, d), (b, kv, s, d), (b, kv, s, d)], dtype, sum(shape))
    got = flash_ops.attention(q, k, v, **kw).float().numpy()
    assert got.shape == (b, h, s, d)
    _close(got, jax_mha(jq, jk, jv, **kw), dtype)
    _close(got, pallas_flash(jq, jk, jv, interpret=True, block_q=64,
                             block_k=64, **kw), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kw", FLASH_KW, ids=["plain", "window", "softcap"])
def test_flash_plain_ragged_sequence_matches_jax_oracle(dtype, kw):
    """A serving prompt has any length (the Pallas kernel asserts
    S % 128 == 0, so only the oracle takes it)."""
    b, h, kv, s, d = 2, 4, 2, 100, 32
    (jq, jk, jv), (q, k, v) = _inputs(
        [(b, h, s, d), (b, kv, s, d), (b, kv, s, d)], dtype, 3)
    _close(flash_ops.attention(q, k, v, **kw).float(),
           jax_mha(jq, jk, jv, **kw), dtype)


# ----------------------------------------------------- plain vs JAX, decode

@pytest.mark.parametrize("shape", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kw", DECODE_KW, ids=["plain", "window", "softcap"])
def test_decode_plain_matches_jax_oracle_and_pallas(shape, dtype, kw):
    b, h, kv, t, d = shape
    (jq, jk, jv), (q, k, v) = _inputs(
        [(b, h, d), (b, kv, t, d), (b, kv, t, d)], dtype, sum(shape))
    lengths = np.random.default_rng(0).integers(1, t + 1, size=b)
    jl = jnp.asarray(lengths, jnp.int32)
    got = decode_ops.decode(q, k, v, torch.from_numpy(lengths).int(),
                            **kw).float().numpy()
    assert got.shape == (b, h, d)
    _close(got, jax_decode(jq, jk, jv, jl, **kw), dtype)
    _close(got, pallas_decode(jq, jk, jv, jl, interpret=True, block_k=128,
                              **kw), dtype)


@pytest.mark.parametrize("length", ["one", "full"])
@pytest.mark.parametrize("kw", DECODE_KW, ids=["plain", "window", "softcap"])
def test_decode_plain_edge_lengths_match_jax(length, kw):
    b, h, kv, t, d = 2, 4, 2, 256, 64
    (jq, jk, jv), (q, k, v) = _inputs(
        [(b, h, d), (b, kv, t, d), (b, kv, t, d)], "float32", 5)
    lengths = np.full(b, 1 if length == "one" else t, np.int32)
    jl = jnp.asarray(lengths)
    got = decode_ops.decode(q, k, v, torch.from_numpy(lengths), **kw)
    _close(got, jax_decode(jq, jk, jv, jl, **kw), "float32")
    _close(got, pallas_decode(jq, jk, jv, jl, interpret=True, block_k=128,
                              **kw), "float32")


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_plain_ragged_cache_matches_jax_oracle(dtype):
    """Any T (the Pallas kernel needs T % block_k == 0)."""
    b, h, kv, t, d = 3, 8, 2, 300, 32
    (jq, jk, jv), (q, k, v) = _inputs(
        [(b, h, d), (b, kv, t, d), (b, kv, t, d)], dtype, 7)
    lengths = np.array([1, 177, 300], np.int32)
    _close(decode_ops.decode(q, k, v, torch.from_numpy(lengths)).float(),
           jax_decode(jq, jk, jv, jnp.asarray(lengths)), dtype)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    (_, _, _), (q, k, v) = _inputs([(1, 2, 16, 32), (1, 1, 16, 32),
                                    (1, 1, 16, 32)], "float32", 0)
    before = (flash_ops.launches, decode_ops.launches)
    flash_ops.attention(q, k, v)
    decode_ops.decode(q[:, :, 0], k, v, torch.tensor([16], dtype=torch.int32))
    assert (flash_ops.launches, decode_ops.launches) == before


def test_decode_splits_cover_the_cache():
    """At 3 blocks per SM (D = 128), 1 (recurrentgemma-2b's D = 256,
    G = 10: 144 KB of shared memory a block) and 0 (one piece)."""
    for b, kv, t in ((8, 8, 1280), (8, 2, 1280), (1, 1, 70), (64, 8, 4096),
                     (8, 1, 1040)):
        for per_sm in (3, 1, 0):
            nsplit, chunk = decode_ops.splits(b, kv, t, 132, per_sm)
            assert chunk % decode_ops.BLOCK_K == 0
            assert (nsplit - 1) * chunk < t <= nsplit * chunk
            # one wave: no more blocks than fit on the SMs at once
            assert nsplit == 1 or b * kv * nsplit <= per_sm * 132
    assert decode_ops.splits(8, 1, 1040, 132, 1) == (9, 128)
    assert decode_ops.splits(8, 1, 1040, 132, 0)[0] == 1


def test_wrappers_reject_bad_options():
    q = torch.zeros(1, 2, 8, 32)
    with pytest.raises(ValueError, match="window"):
        flash_ops.attention(q, q, q, window=0)
    with pytest.raises(ValueError, match="softcap"):
        decode_ops.decode(q[:, :, 0], q, q, torch.ones(1, dtype=torch.int32),
                          softcap=-1.0)


# ------------------------------------------------- CUDA kernels vs plain

def _cuda_inputs(shapes, dtype, seed, dev):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s, np.float32)).to(
        dev, DTYPES[dtype][1]) for s in shapes]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FLASH_SHAPES + [(2, 8, 2, 300, 128),
                                                  (1, 4, 2, 37, 32),
                                                  (2, 10, 1, 300, 256)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kw", FLASH_KW, ids=["plain", "window", "softcap"])
def test_flash_kernel_matches_plain(cuda, shape, dtype, kw):
    b, h, kv, s, d = shape
    q, k, v = _cuda_inputs([(b, h, s, d), (b, kv, s, d), (b, kv, s, d)],
                           dtype, sum(shape), cuda)
    before = flash_ops.launches
    got = flash_ops.attention(q, k, v, **kw)
    assert flash_ops.launches == before + 1
    _close(got.float().cpu(), flash_ref.mha_reference(q, k, v, **kw)
           .float().cpu(), dtype)


def _flash_f32_bar(got, q, k, v, **kw):
    """phase 12's bar: the bf16 output within its rounding to bf16
    (2^-8 relative) plus 1e-4 of the plain version computed in f32."""
    want = flash_ref.mha_reference(q.float(), k.float(), v.float(), **kw)
    err = (got.float() - want).abs()
    assert bool((err <= 1e-4 + 2 ** -8 * want.abs()).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kw", [((8, 32, 8, 1024, 128), {}),
                                      ((8, 10, 1, 1024, 256),
                                       {"window": 2048})],
                         ids=["llama3-8b", "recurrentgemma-2b"])
def test_flash_kernel_bf16_at_the_main_path_shapes(cuda, shape, kw):
    b, h, kv, s, d = shape
    q, k, v = _cuda_inputs([(b, h, s, d), (b, kv, s, d), (b, kv, s, d)],
                           "bfloat16", 23, cuda)
    _flash_f32_bar(flash_ops.attention(q, k, v, **kw), q, k, v, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernel_window_and_softcap_together(cuda, shape, dtype):
    b, h, kv, s, d = shape
    q, k, v = _cuda_inputs([(b, h, s, d), (b, kv, s, d), (b, kv, s, d)],
                           dtype, sum(shape) + 1, cuda)
    kw = {"window": 64, "softcap": 30.0}
    got = flash_ops.attention(q, k, v, **kw)
    _close(got.float().cpu(), flash_ref.mha_reference(q, k, v, **kw)
           .float().cpu(), dtype)
    if dtype == "bfloat16":
        _flash_f32_bar(got, q, k, v, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4, 2, 65, 128), (2, 8, 8, 130, 64),
                                   (1, 10, 1, 191, 256), (1, 2, 1, 5, 32)])
def test_flash_kernel_bf16_ragged_q_tiles(cuda, shape):
    """S not a multiple of the kernel's 64-row Q tile: the last tile's rows
    past S are masked and not written."""
    b, h, kv, s, d = shape
    q, k, v = _cuda_inputs([(b, h, s, d), (b, kv, s, d), (b, kv, s, d)],
                           "bfloat16", s, cuda)
    _flash_f32_bar(flash_ops.attention(q, k, v), q, k, v)


#: sha256 (first 16 hex digits) of the f32 kernel's output on these
#: inputs, as the CUDA-core kernel computed it before the bf16 path moved
#: to the tensor cores (NVIDIA H100 80GB HBM3)
F32_FLASH_BITS = {
    ((2, 4, 2, 256, 64), ()): "97bfcda3e8385c7a",
    ((2, 4, 2, 256, 64), (("window", 64),)): "cc948be7ab4de3bc",
    ((2, 4, 2, 256, 64), (("softcap", 30.0),)): "19c738ce82340c61",
    ((1, 10, 1, 128, 256), ()): "f9e35c83a2eb709e",
    ((1, 4, 2, 37, 32), ()): "9207de5a5fb33abe",
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kw", list(F32_FLASH_BITS))
def test_flash_kernel_f32_bits_unchanged(cuda, shape, kw):
    b, h, kv, s, d = shape
    q, k, v = _cuda_inputs([(b, h, s, d), (b, kv, s, d), (b, kv, s, d)],
                           "float32", sum(shape), cuda)
    got = flash_ops.attention(q, k, v, **dict(kw))
    digest = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()
    assert digest[:16] == F32_FLASH_BITS[(shape, kw)]


@pytest.mark.cuda
def test_flash_kernel_reads_strided_views(cuda):
    """The model's layout: q a transpose of [B,S,H,D], k/v the first S rows
    of a [B,KV,T,D] cache; the output keeps q's strides."""
    q, cache = _cuda_inputs([(2, 100, 8, 128), (2, 2, 160, 128)],
                            "bfloat16", 1, cuda)
    qt, kc = q.transpose(1, 2), cache[:, :, :100]
    got = flash_ops.attention(qt, kc, kc)
    assert got.stride() == qt.stride()
    _close(got.float().cpu(),
           flash_ref.mha_reference(qt, kc, kc).float().cpu(), "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", DECODE_SHAPES + [(3, 8, 2, 1000, 128),
                                                   (2, 4, 4, 70, 32),
                                                   (3, 10, 1, 1000, 256),
                                                   (2, 20, 2, 300, 256)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kw", DECODE_KW, ids=["plain", "window", "softcap"])
def test_decode_kernel_matches_plain(cuda, shape, dtype, kw):
    b, h, kv, t, d = shape
    q, k, v = _cuda_inputs([(b, h, d), (b, kv, t, d), (b, kv, t, d)],
                           dtype, sum(shape), cuda)
    rng = np.random.default_rng(1)
    for lengths in (rng.integers(1, t + 1, b), np.ones(b), np.full(b, t)):
        lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
        before = decode_ops.launches
        got = decode_ops.decode(q, k, v, lens, **kw)
        assert decode_ops.launches == before + 1
        _close(got.float().cpu(), decode_ref.decode_reference(
            q, k, v, lens, **kw).float().cpu(), dtype)


@pytest.mark.cuda
def test_attention_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 2, 8, 48, device=cuda)
    with pytest.raises(ValueError, match="D is not one of"):
        flash_ops.attention(q, q, q)
    q = torch.zeros(1, 2, 8, 32, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="f32 or bf16"):
        flash_ops.attention(q, q, q)
    q = torch.zeros(1, 2, 32, device=cuda)
    k = torch.zeros(1, 1, 8, 32, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        decode_ops.decode(q, k, k, torch.ones(1, device=cuda))
    with pytest.raises(ValueError, match=r"\(D, H / KV\) is not one of"):
        decode_ops.decode(torch.zeros(1, 3, 32, device=cuda), k, k,
                          torch.ones(1, dtype=torch.int32, device=cuda))
    kt = torch.zeros(1, 1, 32, 8, device=cuda).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous last dim"):
        decode_ops.decode(q, kt, kt,
                          torch.ones(1, dtype=torch.int32, device=cuda))
