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
import ctypes
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
#: flash without the causal mask, (B, H, KV, S, T, D): S < T, S > T, MHA
#: at D = 128 and the MQA group of 10 heads of 256; a window (96 columns)
#: leaves every row some of the T columns
NONCAUSAL_SHAPES = [(1, 2, 1, 128, 256, 64), (2, 4, 2, 192, 128, 64),
                    (1, 4, 4, 64, 192, 128), (1, 10, 1, 128, 128, 256)]
NONCAUSAL_KW = [{}, {"window": 96}, {"softcap": 30.0}]
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


@pytest.mark.parametrize("shape", NONCAUSAL_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kw", NONCAUSAL_KW,
                         ids=["plain", "window", "softcap"])
def test_flash_plain_noncausal_matches_jax_oracle_and_pallas(shape, dtype,
                                                             kw):
    """``causal=False`` (whisper's encoder and cross-attention) with S !=
    T: the oracle's and the Pallas kernel's mask keeps every column, or
    the window's."""
    b, h, kv, s, t, d = shape
    (jq, jk, jv), (q, k, v) = _inputs(
        [(b, h, s, d), (b, kv, t, d), (b, kv, t, d)], dtype, sum(shape))
    got = flash_ops.attention(q, k, v, causal=False, **kw).float().numpy()
    assert got.shape == (b, h, s, d)
    _close(got, jax_mha(jq, jk, jv, causal=False, **kw), dtype)
    _close(got, pallas_flash(jq, jk, jv, causal=False, interpret=True,
                             block_q=64, block_k=64, **kw), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kw", FLASH_KW, ids=["plain", "window", "softcap"])
def test_flash_plain_noncausal_ragged_matches_jax_oracle(dtype, kw):
    """Any S and T without the mask: a 37-row prompt over 300 frames (not a
    multiple of 64), and 300 rows over 37."""
    for s, t in ((37, 300), (300, 37)):
        b, h, kv, d = 2, 4, 2, 32
        if "window" in kw and s >= t + kw["window"]:
            kw = {"window": s}   # every row keeps some column
        (jq, jk, jv), (q, k, v) = _inputs(
            [(b, h, s, d), (b, kv, t, d), (b, kv, t, d)], dtype, s)
        _close(flash_ops.attention(q, k, v, causal=False, **kw).float(),
               jax_mha(jq, jk, jv, causal=False, **kw), dtype)


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
    """At 3 blocks per SM (the f32 kernel at D = 128), 2 (the bf16 kernel
    at every main-path (D, G)), 1 (the f32 kernel at recurrentgemma-2b's
    D = 256, G = 10: 144 KB of shared memory a block) and 0 (one piece),
    in the f32 kernel's 64-row steps and the bf16 kernel's 32."""
    for b, kv, t in ((8, 8, 1280), (8, 2, 1280), (1, 1, 70), (64, 8, 4096),
                     (8, 1, 1040)):
        for per_sm in (3, 2, 1, 0):
            for rows in (decode_ops.BLOCK_K, 32):
                nsplit, chunk = decode_ops.splits(b, kv, t, 132, per_sm,
                                                  rows)
                assert chunk % rows == 0
                assert (nsplit - 1) * chunk < t <= nsplit * chunk
                # one wave: no more blocks than fit on the SMs at once
                assert nsplit == 1 or b * kv * nsplit <= per_sm * 132
    assert decode_ops.splits(8, 1, 1040, 132, 1) == (9, 128)
    assert decode_ops.splits(8, 1, 1040, 132, 0)[0] == 1
    # the bf16 kernel at two blocks per SM fills a wave of 132 SMs at the
    # main path's three decode shapes: llama3-8b (8, 8 KV heads, 1039
    # rows), qwen2.5-3b (8, 2, 270), recurrentgemma-2b (8, 1, 1036)
    for b, kv, t, d in ((8, 8, 1039, 128), (8, 2, 270, 128),
                        (8, 1, 1036, 256)):
        nsplit, _ = decode_ops.splits(b, kv, t, 132, 2,
                                      decode_ops.BLOCK_K_BF16[d])
        assert 132 <= b * kv * nsplit <= 2 * 132


def _fake_cuda_plans(monkeypatch):
    """Launch plans whose CUDA side is a recorder: the wrapper's whole
    launch path runs on CPU tensors, and the kernel function's arguments
    land in the returned list."""
    calls = []

    def resolve(plan):
        plan.fn = lambda *args: calls.append(args) or 0
        plan.per_sm, plan.n_sm = 2, 132
        plan.get_device, plan.get_stream = (lambda: plan.index), (
            lambda index: 7)

    monkeypatch.setattr(decode_ops._Plan, "resolve", resolve)
    monkeypatch.setattr(decode_ops, "_PLANS", {})
    return calls


def test_decode_launch_plan_is_built_once_and_reused(monkeypatch):
    calls = _fake_cuda_plans(monkeypatch)
    q = torch.zeros(8, 32, 128, dtype=torch.bfloat16)
    cache = torch.zeros(8, 8, 1280, 128, dtype=torch.bfloat16)
    lens = torch.full((8,), 1030, dtype=torch.int32)
    before = decode_ops.launches
    for t in (1030, 1031, 1032):
        out = decode_ops._launch(q, cache[:, :, :t], cache[:, :, :t], lens,
                                 None, None)
        assert out.shape == q.shape and out.dtype == q.dtype
    assert len(decode_ops._PLANS) == 1 and decode_ops.launches == before + 3
    # (t, nsplit, chunk) of the last call, then the plan's C struct
    assert calls[-1][5:8] == (1032,) + decode_ops.splits(8, 8, 1032, 132, 2,
                                                         32)
    (plan,) = decode_ops._PLANS.values()
    st = plan.static
    assert calls[-1][8] == ctypes.addressof(st)
    assert (st.b, st.h, st.kv, st.d, st.bf16, st.stream) == (8, 32, 8, 128,
                                                             1, 7)
    assert list(st.st) == [32 * 128, 128, *cache.stride()[:3],
                           *cache.stride()[:3], 32 * 128, 128]
    assert st.scale == pytest.approx(128 ** -0.5) and st.window == 0


def test_decode_launch_plan_still_rejects_bad_inputs(monkeypatch):
    """Each input that the wrapper rejected before it kept launch plans is
    rejected with the same words, also once a plan for the same shapes
    and strides exists."""
    _fake_cuda_plans(monkeypatch)
    q = torch.zeros(2, 4, 32)
    k = torch.zeros(2, 2, 16, 32)
    lens = torch.full((2,), 16, dtype=torch.int32)
    decode_ops._launch(q, k, k, lens, None, None)  # builds the plan
    before = decode_ops.launches
    bad = [
        ("int32", (q, k, k, lens.float())),
        ("int32", (q, k, k, lens[:1])),
        ("int32", (q, k, k, torch.zeros(4, dtype=torch.int32)[::2])),
        ("one device", (q, k, k, lens.to("meta"))),
        ("one device", (q, k.to("meta"), k, lens)),
        ("k, v", (q, k, k[:, :, :8], lens)),
        ("one dtype", (q, k.double(), k, lens)),
        ("f32 or bf16", (q.half(), k.half(), k.half(), lens)),
        ("k, v", (q[0], k, k, lens)),
        (r"\(D, H / KV\) is", (torch.zeros(2, 3, 32), k, k, lens)),
        (r"\(D, H / KV\) is", (torch.zeros(2, 4, 48), torch.zeros(
            2, 2, 16, 48), torch.zeros(2, 2, 16, 48), lens)),
        ("contiguous last dim", (q, torch.zeros(2, 2, 32, 16).transpose(
            2, 3), torch.zeros(2, 2, 32, 16).transpose(2, 3), lens)),
        ("16-byte", (torch.zeros(2 * 4 * 32 + 1)[1:].view(2, 4, 32), k, k,
                     lens)),
    ]
    for words, args in bad:
        with pytest.raises(ValueError, match=words):
            decode_ops._launch(*args, None, None)
    assert decode_ops.launches == before


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
@pytest.mark.parametrize("shape", NONCAUSAL_SHAPES + [
    (2, 12, 12, 100, 1500, 64), (1, 4, 2, 37, 300, 32),
    (2, 8, 2, 300, 130, 128), (1, 10, 1, 65, 191, 256)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kw", NONCAUSAL_KW + [{"window": 96,
                                                "softcap": 30.0}],
                         ids=["plain", "window", "softcap", "both"])
def test_flash_kernel_noncausal_matches_plain(cuda, shape, dtype, kw):
    """Both kernels (f32 and bf16) without the causal mask, S != T, ragged
    S and T; bf16 also within phase 12's bar of the f32 plain version."""
    b, h, kv, s, t, d = shape
    q, k, v = _cuda_inputs([(b, h, s, d), (b, kv, t, d), (b, kv, t, d)],
                           dtype, sum(shape), cuda)
    if "window" in kw and s >= t + kw["window"]:
        kw = {**kw, "window": s}   # every row keeps some column
    before = flash_ops.launches
    got = flash_ops.attention(q, k, v, causal=False, **kw)
    assert flash_ops.launches == before + 1
    _close(got.float().cpu(), flash_ref.mha_reference(
        q, k, v, causal=False, **kw).float().cpu(), dtype)
    if dtype == "bfloat16":
        _flash_f32_bar(got, q, k, v, causal=False, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,t,causal", [
    ((8, 12, 12, 1500, 64), 1500, False), ((8, 12, 12, 128, 64), 1500, False),
    ((8, 12, 12, 128, 64), 128, True)],
    ids=["encoder", "cross", "decoder"])
def test_flash_kernel_bf16_at_whispers_shapes(cuda, shape, t, causal):
    """whisper-small's three flash calls at batch 8: the encoder over its
    1500 frames, the prompt's cross-attention over them and its causal
    self-attention."""
    b, h, kv, s, d = shape
    q, k, v = _cuda_inputs([(b, h, s, d), (b, kv, t, d), (b, kv, t, d)],
                           "bfloat16", 29, cuda)
    _flash_f32_bar(flash_ops.attention(q, k, v, causal=causal), q, k, v,
                   causal=causal)


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


#: sha256 (first 16 hex digits) of the f32 decode kernel's output on these
#: inputs (lengths drawn from seed 1), as the CUDA-core kernel computed it
#: before the bf16 path moved to the tensor cores (NVIDIA H100 80GB HBM3)
F32_DECODE_BITS = {
    ((2, 4, 2, 256, 64), ()): "948b595b9f90f8cd",
    ((2, 4, 2, 256, 64), (("window", 128),)): "924a60ac37a0b06d",
    ((2, 4, 2, 256, 64), (("softcap", 25.0),)): "10fc641a4f5c3a9d",
    ((3, 10, 1, 1000, 256), ()): "092c249dcc59dcad",
    ((2, 4, 4, 70, 32), ()): "df499395a8c4c3fb",
    ((8, 32, 8, 1039, 128), ()): "baf6ec47de7e3f85",
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kw", list(F32_DECODE_BITS))
def test_decode_kernel_f32_bits_unchanged(cuda, shape, kw):
    b, h, kv, t, d = shape
    q, k, v = _cuda_inputs([(b, h, d), (b, kv, t, d), (b, kv, t, d)],
                           "float32", sum(shape), cuda)
    lens = torch.tensor(np.random.default_rng(1).integers(1, t + 1, b),
                        dtype=torch.int32, device=cuda)
    got = decode_ops.decode(q, k, v, lens, **dict(kw))
    digest = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()
    assert digest[:16] == F32_DECODE_BITS[(shape, kw)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kw", [((8, 32, 8, 1039, 128), {}),
                                      ((8, 16, 2, 270, 128), {}),
                                      ((8, 10, 1, 1036, 256),
                                       {"window": 2048}),
                                      ((8, 12, 12, 1500, 64), {})])
def test_decode_kernel_bf16_at_the_main_path_shapes(cuda, shape, kw):
    """Against the plain version in f32, within the output's rounding to
    bf16 plus 1e-4 (phase 12's bar), with the cache cut into splits."""
    b, h, kv, t, d = shape
    q, k, v = _cuda_inputs([(b, h, d), (b, kv, t, d), (b, kv, t, d)],
                           "bfloat16", sum(shape), cuda)
    lens = torch.tensor(np.random.default_rng(2).integers(t - 15, t + 1, b),
                        dtype=torch.int32, device=cuda)
    got = decode_ops.decode(q, k, v, lens, **kw).float()
    want = decode_ref.decode_reference(q.float(), k.float(), v.float(), lens,
                                       **kw)
    assert bool(((got - want).abs() <= 1e-4 + 2 ** -8 * want.abs()).all())


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
