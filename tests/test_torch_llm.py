"""The port's LLM serving face (dense, ssm and hybrid families) against
the JAX package's, on the CPU: configs, the model (forward, prefill,
decode), ``Backend``, ``ServingPool``/``PoolPolicy`` and ``EcoreService``.

Both packages run the same parameters: the JAX ``init_params`` tree
(norms and biases perturbed so that they count), carried across with
``params_from_jax``.  At f32 the logits agree to atol/rtol 1e-4 and the
greedy tokens are equal.  At bf16 the two round attention differently:
the JAX model's chunked attention rounds the normalized probabilities to
bf16 before the value product, the flash kernels and their plain versions
keep them in f32.  Over two layers that moves a few logits (magnitude up
to ~4) by up to 0.07, so the bf16 bar is atol 6.25e-2 (4 bf16 ulps in
[2, 4)), rtol 3e-2; the Mamba-2 model (mamba2-370m) and RecurrentGemma
(recurrentgemma-2b) are held to the same two bars.  Routing decisions are
equal, over the dense pool, the three-model pool with mamba2-370m and the
four-model pool with recurrentgemma-2b.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.policy import PoolPolicy as JaxPoolPolicy
from repro.core.policy import RouteRequest as JaxRouteRequest
from repro.launch.serve import synthetic_pool_table as jax_pool_table
from repro.models import layers as jax_layers
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.serving.engine import Backend as JaxBackend
from repro.serving.engine import Request as JaxRequest
from repro.serving.pool import ServingPool as JaxServingPool
from repro.serving.service import EcoreService as JaxEcoreService
from repro_torch.configs import get_config, list_configs
from repro_torch.core.policy import Observation, PoolPolicy, RouteRequest
from repro_torch.models import (ModelConfig, decode_step, forward,
                                init_params, params_from_jax, prefill)
from repro_torch.models import layers
from repro_torch.models.model import check_config
from repro_torch.serving.backend import make_backend
from repro_torch.serving.engine import Backend, Request
from repro_torch.serving.pool import (LENGTH_BUCKETS, ServingPool, bucket_of,
                                      synthetic_pool_table)
from repro_torch.serving.service import EcoreService

torch.set_num_threads(1)

ARCHS = ("qwen2.5-3b", "llama3-8b")
MAMBA = "mamba2-370m"
#: launch/serve.py's default pool up to its first unported member
POOL3 = ARCHS + (MAMBA,)
RG = "recurrentgemma-2b"
#: the default pool without granite-moe-1b-a400m (tests/test_torch_moe.py)
POOL4 = POOL3 + (RG,)
#: launch/serve.py's default pool, every member ported
POOL5 = POOL3 + ("granite-moe-1b-a400m", RG)
#: prompt lengths in every bucket, and on each bucket edge
PROMPT_LENS = [1, 64, 512, 513, 2048, 2049, 8192, 8193, 32768, 32769, 100000]


def _configs(arch, activ_dtype="float32", **kw):
    """The reduced config in both packages: two layers, or for the hybrid
    family one (rec, rec, local) block and the trailing (rec, rec) pair."""
    if arch != RG:
        kw = {"num_layers": 2, **kw}
    return (jax_get_config(arch).reduced(activ_dtype=activ_dtype, **kw),
            get_config(arch).reduced(activ_dtype=activ_dtype, **kw))


def _params(jax_cfg, cfg, seed=0):
    """JAX parameters with random (not zero) norms and biases, and the
    same values in the port's form on the CPU."""
    jp = jax_init_params(jax_cfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        name = jax.tree_util.keystr(path)
        if "norm" in name or "'b" in name or (
                "['rec']" in name and name.endswith(("_b']", "_ba']",
                                                     "_bx']"))):
            return a + jnp.asarray(0.1 * rng.standard_normal(a.shape),
                                   a.dtype)
        return a
    jp = jax.tree_util.tree_map_with_path(perturb, jp)
    return jp, params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")


def _tol(activ_dtype):
    """(atol, rtol) of the logits: see the module docstring."""
    return (1e-4, 1e-4) if activ_dtype == "float32" else (6.25e-2, 3e-2)


# ------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", POOL5)
def test_configs_equal_jax_field_for_field(arch):
    jc, tc = jax_get_config(arch), get_config(arch)
    for field in dataclasses.fields(jc):
        assert getattr(tc, field.name) == getattr(jc, field.name), field.name
    assert [f.name for f in dataclasses.fields(tc)] == \
        [f.name for f in dataclasses.fields(jc)]
    for prop in ("is_subquadratic", "d_inner", "ssm_heads", "n_blocks"):
        assert getattr(tc, prop) == getattr(jc, prop), prop
    assert dataclasses.asdict(tc.reduced(num_layers=2)) == \
        dataclasses.asdict(jc.reduced(num_layers=2))
    assert tc.adtype == torch.bfloat16 and tc.pdtype == torch.float32


def test_unported_configs_raise():
    """Every config is registered (whisper-small too); an unknown arch, and
    a config whose family does not run what it asks, still raise."""
    assert sorted(list_configs()) == sorted(POOL5 + (
        "deepseek-7b", "gemma2-9b", "deepseek-v2-lite-16b", "llava-next-34b",
        "whisper-small"))
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("whisper-medium")
    cfg = get_config("llama3-8b").reduced(num_layers=2)
    with pytest.raises(ValueError, match="not ported yet: mlp 'swiglu'"):
        init_params(dataclasses.replace(cfg, family="encdec"), device="cpu")
    with pytest.raises(ValueError, match="layout"):
        init_params(dataclasses.replace(cfg, family="hybrid"), device="cpu")
    with pytest.raises(ValueError, match="layout"):
        init_params(dataclasses.replace(cfg, family="ssm"), device="cpu")
    with pytest.raises(ValueError, match="layout"):
        init_params(dataclasses.replace(cfg, block_layout=("attn", "local"),
                                        sliding_window=16), device="cpu")


# --------------------------------------------------------------- model

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("activ_dtype", ["float32", "bfloat16"])
def test_model_matches_jax(arch, activ_dtype):
    """forward, prefill (logits and cache) and 6 decode steps."""
    jc, tc = _configs(arch, activ_dtype)
    jp, tp = _params(jc, tc)
    atol, rtol = _tol(activ_dtype)
    toks = np.random.default_rng(1).integers(0, jc.vocab_size, (2, 11))
    jt = jnp.asarray(toks, jnp.int32)
    tt = torch.from_numpy(toks)

    def close(got, want):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=atol, rtol=rtol)

    close(forward(tp, tc, tt), jax_forward(jp, jc, jt))
    jlog, jcache = jax_prefill(jp, jc, jt, max_seq=24)
    tlog, tcache = prefill(tp, tc, tt, max_seq=24)
    assert tlog.dtype == torch.float32 and tlog.shape == (2, 1, jc.vocab_size)
    close(tlog, jlog)
    for step in range(6):
        nxt = jnp.argmax(jlog, axis=-1).astype(jnp.int32)
        jlog, jcache = jax_decode_step(jp, jc, nxt, jcache)
        tlog, tcache = decode_step(tp, tc, torch.from_numpy(
            np.array(nxt)).long(), tcache)
        close(tlog, jlog)
    assert tcache["pos"] == int(jcache["pos"]) == 17
    # the caches hold the same K/V: JAX [n, B, W, KV, hd] is the port's
    # [n, B, KV, T, hd] transposed
    for name in ("k", "v"):
        close(getattr(tcache["blocks"]["s0"], name),
              np.asarray(getattr(jcache["blocks"]["s0"], name),
                         np.float32).transpose(0, 1, 3, 2, 4))


@pytest.mark.parametrize("activ_dtype", ["float32", "bfloat16"])
def test_mamba_matches_jax(activ_dtype):
    """mamba2-370m reduced to two layers (chunk 8): forward, prefill over a
    ragged 21-token prompt (logits and states) and 6 decode steps, greedy
    tokens equal."""
    jc, tc = _configs(MAMBA, activ_dtype)
    jp, tp = _params(jc, tc)
    atol, rtol = _tol(activ_dtype)
    toks = np.random.default_rng(1).integers(0, jc.vocab_size, (2, 21))
    jt = jnp.asarray(toks, jnp.int32)

    def close(got, want):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=atol, rtol=rtol)

    close(forward(tp, tc, torch.from_numpy(toks)), jax_forward(jp, jc, jt))
    jlog, jcache = jax_prefill(jp, jc, jt, max_seq=8)
    tlog, tcache = prefill(tp, tc, torch.from_numpy(toks), max_seq=8)
    close(tlog, jlog)
    for step in range(6):
        nxt = jnp.argmax(jlog, axis=-1).astype(jnp.int32)
        jlog, jcache = jax_decode_step(jp, jc, nxt, jcache)
        tlog, tcache = decode_step(tp, tc, torch.from_numpy(
            np.array(nxt)).long(), tcache)
        close(tlog, jlog)
        np.testing.assert_array_equal(tlog.argmax(-1).numpy(),
                                      np.asarray(jnp.argmax(jlog, -1)))
    assert tcache["pos"] == int(jcache["pos"]) == 27
    # per-layer states: the JAX package stacks them on a leading layer dim
    jstate = jcache["blocks"]["s0"]
    for i, st in enumerate(tcache["blocks"]["s0"]):
        assert st.ssm.dtype == torch.float32 and st.conv.dtype == tc.adtype
        assert st.ssm.shape == (2, tc.ssm_heads, tc.ssm_headdim,
                                tc.ssm_state)
        close(st.ssm, np.asarray(jstate.ssm[i], np.float32))
        close(st.conv, np.asarray(jstate.conv[i], np.float32))


def test_mamba_params_from_jax_keep_the_scalars_in_f32():
    jc, tc = _configs(MAMBA, "bfloat16")
    _, tp = _params(jc, tc)
    layer = tp["blocks"]["s0"][1]
    assert sorted(layer) == ["norm1", "ssm"]
    assert {n: t.dtype for n, t in layer["ssm"].items()} == {
        "in_proj": torch.bfloat16, "conv_w": torch.bfloat16,
        "conv_b": torch.bfloat16, "out_proj": torch.bfloat16,
        "dt_bias": torch.float32, "A_log": torch.float32,
        "D": torch.float32, "norm_w": torch.float32}
    ch = tc.d_inner + 2 * tc.ssm_state
    assert layer["ssm"]["in_proj"].shape == (tc.d_model,
                                             ch + tc.d_inner + tc.ssm_heads)
    own = init_params(tc, seed=0, device="cpu")["blocks"]["s0"][1]["ssm"]
    assert {n: (t.shape, t.dtype) for n, t in own.items()} == {
        n: (t.shape, t.dtype) for n, t in layer["ssm"].items()}


@pytest.mark.parametrize("activ_dtype", ["float32", "bfloat16"])
def test_hybrid_matches_jax(activ_dtype):
    """recurrentgemma-2b reduced (window 16): forward, then prefill of a
    24-token prompt and 16 decode steps at max_seq 48, which take the
    local ring (16 slots: the window) past its wrap, tokens equal in f32.
    The recurrent states equal the JAX cache's, and the port's ring holds
    the JAX ring's rows slot for slot (position p at slot p % 16)."""
    jc, tc = _configs(RG, activ_dtype)
    jp, tp = _params(jc, tc)
    atol, rtol = _tol(activ_dtype)
    toks = np.random.default_rng(1).integers(0, jc.vocab_size, (2, 24))
    jt = jnp.asarray(toks, jnp.int32)

    def close(got, want):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=atol, rtol=rtol)

    close(forward(tp, tc, torch.from_numpy(toks)), jax_forward(jp, jc, jt))
    jlog, jcache = jax_prefill(jp, jc, jt, max_seq=48)
    tlog, tcache = prefill(tp, tc, torch.from_numpy(toks), max_seq=48)
    close(tlog, jlog)
    for step in range(16):
        nxt = jnp.argmax(jlog, axis=-1).astype(jnp.int32)
        if activ_dtype == "float32":
            np.testing.assert_array_equal(tlog.argmax(-1).numpy(),
                                          np.asarray(nxt))
        jlog, jcache = jax_decode_step(jp, jc, nxt, jcache)
        tlog, tcache = decode_step(tp, tc, torch.from_numpy(
            np.array(nxt)).long(), tcache)
        close(tlog, jlog)
    assert tcache["pos"] == int(jcache["pos"]) == 40
    jslots = [jcache["blocks"][f"s{j}"] for j in range(3)] + \
        [jcache["trailing"][f"s{j}"] for j in range(2)]
    for kind, entry, js in zip(tc.layer_kinds, tcache["blocks"]["s0"],
                               jslots):
        if kind == "rec":
            close(entry.h, js.h[0])
            close(entry.conv, js.conv[0])
            continue
        pos_buf = np.asarray(js.pos_buf[0])
        assert entry.k.shape == (2, tc.num_kv_heads, 16, tc.head_dim)
        assert sorted(pos_buf) == list(range(24, 40))  # wrapped
        np.testing.assert_array_equal(pos_buf % 16, np.arange(16))
        for name in ("k", "v"):
            ring = np.asarray(getattr(js, name)[0], np.float32)
            close(getattr(entry, name), ring.transpose(0, 2, 1, 3))


def test_hybrid_params_from_jax_interleave_the_block_slots():
    """Layer order is block 0's slots s0, s1, s2, block 1's, ..., then the
    trailing slots: two blocks here, so reading one slot for every block
    first would give another order."""
    jc, tc = _configs(RG, "bfloat16", num_layers=8)
    jp, tp = _params(jc, tc)
    layers = tp["blocks"]["s0"]
    assert tc.layer_kinds == ("rec", "rec", "local") * 2 + ("rec", "rec")
    order = [("blocks", j, i) for i in range(2) for j in range(3)] + \
        [("trailing", j, 0) for j in range(2)]
    for kind, layer, (group, j, i) in zip(tc.layer_kinds, layers, order):
        slot = jp[group][f"s{j}"]
        mixer = "rec" if kind == "rec" else "attn"
        assert sorted(layer) == sorted(["norm1", mixer, "norm2", "mlp"])
        np.testing.assert_array_equal(layer["norm1"].numpy(),
                                      np.asarray(slot["norm1"][i]))
        name = "w_x" if kind == "rec" else "wq"
        np.testing.assert_array_equal(
            layer[mixer][name].float().numpy(),
            np.asarray(slot[mixer][name][i].astype(jnp.bfloat16)
                       .astype(jnp.float32)))
    rec = layers[0]["rec"]
    assert {n for n, t in rec.items() if t.dtype == torch.float32} == {
        "lru_wa", "lru_wx", "lru_ba", "lru_bx", "log_lambda"}
    assert {n for n, t in rec.items() if t.dtype == torch.bfloat16} == {
        "w_gate", "w_x", "conv_w", "conv_b", "w_out"}
    own = init_params(tc, seed=0, device="cpu")
    for mine, theirs in zip(own["blocks"]["s0"], layers):
        assert jax.tree_util.tree_map(lambda t: (t.shape, t.dtype), mine) \
            == jax.tree_util.tree_map(lambda t: (t.shape, t.dtype), theirs)


def test_gelu_tanh_and_scaled_embedding_bit_equal_jax_in_bf16():
    """XLA rounds every op of ``jax.nn.gelu(approximate=True)`` in bf16 and
    the gemma embedding scale sqrt(d) to bf16 before the product (50.5 at
    d = 2560); the port does the same."""
    rng = np.random.default_rng(0)
    jx = jnp.asarray(3 * rng.standard_normal(20000, np.float32),
                     jnp.bfloat16)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).bfloat16()
    np.testing.assert_array_equal(
        layers.gelu_tanh(tx).float().numpy(),
        np.asarray(jax.nn.gelu(jx, approximate=True).astype(jnp.float32)))
    x32 = rng.standard_normal(2000, np.float32)
    np.testing.assert_allclose(
        layers.gelu_tanh(torch.from_numpy(x32)).numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(x32), approximate=True)),
        atol=1e-6)
    table = rng.standard_normal((64, 2560), np.float32) / 50
    toks = rng.integers(0, 64, (2, 7))
    want = jax_layers.embed({"table": jnp.asarray(table)},
                            jnp.asarray(toks), scale_by_sqrt_dim=True,
                            adtype=jnp.bfloat16)
    got = layers.embed({"table": torch.from_numpy(table).bfloat16()},
                       torch.from_numpy(toks), scale_by_sqrt_dim=True,
                       adtype=torch.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    assert float(torch.tensor(2560 ** 0.5, dtype=torch.bfloat16)) == 50.5


def test_check_config_accepts_the_hybrid_family():
    check_config(get_config(RG))
    check_config(get_config(RG).reduced())
    assert get_config(RG).is_subquadratic


@pytest.mark.parametrize("arch,change,what", [
    ("deepseek-v2-lite-16b", {"post_norm": True}, "post-norms"),
    ("whisper-small", {"embed_scale": True}, "scaled embeddings"),
    ("llava-next-34b", {"mlp_variant": "geglu"}, "mlp 'geglu'"),
    ("llava-next-34b", {"embed_scale": True}, "scaled embeddings"),
    ("qwen2.5-3b", {"use_rope": False}, "positions without RoPE")])
def test_check_config_rejects_what_is_not_ported(arch, change, what):
    cfg = ModelConfig(**{**dataclasses.asdict(jax_get_config(arch)),
                         **change})
    with pytest.raises(ValueError, match=what):
        check_config(cfg)


def test_params_from_jax_unstacks_with_the_jax_names():
    jc, tc = _configs("qwen2.5-3b", "bfloat16")
    _, tp = _params(jc, tc)
    layers = tp["blocks"]["s0"]
    assert len(layers) == 2
    assert sorted(layers[0]) == ["attn", "mlp", "norm1", "norm2"]
    assert sorted(layers[0]["attn"]) == ["bk", "bq", "bv", "wk", "wo", "wq",
                                         "wv"]
    assert sorted(layers[0]["mlp"]) == ["w_down", "w_gate", "w_up"]
    assert layers[0]["attn"]["wq"].dtype == torch.bfloat16
    assert layers[0]["norm1"].dtype == torch.float32
    assert tp["embed"]["table"].shape == (jc.vocab_size, jc.d_model)


def test_init_params_is_seeded():
    cfg = get_config("llama3-8b").reduced(num_layers=2)
    a, b = (init_params(cfg, seed=3, device="cpu") for _ in range(2))
    c = init_params(cfg, seed=4, device="cpu")
    wq = [p["blocks"]["s0"][1]["attn"]["wq"] for p in (a, b, c)]
    assert torch.equal(wq[0], wq[1]) and not torch.equal(wq[0], wq[2])
    # truncated at 2 std of the fan-in scale
    assert float(wq[0].float().abs().max()) <= 2 / cfg.d_model ** 0.5 + 1e-3


def test_decode_step_gives_the_kernel_only_the_filled_cache_rows(
        monkeypatch):
    """The decode kernel sizes its splits from T, so each layer passes the
    cache's rows [0, pos] (a view), with lengths pos + 1."""
    from repro_torch.kernels.decode_attention import ops as decode_ops
    cfg = get_config("qwen2.5-3b").reduced(num_layers=2)
    params = init_params(cfg, seed=0, device="cpu")
    _, cache = prefill(params, cfg, torch.zeros((2, 5), dtype=torch.long),
                       max_seq=16)
    seen, decode = [], decode_ops.decode

    def spy(q, k, v, lengths, **kw):
        seen.append((k.shape[2], v.shape[2], lengths.tolist(),
                     k.data_ptr() == cache["blocks"]["s0"].k.data_ptr()))
        return decode(q, k, v, lengths, **kw)
    monkeypatch.setattr(decode_ops, "decode", spy)
    for _ in range(2):
        _, cache = decode_step(params, cfg, torch.zeros((2, 1),
                                                        dtype=torch.long),
                               cache)
    assert seen == [(t, t, [t, t], i == 0) for t in (6, 7) for i in (0, 1)]


# ------------------------------------------------------------- backend

def _backends(arch, seed=0, **kw):
    jc, tc = _configs(arch)
    jb = JaxBackend(arch, jc, seed=seed, **kw)
    tb = Backend(arch, tc, params=params_from_jax(
        tc, jax.tree_util.tree_map(np.asarray, jb.params), device="cpu"),
        device="cpu", **kw)
    return jb, tb


@pytest.mark.parametrize("arch", POOL4)
@pytest.mark.parametrize("prompt_len", [5, 17])
def test_serve_batch_tokens_equal_jax(arch, prompt_len):
    jb, tb = _backends(arch, max_batch=4, max_seq=32)
    rng = np.random.default_rng(prompt_len)
    reqs = [(i, rng.integers(0, 1000, prompt_len)) for i in range(3)]
    want = jb.serve_batch([JaxRequest(uid=u, prompt=p, max_new_tokens=6)
                           for u, p in reqs])
    got = tb.serve_batch([Request(uid=u, prompt=p, max_new_tokens=6)
                          for u, p in reqs])
    for g, w in zip(got, want):
        assert g.uid == w.uid and g.backend == w.backend
        assert g.batch_size == 3 and g.tokens.dtype == np.int32
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))
    assert tb.profile_row() == jb.profile_row()


def test_serve_batch_rejects_what_does_not_fit():
    _, tb = _backends("llama3-8b", max_seq=16)
    with pytest.raises(ValueError, match="max_seq=16"):
        tb.serve_batch([Request(uid=0, prompt=np.arange(12),
                                max_new_tokens=6)])
    with pytest.raises(ValueError, match="at least one"):
        tb.serve_batch([])


def test_hybrid_serve_batch_checks_max_seq_for_local_layers():
    """max_seq sizes the local layers' ring (the window, 16 rows, at
    max_seq 16; max_seq + 1 = 9 rows at max_seq 8) and bounds nothing: a
    prompt and new tokens past it serve as the JAX backend's do, and the
    model prefills and decodes past it."""
    jb, tb = _backends(RG, max_seq=16)
    prompt = np.random.default_rng(3).integers(0, 1000, 12)
    want = jb.serve_batch([JaxRequest(uid=0, prompt=prompt,
                                      max_new_tokens=6)])
    got = tb.serve_batch([Request(uid=0, prompt=prompt, max_new_tokens=6)])
    np.testing.assert_array_equal(got[0].tokens, np.asarray(want[0].tokens))
    _, cache = prefill(tb.params, tb.cfg,
                       torch.zeros((1, 9), dtype=torch.long), max_seq=8)
    _, cache = decode_step(tb.params, tb.cfg,
                           torch.zeros((1, 1), dtype=torch.long), cache)
    assert cache["pos"] == 10
    assert [e.k.shape[2] for kind, e in zip(tb.cfg.layer_kinds,
                                            cache["blocks"]["s0"])
            if kind == "local"] == [9]


def test_mamba_backend_takes_prompts_longer_than_max_seq_as_jax_does():
    """An ssm config has no attention cache: the JAX backend serves a
    prompt and new tokens beyond max_seq, and so does the port."""
    jb, tb = _backends(MAMBA, max_seq=16)
    prompt = np.random.default_rng(4).integers(0, 1000, 30)
    want = jb.serve_batch([JaxRequest(uid=0, prompt=prompt,
                                      max_new_tokens=5)])
    got = tb.serve_batch([Request(uid=0, prompt=prompt, max_new_tokens=5)])
    np.testing.assert_array_equal(got[0].tokens, np.asarray(want[0].tokens))


def test_llm_backend_is_registered():
    cfg = get_config("qwen2.5-3b").reduced(num_layers=2)
    b = make_backend("llm", "qwen2.5-3b", cfg, max_batch=2, device="cpu")
    assert isinstance(b, Backend) and b.max_batch == 2


# ------------------------------------------------------------- routing

@pytest.mark.parametrize("archs,delta", [(ARCHS, 5.0), (ARCHS, 10.0),
                                         (POOL3, 10.0), (POOL3, 18.5),
                                         (POOL4, 10.0)])
def test_pool_and_policy_decisions_equal_jax(archs, delta):
    jpool = JaxServingPool(jax_pool_table(archs), delta=delta)
    pool = ServingPool(synthetic_pool_table(archs, device="cpu"),
                       delta=delta)
    assert [(e.model, e.group, e.map_pct, e.time_ms, e.energy_mwh)
            for e in pool.table.entries] == \
        [(e.model, e.group, e.map_pct, e.time_ms, e.energy_mwh)
         for e in jpool.table.entries]
    for n in PROMPT_LENS:
        assert dataclasses.asdict(pool.route(n)) == \
            dataclasses.asdict(jpool.route(n))
    assert [dataclasses.asdict(d) for d in pool.route_batch(PROMPT_LENS)] \
        == [dataclasses.asdict(d) for d in jpool.route_batch(PROMPT_LENS)]
    jpol, pol = JaxPoolPolicy(jpool), PoolPolicy(pool)
    reqs = [(i, n) for i, n in enumerate(PROMPT_LENS)]
    want = jpol.decide_batch([JaxRouteRequest(uid=i, complexity=n)
                              for i, n in reqs])
    got = pol.decide_batch([RouteRequest(uid=i, complexity=n)
                            for i, n in reqs])
    assert [dataclasses.asdict(d) for d in got] == \
        [dataclasses.asdict(d) for d in want]
    assert [pol.decide(RouteRequest(uid=i, complexity=n)) for i, n in reqs] \
        == got
    assert [bucket_of(n) for n in PROMPT_LENS] == \
        [0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4]
    assert len(LENGTH_BUCKETS) == 5


def test_bucket_zero_goes_to_qwen_and_longer_prompts_to_llama():
    """delta 10: qwen's 62.33 is within 10 of llama's capped 72.0 in bucket
    0, but not of llama's 72.86 from bucket 1 on."""
    pool = ServingPool(synthetic_pool_table(ARCHS, device="cpu"), delta=10)
    assert [d.arch for d in pool.route_batch([256, 1024, 5000])] == \
        ["qwen2.5-3b", "llama3-8b", "llama3-8b"]


def test_bucket_zero_goes_to_mamba2_from_delta_18():
    """mamba2-370m scores 54.0 against a bucket-0 best of 72.0: within δ
    from 18 on (bucket 1 then goes to qwen2.5-3b); not at δ = 10."""
    routes = {delta: [d.arch for d in ServingPool(
        synthetic_pool_table(POOL3, device="cpu"),
        delta=delta).route_batch([500, 1024])] for delta in (10, 18.5)}
    assert routes == {10: ["qwen2.5-3b", "llama3-8b"],
                      18.5: [MAMBA, "qwen2.5-3b"]}


def test_bucket_one_goes_to_recurrentgemma_at_delta_10():
    """In the four-model pool at δ = 10, bucket 0's best is llama3-8b's
    capped 72.0: qwen2.5-3b (62.33) is the cheapest within δ; bucket 1's
    best is 72.86, qwen2.5-3b misses it by 0.53 and recurrentgemma-2b
    (63.31) is the cheapest within δ."""
    pool = ServingPool(synthetic_pool_table(POOL4, device="cpu"), delta=10)
    assert [d.arch for d in pool.route_batch([256, 1024])] == \
        ["qwen2.5-3b", RG]
    assert [pool.route(n).arch for n in (256, 1024)] == ["qwen2.5-3b", RG]


def test_pool_observe_matches_jax():
    from repro.core.policy import Observation as JaxObservation
    jpol = JaxPoolPolicy(JaxServingPool(jax_pool_table(ARCHS), delta=10))
    pol = PoolPolicy(ServingPool(synthetic_pool_table(ARCHS, device="cpu"),
                                 delta=10))
    pair = ("qwen2.5-3b", "pod-16x16")
    for policy, obs in ((jpol, JaxObservation), (pol, Observation)):
        policy.observe(obs(pair=pair, time_ms=50.0, energy_mwh=9.0))
        policy.observe(obs(pair=pair, map_pct=20.0, true_complexity=300))
    assert [(e.map_pct, e.time_ms, e.energy_mwh)
            for e in pol.pool.table.entries] == pytest.approx(
        [(e.map_pct, e.time_ms, e.energy_mwh)
         for e in jpol.pool.table.entries])
    # qwen's bucket-0 quality fell below the tolerance: bucket 0 moves
    assert pol.decide(RouteRequest(uid=0, complexity=10)).backend == \
        jpol.decide(JaxRouteRequest(uid=0, complexity=10)).backend == \
        "llama3-8b"
    with pytest.raises(ValueError, match="per-bucket"):
        pol.pool.observe("qwen2.5-3b", map_pct=1.0)
    with pytest.raises(KeyError):
        pol.pool.observe("gpt-5", time_ms=1.0)


# ------------------------------------------------------------- service

@pytest.mark.parametrize("archs,delta,served", [
    (ARCHS, 10.0, ARCHS), (POOL3, 18.5, (MAMBA, "qwen2.5-3b")),
    (POOL4, 10.0, ("qwen2.5-3b", RG))])
def test_service_tokens_equal_jax(archs, delta, served):
    """Requests in two buckets through ``EcoreService`` over a reduced
    pool: same routes, same tokens as the JAX service."""
    pairs = {arch: _backends(arch, seed=i, max_batch=2, max_seq=40)
             for i, arch in enumerate(archs)}
    rng = np.random.default_rng(9)
    # payloads are short (the reduced models), routing sees the full length
    work = [(i, n, rng.integers(0, 1000, 7 + i % 2))
            for i, n in enumerate([100, 900, 200, 1500, 300, 700])]

    def run(service_type, policy, req_type, which):
        service = service_type(policy, lambda d: pairs[d.backend][which])
        with service:
            futs = service.submit_batch([req_type(
                uid=i, payload=p, complexity=n, max_new_tokens=4)
                for i, n, p in work])
            service.drain()
            return {f.result().request.uid: (f.result().decision.pair,
                                             np.asarray(f.result()
                                                        .result.tokens))
                    for f in futs}

    want = run(JaxEcoreService, JaxPoolPolicy(JaxServingPool(
        jax_pool_table(archs), delta=delta)), JaxRouteRequest, 0)
    got = run(EcoreService, PoolPolicy(ServingPool(synthetic_pool_table(
        archs, device="cpu"), delta=delta)), RouteRequest, 1)
    assert sorted(got) == sorted(want) == list(range(len(work)))
    assert {pair[0] for pair, _ in got.values()} == set(served)
    for uid in got:
        assert got[uid][0] == want[uid][0]
        np.testing.assert_array_equal(got[uid][1], want[uid][1])


# ------------------------------------------------- on a GPU (cuda marker)

@pytest.mark.cuda
def test_model_on_cuda_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU for the CUDA kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    jc, tc = _configs("qwen2.5-3b")
    _, tp = _params(jc, tc)
    gp = {"embed": {"table": tp["embed"]["table"].cuda()},
          "final_norm": tp["final_norm"].cuda(),
          "blocks": {"s0": [jax.tree_util.tree_map(lambda t: t.cuda(), p)
                            for p in tp["blocks"]["s0"]]}}
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 512, (2, 9)))
    clog, ccache = prefill(tp, tc, toks, max_seq=16)
    glog, gcache = prefill(gp, tc, toks.cuda(), max_seq=16)
    for _ in range(4):
        np.testing.assert_allclose(glog.cpu().numpy(), clog.numpy(),
                                   atol=1e-4, rtol=1e-4)
        nxt = clog.argmax(-1)
        clog, ccache = decode_step(tp, tc, nxt, ccache)
        glog, gcache = decode_step(gp, tc, nxt.cuda(), gcache)


@pytest.mark.cuda
def test_mamba_on_cuda_matches_cpu():
    """The reduced mamba2-370m in f32 through the SSD kernel on the card
    and through its plain version on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU for the CUDA kernels")
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    torch.backends.cuda.matmul.allow_tf32 = False
    jc, tc = _configs(MAMBA)
    _, tp = _params(jc, tc)
    gp = jax.tree_util.tree_map(lambda t: t.cuda(), tp)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 512, (2, 19)))
    before = ssd_ops.launches
    clog, ccache = prefill(tp, tc, toks)
    glog, gcache = prefill(gp, tc, toks.cuda())
    assert ssd_ops.launches == before + tc.num_layers
    for _ in range(4):
        np.testing.assert_allclose(glog.cpu().numpy(), clog.numpy(),
                                   atol=1e-4, rtol=1e-4)
        nxt = clog.argmax(-1)
        clog, ccache = decode_step(tp, tc, nxt, ccache)
        glog, gcache = decode_step(gp, tc, nxt.cuda(), gcache)


@pytest.mark.cuda
def test_hybrid_on_cuda_matches_cpu():
    """The reduced recurrentgemma-2b in f32 through the RG-LRU, flash and
    decode kernels on the card and through their plain versions on the
    CPU, past the window."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU for the CUDA kernels")
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rglru_scan import ops as lru_ops
    torch.backends.cuda.matmul.allow_tf32 = False
    jc, tc = _configs(RG)
    _, tp = _params(jc, tc)
    gp = jax.tree_util.tree_map(lambda t: t.cuda(), tp)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 512,
                                                              (2, 20)))
    before = (lru_ops.launches, flash_ops.launches)
    clog, ccache = prefill(tp, tc, toks, max_seq=32)
    glog, gcache = prefill(gp, tc, toks.cuda(), max_seq=32)
    assert (lru_ops.launches, flash_ops.launches) == (before[0] + 4,
                                                      before[1] + 1)
    for _ in range(6):
        np.testing.assert_allclose(glog.cpu().numpy(), clog.numpy(),
                                   atol=1e-4, rtol=1e-4)
        nxt = clog.argmax(-1)
        clog, ccache = decode_step(tp, tc, nxt, ccache)
        glog, gcache = decode_step(gp, tc, nxt.cuda(), gcache)
