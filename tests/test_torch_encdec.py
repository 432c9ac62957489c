"""The encdec family (whisper-small) in the port against the JAX package,
on the CPU, at ``get_config("whisper-small").reduced()``: 2 encoder and 2
decoder layers, 16 frames, d 128, 4 heads of 32 (MHA).

Whisper encodes frame embeddings (``frame_proj``, sinusoidal positions,
unmasked self-attention, GELU MLP) and decodes text with sinusoidal
positions, causal self-attention, cross-attention over the encoder's
output and the same MLP, no RoPE.  Both packages run the same parameters
(``params_from_jax``, norms perturbed) and the same draws.  Bars: f32
within 1e-5 (logits 1e-4) with greedy tokens equal; bf16 within the dense
bar (atol 6.25e-2, rtol 3e-2, ``tests/test_torch_llm.py``) against the
reference run op by op (``jax.disable_jit``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_llm as llm
import torch

from repro.configs import get_config as jax_get_config
from repro.data import tokens as jax_tokens
from repro.models import attention as jax_attention
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import layers as jax_layers
from repro.models import prefill as jax_prefill
from repro.serving.engine import Backend as JaxBackend
from repro.serving.engine import Request as JaxRequest
from repro_torch.configs import get_config, list_configs
from repro_torch.models import (decode_step, forward, init_params,
                                params_from_jax, prefill)
from repro_torch.models import attention, layers, model
from repro_torch.models.model import check_config
from repro_torch.serving.engine import Backend, Request

torch.set_num_threads(1)

WHISPER = "whisper-small"


def _configs(adt, **kw):
    return (jax_get_config(WHISPER).reduced(activ_dtype=adt, **kw),
            get_config(WHISPER).reduced(activ_dtype=adt, **kw))


def _eager(adt):
    return jax.disable_jit(adt == "bfloat16")


@functools.lru_cache(maxsize=None)
def _jax_fns(jc, max_seq):
    """The reference's forward, prefill and decode step: jitted in f32,
    op by op (``jax.disable_jit``) in bf16, where XLA's fused bf16 chains
    would move the logits (``ROADMAP.md``)."""
    fns = (lambda p, t, f: jax_forward(p, jc, t, f),
           lambda p, t, f: jax_prefill(p, jc, t, f, max_seq=max_seq),
           lambda p, t, c: jax_decode_step(p, jc, t, c))
    if jc.activ_dtype == "float32":
        return tuple(map(jax.jit, fns))

    def eager(fn):
        def run(*args):
            with jax.disable_jit():
                return fn(*args)
        return run
    return tuple(map(eager, fns))


def _bars(adt, logits=False):
    if adt == "float32":
        return (1e-4, 1e-4) if logits else (1e-5, 1e-5)
    return llm._tol(adt)


def _close(got, want, adt, logits=False):
    atol, rtol = _bars(adt, logits)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def _arrays(shapes, adt, seed):
    """The same values as JAX arrays in ``adt`` and as torch tensors."""
    rng = np.random.default_rng(seed)
    jx = [jnp.asarray(rng.standard_normal(s, np.float32), adt)
          for s in shapes]
    return jx, [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        getattr(torch, adt)) for a in jx]


def _tree(jp, adt):
    """A JAX parameter sub-tree as the port keeps it: matrices in
    ``adt``."""
    return {n: torch.from_numpy(np.array(a, np.float32)).to(
        getattr(torch, adt)) for n, a in jp.items()}


# ------------------------------------------------------------- config

def test_config_equals_jax_and_is_registered():
    jc, tc = jax_get_config(WHISPER), get_config(WHISPER)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert dataclasses.asdict(tc.reduced()) == dataclasses.asdict(
        jc.reduced())
    for prop in ("n_blocks", "is_subquadratic"):
        assert getattr(tc, prop) == getattr(jc, prop), prop
    assert (tc.enc_layers, tc.dec_layers, tc.enc_seq) == (12, 12, 1500)
    assert list_configs().index(WHISPER) == 3
    check_config(tc)
    check_config(tc.reduced())


# ------------------------------------------------------------- layers

@pytest.mark.parametrize("num_pos,dim", [(1500, 768), (16, 128)])
@pytest.mark.parametrize("adt", ["float32", "bfloat16"])
def test_sinusoidal_positions_equal_jax(num_pos, dim, adt):
    """The table, and each position's row computed alone (the decode
    step's embedding)."""
    want = jax_layers.sinusoidal_positions(num_pos, dim, jnp.dtype(adt))
    got = layers.sinusoidal_positions(num_pos, dim, getattr(torch, adt))
    assert got.shape == (num_pos, dim) and got.dtype == getattr(torch, adt)
    # f32: 1e-5, or the rounding of the largest angle (num_pos - 1 radians:
    # an ulp of the two frameworks' 10000 ** x moves it by ~2^-23 of itself)
    bar = {"float32": max(1e-5, num_pos * 2 ** -23),
           "bfloat16": 2 ** -8}[adt]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=bar)
    for pos in (0, 7, num_pos - 1):
        row = layers.position_embedding(pos, dim, getattr(torch, adt))
        assert torch.equal(row, got[pos])


@pytest.mark.parametrize("adt", ["float32", "bfloat16"])
def test_gelu_mlp_equals_jax(adt):
    """The ungated GELU MLP: ``w_up`` and ``w_down``, no ``w_gate``."""
    jp = jax_layers.init_mlp(jax.random.PRNGKey(1), 128, 256, "gelu",
                             jnp.float32)
    assert sorted(jp) == ["w_down", "w_up"]
    own = layers.init_mlp(torch.Generator().manual_seed(0), 128, 256, "gelu",
                          torch.float32)
    assert {n: tuple(w.shape) for n, w in own.items()} == {
        n: w.shape for n, w in jp.items()}
    (jx,), (x,) = _arrays([(2, 5, 128)], adt, 3)
    with _eager(adt):
        want = jax_layers.apply_mlp(jp, jx, "gelu")
    _close(layers.apply_mlp(_tree(jp, adt), x, "gelu"), want, adt)
    with pytest.raises(ValueError, match="unknown"):
        layers.init_mlp(torch.Generator(), 8, 8, "relu", torch.float32)


@pytest.mark.parametrize("adt", ["float32", "bfloat16"])
def test_cross_attention_equals_jax(adt):
    """``encode_cross_kv`` (the port keeps [B, KV, T, hd]) and
    ``cross_attention_forward`` over a 5-token prompt, and the decode
    step's ``cross_attention_decode`` for one token, against the
    reference's unmasked cross-attention."""
    jc, tc = _configs(adt)
    jp = jax_attention.init_attention(jax.random.PRNGKey(2), jc,
                                      jnp.float32)
    p = _tree(jp, adt)
    (jenc, jx), (enc, x) = _arrays([(2, 16, 128), (2, 5, 128)], adt, 4)
    with _eager(adt):
        jk, jv = jax_attention.encode_cross_kv(jp, jc, jenc)
        want = jax_attention.cross_attention_forward(jp, jc, jx, (jk, jv))
        want1 = jax_attention.cross_attention_forward(jp, jc, jx[:, :1],
                                                      (jk, jv))
    k, v = attention.encode_cross_kv(p, tc, enc)
    assert k.shape == (2, 4, 16, 32)
    _close(k.transpose(1, 2), jk, adt)
    _close(v.transpose(1, 2), jv, adt)
    _close(attention.cross_attention_forward(p, tc, x, (k, v)), want, adt)
    lengths = torch.full((2,), 16, dtype=torch.int32)
    _close(attention.cross_attention_decode(p, tc, x[:, :1], (k, v),
                                            lengths), want1, adt)


def _jax_encode(jp, jc, frames):
    """The reference's encoder (``_encdec_forward``'s first half), op by
    op with its own primitives: it has no function of its own."""
    adt = jc.adtype
    x = frames.astype(adt) @ jp["frame_proj"].astype(adt)
    x = x + jax_layers.sinusoidal_positions(x.shape[1], jc.d_model, adt)[None]
    hd, eps = jc.head_dim, jc.norm_eps
    for i in range(jc.enc_layers):
        p = jax.tree_util.tree_map(lambda a: a[i], jp["enc_blocks"])
        a = jax_layers.rms_norm(x, p["norm1"], eps, plus_one=True)
        b, s, _ = a.shape
        q, k, v = ((a @ p["attn"][w].astype(adt)).reshape(b, s, -1, hd)
                   for w in ("wq", "wk", "wv"))
        o = jax_attention.gqa_scores_softmax(q, k, v, jnp.zeros((1, s, s)),
                                             scale=hd ** -0.5, cap=None)
        x = x + o.reshape(b, s, -1) @ p["attn"]["wo"].astype(adt)
        m = jax_layers.rms_norm(x, p["norm2"], eps, plus_one=True)
        x = x + jax_layers.apply_mlp(p["mlp"], m, jc.mlp_variant)
    return jax_layers.rms_norm(x, jp["enc_norm"], eps, plus_one=True)


@pytest.mark.parametrize("adt", ["float32", "bfloat16"])
def test_encoder_equals_jax(adt):
    """``encode``: the frames projected, positions added, both encoder
    layers (flash without the causal mask) and ``enc_norm``."""
    jc, tc = _configs(adt)
    jp, tp = llm._params(jc, tc)
    (jfr,), (fr,) = _arrays([(2, 16, jc.vision_dim)], "float32", 6)
    if adt == "float32":
        want = jax.jit(lambda p, f: _jax_encode(p, jc, f))(jp, jfr)
    else:
        with _eager(adt):
            want = _jax_encode(jp, jc, jfr)
    _close(model.encode(tp, tc, fr), want, adt)


# -------------------------------------------------------------- model

def _inputs(jc, batch=2, text=7, seed=5):
    toks = np.random.default_rng(seed).integers(0, jc.vocab_size,
                                                (batch, text))
    frames = jax_tokens.modality_inputs(jc, batch, np.random.default_rng(
        seed))["prefix_embeds"]
    return toks, frames, torch.from_numpy(np.array(frames))


@pytest.mark.parametrize("adt", ["float32", "bfloat16"])
def test_model_matches_jax(adt):
    """``forward``, then ``prefill`` and decode steps on the reference's
    greedy tokens: logits at every step within the bar, in f32 the tokens
    equal too."""
    jc, tc = _configs(adt)
    jp, tp = llm._params(jc, tc)
    toks, jfr, fr = _inputs(jc)
    jt = jnp.asarray(toks, jnp.int32)
    fwd, pre, dec = _jax_fns(jc, 16)
    got = forward(tp, tc, torch.from_numpy(toks), fr)
    assert got.shape == (2, 7, jc.vocab_size)
    _close(got, fwd(jp, jt, jfr), adt, logits=True)
    jlog, jcache = pre(jp, jt, jfr)
    tlog, tcache = prefill(tp, tc, torch.from_numpy(toks), fr, max_seq=16)
    assert tcache["cross_k"].shape == (2, 2, 4, 16, 32)
    _close(tcache["cross_k"].transpose(2, 3), jcache["cross_k"], adt)
    steps = 4 if adt == "float32" else 2
    for step in range(steps + 1):
        _close(tlog, jlog, adt, logits=True)
        nxt = jnp.argmax(jlog, axis=-1).astype(jnp.int32)
        if adt == "float32":
            np.testing.assert_array_equal(tlog.argmax(-1).numpy(),
                                          np.asarray(nxt))
        if step == steps:
            break
        jlog, jcache = dec(jp, nxt, jcache)
        tlog, tcache = decode_step(tp, tc, torch.from_numpy(
            np.array(nxt)).long(), tcache)
    assert tcache["pos"] == int(jcache["pos"]) == 7 + steps


def test_params_from_jax_carries_every_weight():
    """The JAX names per layer, matrices in the activation dtype and equal
    after its rounding, norms in f32; ``init_params`` draws the same
    tree."""
    jc, tc = _configs("bfloat16")
    jp, tp = llm._params(jc, tc)
    own = init_params(tc, seed=0, device="cpu")
    assert sorted(tp) == sorted(own) == sorted(jp)
    for name, n in (("enc_blocks", 2), ("dec_blocks", 2)):
        assert len(tp[name]) == len(own[name]) == n
        for i, (mine, layer) in enumerate(zip(own[name], tp[name])):
            assert sorted(mine) == sorted(layer) == sorted(jp[name])
            assert sorted(layer["mlp"]) == ["w_down", "w_up"]
            for path, a in jax.tree_util.tree_leaves_with_path(jp[name]):
                keys = [k.key for k in path]
                got = layer[keys[0]] if len(keys) == 1 else \
                    layer[keys[0]][keys[1]]
                want = np.asarray(a[i])
                if keys[0].startswith("norm"):
                    assert got.dtype == torch.float32
                    np.testing.assert_array_equal(got.numpy(), want)
                else:
                    assert got.dtype == torch.bfloat16
                    np.testing.assert_array_equal(
                        got.float().numpy(), np.asarray(jnp.asarray(
                            want, jnp.bfloat16), np.float32))
    assert tp["frame_proj"].shape == (jc.vision_dim, jc.d_model)
    assert tp["enc_norm"].dtype == torch.float32
    np.testing.assert_array_equal(tp["enc_norm"].numpy(),
                                  np.asarray(jp["enc_norm"]))


# ------------------------------------------------------------ serving

def _backends(jc, tc, **kw):
    jb = JaxBackend(WHISPER, jc, **kw)
    tb = Backend(WHISPER, tc, params=params_from_jax(
        tc, jax.tree_util.tree_map(np.asarray, jb.params), device="cpu"),
        device="cpu", **kw)
    return jb, tb


def _serve_both(jb, tb, prompts, new):
    want = jb.serve_batch([JaxRequest(uid=i, prompt=p, max_new_tokens=new)
                           for i, p in enumerate(prompts)])
    got = tb.serve_batch([Request(uid=i, prompt=p, max_new_tokens=new)
                          for i, p in enumerate(prompts)])
    for g, w in zip(got, want):
        assert g.tokens.shape == (new,)
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))


def test_serve_batch_tokens_equal_jax():
    """Two ``serve_batch`` calls under one seed: each batch's frames come
    from the backend's generator (``modality_inputs``) as the reference's
    do, so the tokens are equal and both generators end equal."""
    jc, tc = _configs("float32")
    jb, tb = _backends(jc, tc, max_batch=2, max_seq=24, seed=3)
    rng = np.random.default_rng(8)
    for _ in range(2):
        _serve_both(jb, tb, [rng.integers(0, 1000, 6) for _ in range(2)], 4)
    assert tb._rng.random() == jb._rng.random()


def test_frames_do_not_count_against_max_seq():
    """1500 frames (whisper's own count), a 48-token prompt and 8 new
    tokens serve at the serve driver's max_seq of 96: the frames feed the
    encoder, not the decoder's cache; tokens equal the reference's."""
    jc, tc = _configs("float32", enc_seq=1500)
    jb, tb = _backends(jc, tc, max_batch=1, max_seq=96)
    _serve_both(jb, tb, [np.arange(48)], 8)
    with pytest.raises(ValueError, match="0 prefix.*max_seq=96"):
        tb.serve_batch([Request(uid=0, prompt=np.arange(90),
                                max_new_tokens=8)])


def test_a_vlm_prefix_still_counts_against_max_seq():
    """A llava batch whose 90 prefix embeddings, 9-token prompt and 4 new
    tokens overrun max_seq 96 still raises."""
    cfg = get_config("llava-next-34b").reduced(num_layers=2,
                                               num_prefix_embeds=90)
    be = Backend("llava-next-34b", cfg, max_seq=96, device="cpu")
    with pytest.raises(ValueError, match="90 prefix.*max_seq=96"):
        be.serve_batch([Request(uid=0, prompt=np.arange(9),
                                max_new_tokens=4)])
    assert be.serve_batch([Request(uid=0, prompt=np.arange(4),
                                   max_new_tokens=3)])[0].tokens.shape == (3,)


def test_decoder_self_cache_raises_past_max_seq():
    """The divergence past max_seq: the decoder's self cache holds max_seq
    positions in order.  Up to it both packages decode alike; the
    reference's ring then wraps and answers, the port raises."""
    jc, tc = _configs("float32")
    jp, tp = llm._params(jc, tc)
    toks, jfr, fr = _inputs(jc, batch=1, text=6)
    _, pre, dec = _jax_fns(jc, 8)
    jlog, jcache = pre(jp, jnp.asarray(toks, jnp.int32), jfr)
    tlog, tcache = prefill(tp, tc, torch.from_numpy(toks), fr, max_seq=8)
    with pytest.raises(ValueError, match="max_seq=5"):
        prefill(tp, tc, torch.from_numpy(toks), fr, max_seq=5)
    for _ in range(2):   # positions 6 and 7: the cache's last rows
        nxt = jnp.argmax(jlog, axis=-1).astype(jnp.int32)
        jlog, jcache = dec(jp, nxt, jcache)
        tlog, tcache = decode_step(tp, tc, torch.from_numpy(
            np.array(nxt)).long(), tcache)
        _close(tlog, jlog, "float32", logits=True)
    nxt = jnp.argmax(jlog, axis=-1).astype(jnp.int32)
    jlog, _ = dec(jp, nxt, jcache)
    assert np.isfinite(np.asarray(jlog)).all()
    with pytest.raises(ValueError, match="holds 8 positions"):
        decode_step(tp, tc, torch.from_numpy(np.array(nxt)).long(), tcache)


def test_check_config_refuses_what_encdec_does_not_run():
    cfg = get_config(WHISPER)
    for change, what in (({"use_rope": True}, "RoPE"),
                         ({"qkv_bias": True}, "biases"),
                         ({"mlp_variant": "swiglu"}, "mlp 'swiglu'")):
        with pytest.raises(ValueError, match=what):
            check_config(dataclasses.replace(cfg, **change))


# ------------------------------------------------- on a GPU (cuda marker)

def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


@pytest.mark.cuda
def test_whisper_on_cuda_matches_cpu():
    """Phase 41's check at reduced width: f32 on the card through the
    kernels against the CPU's plain versions, 4 decode steps; flash
    launches 2 encoder + 2 self + 2 cross, decode 2 x 2 a step."""
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU for the CUDA kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(WHISPER).reduced(activ_dtype="float32", enc_seq=300)
    params = init_params(cfg, seed=3, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 20)))
    frames = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 300, cfg.vision_dim), np.float32))
    out = {}
    before = (flash_ops.launches, decode_ops.launches)
    for dev in ("cuda", "cpu"):
        p = _to(params, dev)
        logits, cache = prefill(p, cfg, toks.to(dev), frames.to(dev),
                                max_seq=32)
        got = [logits.cpu()]
        for _ in range(4):
            logits, cache = decode_step(p, cfg, logits.argmax(-1), cache)
            got.append(logits.cpu())
        out[dev] = torch.cat(got, 1)
    assert (flash_ops.launches - before[0],
            decode_ops.launches - before[1]) == (6, 16)
    assert float((out["cuda"] - out["cpu"]).abs().max()) < 1e-3
    assert torch.equal(out["cuda"].argmax(-1), out["cpu"].argmax(-1))
