"""The vlm family (llava-next-34b) and the synthetic LM data
(``data/tokens.py``) in the port against the JAX package, on the CPU.

A vlm model is a dense model whose input is the prefix embeddings (the
stubbed vision tower's output, drawn by ``modality_inputs``) projected by
``vision_proj`` and placed before the text's embeddings; positions run over
both.  Both packages run the same parameters (``params_from_jax``) and the
same draws.  Bars: logits in f32 within 1e-4 with greedy tokens equal, in
bf16 within the dense bar (atol 6.25e-2, rtol 3e-2,
``tests/test_torch_llm.py``) against the reference run op by op
(``jax.disable_jit``); the token streams and the embeddings drawn exactly
equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_llm as llm
import torch

from repro.configs import get_config as jax_get_config
from repro.data import tokens as jax_tokens
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import model as jax_model
from repro.models import prefill as jax_prefill
from repro.serving.engine import Backend as JaxBackend
from repro.serving.engine import Request as JaxRequest
from repro_torch.configs import get_config, list_configs
from repro_torch.data import tokens
from repro_torch.launch import serve
from repro_torch.models import (ModelConfig, decode_step, forward,
                                init_params, params_from_jax, prefill)
from repro_torch.models import model
from repro_torch.models.model import check_config
from repro_torch.serving.engine import Backend, Request

torch.set_num_threads(1)

LLAVA = "llava-next-34b"


def _close(got, want, adt):
    atol, rtol = llm._tol(adt)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def _inputs(jc, tc, seed=5, batch=2, text=7):
    """Text tokens [batch, text] and the prefix embeddings both packages
    draw from one seed (equal arrays), as (numpy tokens, JAX prefix, port
    prefix)."""
    toks = np.random.default_rng(seed).integers(0, jc.vocab_size,
                                                (batch, text))
    jpe = jax_tokens.modality_inputs(jc, batch, np.random.default_rng(seed))
    pe = tokens.modality_inputs(tc, batch, np.random.default_rng(seed),
                                device="cpu")
    return toks, jpe["prefix_embeds"], pe["prefix_embeds"]


def _eager(adt):
    return jax.disable_jit(adt == "bfloat16")


# ------------------------------------------------------------- config

def test_config_equals_jax_and_is_listed():
    jc, tc = jax_get_config(LLAVA), get_config(LLAVA)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert dataclasses.asdict(tc.reduced()) == dataclasses.asdict(
        jc.reduced())
    assert LLAVA in list_configs()
    check_config(tc)
    assert (tc.num_prefix_embeds, tc.vision_dim) == (2880, 1152)
    # the other family with prefix embeddings (frames) is registered too
    assert "whisper-small" in list_configs()
    check_config(get_config("whisper-small"))


def test_vision_proj_carried_across():
    jc, tc = llm._configs(LLAVA, "bfloat16")
    jp, tp = llm._params(jc, tc)
    assert tp["vision_proj"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tp["vision_proj"].float().numpy(),
        np.asarray(jp["vision_proj"].astype(jnp.bfloat16).astype(
            jnp.float32)))
    own = init_params(tc, seed=0, device="cpu")
    assert own["vision_proj"].shape == (tc.vision_dim, tc.d_model)
    assert "vision_proj" not in init_params(
        get_config("llama3-8b").reduced(num_layers=2), device="cpu")


# ------------------------------------------------------------- model

@pytest.mark.parametrize("adt", ["float32", "bfloat16"])
def test_embed_inputs_equal_jax(adt):
    jc, tc = llm._configs(LLAVA, adt)
    jp, tp = llm._params(jc, tc)
    toks, jpe, pe = _inputs(jc, tc)
    with _eager(adt):
        want = jax_model._embed_inputs(jp, jc, jnp.asarray(toks, jnp.int32),
                                       jpe)
    got = model._embed_inputs(tp, tc, torch.from_numpy(toks), pe)
    assert got.dtype == tc.adtype and got.shape == (2, 8 + 7, tc.d_model)
    # the projection's sums in another order: f32 ulps, one bf16 rounding
    atol, rtol = (1e-5, 1e-5) if adt == "float32" else (0.0, 2.0 ** -8)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=atol, rtol=rtol)
    np.testing.assert_array_equal(got[:, 8:].float().numpy(), np.asarray(
        want[:, 8:].astype(jnp.float32)))


@pytest.mark.parametrize("adt", ["float32", "bfloat16"])
def test_model_with_prefix_equals_jax(adt):
    """forward, prefill and decode steps of the reduced llava (two layers,
    8 prefix embeddings before 7 text tokens): logits at the bar, greedy
    tokens equal in f32, the cache's position past the prefix."""
    jc, tc = llm._configs(LLAVA, adt)
    jp, tp = llm._params(jc, tc)
    toks, jpe, pe = _inputs(jc, tc)
    jt = jnp.asarray(toks, jnp.int32)
    steps = 5 if adt == "float32" else 2
    with _eager(adt):
        _close(forward(tp, tc, torch.from_numpy(toks), pe),
               jax_forward(jp, jc, jt, jpe), adt)
        jlog, jcache = jax_prefill(jp, jc, jt, jpe, max_seq=24)
        tlog, tcache = prefill(tp, tc, torch.from_numpy(toks), pe, max_seq=24)
        for step in range(steps + 1):
            _close(tlog, jlog, adt)
            nxt = jnp.argmax(jlog, axis=-1).astype(jnp.int32)
            if adt == "float32":
                np.testing.assert_array_equal(tlog.argmax(-1).numpy(),
                                              np.asarray(nxt))
            if step == steps:
                break
            jlog, jcache = jax_decode_step(jp, jc, nxt, jcache)
            tlog, tcache = decode_step(tp, tc, torch.from_numpy(
                np.array(nxt)).long(), tcache)
    assert tcache["pos"] == int(jcache["pos"]) == 8 + 7 + steps


# ------------------------------------------------------------- serving

def _backends(jc, tc, seed, max_seq=40):
    jb = JaxBackend(LLAVA, jc, max_batch=2, max_seq=max_seq, seed=seed)
    tb = Backend(LLAVA, tc, params=params_from_jax(
        tc, jax.tree_util.tree_map(np.asarray, jb.params), device="cpu"),
        max_batch=2, max_seq=max_seq, seed=seed, device="cpu")
    return jb, tb


def test_backend_draws_the_prefix_as_jax():
    """Two consecutive ``serve_batch`` calls under one seed: the backend
    draws each batch's prefix embeddings from its own generator as the
    reference's does, so the tokens are equal and both generators end in
    the same state."""
    jc, tc = llm._configs(LLAVA, "float32")
    jb, tb = _backends(jc, tc, seed=3)
    rng = np.random.default_rng(8)
    for _ in range(2):
        prompts = [rng.integers(0, 1000, 6) for _ in range(2)]
        want = jb.serve_batch([JaxRequest(uid=i, prompt=p, max_new_tokens=4)
                               for i, p in enumerate(prompts)])
        got = tb.serve_batch([Request(uid=i, prompt=p, max_new_tokens=4)
                              for i, p in enumerate(prompts)])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))
    assert tb._rng.random() == jb._rng.random()


def test_max_seq_counts_the_prefix(monkeypatch, capsys):
    """8 prefix + 9 prompt + 4 new tokens need 20 positions: max_seq 20
    takes them, 19 raises (the prompt alone would fit).  With the serve
    driver's max_seq of 96 and a prefix of 90 embeddings the port raises
    where the reference's ring wraps and answers (its global layers' ring
    is not ported, ``ROADMAP.md``)."""
    jc, tc = llm._configs(LLAVA, "float32")
    prompt = np.arange(9)
    for max_seq in (20, 19):
        jb, tb = _backends(jc, tc, seed=0, max_seq=max_seq)
        req = [Request(uid=0, prompt=prompt, max_new_tokens=4)]
        if max_seq == 20:
            assert tb.serve_batch(req)[0].tokens.shape == (4,)
        else:
            with pytest.raises(ValueError, match="8 prefix.*max_seq=19"):
                tb.serve_batch(req)
    wide = jax_get_config(LLAVA).reduced(num_layers=2,
                                         num_prefix_embeds=90)
    assert JaxBackend(LLAVA, wide, max_seq=96).serve_batch([JaxRequest(
        uid=0, prompt=prompt, max_new_tokens=4)])[0].tokens.shape == (4,)
    real = serve.get_config
    monkeypatch.setattr(serve, "get_config", lambda name: real(name).reduced(
        num_layers=2, num_prefix_embeds=90))
    with pytest.raises(ValueError, match="90 prefix.*max_seq=96"):
        serve.main(["--device", "cpu", "--archs", LLAVA, "--requests", "2"])


# ---------------------------------------------------------------- data

@pytest.mark.parametrize("arch", [LLAVA, "qwen2.5-3b"])
def test_token_stream_equals_jax(arch):
    """Three batches of ``TokenStream`` from one seed: tokens, labels and
    (for the vlm config) prefix embeddings equal the reference's."""
    jc, tc = jax_get_config(arch).reduced(), get_config(arch).reduced()
    data = dict(seq_len=24, batch_size=3, seed=11)
    want = jax_tokens.TokenStream(jc, jax_tokens.DataConfig(**data)).batches()
    got = tokens.TokenStream(tc, tokens.DataConfig(**data)).batches("cpu")
    for _ in range(3):
        w, g = next(want), next(got)
        assert sorted(g) == sorted(w)
        for name in w:
            assert g[name].device.type == "cpu"
            np.testing.assert_array_equal(g[name].numpy(),
                                          np.asarray(w[name]))
        assert g["tokens"].dtype == torch.int64
    assert ("prefix_embeds" in g) == (arch == LLAVA)


@pytest.mark.parametrize("arch", [LLAVA, "whisper-small", "llama3-8b"])
def test_modality_inputs_equal_jax(arch):
    jc = jax_get_config(arch)
    tc = ModelConfig(**dataclasses.asdict(jc))
    rng, jrng = np.random.default_rng(2), np.random.default_rng(2)
    for _ in range(2):
        want = jax_tokens.modality_inputs(jc, 2, jrng)
        got = tokens.modality_inputs(tc, 2, rng, device="cpu")
        assert sorted(got) == sorted(want)
        for name in want:
            assert got[name].dtype == torch.float32
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(want[name]))
    assert rng.random() == jrng.random()
