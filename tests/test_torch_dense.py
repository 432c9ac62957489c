"""The rest of the dense family in the port (deepseek-7b, gemma2-9b,
gemma2-9b-swa, llama3-8b-swa) against the JAX package, on the CPU.

Both packages run the same parameters: the JAX ``init_params`` tree, norms
(post-norms too) and biases perturbed, carried across by
``params_from_jax``.  The reference runs jitted.  In f32 the logits agree
within 1e-4 and the greedy tokens are equal, in bf16 within the dense bar
(atol 6.25e-2, rtol 3e-2; ``tests/test_torch_llm.py``).  The
sliding-window layers' ring (``models/kvcache.py``) decodes past its wrap
in both of the JAX ring's cases: R = window, and R = max_seq + 1 when
max_seq is shorter than the window, where the reference attends the last
max_seq + 1 positions.
"""
import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_llm as llm
import torch
from test_torch_serve import _drive

from repro.configs import get_config as jax_get_config
from repro.configs import list_configs as jax_list_configs
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import prefill as jax_prefill
from repro.serving.engine import Request as JaxRequest
from repro_torch.configs import get_config, list_configs
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import (ModelConfig, decode_step, forward,
                                init_params, prefill)
from repro_torch.models.kvcache import ring_rows
from repro_torch.models.model import check_config
from repro_torch.serving.engine import Backend, Request
from repro_torch.serving.pool import DEFAULT_POOL

torch.set_num_threads(1)

DENSE = ("deepseek-7b", "gemma2-9b", "gemma2-9b-swa", "llama3-8b-swa")
SWA = ("llama3-8b-swa", "gemma2-9b-swa")
#: gemma2's caps replaced by ones that bite at the reduced width
BITING = {"attn_softcap": 0.5, "final_softcap": 1.0}


@functools.lru_cache(maxsize=None)
def _jax_fns(jc, max_seq):
    """The reference's forward, prefill and decode step, jitted."""
    return (jax.jit(lambda p, t: jax_forward(p, jc, t)),
            jax.jit(lambda p, t: jax_prefill(p, jc, t, max_seq=max_seq)),
            jax.jit(lambda p, t, c: jax_decode_step(p, jc, t, c)))


def _run_both(arch, activ_dtype, prompt_len, max_seq, steps, **kw):
    """forward over the prompt, then prefill and ``steps`` decode steps,
    in both packages on the same weights and the same (the reference's
    greedy) tokens; the port's logits held to the reference's at every
    step, and in f32 its greedy tokens too.  Returns the port's and the
    reference's final caches and the two configs."""
    jc, tc = llm._configs(arch, activ_dtype, **kw)
    jp, tp = llm._params(jc, tc)
    atol, rtol = llm._tol(activ_dtype)
    fwd, pre, dec = _jax_fns(jc, max_seq)
    toks = np.random.default_rng(1).integers(0, jc.vocab_size,
                                             (2, prompt_len))

    def close(got, want):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=atol, rtol=rtol)

    close(forward(tp, tc, torch.from_numpy(toks)),
          fwd(jp, jnp.asarray(toks, jnp.int32)))
    jlog, jcache = pre(jp, jnp.asarray(toks, jnp.int32))
    tlog, tcache = prefill(tp, tc, torch.from_numpy(toks), max_seq=max_seq)
    for step in range(steps + 1):
        close(tlog, jlog)
        nxt = jnp.argmax(jlog, axis=-1).astype(jnp.int32)
        if activ_dtype == "float32":
            np.testing.assert_array_equal(tlog.argmax(-1).numpy(),
                                          np.asarray(nxt))
        if step == steps:
            break
        jlog, jcache = dec(jp, nxt, jcache)
        tlog, tcache = decode_step(tp, tc, torch.from_numpy(
            np.array(nxt)).long(), tcache)
    assert tcache["pos"] == int(jcache["pos"]) == prompt_len + steps
    return tcache, jcache, tc


# ------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", DENSE)
def test_configs_equal_jax_field_for_field(arch):
    jc, tc = jax_get_config(arch), get_config(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    for prop in ("is_subquadratic", "n_blocks"):
        assert getattr(tc, prop) == getattr(jc, prop), prop
    assert dataclasses.asdict(tc.reduced()) == dataclasses.asdict(
        jc.reduced())
    check_config(tc)
    check_config(tc.reduced())


def test_list_configs_equal_jax_but_the_unported():
    """Every architecture of the JAX registry is ported (whisper-small, the
    last, since the encdec family): the lists are equal, in order; an
    unknown name still raises."""
    for variants in (False, True):
        assert list_configs(include_variants=variants) == \
            jax_list_configs(include_variants=variants)
    assert set(SWA) <= set(list_configs(True)) - set(list_configs())
    check_config(get_config("whisper-small"))
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("whisper-large")


@pytest.mark.parametrize("arch,change,what", [
    ("whisper-small", {"use_rope": True}, "RoPE or q/k/v biases"),
    ("llama3-8b", {"mlp_variant": "gelu"}, "mlp 'gelu'"),
    ("deepseek-7b", {"use_rope": False}, "positions without RoPE")])
def test_check_config_still_refuses(arch, change, what):
    """What stays refused now that whisper-small runs: RoPE in the encdec
    family, and its ungated GELU MLP and RoPE-less positions outside it."""
    with pytest.raises(ValueError, match=what):
        check_config(ModelConfig(**{**dataclasses.asdict(
            jax_get_config(arch)), **change}))


def test_post_norms_carried_across_in_f32():
    """gemma2's sandwich norms: ``init_params`` draws them with the JAX
    names, ``params_from_jax`` carries them as f32 vectors."""
    jc, tc = llm._configs("gemma2-9b", "bfloat16")
    jp, tp = llm._params(jc, tc)
    own = init_params(tc, seed=0, device="cpu")["blocks"]["s0"]
    for i, (mine, layer) in enumerate(zip(own, tp["blocks"]["s0"])):
        assert sorted(mine) == sorted(layer) == sorted(jp["blocks"][f"s{i}"])
        assert {"norm1b", "norm2b"} < set(layer)
        slot = jp["blocks"][f"s{i}"]
        for name in ("norm1b", "norm2b"):
            assert layer[name].dtype == torch.float32
            np.testing.assert_array_equal(layer[name].numpy(),
                                          np.asarray(slot[name][0]))


# --------------------------------------------------------------- model

@pytest.mark.parametrize("caps", ["biting", "published"])
@pytest.mark.parametrize("activ_dtype", ["float32", "bfloat16"])
def test_gemma2_matches_jax(caps, activ_dtype):
    """Reduced gemma2-9b (window 16; local, global): forward over a 24-token
    prompt, then prefill and 12 decode steps at max_seq 40 (the local ring
    of 16 rows wraps), at caps that bite (0.5 on the scores, 1.0 on the
    logits) and at the published 50 and 30."""
    kw = BITING if caps == "biting" else {}
    tcache, jcache, tc = _run_both("gemma2-9b", activ_dtype, 24, 40, 12,
                                   **kw)
    local, glob = tcache["blocks"]["s0"]
    assert local.k.shape[2] == 16 and glob.k.shape[2] == 40
    if caps == "biting":   # the caps change the model
        free = llm._configs("gemma2-9b", activ_dtype)[1]
        params = init_params(free, seed=0, device="cpu")
        toks = torch.arange(24)[None] * 7 % 500
        assert float((forward(params, tc, toks) - forward(params, free, toks))
                     .abs().max()) > 0.1


@pytest.mark.parametrize("arch", SWA)
@pytest.mark.parametrize("max_seq,prompt_len,steps,rows", [
    (40, 20, 24, 16), (12, 10, 20, 13), (12, 20, 8, 13)],
    ids=["R=window", "R=max_seq+1", "R=max_seq+1,long-prompt"])
def test_swa_decodes_past_the_ring_as_jax(arch, max_seq, prompt_len, steps,
                                          rows):
    """A local-only model (window 16) past its ring's wrap, in f32: at
    max_seq 40 the ring holds the window (16 rows); at max_seq 12 the JAX
    ring of 12 slots attends 13 positions and the port's ring holds 13
    rows, past max_seq, whether the ring first fills in decode (a 10-token
    prompt) or in prefill (a 20-token one).  Every ring row holds the K/V of the position
    p = slot (mod R) that the JAX ring's ``pos_buf`` names."""
    tcache, jcache, tc = _run_both(arch, "float32", prompt_len, max_seq,
                                   steps)
    assert ring_rows(tc, max_seq) == rows
    w = min(tc.sliding_window, max_seq)     # the JAX ring's slots
    for i, entry in enumerate(tcache["blocks"]["s0"]):
        js = jcache["blocks"]["s0"]
        pos_buf = np.asarray(js.pos_buf[i])
        assert entry.k.shape == (2, tc.num_kv_heads, rows, tc.head_dim)
        assert sorted(pos_buf) == list(range(prompt_len + steps - w,
                                             prompt_len + steps))
        for name in ("k", "v"):
            ring = np.asarray(getattr(js, name)[i], np.float32)
            np.testing.assert_allclose(
                getattr(entry, name)[:, :, pos_buf % rows].numpy(),
                ring.transpose(0, 2, 1, 3), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("activ_dtype", ["float32", "bfloat16"])
def test_deepseek_matches_jax(activ_dtype):
    """Reduced deepseek-7b (MHA: 4 heads over 4 KV heads): forward, prefill
    of 11 tokens and 6 decode steps."""
    tcache, _, tc = _run_both("deepseek-7b", activ_dtype, 11, 24, 6)
    assert tc.num_kv_heads == tc.num_heads == 4
    assert tcache["blocks"]["s0"].k.shape[1:] == (2, 4, 24, 32)


def test_local_only_takes_any_length_and_global_layers_raise():
    """llama3-8b-swa decodes past max_seq on a ring of R rows, whose
    decode kernel reads min(pos + 1, R) rows with no window; gemma2-9b
    (a global layer every other layer) still raises past max_seq."""
    cfg = get_config("llama3-8b-swa").reduced(num_layers=2)
    params = init_params(cfg, seed=0, device="cpu")
    seen, decode = [], decode_ops.decode

    def spy(q, k, v, lengths, **kw):
        seen.append((k.shape[2], lengths.tolist(), kw))
        return decode(q, k, v, lengths, **kw)
    _, cache = prefill(params, cfg, torch.zeros((1, 30), dtype=torch.long),
                       max_seq=8)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(decode_ops, "decode", spy)
        for _ in range(3):
            _, cache = decode_step(params, cfg, torch.zeros(
                (1, 1), dtype=torch.long), cache)
    assert cache["pos"] == 33
    assert [e.k.shape[2] for e in cache["blocks"]["s0"]] == [9, 9]
    assert seen == [(9, [9], {"softcap": None})] * 6
    gcfg = get_config("gemma2-9b").reduced()
    gparams = init_params(gcfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="max_seq=8"):
        prefill(gparams, gcfg, torch.zeros((1, 9), dtype=torch.long),
                max_seq=8)
    _, gcache = prefill(gparams, gcfg, torch.zeros((1, 8), dtype=torch.long),
                        max_seq=8)
    with pytest.raises(ValueError, match="full"):
        decode_step(gparams, gcfg, torch.zeros((1, 1), dtype=torch.long),
                    gcache)
    backend = Backend("gemma2-9b", gcfg, gparams, max_seq=8, device="cpu")
    with pytest.raises(ValueError, match="max_seq=8"):
        backend.serve_batch([Request(uid=0, prompt=np.arange(6),
                                     max_new_tokens=4)])


# ------------------------------------------------------------- serving

@pytest.mark.parametrize("arch,prompt_len", [
    ("gemma2-9b", 9), ("llama3-8b-swa", 20), ("deepseek-7b", 9)])
def test_serve_batch_tokens_equal_jax(arch, prompt_len):
    """``Backend.serve_batch`` at max_seq 16: llama3-8b-swa's 20-token
    prompt and 6 new tokens run past it, as the JAX backend's do."""
    jb, tb = llm._backends(arch, max_batch=4, max_seq=16)
    rng = np.random.default_rng(prompt_len)
    reqs = [(i, rng.integers(0, 1000, prompt_len)) for i in range(3)]
    want = jb.serve_batch([JaxRequest(uid=u, prompt=p, max_new_tokens=6)
                           for u, p in reqs])
    got = tb.serve_batch([Request(uid=u, prompt=p, max_new_tokens=6)
                          for u, p in reqs])
    for g, w in zip(got, want):
        assert g.uid == w.uid and g.backend == w.backend == arch
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))


@pytest.mark.parametrize("delta", [0.02, 5.0])
def test_pool_and_routes_equal_jax(delta):
    """The four with the default pool: profile rows and decisions (bucket
    4 goes to a ``-swa`` variant, sub-quadratic) equal to the JAX
    package's."""
    llm.test_pool_and_policy_decisions_equal_jax(DENSE + DEFAULT_POOL, delta)


def test_serve_driver_prints_the_references_lines(monkeypatch, capsys):
    """``--archs deepseek-7b gemma2-9b-swa`` through both drivers with the
    stub backend: at δ = 5 the two 40 000-token requests go to
    gemma2-9b-swa, the rest to deepseek-7b."""
    want, got, measured = _drive(monkeypatch, capsys, [
        "--archs", "deepseek-7b", "gemma2-9b-swa", "--requests", "16"])
    assert got == want and not measured
    routed = {re.search(r"-> (\S+)", ln).group(1) for ln in got
              if ln.startswith("req ")}
    assert routed == {"deepseek-7b", "gemma2-9b-swa"}


# ------------------------------------------------- on a GPU (cuda marker)

@pytest.mark.cuda
def test_ring_on_cuda_matches_forward():
    """Phase 34's check at reduced width: llama3-8b-swa (window 16) in f32
    on the card, a 40-token prompt into rings of 16 rows and 16 decode
    steps; each step's logits within 1e-3 of ``forward`` over the whole
    sequence on the card, argmax equal, one flash launch per layer and one
    decode launch per layer per step."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU for the CUDA kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("llama3-8b-swa").reduced(num_layers=2,
                                              activ_dtype="float32")
    params = init_params(cfg, seed=3, device="cuda")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (1, 40))).cuda()
    before = (flash_ops.launches, decode_ops.launches)
    logits, cache = prefill(params, cfg, toks, max_seq=16)
    steps = [logits]
    for _ in range(16):
        toks = torch.cat([toks, logits.argmax(-1)], 1)
        logits, cache = decode_step(params, cfg, toks[:, -1:], cache)
        steps.append(logits)
    assert (flash_ops.launches - before[0],
            decode_ops.launches - before[1]) == (2, 32)
    assert [e.k.shape[2] for e in cache["blocks"]["s0"]] == [16, 16]
    want = forward(params, cfg, toks)[:, 39:]
    got = torch.cat(steps, 1)
    assert float((got - want).abs().max()) < 1e-3
    assert torch.equal(got.argmax(-1), want.argmax(-1))
