"""MLA and deepseek-v2-lite-16b in the port against the JAX package, on the
CPU: the config, ``init_mla`` and ``params_from_jax``, ``mla_forward``
and ``mla_decode_v2`` (the one-device carry path of the reference), the
latent cache, the model with its MoE layers, the max_seq bound, the MoE's
sorted form and the pool's routes.

Inputs are drawn with numpy from a seed.  Bars: the MLA functions in f32
within 1e-5 (atol and rtol), in bf16 at the moe family's layer bar (atol
2e-2, rtol 1e-2, ``tests/test_torch_moe.py``) against the reference run op
by op (``jax.disable_jit``, the evaluation the port follows); the model's
logits in f32 within 1e-4 (``tests/test_torch_llm.py``), greedy tokens and
every MoE layer's expert ids equal.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_llm as llm
import torch

from repro.configs import get_config as jax_get_config
from repro.core.policy import PoolPolicy as JaxPoolPolicy
from repro.core.policy import RouteRequest as JaxRouteRequest
from repro.launch.serve import synthetic_pool_table as jax_pool_table
from repro.models import attention as jax_attention
from repro.models import decode_step as jax_decode_step
from repro.models import moe as jax_moe
from repro.models import prefill as jax_prefill
from repro.serving.pool import ServingPool as JaxServingPool
from repro_torch.configs import get_config, list_configs
from repro_torch.core.policy import PoolPolicy, RouteRequest
from repro_torch.launch import serve
from repro_torch.models import decode_step, init_params, moe, prefill
from repro_torch.models.attention import (init_mla, mla_decode_v2,
                                          mla_forward)
from repro_torch.models.kvcache import MLACache, init_cache
from repro_torch.models.model import check_config
from repro_torch.serving.engine import Backend, Request
from repro_torch.serving.pool import ServingPool, synthetic_pool_table

torch.set_num_threads(1)

DSV2 = "deepseek-v2-lite-16b"
#: (atol, rtol) of an MLA layer's output, by activation dtype
LAYER_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 1e-2)}


def _close(got, want, atol, rtol):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def _eager(adt):
    """The reference op by op in bf16, jitted in f32."""
    return jax.disable_jit() if adt == "bfloat16" else contextlib.nullcontext()


def _mla_layer(adt, seed=0):
    """The reduced config's MLA parameters: the JAX ones (f32) and the same
    values in ``adt`` for the port, and an input x [2, 12, d] in ``adt``
    for both."""
    jc, tc = llm._configs(DSV2, adt)
    jp = jax_attention.init_mla(jax.random.PRNGKey(seed), jc, jnp.float32)
    dt = getattr(torch, adt)
    tp = {n: torch.from_numpy(np.array(a)).to(dt) for n, a in jp.items()}
    x = np.random.default_rng(seed).standard_normal((2, 12, jc.d_model))
    jx = jnp.asarray(x, getattr(jnp, adt))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(dt)
    return jc, tc, jp, tp, jx, tx


# ------------------------------------------------------------- config

def test_config_equals_jax_and_is_listed():
    jc, tc = jax_get_config(DSV2), get_config(DSV2)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert dataclasses.asdict(tc.reduced()) == dataclasses.asdict(
        jc.reduced())
    assert DSV2 in list_configs()
    check_config(tc)
    check_config(tc.reduced())
    assert (tc.use_mla, tc.num_experts, tc.moe_top_k,
            tc.num_shared_experts) == (True, 64, 6, 2)


def test_init_mla_and_params_from_jax():
    """``init_mla``'s shapes are the reference's; ``init_params`` puts an
    ``mla`` sub-tree where a GQA model has ``attn``, and
    ``params_from_jax`` carries its values across in the activation
    dtype."""
    jc, tc = llm._configs(DSV2, "bfloat16")
    gen = torch.Generator().manual_seed(0)
    own = init_mla(gen, tc, torch.bfloat16)
    ref = jax_attention.init_mla(jax.random.PRNGKey(0), jc, jnp.float32)
    assert {n: tuple(w.shape) for n, w in own.items()} == \
        {n: a.shape for n, a in ref.items()}
    jp, tp = llm._params(jc, tc)
    for i, layer in enumerate(tp["blocks"]["s0"]):
        assert sorted(layer) == ["mla", "moe", "norm1", "norm2"]
        for name, w in layer["mla"].items():
            assert w.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                w.float().numpy(),
                np.asarray(jp["blocks"]["s0"]["mla"][name][i].astype(
                    jnp.bfloat16).astype(jnp.float32)))
    seeded = init_params(tc, seed=0, device="cpu")["blocks"]["s0"]
    assert jax.tree_util.tree_map(lambda t: (t.shape, t.dtype), seeded) == \
        jax.tree_util.tree_map(lambda t: (t.shape, t.dtype),
                               tp["blocks"]["s0"])


# ------------------------------------------------------- MLA functions

@pytest.mark.parametrize("return_cache", [False, True])
@pytest.mark.parametrize("adt", ["float32", "bfloat16"])
def test_mla_forward_equals_jax(adt, return_cache):
    jc, tc, jp, tp, jx, tx = _mla_layer(adt)
    b, s = tx.shape[:2]
    pos = np.broadcast_to(np.arange(s), (b, s))
    with _eager(adt):
        want = jax_attention.mla_forward(jp, jc, jx, jnp.asarray(pos),
                                         return_cache=return_cache)
    got = mla_forward(tp, tc, tx, torch.from_numpy(pos.copy()),
                      return_cache=return_cache)
    if not return_cache:
        got, want = (got, None), (want, None)
    (out, rows), (jout, jrows) = got, want
    assert out.dtype == tx.dtype and out.shape == tx.shape
    _close(out, jout, *LAYER_TOL[adt])
    if return_cache:
        for mine, theirs in zip(rows, jrows):
            assert mine.dtype == tx.dtype
            _close(mine, theirs, *LAYER_TOL[adt])
        assert rows[0].shape == (b, s, tc.kv_lora_rank)
        assert rows[1].shape == (b, s, tc.qk_rope_dim)


@pytest.mark.parametrize("adt", ["float32", "bfloat16"])
def test_mla_decode_v2_equals_jax(adt):
    """One token at position 9 over the latent rows of positions [0, 9):
    the reference reads a cache of 16 rows and masks rows >= 9, the port
    is given the first 9."""
    jc, tc, jp, tp, _, _ = _mla_layer(adt)
    rng = np.random.default_rng(3)
    dt, jdt = getattr(torch, adt), getattr(jnp, adt)
    pos, t = 9, 16
    x = jnp.asarray(rng.standard_normal((2, 1, jc.d_model)), jdt)
    c = jnp.asarray(rng.standard_normal((2, t, jc.kv_lora_rank)), jdt)
    kr = jnp.asarray(rng.standard_normal((2, t, jc.qk_rope_dim)), jdt)

    def port(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(dt)

    with _eager(adt):
        want = jax_attention.mla_decode_v2(jp, jc, x, c, kr, pos)
    got = mla_decode_v2(tp, tc, port(x), port(c)[:, :pos], port(kr)[:, :pos],
                        pos)
    for mine, theirs in zip(got, want):
        assert mine.dtype == dt and mine.shape == theirs.shape
        _close(mine, theirs, *LAYER_TOL[adt])


# ------------------------------------------------------------- model

def test_model_tokens_and_expert_ids_equal_jax(monkeypatch):
    """Prefill of 2 x 11 tokens and 8 decode steps of the reduced
    deepseek-v2-lite (two MLA + MoE layers, 4 experts, top-2, 2 shared) in
    f32: logits within 1e-4, greedy tokens equal, and every MoE layer's
    expert ids equal, in order, to the reference's (recorded from
    ``route_topk`` in both packages)."""
    jc, tc = llm._configs(DSV2, "float32")
    jp, tp = llm._params(jc, tc)
    jids, tids = [], []
    jax_route, route = jax_moe.route_topk, moe.route_topk

    def jax_recorded(*a):
        out = jax_route(*a)
        jax.debug.callback(lambda ids: jids.append(np.asarray(ids)), out[1],
                           ordered=True)
        return out

    def recorded(*a):
        out = route(*a)
        tids.append(out[1].numpy())
        return out

    monkeypatch.setattr(jax_moe, "route_topk", jax_recorded)
    monkeypatch.setattr(moe, "route_topk", recorded)
    pre = jax.jit(lambda p, t: jax_prefill(p, jc, t, max_seq=24))
    dec = jax.jit(lambda p, t, c: jax_decode_step(p, jc, t, c))
    toks = np.random.default_rng(1).integers(0, jc.vocab_size, (2, 11))
    jlog, jcache = pre(jp, jnp.asarray(toks, jnp.int32))
    tlog, tcache = prefill(tp, tc, torch.from_numpy(toks), max_seq=24)
    for step in range(9):
        _close(tlog, jlog, 1e-4, 1e-4)
        nxt = jnp.argmax(jlog, axis=-1).astype(jnp.int32)
        np.testing.assert_array_equal(tlog.argmax(-1).numpy(),
                                      np.asarray(nxt))
        if step == 8:
            break
        jlog, jcache = dec(jp, nxt, jcache)
        tlog, tcache = decode_step(tp, tc, torch.from_numpy(
            np.array(nxt)).long(), tcache)
    jax.effects_barrier()
    assert tcache["pos"] == int(jcache["pos"]) == 19
    assert len(tids) == len(jids) == 2 * 9
    for mine, theirs in zip(tids, jids):
        np.testing.assert_array_equal(mine, theirs)
    # the latent cache holds the reference's rows [0, 19)
    for i, entry in enumerate(tcache["blocks"]["s0"]):
        for mine, theirs in zip(entry, jcache["blocks"]["s0"]):
            _close(mine[:, :19], theirs[i][:, :19], 1e-5, 1e-5)


def test_mla_cache_shapes():
    """One ``MLACache`` per layer: the latent c [B, max_seq, r] and k_rope
    [B, max_seq, dr] in the activation dtype, not a stacked K/V (the
    ``("attn",)`` layout's dense cache)."""
    for cfg, rows in ((get_config(DSV2), (512, 64)),
                      (get_config(DSV2).reduced(num_layers=2), (64, 16))):
        cache = init_cache(cfg, 3, 40, cfg.adtype, "cpu")
        entries = cache["blocks"]["s0"]
        assert isinstance(entries, list) and len(entries) == cfg.num_layers
        for entry in entries:
            assert isinstance(entry, MLACache)
            assert [tuple(t.shape) for t in entry] == [(3, 40, n)
                                                       for n in rows]
            assert {t.dtype for t in entry} == {torch.bfloat16}
    assert cache["max_seq"] == 40 and cache["pos"] == 0


def test_raises_past_max_seq():
    jc, tc = llm._configs(DSV2, "float32")
    _, tp = llm._params(jc, tc)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, tc.vocab_size, (1, 8)))
    with pytest.raises(ValueError, match="max_seq=6"):
        prefill(tp, tc, toks, max_seq=6)
    logits, cache = prefill(tp, tc, toks, max_seq=9)
    logits, cache = decode_step(tp, tc, logits.argmax(-1), cache)
    with pytest.raises(ValueError, match="holds 9 positions"):
        decode_step(tp, tc, logits.argmax(-1), cache)
    be = Backend(DSV2, tc, params=tp, max_seq=12, device="cpu")
    with pytest.raises(ValueError, match="max_seq=12"):
        be.serve_batch([Request(uid=0, prompt=np.arange(10),
                                max_new_tokens=4)])
    assert be.serve_batch([Request(uid=0, prompt=np.arange(10),
                                   max_new_tokens=3)])[0].tokens.shape == (3,)


# ------------------------------------------------------------ the MoE

@pytest.mark.parametrize("adt", ["float32", "bfloat16"])
def test_sorted_form_grouped_products_equal_per_expert_products(adt):
    """The sorted form's grouped products (group ends kept on the tokens'
    device) are, on the CPU, the per-expert products bit for bit, empty
    groups included: 64 experts, top-6, over 40 tokens."""
    cfg = dataclasses.replace(get_config(DSV2).reduced(num_layers=2),
                              num_experts=64, moe_top_k=6)
    dt = getattr(torch, adt)
    p = moe.init_moe(torch.Generator().manual_seed(1), cfg, dt)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (40, cfg.d_model)).astype(np.float32)).to(dt)
    tok, w, _, sizes, _ = moe._dispatch(cfg, p["router"], x)
    assert int(sizes.sum()) == 40 * 6 and int((sizes == 0).sum()) > 0
    rows = x[tok].split(sizes.tolist())
    per_expert = torch.cat([moe._expert(p, e, r) for e, r in enumerate(rows)])
    want = moe._add_in_order(tok, per_expert * w.to(dt)[:, None], 40)
    assert torch.equal(moe._experts_sorted(p, x, tok, w, sizes), want)


@pytest.mark.parametrize("arch,t,sorted_form", [
    (DSV2, 8, False), (DSV2, 256, False), (DSV2, 512, True),
    (DSV2, 8192, True), ("granite-moe-1b-a400m", 2048, False),
    ("granite-moe-1b-a400m", 8192, True)])
def test_card_form_by_size(arch, t, sorted_form):
    """The card's choice between the forms at the published widths: the
    sorted form from the every-expert form's 6e10 multiply-adds a product
    (below it the sorted form's launches cost the host more than its
    products save, ``chip_smoke.py`` phase 37)."""
    cfg = get_config(arch)
    macs = t * cfg.num_experts * cfg.d_model * cfg.moe_d_ff
    assert (macs >= moe.SORTED_MIN_MACS) == sorted_form


# ------------------------------------------------------- serving

@pytest.mark.parametrize("archs,delta,routes", [
    (("deepseek-v2-lite-16b", "llama3-8b"), 12.4,
     ("deepseek-v2-lite-16b", "llama3-8b")),
    (("llava-next-34b", "mamba2-370m"), 20.0,
     ("mamba2-370m", "llava-next-34b"))])
def test_pool_routes_equal_jax(archs, delta, routes):
    """The pools of ``chip_smoke.py``'s services with the new configs: the
    table and every decision equal the reference's, and a complexity of
    512 (bucket 0) and one of 1024 (bucket 1) go to ``routes``."""
    jpool = JaxServingPool(jax_pool_table(archs), delta=delta)
    pool = ServingPool(synthetic_pool_table(archs, device="cpu"), delta=delta)
    assert [(e.model, e.map_pct, e.time_ms, e.energy_mwh)
            for e in pool.table.entries] == \
        [(e.model, e.map_pct, e.time_ms, e.energy_mwh)
         for e in jpool.table.entries]
    lens = [1, 512, 513, 1024, 2049, 8193, 40000]
    want = JaxPoolPolicy(jpool).decide_batch(
        [JaxRouteRequest(uid=i, complexity=n) for i, n in enumerate(lens)])
    got = PoolPolicy(pool).decide_batch(
        [RouteRequest(uid=i, complexity=n) for i, n in enumerate(lens)])
    assert [dataclasses.asdict(d) for d in got] == \
        [dataclasses.asdict(d) for d in want]
    assert (pool.route(512).arch, pool.route(1024).arch) == routes


def test_serve_driver_takes_deepseek_v2(capsys):
    """``--archs deepseek-v2-lite-16b llama3-8b --delta 12.4`` through the
    port's serve driver (reduced, on the CPU): every request served, short
    ones by deepseek-v2-lite."""
    assert serve.main(["--device", "cpu", "--reduced", "--archs", DSV2,
                       "llama3-8b", "--delta", "12.4", "--requests", "8",
                       "--max-new", "3"]) in (None, 0)
    out = capsys.readouterr().out
    assert "8 requests in" in out
    assert f"bucket=0 -> {DSV2}" in out
