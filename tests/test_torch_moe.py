"""The port's MoE family (``models/moe.py``, granite-moe-1b-a400m) against
the JAX package's ``repro.models.moe`` and MoE model on the CPU, and the
completed default serving pool.

Inputs are drawn with numpy from a seed, so both frameworks see the same
values.  Bars: routing ids and group sizes exactly equal, weights and
router probabilities within 1e-6; the layer's output in f32 within atol
1e-5 plus rtol 1e-6 (outputs reach ~20, where an f32 ulp is 2e-6) and its
load-balance loss within 1e-6; the model's logits within 1e-4 in f32 with greedy tokens
equal, and in bf16 at the dense family's bar (atol 6.25e-2, rtol 3e-2,
``tests/test_torch_llm.py``).  In bf16 the k weighted expert outputs of a
token are added one at a time in expert-sorted order, as the reference's
scatter-add does: given the same rows, that sum is bit-equal.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.policy import PoolPolicy as JaxPoolPolicy
from repro.core.policy import RouteRequest as JaxRouteRequest
from repro.launch.serve import DEFAULT_POOL as JAX_DEFAULT_POOL
from repro.launch.serve import synthetic_pool_table as jax_pool_table
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import moe as jax_moe
from repro.models import prefill as jax_prefill
from repro.models.base import ModelConfig as JaxModelConfig
from repro.serving.engine import Backend as JaxBackend
from repro.serving.engine import Request as JaxRequest
from repro.serving.pool import ServingPool as JaxServingPool
from repro.serving.service import EcoreService as JaxEcoreService
from repro_torch.configs import get_config
from repro_torch.core.policy import PoolPolicy, RouteRequest
from repro_torch.models import (ModelConfig, decode_step, forward,
                                init_params, params_from_jax, prefill)
from repro_torch.models import moe
from repro_torch.models.model import check_config
from repro_torch.serving.engine import Backend, Request
from repro_torch.serving.pool import (DEFAULT_POOL, ServingPool,
                                      synthetic_pool_table)
from repro_torch.serving.service import EcoreService

torch.set_num_threads(1)

GRANITE = "granite-moe-1b-a400m"
#: tests/test_moe.py's (t, e, k) grid
TEK = [(64, 8, 2), (128, 4, 1), (96, 16, 4)]


def _cfgs(**kw):
    """tests/test_moe.py's small MoE config in both packages."""
    base = dict(name="m", family="moe", num_layers=1, d_model=32,
                num_heads=2, num_kv_heads=2, d_ff=0, moe_d_ff=16,
                num_experts=8, moe_top_k=2, vocab_size=64,
                block_layout=("attn",))
    base.update(kw)
    return JaxModelConfig(**base), ModelConfig(**base)


def _layer(jc, tc, seed=0, adt="float32"):
    """The JAX layer's parameters (f32) and the same values in the port's
    form, the router in f32 and the experts in ``adt``."""
    jp = jax_moe.init_moe(jax.random.PRNGKey(seed), jc, jnp.float32)
    dt = getattr(torch, adt)

    def conv(tree, f32=()):
        return {n: conv(a) if isinstance(a, dict) else
                torch.from_numpy(np.array(a)).to(
                    torch.float32 if n in f32 else dt)
                for n, a in tree.items()}
    return jp, conv(jp, ("router",))


def _x(t, d, seed=1, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((t, d)).astype(dtype)


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


# ------------------------------------------------------------- routing

@pytest.mark.parametrize("t,e,k", TEK)
def test_route_topk_equals_jax(t, e, k):
    jc, tc = _cfgs(num_experts=e, moe_top_k=k)
    jp, tp = _layer(jc, tc)
    x = _x(t, 32)
    jw, jids, jprobs = jax_moe.route_topk(jp["router"], jnp.asarray(x), k)
    w, ids, probs = moe.route_topk(tp["router"], torch.from_numpy(x), k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    _close(w, jw, 1e-6)
    _close(probs, jprobs, 1e-6)
    assert w.dtype == probs.dtype == torch.float32


@pytest.mark.parametrize("t,e,k", TEK)
def test_route_topk_breaks_ties_as_lax_top_k(t, e, k):
    """A zero router gives every expert the same probability: lax.top_k
    takes the lowest ids in ascending order.  With the router's columns in
    equal pairs, every pick of a pair's second member follows its first."""
    x = _x(t, 32)
    zero = np.zeros((32, e), np.float32)
    _, jids, _ = jax_moe.route_topk(jnp.asarray(zero), jnp.asarray(x), k)
    w, ids, _ = moe.route_topk(torch.from_numpy(zero), torch.from_numpy(x), k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(ids.numpy(), np.tile(np.arange(k), (t, 1)))
    np.testing.assert_array_equal(w.numpy(), np.full((t, k), 1 / k,
                                                     np.float32))
    half = np.random.default_rng(2).standard_normal((32, e // 2 or 1))
    pairs = np.repeat(half, 2, axis=1)[:, :e].astype(np.float32)
    _, jids, _ = jax_moe.route_topk(jnp.asarray(pairs), jnp.asarray(x), k)
    _, ids, _ = moe.route_topk(torch.from_numpy(pairs), torch.from_numpy(x),
                               k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))


@pytest.mark.parametrize("t,e,k", TEK)
def test_dispatch_equals_jax(t, e, k, monkeypatch):
    """The sort is exact: token order and group sizes equal; the weights
    equal the reference's bit for bit when both sort the same routing (the
    JAX route fed to the port), and within route_topk's 1e-6 otherwise
    (the two frameworks' f32 products and exp differ by an ulp)."""
    jc, tc = _cfgs(num_experts=e, moe_top_k=k)
    jp, tp = _layer(jc, tc)
    x = _x(t, 32)
    jtok, jw, jids, jsizes, _ = jax_moe._dispatch(jc, jp["router"],
                                                  jnp.asarray(x))
    tok, w, ids, sizes, _ = moe._dispatch(tc, tp["router"],
                                          torch.from_numpy(x))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    _close(w, jw, 1e-6)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(jsizes))
    assert sizes.dtype == torch.int32 and int(sizes.sum()) == t * k
    route = [torch.from_numpy(np.array(a)) for a in jax_moe.route_topk(
        jp["router"], jnp.asarray(x), k)]
    monkeypatch.setattr(moe, "route_topk", lambda *args: (
        route[0], route[1].long(), route[2]))
    tok, w, _, sizes, _ = moe._dispatch(tc, tp["router"], torch.from_numpy(x))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(jsizes))


# ---------------------------------------------------------- the layer

@pytest.mark.parametrize("t,e,k", TEK)
def test_moe_ragged_equals_jax_in_f32(t, e, k):
    """Both forms, the CPU's sorted one (``moe_ragged`` here) and the
    card's every-expert one (``_experts_all``), against the reference."""
    jc, tc = _cfgs(num_experts=e, moe_top_k=k)
    jp, tp = _layer(jc, tc)
    x = _x(t, 32)
    jout, jaux = jax_moe.moe_ragged(jp, jc, jnp.asarray(x))
    out, aux = moe.moe_ragged(tp, tc, torch.from_numpy(x))
    _close(out, jout, 1e-5, 1e-6)
    assert abs(float(aux) - float(jaux)) < 1e-6
    w, ids, _ = moe.route_topk(tp["router"], torch.from_numpy(x), k)
    _close(moe._experts_all(tp, torch.from_numpy(x), w, ids), jout, 1e-5,
           1e-6)
    assert moe.moe_ragged(tp, tc, torch.from_numpy(x), aux=False)[1] is None


def test_aux_loss_equals_jax_and_is_one_when_balanced():
    jc, tc = _cfgs()
    t, e, k = 512, tc.num_experts, tc.moe_top_k
    ids = np.arange(t * k).reshape(t, k) % e
    probs = np.full((t, e), 1.0 / e, np.float32)
    aux = moe._aux_loss(tc, torch.from_numpy(ids), torch.from_numpy(probs), t)
    assert abs(float(aux) - 1.0) < 1e-5
    probs = np.random.default_rng(3).dirichlet(np.ones(e), t).astype(
        np.float32)
    ids = np.argsort(-probs, axis=1)[:, :k]
    want = jax_moe._aux_loss(jc, jnp.asarray(ids), jnp.asarray(probs), t)
    got = moe._aux_loss(tc, torch.from_numpy(ids), torch.from_numpy(probs), t)
    assert abs(float(got) - float(want)) < 1e-6


def test_bf16_expert_outputs_add_in_the_reference_order():
    """The k weighted rows of each token, in sorted order, summed one add
    at a time in bf16: bit-equal to the reference's scatter-add, where one
    f32 sum rounded once (``index_add_`` on the CPU) is not."""
    jc, tc = _cfgs(num_experts=16, moe_top_k=4)
    jp, tp = _layer(jc, tc)
    x = _x(96, 32)
    tok, _, _, _, _ = moe._dispatch(tc, tp["router"], torch.from_numpy(x))
    rows = (3 * np.random.default_rng(5).standard_normal((96 * 4, 32))
            ).astype(np.float32)
    jrows = jnp.asarray(rows, jnp.bfloat16)
    want = jnp.zeros((96, 32), jnp.bfloat16).at[jnp.asarray(tok.numpy())].add(
        jrows)
    trows = torch.from_numpy(np.array(jrows.astype(jnp.float32))).bfloat16()
    got = moe._add_in_order(tok, trows, 96)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    once = torch.zeros((96, 32)).index_add_(0, tok, trows.float()).bfloat16()
    assert not torch.equal(once, got)


def test_moe_ragged_in_bf16_near_jax():
    """bf16 experts: the sorted form against the reference at the JAX
    kernel tests' bf16 bar (atol 2e-2, rtol 1e-2) and the same ids."""
    jc, tc = _cfgs(num_experts=16, moe_top_k=4)
    jp, tp = _layer(jc, tc, adt="bfloat16")
    x = _x(96, 32)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).bfloat16()
    jout, _ = jax_moe.moe_ragged(jp, jc, jx)
    out, _ = moe.moe_ragged(tp, tc, tx)
    assert out.dtype == torch.bfloat16
    _close(out.float(), jout.astype(jnp.float32), 2e-2, 1e-2)


@pytest.mark.parametrize("t,e,k", TEK)
def test_capacity_local_equals_jax_without_drops(t, e, k):
    """tests/test_moe.py's relation on the port (capacity equals the
    dropless path when nothing drops), and the port equal to the JAX
    capacity path."""
    jc, tc = _cfgs(num_experts=e, moe_top_k=k, moe_capacity_factor=float(e))
    jp, tp = _layer(jc, tc)
    x = torch.from_numpy(_x(t, 32))
    o1, a1 = moe.moe_ragged(tp, tc, x)
    o2, a2 = moe.moe_capacity_local(tp, tc, x)
    _close(o2, o1, 1e-5, 1e-6)
    assert abs(float(a1) - float(a2)) < 1e-6
    jout, jaux = jax_moe.moe_capacity_local(jp, jc, jnp.asarray(x.numpy()))
    _close(o2, jout, 1e-5, 1e-6)
    assert abs(float(a2) - float(jaux)) < 1e-6


def test_capacity_local_drops_as_jax():
    """Capacity factor 1: some groups overflow their window, and the port
    drops the same (token, expert) pairs: equal outputs, the dropped
    tokens' rows short of the dropless path's, finite, bounded."""
    jc, tc = _cfgs(moe_capacity_factor=1.0)
    jp, tp = _layer(jc, tc)
    x = _x(64, 32)
    jout, _ = jax_moe.moe_capacity_local(jp, jc, jnp.asarray(x))
    out, _ = moe.moe_capacity_local(tp, tc, torch.from_numpy(x))
    _close(out, jout, 1e-5, 1e-6)
    sizes = moe._dispatch(tc, tp["router"], torch.from_numpy(x))[3]
    assert int(sizes.max()) > 16      # the capacity: something drops
    full, _ = moe.moe_ragged(tp, tc, torch.from_numpy(x))
    short = (out - full).abs().amax(dim=1) > 1e-4
    jshort = np.abs(np.asarray(jout) - np.asarray(
        jax_moe.moe_ragged(jp, jc, jnp.asarray(x))[0])).max(axis=1) > 1e-4
    np.testing.assert_array_equal(short.numpy(), jshort)
    assert short.any() and torch.isfinite(out).all()
    assert float(out.abs().max()) <= float(full.abs().max()) * 3


def test_apply_moe_with_a_shared_expert_equals_jax():
    jc, tc = _cfgs(num_shared_experts=1)
    jp, tp = _layer(jc, tc)
    assert sorted(tp["shared"]) == ["w_down", "w_gate", "w_up"]
    x = np.random.default_rng(1).standard_normal((2, 16, 32)).astype(
        np.float32)
    jout, jaux = jax_moe.apply_moe(jp, jc, jnp.asarray(x), return_aux=True)
    out, aux = moe.apply_moe(tp, tc, torch.from_numpy(x), return_aux=True)
    assert out.shape == (2, 16, 32)
    _close(out, jout, 1e-5, 1e-6)
    assert abs(float(aux) - float(jaux)) < 1e-6
    _close(moe.apply_moe(tp, tc, torch.from_numpy(x)), jout, 1e-5, 1e-6)


# ------------------------------------------------------------ the model

def _model_cfgs(activ_dtype, **kw):
    kw = {"num_layers": 2, "activ_dtype": activ_dtype, **kw}
    return (jax_get_config(GRANITE).reduced(**kw),
            get_config(GRANITE).reduced(**kw))


def _model_params(jc, tc, seed=0):
    """JAX parameters with random (not zero) norms, and the same values in
    the port's form on the CPU."""
    jp = jax_init_params(jc, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        if "norm" in jax.tree_util.keystr(path):
            return a + jnp.asarray(0.1 * rng.standard_normal(a.shape),
                                   a.dtype)
        return a
    jp = jax.tree_util.tree_map_with_path(perturb, jp)
    return jp, params_from_jax(tc, jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")


def test_granite_config_is_the_published_one_and_is_accepted():
    """(Field-for-field equality with the JAX config is
    tests/test_torch_llm.py's.)"""
    tc = get_config(GRANITE)
    assert (tc.num_layers, tc.d_model, tc.num_heads, tc.num_kv_heads,
            tc.head_dim, tc.num_experts, tc.moe_top_k, tc.moe_d_ff,
            tc.num_shared_experts, tc.vocab_size) == (
        24, 1024, 16, 8, 64, 32, 8, 512, 0, 49_155)
    check_config(tc)
    check_config(tc.reduced())
    # experts outside the moe family stay refused
    with pytest.raises(ValueError, match="experts"):
        check_config(dataclasses.replace(get_config("llama3-8b"),
                                         num_experts=4, moe_top_k=2))


@pytest.mark.parametrize("kw", [{}, {"num_experts": 8, "moe_top_k": 4}],
                         ids=["e4k2", "e8k4"])
@pytest.mark.parametrize("activ_dtype", ["float32", "bfloat16"])
def test_granite_model_matches_jax(activ_dtype, kw):
    """forward, prefill and 6 decode steps of the reduced granite (two
    layers); greedy tokens equal in f32.  In bf16 the reference runs op by
    op (``jax.disable_jit``), the evaluation the port follows: compiled, XLA
    fuses the bf16 element-wise chains and rounds them once, and its logits
    move by up to 0.0625 from its own op-by-op ones (one element past the
    bar of the port against them, at 8 experts, top-4)."""
    jc, tc = _model_cfgs(activ_dtype, **kw)
    eager = (jax.disable_jit() if activ_dtype == "bfloat16"
             else contextlib.nullcontext())
    jp, tp = _model_params(jc, tc)
    atol, rtol = ((1e-4, 1e-4) if activ_dtype == "float32"
                  else (6.25e-2, 3e-2))
    toks = np.random.default_rng(1).integers(0, jc.vocab_size, (2, 11))
    jt = jnp.asarray(toks, jnp.int32)

    def close(got, want):
        _close(got.float().numpy(), want, atol, rtol)

    with eager:
        close(forward(tp, tc, torch.from_numpy(toks)),
              jax_forward(jp, jc, jt))
        jlog, jcache = jax_prefill(jp, jc, jt, max_seq=24)
        tlog, tcache = prefill(tp, tc, torch.from_numpy(toks), max_seq=24)
        close(tlog, jlog)
        for _ in range(6):
            nxt = jnp.argmax(jlog, axis=-1).astype(jnp.int32)
            if activ_dtype == "float32":
                np.testing.assert_array_equal(tlog.argmax(-1).numpy(),
                                              np.asarray(nxt))
            jlog, jcache = jax_decode_step(jp, jc, nxt, jcache)
            tlog, tcache = decode_step(tp, tc, torch.from_numpy(
                np.array(nxt)).long(), tcache)
            close(tlog, jlog)
    assert tcache["pos"] == int(jcache["pos"]) == 17


def test_granite_params_keep_the_router_in_f32():
    jc, tc = _model_cfgs("bfloat16")
    _, tp = _model_params(jc, tc)
    layer = tp["blocks"]["s0"][1]
    assert sorted(layer) == ["attn", "moe", "norm1", "norm2"]
    assert {n: (tuple(t.shape), t.dtype) for n, t in layer["moe"].items()} \
        == {"router": ((128, 4), torch.float32),
            "w_gate": ((4, 128, 64), torch.bfloat16),
            "w_up": ((4, 128, 64), torch.bfloat16),
            "w_down": ((4, 64, 128), torch.bfloat16)}
    own = init_params(tc, seed=0, device="cpu")
    for mine, theirs in zip(own["blocks"]["s0"], tp["blocks"]["s0"]):
        assert jax.tree_util.tree_map(lambda t: (t.shape, t.dtype), mine) \
            == jax.tree_util.tree_map(lambda t: (t.shape, t.dtype), theirs)
    # a shared expert's MLP comes across as a nested tree
    jc, tc = _model_cfgs("float32", num_shared_experts=1)
    jp, tp = _model_params(jc, tc)
    shared = tp["blocks"]["s0"][0]["moe"]["shared"]
    np.testing.assert_array_equal(
        shared["w_up"].numpy(),
        np.asarray(jp["blocks"]["s0"]["moe"]["shared"]["w_up"][0]))
    toks = np.random.default_rng(1).integers(0, jc.vocab_size, (2, 7))
    _close(forward(tp, tc, torch.from_numpy(toks)),
           jax_forward(jp, jc, jnp.asarray(toks, jnp.int32)), 1e-4, 1e-4)


@pytest.mark.parametrize("prompt_len", [5, 17])
def test_granite_serve_batch_tokens_equal_jax(prompt_len):
    jc, tc = _model_cfgs("float32")
    jb = JaxBackend(GRANITE, jc, max_batch=4, max_seq=32)
    tb = Backend(GRANITE, tc, params=params_from_jax(
        tc, jax.tree_util.tree_map(np.asarray, jb.params), device="cpu"),
        max_batch=4, max_seq=32, device="cpu")
    rng = np.random.default_rng(prompt_len)
    reqs = [(i, rng.integers(0, 1000, prompt_len)) for i in range(3)]
    want = jb.serve_batch([JaxRequest(uid=u, prompt=p, max_new_tokens=6)
                           for u, p in reqs])
    got = tb.serve_batch([Request(uid=u, prompt=p, max_new_tokens=6)
                          for u, p in reqs])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))
    assert tb.profile_row() == jb.profile_row()


# ------------------------------------------------- the default pool

#: δ -> the archs that 256- and 1024-token prompts go to: granite's 49.58
#: is within δ of bucket 0's capped 72.0 from δ = 22.42 on
POOL_ROUTES = {10.0: ("qwen2.5-3b", "recurrentgemma-2b"),
               18.5: ("mamba2-370m", "qwen2.5-3b"),
               23.0: (GRANITE, "mamba2-370m")}


@pytest.mark.parametrize("delta", sorted(POOL_ROUTES))
def test_default_pool_table_and_routes_equal_jax(delta):
    assert DEFAULT_POOL == JAX_DEFAULT_POOL
    jpool = JaxServingPool(jax_pool_table(DEFAULT_POOL), delta=delta)
    pool = ServingPool(synthetic_pool_table(DEFAULT_POOL, device="cpu"),
                       delta=delta)
    assert [(e.model, e.device, e.group, e.map_pct, e.time_ms, e.energy_mwh)
            for e in pool.table.entries] == \
        [(e.model, e.device, e.group, e.map_pct, e.time_ms, e.energy_mwh)
         for e in jpool.table.entries]
    lens = [1, 256, 512, 513, 1024, 2049, 8193, 32769, 100000]
    jpol, pol = JaxPoolPolicy(jpool), PoolPolicy(pool)
    want = jpol.decide_batch([JaxRouteRequest(uid=i, complexity=n)
                              for i, n in enumerate(lens)])
    got = pol.decide_batch([RouteRequest(uid=i, complexity=n)
                            for i, n in enumerate(lens)])
    assert [dataclasses.asdict(d) for d in got] == \
        [dataclasses.asdict(d) for d in want]
    assert tuple(pool.route(n).arch for n in (256, 1024)) == \
        POOL_ROUTES[delta]


def test_service_over_the_default_pool_equals_jax():
    """Short and long prompts through ``EcoreService`` over the five
    reduced models at δ = 23: granite takes bucket 0, mamba2 bucket 1; the
    routes and tokens equal the JAX service's."""
    backends = {}
    for i, arch in enumerate(DEFAULT_POOL):
        kw = {} if arch == "recurrentgemma-2b" else {"num_layers": 2}
        jc, tc = (jax_get_config(arch).reduced(activ_dtype="float32", **kw),
                  get_config(arch).reduced(activ_dtype="float32", **kw))
        jb = JaxBackend(arch, jc, seed=i, max_batch=2, max_seq=40)
        backends[arch] = (jb, Backend(arch, tc, params=params_from_jax(
            tc, jax.tree_util.tree_map(np.asarray, jb.params),
            device="cpu"), max_batch=2, max_seq=40, device="cpu"))
    rng = np.random.default_rng(9)
    work = [(i, n, rng.integers(0, 1000, 7 + i % 2))
            for i, n in enumerate([100, 900, 200, 1500, 300, 700])]

    def run(service_type, policy, req_type, which):
        with service_type(policy, lambda d: backends[d.backend][which]) as s:
            futs = s.submit_batch([req_type(
                uid=i, payload=p, complexity=n, max_new_tokens=4)
                for i, n, p in work])
            s.drain()
            return {f.result().request.uid: (f.result().decision.pair,
                                             np.asarray(f.result()
                                                        .result.tokens))
                    for f in futs}

    want = run(JaxEcoreService, JaxPoolPolicy(JaxServingPool(
        jax_pool_table(DEFAULT_POOL), delta=23.0)), JaxRouteRequest, 0)
    got = run(EcoreService, PoolPolicy(ServingPool(synthetic_pool_table(
        DEFAULT_POOL, device="cpu"), delta=23.0)), RouteRequest, 1)
    assert {pair[0] for pair, _ in got.values()} == {GRANITE, "mamba2-370m"}
    assert sorted(got) == sorted(want)
    for uid in got:
        assert got[uid][0] == want[uid][0]
        np.testing.assert_array_equal(got[uid][1], want[uid][1])


# ------------------------------------------------- on a GPU (cuda marker)

@pytest.mark.cuda
@pytest.mark.parametrize("t", [8, 2048])
def test_bf16_layer_on_cuda_near_f32(t):
    """One granite MoE layer at full width on the card: bf16 against the
    same weights widened to f32, on one bf16 input: the same experts, the
    largest per-token relative error (L2) within 2^-6; and the f32 layer
    on the card equal to the CPU's within 1e-5 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(GRANITE)
    gen = torch.Generator(device="cuda").manual_seed(0)
    p16 = moe.init_moe(gen, cfg, torch.bfloat16, "cuda")
    p32 = {n: w.float() for n, w in p16.items()}
    x16 = torch.from_numpy(_x(t, cfg.d_model)).cuda().bfloat16()
    x32 = x16.float()
    w16, ids16, _ = moe.route_topk(p16["router"], x16, cfg.moe_top_k)
    _, ids32, _ = moe.route_topk(p32["router"], x32, cfg.moe_top_k)
    assert torch.equal(ids16, ids32)
    y16, _ = moe.moe_ragged(p16, cfg, x16)
    y32, _ = moe.moe_ragged(p32, cfg, x32)
    rel = (y16.float() - y32).norm(dim=1) / y32.norm(dim=1)
    assert float(rel.max()) <= 2 ** -6
    cpu, _ = moe.moe_ragged({n: w.cpu() for n, w in p32.items()}, cfg,
                            x32.cpu())
    assert float((y32.cpu() - cpu).norm(dim=1).div(cpu.norm(dim=1)).max()) \
        <= 1e-5
