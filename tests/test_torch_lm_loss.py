"""LM training's loss in the port against the JAX package, on the CPU:
``layers.cross_entropy``, the load rule (``keeps_f32``, ``cast_params``,
``keep_f32``), ``forward(..., return_aux=True)`` and ``loss_fn`` with its
gradients against ``jax.value_and_grad(repro.models.loss_fn)``.

Both packages run the same parameters: the JAX ``init_params`` tree of the
reduced config (norms and biases perturbed, ``tests/test_torch_llm.py``),
carried across by ``params_from_jax(..., keep_f32=True)``, so the port
differentiates f32 masters through ``cast_params`` as the reference
differentiates its f32 leaves through its casts at use.  The JAX
gradients go through ``params_from_jax`` too, into the port's layout.
Bars: f32 activations, the loss within 1e-5 relative and each gradient
leaf within 1e-4 of that leaf's largest |value|, MoE expert ids equal;
bf16 activations against the reference run op by op (``jax.disable_jit``),
the loss at the bf16 logits' bar (atol 6.25e-2, rtol 3e-2,
``ROADMAP.md``) and each gradient leaf within 6.25e-2 of its largest
|value| (that atol, on the leaf's scale, as the f32 bar is the f32
logits' 1e-4).  This file holds five of the ten archs in f32; the others
are in ``tests/test_torch_lm_grads.py``, the bf16 cases (one a family) in
``tests/test_torch_lm_bf16*.py``, split so that no file takes much over
a minute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_llm as llm
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as jax_layers
from repro.models import loss_fn as jax_loss_fn
from repro.models import moe as jax_moe
from repro_torch.configs import get_config, list_configs
from repro_torch.models import (cast_params, forward, init_params, loss_fn,
                                params_from_jax)
from repro_torch.models import layers, moe
from repro_torch.models.model import AUX_WEIGHT, keeps_f32
from repro_torch.optim.adamw import tree_leaves, tree_paths

torch.set_num_threads(1)

#: the ten assigned archs
ARCHS = tuple(list_configs())
#: the archs whose reduced config is not cut to two layers: the hybrid's
#: block and trailing pair, gemma2's local and global layer, whisper's
#: 2 + 2 layers
WHOLE = ("recurrentgemma-2b", "gemma2-9b", "whisper-small")
MOE = ("granite-moe-1b-a400m", "deepseek-v2-lite-16b")


def configs(arch, adt="float32"):
    """The reduced config of ``arch`` in both packages."""
    kw = {} if arch in WHOLE else {"num_layers": 2}
    return (jax_get_config(arch).reduced(activ_dtype=adt, **kw),
            get_config(arch).reduced(activ_dtype=adt, **kw))


def batch(cfg, b=2, s=12, seed=0):
    """Tokens and labels [b, s] (three labels of the first row -1) and the
    family's prefix embeddings, as numpy arrays."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s), np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (b, s), np.int32)}
    out["labels"][0, :3] = -1
    rows = {"vlm": cfg.num_prefix_embeds, "encdec": cfg.enc_seq}
    if cfg.family in rows:
        out["prefix_embeds"] = rng.standard_normal(
            (b, rows[cfg.family], cfg.vision_dim), np.float32)
    return out


def torch_batch(b):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in b.items()}


def jax_value_and_grad(jc, jp, b):
    """((loss, {"ce", "aux"}), grads) of the reference: jitted in f32, op
    by op in bf16."""
    fn = jax.value_and_grad(lambda p, bb: jax_loss_fn(p, jc, bb),
                            has_aux=True)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    if jc.activ_dtype == "float32":
        return jax.jit(fn)(jp, jb)
    with jax.disable_jit():
        return fn(jp, jb)


def port_value_and_grad(tc, tp, b):
    """((loss, {"ce", "aux"}), grads as a list in ``tree_leaves`` order)
    of the port on f32 masters ``tp``."""
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = loss_fn(tp, tc, torch_batch(b))
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    return (loss.detach(), {k: m.detach() for k, m in metrics.items()}), \
        grads


def check_loss_and_grads(arch, adt="float32"):
    """The port's loss, aux and gradients against the reference's at the
    module docstring's bars; returns the reference's aux."""
    jc, tc = configs(arch, adt)
    jp, _ = llm._params(jc, tc)
    tp = params_from_jax(tc, jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu", keep_f32=True)
    b = batch(tc)
    (jl, jm), jg = jax_value_and_grad(jc, jp, b)
    (tl, tm), tg = port_value_and_grad(tc, tp, b)
    want = tree_leaves(params_from_jax(
        tc, jax.tree_util.tree_map(np.asarray, jg), device="cpu",
        keep_f32=True))
    f32 = adt == "float32"
    atol, rtol = (0.0, 1e-5) if f32 else llm._tol(adt)
    for got, ref in ((tl, jl), (tm["ce"], jm["ce"]), (tm["aux"], jm["aux"])):
        np.testing.assert_allclose(float(got), float(ref), atol=atol,
                                   rtol=rtol)
    bar = 1e-4 if f32 else 6.25e-2
    assert len(tg) == len(want)
    for path, got, ref in zip(tree_paths(tp), tg, want):
        assert got.dtype == torch.float32 and got.shape == ref.shape, path
        np.testing.assert_allclose(
            got.numpy(), ref.numpy(), rtol=0,
            atol=bar * float(ref.abs().max()) + 1e-30, err_msg=path)
    return float(jm["aux"])


def record_expert_ids(monkeypatch):
    """Lists that receive every ``route_topk``'s expert ids, the
    reference's (``jax.debug.callback``) and the port's."""
    jids, tids = [], []
    jax_route, route = jax_moe.route_topk, moe.route_topk

    def jax_recorded(*a):
        out = jax_route(*a)
        jax.debug.callback(lambda ids: jids.append(np.asarray(ids)), out[1],
                           ordered=True)
        return out

    def recorded(*a):
        out = route(*a)
        tids.append(out[1].detach().numpy())
        return out

    monkeypatch.setattr(jax_moe, "route_topk", jax_recorded)
    monkeypatch.setattr(moe, "route_topk", recorded)
    return jids, tids


def check_arch(arch, monkeypatch):
    """f32 loss and gradients of ``arch``; a MoE arch's expert ids equal,
    in order, and its aux loss non-zero."""
    jids, tids = record_expert_ids(monkeypatch)
    aux = check_loss_and_grads(arch)
    if arch in MOE:
        assert aux > 0 and len(tids) == len(jids) == 2
        for got, want in zip(tids, jids):
            np.testing.assert_array_equal(got, want)
    else:
        assert aux == 0 and not tids


# ------------------------------------------------------------- the loss

@pytest.mark.parametrize("ignored", [0, 5, 24])
def test_cross_entropy_equals_jax(ignored):
    """Mean CE over the labels that are not -1 (all of them ignored: the
    sum over max(count, 1)), against the reference's f32 logsumexp."""
    rng = np.random.default_rng(ignored)
    logits = (4 * rng.standard_normal((2, 12, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (2, 12)).astype(np.int32)
    labels.reshape(-1)[rng.permutation(24)[:ignored]] = -1
    want = float(jax_layers.cross_entropy(jnp.asarray(logits),
                                          jnp.asarray(labels)))
    got = layers.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(labels).long())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=0)
    if ignored == 24:
        assert float(got) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_load_rule_of_the_masters_equals_the_serving_tree(arch):
    """``cast_params`` of the f32 masters is the tree the serving path
    loads, in dtype and value: from ``init_params`` (bf16 activations)
    and from ``params_from_jax``."""
    _, tc = configs(arch, "bfloat16")
    masters = init_params(tc, seed=3, device="cpu", keep_f32=True)
    assert all(x.dtype == torch.float32 for x in tree_leaves(masters))
    served = init_params(tc, seed=3, device="cpu")
    cast = cast_params(tc, masters)
    assert tree_paths(cast) == tree_paths(served)
    for path, got, want in zip(tree_paths(cast), tree_leaves(cast),
                               tree_leaves(served)):
        assert got.dtype == want.dtype, path
        assert torch.equal(got, want), path
    jc, _ = configs(arch, "bfloat16")
    jp = jax.tree_util.tree_map(np.asarray, llm._params(jc, tc)[0])
    loaded = params_from_jax(tc, jp, device="cpu")
    cast = cast_params(tc, params_from_jax(tc, jp, device="cpu",
                                           keep_f32=True))
    for got, want in zip(tree_leaves(cast), tree_leaves(loaded)):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_load_rule_keeps_norms_and_gates_f32():
    assert keeps_f32(("final_norm",)) and keeps_f32(("enc_norm",))
    assert keeps_f32(("blocks", "s0", "norm_x"))
    assert keeps_f32(("blocks", "s0", "ssm", "A_log"))
    assert keeps_f32(("blocks", "s0", "rec", "lru_wa"))
    assert keeps_f32(("blocks", "s0", "moe", "router"))
    assert not keeps_f32(("blocks", "s0", "moe", "shared", "w_up"))
    assert not keeps_f32(("blocks", "s0", "attn", "bq"))
    assert not keeps_f32(("embed", "table"))


def test_cast_params_passes_gradients_to_the_masters():
    _, tc = configs("qwen2.5-3b", "bfloat16")
    masters = init_params(tc, seed=0, device="cpu", keep_f32=True)
    w = masters["blocks"]["s0"][0]["attn"]["wq"].requires_grad_(True)
    cast = cast_params(tc, masters)
    assert cast["blocks"]["s0"][0]["attn"]["wq"].dtype == torch.bfloat16
    (g,) = torch.autograd.grad(cast["blocks"]["s0"][0]["attn"]["wq"].float()
                               .sum(), [w])
    assert g.dtype == torch.float32 and torch.equal(g, torch.ones_like(g))


def test_forward_returns_the_summed_aux_loss():
    """``return_aux``: the logits are ``forward``'s, and the aux loss is
    the sum of each MoE layer's ``moe_ragged`` loss; zero, f32, without
    experts."""
    for arch in ("granite-moe-1b-a400m", "qwen2.5-3b"):
        _, tc = configs(arch)
        params = init_params(tc, seed=1, device="cpu")
        tokens = torch.from_numpy(batch(tc)["tokens"]).long()
        logits, aux = forward(params, tc, tokens, return_aux=True)
        torch.testing.assert_close(logits, forward(params, tc, tokens),
                                   rtol=0, atol=0)
        assert aux.dtype == torch.float32 and aux.shape == ()
        assert (float(aux) > 0) == (arch == "granite-moe-1b-a400m")


def test_loss_adds_the_weighted_aux_loss():
    _, tc = configs("granite-moe-1b-a400m")
    params = init_params(tc, seed=2, device="cpu", keep_f32=True)
    loss, m = loss_fn(params, tc, torch_batch(batch(tc)))
    assert AUX_WEIGHT == 0.01
    assert float(loss) == float(m["ce"] + AUX_WEIGHT * m["aux"])


def test_vlm_labels_are_padded_over_the_prefix():
    """A vlm batch's logits cover the prefix rows too; the loss pads the
    labels with -1 there, so the CE is the text's alone."""
    _, tc = configs("llava-next-34b")
    params = init_params(tc, seed=4, device="cpu", keep_f32=True)
    b = torch_batch(batch(tc))
    _, m = loss_fn(params, tc, b)
    logits = forward(cast_params(tc, params), tc, b["tokens"],
                     b["prefix_embeds"])
    p = tc.num_prefix_embeds
    want = layers.cross_entropy(logits[:, p:], b["labels"])
    assert logits.shape[1] == p + b["labels"].shape[1]
    torch.testing.assert_close(m["ce"], want, rtol=1e-6, atol=0)


# ------------------------------------------------ loss and gradients, f32

@pytest.mark.parametrize("arch", ARCHS[:5])
def test_loss_and_gradients_equal_jax(arch, monkeypatch):
    check_arch(arch, monkeypatch)
