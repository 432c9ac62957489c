"""Model assembly of the dense, moe, vlm, ssm, hybrid and encdec families:
init / forward / prefill / decode.

A dense model is embed -> N x [pre-norm attention][pre-norm SwiGLU or
GeGLU MLP] -> final norm -> tied unembedding, its attention layers global
(``"attn"``), sliding-window (``"local"``) or alternating (gemma2: local,
global), optionally with gemma-scaled embeddings, post-norms after the
mixer and the MLP (``norm1b``, ``norm2b``) and logit softcaps; a moe
model (Granite MoE) the same with top-k routed SwiGLU experts in place of
the MLP (``models/moe.py``), its attention GQA or MLA (deepseek-v2:
``mla`` in place of ``attn``, a latent cache); a vlm model (LLaVA-NeXT)
is a dense model whose input is the projected prefix embeddings
(``vision_proj``) placed before the text's, positions running over both;
an ssm model (Mamba-2) is embed -> N x
[pre-norm Mamba-2 block] -> final norm -> tied unembedding, with no MLP;
a hybrid model (RecurrentGemma) is gemma-scaled embed -> 8 x [rec, rec,
local] + [rec, rec] sub-layers, each [pre-norm mixer][pre-norm GeGLU MLP]
(the mixer an RG-LRU block or sliding-window attention) -> final norm ->
tied unembedding; an encdec model (Whisper) encodes frame embeddings
(``frame_proj``, sinusoidal positions, N x [pre-norm unmasked attention]
[pre-norm GELU MLP], ``enc_norm``) and decodes text with embed +
sinusoidal positions -> N x [pre-norm causal attention][pre-norm
cross-attention over the encoder's output][pre-norm GELU MLP] -> final
norm -> tied unembedding, no RoPE.  Where the JAX package scans over
layer parameters stacked on a leading n_blocks dim per block slot, the
port loops over a list: ``params["blocks"]["s0"]`` holds one dict per
layer in layer order (``cfg.layer_kinds``) with the JAX names (``norm1``,
``attn.{wq,wk,wv,wo[,bq,bk,bv]}``, ``mla.{wq,w_dkv,w_kr,w_uk,w_uv,wo}`` or
``rec.{w_gate,w_x,conv_w,conv_b,
lru_wa,lru_ba,lru_wx,lru_bx,log_lambda,w_out}``, [``norm1b``,] ``norm2``,
``mlp.{w_gate,w_up,w_down}`` or ``moe.{router,w_gate,w_up,w_down[,
shared]}``[, ``norm2b``]; or ``norm1``, ``ssm.{in_proj,conv_w,conv_b,
dt_bias,A_log,D,norm_w,out_proj}``); an encdec model's
``params["enc_blocks"]`` and ``params["dec_blocks"]`` hold its encoder
and decoder layers (``norm1``, ``attn``, [``norm_x``, ``xattn``,]
``norm2``, ``mlp.{w_up,w_down}``) beside ``enc_norm`` and ``frame_proj``;
``params_from_jax`` unstacks a JAX parameter tree into that form, the
hybrid's block slots interleaved.
Matrices, biases and the convs are kept in the activation dtype (cast once
at load); norm weights, the Mamba-2 per-head scalars, the RG-LRU gate
parameters and the MoE router stay in f32 (``keeps_f32``, the load rule).
Training keeps every leaf in f32 (``keep_f32=True``: the JAX package's
``cfg.pdtype`` masters) and applies the load rule once a step
(``cast_params``), differentiably, so the layers run as they serve and
gradients reach the masters through the casts.  ``loss_fn`` is the
reference's: next-token cross-entropy plus ``AUX_WEIGHT`` times the MoE
load-balance loss that ``forward(..., return_aux=True)`` sums over layers.
With ``cfg.remat`` (the published configs; ``reduced()`` turns it off)
a recorded training forward rematerialises as the reference's
``jax.checkpoint`` does: each scanned block (``_regions``) keeps only its
input and runs again in the backward, casting its layers itself, and the
loss head runs in checkpointed chunks of ``LOSS_CHUNK_ROWS`` rows; the
encdec family's blocks, ``prefill``, ``decode_step`` and anything under
``no_grad`` are not checkpointed.

On a mesh (the sharding context that ``launch/steps.py`` enters; the
dense family, ``check_mesh``) the tree is a rank's shards by the
reference's rules (``sharding/specs.py``; ``shard_params``,
``init_shards``): each leaf FSDP splits over 'data' is gathered at use
(``_use_leaf``; under remat inside its block's or head chunk's
checkpoint, so the recompute gathers again) and its gradient
reduce-scattered back into the shard; attention and the MLP are
tensor-parallel over 'model' (``attention.py``; the MLP's input and
output through ``comm``), the embedding and the head
vocabulary-parallel (``layers.embed``, ``layers.nll_sum``); a rank's
loss is its rows' part of the batch's.

The variants with experts outside the moe family, positions without RoPE
or a GELU MLP outside the encdec family, or other layouts raise
``ValueError``.  A config with a global ``"attn"`` layer (an encdec
model's decoder too) raises past ``max_seq`` (its cache holds positions
in order); a ``"local"`` layer's ring takes any length, as in the JAX
package (``kvcache.py``).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.device import resolve_device
from repro_torch.sharding import comm, ctx
from repro_torch.sharding import specs as sp

from .attention import (attention_decode, attention_forward,
                        cross_attention_decode, cross_attention_forward,
                        encode_cross_kv, init_attention, init_mla,
                        mla_decode_v2, mla_forward)
from .base import ModelConfig
from .kvcache import AttnCache, bounded_by_max_seq, init_cache, ring_rows
from .layers import (apply_mlp, dense_init, embed, init_embedding,
                     init_mlp, nll_sum, position_embedding, rms_norm,
                     sinusoidal_positions, unembed)
from .moe import apply_moe, init_moe
from .rglru import init_rec, rec_decode_step, rec_forward
from .ssm import init_ssm, ssm_decode_step, ssm_forward

class _Family(NamedTuple):
    """What the port runs of a family."""
    layouts: tuple      # (block layout, trailing layout) pairs
    mlps: tuple
    scaled: bool        # gemma-scaled embeddings
    post_norm: bool


_PORTED = {
    "dense": _Family(((("attn",), ()), (("local", "attn"), ()),
                      (("local",), ())), ("swiglu", "geglu"), True, True),
    "moe": _Family(((("attn",), ()),), ("swiglu",), False, False),
    "vlm": _Family(((("attn",), ()),), ("swiglu",), False, False),
    "ssm": _Family(((("ssm",), ()),), ("swiglu",), False, False),
    "hybrid": _Family(((("rec", "rec", "local"), ("rec", "rec")),),
                      ("geglu",), True, False),
    "encdec": _Family(((("attn",), ()),), ("gelu",), False, False)}
#: the Mamba-2 parameters kept in f32 (the rest take the activation dtype)
_SSM_F32 = ("dt_bias", "A_log", "D", "norm_w")
#: the RG-LRU parameters kept in f32: the gates read them in f32
_REC_F32 = ("lru_wa", "lru_wx", "lru_ba", "lru_bx", "log_lambda")
#: the parameters kept in f32, by sub-tree (the MoE router reads x in f32)
_F32 = {"ssm": _SSM_F32, "rec": _REC_F32, "moe": ("router",)}
#: the weight of the MoE load-balance loss in ``loss_fn``
AUX_WEIGHT = 0.01
#: rows of each checkpointed chunk of ``loss_fn``'s head under
#: ``cfg.remat``: a chunk's f32 logits are 0.29 GiB at qwen2.5-3b's
#: vocabulary (recurrentgemma-2b's 0.49), and from 512 rows down the head
#: no longer sets a train_4k step's peak (``dryrun.train_step_bytes``:
#: equal at 256, 1.2-1.5 GiB more at 1024; ``PERF.md``)
LOSS_CHUNK_ROWS = 512


def keeps_f32(path) -> bool:
    """The load rule, for the leaf at ``path`` (its keys from the root):
    norm weights (``norm*``, ``*_norm``) and the ``_F32`` leaves of a
    Mamba-2, RG-LRU or MoE sub-tree stay f32; every other leaf takes the
    activation dtype."""
    name = path[-1]
    if name.startswith("norm") or name.endswith("_norm"):
        return True
    return len(path) > 1 and name in _F32.get(path[-2], ())


def _map_tree(tree, fn, path=()):
    """``tree`` (nested dicts and lists) with each leaf x replaced by
    ``fn(path, x)``."""
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(v, fn, path) for v in tree]
    return fn(path, tree)


def cast_params(cfg: ModelConfig, params):
    """``params`` under the load rule (``keeps_f32``): a tree of f32
    masters (``keep_f32=True``) as the layers read it, matrices in the
    activation dtype.  ``Tensor.to`` is differentiable, so gradients flow
    back to the masters; a leaf already in its dtype is returned as it
    is."""
    return _map_tree(params, lambda path, x: x if keeps_f32(path)
                     else x.to(cfg.adtype))


def check_config(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` naming what of ``cfg`` the port does not run."""
    fam = _PORTED.get(cfg.family, _Family((), (), False, False))
    unported = [what for what, bad in (
        (f"family {cfg.family!r}", cfg.family not in _PORTED),
        (f"layout {cfg.block_layout}+{cfg.trailing_layout}",
         (cfg.block_layout, cfg.trailing_layout) not in fam.layouts),
        (f"mlp {cfg.mlp_variant!r}", cfg.mlp_variant not in fam.mlps),
        ("experts", bool(cfg.num_experts) and cfg.family != "moe"),
        ("post-norms", cfg.post_norm and not fam.post_norm),
        ("scaled embeddings", cfg.embed_scale and not fam.scaled),
        ("positions without RoPE", not cfg.use_rope
         and cfg.family != "encdec"),
        ("RoPE or q/k/v biases in the encdec family",
         cfg.family == "encdec" and (cfg.use_rope or cfg.qkv_bias))) if bad]
    if unported:
        raise ValueError(f"{cfg.name}: not ported yet: {', '.join(unported)}")


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda", *,
                keep_f32: bool = False) -> Dict[str, Any]:
    """Seeded random parameters, drawn on ``device`` from one generator;
    with ``keep_f32`` every leaf stays f32 (``cast_params`` of that tree is
    the tree drawn without it).  On the ``meta`` device the tree has every
    leaf's shape and dtype and holds no data: no generator draws there."""
    check_config(cfg)
    dev = resolve_device(device)
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))
    adt = torch.float32 if keep_f32 else cfg.adtype
    d = cfg.d_model

    def norm():
        return torch.zeros(d, dtype=torch.float32, device=dev)

    def layer(kind):
        if kind == "ssm":
            return {"norm1": norm(), "ssm": init_ssm(gen, cfg, adt, dev)}
        mixer = ({"rec": init_rec(gen, cfg, adt, dev)} if kind == "rec" else
                 {"mla": init_mla(gen, cfg, adt, dev)} if _is_mla(cfg, kind)
                 else {"attn": init_attention(gen, cfg, adt, dev)})
        mlp = ({"moe": init_moe(gen, cfg, adt, dev)} if cfg.num_experts else
               {"mlp": init_mlp(gen, d, cfg.d_ff, cfg.mlp_variant, adt, dev)})
        post = {"norm1b": norm(), "norm2b": norm()} if cfg.post_norm else {}
        return {"norm1": norm(), **mixer, "norm2": norm(), **mlp, **post}

    params = {"embed": init_embedding(gen, cfg.vocab_size, d, adt, dev),
              "final_norm": norm()}
    if cfg.family == "encdec":
        def coder_layer(cross):
            xattn = ({"norm_x": norm(),
                      "xattn": init_attention(gen, cfg, adt, dev)}
                     if cross else {})
            return {"norm1": norm(),
                    "attn": init_attention(gen, cfg, adt, dev), **xattn,
                    "norm2": norm(),
                    "mlp": init_mlp(gen, d, cfg.d_ff, cfg.mlp_variant, adt,
                                    dev)}

        params["enc_blocks"] = [coder_layer(False)
                                for _ in range(cfg.enc_layers)]
        params["dec_blocks"] = [coder_layer(True)
                                for _ in range(cfg.dec_layers)]
        params["enc_norm"] = norm()
        params["frame_proj"] = dense_init(gen, (cfg.vision_dim, d), adt,
                                          device=dev)
        return params
    if _has_prefix(cfg):
        params["vision_proj"] = dense_init(gen, (cfg.vision_dim, d), adt,
                                           device=dev)
    params["blocks"] = {"s0": [layer(kind) for kind in cfg.layer_kinds]}
    return params


def params_from_jax(cfg: ModelConfig, tree, device="cuda", *,
                    keep_f32: bool = False) -> Dict[str, Any]:
    """The JAX package's parameter tree (``repro.models.init_params``, as
    numpy arrays or anything ``np.asarray`` reads) in the port's form: for
    layer order, block i's slots s0, s1, ... in turn, then the trailing
    slots; its leaves in f32, cast by ``cast_params`` unless
    ``keep_f32``."""
    check_config(cfg)
    dev = resolve_device(device)

    def f32(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    def unstack(sub, i):
        return {n: unstack(a, i) if isinstance(a, dict) else f32(a[i])
                for n, a in sub.items()}

    params = {"embed": {"table": f32(tree["embed"]["table"])},
              "final_norm": f32(tree["final_norm"])}
    if cfg.family == "encdec":
        for name, n in (("enc_blocks", cfg.enc_layers),
                        ("dec_blocks", cfg.dec_layers)):
            params[name] = [unstack(tree[name], i) for i in range(n)]
        params["enc_norm"] = f32(tree["enc_norm"])
        params["frame_proj"] = f32(tree["frame_proj"])
    else:
        slots = [(tree["blocks"][f"s{j}"], i) for i in range(cfg.n_blocks)
                 for j in range(len(cfg.block_layout))]
        slots += [(tree["trailing"][f"s{j}"], 0)
                  for j in range(len(cfg.trailing_layout))]
        if _has_prefix(cfg):
            params["vision_proj"] = f32(tree["vision_proj"])
        params["blocks"] = {"s0": [unstack(slot, i) for slot, i in slots]}
    return params if keep_f32 else cast_params(cfg, params)


# ------------------------------------------------------------------ the mesh


def check_mesh(cfg: ModelConfig, mesh) -> None:
    """Raise ``ValueError`` naming what of ``cfg`` the sharded path does
    not run on ``mesh``: it shards the dense family, with heads, MLP width
    and vocabulary split evenly over 'model' and KV heads that divide it
    or that it divides (each rank then computes the KV heads its query
    heads read)."""
    m = sp.axis_sizes(mesh).get("model", 1)
    kv = cfg.num_kv_heads
    bad = [what for what, b in (
        (f"family {cfg.family!r} (the dense family is sharded)",
         cfg.family != "dense"),
        (f"{cfg.num_heads} heads", cfg.num_heads % m),
        (f"{kv} KV heads", kv % m and m % kv),
        (f"d_ff {cfg.d_ff}", cfg.d_ff % m),
        (f"vocabulary {cfg.vocab_size}", cfg.vocab_size % m)) if b]
    if bad:
        raise ValueError(f"{cfg.name} on a {m}-way model axis: not ported "
                         f"yet: {', '.join(bad)}")


@functools.lru_cache(maxsize=None)
def _spec_tree(cfg: ModelConfig, mode: str, sizes: tuple):
    return sp.param_specs(init_params(cfg, device="meta"), mode=mode,
                          mesh=dict(sizes))


def mesh_specs(cfg: ModelConfig, mesh, mode: str):
    """``sharding.specs.param_specs`` of ``cfg``'s tree on ``mesh`` in
    ``mode`` ("train" or "serve"), worked out once."""
    check_mesh(cfg, mesh)
    return _spec_tree(cfg, mode, tuple(sorted(sp.axis_sizes(mesh).items())))


def leaf_specs(specs) -> list:
    """The specs of a spec tree in ``optim.adamw.tree_leaves``' order (a
    dict's keys sorted, a list in order; a spec, a tuple, is a leaf)."""
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in leaf_specs(specs[k])]
    if isinstance(specs, list):
        return [x for t in specs for x in leaf_specs(t)]
    return [specs]


def _mesh_specs(cfg: ModelConfig):
    """The current mesh's specs (``ctx``), or None outside a mesh."""
    mesh = ctx.current_mesh()
    return None if mesh is None else mesh_specs(cfg, mesh,
                                                ctx.current_mode())


def _use_leaf(x, spec):
    """A rank's shard ``x`` of spec ``spec`` as the layers use it: made
    whole over 'data' (FSDP: all-gathered, its gradient reduce-scattered
    back into the shard), its gradient summed over each batch axis the
    leaf is replicated over; the 'model' split is the layers'."""
    for a in sp.BATCH_AXES:
        if a not in spec:
            x = comm.reduce_grad(x, a)
    for dim, a in enumerate(spec):
        if a == "data":
            x = comm.all_gather(x, "data", dim)
    return x


def _at_use(p, specs, i):
    """Layer i's leaves ``p`` through ``_use_leaf`` (as they are outside a
    mesh, ``specs`` None)."""
    if specs is None:
        return p
    spec = specs["blocks"]["s0"][i]

    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(v, s[k]) for k, v in t.items()}
        return _use_leaf(t, s)
    return walk(p, spec)


def _vocab_lo(cfg: ModelConfig):
    """The first vocabulary row of this rank's table shard, or None when
    'model' has one rank."""
    m = comm.size("model")
    if m == 1:
        return None
    return sp.axis_coords(ctx.current_mesh())["model"] * (cfg.vocab_size // m)


def shard_params(cfg: ModelConfig, params, mesh, mode: str):
    """This rank's shards (views) of the full tree ``params`` on
    ``mesh``."""
    specs = mesh_specs(cfg, mesh, mode)

    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(v, s[k]) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, x) for v, x in zip(t, s)]
        return sp.local_slice(t, s, mesh)
    return walk(params, specs)


def init_shards(cfg: ModelConfig, mesh, seed: int = 0, device="cuda", *,
                keep_f32: bool = False):
    """This rank's shards of a seeded random tree on ``mesh``, drawn at
    their own sizes (the full tree is never made): norms zero, every
    other leaf normal with ``dense_init``'s fan-in scale, in the dtypes
    of ``init_params(cfg, keep_f32=keep_f32)``; training specs with
    ``keep_f32``, serving ones without.  Their values are not the full
    tree's slices (``shard_params`` of ``init_params`` gives those)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    meta = init_params(cfg, device="meta", keep_f32=keep_f32)
    specs = mesh_specs(cfg, mesh, "train" if keep_f32 else "serve")

    def walk(t, s, name=""):
        if isinstance(t, dict):
            return {k: walk(v, s[k], k) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, x, name) for v, x in zip(t, s)]
        out = torch.empty(sp.local_shape(t.shape, s, mesh), dtype=t.dtype,
                          device=dev)
        if t.dim() < 2 or name.startswith("norm"):
            return out.zero_()
        std = (cfg.d_model ** -0.5 if name == "table"
               else t.shape[0] ** -0.5)
        return out.normal_(generator=gen).mul_(std)
    return walk(meta, specs)


def _has_prefix(cfg: ModelConfig) -> bool:
    """True if ``cfg`` projects prefix embeddings (``vision_proj``)."""
    return cfg.family == "vlm" or bool(cfg.num_prefix_embeds)


def _is_mla(cfg: ModelConfig, kind: str) -> bool:
    """True if a layer of ``kind`` runs MLA: the global attention layers of
    an MLA config."""
    return kind == "attn" and cfg.use_mla


def _window(cfg: ModelConfig, kind: str):
    return cfg.sliding_window if kind == "local" else None


def _post_norm(p, cfg: ModelConfig, name, h):
    """A sub-layer's output through its post-norm (``norm1b`` after the
    mixer, ``norm2b`` after the MLP) where the config has them."""
    if not cfg.post_norm:
        return h
    return rms_norm(h, p[name], cfg.norm_eps, plus_one=True)


def _residuals(p, cfg: ModelConfig, kind, x, o, aux=None):
    """(the residual stream after a layer whose mixer gave ``o``, ``aux``
    plus its MoE load-balance loss): a Mamba-2 block adds ``o``; every
    other layer adds it (post-normed) and then its pre-norm MLP or MoE
    (post-normed).  ``aux`` None computes no load-balance loss."""
    if kind == "ssm":
        return x + o, aux
    x = x + _post_norm(p, cfg, "norm1b", o)
    h = rms_norm(x, p["norm2"], cfg.norm_eps, plus_one=True)
    if "moe" in p and aux is not None:
        h, a = apply_moe(p["moe"], cfg, h, return_aux=True)
        aux = aux + a
    elif "moe" in p:
        h = apply_moe(p["moe"], cfg, h)
    else:   # on a mesh: column-parallel in, row-parallel out over 'model'
        h = apply_mlp(p["mlp"], comm.reduce_grad(h, "model"),
                      cfg.mlp_variant)
        h = comm.all_reduce(h, "model")
    return x + _post_norm(p, cfg, "norm2b", h), aux


def _entry(c, i):
    """Layer i's cache entry: a view of the stacked K/V, or the i-th of the
    per-layer list."""
    return c[i] if isinstance(c, list) else AttnCache(c.k[i], c.v[i])


def _embed(params, cfg: ModelConfig, tokens):
    """The tokens' embeddings; on a mesh the table's shard, cast to the
    activation dtype and gathered over 'data' where FSDP splits it, looked
    up vocabulary-parallel over 'model' (``layers.embed``)."""
    specs = _mesh_specs(cfg)
    if specs is None:
        return embed(params["embed"], tokens,
                     scale_by_sqrt_dim=cfg.embed_scale, adtype=cfg.adtype)
    table, spec = params["embed"]["table"], specs["embed"]["table"]
    if "data" in spec and comm.size("data") > 1:
        table = table.to(cfg.adtype)   # gathered in the activation dtype
    return embed({"table": _use_leaf(table, spec)}, tokens,
                 scale_by_sqrt_dim=cfg.embed_scale, adtype=cfg.adtype,
                 vocab_lo=_vocab_lo(cfg))


def _logits(params, cfg: ModelConfig, x):
    """The tied unembedding's f32 logits [..., V] of x; on a mesh each
    rank's vocabulary columns, gathered over 'model'."""
    specs = _mesh_specs(cfg)
    if specs is None:
        return unembed(params["embed"], x, cap=cfg.final_softcap)
    table = _use_leaf(params["embed"]["table"].to(x.dtype),
                      specs["embed"]["table"])
    logits = unembed({"table": table}, comm.reduce_grad(x, "model"),
                     cap=cfg.final_softcap)
    return comm.all_gather(logits, "model", dim=logits.dim() - 1)


def _embed_inputs(params, cfg: ModelConfig, tokens, prefix_embeds=None):
    """The text's embeddings [B,S,d], after the prefix embeddings [B,P,
    vision_dim] cast to the activation dtype and projected by
    ``vision_proj`` in it, when given: [B,P+S,d]."""
    x = _embed(params, cfg, tokens)
    if prefix_embeds is None:
        return x
    pre = prefix_embeds.to(x.device, cfg.adtype) @ params["vision_proj"]
    return torch.cat([pre, x], dim=1)


def _layer(p, cfg: ModelConfig, kind, x, positions, aux, cache=None, i=0,
           max_seq=None):
    """Layer i of ``kind`` (parameters ``p``) over x [B,S,d]: (x, aux)
    after it (``_residuals``); with ``cache``, its K/V, latent rows or
    state land in entry i (``_prompt_layers``; ``max_seq`` sizes the
    layer's cache, which a mesh may split)."""
    s = x.shape[1]
    h = rms_norm(x, p["norm1"], cfg.norm_eps, plus_one=True)
    if _is_mla(cfg, kind):
        if cache is None:
            o = mla_forward(p["mla"], cfg, h, positions)
        else:
            o, rows = mla_forward(p["mla"], cfg, h, positions,
                                  return_cache=True)
            for full, new in zip(cache[i], rows):
                full[:, :s].copy_(new)
    elif kind in ("ssm", "rec"):
        fwd = ssm_forward if kind == "ssm" else rec_forward
        if cache is None:
            o = fwd(p[kind], cfg, h)
        else:
            o, cache[i] = fwd(p[kind], cfg, h, return_state=True)
    else:
        o = attention_forward(p["attn"], cfg, h, positions,
                              window=_window(cfg, kind),
                              cache=None if cache is None
                              else _entry(cache, i),
                              rows=_rows(cfg, kind, max_seq))
    return _residuals(p, cfg, kind, x, o, aux)


def _rows(cfg: ModelConfig, kind, max_seq):
    """The rows of a ``kind`` layer's K/V cache for ``max_seq``
    (``kvcache.py``)."""
    if max_seq is None:
        return None
    return max_seq if kind == "attn" else ring_rows(cfg, max_seq)


def _records(params) -> bool:
    """True if autograd records a function of ``params``: grad mode is on
    and a leaf of the tree requires its gradient."""
    if not torch.is_grad_enabled():
        return False
    leaves = []
    _map_tree(params, lambda _, x: leaves.append(x))
    return any(x.requires_grad for x in leaves)


def _checkpointed(fn, *args):
    """``fn(*args)``, its intermediate tensors freed after the forward and
    ``fn`` run again where the backward needs them (non-reentrant
    ``torch.utils.checkpoint``: ``args`` and the tensors ``fn`` closes
    over are kept).  The recompute runs ``fn`` whole (no early stop), so a
    step runs, and ``StepCost`` counts, each region's forward twice, as
    the reference's rematerialised scan body does; nothing in the model
    draws random numbers, so no RNG state is kept.  It runs in the
    sharding context of the forward (``ctx.snapshot``), wherever the
    backward runs it."""
    state = ctx.snapshot()

    def again(*a):
        with ctx.restored(state):
            return fn(*a)
    with torch.utils.checkpoint.set_checkpoint_early_stop(False):
        return torch.utils.checkpoint.checkpoint(
            again, *args, use_reentrant=False, preserve_rng_state=False)


def _regions(cfg: ModelConfig):
    """The layer indices of each of the reference's scanned blocks: the
    block layout's ``len(cfg.block_layout)`` layers ``n_blocks`` times,
    then the trailing layout's layers as one more block."""
    n, m = len(cfg.block_layout), cfg.n_blocks
    out = [range(j * n, (j + 1) * n) for j in range(m)]
    if cfg.trailing_layout:
        out.append(range(n * m, len(cfg.layer_kinds)))
    return out


def _prompt_layers(params, cfg: ModelConfig, tokens, cache=None,
                   prefix_embeds=None, aux=None, max_seq=None):
    """(the hidden states [B,P+S,d] after every layer and the final norm,
    P prefix positions, 0 without ``prefix_embeds``; ``aux``, an f32 zero,
    plus each MoE layer's load-balance loss in layer order, or None when
    ``aux`` is None).  With ``cache``, each global attention layer's K/V
    (or MLA's latent rows) land in its rows [0, P+S), each local layer's
    ring keeps the last of them, and each Mamba-2 or RG-LRU layer's state
    after the prompt replaces its entry.  With ``cfg.remat``, no cache
    and autograd recording, each of the reference's scanned blocks
    (``_regions``) runs checkpointed (``_checkpointed``), as the
    reference wraps its scan body in ``jax.checkpoint``: a block keeps
    only its input until the backward runs it again.  A block casts its
    layers' leaves by the load rule itself (``cast_params``; a no-op on a
    tree already cast), as the reference casts at use inside its scan
    body: f32 masters' activation-dtype copies are not kept through the
    forward either, and their gradients reach the masters as soon as the
    block's backward has run.  On a mesh each layer's shards are made
    whole where FSDP splits them (``_use``) at use, inside its block's
    region, so the recompute gathers again."""
    check_config(cfg)
    specs = _mesh_specs(cfg)
    x = ctx.constrain_batch(_embed_inputs(params, cfg, tokens,
                                          prefix_embeds))
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    layers = list(zip(cfg.layer_kinds, params["blocks"]["s0"]))
    if cfg.remat and cache is None and _records(params):
        for region in _regions(cfg):
            def block(x, aux, region=region):
                for i in region:
                    kind, p = layers[i]
                    x, aux = _layer(_at_use(cast_params(cfg, p), specs, i),
                                    cfg, kind, x, positions, aux)
                return ctx.constrain_batch(x), aux
            x, aux = _checkpointed(block, x, aux)
    else:
        for i, (kind, p) in enumerate(layers):
            x, aux = _layer(_at_use(p, specs, i), cfg, kind, x, positions,
                            aux, cache, i, max_seq)
            x = ctx.constrain_batch(x)
    final = params["final_norm"]
    if specs is not None:
        final = _use_leaf(final, specs["final_norm"])
    return rms_norm(x, final, cfg.norm_eps, plus_one=True), aux


def encode(params, cfg: ModelConfig, frames):
    """An encdec model's encoder output [B, T, d] of frame embeddings
    ``frames`` [B, T, vision_dim]: cast to the activation dtype and
    projected by ``frame_proj`` in it, plus the sinusoidal positions, then
    every encoder layer (unmasked self-attention, GELU MLP) and
    ``enc_norm``."""
    check_config(cfg)
    if frames is None:
        raise ValueError(f"{cfg.name} needs frame embeddings "
                         "(prefix_embeds)")
    adt, proj = cfg.adtype, params["frame_proj"]
    x = frames.to(proj.device, adt) @ proj
    x = x + sinusoidal_positions(x.shape[1], cfg.d_model, adt, x.device)
    for p in params["enc_blocks"]:
        h = rms_norm(x, p["norm1"], cfg.norm_eps, plus_one=True)
        x = x + attention_forward(p["attn"], cfg, h, None, causal=False)
        h = rms_norm(x, p["norm2"], cfg.norm_eps, plus_one=True)
        x = x + apply_mlp(p["mlp"], h, cfg.mlp_variant)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps, plus_one=True)


def _cross_entry(cache, i):
    """Decoder layer i's cross-attention K/V, views of the cache."""
    return AttnCache(cache["cross_k"][i], cache["cross_v"][i])


def _decoder_prompt(params, cfg: ModelConfig, tokens, enc, cache=None):
    """An encdec model's decoder hidden states [B,S,d] over the prompt,
    after the final norm; with ``cache``, each layer's self-attention K/V
    land in its rows [0, S) and its cross-attention K/V of ``enc`` in
    ``cross_k`` / ``cross_v``."""
    x = _embed(params, cfg, tokens)
    x = x + sinusoidal_positions(x.shape[1], cfg.d_model, x.dtype, x.device)
    for i, p in enumerate(params["dec_blocks"]):
        h = rms_norm(x, p["norm1"], cfg.norm_eps, plus_one=True)
        x = x + attention_forward(p["attn"], cfg, h, None, cache=None
                                  if cache is None else
                                  _entry(cache["blocks"]["s0"], i))
        h = rms_norm(x, p["norm_x"], cfg.norm_eps, plus_one=True)
        kv = encode_cross_kv(p["xattn"], cfg, enc, None if cache is None
                             else _cross_entry(cache, i))
        x = x + cross_attention_forward(p["xattn"], cfg, h, kv)
        h = rms_norm(x, p["norm2"], cfg.norm_eps, plus_one=True)
        x = x + apply_mlp(p["mlp"], h, cfg.mlp_variant)
    return rms_norm(x, params["final_norm"], cfg.norm_eps, plus_one=True)


def _decoder_step(params, cfg: ModelConfig, token, cache):
    """An encdec model's decode step: the token's embedding plus its
    position's, each decoder layer's self-attention over the first pos + 1
    rows of its cache (the new K/V written at row pos) and cross-attention
    over all ``enc_seq`` rows of its cross K/V."""
    pos = cache["pos"]
    x = _embed(params, cfg, token)
    x = x + position_embedding(pos, cfg.d_model, x.dtype, x.device)
    b, dev = x.shape[0], x.device
    self_rows = torch.full((b,), pos + 1, dtype=torch.int32, device=dev)
    cross_rows = torch.full((b,), cfg.enc_seq, dtype=torch.int32, device=dev)
    for i, p in enumerate(params["dec_blocks"]):
        h = rms_norm(x, p["norm1"], cfg.norm_eps, plus_one=True)
        x = x + attention_decode(p["attn"], cfg, h,
                                 _entry(cache["blocks"]["s0"], i), pos, None,
                                 self_rows)
        h = rms_norm(x, p["norm_x"], cfg.norm_eps, plus_one=True)
        x = x + cross_attention_decode(p["xattn"], cfg, h,
                                       _cross_entry(cache, i), cross_rows)
        h = rms_norm(x, p["norm2"], cfg.norm_eps, plus_one=True)
        x = x + apply_mlp(p["mlp"], h, cfg.mlp_variant)
    return rms_norm(x, params["final_norm"], cfg.norm_eps, plus_one=True)


def _hidden(params, cfg: ModelConfig, tokens, prefix_embeds, aux: bool):
    """(the hidden states after the final norm, the MoE layers'
    load-balance losses summed in layer order from an f32 zero, or None
    without ``aux``; an encdec model's is zero)."""
    zero = (torch.zeros((), dtype=torch.float32,
                        device=params["final_norm"].device) if aux else None)
    if cfg.family == "encdec":
        return _decoder_prompt(params, cfg, tokens,
                               encode(params, cfg, prefix_embeds)), zero
    return _prompt_layers(params, cfg, tokens, prefix_embeds=prefix_embeds,
                          aux=zero)


def forward(params, cfg: ModelConfig, tokens, prefix_embeds=None, *,
            return_aux: bool = False):
    """Full-sequence logits [B, P+S, V] (f32).  tokens [B, S] int;
    ``prefix_embeds`` [B, P, vision_dim] (vlm) go before the text; an
    encdec model's (its frame embeddings [B, T, vision_dim]) go through
    the encoder, and the logits are the text's [B, S, V].  With
    ``return_aux``, (logits, the MoE layers' load-balance losses summed
    in layer order from an f32 zero: zero without experts)."""
    x, aux = _hidden(params, cfg, tokens, prefix_embeds, return_aux)
    logits = _logits(params, cfg, x)
    return (logits, aux) if return_aux else logits


def _head_nll(table, cfg: ModelConfig, x, labels):
    """``nll_sum`` of the tied unembedding's f32 logits of rows x [..., d]
    (softcapped at ``cfg.final_softcap``) against ``labels`` [...]; the
    table cast to x's dtype here (inside each checkpointed chunk of
    ``_chunked_nll``, from the f32 master, as the blocks cast theirs) and,
    on a mesh, gathered over 'data' and vocabulary-parallel over 'model':
    the softmax's max and sum, and the labels' logits, all-reduced."""
    table = table.to(x.dtype)
    specs = _mesh_specs(cfg)
    if specs is None:
        return nll_sum(unembed({"table": table}, x, cap=cfg.final_softcap),
                       labels)
    table = _use_leaf(table, specs["embed"]["table"])
    logits = unembed({"table": table}, comm.reduce_grad(x, "model"),
                     cap=cfg.final_softcap)
    return nll_sum(logits, labels, vocab_lo=_vocab_lo(cfg))


def _chunked_nll(table, cfg: ModelConfig, x, labels):
    """``_head_nll`` over the rows of x [B, S, d] in checkpointed chunks
    of ``LOSS_CHUNK_ROWS`` rows: each chunk is its own region
    (``_checkpointed``), so only one chunk's f32 logits, and in the
    backward their gradient, are alive at a time, and each chunk's table
    gradient reaches the f32 master through its own cast; the sums are
    added in row order."""
    rows, flat = x.reshape(-1, x.shape[-1]), labels.reshape(-1)
    total = None
    for xs, ls in zip(torch.split(rows, LOSS_CHUNK_ROWS),
                      torch.split(flat, LOSS_CHUNK_ROWS)):
        part = _checkpointed(_head_nll, table, cfg, xs, ls)
        total = part if total is None else total + part
    return total


def loss_fn(params, cfg: ModelConfig, batch):
    """(loss, {"ce", "aux"}) of ``batch`` (``tokens``, ``labels`` [B, S]
    and, for the vlm and encdec families, ``prefix_embeds``): the
    next-token cross-entropy over the labels that are not -1 plus
    ``AUX_WEIGHT`` times the MoE load-balance loss.  ``params`` are f32
    masters (``keep_f32=True``), cast here once by ``cast_params``, or a
    tree already in the load rule's dtypes.  A vlm batch's labels get -1
    over the prefix rows.  With ``cfg.remat`` and autograd recording, the
    layers run in checkpointed blocks that cast their own leaves
    (``_prompt_layers``; an encdec model's are cast here and not
    checkpointed, as in the reference) and the head in checkpointed row
    chunks that cast the table (``_chunked_nll``), every family alike.
    On a mesh (the sharding context) the batch is this rank's shard and
    the loss its part: its rows' summed loss over the labels counted
    over every batch shard, so the parts sum to the reference's loss."""
    remat = cfg.remat and _records(params)
    if remat and "blocks" in params:
        # each checkpointed block casts its own layers (``_prompt_layers``),
        # each head chunk the table (``_head_nll``)
        kept = ("blocks", "embed")
        p = dict(cast_params(cfg, {k: v for k, v in params.items()
                                   if k not in kept}),
                 **{k: params[k] for k in kept})
    else:
        p = cast_params(cfg, params)
    x, aux = _hidden(p, cfg, batch["tokens"], batch.get("prefix_embeds"),
                     True)
    labels = batch["labels"]
    if x.shape[1] != labels.shape[1]:  # vlm prefix: no labels there
        pad = torch.full((labels.shape[0], x.shape[1] - labels.shape[1]),
                         -1, dtype=labels.dtype, device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    table = p["embed"]["table"]
    total = (_chunked_nll if remat else _head_nll)(table, cfg, x, labels)
    count = comm.sum_over((labels != -1).sum(), ctx.batch_axes() or ())
    ce = total / torch.clamp(count, min=1)
    return ce + AUX_WEIGHT * aux, {"ce": ce, "aux": aux}


def prefill(params, cfg: ModelConfig, tokens, prefix_embeds=None, *,
            max_seq=None):
    """Run the prompt, after ``prefix_embeds`` [B, P, vision_dim] where
    given: (last-position logits [B, 1, V], cache holding the prompt's K/V
    and recurrent states for ``decode_step``, its ``pos`` P + S).
    ``max_seq`` sizes the attention caches (a local layer's ring,
    ``kvcache.py``); a config without a global ``"attn"`` layer takes any
    prompt.  An encdec model's ``prefix_embeds`` are its frames: the
    encoder takes them, the cache keeps their cross-attention K/V, and
    ``pos`` and ``max_seq`` count the text only."""
    b = tokens.shape[0]
    s = tokens.shape[1] + (0 if prefix_embeds is None
                           or cfg.family == "encdec"
                           else prefix_embeds.shape[1])
    max_seq = max_seq or s
    if bounded_by_max_seq(cfg) and s > max_seq:
        raise ValueError(f"prompt of {s} tokens does not fit max_seq="
                         f"{max_seq} (the global layers' wrapping ring is "
                         "not ported)")
    cache = init_cache(cfg, b, max_seq, cfg.adtype,
                       params["embed"]["table"].device, ctx.current_mesh())
    if cfg.family == "encdec":
        x = _decoder_prompt(params, cfg, tokens,
                            encode(params, cfg, prefix_embeds), cache)
    else:
        x, _ = _prompt_layers(params, cfg, tokens, cache["blocks"]["s0"],
                              prefix_embeds, max_seq=max_seq)
    cache["pos"] = s
    return _logits(params, cfg, x[:, -1:]), cache


def decode_step(params, cfg: ModelConfig, token, cache):
    """One decode step.  token [B, 1] int -> (logits [B, 1, V], cache).
    The cache is updated in place (the new K/V or latent row at ``pos``,
    or at slot pos % R of a local layer's ring, each recurrent layer's new
    state, then ``pos + 1``) and returned."""
    check_config(cfg)
    if bounded_by_max_seq(cfg) and cache["pos"] >= cache["max_seq"]:
        raise ValueError(f"the cache holds {cache['max_seq']} positions and "
                         "is full (the global layers' wrapping ring is not "
                         "ported)")
    step = _decoder_step if cfg.family == "encdec" else _layers_step
    x = step(params, cfg, token, cache)
    cache["pos"] += 1
    return _logits(params, cfg, x), cache


def _layers_step(params, cfg: ModelConfig, token, cache):
    """The hidden state [B,1,d] after every layer and the final norm, for
    one decode step of the token at ``cache["pos"]``."""
    pos, c = cache["pos"], cache["blocks"]["s0"]
    specs = _mesh_specs(cfg)
    x = ctx.constrain_batch(_embed(params, cfg, token))
    b = x.shape[0]
    entries = [_entry(c, i) if kind in ("attn", "local")
               and not _is_mla(cfg, kind) else None
               for i, kind in enumerate(cfg.layer_kinds)]
    positions = torch.full((b, 1), pos, dtype=torch.long, device=x.device)
    # the rows each cache size attends: min(pos + 1, T)
    lengths = {n: torch.full((b,), min(pos + 1, n), dtype=torch.int32,
                             device=x.device)
               for n in {e.k.shape[2] for e in entries if e is not None}}
    for i, (kind, p) in enumerate(zip(cfg.layer_kinds,
                                      params["blocks"]["s0"])):
        p = _at_use(p, specs, i)
        h = rms_norm(x, p["norm1"], cfg.norm_eps, plus_one=True)
        if _is_mla(cfg, kind):
            o, c_col, kr_col = mla_decode_v2(p["mla"], cfg, h, c[i].c[:, :pos],
                                             c[i].kr[:, :pos], pos)
            c[i].c[:, pos].copy_(c_col[:, 0])
            c[i].kr[:, pos].copy_(kr_col[:, 0])
        elif kind in ("ssm", "rec"):
            step = ssm_decode_step if kind == "ssm" else rec_decode_step
            o, c[i] = step(p[kind], cfg, h, c[i])
        else:
            o = attention_decode(p["attn"], cfg, h, entries[i], pos,
                                 positions, lengths[entries[i].k.shape[2]],
                                 _rows(cfg, kind, cache["max_seq"]))
        x, _ = _residuals(p, cfg, kind, x, o)
        x = ctx.constrain_batch(x)
    return rms_norm(x, params["final_norm"], cfg.norm_eps, plus_one=True)
