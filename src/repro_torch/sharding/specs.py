"""Partition rules for parameters, inputs and decode caches: the rule
table of ``repro.sharding.specs``, its specs as tuples of mesh axis names
(``None``: the dim is not sharded).

Baseline scheme (MaxText-style 2-D):
  * 'data'  axis = batch parallelism AND FSDP shard axis for training params
  * 'model' axis = tensor parallelism (heads / ff / vocab / experts-ff)
  * 'pod'   axis = pure data parallelism across pods (params replicated)

For serving (``mode='serve'``) the FSDP axis is dropped.  The reference
stacks each block slot's layers on a leading dim (``blocks/s0/attn/wq``
[n, d, h*hd]) and gives that dim ``None``; the port keeps one leaf a
layer (``blocks/s0/3/attn/wq`` [d, h*hd]), whose spec is the reference's
without that ``None``.  An axis that does not divide its dim is dropped,
as in the reference.  ``mesh`` is a ``DeviceMesh`` or a mapping of axis
name to size.
"""
from __future__ import annotations

import math
import re
from typing import Any, Dict, Optional, Tuple

# (regex on param path, spec for the *unstacked* param): the reference's
_RULES: Tuple[Tuple[str, Tuple], ...] = (
    (r"embed/table$", ("model", "data")),
    (r"(vision_proj|frame_proj)$", (None, "data")),
    (r"attn/w[qkv]$", ("data", "model")),
    (r"attn/wo$", ("model", "data")),
    (r"attn/b[qkv]$", ("model",)),
    (r"xattn/w[qkv]$", ("data", "model")),
    (r"xattn/wo$", ("model", "data")),
    (r"mla/wq$", ("data", "model")),
    (r"mla/w_dkv$", ("data", None)),
    (r"mla/w_kr$", ("data", None)),
    (r"mla/w_uk$", (None, "model")),
    (r"mla/w_uv$", (None, "model")),
    (r"mla/wo$", ("model", "data")),
    (r"mlp/w_(gate|up)$", ("data", "model")),
    (r"mlp/w_down$", ("model", "data")),
    (r"shared/w_(gate|up)$", ("data", "model")),
    (r"shared/w_down$", ("model", "data")),
    (r"moe/router$", ("data", None)),
    (r"moe/w_(gate|up)$", (None, "data", "model")),
    (r"moe/w_down$", (None, "model", "data")),
    (r"rec/w_(gate|x)$", ("data", "model")),
    (r"rec/w_out$", ("model", "data")),
    (r"rec/lru_w[ax]$", ("data", "model")),
    (r"rec/(lru_b[ax]|log_lambda|conv_b)$", ("model",)),
    (r"rec/conv_w$", (None, "model")),
    (r"ssm/in_proj$", ("data", None)),
    (r"ssm/out_proj$", (None, "data")),
    (r"ssm/conv_w$", (None, None)),
)

#: the batch axes, in the order a batch dim is split over them
BATCH_AXES = ("pod", "data")


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of a mapping."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}


def axis_coords(mesh) -> Dict[str, int]:
    """{axis name: this rank's index along it} of a ``DeviceMesh``."""
    return {n: mesh.get_local_rank(n) for n in mesh.mesh_dim_names}


def spec_for_param(path: str, shape, *, mode: str, mesh=None) -> Tuple:
    """The spec of the leaf at ``path`` (``optim.adamw.tree_paths``' form)
    of ``shape``."""
    spec: Optional[Tuple] = None
    for pat, s in _RULES:
        if re.search(pat, path):
            spec = s
            break
    if spec is None or len(spec) != len(shape):
        spec = (None,) * len(shape)  # norms, scalars, odd shapes: replicate
    if mode == "serve":  # drop FSDP axis
        spec = tuple(None if s == "data" else s for s in spec)
    if mesh is not None:  # drop axes that do not divide the dim evenly
        sizes = axis_sizes(mesh)
        spec = tuple(a if a is None or (a in sizes and shape[i] % sizes[a]
                                        == 0) else None
                     for i, a in enumerate(spec))
    return spec


def _map(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn, path + (i,)) for i, v in enumerate(tree))
    return fn("/".join(map(str, path)), tree)


def param_specs(params: Any, *, mode: str = "train", mesh=None) -> Any:
    """A tree of specs shaped like ``params``."""
    return _map(params, lambda path, x: spec_for_param(
        path, tuple(x.shape), mode=mode, mesh=mesh))


def batch_axes(mesh) -> Tuple[str, ...]:
    """The composite batch-sharding axis tuple for this mesh."""
    sizes = axis_sizes(mesh)
    return tuple(a for a in BATCH_AXES if a in sizes)


def batch_shards(mesh) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in batch_axes(mesh))


def batch_spec(mesh, global_batch: int, ndim: int) -> Tuple:
    """Shard dim 0 over (pod, data) when divisible, else replicate."""
    if global_batch % batch_shards(mesh) == 0:
        return (batch_axes(mesh),) + (None,) * (ndim - 1)
    return (None,) * ndim


def decode_cache_layout(num_kv_heads: int, seq: int, mesh) -> str:
    """How attention K/V caches use the 'model' axis at decode time:
    'kv' shards the KV-head dim (kv_heads % model == 0), 'seq' the
    sequence dim, 'none' replicates (neither divides)."""
    sizes = axis_sizes(mesh)
    if "model" not in sizes:
        return "none"
    m = sizes["model"]
    if num_kv_heads % m == 0:
        return "kv"
    if seq % m == 0:
        return "seq"
    return "none"


def cache_specs(cache: Any, mesh, global_batch: int) -> Any:
    """Specs of a decode cache (``models.init_cache`` at global shapes),
    shaped like it: batch over (pod, data); each attention layer's K/V
    ([n, B, KV, T, hd] stacked, [B, KV, T, hd] a layer) over 'model' by
    ``decode_cache_layout``; recurrent states and latent rows
    batch-sharded; ``pos`` and ``max_seq`` (ints) None.  The reference's
    K/V are [n, B, T, KV, hd]: the same specs with KV and T swapped."""
    from repro_torch.models.kvcache import AttnCache
    mdl = "model" if "model" in axis_sizes(mesh) else None
    bspec = batch_spec(mesh, global_batch, 1)[0]

    def batched(t):
        return (bspec,) + (None,) * (t.dim() - 1)

    def entry(e):
        if isinstance(e, AttnCache):
            stacked = (None,) * (e.k.dim() - 4)
            kv, rows = e.k.shape[-3], e.k.shape[-2]
            layout = decode_cache_layout(kv, rows, mesh)
            spec = stacked + (bspec, mdl if layout == "kv" else None,
                              mdl if layout == "seq" else None, None)
            return AttnCache(spec, spec)
        return type(e)(*(batched(t) for t in e))

    blocks = cache["blocks"]["s0"]
    out = {k: None for k in cache if k != "blocks"}
    out["blocks"] = {"s0": [entry(e) for e in blocks]
                     if isinstance(blocks, list) else entry(blocks)}
    for name in ("cross_k", "cross_v"):
        if name in cache:
            out[name] = (None, bspec) + (None,) * (cache[name].dim() - 2)
    return out


def local_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """The shape of one rank's shard of a tensor of ``shape``."""
    sizes = axis_sizes(mesh)
    return tuple(n // math.prod(sizes[a] for a in _axes(s))
                 for n, s in zip(shape, spec))


def _axes(s) -> Tuple[str, ...]:
    return () if s is None else (s,) if isinstance(s, str) else tuple(s)


def shard_index(s, mesh) -> Tuple[int, int]:
    """(this rank's shard index, shard count) along a dim of spec entry
    ``s``: the axes of a tuple entry in order, the first outermost."""
    sizes, coords = axis_sizes(mesh), axis_coords(mesh)
    index, count = 0, 1
    for a in _axes(s):
        index, count = index * sizes[a] + coords[a], count * sizes[a]
    return index, count


def local_slice(x, spec, mesh):
    """This rank's shard of the full tensor ``x`` (a view)."""
    for dim, s in enumerate(spec):
        index, count = shard_index(s, mesh)
        if count > 1:
            n = x.shape[dim] // count
            x = x.narrow(dim, index * n, n)
    return x
