"""The steps of ``repro.launch.steps``: training, prefill and decode, on
one device or on a mesh, and their inputs for an ``InputShape``.

The training step differentiates ``loss_fn`` by autograd with respect to
the f32 master parameters (``init_params(..., keep_f32=True)``), which
the loss casts to the layers' dtypes once a step (``models.cast_params``),
and hands the gradients to ``adamw_update``.  On the card the attention layers
run the flash kernel and its backward kernel.

Torch has no ``ShapeDtypeStruct``: where the reference builds input
specs, ``batch_inputs`` and ``decode_inputs`` return seeded tensors on
the device, drawn from one ``torch.Generator``.  A decode input is a full
cache of seeded values whose ``pos`` is ``seq_len - 1``, so one decode
step attends the whole cache without a prefill before it, as the
reference's lowered step reads the whole buffer.

With a ``mesh`` (``launch/mesh.py``) a step runs one rank's program
inside ``sharding.ctx.activation_sharding``: its parameters, moments and
decode cache are the rank's shards (``models.shard_params``,
``init_shards``, ``init_cache(..., mesh)``), the batch it is handed is
the global one, which it splits by ``sharding.specs.batch_spec`` (each
micro-batch's rows over the batch axes, as the reference's
``lower_combo`` shards them), and the model code runs its sharded path
(``models/model.py``).  Without one a step is the one-device step.
"""
from __future__ import annotations

import contextlib
import math

import torch

from repro_torch.device import resolve_device
from repro_torch.models import decode_step, init_cache, loss_fn, prefill
from repro_torch.models.base import InputShape, ModelConfig
from repro_torch.models.model import leaf_specs, mesh_specs
from repro_torch.optim.adamw import (AdamWConfig, OptState, adamw_update,
                                     tree_leaves, tree_paths,
                                     tree_unflatten)
from repro_torch.sharding import comm, ctx
from repro_torch.sharding import specs as sp


def on_mesh(mesh, mode: str):
    """The sharding context of a step on ``mesh`` in ``mode`` (no context
    without a mesh)."""
    if mesh is None:
        return contextlib.nullcontext()
    return ctx.activation_sharding(sp.batch_axes(mesh), mesh, mode)


def batch_shard(x, mesh):
    """This rank's rows of a global batch tensor (``batch_spec``); all of
    them without a mesh."""
    if mesh is None:
        return x
    return sp.local_slice(x, sp.batch_spec(mesh, x.shape[0], x.dim()), mesh)


def decays_as_stacked(path, leaf) -> bool:
    """The reference's weight-decay rule in the port's layout.  The
    reference decays leaves of two or more dims, and keeps each layer's
    leaves stacked on a leading layer dim, so it decays every leaf of a
    layer, its norms and biases too; the port keeps its layers in lists
    (an index in ``path``), one leaf a layer."""
    return leaf.ndim >= 2 or any(isinstance(k, int) for k in path)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    num_microbatches: int = 1, mesh=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with ``loss``, ``ce``, ``aux``, ``lr`` and ``grad_norm`` (0-dim
    tensors on the device).  The step takes ownership of ``params`` and
    ``opt_state``, as the reference's jitted step donates them: they are
    updated in place and returned.  ``num_microbatches > 1`` splits the
    batch along its first dim, accumulates the gradients in f32, divides
    them by the count and averages the losses and metrics, as the
    reference's ``lax.scan`` does.  The gradients accumulate in each
    master's ``.grad`` (autograd adds a micro-batch's into it leaf by leaf
    as the backward reaches the leaf, in the reference's order: the first
    micro-batch's, then each later one's added), so the step holds one
    f32 gradient a parameter, whatever the count, and none after it
    returns; micro-batches therefore take f32 masters
    (``init_params(..., keep_f32=True)``) and raise on another dtype.
    Weight decay follows the reference's stacked layers
    (``decays_as_stacked``).  Raises if a parameter leaf received no
    gradient.  On ``mesh`` (module docstring) the parameters and moments
    are the rank's f32 shards, the gradients reach them reduce-scattered
    (``sharding/comm.py``) and accumulate there, AdamW runs on them with
    the norm summed over the ranks, each leaf once, and the metrics are
    the global batch's."""
    if num_microbatches < 1:
        raise ValueError(f"num_microbatches must be >= 1; got "
                         f"{num_microbatches}")

    replicas = None
    if mesh is not None:
        specs = leaf_specs(mesh_specs(cfg, mesh, "train"))
        sizes = sp.axis_sizes(mesh)
        world = math.prod(sizes.values())
        replicas = [world // math.prod(sizes[a] for a in s if a)
                    for s in specs]

    def split(x):
        if x.shape[0] % num_microbatches:
            raise ValueError(f"a batch of {x.shape[0]} does not split into "
                             f"{num_microbatches} microbatches")
        return x.reshape((num_microbatches, -1) + tuple(x.shape[1:]))

    def accumulate(params, leaves, micro):
        """Each micro-batch's loss and metrics; its gradients added into
        the leaves' ``.grad``."""
        losses, ms = [], []
        for i, mb in enumerate(micro):
            loss, metrics = loss_fn(params, cfg, mb)
            loss.backward()
            if i == 0:
                missing = [path for path, p in zip(tree_paths(params),
                                                   leaves) if p.grad is None]
                if missing:
                    raise RuntimeError(f"{cfg.name}: no gradient reached the "
                                       f"parameters {missing}")
            losses.append(loss.detach())
            ms.append({k: m.detach() for k, m in metrics.items()})
        return losses, ms

    def train_step(params, opt_state: OptState, batch):
        with on_mesh(mesh, "train"):
            return step(params, opt_state, batch)

    def step(params, opt_state: OptState, batch):
        leaves = tree_leaves(params)
        if num_microbatches == 1:
            micro = [batch]
        else:
            if any(p.dtype != torch.float32 for p in leaves):
                raise ValueError("micro-batches accumulate in the masters' "
                                 "gradients: pass f32 masters")
            parts = {k: split(x) for k, x in batch.items()}
            micro = [{k: x[i] for k, x in parts.items()}
                     for i in range(num_microbatches)]
        micro = [{k: batch_shard(x, mesh) for k, x in mb.items()}
                 for mb in micro]
        for p in leaves:
            p.grad = None
            p.requires_grad_(True)
        try:
            losses, ms = accumulate(params, leaves, micro)
            grads = [p.grad for p in leaves]
            if num_microbatches == 1:
                loss, metrics = losses[0], ms[0]
            else:
                n = torch.full((), num_microbatches, dtype=torch.float32,
                               device=losses[0].device)
                for g in grads:
                    g.div_(n)
                loss = torch.stack(losses).mean()
                metrics = {k: torch.stack([m[k] for m in ms]).mean()
                           for k in ms[0]}
            if mesh is not None:   # each rank's part of the batch's loss
                axes = sp.batch_axes(mesh)
                loss = comm.sum_over(loss, axes)
                metrics = {k: comm.sum_over(m, axes)
                           for k, m in metrics.items()}
            with torch.no_grad():
                params, opt_state, opt_metrics = adamw_update(
                    opt_cfg, params, tree_unflatten(params, grads),
                    opt_state, decays=decays_as_stacked, replicas=replicas,
                    reduce=None if mesh is None else comm.sum_all)
        finally:
            for p in leaves:
                p.requires_grad_(False)
                p.grad = None
        return params, opt_state, dict(metrics, loss=loss, **opt_metrics)

    return train_step


def make_prefill_step(cfg: ModelConfig, mesh=None):
    """``prefill_step(params, batch) -> (last-position logits, cache)``;
    on ``mesh`` the rank's rows of both."""
    def prefill_step(params, batch):
        with on_mesh(mesh, "serve"):
            return prefill(params, cfg, batch_shard(batch["tokens"], mesh),
                           None if batch.get("prefix_embeds") is None else
                           batch_shard(batch["prefix_embeds"], mesh))
    return prefill_step


def make_decode_step(cfg: ModelConfig, mesh=None):
    """``serve_step(params, token, cache) -> (logits, cache)``; the cache
    is updated in place.  On ``mesh`` ``token`` is the global batch's and
    the cache and logits the rank's rows."""
    def serve_step(params, token, cache):
        with on_mesh(mesh, "serve"):
            return decode_step(params, cfg, batch_shard(token, mesh), cache)
    return serve_step


def text_len(cfg: ModelConfig, seq_len: int) -> int:
    """Text tokens after reserving prefix positions for stub modalities."""
    if cfg.family == "vlm" and cfg.num_prefix_embeds:
        return max(seq_len - cfg.num_prefix_embeds, 16)
    return seq_len


def batch_inputs(cfg: ModelConfig, shape: InputShape, batch: int, *,
                 seed: int = 0, device="cuda"):
    """A train or prefill batch of ``batch`` sequences: ``tokens`` [batch,
    text_len] (and ``labels`` for training), a vlm's ``prefix_embeds``
    [batch, num_prefix_embeds, vision_dim] or an encdec model's frames
    [batch, enc_seq, vision_dim] in f32, drawn on ``device`` from one
    generator seeded with ``seed`` (on the meta device: their sizes, no
    draws)."""
    dev = resolve_device(device)
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))
    st = text_len(cfg, shape.seq_len)

    def ids():
        return torch.randint(0, cfg.vocab_size, (batch, st), generator=gen,
                             device=dev)

    out = {"tokens": ids()}
    if shape.kind == "train":
        out["labels"] = ids()
    if cfg.family == "vlm" and cfg.num_prefix_embeds:
        out["prefix_embeds"] = torch.randn(
            (batch, cfg.num_prefix_embeds, cfg.vision_dim), generator=gen,
            device=dev)
    if cfg.family == "encdec":
        out["prefix_embeds"] = torch.randn(
            (batch, cfg.enc_seq, cfg.vision_dim), generator=gen, device=dev)
    return out


def cache_tensors(cache):
    """The tensors of a decode cache, in ``tree_leaves``' order."""
    return [t for t in tree_leaves(cache) if isinstance(t, torch.Tensor)]


def decode_inputs(cfg: ModelConfig, shape: InputShape, batch: int, *,
                  seed: int = 0, device="cuda", mesh=None):
    """(token [batch, 1], cache) for one decode step at position
    ``shape.seq_len - 1``: ``init_cache(cfg, batch, shape.seq_len)`` in the
    activation dtype with every tensor filled from one generator seeded
    with ``seed`` (standard normal values), on ``device``; on ``mesh`` the
    rank's shard of that cache (its rows of the batch)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    token = torch.randint(0, cfg.vocab_size, (batch, 1), generator=gen,
                          device=dev)
    rows = batch_shard(token, mesh).shape[0]
    cache = init_cache(cfg, rows, shape.seq_len, cfg.adtype, dev, mesh)
    for t in cache_tensors(cache):
        t.normal_(generator=gen)
    cache["pos"] = shape.seq_len - 1
    return token, cache
