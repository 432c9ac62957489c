"""The port's sharded path on real process groups: four ``gloo`` ranks on
the CPU, as a 2 x 2 (data x model) and a 1 x 4 mesh, against the
unsharded port and the JAX package's unsharded functions.

Two reduced dense configs in f32: llama3-8b (two layers, with
``remat``: FSDP's gathers inside the checkpointed blocks and the head's
chunk) and gemma2-9b (a local and a global layer: window 16, attention
and final softcaps).  On the 2 x 2 mesh both KV heads split over
'model' (the ``kv`` decode layout); on the 1 x 4 mesh the two KV heads
do not, so each rank computes the KV heads its query head reads from
K/V columns gathered whole, and decode runs the ``seq`` layout (each
rank a quarter of every cache's rows, the kernel's softmax statistics
merged over the ranks), past the gemma ring's wrap.

One spawn a mesh (``mesh_runs``; both run while the references are
computed) runs every case on each rank and saves what it got: the loss
and ``ce`` parts and the gradient shards of one ``loss_fn`` (its
backward in another thread, outside the sharding context, as the card's
autograd engine runs it), the updated shards and metrics of one
``make_train_step`` of two micro-batches, the logits of a prefill and of
four decode steps of fixed tokens, and the bytes each collective kind
moved in the step (``sharding/comm.py``).  Bars: the f32 bars of
``tests/test_torch_lm_loss.py`` (loss 1e-5 relative, each gradient
within 1e-4 of its leaf's largest |value|), the step's parameters at
``tests/test_torch_lm_train.py``'s first-step bar, logits 1e-4; the
collective bytes exactly equal to ``expected_bytes``, a count from the
shapes.
"""
import datetime
import math
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_llm as llm
import test_torch_lm_loss as lm
import test_torch_lm_train as lt
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.models import decode_step as jax_decode_step
from repro.models import prefill as jax_prefill
from repro_torch.launch import steps as st
from repro_torch.models import (decode_step, init_params, params_from_jax,
                                prefill)
from repro_torch.models.model import LOSS_CHUNK_ROWS, leaf_specs, mesh_specs
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_leaves, tree_paths, tree_unflatten
from repro_torch.sharding import specs as sp

torch.set_num_threads(1)

#: (arch, reduced-config overrides)
CASES = {"llama3-8b": {"num_layers": 2, "remat": True},
         "gemma2-9b": {}}
MESHES = ((2, 2), (1, 4))
#: the training batch, its micro-batches, the prompt, the decode steps
BATCH, SEQ, MICRO, PROMPT, STEPS, MAX_SEQ = 4, 12, 2, 14, 4, 20
OPT = lt.OPT
#: seconds the ranks of both meshes may take (a collective's too)
SPAWN_TIMEOUT_S = 300


def configs(arch):
    kw = dict(CASES[arch], activ_dtype="float32")
    return (lm.jax_get_config(arch).reduced(**kw),
            lm.get_config(arch).reduced(**kw))


def inputs(cfg, seed=5):
    rng = np.random.default_rng(seed)
    ids = lambda *s: rng.integers(0, cfg.vocab_size, s, np.int64)
    return {"tokens": ids(BATCH, SEQ), "labels": ids(BATCH, SEQ),
            "prompt": ids(BATCH, PROMPT), "next": ids(STEPS, BATCH, 1)}


class _Coords:
    """A mesh's sizes and one rank's coordinates, where ``specs`` reads a
    ``DeviceMesh``."""

    def __init__(self, shape, rank):
        self.mesh_dim_names = ("data", "model")
        self.shape, self.rank = shape, rank

    def size(self, i=None):
        return self.shape[i] if i is not None else math.prod(self.shape)

    def get_local_rank(self, name):
        return (self.rank // self.shape[1] if name == "data"
                else self.rank % self.shape[1])


# ------------------------------------------------------------- the ranks


def _rank(rank, shape, folder):
    """One rank of a spawn: every case, saved to ``rank<r>.pt``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{folder}/init",
                            rank=rank, world_size=math.prod(shape),
                            timeout=datetime.timedelta(
                                seconds=SPAWN_TIMEOUT_S))
    try:
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models import loss_fn
        from repro_torch.models.model import shard_params
        from repro_torch.sharding import comm
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        out = {}
        for arch in CASES:
            cfg = configs(arch)[1]
            data = torch.load(f"{folder}/{arch}.pt")
            b = {k: data["inputs"][k] for k in ("tokens", "labels")}
            local = shard_params(cfg, data["masters"], mesh, "train")
            leaves = [x.clone().requires_grad_(True)
                      for x in tree_leaves(local)]
            with st.on_mesh(mesh, "train"):
                loss, m = loss_fn(tree_unflatten(local, leaves), cfg,
                                  {k: st.batch_shard(x, mesh)
                                   for k, x in b.items()})
            # in a thread of its own, outside the context, as the autograd
            # engine's device threads run a checkpoint's recompute
            failed = []

            def backward():
                try:
                    loss.backward()
                except Exception as e:  # raised in this rank below
                    failed.append(e)
            thread = threading.Thread(target=backward)
            thread.start()
            thread.join()
            if failed:
                raise failed[0]
            grads = [x.grad for x in leaves]
            for x in leaves:
                x.requires_grad_(False)
            comm.reset()
            step = st.make_train_step(cfg, adamw.AdamWConfig(**OPT), MICRO,
                                      mesh=mesh)
            new, opt, metrics = step(tree_unflatten(local, leaves),
                                     adamw.init_opt_state(local), b)
            moved = comm.by_kind()
            served = shard_params(cfg, data["serving"], mesh, "serve")
            logits = []
            with torch.no_grad(), st.on_mesh(mesh, "serve"):
                prompt = st.batch_shard(data["inputs"]["prompt"], mesh)
                got, cache = prefill(served, cfg, prompt, max_seq=MAX_SEQ)
                logits.append(got)
                for tok in data["inputs"]["next"]:
                    got, cache = decode_step(served, cfg,
                                             st.batch_shard(tok, mesh), cache)
                    logits.append(got)
            out[arch] = {"loss": loss.detach(), "ce": m["ce"].detach(),
                         "grads": grads, "params": tree_leaves(new),
                         "mu": tree_leaves(opt.mu), "metrics": metrics,
                         "moved": moved, "logits": logits}
        torch.save(out, f"{folder}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """{(mesh shape, arch): (the reference's values, each rank's)}: the
    JAX package's and the unsharded port's runs here, the ranks' from
    one spawn of four processes a mesh."""
    folder = tmp_path_factory.mktemp("mesh")
    made = {}
    for arch in CASES:
        jc, tc = configs(arch)
        jp, _ = llm._params(jc, tc)
        masters = params_from_jax(tc, jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu", keep_f32=True)
        serving = params_from_jax(tc, jax.tree_util.tree_map(np.asarray,
                                                             jp),
                                  device="cpu")
        data = inputs(tc)
        torch.save({"masters": masters, "serving": serving,
                    "inputs": {k: torch.from_numpy(v)
                               for k, v in data.items()}},
                   f"{folder}/{arch}.pt")
        made[arch] = (jc, tc, jp, masters, serving, data)
    # both meshes' ranks run while this process computes the references
    spawns = {}
    for shape in MESHES:
        sub = folder / "x".join(map(str, shape))
        sub.mkdir()
        for arch in CASES:
            os.link(f"{folder}/{arch}.pt", f"{sub}/{arch}.pt")
        spawns[shape, sub] = mp.start_processes(
            _rank, args=(shape, sub), nprocs=math.prod(shape), join=False,
            start_method="spawn")
    refs = {arch: reference(*made[arch]) for arch in CASES}
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    for running in spawns.values():
        while not running.join(timeout=1):
            if time.monotonic() > deadline:
                for p in (p for r in spawns.values() for p in r.processes):
                    p.kill()
                pytest.fail(f"the ranks ran past {SPAWN_TIMEOUT_S} s")
    got = {}
    for shape, sub in spawns:
        ranks = [torch.load(f"{sub}/rank{r}.pt")
                 for r in range(math.prod(shape))]
        for arch in CASES:
            got[shape, arch] = (refs[arch], [r[arch] for r in ranks])
    return got



def reference(jc, tc, jp, masters, serving, data):
    """The JAX package's and the unsharded port's values of every check."""
    b = {k: data[k].astype(np.int32) for k in ("tokens", "labels")}
    (jl, jm), jg = lm.jax_value_and_grad(jc, jp, b)
    as_port = lambda tree: tree_leaves(params_from_jax(
        tc, jax.tree_util.tree_map(np.asarray, tree), device="cpu",
        keep_f32=True))
    (tl, tm), tg = lm.port_value_and_grad(tc, masters, b)
    copy = tree_unflatten(masters, [x.clone() for x in tree_leaves(masters)])
    new, opt, metrics = st.make_train_step(
        tc, adamw.AdamWConfig(**OPT), MICRO)(
            copy, adamw.init_opt_state(copy), lm.torch_batch(b))
    prompt = data["prompt"]
    jlog, jcache = jax.jit(lambda p, t: jax_prefill(
        p, jc, t, max_seq=MAX_SEQ))(jp, jnp.asarray(prompt, jnp.int32))
    jsteps = [jlog]
    jdec = jax.jit(lambda p, t, c: jax_decode_step(p, jc, t, c))
    with torch.no_grad():
        tlog, cache = prefill(serving, tc, torch.from_numpy(prompt),
                              max_seq=MAX_SEQ)
        tsteps = [tlog]
        for tok in data["next"]:
            jlog, jcache = jdec(jp, jnp.asarray(tok, jnp.int32), jcache)
            jsteps.append(jlog)
            tlog, cache = decode_step(serving, tc, torch.from_numpy(tok),
                                      cache)
            tsteps.append(tlog)
    return {"jax": {"loss": float(jl), "ce": float(jm["ce"]),
                    "grads": as_port(jg),
                    "logits": [np.asarray(x) for x in jsteps]},
            "port": {"loss": float(tl), "ce": float(tm["ce"]), "grads": tg,
                     "params": tree_leaves(new), "mu": tree_leaves(opt.mu),
                     "metrics": metrics, "lr": float(metrics["lr"]),
                     "logits": tsteps}}


def _close(got, want, what, scale=None):
    bar = 1e-4 * (scale if scale is not None else float(np.abs(
        np.asarray(want)).max()))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=bar + 1e-30, err_msg=what)


CELLS = [(shape, arch) for shape in MESHES for arch in CASES]
IDS = [f"{'x'.join(map(str, s))}-{a}" for s, a in CELLS]


def _parts(shape, arch):
    """(rank coordinates, the leaves' specs) of a cell."""
    tc = configs(arch)[1]
    sizes = {"data": shape[0], "model": shape[1]}
    return ([_Coords(shape, r) for r in range(math.prod(shape))],
            leaf_specs(mesh_specs(tc, sizes, "train")))


@pytest.mark.parametrize("shape,arch", CELLS, ids=IDS)
def test_loss_and_ce_equal_unsharded(mesh_runs, shape, arch):
    """Each rank's loss and ``ce`` are its part: summed over the batch
    shards of one 'model' coordinate they are the unsharded port's and the
    reference's, and every rank of a batch shard holds the same part."""
    ref, ranks = mesh_runs[shape, arch]
    for key in ("loss", "ce"):
        for mr in range(shape[1]):
            total = sum(float(ranks[d * shape[1] + mr][key])
                        for d in range(shape[0]))
            for want in (ref["port"][key], ref["jax"][key]):
                np.testing.assert_allclose(total, want, rtol=1e-5, atol=0,
                                           err_msg=key)


@pytest.mark.parametrize("shape,arch", CELLS, ids=IDS)
def test_gradient_shards_equal_unsharded(mesh_runs, shape, arch):
    """Every rank's gradient shard of every leaf against the same slice of
    the unsharded port's and of the reference's gradient, within 1e-4 of
    the leaf's largest |value|."""
    ref, ranks = mesh_runs[shape, arch]
    coords, specs = _parts(shape, arch)
    paths = tree_paths(init_params(configs(arch)[1], device="meta"))
    for who in ("port", "jax"):
        for r, (c, got) in enumerate(zip(coords, ranks)):
            for path, spec, g, want in zip(paths, specs, got["grads"],
                                           ref[who]["grads"]):
                assert g.shape == sp.local_shape(want.shape, spec, c), path
                _close(g, sp.local_slice(want, spec, c),
                       f"{who} rank {r} {path} {spec}",
                       float(want.abs().max()))


@pytest.mark.parametrize("shape,arch", CELLS, ids=IDS)
def test_train_step_equals_unsharded(mesh_runs, shape, arch):
    """One ``make_train_step`` of two micro-batches: the metrics (the
    global batch's loss and the grad norm, each leaf counted once) at
    1e-5 relative, the first moments' shards at the gradient bar and the
    updated shards at the first step's bar, against the unsharded port's
    step."""
    ref, ranks = mesh_runs[shape, arch]
    coords, specs = _parts(shape, arch)
    port = ref["port"]
    for c, got in zip(coords, ranks):
        for k in ("loss", "ce", "grad_norm", "lr"):
            np.testing.assert_allclose(float(got["metrics"][k]),
                                       float(port["metrics"][k]), rtol=1e-5,
                                       atol=0, err_msg=k)
        cut = lambda leaves: [sp.local_slice(x, s, c)
                              for x, s in zip(leaves, specs)]
        mu = cut(port["mu"])
        for i, (m, want) in enumerate(zip(got["mu"], mu)):
            _close(m, want, f"mu {i}")
        lt.updated_close(got["params"], cut(port["params"]), mu,
                         port["lr"], adamw.AdamWConfig(**OPT))


@pytest.mark.parametrize("shape,arch", CELLS, ids=IDS)
def test_prefill_and_decode_logits_equal_unsharded(mesh_runs, shape, arch):
    """The prefill's last-position logits and four decode steps' (the
    rank's rows of the batch, the whole vocabulary) against the unsharded
    port's and the reference's, within 1e-4."""
    ref, ranks = mesh_runs[shape, arch]
    for r, got in enumerate(ranks):
        d = r // shape[1]
        rows = slice(d * BATCH // shape[0], (d + 1) * BATCH // shape[0])
        for i, g in enumerate(got["logits"]):
            for who, want in (("port", ref["port"]["logits"][i]),
                              ("jax", ref["jax"]["logits"][i])):
                _close(g, np.asarray(want)[rows],
                       f"{who} rank {r} step {i}")


def expected_bytes(shape, arch):
    """Each rank's weighted collective bytes by kind in the step of two
    micro-batches (``sharding/comm.py``'s weights), counted from the
    shapes: per micro-batch of ``rows`` rows, the FSDP gathers of every
    'data'-sharded leaf at use (the table for the embedding and for each
    head chunk, each layer once and again in its recompute under remat)
    and their reduce-scatters, the gradient all-reduce over 'data' of each
    leaf it keeps whole, and over 'model' the two all-reduces of each
    attention and MLP (the row-parallel output forward, the input's
    gradient backward), the embedding's and the head's, the head's three
    softmax all-reduces, the gathers of K/V columns where the KV heads do
    not divide the axis; then the label count, the three metrics and the
    norm's one all-reduce."""
    n, m = shape
    tc = configs(arch)[1]
    sizes = {"data": n, "model": m}
    params = init_params(tc, device="meta")
    specs = mesh_specs(tc, sizes, "train")
    f = 4   # f32
    rows = BATCH // MICRO // n
    act = rows * SEQ * tc.d_model * f
    ag = rs = ar = 0
    again = 2 if tc.remat else 1    # the recompute's forward

    def leaf(shape_, spec, uses=1, forwards=1):
        nonlocal ag, rs, ar
        local = math.prod(sp.local_shape(shape_, spec, sizes)) * f
        if "data" in spec and n > 1:
            ag += forwards * local * n
            rs += uses * local
        elif n > 1:
            ar += 2 * uses * local
    for p, s in zip(params["blocks"]["s0"], specs["blocks"]["s0"]):
        for name in p:
            if isinstance(p[name], dict):
                for w in p[name]:
                    leaf(p[name][w].shape, s[name][w], forwards=again)
            else:
                leaf(p[name].shape, s[name], forwards=again)
        if m > 1:   # attention's and the MLP's output and input's gradient
            ar += 2 * 2 * act * (again + 1)
            if tc.num_kv_heads % m:
                cols = tc.num_kv_heads * tc.head_dim
                ag += 2 * again * tc.d_model * cols * f
                rs += 2 * tc.d_model * cols // m * f
    table = params["embed"]["table"].shape
    chunks = math.ceil(rows * SEQ / LOSS_CHUNK_ROWS) if tc.remat else 1
    leaf(table, specs["embed"]["table"], uses=1 + chunks,
         forwards=1 + chunks * again)
    leaf(params["final_norm"].shape, specs["final_norm"])
    if m > 1:
        ar += 2 * act + 2 * act   # the embedding's sum, the head's input
        ar += 3 * 2 * rows * SEQ * f * again   # the head's max, sum, label
    if n > 1:
        ar += 2 * 8                # the label count (int64)
    ag, rs, ar = (MICRO * x for x in (ag, rs, ar))
    if n > 1:
        ar += 3 * 2 * f            # loss, ce and aux over the batch shards
    ar += 2 * f                    # the norm's squared sum
    return {k: float(v) for k, v in (("all-gather", ag),
                                     ("reduce-scatter", rs),
                                     ("all-reduce", ar)) if v}


@pytest.mark.parametrize("shape,arch", CELLS, ids=IDS)
def test_collective_bytes_equal_the_count(mesh_runs, shape, arch):
    """Each rank's collective bytes by kind in the step equal
    ``expected_bytes``, and the step moved some."""
    _, ranks = mesh_runs[shape, arch]
    want = expected_bytes(shape, arch)
    assert sum(want.values()) > 0
    for r, got in enumerate(ranks):
        assert got["moved"] == want, r
