"""The dry run on one card: run every (arch x input-shape) step, count its
operations and bytes, time it and write one roofline row per combination.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
      --shape prefill_32k --out artifacts/
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out artifacts/
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \
      mamba2-370m --shape prefill_32k decode_32k --out artifacts/
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \
      --shape train_4k --both-meshes --out artifacts/

The port of ``repro.launch.dryrun`` for one H100.  Where the reference
lowers and compiles each step for a TPU mesh and reads its cost from the
HLO, this runs the step at full width and depth through the model's
entry points (``launch/steps.py``) on ``--device`` (default ``cuda``):

- operations and bytes are counted as the step runs
  (``launch/cost.py``), the hand-written kernels by their analytic counts;
- they are counted on the warm-up step, which therefore runs under
  ``StepCost`` (``compile_s`` includes the count);
- ``measured_step_s`` is the median of ``--reps`` (``REPS``) timed steps
  after the warm-up (CUDA events on the card, the host clock on the
  CPU), and
  ``measured_energy_j`` the roofline's first-order energy over that
  time (``Roofline.energy_over``): the idle draw over the measured step
  plus the draw above idle over its compute term;
- ``peak_memory_gb`` is ``torch.cuda.max_memory_allocated`` over the
  steps, after ``reset_peak_memory_stats`` (not measured on the CPU);
- the roofline terms (``launch/roofline.py``) use the card's record: the
  data sheet's rates, the power limit and the idle draw read from the
  card at rest before the first step.

Each row has the reference's keys with the same meanings: ``mesh`` is
``"1x1"`` (the reference's name of a one-device mesh) and ``chips`` 1;
``lower_s`` is the time to draw the inputs (and the weights, when not
given), ``compile_s`` the warm-up step's (it builds or loads the
kernels).  It drops ``xla_flops`` and ``xla_bytes`` and adds
``global_batch`` (the batch it ran), ``measured_step_s``,
``measured_energy_j``, ``peak_memory_gb`` and ``device`` (the card's
name and power limit; on the CPU, ``cpu``).  Rows are appended to
``--out``/dryrun.jsonl, which ``serving/pool.py::pool_table_from_dryrun``
reads: it routes on the measured step where a row has one.

Batch size: a prefill row runs batch 1 (one sequence is one request).
A training row runs the reference's gradient accumulation,
``MICROBATCHES[arch]`` micro-batches (4 for an arch it does not name, at
most the shape's ``global_batch``), each of one sequence: the
activation memory of one sequence, and the accumulation loop the
reference lowers; ``global_batch`` is then the micro-batch count.  A
decode row runs the largest power of two up to the shape's
``global_batch`` whose weights and cache fit in 3/4 of the card's
memory, counted from the shapes (``init_params`` and ``init_cache`` on
the meta device) before anything is allocated.

Skip rows: ``long_500k`` for a model that is not sub-quadratic, with the
reference's reason; a training row whose f32 parameters, gradient and
AdamW moments (16 bytes a parameter: ``make_train_step`` accumulates the
micro-batches in the one gradient) do not fit in 3/4 of the card's
memory, or whose step does not: its peak with one micro-batch's
activations, measured by running it on the meta device
(``train_step_bytes``, which counts the model's rematerialisation:
``cfg.remat``); a prefill row whose weights, or whose step's peak
measured the same way (``prefill_step_bytes``), do not; a decode row
whose weights and one sequence's cache do not.  Any other exception
writes a ``"fail"`` row, and ``main`` returns 1.

Mesh rows (``--mesh 16x16``, ``--multi-pod`` for 2x16x16,
``--both-meshes`` for both; the reference's production meshes): ``main``
initialises ``torch.distributed``'s fake process group of a mesh's size
with this process as its rank 0 (``fake_mesh``: the counterpart of the
reference's simulated devices; the process must have no process group
of its own), runs the mesh's rows and destroys the group.  A row is rank
0's step on ``--device``: its weights, AdamW state, cache and batch rows
are its shards (``models.init_shards``, ``steps.decode_inputs(...,
mesh)``), the global batch the shape's (``global_batch``: a training row
splits it into ``MICROBATCHES[arch]`` micro-batches, each over the batch
axes).  Its counted operations and bytes are rank 0's, its collective
bytes by kind those of ``sharding/comm.py`` (the roofline's collective
term), its peak rank 0's.  The fake group's collectives move nothing and
return at once, their outputs holding whatever memory they were given:
so ``measured_step_s`` is rank 0's compute alone (``measured_scope`` says
so, and routing reads the roofline's step for such a row), and a mesh
row checks its outputs' shapes, never their values.  A mesh row skips
where the rank's f32 masters, gradient and moments, or its weights (and
a decode row's cache shard), pass 3/4 of the card, and for the families
the port does not shard yet (``models.check_mesh``).
"""
import argparse
import dataclasses
import functools
import json
import math
import os
import statistics
import sys
import time
import traceback
from typing import Optional

import torch

from repro_torch.configs import get_config, list_configs
from repro_torch.device import resolve_device
from repro_torch.launch import roofline as rl
from repro_torch.launch import steps as st
from repro_torch.launch.cost import StepBytes, StepCost
from repro_torch.launch.mesh import make_mesh, mesh_name
from repro_torch.models import init_cache, init_params
from repro_torch.models.base import INPUT_SHAPES, InputShape
from repro_torch.models.model import (check_mesh, init_shards, leaf_specs,
                                      mesh_specs)
from repro_torch.optim.adamw import AdamWConfig, init_opt_state, tree_leaves
from repro_torch.sharding import comm
from repro_torch.sharding import specs as sp

# per-arch gradient-accumulation factor for train_4k (the reference's)
MICROBATCHES = {
    "llava-next-34b": 16,
    "llama3-8b": 8, "llama3-8b-swa": 8,
    "gemma2-9b": 8, "gemma2-9b-swa": 8,
    "deepseek-7b": 8,
    "qwen2.5-3b": 4,
    "deepseek-v2-lite-16b": 4,
    "recurrentgemma-2b": 4,
    "mamba2-370m": 4,
    "granite-moe-1b-a400m": 8,
    "whisper-small": 16,
}
#: the reference's name of a one-device mesh (``launch/mesh.py``)
MESH = "1x1"
#: what a mesh row's measured step is
MESH_SCOPE = ("rank 0's compute alone: the fake process group moves no "
              "data")
#: timed steps after the warm-up (``--reps``)
REPS = 3
#: the seed of the weights and the inputs
SEED = 0
#: the share of the card's memory a step's weights and state may take
FIT = 0.75
#: bytes a training parameter holds: f32 master, gradient (the
#: micro-batches' sum, accumulated in place), two moments
TRAIN_BYTES_PER_PARAM = 16


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def weight_bytes(cfg) -> int:
    """Bytes of the serving weights (``init_params`` on the meta
    device)."""
    return _bytes(tree_leaves(init_params(cfg, device="meta")))


def cache_bytes(cfg, batch: int, seq_len: int) -> int:
    """Bytes of a decode cache of ``batch`` sequences of ``seq_len``
    positions (``init_cache`` on the meta device)."""
    return _bytes(st.cache_tensors(init_cache(cfg, batch, seq_len,
                                              cfg.adtype, "meta")))


@functools.lru_cache(maxsize=None)
def train_step_bytes(cfg, shape: InputShape) -> int:
    """The most bytes a training step of ``shape``'s rows holds at once,
    measured on the meta device (``StepBytes``; 4-11 s at full size on 8
    CPU threads, so kept for the next caller): the f32 masters, the AdamW
    moments and the batch, and a step of two micro-batches of one
    sequence, the second, as every later one, beside the first's
    accumulated gradients, and the update.  The kernels' wrappers
    allocate there what they allocate on the card; a library's workspace
    is not counted."""
    params = init_params(cfg, SEED, "meta", keep_f32=True)
    state = init_opt_state(params)
    data = st.batch_inputs(cfg, shape, 2, device="meta")
    with StepBytes(tree_leaves(params) + tree_leaves(state)
                   + list(data.values())) as mem:
        st.make_train_step(cfg, AdamWConfig(), num_microbatches=2)(
            params, state, data)
    return mem.peak


@functools.lru_cache(maxsize=None)
def prefill_step_bytes(cfg, shape: InputShape) -> int:
    """The most bytes a prefill step of one ``shape.seq_len``-token
    sequence holds at once (its serving weights, its inputs, the cache it
    fills and its activations), measured on the meta device under
    ``no_grad`` as ``train_step_bytes`` measures a training step, and kept
    for the next caller."""
    params = init_params(cfg, SEED, "meta")
    data = st.batch_inputs(cfg, shape, 1, device="meta")
    with torch.no_grad(), StepBytes(tree_leaves(params)
                                    + list(data.values())) as mem:
        st.make_prefill_step(cfg)(params, data)
    return mem.peak


def microbatches(cfg, shape: InputShape) -> int:
    """A training row's micro-batch count (``MICROBATCHES``)."""
    return min(MICROBATCHES.get(cfg.name, 4), shape.global_batch)


def local_rows(batch: int, mesh) -> int:
    """Rank 0's rows of a global batch (``specs.batch_spec``: all of them
    where the batch shards do not divide it, or without a mesh)."""
    n = 1 if mesh is None else sp.batch_shards(mesh)
    return batch // n if batch % n == 0 else batch


def run_batch(cfg, shape: InputShape, chip: rl.Chip, mesh=None) -> int:
    """The batch a row runs (the module docstring's rule): a mesh row's
    global batch, the shape's; a training row's micro-batches of one
    sequence; 0 when a decode row's weights and one sequence's cache do
    not fit."""
    if mesh is not None:
        return shape.global_batch
    if shape.kind == "train":
        return microbatches(cfg, shape)
    if shape.kind == "prefill":
        return 1
    room = FIT * chip.memory_bytes - weight_bytes(cfg)
    batch = 1 << (shape.global_batch.bit_length() - 1)
    while batch and cache_bytes(cfg, batch, shape.seq_len) > room:
        batch //= 2
    return batch


def skip_reason(cfg, shape, chip: rl.Chip, mesh=None) -> Optional[str]:
    """Why a combination is not run on ``chip`` (as rank 0 of ``mesh``),
    or None."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return ("long_500k requires sub-quadratic attention; "
                f"{cfg.name} has unbounded full-attention layers "
                "(see DESIGN.md §5)")
    if mesh is not None:
        return _shard_skip_reason(cfg, shape, chip, mesh)
    gib = FIT * chip.memory_bytes / 2**30
    if shape.kind == "train":
        total = rl.count_params(cfg)["total"]
        if TRAIN_BYTES_PER_PARAM * total > FIT * chip.memory_bytes:
            return (f"train: {total / 1e9:.2f} G parameters hold "
                    f"{TRAIN_BYTES_PER_PARAM * total / 2**30:.1f} GiB in "
                    "f32 masters, gradients and AdamW moments, over "
                    f"{gib:.1f} GiB (3/4 of {chip.name})")
        peak = train_step_bytes(cfg, shape)
        if peak > FIT * chip.memory_bytes:
            return (f"train: a step of {shape.seq_len}-token micro-batches "
                    f"holds {peak / 2**30:.1f} GiB at its peak (on the meta "
                    f"device: {TRAIN_BYTES_PER_PARAM * total / 2**30:.1f} "
                    "GiB of f32 masters, gradients and AdamW moments, the "
                    f"rest one micro-batch's activations), over {gib:.1f} "
                    f"GiB (3/4 of {chip.name})")
    elif shape.kind == "prefill":
        weights = weight_bytes(cfg)
        if weights > FIT * chip.memory_bytes:
            return (f"prefill: {weights / 2**30:.1f} GiB of weights, over "
                    f"{gib:.1f} GiB (3/4 of {chip.name})")
        peak = prefill_step_bytes(cfg, shape)
        if peak > FIT * chip.memory_bytes:
            return (f"prefill: a {shape.seq_len}-token prompt holds "
                    f"{peak / 2**30:.1f} GiB at its peak (on the meta "
                    f"device: {weights / 2**30:.1f} GiB of weights, the "
                    f"rest its cache and activations), over {gib:.1f} GiB "
                    f"(3/4 of {chip.name})")
    elif shape.kind == "decode" and not run_batch(cfg, shape, chip):
        return (f"decode: the weights and one {shape.seq_len}-position "
                f"cache do not fit in {gib:.1f} GiB (3/4 of {chip.name})")
    return None


def _step(cfg, shape, batch, params, dev, mesh=None):
    """(run, check): ``run()`` takes one step of ``batch`` rows (a
    training row's in ``microbatches``) and returns its loss or logits;
    ``check(out)`` raises unless the output is shaped right and, without
    a mesh, finite (the fake group's outputs hold no values)."""
    data = st.batch_inputs(cfg, shape, batch, seed=SEED, device=dev)
    if shape.kind == "train":
        step = st.make_train_step(cfg, AdamWConfig(),
                                  microbatches(cfg, shape), mesh=mesh)
        state = [params, init_opt_state(params)]

        def run():
            state[0], state[1], metrics = step(*state, data)
            return metrics["loss"]
        want = ()
    elif shape.kind == "prefill":
        step = st.make_prefill_step(cfg, mesh)

        def run():
            with torch.no_grad():
                return step(params, data)[0]
        want = (local_rows(batch, mesh), 1, cfg.vocab_size)
    else:
        step = st.make_decode_step(cfg, mesh)
        token, cache = st.decode_inputs(cfg, shape, batch, seed=SEED,
                                        device=dev, mesh=mesh)
        pos = cache["pos"]

        def run():
            cache["pos"] = pos    # each step writes the same last row
            with torch.no_grad():
                return step(params, token, cache)[0]
        want = (local_rows(batch, mesh), 1, cfg.vocab_size)

    def check(out):
        if tuple(out.shape) != want or (mesh is None and not bool(
                torch.isfinite(out).all())):
            raise FloatingPointError(f"{cfg.name}: output of shape "
                                     f"{tuple(out.shape)}, not {want}, or "
                                     "not finite")
    return run, check


def _timed(run, dev, reps):
    """Median seconds of ``reps`` steps."""
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            run()
            times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _largest(counts, total, n=3) -> str:
    """The ``n`` largest kinds of ``counts`` with their shares of
    ``total``."""
    return ", ".join(f"{k} {v / total:.1%}" for k, v in
                     counts.most_common(n)) if total else "none"


def run_combo(arch: str, shape, *, cfg=None, device="cuda",
              chip: Optional[rl.Chip] = None, params=None, mesh=None,
              reps: int = REPS):
    """One row for ``arch`` (``cfg``, when given, in place of its
    published config) at ``shape`` (a name of ``INPUT_SHAPES`` or an
    ``InputShape``) on ``device``, timed over ``reps`` steps.  ``chip``
    defaults to the card's record (``roofline.h100``); ``params`` are
    serving weights to reuse (drawn from ``SEED`` when None; a training
    row always draws f32 masters).  The inputs are drawn from ``SEED``
    too.  With ``mesh`` (a ``DeviceMesh`` over the fake process group,
    ``fake_mesh``) the row is rank 0's, its weights its shards."""
    cfg = cfg or get_config(arch)
    shape = INPUT_SHAPES[shape] if isinstance(shape, str) else shape
    dev = resolve_device(device)
    chip = chip or rl.h100(dev)
    name, chips = (MESH, 1) if mesh is None else (mesh_name(mesh),
                                                 mesh.size())
    reason = skip_reason(cfg, shape, chip, mesh)
    if reason:
        return {"arch": arch, "shape": shape.name, "mesh": name,
                "status": "skip", "reason": reason}
    batch = run_batch(cfg, shape, chip, mesh)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    train = shape.kind == "train"
    if mesh is not None:
        params = init_shards(cfg, mesh, SEED, dev, keep_f32=train)
    elif train:
        params = init_params(cfg, SEED, dev, keep_f32=True)
    elif params is None:
        params = init_params(cfg, SEED, dev)
    run, check = _step(cfg, shape, batch, params, dev, mesh)
    _sync(dev)
    t1 = time.perf_counter()
    comm.reset()
    with StepCost() as cost:   # the warm-up, counted
        check(run())
    moved = comm.by_kind()
    _sync(dev)
    t2 = time.perf_counter()
    measured = _timed(run, dev, reps)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    del run, check

    counts = rl.count_params(cfg)
    r = rl.Roofline(
        arch=arch, shape=shape.name, mesh=name, chips=chips,
        flops=cost.flops, bytes_accessed=cost.bytes,
        coll_bytes=float(sum(moved.values())), coll_by_kind=moved,
        per_device_memory=peak or 0.0,
        model_flops=rl.model_flops(cfg, dataclasses.replace(
            shape, global_batch=batch), counts["total"], counts["active"]),
        chip=chip)
    row = r.row()
    row.update(status="ok", lower_s=round(t1 - t0, 1),
               compile_s=round(t2 - t1, 1),
               params_total=counts["total"], params_active=counts["active"],
               global_batch=batch, measured_step_s=measured,
               measured_energy_j=r.energy_over(measured),
               peak_memory_gb=None if peak is None else peak / 2**30,
               device=chip.name if dev.type == "cuda" else "cpu")
    if mesh is not None:
        row["measured_scope"] = MESH_SCOPE
    if peak is None:
        row["per_device_memory_gb"] = None   # not measured on the CPU
    print(f"--- {arch} x {shape.name} x {name} on {row['device']}, batch "
          f"{batch}" + ("" if mesh is None else f" (rank 0 of {chips}: "
                        f"{local_rows(batch, mesh)} rows)") + " ---")
    print(f"counted: flops={r.flops:.4e} bytes={r.bytes_accessed:.4e} "
          f"collective={r.coll_bytes:.4e} {moved}; largest ops "
          f"{_largest(cost.by_kind, cost.flops)}; largest bytes "
          f"{_largest(cost.bytes_by_kind, cost.bytes)}")
    print(f"roofline: compute={r.t_compute*1e3:.3f}ms "
          f"memory={r.t_memory*1e3:.3f}ms collective="
          f"{r.t_collective*1e3:.3f}ms -> {r.bottleneck}-bound; "
          f"useful-flops={r.useful_flops_ratio:.2f}; "
          f"energy={r.energy_j:.4g} J")
    print(f"measured{'' if mesh is None else f' ({MESH_SCOPE})'}: "
          f"{measured*1e3:.3f} ms a step (median of {reps}), roofline "
          f"share {r.t_step / measured:.1%}, energy "
          f"{row['measured_energy_j']:.4g} J, peak memory "
          + ("not measured" if peak is None else f"{peak / 2**30:.2f} GiB"))
    return row


def fake_mesh(name: str, device="cuda"):
    """A mesh named ``name`` ("16x16", "2x16x16", "2x2"; axes (data,
    model), or (pod, data, model) for three dims) over ``torch.distributed``'s
    fake process group of its size, this process its rank 0 (it must have
    no process group: ``init_process_group`` raises)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    shape = tuple(int(x) for x in name.split("x"))
    axes = ("pod", "data", "model")[-len(shape):]
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    return make_mesh(shape, axes, device)


def _shard_bytes(cfg, mesh, mode: str) -> int:
    """Bytes of rank 0's shards of the tree (``mode``'s specs; f32 masters
    for "train", serving weights for "serve")."""
    meta = tree_leaves(init_params(cfg, device="meta",
                                   keep_f32=mode == "train"))
    specs = leaf_specs(mesh_specs(cfg, mesh, mode))
    return sum(math.prod(sp.local_shape(x.shape, s, mesh)) * x.element_size()
               for x, s in zip(meta, specs))


def _shard_skip_reason(cfg, shape, chip: rl.Chip, mesh) -> Optional[str]:
    """``skip_reason`` of a mesh row: the module docstring's rule on rank
    0's shards."""
    try:
        check_mesh(cfg, mesh)
    except ValueError as e:
        return f"mesh: {e}"
    room = FIT * chip.memory_bytes
    if shape.kind == "train":
        held = TRAIN_BYTES_PER_PARAM // 4 * _shard_bytes(cfg, mesh, "train")
        what = "f32 masters, gradients and AdamW moments"
    else:
        held = _shard_bytes(cfg, mesh, "serve")
        what = "weights"
        if shape.kind == "decode":
            held += _bytes(st.cache_tensors(init_cache(
                cfg, local_rows(shape.global_batch, mesh), shape.seq_len,
                cfg.adtype, "meta", mesh)))
            what += " and cache"
    if held > room:
        return (f"{shape.kind}: rank 0's {what} hold {held / 2**30:.1f} "
                f"GiB, over {room / 2**30:.1f} GiB (3/4 of {chip.name})")
    return None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=None)
    ap.add_argument("--shape", nargs="+", default=None,
                    choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--include-variants", action="store_true")
    ap.add_argument("--out", default="artifacts")
    ap.add_argument("--device", default="cuda",
                    help="where the steps run (default cuda; without a "
                         "GPU pass cpu: the roofline then uses the data "
                         "sheet's rates)")
    ap.add_argument("--mesh", default=MESH,
                    help="1x1 (default: the card itself), or a mesh whose "
                         "rank 0 runs under the fake process group, e.g. "
                         "16x16 or 2x16x16")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2x16x16 mesh")
    ap.add_argument("--both-meshes", action="store_true",
                    help="the 16x16 and the 2x16x16 mesh")
    ap.add_argument("--reps", type=int, default=REPS,
                    help=f"timed steps a row after its warm-up (default "
                         f"{REPS})")
    args = ap.parse_args(argv)

    archs = (args.arch if args.arch
             else list_configs(include_variants=args.include_variants))
    shapes = args.shape if args.shape else list(INPUT_SHAPES)
    meshes = (["16x16", "2x16x16"] if args.both_meshes else
              ["2x16x16"] if args.multi_pod else [args.mesh])
    failures = sum(_rows(archs, shapes, args, name) for name in meshes)
    return 1 if failures else 0


def _rows(archs, shapes, args, name) -> int:
    """Appends every (arch, shape) row of mesh ``name`` to
    ``--out``/dryrun.jsonl; returns the failures.  A mesh other than 1x1
    runs under the fake process group, destroyed after its rows."""
    import torch.distributed as dist
    dev = resolve_device(args.device)
    mesh = None if name == MESH else fake_mesh(name, dev)
    try:
        return _write_rows(archs, shapes, args, dev, mesh)
    finally:
        if mesh is not None:
            dist.destroy_process_group()


def _write_rows(archs, shapes, args, dev, mesh) -> int:
    chip = rl.h100(dev)    # at rest: its power draw is the idle draw
    if dev.type == "cuda":
        print(f"card: {chip.name}; idle draw {chip.power_idle} W")

    os.makedirs(args.out, exist_ok=True)
    out_path = os.path.join(args.out, "dryrun.jsonl")
    failures = 0
    with open(out_path, "a") as f:
        for arch in archs:
            params = None    # serving weights, shared by the arch's rows
            for shape in shapes:
                try:
                    cfg = get_config(arch)
                    if (mesh is None and params is None
                            and INPUT_SHAPES[shape].kind != "train"
                            and not skip_reason(cfg, INPUT_SHAPES[shape],
                                                chip)):
                        params = init_params(cfg, SEED, dev)
                    row = run_combo(arch, shape, device=dev, chip=chip,
                                    params=params, mesh=mesh,
                                    reps=args.reps)
                except Exception as e:  # a failure here is a bug: report
                    traceback.print_exc()
                    row = {"arch": arch, "shape": shape,
                           "mesh": MESH if mesh is None else mesh_name(mesh),
                           "status": "fail", "error": repr(e)}
                    failures += 1
                f.write(json.dumps(row) + "\n")
                f.flush()
            del params
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    print(f"wrote {out_path}")
    return failures


if __name__ == "__main__":
    sys.exit(main())
