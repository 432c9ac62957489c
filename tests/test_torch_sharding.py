"""The port's parallel layer against the reference's rules, on the CPU:
``sharding/specs.py`` (every leaf of every dense config at full size, on
the meta device, in both modes, on both production meshes, against
``repro.sharding.specs.spec_for_param`` of its stacked leaf; batch specs,
decode cache layouts and cache specs), ``sharding/ctx.py``'s no-op cases
of ``tests/test_sharding.py``, ``launch/mesh.py``'s refusals, and one
dry-run mesh row under the fake process group (a reduced config on a
2 x 2 mesh, in a process of its own) with the reference's row keys.
"""
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import roofline as jax_rl
from repro.launch import steps as jax_steps
from repro.models.base import INPUT_SHAPES as JAX_SHAPES
from repro.sharding import specs as jax_sp
from repro_torch.configs import get_config
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import init_cache, init_params
from repro_torch.models.model import leaf_specs
from repro_torch.optim.adamw import tree_leaves, tree_paths
from repro_torch.sharding import ctx
from repro_torch.sharding import specs as sp

torch.set_num_threads(1)

DENSE = ("llama3-8b", "llama3-8b-swa", "deepseek-7b", "gemma2-9b",
         "gemma2-9b-swa", "qwen2.5-3b")
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
ROOT = Path(__file__).resolve().parent.parent


def jax_mesh(sizes):
    """What the reference's rules read of a mesh."""
    return types.SimpleNamespace(shape=dict(sizes),
                                 axis_names=tuple(sizes))


def same(spec):
    """A spec with each one-axis tuple entry as that axis's name (JAX's
    ``PartitionSpec`` keeps ("data",) as "data")."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def reference_path(cfg, path):
    """(the reference's path of the port's leaf ``path``, its layer's
    stack index or None): layer i is block i // n's slot i % n."""
    parts = path.split("/")
    if parts[0] != "blocks":
        return path, None
    i, n = int(parts[2]), len(cfg.block_layout)
    return "/".join(["blocks", f"s{i % n}"] + parts[3:]), i // n


@pytest.mark.parametrize("mesh", tuple(MESHES))
@pytest.mark.parametrize("mode", ("train", "serve"))
@pytest.mark.parametrize("arch", DENSE)
def test_every_leaf_gets_the_reference_spec(arch, mode, mesh):
    cfg = get_config(arch)
    sizes = MESHES[mesh]
    params = init_params(cfg, device="meta", keep_f32=mode == "train")
    specs = sp.param_specs(params, mode=mode, mesh=sizes)
    spec_of = dict(zip(tree_paths(params), leaf_specs(specs)))
    checked = 0
    for path, leaf in zip(tree_paths(params), tree_leaves(params)):
        ref_path, index = reference_path(cfg, path)
        shape = tuple(leaf.shape)
        if index is None:
            want = tuple(jax_sp.spec_for_param(ref_path, shape, mode=mode,
                                               mesh=jax_mesh(sizes)))
        else:
            stacked = (cfg.n_blocks,) + shape
            want = tuple(jax_sp.spec_for_param(
                ref_path, stacked, mode=mode, mesh=jax_mesh(sizes)))
            assert want[0] is None, path
            want = want[1:]
        want = want + (None,) * (len(shape) - len(want))
        assert spec_of[path] == want, path
        checked += 1
    assert checked == len(tree_leaves(params)) > 4 * cfg.num_layers


BATCHES = [(m, b, nd) for m in MESHES for b in (1, 8, 16, 32, 128, 256)
           for nd in (2, 3)]


@pytest.mark.parametrize("mesh,global_batch,ndim", BATCHES)
def test_batch_spec_is_the_reference_s(mesh, global_batch, ndim):
    sizes = MESHES[mesh]
    want = tuple(jax_sp.batch_spec(jax_mesh(sizes), global_batch, ndim))
    assert same(sp.batch_spec(sizes, global_batch, ndim)) == same(want)
    assert sp.batch_axes(sizes) == jax_sp.batch_axes(jax_mesh(sizes))


LAYOUTS = [(kv, seq, m) for kv in (1, 2, 8, 16, 32) for seq in (40, 4096,
                                                               32768)
           for m in (1, 2, 4, 16)]


@pytest.mark.parametrize("kv,seq,m", LAYOUTS)
def test_decode_cache_layout_is_the_reference_s(kv, seq, m):
    sizes = {"data": 1, "model": m}
    assert sp.decode_cache_layout(kv, seq, sizes) == \
        jax_sp.decode_cache_layout(kv, seq, jax_mesh(sizes))
    assert sp.decode_cache_layout(kv, seq, {"data": 4}) == "none"


@pytest.mark.parametrize("mesh", tuple(MESHES))
@pytest.mark.parametrize("arch", DENSE)
def test_cache_specs_are_the_reference_s(arch, mesh):
    """Each attention layer's K/V spec at ``decode_32k`` (the reference's
    [n, B, W, KV, hd] with W and KV swapped into the port's [B, KV, T,
    hd], without the stacked dim for the port's per-layer entries), and
    ``pos`` replicated."""
    sizes = MESHES[mesh]
    shape = JAX_SHAPES["decode_32k"]
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    cache = init_cache(cfg, shape.global_batch, shape.seq_len, cfg.adtype,
                       "meta")
    got = sp.cache_specs(cache, sizes, shape.global_batch)
    want = jax_sp.cache_specs(jax_steps.cache_structs(jcfg, shape),
                              jax_mesh(sizes), shape.global_batch)
    swap = lambda s: (s[0], s[1], s[3], s[2], s[4])
    entries = got["blocks"]["s0"]
    if isinstance(entries, list):
        n = len(cfg.block_layout)
        for i, e in enumerate(entries):
            ref = swap(tuple(want["blocks"][f"s{i % n}"].k))[1:]
            assert same(e.k) == same(e.v) == same(ref), i
    else:
        ref = swap(tuple(want["blocks"]["s0"].k))
        assert same(entries.k) == same(entries.v) == same(ref)
    assert tuple(want["pos"]) == () and got["pos"] is None


def test_ctx_noop_outside_context():
    x = torch.ones(4, 8)
    assert ctx.constrain_batch(x) is x
    assert ctx.batch_axes() is None and ctx.current_mesh() is None
    assert ctx.current_mode() == "train"


def test_ctx_inside_context():
    mesh = object()
    with ctx.activation_sharding(("data",), mesh=mesh, mode="serve"):
        x = torch.ones(3, 8)  # 3 % 16 != 0
        assert ctx.constrain_batch(x) is x
        assert ctx.batch_axes() == ("data",)
        assert ctx.current_mesh() is mesh and ctx.current_mode() == "serve"
    assert ctx.current_mesh() is None


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        mesh_mod.make_production_mesh(device="cpu")


#: run in a process of its own: the fake process group is one a process
MESH_ROW = r"""
import json, sys
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, mesh, roofline as rl
from repro_torch.models.base import InputShape
m = dryrun.fake_mesh("2x2", "cpu")
refusals = []
for fn in (lambda: mesh.make_production_mesh(device="cpu"),
           lambda: mesh.make_mesh((2, 2), ("data", "model"), "cuda")):
    try:
        fn()
    except (ValueError, RuntimeError) as e:
        refusals.append(type(e).__name__)
cfg = get_config("llama3-8b").reduced(num_layers=2)
rows = [dryrun.run_combo("llama3-8b", s, cfg=cfg, device="cpu",
                         chip=rl.h100("cpu"), mesh=m)
        for s in (InputShape("train_4k", 32, 8, "train"),
                  InputShape("prefill_32k", 32, 4, "prefill"),
                  InputShape("decode_32k", 32, 4, "decode"))]
print(json.dumps({"refusals": refusals, "rows": rows}))
"""


def test_a_mesh_row_under_the_fake_group():
    """Rank 0's training, prefill and decode rows of a reduced llama3-8b
    on a 2 x 2 mesh: the reference's row keys, ``mesh`` "2x2", 4 chips,
    collective bytes above 0 (all-gathers, reduce-scatters and
    all-reduces in training) with their term over the NVLink rate;
    ``make_mesh`` refused a world of another size and a mesh on cuda
    without a GPU."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", MESH_ROW], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    got = json.loads(out.strip().splitlines()[-1])
    assert got["refusals"] == ["ValueError", "RuntimeError"]
    ref = jax_rl.Roofline("a", "s", "16x16", 256, 1.0, 1.0, 1.0, {}, 1.0,
                          1.0).row()
    keys = set(ref) | {"status", "lower_s", "compile_s", "params_total",
                       "params_active"}
    for row in got["rows"]:
        assert keys <= set(row) and row["status"] == "ok", row
        assert row["mesh"] == "2x2" and row["chips"] == 4
        assert row["measured_scope"].startswith("rank 0's compute alone")
        assert row["coll_bytes_per_chip"] == sum(
            row["coll_by_kind"].values()) > 0
        assert row["t_collective_s"] == pytest.approx(
            row["coll_bytes_per_chip"] / 450e9, rel=1e-12)
    assert set(got["rows"][0]["coll_by_kind"]) == {
        "all-gather", "reduce-scatter", "all-reduce"}
    assert [r["global_batch"] for r in got["rows"]] == [8, 4, 4]


#: ``dryrun.main`` over three meshes in one process, reduced configs
MESH_MAIN = r"""
import json, sys
import torch.distributed as dist
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.models.base import InputShape
dryrun.get_config = lambda a: get_config(a).reduced(num_layers=2)
dryrun.INPUT_SHAPES = {"prefill_32k": InputShape("prefill_32k", 32, 4,
                                                 "prefill")}
common = ["--arch", "llama3-8b", "--shape", "prefill_32k", "--device", "cpu",
          "--reps", "1", "--out", sys.argv[1]]
rcs = [dryrun.main(common + ["--both-meshes"]),
       dryrun.main(common + ["--mesh", "2x2"])]
print(json.dumps({"rcs": rcs, "group": dist.is_initialized()}))
"""


def test_main_runs_meshes_one_after_another(tmp_path):
    """``dryrun.main`` destroys each mesh's fake group after its rows, so
    one process runs ``--both-meshes`` (the reduced llama3-8b's 4 heads do
    not divide a 16-way 'model' axis: two skip rows, without a step) and
    then a 2 x 2 mesh (an ``ok`` row of 4 chips), and ends with no
    process group."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", MESH_MAIN, str(tmp_path)],
                         env=env, capture_output=True, text=True,
                         timeout=300, check=True).stdout
    assert json.loads(out.strip().splitlines()[-1]) == {"rcs": [0, 0],
                                                        "group": False}
    rows = [json.loads(x) for x in
            (tmp_path / "dryrun.jsonl").read_text().splitlines()]
    assert [(r["mesh"], r["status"]) for r in rows] == [
        ("16x16", "skip"), ("2x16x16", "skip"), ("2x2", "ok")]
    assert rows[0]["reason"].startswith("mesh: ")
    assert rows[2]["chips"] == 4 and rows[2]["measured_scope"] == \
        "rank 0's compute alone: the fake process group moves no data"
