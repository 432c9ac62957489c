"""The port's dry run (``repro_torch.launch.dryrun``, ``roofline``,
``cost``, the serving steps of ``launch/steps.py``, ``INPUT_SHAPES`` and
``core/energy.py::roofline_backend_profile``) against the JAX package's,
on the CPU.

The shapes and parameter counts are equal; the roofline arithmetic
equals the reference's to 1e-12 relative when the port's ``Roofline`` is
given the reference's TPU constants as a ``Chip``; the prefill and
decode steps of reduced f32 configs give the JAX steps' logits within
1e-4 (atol and rtol), the weights carried across by ``params_from_jax``.
The step cost counter's matrix products are held to a hand count within
1 %.  The JAX steps are built directly: ``repro.launch.dryrun`` sets
``XLA_FLAGS`` when imported, so it is never imported here.
"""
import dataclasses
import json
import math
import subprocess
import types
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_llm import _configs, _params

from repro.configs import get_config as jax_get_config
from repro.configs import list_configs as jax_list_configs
from repro.core import energy as jax_energy
from repro.launch import roofline as jax_rl
from repro.launch import steps as jax_steps
from repro.models import prefill as jax_prefill
from repro.models.base import INPUT_SHAPES as JAX_SHAPES
from repro_torch.configs import get_config
from repro_torch.core.energy import roofline_backend_profile
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.launch import dryrun, roofline as rl, serve
from repro_torch.launch import steps as st
from repro_torch.launch.cost import StepBytes, StepCost
from repro_torch.models import init_params, loss_fn, prefill
from repro_torch.models import moe
from repro_torch.models.base import INPUT_SHAPES, InputShape
from repro_torch.optim.adamw import (adamw_update, init_opt_state,
                                     tree_leaves, tree_unflatten)
from repro_torch.serving import pool

torch.set_num_threads(1)

#: the reference's TPU v5e constants (``repro.launch.roofline``)
TPU = rl.Chip("tpu-v5e", jax_rl.PEAK_FLOPS, jax_rl.HBM_BW, jax_rl.LINK_BW,
              jax_rl.CHIP_POWER_IDLE, jax_rl.CHIP_POWER_PEAK)
#: the reference's row keys (``run_combo``)
REF_KEYS = set(jax_rl.Roofline("a", "s", "m", 1, 1.0, 1.0, 0.0, {}, 0.0,
                               1.0).row()) | {
    "status", "lower_s", "compile_s", "params_total", "params_active",
    "xla_flops", "xla_bytes"}
SMALL = {"prefill": InputShape("prefill_32k", 32, 2, "prefill"),
         "decode": InputShape("decode_32k", 32, 4, "decode"),
         "train": InputShape("train_4k", 32, 2, "train")}


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=1e-4,
                               rtol=1e-4)


def test_input_shapes_equal_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()}


@pytest.mark.parametrize("arch", jax_list_configs(include_variants=True))
def test_count_params_equals_the_reference(arch):
    assert rl.count_params(get_config(arch)) == \
        jax_rl.count_params(jax_get_config(arch))


def test_count_params_allocates_nothing():
    leaves = tree_leaves(init_params(get_config("llava-next-34b"),
                                     device="meta"))
    assert leaves and all(t.device.type == "meta" for t in leaves)


@pytest.mark.parametrize("flops,bytes_,coll", [
    (197e12, 819e9, 50e9), (1e12, 819e9 * 10, 1e9), (1e10, 819e9, 0.0),
    (197e12 * 0.9, 819e9, 2e11), (0.0, 0.0, 0.0)])
def test_roofline_arithmetic_equals_the_reference(flops, bytes_, coll):
    kw = dict(arch="a", shape="s", mesh="16x16", chips=256, flops=flops,
              bytes_accessed=bytes_, coll_bytes=coll,
              coll_by_kind={"all-reduce": coll}, per_device_memory=8e9,
              model_flops=flops * 256 * 0.5)
    want = jax_rl.Roofline(**kw).row()
    got = rl.Roofline(**kw, chip=TPU).row()
    assert got.keys() == want.keys()
    for k, w in want.items():
        if isinstance(w, float):
            assert got[k] == pytest.approx(w, rel=1e-12, abs=0), k
        else:
            assert got[k] == w, k
    for per in (1, 32, 128):
        a = roofline_backend_profile(got, requests_per_step=per)
        b = jax_energy.roofline_backend_profile(want, requests_per_step=per)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k] == pytest.approx(b[k], rel=1e-12, abs=0)


def test_one_card_has_no_collective_term():
    r = rl.Roofline("a", "s", dryrun.MESH, 1, 1e12, 1e9, 5e9, {}, 0.0, 1e12,
                    chip=rl.h100("cpu"))
    assert r.t_collective == 0.0 and r.bottleneck == "compute"
    assert r.t_compute == pytest.approx(1e12 / 989e12, rel=1e-12)


@pytest.mark.parametrize("flops,bytes_", [(1e12, 1e9), (1e9, 1e12),
                                          (0.0, 0.0)])
def test_energy_over_a_measured_step(flops, bytes_):
    """``energy_over(t_step)`` is ``energy_j``; a longer step adds the idle
    draw over the difference."""
    chip = rl.Chip("card", 989e12, 3.35e12, None, 120.0, 700.0)
    r = rl.Roofline("a", "s", dryrun.MESH, 1, flops, bytes_, 0.0, {}, 0.0,
                    flops, chip=chip)
    assert r.energy_over(r.t_step) == pytest.approx(r.energy_j, rel=1e-12,
                                                    abs=1e-15)
    assert r.energy_over(r.t_step + 0.5) == pytest.approx(
        r.energy_j + 0.5 * 120.0, rel=1e-12)


def test_the_card_record_reads_its_rest(monkeypatch):
    """``h100`` on a card: nvidia-smi's name and limit, the least of its
    draws as the idle power, the card's memory; a failing nvidia-smi
    raises.  (nvidia-smi and the card stubbed: this machine has none.)"""
    draws = iter([353.66, 210.4, 140.2, 135.4, 151.0, 136.0, 135.9, 139.0])
    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        return types.SimpleNamespace(stdout=f"NVIDIA H100 80GB HBM3, "
                                     f"700.00 W, {next(draws)} W\n")
    monkeypatch.setattr(rl.subprocess, "run", run)
    monkeypatch.setattr(rl.time, "sleep", lambda s: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda i=None: None)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: types.SimpleNamespace(total_memory=85e9))
    chip = rl.h100(torch.device("cuda", 0))
    assert chip.name == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert (chip.power_idle, chip.power_peak) == (135.4, 700.0)
    assert chip.memory_bytes == 85e9 and chip.link_bw == rl.H100_LINK_BW
    assert len(calls) == rl.REST_SAMPLES and "--id=0" in calls[0]

    def broken(cmd, **kw):
        raise subprocess.CalledProcessError(9, cmd)
    monkeypatch.setattr(rl.subprocess, "run", broken)
    with pytest.raises(subprocess.CalledProcessError):
        rl.h100(torch.device("cuda", 0))


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "llama3-8b",
                                  "mamba2-370m"])
@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
def test_model_flops_equal_the_reference(arch, shape):
    c = rl.count_params(get_config(arch))
    assert rl.model_flops(get_config(arch), INPUT_SHAPES[shape], c["total"],
                          c["active"]) == jax_rl.model_flops(
        jax_get_config(arch), JAX_SHAPES[shape], c["total"], c["active"])


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mamba2-370m",
                                  "recurrentgemma-2b"])
def test_serving_steps_match_the_jax_steps(arch):
    """One dense, one ssm and one hybrid config: the prefill step's logits,
    then one decode step from caches with room for it."""
    jc, tc = _configs(arch)
    jp, tp = _params(jc, tc)
    toks = np.random.default_rng(3).integers(0, jc.vocab_size, (2, 13))
    jlog, _ = jax.jit(jax_steps.make_prefill_step(jc))(
        jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    tlog, _ = st.make_prefill_step(tc)(tp, {"tokens": torch.from_numpy(toks)})
    _close(tlog, jlog)
    _, jcache = jax.jit(lambda p, t: jax_prefill(p, jc, t, max_seq=16))(
        jp, jnp.asarray(toks, jnp.int32))
    _, tcache = prefill(tp, tc, torch.from_numpy(toks), max_seq=16)
    nxt = np.array([[5], [7]])
    jlog, _ = jax.jit(jax_steps.make_decode_step(jc))(
        jp, jnp.asarray(nxt, jnp.int32), jcache)
    tlog, tcache = st.make_decode_step(tc)(tp, torch.from_numpy(nxt), tcache)
    _close(tlog, jlog)
    assert tcache["pos"] == 14


@pytest.mark.parametrize("arch", ["llava-next-34b", "whisper-small",
                                  "llama3-8b"])
def test_batch_inputs_follow_the_reference_specs(arch):
    jc, tc = jax_get_config(arch).reduced(), get_config(arch).reduced()
    for kind, shape in SMALL.items():
        if kind == "decode":
            continue
        want = jax_steps.batch_specs(jc, shape)
        got = st.batch_inputs(tc, shape, shape.global_batch, seed=1,
                              device="cpu")
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}
        again = st.batch_inputs(tc, shape, shape.global_batch, seed=1,
                                device="cpu")
        assert all(torch.equal(got[k], again[k]) for k in got)
    assert st.text_len(tc, 4096) == jax_steps.text_len(jc, 4096)


@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-370m",
                                  "recurrentgemma-2b", "whisper-small"])
def test_decode_inputs_fill_a_full_cache(arch):
    cfg = get_config(arch).reduced()
    shape = SMALL["decode"]
    token, cache = st.decode_inputs(cfg, shape, 3, seed=2, device="cpu")
    assert tuple(token.shape) == (3, 1) and cache["pos"] == shape.seq_len - 1
    tensors = st.cache_tensors(cache)
    assert tensors and all(bool((t != 0).any()) for t in tensors)
    _, again = st.decode_inputs(cfg, shape, 3, seed=2, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tensors,
                                                 st.cache_tensors(again)))
    logits, cache = st.make_decode_step(cfg)(
        init_params(cfg, device="cpu"), token, cache)
    assert tuple(logits.shape) == (3, 1, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())


def _hand_count(cfg, b, s):
    """Matrix-product operations of a dense prefill: the q, k, v and o
    projections and the SwiGLU MLP of every layer, and the logits of the
    last position."""
    d, h, kv, hd, ff = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    layer = 2 * b * s * (d * h * hd + 2 * d * kv * hd + h * hd * d
                         + 3 * d * ff)
    return cfg.num_layers * layer + 2 * b * d * cfg.vocab_size


def test_counter_matches_a_hand_count_and_sees_the_kernels():
    cfg = get_config("llama3-8b").reduced(num_layers=2,
                                          activ_dtype="float32")
    params = init_params(cfg, device="cpu")
    b, s = 2, 48
    batch = st.batch_inputs(cfg, InputShape("p", s, b, "prefill"), b,
                            device="cpu")
    with StepCost() as cost:
        st.make_prefill_step(cfg)(params, batch)
    products = sum(cost.by_kind[k] for k in ("mm", "bmm", "addmm"))
    assert products == pytest.approx(_hand_count(cfg, b, s), rel=0.01)
    q = torch.empty((b, cfg.num_heads, s, cfg.head_dim), device="meta")
    k = torch.empty((b, cfg.num_kv_heads, s, cfg.head_dim), device="meta")
    assert cost.by_kind["kernel"] == cfg.num_layers * flash_ops.cost(
        q, k, k)[0]
    assert cost.held == 0 and cost.bytes > 0

    train = dataclasses.replace(SMALL["train"], seq_len=s, global_batch=b)
    masters = init_params(cfg, device="cpu", keep_f32=True)
    step = st.make_train_step(cfg, dryrun.AdamWConfig())
    data = st.batch_inputs(cfg, train, b, device="cpu")
    with StepCost() as tcost:
        step(masters, dryrun.init_opt_state(masters), data)
    assert tcost.flops > 1.5 * cost.flops and tcost.held == 0
    # the backward kernels' counts arrive through the held identity nodes
    assert tcost.by_kind["kernel"] == pytest.approx(
        3.5 * cost.by_kind["kernel"])


def test_kernel_costs_are_the_bound_columns():
    """flash at llama3-8b (8, 32, 8, 1024, 128), bf16: 68.8 GFLOP, the
    causal half; decode over a cache's T rows, never its lengths."""
    def meta(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device="meta")
    ops, _ = flash_ops.cost(meta(8, 32, 1024, 128), meta(8, 8, 1024, 128),
                            meta(8, 8, 1024, 128))
    assert ops == 4 * 128 * 8 * 32 * 1024 * 1025 // 2
    assert round(ops / 1e9, 1) == 68.8
    from repro_torch.kernels.decode_attention import ops as decode_ops
    lengths = torch.empty(8, dtype=torch.int32, device="meta")
    ops, nbytes = decode_ops.cost(meta(8, 32, 128), meta(8, 8, 1039, 128),
                                  meta(8, 8, 1039, 128), lengths)
    assert ops == 4 * 32 * 128 * 8 * 1039
    assert nbytes == 2 * (2 * 8 * 128 * 8 * 1039 + 2 * 8 * 32 * 128) + 32


def test_counter_is_off_without_a_mode():
    cfg = get_config("mamba2-370m").reduced(num_layers=2)
    params = init_params(cfg, device="cpu")
    toks = torch.zeros((1, 12), dtype=torch.long)
    plain = prefill(params, cfg, toks)[0]
    with StepCost():
        counted = prefill(params, cfg, toks)[0]
    assert torch.equal(plain, counted)


def test_run_combo_writes_ok_and_skip_rows():
    chip = rl.h100("cpu")
    cfg = get_config("llama3-8b").reduced(num_layers=2)
    for kind, shape in SMALL.items():
        row = dryrun.run_combo("llama3-8b", shape, cfg=cfg, device="cpu",
                               chip=chip)
        assert row["status"] == "ok" and row["mesh"] == "1x1"
        assert row["chips"] == 1 and row["device"] == "cpu"
        assert set(row) == REF_KEYS - {"xla_flops", "xla_bytes"} | {
            "global_batch", "measured_step_s", "measured_energy_j",
            "peak_memory_gb", "device"}
        assert row["global_batch"] == {
            "decode": shape.global_batch, "prefill": 1,
            "train": min(dryrun.MICROBATCHES["llama3-8b"],
                         shape.global_batch)}[kind]
        assert row["flops_per_chip"] > 0 and row["measured_step_s"] > 0
        assert row["t_collective_s"] == 0.0 and json.dumps(row)
    skip = dryrun.run_combo("llama3-8b", "long_500k", device="cpu",
                            chip=chip)
    assert skip == {"arch": "llama3-8b", "shape": "long_500k",
                    "mesh": "1x1", "status": "skip", "reason": (
                        "long_500k requires sub-quadratic attention; "
                        "llama3-8b has unbounded full-attention layers "
                        "(see DESIGN.md §5)")}
    big = dryrun.run_combo("llava-next-34b", "train_4k", device="cpu",
                           chip=chip)
    assert big["status"] == "skip" and "AdamW" in big["reason"]


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mamba2-370m"])
def test_training_row_runs_the_reference_microbatches(arch):
    """A ``train_4k`` row runs ``MICROBATCHES[arch]`` micro-batches of one
    sequence (a reduced config at 16 tokens): its counts are one
    micro-batch's forward and backward times that count, one AdamW
    update, and the accumulation: the later micro-batches' gradients
    added to the first's ((n - 1) P additions), one division by n, the
    losses and metrics stacked and averaged."""
    cfg = get_config(arch).reduced(num_layers=2)
    shape = InputShape("train_4k", 16, 256, "train")
    n = dryrun.MICROBATCHES[arch]
    assert dryrun.run_batch(cfg, shape, rl.h100("cpu")) == n
    row = dryrun.run_combo(arch, shape, cfg=cfg, device="cpu",
                           chip=rl.h100("cpu"))
    assert row["status"] == "ok" and row["global_batch"] == n
    run, _ = dryrun._step(cfg, shape, n, init_params(
        cfg, dryrun.SEED, "cpu", keep_f32=True), torch.device("cpu"))
    with StepCost() as step:
        run()
    params = init_params(cfg, dryrun.SEED, "cpu", keep_f32=True)
    leaves = tree_leaves(params)
    for x in leaves:
        x.requires_grad_(True)
    data = st.batch_inputs(cfg, shape, 1, seed=dryrun.SEED, device="cpu")
    with StepCost() as one:
        loss, _ = loss_fn(params, cfg, data)
        loss.backward()
    for x in leaves:
        x.requires_grad_(False)
    grads = tree_unflatten(params, [x.grad for x in leaves])
    state = init_opt_state(params)
    with StepCost() as update, torch.no_grad():
        adamw_update(dryrun.AdamWConfig(), params, grads, state,
                     decays=st.decays_as_stacked)
    p = sum(x.numel() for x in leaves)
    want = Counter({k: n * c for k, c in one.by_kind.items()})
    want.update(update.by_kind)
    want.update({"add_": (n - 1) * p, "div_": p, "full": 1, "stack": 3 * n,
                 "mean": 3})
    assert step.by_kind == want
    assert step.bytes_by_kind["add_"] == n * one.bytes_by_kind["add_"] + \
        update.bytes_by_kind["add_"] + 12 * (n - 1) * p


def test_skip_rule_counts_what_a_microbatched_step_holds(monkeypatch):
    """A reduced deepseek-v2-lite-16b (MLA and MoE: no hand-written kernel
    on its path) in its bf16 layers.  On the meta device, when the AdamW
    update starts, a step of 1 or 4 micro-batches holds, beside its batch,
    ``TRAIN_BYTES_PER_PARAM`` bytes a parameter (``count_params``) and a
    few scalars: the gradients accumulate in place, no second copy.  The
    skip rule's count (``train_step_bytes``, the step's peak on the meta
    device) is the peak of the same step run on the CPU in the card's MoE
    form (the meta device follows the card's rule: at 16 tokens the
    every-expert form); the rule skips a row whose step passes 3/4 of the
    card although its state fits."""
    cfg = get_config("deepseek-v2-lite-16b").reduced(num_layers=2)
    shape = InputShape("train_4k", 16, 256, "train")
    total = rl.count_params(cfg)["total"]
    real = st.adamw_update
    held = {}
    for n in (1, 4):
        params = init_params(cfg, dryrun.SEED, "meta", keep_f32=True)
        state = init_opt_state(params)
        batch = st.batch_inputs(cfg, shape, n, device="meta")
        data = sum(x.untyped_storage().nbytes() for x in batch.values())

        def at_update(*args, **kwargs):
            held[n] = mode._now() - data
            return real(*args, **kwargs)
        monkeypatch.setattr(st, "adamw_update", at_update)
        with StepBytes(tree_leaves(params) + tree_leaves(state)
                       + list(batch.values())) as mode:
            st.make_train_step(cfg, dryrun.AdamWConfig(),
                               num_microbatches=n)(params, state, batch)
        assert 0 <= held[n] - dryrun.TRAIN_BYTES_PER_PARAM * total < 256
    monkeypatch.setattr(st, "adamw_update", real)

    card_rule = moe.runs_sorted
    monkeypatch.setattr(moe, "runs_sorted",
                        lambda c, x: card_rule(c, x.to("meta")))
    params = init_params(cfg, dryrun.SEED, "cpu", keep_f32=True)
    state = init_opt_state(params)
    batch = st.batch_inputs(cfg, shape, 2, device="cpu")
    with StepBytes(tree_leaves(params) + tree_leaves(state)
                   + list(batch.values())) as mode:
        st.make_train_step(cfg, dryrun.AdamWConfig(), num_microbatches=2)(
            params, state, batch)
    monkeypatch.setattr(moe, "runs_sorted", card_rule)
    peak = dryrun.train_step_bytes(cfg, shape)
    assert peak == mode.peak > dryrun.TRAIN_BYTES_PER_PARAM * total

    def chip(fit_bytes):
        return dataclasses.replace(rl.h100("cpu"),
                                   memory_bytes=fit_bytes / dryrun.FIT)
    assert dryrun.skip_reason(cfg, shape, chip(peak)) is None
    reason = dryrun.skip_reason(cfg, shape, chip(peak - 1))
    assert reason.startswith("train: a step of 16-token micro-batches "
                             "holds") and "meta device" in reason
    assert "AdamW" in dryrun.skip_reason(
        cfg, shape, chip(dryrun.TRAIN_BYTES_PER_PARAM * total - 1))


@pytest.mark.parametrize("dtype,min_macs,form", [
    ("float32", 0.0, "every"), ("bfloat16", math.inf, "every"),
    ("bfloat16", 0.0, "sorted")])
def test_meta_step_runs_the_cards_moe_form(monkeypatch, dtype, min_macs,
                                           form):
    """A reduced granite-moe-1b-a400m step of 2 micro-batches on the meta
    device, as ``train_step_bytes`` runs it, takes the MoE form the card
    would (every expert in f32 and below ``SORTED_MIN_MACS``, else
    sorted), so that the skip rule counts that form's activations; the
    same step on the CPU runs the sorted form."""
    cfg = dataclasses.replace(
        get_config("granite-moe-1b-a400m").reduced(num_layers=2),
        activ_dtype=dtype)
    monkeypatch.setattr(moe, "SORTED_MIN_MACS", min_macs)
    calls = Counter()
    for name in ("_experts_sorted", "_experts_all"):
        def counted(*args, _real=getattr(moe, name), _name=name):
            calls[_name, args[1].device.type] += 1
            return _real(*args)
        monkeypatch.setattr(moe, name, counted)
    shape = InputShape("train_4k", 16, 2, "train")
    for device in ("meta", "cpu"):
        params = init_params(cfg, dryrun.SEED, device, keep_f32=True)
        st.make_train_step(cfg, dryrun.AdamWConfig(), num_microbatches=2)(
            params, init_opt_state(params),
            st.batch_inputs(cfg, shape, 2, device=device))
    ran = "_experts_sorted" if form == "sorted" else "_experts_all"
    assert calls == Counter({(ran, "meta"): 4, ("_experts_sorted", "cpu"): 4})


def test_kernels_on_the_meta_device_allocate_and_launch_nothing():
    """On the meta device each kernel wrapper returns outputs of its
    card's shapes and dtypes, forward and backward, and counts no
    launch."""
    from repro_torch.kernels.rglru_scan import ops as lru_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    mods = (flash_ops, ssd_ops, lru_ops)
    before = [(m.launches, m.backward_launches) for m in mods]

    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta",
                           requires_grad=True)
    q, k = meta(2, 8, 64, 32), meta(2, 2, 64, 32)
    o = flash_ops.attention(q, k, k)
    assert o.shape == q.shape and o.dtype == q.dtype and o.is_meta
    assert all(g.shape == x.shape for g, x in zip(
        torch.autograd.grad(o.sum(), (q, k)), (q, k)))
    x, dt = meta(2, 40, 4, 16), meta(2, 40, 4, dtype=torch.float32)
    a, d = meta(4, dtype=torch.float32), meta(4, dtype=torch.float32)
    b = meta(2, 40, 8)
    y = ssd_ops.ssd(x, dt, a, b, b, d, chunk=16)
    assert y.shape == x.shape and y.is_meta
    assert torch.autograd.grad(y.sum(), x)[0].shape == x.shape
    la = meta(2, 40, 16, dtype=torch.float32)
    h = lru_ops.linear_scan(la, la)
    assert h.shape == la.shape and h.is_meta
    assert torch.autograd.grad(h.sum(), la)[0].shape == la.shape
    assert [(m.launches, m.backward_launches) for m in mods] == before


def test_decode_batch_fits_three_quarters_of_the_card():
    chip = rl.h100("cpu")
    shape = INPUT_SHAPES["decode_32k"]
    for arch, want in (("llama3-8b", 8), ("qwen2.5-3b", 32),
                       ("mamba2-370m", 128)):
        cfg = get_config(arch)
        b = dryrun.run_batch(cfg, shape, chip)
        assert b == want
        room = 0.75 * chip.memory_bytes - dryrun.weight_bytes(cfg)
        assert dryrun.cache_bytes(cfg, b, shape.seq_len) <= room
        assert b == shape.global_batch or dryrun.cache_bytes(
            cfg, 2 * b, shape.seq_len) > room
    # llama3-8b's cache: 32 layers x K and V x 8 heads x 32768 x 128 bf16
    assert dryrun.cache_bytes(get_config("llama3-8b"), 1, 32768) == \
        32 * 2 * 8 * 32768 * 128 * 2


def test_main_writes_rows_the_driver_routes_on(monkeypatch, capsys,
                                               tmp_path):
    """``main`` on the CPU over two reduced archs; the serve driver then
    routes on its rows with ``--dryrun-mesh 1x1``."""
    monkeypatch.setattr(dryrun, "get_config",
                        lambda a: get_config(a).reduced(num_layers=2))
    monkeypatch.setattr(dryrun, "INPUT_SHAPES", SMALL)
    archs = ["qwen2.5-3b", "mamba2-370m"]
    for arch in archs:
        assert dryrun.main(["--arch", arch, "--shape", "prefill", "--out",
                            str(tmp_path), "--device", "cpu"]) == 0
    path = tmp_path / "dryrun.jsonl"
    rows = [json.loads(x) for x in path.read_text().splitlines()]
    assert [(r["arch"], r["status"], r["mesh"]) for r in rows] == \
        [(a, "ok", "1x1") for a in archs]
    table = pool.pool_table_from_dryrun(str(path), ("prefill_32k",), "1x1",
                                        device="cpu")
    for r in rows:
        e = next(e for e in table.entries if e.model == r["arch"])
        assert e.time_ms == r["measured_step_s"] * 1e3 / r["global_batch"]
        assert e.energy_mwh == \
            r["measured_energy_j"] / 3.6 / r["global_batch"]
    capsys.readouterr()
    assert serve.main(["--requests", "6", "--dryrun-artifact", str(path),
                       "--dryrun-mesh", "1x1", "--archs", *archs,
                       "--device", "cpu", "--reduced", "--max-new",
                       "2"]) == 0
    out = capsys.readouterr().out
    assert out.splitlines()[0] == f"pool profile from {path}: 2 backends"


def test_pool_table_divides_a_port_row_by_its_batch(tmp_path):
    rows = [dict(arch="qwen2.5-3b", mesh="1x1", shape="decode_32k",
                 status="ok", t_step_s=0.032, energy_j=8.0,
                 params_active=2_774_773_760, global_batch=32),
            dict(arch="llama3-8b", mesh="1x1", shape="decode_32k",
                 status="ok", t_step_s=0.016, energy_j=4.0,
                 params_active=6_979_588_096, global_batch=8)]
    path = tmp_path / "dryrun.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    table = pool.pool_table_from_dryrun(str(path), ("decode_32k",), "1x1",
                                        device="cpu")
    got = {e.model: (e.time_ms, e.energy_mwh, e.device)
           for e in table.entries}
    assert got == {"qwen2.5-3b": (1.0, 8.0 / 3.6 / 32, "pod-1x1"),
                   "llama3-8b": (2.0, 4.0 / 3.6 / 8, "pod-1x1")}
    assert math.isclose(got["qwen2.5-3b"][0], 0.032 * 1e3 / 32)


def test_pool_table_routes_a_port_row_on_its_measured_step(tmp_path):
    """A row with ``measured_step_s`` is routed on the measured step and
    its energy, split over its batch; the roofline estimate is not
    read."""
    rows = [dict(arch="qwen2.5-3b", mesh="1x1", shape="prefill_32k",
                 status="ok", t_step_s=0.3, energy_j=90.0,
                 measured_step_s=0.9, measured_energy_j=270.0,
                 params_active=2_774_773_760, global_batch=1),
            dict(arch="llama3-8b", mesh="1x1", shape="decode_32k",
                 status="ok", t_step_s=0.016, energy_j=4.0,
                 measured_step_s=0.04, measured_energy_j=8.0,
                 params_active=6_979_588_096, global_batch=8)]
    path = tmp_path / "dryrun.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    table = pool.pool_table_from_dryrun(
        str(path), ("prefill_32k", "decode_32k"), "1x1", device="cpu")
    got = {e.model: (e.time_ms, e.energy_mwh) for e in table.entries}
    assert got == {"qwen2.5-3b": (0.9 * 1e3, 270.0 / 3.6),
                   "llama3-8b": (0.04 * 1e3 / 8, 8.0 / 3.6 / 8)}


def test_pool_table_routes_a_mesh_row_on_its_roofline_step(tmp_path):
    """A mesh row's measured step is rank 0's compute alone
    (``measured_scope``), so the pool, with its default mesh, routes it on
    the roofline's step and energy, which count the collectives' term;
    the 1x1 row beside it keeps its measured step."""
    rows = [dict(arch="llama3-8b", mesh="16x16", shape="prefill_32k",
                 chips=256, status="ok", t_step_s=0.36, energy_j=900.0,
                 t_collective_s=0.156, measured_step_s=0.1,
                 measured_energy_j=300.0, measured_scope=dryrun.MESH_SCOPE,
                 params_active=6_979_588_096, global_batch=32),
            dict(arch="qwen2.5-3b", mesh="1x1", shape="prefill_32k",
                 status="ok", t_step_s=0.3, energy_j=90.0,
                 measured_step_s=0.9, measured_energy_j=270.0,
                 params_active=2_774_773_760, global_batch=1)]
    path = tmp_path / "dryrun.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    table = pool.pool_table_from_dryrun(str(path), device="cpu")
    assert {(e.model, e.time_ms, e.energy_mwh, e.device)
            for e in table.entries} == {
        ("llama3-8b", 0.36 * 1e3 / 32, 900.0 / 3.6 / 32, "pod-16x16")}
    table = pool.pool_table_from_dryrun(str(path), mesh="1x1", device="cpu")
    assert {(e.model, e.time_ms) for e in table.entries} == {
        ("qwen2.5-3b", 0.9 * 1e3)}


def test_flash_cpu_gradients_keep_the_inputs_strides():
    """The CPU path hands q's, k's and v's gradients on in their strides,
    as the backward kernel writes them, so that a training step runs (and
    counts) the same ops after it on either device: no ``clone`` of a
    transposed gradient."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 12, h, 16), generator=gen)
               for h in (4, 2, 2))
    qt, kt, vt = (x.transpose(1, 2).requires_grad_() for x in (q, k, v))
    out = flash_ops.attention(qt, kt, vt)
    grads = torch.autograd.grad(out.square().sum(), (qt, kt, vt))
    for x, g in zip((qt, kt, vt), grads):
        assert g.stride() == x.stride()
    want = torch.autograd.grad(
        flash_ref.mha_reference(qt, kt, vt).square().sum(), (qt, kt, vt))
    for g, w in zip(grads, want):
        assert torch.equal(g, w)
    cfg = get_config("llama3-8b").reduced(num_layers=2)
    run, _ = dryrun._step(cfg, InputShape("train", 16, 2, "train"), 2,
                          init_params(cfg, dryrun.SEED, "cpu",
                                      keep_f32=True), torch.device("cpu"))
    with StepCost() as cost:
        run()
    assert cost.by_kind["clone"] == 0
