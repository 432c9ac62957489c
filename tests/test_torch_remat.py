"""The port's rematerialisation (``cfg.remat``) against the JAX package's
``jax.checkpoint``, on the CPU.

With ``cfg.remat`` and autograd recording, ``_prompt_layers`` runs each
of the reference's scanned blocks (``len(cfg.block_layout)`` layers, the
trailing layout one more block) under non-reentrant
``torch.utils.checkpoint``, and ``loss_fn`` computes the head in
checkpointed chunks of ``LOSS_CHUNK_ROWS`` rows.  Reduced configs of both
packages with ``remat=True`` and at least two blocks; the head's chunk is
cut to ``CHUNK`` rows so that several chunks run, none on a sequence's
edge.  Bars, ``tests/test_torch_lm_loss.py``'s in f32: the loss within
1e-5 relative and each gradient leaf within 1e-4 of its largest |value|
of the reference's, MoE expert ids equal; remat against no remat in the
port 1e-6 for both.  Also: each kernel's forward runs twice a layer under
remat (forward and recompute) and once without; the step's counted cost
is the kept step's plus the recomputed regions' forward; the skip rule's
count falls; the dry run's prefill rule; RoPE's frequencies filled on the
device, bit for bit.
"""
import dataclasses
from collections import Counter

import jax
import numpy as np
import pytest
import test_torch_lm_loss as lm
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as jax_layers
from repro_torch.configs import get_config, list_configs
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rglru_scan import ops as lru_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as rl
from repro_torch.launch.cost import StepCost
from repro_torch.models import init_params, layers, loss_fn, model, prefill
from repro_torch.models.base import INPUT_SHAPES, InputShape
from repro_torch.optim.adamw import tree_leaves

torch.set_num_threads(1)

#: rows of the head's chunks here: 7 does not divide a 12-token sequence
CHUNK = 7
#: layers of each arch's reduced config: qwen2.5-3b three one-layer
#: blocks; recurrentgemma-2b two (rec, rec, local) blocks and the trailing
#: (rec, rec) pair; granite and llava two one-layer blocks
LAYERS = {"qwen2.5-3b": 3, "recurrentgemma-2b": 8,
          "granite-moe-1b-a400m": 2, "llava-next-34b": 2}
ARCHS = tuple(list_configs())


@pytest.fixture(autouse=True)
def small_chunks(monkeypatch):
    monkeypatch.setattr(model, "LOSS_CHUNK_ROWS", CHUNK)


def configs(arch, remat=True):
    """The reduced configs of ``arch`` in both packages, f32, with
    ``remat``; ``LAYERS``' depth or the reduced default."""
    kw = {"remat": remat, "activ_dtype": "float32"}
    if arch in LAYERS:
        kw["num_layers"] = LAYERS[arch]
    return (jax_get_config(arch).reduced(**kw),
            get_config(arch).reduced(**kw))


@pytest.mark.parametrize("arch", tuple(LAYERS))
def test_rematerialised_loss_and_gradients_equal_jax(arch, monkeypatch):
    """The port under remat against ``jax.value_and_grad`` of the
    reference with ``jax.checkpoint`` on its scan bodies: the loss, ce,
    aux and every gradient leaf at the f32 bars; a MoE arch's expert ids
    of each layer equal to the reference's in the forward and in the
    recompute (the backward runs the layers again in reverse order)."""
    jc, tc = configs(arch)
    assert jc.remat and tc.remat and len(model._regions(tc)) >= 2
    jids, tids = lm.record_expert_ids(monkeypatch)
    jp, _ = lm.llm._params(jc, tc)
    tp = model.params_from_jax(tc, jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu", keep_f32=True)
    b = lm.batch(tc)
    rows = b["tokens"].size + b["tokens"].shape[0] * (
        tc.num_prefix_embeds if tc.family == "vlm" else 0)
    assert rows > 2 * CHUNK and rows % CHUNK
    (jl, jm), jg = lm.jax_value_and_grad(jc, jp, b)
    (tl, tm), tg = lm.port_value_and_grad(tc, tp, b)
    for got, want in ((tl, jl), (tm["ce"], jm["ce"]),
                      (tm["aux"], jm["aux"])):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    want = tree_leaves(model.params_from_jax(
        tc, jax.tree_util.tree_map(np.asarray, jg), device="cpu",
        keep_f32=True))
    assert len(tg) == len(want)
    for got, ref in zip(tg, want):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                   atol=1e-4 * float(ref.abs().max()))
    if tc.num_experts:
        n = tc.num_layers
        assert float(tm["aux"]) > 0 and len(tids) == 2 * n
        forward, recompute = tids[:n], tids[n:][::-1]
        for got, again, ref in zip(forward, recompute, jids[:n]):
            np.testing.assert_array_equal(got, ref)
            np.testing.assert_array_equal(again, got)
    else:
        assert not tids


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_equals_the_kept_step(arch):
    """The port's loss and gradients with ``remat`` against the same
    config without it, from the same masters: within 1e-6 (relative; of
    each leaf's largest |value|).  The encdec family checkpoints only its
    head."""
    _, kept = configs(arch, remat=False)
    remat = dataclasses.replace(kept, remat=True)
    tp = init_params(kept, seed=3, device="cpu", keep_f32=True)
    b = lm.batch(kept, seed=3)
    (loss, metrics), grads = lm.port_value_and_grad(remat, tp, b)
    (want_loss, want_metrics), want = lm.port_value_and_grad(kept, tp, b)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    np.testing.assert_allclose(float(metrics["aux"]),
                               float(want_metrics["aux"]), rtol=1e-6)
    for got, ref in zip(grads, want):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                   atol=1e-6 * float(ref.abs().max()))


def forward_calls(monkeypatch):
    """A Counter of the kernel entry points' calls (flash, SSD, RG-LRU)."""
    calls = Counter()
    for name, mod, attr in (("flash", flash_ops, "attention"),
                            ("ssd", ssd_ops, "ssd"),
                            ("rglru", lru_ops, "rglru")):
        def counted(*args, _real=getattr(mod, attr), _name=name, **kwargs):
            calls[_name] += 1
            return _real(*args, **kwargs)
        monkeypatch.setattr(mod, attr, counted)
    return calls


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "recurrentgemma-2b",
                                  "mamba2-370m", "whisper-small"])
def test_each_kernel_forward_runs_twice_a_layer_under_remat(arch,
                                                            monkeypatch):
    """A training step's forward kernels, called through their wrappers:
    once a layer without remat, twice under it (the backward's
    recompute); whisper-small's encoder, self- and cross-attention once
    either way (its blocks are not checkpointed)."""
    _, kept = configs(arch, remat=False)
    kinds = kept.layer_kinds
    if kept.family == "encdec":
        once = Counter(flash=kept.enc_layers + 2 * kept.dec_layers)
    else:
        once = Counter(flash=sum(k in ("attn", "local") for k in kinds),
                       ssd=kinds.count("ssm"), rglru=kinds.count("rec"))
    once = +once
    tp = init_params(kept, seed=1, device="cpu", keep_f32=True)
    b = lm.batch(kept, seed=1)
    calls = forward_calls(monkeypatch)
    for cfg, times in ((kept, 1), (dataclasses.replace(kept, remat=True),
                                   1 if kept.family == "encdec" else 2)):
        calls.clear()
        lm.port_value_and_grad(cfg, tp, b)
        assert calls == Counter({k: n * times for k, n in once.items()})


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "recurrentgemma-2b",
                                  "granite-moe-1b-a400m", "mamba2-370m"])
def test_step_cost_counts_the_recompute(arch, monkeypatch):
    """``StepCost`` of a rematerialised step (loss and backward) equals,
    op kind by op kind, that of the same step with its regions run plainly
    (their activations kept) plus the forward of every checkpointed region
    (each block and each chunk of the head), counted apart in a forward
    alone: the recompute is counted once in full, none of it inside a
    kernel's hold."""
    _, kept = configs(arch, remat=False)
    cfg = dataclasses.replace(kept, remat=True)
    tp = init_params(cfg, seed=2, device="cpu", keep_f32=True)
    b = lm.torch_batch(lm.batch(cfg, seed=2))
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)

    def step():
        loss, _ = loss_fn(tp, cfg, b)
        torch.autograd.grad(loss, leaves)

    with StepCost() as remat:
        step()
    regions, ran = StepCost(), Counter()

    def counted(fn, *args):
        ran[fn.__name__] += 1
        with regions:
            return fn(*args)
    monkeypatch.setattr(model, "_checkpointed", counted)
    loss_fn(tp, cfg, b)
    monkeypatch.setattr(model, "_checkpointed", lambda fn, *args: fn(*args))
    with StepCost() as plain:
        step()
    assert ran == Counter(block=len(model._regions(cfg)),
                          _head_nll=-(-b["tokens"].numel() // CHUNK))
    for kind in ("by_kind", "bytes_by_kind"):
        want = getattr(plain, kind) + getattr(regions, kind)
        assert getattr(remat, kind) == want, kind
    assert remat.by_kind["kernel"] > plain.by_kind["kernel"] > 0


def test_remat_lowers_the_skip_rules_count():
    """``train_step_bytes`` of a reduced qwen2.5-3b at 256-token
    micro-batches: lower with remat (its blocks keep only their inputs,
    the head one chunk of logits) than without."""
    _, kept = configs("qwen2.5-3b", remat=False)
    shape = InputShape("train_4k", 256, 2, "train")
    with_remat = dryrun.train_step_bytes(
        dataclasses.replace(kept, remat=True), shape)
    assert with_remat < dryrun.train_step_bytes(kept, shape)


def test_prefill_rule_skips_what_does_not_fit():
    """The dry run's prefill rule on the card's record: llava-next-34b's
    weights alone pass 3/4 of the card (skipped without running the
    step); qwen2.5-3b's 32k-token prefill fits (its step's peak on the
    meta device); a card too small for that peak skips it, naming the
    GiB."""
    chip = rl.h100("cpu")
    shape = INPUT_SHAPES["prefill_32k"]
    llava = get_config("llava-next-34b")
    reason = dryrun.skip_reason(llava, shape, chip)
    assert reason.startswith("prefill: ") and "GiB of weights" in reason
    qwen = get_config("qwen2.5-3b")
    assert dryrun.skip_reason(qwen, shape, chip) is None
    peak = dryrun.prefill_step_bytes(qwen, shape)
    assert peak > dryrun.weight_bytes(qwen)
    small = dataclasses.replace(chip, memory_bytes=(peak - 1) / dryrun.FIT)
    reason = dryrun.skip_reason(qwen, shape, small)
    assert reason.startswith("prefill: a 32768-token prompt holds "
                             f"{peak / 2**30:.1f} GiB")


def test_prefill_and_serving_are_not_rematerialised(monkeypatch):
    """Serving never checkpoints: ``prefill`` under grad mode with a full
    config's ``remat`` and masters that require gradients, and
    ``forward`` under ``no_grad``."""
    _, kept = configs("qwen2.5-3b", remat=False)
    cfg = dataclasses.replace(kept, remat=True)
    monkeypatch.setattr(model, "_checkpointed", None)
    tp = init_params(cfg, seed=4, device="cpu")
    for p in tree_leaves(tp):
        p.requires_grad_(True)
    tokens = torch.zeros((1, 8), dtype=torch.long)
    prefill(tp, cfg, tokens)
    with torch.no_grad():
        model.forward(tp, cfg, tokens)
        loss_fn(tp, cfg, {"tokens": tokens, "labels": tokens})


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0, 500_000.0])
def test_rope_frequencies_filled_on_the_device_keep_their_bits(theta):
    """``apply_rope``'s output with theta filled on the device equals, bit
    for bit, the formula with theta copied from the host
    (``torch.tensor``), and the reference's f32 frequencies."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((2, 9, 4, 64), generator=gen)
    pos = torch.arange(9).expand(2, 9)
    exps = torch.arange(0, 64, 2, dtype=torch.float32) / 64
    host = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32), exps)
    assert torch.equal(layers.rope_freqs(64, theta), host)
    np.testing.assert_array_equal(
        layers.rope_freqs(64, theta).numpy(),
        np.asarray(jax_layers.rope_freqs(64, theta)))
    angles = pos[..., None].float() * host
    sin, cos = torch.sin(angles)[..., None, :], torch.cos(angles)[..., None, :]
    x1, x2 = x.chunk(2, dim=-1)
    want = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    assert torch.equal(layers.apply_rope(x, pos, theta), want)
