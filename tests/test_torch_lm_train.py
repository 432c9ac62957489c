"""LM training's step and drivers in the port, on the CPU:
``launch/steps.py::make_train_step`` against the JAX package's (one step
from the same parameters and batch; two micro-batches against the
reference's ``lax.scan`` accumulation under its host mesh), its
micro-batches against one batch, its refusal of a leaf without a gradient, and ``launch/train.py``
and ``examples/train_lm.py``: the loss falls and ``--save`` round-trips.

Bars: the loss and metrics within 1e-5 relative, the moments within 1e-4
of each leaf's largest |value| (the gradient bar of
``tests/test_torch_lm_loss.py``), the updated parameters within 1e-4 of
each leaf's largest |value| plus that gradient bar carried through Adam's
first step.  The step moves a parameter by lr (u(g) + weight decay p),
u(x) = x / (|x| + eps): about lr times the sign of its gradient, so two
gradients that agree to gamma = 1e-4 max |g| move it apart by up to lr
max |u(g +- gamma) - u(g)| (nearly 2 lr where g lies within gamma of
zero, more than the parameter bar where |g| is near eps).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_llm as llm
import test_torch_lm_loss as lm
import torch

from repro.launch.mesh import make_host_mesh
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.optim import adamw as jax_adamw
from repro_torch.checkpoint import ckpt
from repro_torch.examples import train_lm
from repro_torch.launch import train
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model, params_from_jax
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_leaves, tree_paths

torch.set_num_threads(1)

OPT = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10)


def _masters(arch, seed=0):
    jc, tc = lm.configs(arch)
    jp, _ = llm._params(jc, tc, seed)
    return jc, tc, jp, params_from_jax(
        tc, jax.tree_util.tree_map(np.asarray, jp), device="cpu",
        keep_f32=True)


def first_step_spread(m, cfg, bar=1e-4):
    """max |u(g +- gamma) - u(g)| of the module docstring, elementwise, of
    the clipped gradient g = m / (1 - b1) (``m`` the first moment after
    one step)."""
    g = m.double() / (1 - cfg.b1)
    gamma = bar * float(g.abs().max())
    u = lambda x: x / (x.abs() + cfg.eps)
    return torch.maximum(u(g + gamma) - u(g), u(g) - u(g - gamma)).float()


def updated_close(got, want, mu, lr, cfg):
    """Parameter trees after one step at the module docstring's bar;
    ``mu`` the reference run's first moments."""
    for path, p, w, m in zip(tree_paths(want), tree_leaves(got),
                             tree_leaves(want), tree_leaves(mu)):
        err = (p - w).abs()
        bar = 1e-4 * float(w.abs().max())
        assert bool((err <= bar + lr * first_step_spread(m, cfg)).all()), \
            path


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "granite-moe-1b-a400m"])
def test_train_step_equals_jax(arch):
    jc, tc, jp, tp = _masters(arch)
    b = lm.batch(tc, seed=3)
    jstep = jax.jit(jax_make_train_step(jc, jax_adamw.AdamWConfig(**OPT)))
    jp2, jopt, jm = jstep(jp, jax_adamw.init_opt_state(jp),
                          {k: jnp.asarray(v) for k, v in b.items()})
    step = make_train_step(tc, adamw.AdamWConfig(**OPT))
    tp2, topt, tm = step(tp, adamw.init_opt_state(tp), lm.torch_batch(b))
    # updated in place: the step owns the parameters, as the reference's
    # jitted step takes them donated
    assert all(a is b for a, b in zip(tree_leaves(tp2), tree_leaves(tp)))
    assert int(topt.step) == 1
    assert set(tm) == {"loss", "ce", "aux", "lr", "grad_norm"}
    for k in tm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=0, err_msg=k)
    as_port = lambda tree: params_from_jax(
        tc, jax.tree_util.tree_map(np.asarray, tree), device="cpu",
        keep_f32=True)
    mu = as_port(jopt.mu)
    for path, got, want in zip(tree_paths(mu), tree_leaves(topt.mu),
                               tree_leaves(mu)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-4 * float(want.abs().max()),
                                   err_msg=path)
    updated_close(tp2, as_port(jp2), mu, float(jm["lr"]),
                  adamw.AdamWConfig(**OPT))


@pytest.mark.parametrize("chunk", [adamw.CHUNK, 7])
def test_adamw_on_a_nested_tree_in_chunks_equals_jax(chunk, monkeypatch):
    """A nested tree of dicts and lists (a matrix, vectors, a scalar, a
    3-d leaf), 12 unclipped steps, each leaf in pieces of ``chunk``
    elements: bit-equal to the reference's update on the same tree, the
    parameters and moments updated in place."""
    monkeypatch.setattr(adamw, "CHUNK", chunk)
    rng = np.random.default_rng(8)
    shapes = {"w": [(5, 6), {"b": (9,)}], "s": [(), (4, 3, 2)]}

    def draw():
        return jax.tree_util.tree_map(
            lambda s: rng.standard_normal(s).astype(np.float32), shapes,
            is_leaf=lambda x: isinstance(x, tuple) and all(
                isinstance(i, int) for i in x))
    p0 = draw()
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()), p0)
    kw = dict(peak_lr=1e-2, warmup_steps=4, total_steps=12, clip_norm=None)
    jcfg, tcfg = jax_adamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    jopt, topt = jax_adamw.init_opt_state(jp), adamw.init_opt_state(tp)
    leaves = tree_leaves(tp)
    for _ in range(12):
        g = draw()
        jp, jopt, _ = jax_adamw.adamw_update(
            jcfg, jp, jax.tree_util.tree_map(jnp.asarray, g), jopt)
        tp, topt, _ = adamw.adamw_update(
            tcfg, tp, jax.tree_util.tree_map(torch.from_numpy, g), topt)
    assert all(a is b for a, b in zip(tree_leaves(tp), leaves))
    for got, want in ((tp, jp), (topt.mu, jopt.mu), (topt.nu, jopt.nu)):
        for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_microbatches_average_to_the_whole_batch():
    """Two micro-batches of 2 against one batch of 4 (no ignored label, so
    the mean of the halves' losses is the batch's): loss and gradient norm
    within 1e-5 relative, the moments and parameters at the bars."""
    _, tc, _, tp = _masters("qwen2.5-3b")
    b = lm.batch(tc, b=4, seed=5)
    b["labels"][0, :3] = b["tokens"][0, :3]
    tb = lm.torch_batch(b)
    cfg = adamw.AdamWConfig(**OPT)
    p1 = adamw.tree_unflatten(tp, [x.clone() for x in tree_leaves(tp)])
    p2 = adamw.tree_unflatten(tp, [x.clone() for x in tree_leaves(tp)])
    one = make_train_step(tc, cfg)(p1, adamw.init_opt_state(p1), tb)
    two = make_train_step(tc, cfg, num_microbatches=2)(
        p2, adamw.init_opt_state(p2), tb)
    for k in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(float(two[2][k]), float(one[2][k]),
                                   rtol=1e-5, err_msg=k)
    for got, want in zip(tree_leaves(two[1].mu), tree_leaves(one[1].mu)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-4 * float(want.abs().max()))
    updated_close(two[0], one[0], one[1].mu, float(one[2]["lr"]), cfg)
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(tc, cfg, num_microbatches=3)(
            p2, adamw.init_opt_state(p2), tb)


def test_microbatched_step_equals_jax():
    """Two micro-batches of a reduced granite-moe-1b-a400m (batch 4 of 16
    tokens, f32, three ignored labels in the first micro-batch, so the
    mean of the halves' losses is not the whole batch's) against the
    reference's ``lax.scan`` accumulation, jitted under its host mesh as
    ``repro.launch.train`` runs it: the metrics within 1e-5 relative, the
    first moments within the gradient bar (1e-4 of each leaf's largest
    |value|), the second moments within twice it (d(g^2) = 2 g dg), the
    parameters at the module docstring's bar."""
    jc, tc, jp, tp = _masters("granite-moe-1b-a400m")
    b = lm.batch(tc, b=4, s=16, seed=5)
    with make_host_mesh():
        jstep = jax.jit(jax_make_train_step(
            jc, jax_adamw.AdamWConfig(**OPT), num_microbatches=2))
        jp2, jopt, jm = jstep(jp, jax_adamw.init_opt_state(jp),
                              {k: jnp.asarray(v) for k, v in b.items()})
    step = make_train_step(tc, adamw.AdamWConfig(**OPT), num_microbatches=2)
    tp2, topt, tm = step(tp, adamw.init_opt_state(tp), lm.torch_batch(b))
    assert float(jm["aux"]) > 0 and set(tm) == set(jm)
    for k in tm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=0, err_msg=k)
    as_port = lambda tree: params_from_jax(
        tc, jax.tree_util.tree_map(np.asarray, tree), device="cpu",
        keep_f32=True)
    mu, nu = as_port(jopt.mu), as_port(jopt.nu)
    for bar, got_tree, want_tree in ((1e-4, topt.mu, mu),
                                     (2e-4, topt.nu, nu)):
        for path, got, want in zip(tree_paths(want_tree),
                                   tree_leaves(got_tree),
                                   tree_leaves(want_tree)):
            np.testing.assert_allclose(
                got.numpy(), want.numpy(), rtol=0,
                atol=bar * float(want.abs().max()) + 1e-30, err_msg=path)
    updated_close(tp2, as_port(jp2), mu, float(jm["lr"]),
                  adamw.AdamWConfig(**OPT))
    assert all(x.grad is None and not x.requires_grad
               for x in tree_leaves(tp2))


def test_a_leaf_without_a_gradient_raises(monkeypatch):
    """A parameter cut off from the loss (here ``final_norm``, detached
    after the cast) would keep its value silently: the step raises and
    names it."""
    _, tc, _, tp = _masters("qwen2.5-3b")
    cast = model.cast_params

    def detached(cfg, params):
        out = cast(cfg, params)
        return dict(out, final_norm=out["final_norm"].detach())

    monkeypatch.setattr(model, "cast_params", detached)
    step = make_train_step(tc, adamw.AdamWConfig(**OPT))
    with pytest.raises(RuntimeError, match="final_norm"):
        step(tp, adamw.init_opt_state(tp), lm.torch_batch(lm.batch(tc)))
    assert not any(x.requires_grad for x in tree_leaves(tp))


def _losses(out: str):
    return [float(x) for x in re.findall(r"^step +\d+ loss=([\d.]+)", out,
                                         re.M)]


def test_train_driver_loss_falls_and_the_checkpoint_round_trips(
        tmp_path, capsys, monkeypatch):
    saved = {}
    save = ckpt.save
    monkeypatch.setattr(ckpt, "save", lambda path, tree: (
        saved.update(tree=tree), save(path, tree))[1])
    path = tmp_path / "lm.npz"
    assert train.main(["--arch", "qwen2.5-3b", "--steps", "20", "--batch",
                       "4", "--seq", "32", "--lr", "3e-3", "--log-every",
                       "1", "--layers", "7", "--save", str(path),
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("arch=qwen2.5-3b family=dense layers=1 "
                          "d_model=128 vocab=512\nparams: ")
    losses = _losses(out)
    assert len(losses) == 20 and np.mean(losses[-5:]) < np.mean(losses[:5])
    assert f"saved {path}" in out and "device: cpu (cpu)" in out
    assert "tokens/s" in out and "peak device memory" in out
    back = ckpt.load(str(path), saved["tree"])
    assert tree_paths(back) == tree_paths(saved["tree"])
    for a, b in zip(tree_leaves(back), tree_leaves(saved["tree"])):
        assert a.dtype == torch.float32 and torch.equal(a, b)


def test_train_lm_example_takes_the_reference_defaults(capsys):
    assert train_lm.main(["--steps", "12", "--batch", "2", "--seq", "16",
                          "--lr", "3e-3", "--log-every", "1", "--device",
                          "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("arch=qwen2.5-3b family=dense")
    losses = _losses(out)
    assert len(losses) == 12 and np.mean(losses[-3:]) < np.mean(losses[:3])


def test_train_driver_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "qwen2.5-3b", "--steps", "1"])
