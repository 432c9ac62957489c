"""Train the detector family on the synthetic scene corpus and profile it:
the paper's offline profiling stage, as ``repro.detection.train``.

``train_detector`` is the reference's loop (AdamW, cosine schedule, batches
of fresh scenes from ``seed + 17``) in PyTorch autograd; ``train_all``
caches the eight models as the JAX package's ``.npz`` checkpoints, so each
package loads the other's; ``profile_pairs`` measures per-group mAP for
every (model, device) pair and assembles the ProfileTable the routers
consume.  Convolutions run in full float32 (cuDNN's TF32 off), so the GPU
agrees with the CPU and with the JAX package to f32 rounding.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.detection import scenes as sc
from repro_torch.detection.detectors import (DETECTOR_CONFIGS, Detector,
                                             DetectorConfig,
                                             decode_detections,
                                             detection_loss, encode_targets,
                                             init_detector, params_from_jax,
                                             params_to_jax)
from repro_torch.detection.devices import DEVICES, TESTBED_PAIRS
from repro_torch.device import resolve_device
from repro_torch.optim.adamw import (AdamWConfig, OptState, adamw_update,
                                     init_opt_state)


def _full_f32():
    """cuDNN with TF32 off, its other flags as the caller set them."""
    c = torch.backends.cudnn
    return c.flags(enabled=True, benchmark=c.benchmark,
                   benchmark_limit=c.benchmark_limit,
                   deterministic=c.deterministic, allow_tf32=False)


def batch_from_scenes(batch_scenes: Sequence[sc.Scene], device) -> Dict:
    """Images and grid targets in the JAX package's layout, on ``device``."""
    imgs = np.stack([s.image for s in batch_scenes])[..., None]
    objs, boxes, clss = zip(*(encode_targets(s.boxes, s.classes)
                              for s in batch_scenes))
    put = lambda a: torch.from_numpy(np.stack(a)).to(device)
    return {"image": torch.from_numpy(imgs).to(device), "obj": put(objs),
            "box": put(boxes), "cls": put(clss)}


def train_step(model: Detector, opt: OptState, batch: Dict,
               opt_cfg: AdamWConfig) -> Tuple[OptState, torch.Tensor]:
    """One step of the reference's loop on ``model`` (updated in place):
    loss and gradients by autograd, then ``adamw_update``.  Returns the new
    optimizer state and the loss before the step, on the device."""
    params = dict(model.named_parameters())
    with _full_f32():
        loss = detection_loss(model, batch)
        grads = torch.autograd.grad(loss, list(params.values()))
    with torch.no_grad():
        _, opt, _ = adamw_update(
            opt_cfg, {k: p.detach() for k, p in params.items()},
            dict(zip(params, grads)), opt)
    return opt, loss.detach()


def fit_detector(model: Detector, *, steps: int = 700, batch_size: int = 16,
                 seed: int = 0, lr: float = 5e-3,
                 verbose: bool = False) -> np.ndarray:
    """Train ``model`` in place on its device with the reference's settings;
    the per-step losses (one host read at the end)."""
    dev = next(model.parameters()).device
    opt_cfg = AdamWConfig(peak_lr=lr, warmup_steps=20, total_steps=steps,
                          weight_decay=1e-4)
    opt = init_opt_state(dict(model.named_parameters()))
    rng = np.random.default_rng(seed + 17)
    losses = []
    for i in range(steps):
        batch = batch_from_scenes(
            [sc.make_scene(rng) for _ in range(batch_size)], dev)
        opt, loss = train_step(model, opt, batch, opt_cfg)
        losses.append(loss)
        if verbose and i % 100 == 0:
            print(f"  {model.cfg.name} step {i} loss {float(loss):.4f}")
    return torch.stack(losses).cpu().numpy()


def train_detector(cfg: DetectorConfig, *, steps: int = 700,
                   batch_size: int = 16, seed: int = 0, lr: float = 5e-3,
                   verbose: bool = False, device="cuda") -> Detector:
    """A detector trained from the port's seeded ``init_detector(cfg,
    seed)`` (torch cannot draw JAX's threefry init) on ``device``."""
    model = init_detector(cfg, seed).to(resolve_device(device))
    fit_detector(model, steps=steps, batch_size=batch_size, seed=seed,
                 lr=lr, verbose=verbose)
    return model


def load_detector(path: str, name: str, *, device="cuda") -> Detector:
    """``DETECTOR_CONFIGS[name]`` from a checkpoint of either package."""
    like = params_to_jax(init_detector(DETECTOR_CONFIGS[name]))
    return params_from_jax(ckpt.load(path, like), name).to(
        resolve_device(device))


def train_all(cache_dir: str = "artifacts/detectors", *, steps: int = 700,
              verbose: bool = False, device="cuda") -> Dict[str, Detector]:
    """The eight detectors: loaded where ``cache_dir`` holds a checkpoint,
    else trained and saved there."""
    os.makedirs(cache_dir, exist_ok=True)
    out = {}
    for name, cfg in DETECTOR_CONFIGS.items():
        path = os.path.join(cache_dir, f"{name}.npz")
        if os.path.exists(path):
            out[name] = load_detector(path, name, device=device)
            continue
        if verbose:
            print(f"training {name} ...")
        out[name] = train_detector(cfg, steps=steps, verbose=verbose,
                                   device=device)
        ckpt.save(path, params_to_jax(out[name]))
    return out


def run_detector(model: Detector, images: np.ndarray, *, device="cuda"):
    """images [B,H,W] -> list of (boxes, scores, classes)."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(images, np.float32), device=dev)[..., None]
    with torch.no_grad(), _full_f32():
        raw = model.to(dev)(x).cpu().numpy()
    return [decode_detections(r) for r in raw]


def profile_pairs(detector_params: Dict[str, Detector],
                  pairs: Sequence[Tuple[str, str]],
                  val_scenes: Optional[List[sc.Scene]] = None,
                  verbose: bool = False, *, device="cuda"):
    """Measure per-group mAP for each pair; energy/time from device models.
    The detectors run on ``device``, where the table's state lives too."""
    # lazy: the core imports this module (the SF estimator's forward)
    from repro_torch.core.groups import all_groups, group_of
    from repro_torch.core.metrics import MAPAccumulator
    from repro_torch.core.profiles import ProfileEntry, ProfileTable
    device = resolve_device(device)
    if val_scenes is None:
        val_scenes = sc.full_dataset(250, seed=99)
    by_group: Dict[int, List[sc.Scene]] = {g: [] for g in all_groups()}
    for s in val_scenes:
        by_group[group_of(s.count)].append(s)
    # batch-evaluate each model once per group
    model_group_map: Dict[Tuple[str, int], float] = {}
    for m in sorted({m for m, _ in pairs}):
        for g, group_scenes in by_group.items():
            acc = MAPAccumulator(sc.NUM_CLASSES)
            if group_scenes:
                imgs = np.stack([s.image for s in group_scenes])
                dets = run_detector(detector_params[m], imgs, device=device)
                for s, (b, s_, c) in zip(group_scenes, dets):
                    acc.add_image(b, s_, c, s.boxes, s.classes)
            model_group_map[(m, g)] = acc.map()
            if verbose:
                print(f"  {m} group {g}: mAP {acc.map():.1f}")
    entries = []
    for m, d in pairs:
        dev, flops = DEVICES[d], DETECTOR_CONFIGS[m].flops
        for g in all_groups():
            entries.append(ProfileEntry(
                model=m, device=d, group=g,
                map_pct=model_group_map[(m, g)],
                time_ms=dev.time_ms(flops),
                energy_mwh=dev.energy_mwh(flops)))
    return ProfileTable(entries, device=device)


def default_testbed(cache_dir: str = "artifacts/detectors",
                    profile_path: str = "artifacts/profile_table.json",
                    verbose: bool = False, *, device="cuda"):
    """Train (or load) detectors + build (or load) the testbed profile."""
    from repro_torch.core.profiles import ProfileTable
    params = train_all(cache_dir, verbose=verbose, device=device)
    if os.path.exists(profile_path):
        table = ProfileTable.from_json(profile_path, device=device)
    else:
        table = profile_pairs(params, TESTBED_PAIRS, verbose=verbose,
                              device=device)
        os.makedirs(os.path.dirname(profile_path), exist_ok=True)
        table.to_json(profile_path)
    return params, table
