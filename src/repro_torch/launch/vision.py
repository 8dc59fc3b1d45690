"""Vision launcher: the paper's burned-area segmentation study and its
deforestation change-detection study.

``python -m repro_torch.launch.vision [--device cpu] [--models unet,unetpp]``

Port of the functions of ``examples/burned_area_grid.py`` (synthetic
Sentinel-2 scenes -> percentile normalization -> chipping -> a U-Net
family model trained on the chips -> validation metrics) and of
``examples/deforestation_changeformer.py`` (scene pairs -> NIR-R-G
composites -> ChangeFormer -> change-class test metrics).  Every scene and
composite is normalized on the device by ``percentile_normalize``, whose
stretch is the hand-written CUDA kernel K5 on a card, where the examples
call the numpy ``percentile_stretch``.  The examples' ``ExperimentGrid`` /
``Orchestrator`` layer waits for the port of api/campaign.  Runs on
``cuda`` unless ``device`` (``--device``) says otherwise.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.data.chipping import dedup_chips, make_chips, split_by_raster
from repro_torch.data.loader import ChipLoader, prefetch
from repro_torch.data.rasters import synth_change_pair, synth_raster
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.percentile_norm import percentile_normalize
from repro_torch.kernels.percentile_norm.kernel import percentile_norm_kernel
from repro_torch.models.changeformer import (changeformer_apply,
                                             changeformer_init,
                                             changeformer_loss)
from repro_torch.models.segmentation import (SEG_MODELS, seg_apply, seg_init,
                                             seg_loss, seg_metrics)
from repro_torch.optim import get_optimizer
from repro_torch.tree import tree_leaves, tree_unflatten


def build_dataset(n_scenes: int = 4, size: int = 192, chip: int = 64,
                  device=None, *, min_frac: float = 0.08,
                  on_scene=None) -> dict:
    """Synthetic burned-area scenes, each normalized on ``device``, chipped
    on the host (overlap 0.25; the example keeps chips with both classes
    at ``min_frac`` 0.08, the paper's recipe 0.10), de-duplicated and split
    by raster (0.7 / 0.15 / 0.15).
    ``on_scene(scene, normalized)``, if given, sees each scene and its
    normalized raster (a tensor on ``device``) before it is chipped."""
    device = resolve_device(device)
    chips = []
    for i in range(n_scenes):
        scene = synth_raster(f"ba-scene-{i}", size, size, seed=i)
        norm = percentile_normalize(torch.from_numpy(scene.raster).to(device))
        if on_scene is not None:
            on_scene(scene, norm)
        img = norm[..., :3].cpu().numpy()
        chips.extend(make_chips(img, scene.mask, scene.scene_id, chip=chip,
                                overlap=0.25, min_frac=min_frac))
    chips = dedup_chips(chips)
    return split_by_raster(chips, fractions=(0.7, 0.15, 0.15))


def train_step(loss_fn, params, opt, opt_state, step: int, lr: float):
    """One optimizer step on ``loss_fn(params)``: the parameters and the
    optimizer state are updated in place.  Returns the loss, detached."""
    leaves = tree_leaves(params)
    loss = loss_fn(params)
    grads = torch.autograd.grad(loss, leaves)
    opt.update(tree_unflatten(params, list(grads)), opt_state, params, step,
               lr)
    return loss.detach()


def _trainable(params):
    for t in tree_leaves(params):
        t.requires_grad_(True)
    return params


def _to_device(arrays, device, dtype=None):
    t = torch.from_numpy(np.stack(arrays))
    return t.to(device, dtype) if dtype is not None else t.to(device)


def _floats(metrics: dict) -> dict:
    return {k: float(v) for k, v in metrics.items()}


def train_segmentation(name: str, split: dict, *, lr: float = 1e-3,
                       optimizer: str = "adam", epochs: int = 4,
                       batch: int = 4, width: int = 8, device=None,
                       seed: int = 0) -> dict:
    """The burned-area example's ``train_unet`` payload for any
    ``SEG_MODELS`` name: ``epochs`` over the train chips in batches of
    ``batch`` (``ChipLoader``, seed 0, the last batch short), then the val
    metrics.  Also returns the per-step losses and the wall times."""
    if not split["val"]:
        raise ValueError("the split has no val chips to score")
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = _trainable(seg_init(name, gen, width=width, device=device))
    opt = get_optimizer(optimizer)
    state = opt.init(params)
    loader = ChipLoader(split["train"], batch_size=batch, seed=0,
                        drop_last=False)
    losses, step, first_s = [], 0, None
    t0 = time.perf_counter()
    for _ in range(epochs):
        for x, m in prefetch(loader, device=device):
            losses.append(train_step(
                lambda p: seg_loss(name, p, x, m), params, opt, state, step,
                lr))
            step += 1
            if first_s is None:
                losses[0].item()    # waits for the device
                first_s = time.perf_counter() - t0
    losses = torch.stack(losses).tolist()
    train_s = time.perf_counter() - t0
    with torch.no_grad():
        vx = _to_device([c.image for c in split["val"]], device)
        vm = _to_device([c.mask for c in split["val"]], device, torch.int32)
        metrics = _floats(seg_metrics(seg_apply(name, params, vx), vm))
    return {"model": name, "params": sum(t.numel() for t in
                                         tree_leaves(params)),
            "steps": step, "chips_seen": len(split["train"]) * epochs,
            "losses": losses, "train_s": train_s, "first_step_s": first_s,
            **metrics}


def nir_rg_normalize(img: np.ndarray, device) -> torch.Tensor:
    """The NIR-R-G composite of a 4-band raster (``data.normalize.nir_rg``:
    red 0, green 1, NIR 3), percentile-normalized on ``device``."""
    comp = np.stack([img[..., 3], img[..., 0], img[..., 1]], axis=-1)
    return percentile_normalize(torch.from_numpy(comp).to(device))


def build_pairs(n: int = 6, size: int = 64, device=None) -> list:
    """``n`` synthetic deforestation pairs: (before, after) NIR-R-G
    composites normalized on ``device``, and the int32 change mask."""
    device = resolve_device(device)
    pairs = []
    for i in range(n):
        a, b, m = synth_change_pair(f"defo-{i}", size, size, bands=4, seed=i)
        pairs.append((nir_rg_normalize(a, device), nir_rg_normalize(b, device),
                      torch.from_numpy(m.astype(np.int32)).to(device)))
    return pairs


def train_changeformer(pairs: list, *, lr: float = 1e-3, steps: int = 60,
                       n_train: int = 4, device=None, seed: int = 0) -> dict:
    """The deforestation example's recipe: ChangeFormer at its defaults,
    AdamW, ``steps`` full-batch steps on the first ``n_train`` pairs, then
    the change-class metrics on the rest."""
    if len(pairs) <= n_train:
        raise ValueError(f"{len(pairs)} pairs leave none to test after "
                         f"{n_train} to train on")
    device = resolve_device(device)

    def stack(rows, k):
        return torch.stack([p[k] for p in rows]).to(device)
    train, test = pairs[:n_train], pairs[n_train:]
    xa, xb, ym = (stack(train, k) for k in range(3))
    gen = torch.Generator(device=device).manual_seed(seed)
    params = _trainable(changeformer_init(gen, in_ch=3, device=device))
    opt = get_optimizer("adamw")   # paper: AdamW optimal for ChangeFormer
    state = opt.init(params)
    losses = []
    t0 = time.perf_counter()
    for i in range(steps):
        losses.append(train_step(
            lambda p: changeformer_loss(p, xa, xb, ym), params, opt, state, i,
            lr))
    losses = torch.stack(losses).tolist()
    train_s = time.perf_counter() - t0
    with torch.no_grad():
        logits = changeformer_apply(params, *(stack(test, k)
                                              for k in range(2)))
        metrics = _floats(seg_metrics(logits, stack(test, 2)))
    return {"model": "changeformer",
            "params": sum(t.numel() for t in tree_leaves(params)),
            "steps": steps, "losses": losses, "train_s": train_s, **metrics}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    ap.add_argument("--models", default="unet",
                    help=f"comma-separated of {sorted(SEG_MODELS)}")
    ap.add_argument("--scenes", type=int, default=4)
    ap.add_argument("--size", type=int, default=192)
    ap.add_argument("--chip", type=int, default=64)
    ap.add_argument("--optimizer", default="adam")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--pair-size", type=int, default=64)
    ap.add_argument("--cf-steps", type=int, default=60)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    n0 = percentile_norm_kernel.launches
    split = build_dataset(args.scenes, args.size, args.chip, device)
    out = {"device": str(device),
           "chips": {k: len(v) for k, v in split.items()}, "models": []}
    for name in args.models.split(","):
        res = train_segmentation(
            name, split, lr=args.lr, optimizer=args.optimizer,
            epochs=args.epochs, device=device)
        out["models"].append({k: v for k, v in res.items() if k != "losses"}
                             | {"final_loss": res["losses"][-1]})
    pairs = build_pairs(args.pairs, args.pair_size, device)
    res = train_changeformer(pairs, steps=args.cf_steps, device=device)
    out["changeformer"] = ({k: v for k, v in res.items() if k != "losses"}
                           | {"final_loss": res["losses"][-1]})
    out["percentile_norm_launches"] = percentile_norm_kernel.launches - n0
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
