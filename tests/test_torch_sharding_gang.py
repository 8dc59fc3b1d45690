"""The parameter-sharded layouts on a world-2 gang (gloo on the CPU, one
thread a rank): ``fsdp_tp`` and ``fsdp_sp`` on the data grid
``{"data": 2}``, where the reference's rules make both pure ZeRO-3.

One gang of ``torch_sharding_worker.py`` per module computes, for reduced
f32 stablelm, mamba2 and qwen3-moe under both layouts, the sharded loss
and gradients, one AdamW and one LAMB step, and the flat-key round trip.
They are held against:

* the port's world-1 step on the same weights and global batch, run
  under the reference's ctx for the mesh (``shard_ctx_for({"data": 2},
  layout)``), which makes the MoE dispatch each half of the rows as a
  group, as the ranks do: the loss, the gradients and the steps' loss and
  ``grad_norm`` (loss rtol 1e-5; the rest atol 1e-5, rtol 1e-4: f32 sums
  in another order, as in ``test_torch_distributed.py``);
* the unsharded optimizer: AdamW and LAMB (whose trust ratio takes the
  whole leaves' norms from the shards) applied by the gang equal the
  world-1 update of the same parameters by the gang's own gradients
  (within the same tolerance; a world-1 gradient may differ in its last
  bits, and Adam's first step divides each entry by its own magnitude);
* the rules: each rank holds exactly its spec's share of each leaf, and
  its gradients come back in the same shapes;
* the analytic model's mechanisms: the gathers move ``(N-1)/N`` of the
  sharded bytes once for the outer leaves and twice for the layers
  (forward and remat), the reduce-scatter once;
* the reference's own ``build_train(cfg, mesh{data: 2}, layout)`` run on
  two host CPU devices in a subprocess from the same weights and batch:
  its loss and ``grad_norm`` (before the optimizer) within the same
  tolerances.

A grid of one rank is the ``dp`` step bit for bit.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint.io import _flatten  # noqa: E402
from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.convert import params_from_flat, params_to_flat  # noqa: E402
from repro_torch.distributed import free_port, init_distributed  # noqa: E402
from repro_torch.launch.steps import build_train, shard_ctx_for  # noqa: E402
from repro_torch.models.model import period_len  # noqa: E402
from repro_torch.optim import get_optimizer  # noqa: E402
from repro_torch.sharding import rules, use_ctx  # noqa: E402
from repro_torch.sharding.grid import data_grid  # noqa: E402
from repro_torch.train import make_loss_and_grads, make_train_step  # noqa: E402
from repro_torch.train.step import TrainState  # noqa: E402
from repro_torch.tree import tree_leaves, tree_unflatten  # noqa: E402

from test_torch_campaign_chaos import ONE_THREAD  # noqa: E402
from torch_one_thread import one_thread  # noqa: E402,F401
import torch_sharding_worker as W  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
MESH = {"data": 2}
LOSS_RTOL, GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-5, 1e-4
KEY = 11


def _env(**extra):
    src = str(ROOT / "src")
    path = os.environ.get("PYTHONPATH", "")
    return {**os.environ, **ONE_THREAD, **extra,
            "PYTHONPATH": src + (os.pathsep + path if path else "")}


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """The weights and batches, the gang, and the reference's sharded
    step; returns the work directory."""
    work = tmp_path_factory.mktemp("shard_gang")
    for arch in W.ARCHS:
        np.savez(work / f"{arch}.params.npz",
                 **_flatten(JM.init_params(jax.random.PRNGKey(KEY),
                                           jax_reduced(arch))))
        np.save(work / f"{arch}.tokens.npy", np.random.default_rng(4)
                .integers(0, get_reduced(arch).vocab, size=(W.B, W.S))
                .astype(np.int32))
    coordinator = f"127.0.0.1:{free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_sharding_worker.py"),
         str(r), coordinator, str(work)], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    ref = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "jax_sharded_step.py"),
         str(work), str(KEY)],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=2"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    outs = [p.communicate(timeout=400)[0] for p in procs + [ref]]
    assert [p.returncode for p in procs + [ref]] == [0, 0, 0], outs
    return work


def _world1(arch, layout, work):
    """The port's world-1 loss, gradients and steps on the global batch,
    under the mesh's ctx."""
    cfg = get_reduced(arch)
    flat = dict(np.load(work / f"{arch}.params.npz"))
    batch = W.global_batch(work, arch)
    out = {}
    with use_ctx(shard_ctx_for(MESH, layout)):
        params = params_from_flat(flat, cfg, device="cpu")
        loss, grads = make_loss_and_grads(cfg, loss_chunk=W.CHUNK)(params,
                                                                   batch)
        out["loss"] = float(loss)
        out["grad"] = params_to_flat(tree_unflatten(params, grads),
                                     period_len(cfg))
        for name in (cfg.optimizer, "lamb"):
            opt = get_optimizer(name)
            step = make_train_step(cfg, opt, lr_schedule=lambda s: W.LR,
                                   loss_chunk=W.CHUNK)
            p = params_from_flat(flat, cfg, device="cpu")
            _, metrics = step(TrainState(p, opt.init(p), 0), batch)
            out[name] = {k: float(metrics[k]) for k in ("loss",
                                                        "grad_norm")}
    return out


def _update(arch, name, work, grads_flat):
    """World 1's update of the weights by ``grads_flat`` (the gang's
    gradients, gathered)."""
    cfg = get_reduced(arch)
    p = params_from_flat(dict(np.load(work / f"{arch}.params.npz")), cfg,
                         device="cpu")
    g = params_from_flat(grads_flat, cfg, device="cpu")
    opt = get_optimizer(name)
    opt.update(g, opt.init(p), p, 0, W.LR)
    return params_to_flat(p, period_len(cfg))


def _load(work, rank, arch, layout):
    tag = f"rank{rank}.{arch}.{layout}"
    return (dict(np.load(work / f"{tag}.npz")),
            json.loads((work / f"{tag}.json").read_text()))


def _close(got, want, what):
    np.testing.assert_allclose(got, want, atol=GRAD_ATOL, rtol=GRAD_RTOL,
                               err_msg=what)


@pytest.mark.parametrize("arch,layout", W.CASES)
def test_sharded_loss_and_grads_equal_world1(gang, arch, layout):
    want = _world1(arch, layout, gang)
    for rank in range(2):
        got, info = _load(gang, rank, arch, layout)
        np.testing.assert_allclose(float(got["loss"]), want["loss"],
                                   rtol=LOSS_RTOL)
        for key, w in want["grad"].items():
            _close(got[f"grad/{key}"], w, f"{arch} {layout} grad {key}")
        grads = {k[len("grad/"):]: v for k, v in got.items()
                 if k.startswith("grad/")}
        for name in (get_reduced(arch).optimizer, "lamb"):
            metrics = want[name]
            np.testing.assert_allclose(info[name]["loss"], metrics["loss"],
                                       rtol=LOSS_RTOL)
            _close(info[name]["grad_norm"], metrics["grad_norm"],
                   f"{arch} {layout} {name} grad_norm")
            for key, w in _update(arch, name, gang, grads).items():
                _close(got[f"{name}/{key}"], w, f"{arch} {layout} {name} "
                       f"{key}")
        assert info["round_trip_bitwise"]


@pytest.mark.parametrize("arch,layout", W.CASES)
def test_each_rank_holds_its_share(gang, arch, layout):
    """Shard shapes by the rules, gradients in the same shapes, and the
    collective bytes by the analytic model's mechanisms."""
    cfg = get_reduced(arch)
    params = params_from_flat(dict(np.load(gang / f"{arch}.params.npz")),
                              cfg, device="cpu")
    specs = tree_leaves(rules.param_shardings(params, MESH, layout))
    leaves = tree_leaves(params)
    want = [list(rules.shard_shape(t.shape, s, MESH))
            for t, s in zip(leaves, specs)]
    assert any(w != list(t.shape) for w, t in zip(want, leaves))
    sharded = [t.numel() * 4 for t, s in zip(leaves, specs) if any(s)]
    layer = sum(t.numel() * 4 for i, (t, s) in enumerate(zip(
        tree_leaves(params["layers"]), tree_leaves(
            rules.param_shardings(params, MESH, layout)["layers"])))
        if any(s))
    outer = sum(sharded) - layer
    for rank in range(2):
        _, info = _load(gang, rank, arch, layout)
        assert info["shard_shapes"] == want
        assert info["grad_shapes"] == want
        b = info["bytes"]
        assert b["grad_reducescatter"] == sum(sharded) / 2
        assert b["fsdp_allgather"] == (outer + 2 * layer) / 2
        replicated = sum(t.numel() * 4 for t, s in zip(leaves, specs)
                         if not any(s))
        assert b["replicated_allreduce"] == replicated + 4   # and the loss


@pytest.mark.parametrize("arch,layout", W.CASES)
def test_matches_the_reference_sharded_step(gang, arch, layout):
    """The reference's ``build_train`` on a two-device data mesh: loss
    and grad_norm before its update."""
    ref = json.loads((gang / f"ref.{arch}.{layout}.json").read_text())
    _, info = _load(gang, 0, arch, layout)
    got = info[get_reduced(arch).optimizer]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=LOSS_RTOL)
    _close(got["grad_norm"], ref["grad_norm"], f"{arch} {layout} grad_norm")


@pytest.mark.parametrize("layout", ["fsdp_tp", "fsdp_sp"])
def test_a_grid_of_one_is_the_dp_step(layout):
    """``build_train`` on a grid of one rank under a sharded layout is
    the ``dp`` step, bit for bit."""
    cfg = get_reduced("stablelm-1.6b")
    grid = data_grid(init_distributed(1, device="cpu"))
    runs = []
    for lay, g in ((layout, grid), ("dp", None)):
        step, (state, batch) = build_train(cfg, 2, 16, device="cpu",
                                           layout=lay, grid=g, seed=3)
        metrics = [step(state, batch)[1] for _ in range(2)]
        runs.append(([float(m["loss"]) for m in metrics],
                     tree_leaves(state.params)))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
