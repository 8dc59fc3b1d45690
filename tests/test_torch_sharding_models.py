"""The model code that reads the sharding ctx, against the reference:

* ``ssd_seq_parallel`` equals the reference's at n_seg 2, 4 and 8, at
  the shapes and the atol/rtol (2e-5) of the reference's own test
  (``tests/test_kernels.py::test_ssd_seq_parallel_matches_chunked``),
  and the port's plain chunked scan;
* ``_seq_shards`` and ``_dispatch_groups`` give the reference's counts
  under equal ctxs (the reference's on its fake meshes);
* ``moe_apply`` (grouped dispatch, with and without a token mask) and
  ``ssm_apply`` (the sequence-parallel branch under ``fsdp_sp``) under a
  ``ShardCtx`` of ``{data: 2, model: 2}`` equal the reference's, jitted
  under its ctx on a host mesh of four CPU devices in a subprocess
  (f32, atol/rtol 1e-5);
* under that ctx a reduced mamba2's loss and gradients, remat on, equal
  the unsharded ones, and the sequence-parallel scan runs in the forward
  and again in each layer's recompute.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.io import _flatten  # noqa: E402
from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.configs.base import SSMConfig as JSSMConfig  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.sharding import ShardCtx as JShardCtx  # noqa: E402
from repro.sharding import rules as JR  # noqa: E402
from repro.sharding.ctx import use_ctx as jax_use_ctx  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.configs.base import SSMConfig  # noqa: E402
from repro_torch.convert import params_from_flat  # noqa: E402
from repro_torch.data.inputs import make_batch  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.sharding import ShardCtx, rules, use_ctx  # noqa: E402
from repro_torch.train import make_loss_and_grads  # noqa: E402

from test_sharding import _fake_mesh  # noqa: E402
from test_torch_campaign_chaos import ONE_THREAD  # noqa: E402
from torch_one_thread import one_thread  # noqa: E402,F401
import jax_sharded_mixers as X  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5
MESH = {"data": 2, "model": 2}


def _seq_inputs():
    """The reference test's shapes: Bs 2, S 128, 4 heads of 16, g 2,
    N 16, chunk 16 (numpy draws in place of its jax.random ones)."""
    rng = np.random.default_rng(0)
    Bs, S, nh, N = 2, 128, 4, 16
    x = rng.standard_normal((Bs, S, nh, 16)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bs, S, nh)))).astype(
        np.float32)
    A = -np.exp(rng.standard_normal(nh) * 0.3).astype(np.float32)
    B = rng.standard_normal((Bs, S, 2, N)).astype(np.float32)
    C = rng.standard_normal((Bs, S, 2, N)).astype(np.float32)
    return x, dt, A, B, C


@pytest.mark.parametrize("n_seg", [2, 4, 8])
def test_ssd_seq_parallel_matches_the_reference(n_seg):
    kw = dict(d_state=16, head_dim=16, n_groups=2, chunk=16)
    args = _seq_inputs()
    jy, jh = JS.ssd_seq_parallel(*map(jnp.asarray, args), JSSMConfig(**kw),
                                 n_seg)
    ty, th = TS.ssd_seq_parallel(*map(torch.from_numpy, args),
                                 SSMConfig(**kw), n_seg)
    for got, want in ((ty, jy), (th, jh)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                                   rtol=2e-5)
    cy, ch = TS.ssd_chunked(*map(torch.from_numpy, args), SSMConfig(**kw))
    np.testing.assert_allclose(ty.numpy(), cy.numpy(), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(th.numpy(), ch.numpy(), atol=2e-5, rtol=2e-5)


GRIDS = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
         {"data": 2}, {"data": 2, "model": 2}, {"data": 3, "model": 4}]


@pytest.mark.parametrize("dims", GRIDS, ids=lambda d: "x".join(
    f"{k}{v}" for k, v in d.items()))
def test_ctx_readers_match_the_reference(dims):
    jmesh = _fake_mesh(tuple(dims.values()), tuple(dims))
    shapes = [(1, 4096), (2, 4096), (16, 128), (32, 4096), (6, 36), (8, 24)]
    for layout in ("dp", "fsdp_tp", "fsdp_sp"):
        jctx = JShardCtx(jmesh, JR.logical_axes(jmesh, layout))
        tctx = ShardCtx(dims, rules.logical_axes(dims, layout))
        for B, S in shapes:
            with jax_use_ctx(jctx):
                want = (JS._seq_shards(S), JMOE._dispatch_groups(B, S))
            with use_ctx(tctx):
                got = (TS._seq_shards(S), TMOE._dispatch_groups(B, S))
            assert got == want, (dims, layout, B, S)
    assert (TS._seq_shards(4096), TMOE._dispatch_groups(8, 4096)) == (1,
                                                                      (1, 1))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Weights and inputs, and the reference's outputs from the
    subprocess; returns (inputs, outputs)."""
    work = tmp_path_factory.mktemp("mixers")
    mcfg = jax_reduced("qwen3-moe-30b-a3b")
    scfg = jax_reduced("mamba2-2.7b")
    rng = np.random.default_rng(5)
    inp = {f"moe/{k}": v for k, v in _flatten(JMOE.moe_init(
        jax.random.PRNGKey(1), mcfg.d_model, mcfg.moe, mcfg.act,
        jnp.float32)).items()}
    inp.update({f"ssm/{k}": v for k, v in _flatten(JS.ssm_init(
        jax.random.PRNGKey(2), scfg.d_model, scfg.ssm, jnp.float32)).items()})
    inp["moe_x"] = rng.standard_normal((4, 8, mcfg.d_model)).astype(
        np.float32)
    inp["mask"] = np.arange(8)[None, :] < np.array([8, 5, 8, 2])[:, None]
    inp["ssm_x"] = rng.standard_normal((2, 128, scfg.d_model)).astype(
        np.float32)
    np.savez(work / "inputs.npz", **inp)
    env = {**os.environ, **ONE_THREAD,
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": str(ROOT / "src") + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.run([sys.executable, str(ROOT / "tests" /
                                               "jax_sharded_mixers.py"),
                           str(work)], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return inp, dict(np.load(work / "ref.npz"))


def _sub(inp, prefix):
    tree = {}
    for k, v in inp.items():
        if k.startswith(prefix):
            *parents, leaf = k[len(prefix):].split("/")
            d = tree
            for p in parents:
                d = d.setdefault(p, {})
            d[leaf] = torch.from_numpy(np.array(v))
    return tree


@pytest.mark.parametrize("layout", X.LAYOUTS)
def test_grouped_moe_matches_the_reference(reference, layout):
    inp, ref = reference
    cfg = get_reduced("qwen3-moe-30b-a3b")
    params = _sub(inp, "moe/")
    x = torch.from_numpy(inp["moe_x"])
    with use_ctx(ShardCtx(MESH, rules.logical_axes(MESH, layout))):
        groups = TMOE._dispatch_groups(*x.shape[:2])
        assert groups == ((2, 2) if layout == "fsdp_sp" else (2, 1))
        for masked in (False, True):
            mask = torch.from_numpy(inp["mask"]) if masked else None
            y, aux = TMOE.moe_apply(params, x, cfg.moe, cfg.act,
                                    token_mask=mask)
            want = ref[f"{layout}/moe/{masked}/y"]
            if masked:       # only the real tokens' outputs are defined
                keep = inp["mask"]
                y, want = y.numpy()[keep], want[keep]
            np.testing.assert_allclose(np.asarray(y), want, atol=TOL,
                                       rtol=TOL)
            np.testing.assert_allclose(float(aux),
                                       ref[f"{layout}/moe/{masked}/aux"],
                                       atol=TOL, rtol=TOL)


@pytest.mark.parametrize("layout", X.LAYOUTS)
def test_ssm_apply_takes_the_reference_branch(reference, layout,
                                              monkeypatch):
    inp, ref = reference
    cfg = get_reduced("mamba2-2.7b")
    calls = []
    real = TS.ssd_seq_parallel
    monkeypatch.setattr(TS, "ssd_seq_parallel",
                        lambda *a, **k: calls.append(a[6]) or real(*a, **k))
    with use_ctx(ShardCtx(MESH, rules.logical_axes(MESH, layout))):
        y, st = TS.ssm_apply(_sub(inp, "ssm/"), torch.from_numpy(
            inp["ssm_x"]), cfg.ssm, return_state=True)
    assert calls == ([2] if layout == "fsdp_sp" else [])
    np.testing.assert_allclose(y.numpy(), ref[f"{layout}/ssm/y"], atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(st["h"].numpy(), ref[f"{layout}/ssm/h"],
                               atol=TOL, rtol=TOL)


def test_remat_recompute_keeps_the_ctx(monkeypatch):
    """A reduced mamba2's loss and gradients under a ``seq`` extent of 2
    equal the unsharded ones; the checkpointed layers re-install the ctx,
    so the recompute takes the sequence-parallel branch too."""
    cfg = get_reduced("mamba2-2.7b")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    batch = make_batch(cfg, 2, 128, seed=1, device="cpu")
    fn = make_loss_and_grads(cfg, loss_chunk=32)
    want_loss, want = fn(params, batch)
    calls = []
    real = TS.ssd_seq_parallel
    monkeypatch.setattr(TS, "ssd_seq_parallel",
                        lambda *a, **k: calls.append(a[6]) or real(*a, **k))
    with use_ctx(ShardCtx(MESH, rules.logical_axes(MESH, "fsdp_sp"))):
        loss, grads = fn(params, batch)
    assert len(calls) == 2 * cfg.n_layers
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5,
                                   rtol=1e-4)
