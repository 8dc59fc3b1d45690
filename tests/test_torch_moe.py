"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's (``repro.models.moe``) on the same weights and inputs, made with
numpy from a seed: y and the aux loss in f32 at atol 1e-5, and in bf16;
under a capacity factor that drops tokens (the same ones); with a token
mask of right-padded rows (whole outputs, pad positions included); top-1
with a shared expert; decode-shaped input (S = 1, capacity clamped at 4);
and the gradients of y and aux against ``jax.grad``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import MoEConfig as JMoEConfig  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402

ATOL = 1e-5
# bf16: both packages round each of the three expert products and the
# combine to bf16 (one ulp = 2**-8 relative) after f32 sums taken in
# another order, so an element may differ by a few bf16 ulps of the
# output's scale
BF16_TOL = 2e-2


def _cfg(**kw):
    base = dict(n_experts=8, top_k=2, expert_d_ff=48)
    base.update(kw)
    return MoEConfig(**base), JMoEConfig(**base)


def _weights(cfg, d, act, seed=0, router_scale=1.0):
    """Numpy weights in the reference's layout (router f32 (d, E); up,
    gate (E, d, f); down (E, f, d)).  ``router_scale`` widens the router
    logits so the routing is decisive and uneven."""
    rng = np.random.default_rng(seed)
    E, f = cfg.n_experts, cfg.expert_d_ff
    w = {"router": {"w": rng.standard_normal((d, E), np.float32)
                    * router_scale / np.sqrt(d)},
         "up": rng.standard_normal((E, d, f), np.float32) / np.sqrt(d),
         "down": rng.standard_normal((E, f, d), np.float32) / np.sqrt(f)}
    if act == "silu":
        w["gate"] = rng.standard_normal((E, d, f), np.float32) / np.sqrt(d)
    return _map(w, lambda a: a.astype(np.float32))


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _pair(w, dtype):
    """(jax params, torch params): experts in ``dtype``, the router f32."""
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = getattr(torch, dtype)
    jp = _map(w, lambda a: jnp.asarray(a, jd))
    tp = _map(w, lambda a: torch.from_numpy(a).to(td))
    jp["router"]["w"] = jnp.asarray(w["router"]["w"])
    tp["router"]["w"] = torch.from_numpy(w["router"]["w"])
    return jp, tp


def _x(B, S, d, seed=1):
    return np.random.default_rng(seed).standard_normal((B, S, d),
                                                       np.float32)


def _run(w, x, tcfg, jcfg, act, dtype="float32", mask=None, **kw):
    jp, tp = _pair(w, dtype)
    jx = jnp.asarray(x, {"float32": jnp.float32,
                         "bfloat16": jnp.bfloat16}[dtype])
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    jy, jaux = JMOE.moe_apply(jp, jx, jcfg, act, token_mask=jm, **kw)
    ty, taux = TMOE.moe_apply(tp, tx, tcfg, act, token_mask=tm, **kw)
    return (np.asarray(jy.astype(jnp.float32)), float(jaux),
            ty.float().numpy(), float(taux))


def _keep(x, w, cfg, mask=None, capacity_factor=None):
    """The port's and the reference's keep masks (T, K) and capacity, from
    their own top-k and ranking helpers."""
    cf = capacity_factor or cfg.capacity_factor
    B, S, d = x.shape
    T, E, K = B * S, cfg.n_experts, cfg.top_k
    cap = max(int(T * K / E * cf), 4)
    xt = x.reshape(T, d)
    jprobs, _ = JMOE.router_probs(w, jnp.asarray(xt))
    _, jidx = JMOE._local_top_k(jprobs, K)
    tprobs, _ = TMOE.router_probs(_map(w, torch.from_numpy),
                                  torch.from_numpy(xt))
    _, tidx = TMOE._local_top_k(tprobs, K)
    if mask is not None:
        jidx = jnp.where(jnp.asarray(mask).reshape(T, 1), jidx, E)
        tidx = torch.where(torch.from_numpy(mask).reshape(T, 1), tidx, E)
    jslot = JMOE._ranks_in_expert(jidx.reshape(-1), E)
    tslot = TMOE._ranks_in_expert(tidx.reshape(-1), E)
    return (np.asarray(jslot < cap).reshape(T, K),
            (tslot < cap).numpy().reshape(T, K), cap)


@pytest.mark.parametrize("act,E,K", [("silu", 8, 2), ("gelu", 4, 1),
                                     ("silu", 16, 4)])
def test_moe_apply_matches_reference_f32(act, E, K):
    tcfg, jcfg = _cfg(n_experts=E, top_k=K)
    w = _weights(tcfg, 32, act)
    x = _x(3, 10, 32)
    jy, jaux, ty, taux = _run(w, x, tcfg, jcfg, act)
    np.testing.assert_allclose(ty, jy, atol=ATOL, rtol=0)
    np.testing.assert_allclose(taux, jaux, atol=ATOL, rtol=0)
    assert taux > 0


def test_moe_apply_matches_reference_bf16():
    tcfg, jcfg = _cfg()
    w = _weights(tcfg, 64, "silu", seed=2)
    x = _x(2, 16, 64, seed=3)
    jy, jaux, ty, taux = _run(w, x, tcfg, jcfg, "silu", dtype="bfloat16")
    scale = np.abs(jy).max()
    np.testing.assert_allclose(ty, jy, atol=BF16_TOL * scale,
                               rtol=BF16_TOL)
    # the router reads the same bf16 x in f32 in both: the aux is f32
    np.testing.assert_allclose(taux, jaux, atol=ATOL, rtol=0)


def test_capacity_drops_the_same_tokens():
    """A capacity factor of 0.5 and a wide router: the same assignments
    are kept and dropped, and the outputs agree."""
    tcfg, jcfg = _cfg(n_experts=4, top_k=2)
    w = _weights(tcfg, 32, "silu", seed=4, router_scale=4.0)
    x = _x(4, 16, 32, seed=5)
    jkeep, tkeep, cap = _keep(x, w, tcfg, capacity_factor=0.5)
    np.testing.assert_array_equal(tkeep, jkeep)
    assert (~tkeep).sum() > 10 and cap == 16
    jy, jaux, ty, taux = _run(w, x, tcfg, jcfg, "silu",
                              capacity_factor=0.5)
    np.testing.assert_allclose(ty, jy, atol=ATOL, rtol=0)
    np.testing.assert_allclose(taux, jaux, atol=ATOL, rtol=0)
    # a token whose every assignment was dropped gets a zero output
    gone = (~tkeep).all(axis=1)
    assert gone.any()
    assert np.all(ty.reshape(-1, 32)[gone] == 0)


def test_token_mask_of_right_padded_rows():
    """Rows of lengths 16, 9 and 0 (a dummy row): pads claim no capacity,
    and the whole outputs compare, pad positions included (the gather
    reads expert E - 1 for them in both packages)."""
    tcfg, jcfg = _cfg(n_experts=4, top_k=2)
    w = _weights(tcfg, 32, "silu", seed=6, router_scale=4.0)
    x = _x(3, 16, 32, seed=7)
    mask = np.arange(16)[None, :] < np.array([16, 9, 0])[:, None]
    jkeep, tkeep, _ = _keep(x, w, tcfg, mask=mask, capacity_factor=0.6)
    np.testing.assert_array_equal(tkeep, jkeep)
    jy, jaux, ty, taux = _run(w, x, tcfg, jcfg, "silu", mask=mask,
                              capacity_factor=0.6)
    np.testing.assert_allclose(ty, jy, atol=ATOL, rtol=0)
    np.testing.assert_allclose(taux, jaux, atol=ATOL, rtol=0)
    # the pads differ from an unmasked run's outputs: the mask acts
    _, _, ty_all, _ = _run(w, x, tcfg, jcfg, "silu", capacity_factor=0.6)
    assert not np.allclose(ty_all, ty)


def test_top1_with_shared_expert():
    """llama4's FFN: top-1 routing plus a shared SwiGLU expert."""
    tcfg, jcfg = _cfg(n_experts=4, top_k=1, shared_expert=True)
    d, f = 32, 40
    w = _weights(tcfg, d, "silu", seed=8)
    rng = np.random.default_rng(9)
    shared = {n: {"w": (rng.standard_normal(s) / np.sqrt(s[0])).astype(
                  np.float32)}
              for n, s in (("up", (d, f)), ("gate", (d, f)),
                           ("down", (f, d)))}
    x = _x(2, 12, d, seed=10)
    jy, jaux, ty, taux = _run(w, x, tcfg, jcfg, "silu")
    jy = jy + np.asarray(JL.mlp_apply(_map(shared, jnp.asarray),
                                      jnp.asarray(x), "silu"))
    ty = ty + TL.mlp_apply(_map(shared, torch.from_numpy),
                           torch.from_numpy(x), "silu").numpy()
    np.testing.assert_allclose(ty, jy, atol=ATOL, rtol=0)
    np.testing.assert_allclose(taux, jaux, atol=ATOL, rtol=0)


def test_decode_shaped_input():
    """8 rows of one token: T*K/E*cf = 2.5, so the capacity is clamped at
    4 and an expert that more than 4 rows pick drops the rest."""
    tcfg, jcfg = _cfg(n_experts=32, top_k=8)
    w = _weights(tcfg, 32, "silu", seed=11, router_scale=3.0)
    x = _x(8, 1, 32, seed=12)
    jkeep, tkeep, cap = _keep(x, w, tcfg)
    assert cap == 4
    np.testing.assert_array_equal(tkeep, jkeep)
    jy, jaux, ty, taux = _run(w, x, tcfg, jcfg, "silu")
    np.testing.assert_allclose(ty, jy, atol=ATOL, rtol=0)
    np.testing.assert_allclose(taux, jaux, atol=ATOL, rtol=0)


def test_top_k_ties_and_sentinel_ranks():
    """Ties go to the first index in both top-ks; the sentinel E ranks as
    its own segment and never shifts a real expert's ranks."""
    probs = np.array([[0.3, 0.3, 0.2, 0.2], [0.1, 0.4, 0.4, 0.1]],
                     np.float32)
    jv, ji = JMOE._local_top_k(jnp.asarray(probs), 3)
    tv, ti = TMOE._local_top_k(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert ti.tolist() == [[0, 1, 2], [1, 2, 0]]
    ids = np.array([2, 4, 0, 2, 4, 1, 2, 0, 4], np.int32)
    want = np.asarray(JMOE._ranks_in_expert(jnp.asarray(ids), 4))
    got = TMOE._ranks_in_expert(torch.from_numpy(ids).long(), 4).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [0, 0, 0, 1, 1, 0, 2, 1, 2]


def test_load_balance_loss_matches_reference():
    rng = np.random.default_rng(16)
    probs = rng.dirichlet(np.ones(6), size=20).astype(np.float32)
    mask = (rng.random((20, 6)) < 0.3).astype(np.float32)
    want = JMOE.load_balance_loss(jnp.asarray(probs), jnp.asarray(mask))
    got = TMOE.load_balance_loss(torch.from_numpy(probs),
                                 torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("mask_rows", [None, [12, 5]])
def test_gradients_match_jax_grad(mask_rows):
    """d/d(x, router, up, gate, down) of sum(y * r) + aux, f32."""
    tcfg, jcfg = _cfg(n_experts=4, top_k=2)
    w = _weights(tcfg, 24, "silu", seed=13, router_scale=2.0)
    x = _x(2, 12, 24, seed=14)
    r = np.random.default_rng(15).standard_normal(x.shape, np.float32)
    mask = None if mask_rows is None else (
        np.arange(12)[None, :] < np.array(mask_rows)[:, None])

    def jloss(p, xx):
        y, aux = JMOE.moe_apply(p, xx, jcfg, "silu",
                                token_mask=None if mask is None
                                else jnp.asarray(mask))
        return jnp.sum(y * jnp.asarray(r)) + aux

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(_map(w, jnp.asarray),
                                               jnp.asarray(x))
    tp = _map(w, lambda a: torch.from_numpy(a).requires_grad_(True))
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = TMOE.moe_apply(tp, tx, tcfg, "silu",
                            token_mask=None if mask is None
                            else torch.from_numpy(mask))
    (y * torch.from_numpy(r)).sum().add(aux).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=ATOL,
                               rtol=0)
    for path in (("router", "w"), ("up",), ("gate",), ("down",)):
        want, got = jg, tp
        for k in path:
            want, got = want[k], got[k]
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=0, err_msg=str(path))


def test_moe_init_router_is_f32():
    cfg = dataclasses.replace(_cfg()[0], expert_d_ff=16)
    p = TMOE.moe_init(torch.Generator().manual_seed(0), 32, cfg, "silu",
                      torch.bfloat16, "cpu")
    assert p["router"]["w"].dtype == torch.float32
    assert p["up"].dtype == p["gate"].dtype == p["down"].dtype == \
        torch.bfloat16
    assert p["up"].shape == (8, 32, 16) and p["down"].shape == (8, 16, 32)
    assert "gate" not in TMOE.moe_init(torch.Generator().manual_seed(0), 32,
                                       cfg, "gelu", torch.float32, "cpu")
