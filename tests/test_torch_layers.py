"""The port's layers against their JAX twins in f32, on the same numpy
inputs, at atol 1e-5."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

ATOL = 1e-5
RNG = np.random.default_rng(7)


def _rand(*shape, scale=1.0):
    return (RNG.standard_normal(shape, dtype=np.float32) * scale)


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               atol=atol, rtol=0)


def _both(tree):
    """numpy tree -> (jax tree, torch tree)."""
    if isinstance(tree, dict):
        pairs = {k: _both(v) for k, v in tree.items()}
        return ({k: p[0] for k, p in pairs.items()},
                {k: p[1] for k, p in pairs.items()})
    return jnp.asarray(tree), torch.from_numpy(tree)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_apply(kind):
    p = {"scale": 1 + _rand(48, scale=0.1)}
    if kind == "layernorm":
        p["bias"] = _rand(48, scale=0.1)
    jp, tp = _both(p)
    x = _rand(3, 5, 48, scale=2.0)
    _close(TL.norm_apply(kind, tp, torch.from_numpy(x)),
           JL.norm_apply(kind, jp, jnp.asarray(x)))


def test_apply_rope():
    x = _rand(2, 9, 4, 32)
    pos = RNG.integers(0, 500, size=(2, 9)).astype(np.int32)
    _close(TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4))


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_apply(act):
    p = {"up": {"w": _rand(32, 64, scale=0.2)},
         "down": {"w": _rand(64, 32, scale=0.2)}}
    if act == "silu":
        p["gate"] = {"w": _rand(32, 64, scale=0.2)}
    jp, tp = _both(p)
    x = _rand(2, 7, 32)
    _close(TL.mlp_apply(tp, torch.from_numpy(x), act),
           JL.mlp_apply(jp, jnp.asarray(x), act))


def _attn_params(d, H, Kh, hd):
    return {"wq": {"w": _rand(d, H * hd, scale=0.1)},
            "wk": {"w": _rand(d, Kh * hd, scale=0.1)},
            "wv": {"w": _rand(d, Kh * hd, scale=0.1)},
            "wo": {"w": _rand(H * hd, d, scale=0.1)}}


ATTN_CASES = [
    # H, Kh, causal, window, S
    (4, 2, True, None, 24),
    (4, 1, True, 8, 24),      # window < S: set, and exercised
    (4, 4, False, None, 17),
    (4, 2, True, 64, 24),     # window >= S: dropped
]


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("backend", ["torch", "cuda", "auto"])
def test_attn_apply(case, backend):
    H, Kh, causal, window, S = case
    d, hd = 32, 16
    jp, tp = _both(_attn_params(d, H, Kh, hd))
    x = _rand(2, S, d)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()
    jspec = JL.AttnSpec(n_heads=H, n_kv_heads=Kh, head_dim=hd, causal=causal,
                        window=window, backend="jnp")
    tspec = TL.AttnSpec(n_heads=H, n_kv_heads=Kh, head_dim=hd, causal=causal,
                        window=window, backend=backend)
    jout, (jk, jv) = JL.attn_apply(jp, jnp.asarray(x), jspec,
                                   jnp.asarray(pos), return_kv=True)
    tout, (tk, tv) = TL.attn_apply(tp, torch.from_numpy(x), tspec,
                                   torch.from_numpy(pos), return_kv=True)
    _close(tout, jout)
    _close(tk, jk)
    _close(tv, jv)


@pytest.mark.parametrize("cache_len,lengths", [
    (32, None), (8, None), (32, [11, 4, 1]), (8, [11, 4, 0])])
def test_kv_to_cache(cache_len, lengths):
    k, v = _rand(3, 11, 2, 16), _rand(3, 11, 2, 16)
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    tl = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    jc = JL.kv_to_cache(jnp.asarray(k), jnp.asarray(v), cache_len,
                        jnp.float32, lengths=jl)
    tc = TL.kv_to_cache(torch.from_numpy(k), torch.from_numpy(v), cache_len,
                        torch.float32, lengths=tl)
    _close(tc["k"], jc["k"], atol=0)
    _close(tc["v"], jc["v"], atol=0)


@pytest.mark.parametrize("window", [None, 6])
def test_attn_decode(window):
    d, H, Kh, hd, L, B = 32, 4, 2, 16, 16, 3
    jp, tp = _both(_attn_params(d, H, Kh, hd))
    cache = {"k": _rand(B, L, Kh, hd), "v": _rand(B, L, Kh, hd)}
    x = _rand(B, 1, d)
    position = np.array([3, 15, 40], np.int32)   # unfilled, full, wrapped
    jspec = JL.AttnSpec(n_heads=H, n_kv_heads=Kh, head_dim=hd, window=window)
    tspec = TL.AttnSpec(n_heads=H, n_kv_heads=Kh, head_dim=hd, window=window)
    jout, jcache = JL.attn_decode(
        jp, {k: jnp.asarray(v) for k, v in cache.items()}, jnp.asarray(x),
        jspec, jnp.asarray(position))
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    tout, tcache2 = TL.attn_decode(tp, tcache, torch.from_numpy(x), tspec,
                                   torch.from_numpy(position))
    assert tcache2 is tcache                       # updated in place
    _close(tout, jout)
    _close(tcache["k"], jcache["k"])
    _close(tcache["v"], jcache["v"])
