"""K1-K3's query offset on the CPU: a sequence-parallel rank's block of
queries at absolute positions ``q_offset + i`` against every key.

* The plain versions (``attention_ref``, ``attention_bwd_ref``) with
  ``q_offset`` against the reference's ``naive_attention(q_offset=...)``
  in f32 (its forward and ``jax.grad``), and against rows ``[q_offset,
  q_offset + Sq)`` of the whole sequence's result: causal and windowed,
  GQA and hd 80.
* The port's ``naive_attention`` with ``q_offset`` against the
  reference's, and ``flash_attention`` (the differentiable op, on CPU
  tensors) against both.
* ``meta.valid_pairs`` with an offset: the plain mask's admitted pairs,
  and the meta operators' ``FlopCounterMode`` count of K1-K3 at them; the
  non-causal unwindowed count (the offset binds nothing) equals
  ``FlopCounterMode``'s count of the plain forward.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.models.layers import naive_attention as jax_naive  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention import meta as FM  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_bwd_ref, attention_mask, attention_ref)
from repro_torch.models.layers import naive_attention  # noqa: E402

from torch_one_thread import one_thread  # noqa: E402,F401

ATOL, RTOL = 2e-5, 1e-5
# B, Sq, Sk, H, Kh, hd, causal, window, q_offset: a rank's block of a
# causal, windowed, non-causal and hd-80 sequence, GQA, a ragged block
CASES = [
    (2, 16, 32, 4, 2, 16, True, None, 16),
    (2, 16, 32, 4, 1, 16, True, 7, 16),
    (1, 24, 48, 4, 4, 80, False, 10, 24),
    (1, 24, 48, 4, 2, 80, True, None, 24),
    (2, 13, 40, 6, 3, 32, True, 9, 21),
    (1, 16, 32, 2, 2, 16, True, None, 0),
]
IDS = [f"sq{c[1]}_sk{c[2]}_hd{c[5]}_{'c' if c[6] else 'nc'}_w{c[7]}_"
       f"o{c[8]}" for c in CASES]


def _inputs(B, Sq, Sk, H, Kh, hd, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Sk, H, hd), (B, Sk, Kh, hd), (B, Sk, Kh, hd)))
    return q, k, v


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL, err_msg=what)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_versions_with_an_offset(case):
    """Forward and backward of the block against the reference's
    ``naive_attention(q_offset=...)`` and against the whole sequence's
    rows of the block."""
    B, Sq, Sk, H, Kh, hd, causal, window, off = case
    q_all, k, v = _inputs(B, Sq, Sk, H, Kh, hd)
    q = q_all[:, off:off + Sq]
    rng = np.random.default_rng(1)
    do = rng.standard_normal(q.shape).astype(np.float32)
    kw = dict(causal=causal, window=window)

    def ref_loss(q, k, v):
        return jnp.sum(jax_naive(q, k, v, q_offset=off, **kw) * do)

    want_o = jax_naive(q, k, v, q_offset=off, **kw)
    want_g = jax.grad(ref_loss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = attention_ref(tq, tk, tv, q_offset=off, **kw)
    _close(out, want_o, "out vs the reference")
    grads = attention_bwd_ref(tq, tk, tv, out, lse, tdo, q_offset=off, **kw)
    for name, g, w in zip("qkv", grads, want_g):
        _close(g, w, f"d{name} vs jax.grad")
    # the block's rows of the whole sequence's attention
    whole, whole_lse = attention_ref(torch.from_numpy(q_all), tk, tv, **kw)
    _close(out, whole[:, off:off + Sq], "out vs the whole sequence's rows")
    rows = whole_lse.reshape(B, H, Sk)[:, :, off:off + Sq].reshape(B * H, Sq)
    _close(lse, rows, "lse vs the whole sequence's rows")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_naive_and_flash_attention_with_an_offset(case):
    """The port's ``naive_attention`` and the differentiable
    ``flash_attention`` (CPU tensors: the plain versions) against the
    reference's ``naive_attention``, the gradients against ``jax.grad``."""
    B, Sq, Sk, H, Kh, hd, causal, window, off = case
    q_all, k, v = _inputs(B, Sq, Sk, H, Kh, hd, seed=2)
    q = q_all[:, off:off + Sq]
    kw = dict(causal=causal, window=window, q_offset=off)
    want = jax_naive(q, k, v, **kw)
    want_g = jax.grad(lambda *a: jnp.sum(jax_naive(*a, **kw) ** 2),
                      argnums=(0, 1, 2))(q, k, v)
    _close(naive_attention(*(torch.from_numpy(x) for x in (q, k, v)), **kw),
           want, "naive_attention")
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = flash_attention(*leaves, **kw)
    _close(out.detach(), want, "flash_attention")
    (out ** 2).sum().backward()
    for name, t, w in zip("qkv", leaves, want_g):
        _close(t.grad, w, f"flash_attention d{name}")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_counted_pairs_are_the_offset_mask(case):
    B, Sq, Sk, H, Kh, hd, causal, window, off = case
    mask = attention_mask(Sq, Sk, causal=causal, window=window, q_offset=off)
    pairs = FM.valid_pairs(Sq, Sk, causal, window, off)
    assert pairs == int(mask.sum()) > 0
    leaves = [torch.empty(s, device="meta", requires_grad=True)
              for s in ((B, Sq, H, hd), (B, Sk, Kh, hd), (B, Sk, Kh, hd))]
    with FlopCounterMode(display=False) as counter:
        out = flash_attention(*leaves, causal=causal, window=window,
                              q_offset=off)
        fwd = counter.get_total_flops()
        out.sum().backward()
    per = B * H * hd * pairs
    assert fwd == FM.FWD_PER_PAIR * per
    assert counter.get_total_flops() - fwd == (FM.DQ_PER_PAIR
                                               + FM.DKV_PER_PAIR) * per


def test_an_offset_binds_nothing_unmasked():
    """Non-causal, unwindowed: every pair is admitted at any offset, and
    the count is the plain forward's ``FlopCounterMode`` count."""
    B, Sq, Sk, H, Kh, hd = 1, 12, 30, 4, 2, 16
    q, k, v = (torch.from_numpy(x) for x in _inputs(B, Sq, Sk, H, Kh, hd))
    q = q[:, :Sq]
    with FlopCounterMode(display=False) as plain:
        attention_ref(q, k, v, causal=False, q_offset=18)
    meta = [torch.empty(t.shape, device="meta") for t in (q, k, v)]
    with FlopCounterMode(display=False) as counted:
        FM.flash_fwd_meta(*meta, causal=False, window=None, q_offset=18)
    assert FM.valid_pairs(Sq, Sk, False, None, 18) == Sq * Sk
    assert counted.get_total_flops() == plain.get_total_flops()


def test_the_offset_is_checked():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 8, 8, 2, 2, 16))
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention(q, k, v, q_offset=-1)
    # positions >= Sk - 1 + window see no key
    with pytest.raises(ValueError, match="no admissible key"):
        flash_attention(q[:, :4], k, v, window=3, q_offset=7)
