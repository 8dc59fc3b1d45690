"""The hand-written CUDA flash-attention kernels (forward K1, backward K2
and K3) against their plain PyTorch versions, and a small train step, on
the card.  Every test here is marked ``cuda`` and skips where
no card is present; on a machine with an H100 run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX: the machine with the card has none.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_bwd_dkv_kernel, flash_attention_bwd_dq_kernel,
    flash_attention_bwd_kernel, flash_attention_fwd_kernel)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_bwd_ref, attention_ref, row_delta)

pytestmark = pytest.mark.cuda

CASES = [
    # B, Sq, Sk, H, Kh, hd, causal, window
    (2, 128, 128, 4, 2, 64, True, None),
    (1, 256, 256, 8, 8, 32, True, 64),
    (2, 100, 100, 4, 1, 64, False, None),
    (1, 512, 512, 4, 2, 128, True, None),
    (1, 64, 192, 2, 2, 16, False, None),     # cross-length
    (3, 80, 80, 6, 3, 48, True, 32),         # odd sizes + window
    (1, 300, 300, 2, 1, 256, True, None),    # widest head
    (2, 1000, 1000, 32, 8, 64, True, None),  # ragged, granite heads
]
# kernel vs plain in the working dtype: f32 differs only by summation
# order; bf16 adds the output's rounding to bf16 (~4e-3 relative)
TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (2e-2, 1e-4)}
# K2/K3 against the plain backward: both compute in f32 from the same
# inputs and return f32, so only the order of the f32 sums differs
BWD_TOL = 2e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(case, dtype, dev, seed=0):
    B, Sq, Sk, H, Kh, hd, causal, window = case
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s, dtype=np.float32)).to(dev, dtype)
    return mk(B, Sq, H, hd), mk(B, Sk, Kh, hd), mk(B, Sk, Kh, hd)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain(case, dtype, dev):
    dtype = getattr(torch, dtype)
    causal, window = case[6], case[7]
    q, k, v = _inputs(case, dtype, dev)
    n0 = flash_attention_fwd_kernel.launches
    out, lse = flash_attention_fwd_kernel(q, k, v, causal=causal,
                                          window=window)
    torch.cuda.synchronize()
    assert flash_attention_fwd_kernel.launches == n0 + 1
    ref_out, ref_lse = attention_ref(q, k, v, causal=causal, window=window)
    tol_o, tol_l = TOL[dtype]
    torch.testing.assert_close(out.float(), ref_out.float(), atol=tol_o,
                               rtol=tol_o)
    torch.testing.assert_close(lse, ref_lse, atol=tol_l, rtol=tol_l)


def test_ops_routes_cuda_tensors_to_the_kernel(dev):
    case = CASES[0]
    q, k, v = _inputs(case, torch.bfloat16, dev)
    n0 = flash_attention_fwd_kernel.launches
    flash_attention(q, k, v, causal=True)
    assert flash_attention_fwd_kernel.launches == n0 + 1


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_kernels_match_plain(case, dtype, dev):
    dtype = getattr(torch, dtype)
    causal, window = case[6], case[7]
    q, k, v = _inputs(case, dtype, dev)
    do = _inputs(case, dtype, dev, seed=1)[0]
    out, lse = attention_ref(q, k, v, causal=causal, window=window)
    n2 = flash_attention_bwd_dq_kernel.launches
    n3 = flash_attention_bwd_dkv_kernel.launches
    got = flash_attention_bwd_kernel(q, k, v, do, lse, row_delta(out, do),
                                     causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention_bwd_dq_kernel.launches == n2 + 1
    assert flash_attention_bwd_dkv_kernel.launches == n3 + 1
    want = attention_bwd_ref(q, k, v, out, lse, do, causal=causal,
                             window=window)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        torch.testing.assert_close(g, w, atol=BWD_TOL, rtol=BWD_TOL)


def test_cuda_grad_reaches_k2_and_k3(dev):
    q, k, v = (x.requires_grad_(True)
               for x in _inputs(CASES[0], torch.bfloat16, dev))
    n1 = flash_attention_fwd_kernel.launches
    n2 = flash_attention_bwd_dq_kernel.launches
    n3 = flash_attention_bwd_dkv_kernel.launches
    out = flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(out.float().square().sum(), (q, k, v))
    torch.cuda.synchronize()
    assert flash_attention_fwd_kernel.launches == n1 + 1
    assert flash_attention_bwd_dq_kernel.launches == n2 + 1
    assert flash_attention_bwd_dkv_kernel.launches == n3 + 1
    assert all(g.dtype == torch.bfloat16 and torch.isfinite(g).all()
               for g in grads)


def test_train_step_on_the_card(dev):
    from repro_torch.configs import get_reduced
    from repro_torch.launch.train import train_main
    n_layers, steps = get_reduced("stablelm-1.6b").n_layers, 3
    n1 = flash_attention_fwd_kernel.launches
    n2 = flash_attention_bwd_dq_kernel.launches
    n3 = flash_attention_bwd_dkv_kernel.launches
    res = train_main("stablelm-1.6b", steps=steps, batch=2, seq=128,
                     log_every=0, device="cuda")
    assert np.all(np.isfinite(res["losses"])) and len(res["losses"]) == 3
    # remat runs each layer's forward twice per step
    assert flash_attention_fwd_kernel.launches - n1 == 2 * n_layers * steps
    assert flash_attention_bwd_dq_kernel.launches - n2 == n_layers * steps
    assert flash_attention_bwd_dkv_kernel.launches - n3 == n_layers * steps


def test_unsupported_inputs_raise(dev):
    q, k, v = _inputs((1, 64, 64, 2, 2, 24, True, None), torch.float32, dev)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_fwd_kernel(q, k, v, causal=True, window=None)
    q, k, v = _inputs(CASES[0], torch.float16, dev)
    with pytest.raises(TypeError):
        flash_attention_fwd_kernel(q, k, v, causal=True, window=None)
