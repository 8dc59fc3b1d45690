"""The hand-written CUDA flash-attention forward against its plain PyTorch
version, on the card.  Every test here is marked ``cuda`` and skips where
no card is present; on a machine with an H100 run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX: the machine with the card has none.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import \
    flash_attention_fwd_kernel  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402

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


def test_grad_on_cuda_raises(dev):
    q, k, v = _inputs(CASES[0], torch.float32, dev)
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError):
        flash_attention(q, k, v, causal=True)


def test_unsupported_inputs_raise(dev):
    q, k, v = _inputs((1, 64, 64, 2, 2, 24, True, None), torch.float32, dev)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_fwd_kernel(q, k, v, causal=True, window=None)
    q, k, v = _inputs(CASES[0], torch.float16, dev)
    with pytest.raises(TypeError):
        flash_attention_fwd_kernel(q, k, v, causal=True, window=None)
