"""The hand-written CUDA kernels (flash-attention forward K1, backward K2
and K3, and the SSD chunk scan K4) against their plain PyTorch versions, a
small train step and reduced mamba2 serving, on the card.  Every test here
is marked ``cuda`` and skips where no card is present; on a machine with an
H100 run

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


# ------------------------------------------------------------------ K4
SSD_CASES = [
    # Bs, S, nh, hp, g, N, chunk
    (2, 64, 4, 16, 1, 16, 16),
    (1, 96, 8, 32, 2, 32, 32),
    (2, 130, 4, 16, 4, 8, 32),       # ragged S, N not a multiple of 16
    (1, 300, 8, 64, 1, 128, 256),    # one short chunk after a full one
    (2, 200, 16, 128, 8, 128, 256),  # jamba's widths, g 8
    (1, 513, 4, 64, 2, 64, 64),      # Q 64, a one-row tail chunk
]
# K4 against the plain chunked scan: both compute in f32 from the same
# inputs, so y and h_final differ by summation order (and, in bf16, by
# y's rounding to bf16, one ulp = 2**-8 relative)
SSD_TOL = {torch.float32: 5e-4, torch.bfloat16: 2e-2}


def _ssd_inputs(case, dtype, dev, seed=0):
    """x, B and C as strided views of one buffer (as ssm_apply hands them
    over), dt and A f32."""
    Bs, S, nh, hp, g, N, _ = case
    rng = np.random.default_rng(seed)
    width = nh * hp + 2 * g * N
    buf = torch.from_numpy(rng.standard_normal(
        (Bs, S, width), dtype=np.float32)).to(dev, dtype)
    x = buf[..., :nh * hp].reshape(Bs, S, nh, hp)
    B = buf[..., nh * hp:nh * hp + g * N].reshape(Bs, S, g, N)
    C = buf[..., nh * hp + g * N:].reshape(Bs, S, g, N)
    dt = torch.from_numpy(np.logaddexp(rng.standard_normal(
        (Bs, S, nh)), 0).astype(np.float32)).to(dev)
    A = -torch.from_numpy(np.exp(rng.standard_normal(nh) * 0.3)
                          .astype(np.float32)).to(dev)
    return x, dt, A, B, C


@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_matches_plain(case, dtype, dev):
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_kernel
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref
    dtype = getattr(torch, dtype)
    x, dt, A, B, C = _ssd_inputs(case, dtype, dev)
    assert not x.is_contiguous()
    n0 = ssd_scan_kernel.launches
    y, h = ssd_scan_kernel(x, dt, A, B, C, chunk=case[-1])
    torch.cuda.synchronize()
    assert ssd_scan_kernel.launches == n0 + 1
    assert y.dtype == dtype and h.dtype == torch.float32
    yr, hr = ssd_chunked_ref(x, dt, A, B, C, case[-1])
    tol = SSD_TOL[dtype]
    torch.testing.assert_close(y.float(), yr.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(h, hr, atol=5e-4, rtol=5e-4)


def test_ssd_kernel_freezes_the_state_on_zero_dt(dev):
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_kernel
    x, dt, A, B, C = _ssd_inputs((2, 300, 8, 64, 1, 128, 256),
                                 torch.float32, dev)
    dt[:, 141:] = 0
    _, h_pad = ssd_scan_kernel(x, dt, A, B, C, chunk=256)
    _, h_cut = ssd_scan_kernel(x[:, :141], dt[:, :141], A, B[:, :141],
                               C[:, :141], chunk=256)
    # equal up to f32 rounding: the two chunk lengths (256, 141) group the
    # cumsum of dt * A differently across the lanes of the scan
    torch.testing.assert_close(h_pad, h_cut, atol=5e-4, rtol=5e-4)


def test_ssd_ops_routes_cuda_tensors_to_the_kernel_and_trains(dev):
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_kernel
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref
    ins = [t.detach().clone().requires_grad_(True) for t in
           _ssd_inputs(SSD_CASES[2], torch.float32, dev)]
    co = torch.randn(ins[0].shape, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(0))
    n0 = ssd_scan_kernel.launches
    got = torch.autograd.grad((ssd_scan(*ins, chunk=32) * co).sum(), ins)
    assert ssd_scan_kernel.launches == n0 + 1
    want = torch.autograd.grad((ssd_chunked_ref(*ins, 32)[0] * co).sum(),
                               ins)
    # the backward is the plain scan's autograd in both
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_ssd_unsupported_inputs_raise(dev):
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_kernel
    x, dt, A, B, C = _ssd_inputs((1, 64, 4, 16, 1, 16, 16), torch.float32,
                                 dev)
    strided = torch.zeros((1, 64, 4, 32), device=dev)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan_kernel(strided, dt, A, B, C, chunk=16)
    with pytest.raises(TypeError):
        ssd_scan_kernel(x.half(), dt, A, B.half(), C.half(), chunk=16)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        ssd_scan_kernel(x, dt.cpu(), A, B, C, chunk=16)


def test_mamba2_serves_through_k4_on_the_card(dev):
    """Reduced mamba2 through the engine on the card: K4 runs in every
    layer of every prefill, and the kernel path's prefill logits agree
    with the plain scan's."""
    import dataclasses
    from repro_torch.configs import get_reduced
    from repro_torch.launch.serve import serve_main
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_kernel
    from repro_torch.models import init_params, prefill
    n0 = ssd_scan_kernel.launches
    res = serve_main("mamba2-2.7b", requests=6, max_tokens=4, device="cuda")
    cfg = get_reduced("mamba2-2.7b")
    assert res["requests"] == 6 and res["tokens"] == 24
    assert ssd_scan_kernel.launches - n0 == res["ssd_scan_launches"] == \
        cfg.n_layers * res["prefill_calls"]
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(1),
                         device=dev)
    toks = torch.randint(0, cfg.vocab, (3, 70), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(2))
    lens = torch.tensor([70, 33, 5], device=dev)
    logits = {}
    for backend in ("cuda", "torch"):
        c = dataclasses.replace(cfg, mixer_backend=backend)
        logits[backend] = prefill(params, c, {"tokens": toks}, 128,
                                  lengths=lens)
    for name in ("h", "conv"):
        torch.testing.assert_close(logits["cuda"][1][name],
                                   logits["torch"][1][name], atol=5e-4,
                                   rtol=5e-4)
    torch.testing.assert_close(logits["cuda"][0], logits["torch"][0],
                               atol=5e-4, rtol=5e-4)
