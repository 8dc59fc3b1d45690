"""The hand-written CUDA kernels (flash-attention forward K1, backward K2
and K3, the SSD chunk scan K4 and the percentile stretch K5) against their
plain PyTorch versions, a small train step, reduced mamba2, MoE and
hybrid serving, a dropped engine's memory, the continuous scheduler's
eviction resume and a reduced vision run, on the card.  Every test here
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
    bwd_library, flash_attention_bwd_kernel, flash_attention_fwd_kernel,
    library, route)
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


TC_CASES = [
    # B, Sq, Sk, H, Kh, hd, causal, window, q cut from a fused qkv tensor
    (2, 1, 1, 32, 8, 64, True, None, False),        # one row
    (2, 17, 17, 32, 8, 64, True, None, False),      # Sq below one q tile
    (2, 1000, 1000, 32, 8, 64, True, None, False),  # ragged, granite heads
    (1, 64, 192, 4, 4, 64, False, None, False),     # non-causal cross-length
    (1, 700, 700, 4, 2, 64, True, 100, False),      # window off the tile grid
    (2, 300, 300, 8, 8, 64, True, None, False),     # MHA
    (1, 520, 520, 16, 16, 128, True, None, False),  # hd 128: two boxes a row
    (2, 333, 333, 8, 2, 64, True, None, True),      # strided q
    (1, 260, 260, 4, 4, 128, False, None, True),    # strided q, hd 128
    (2, 600, 600, 32, 2, 128, True, None, False),   # GQA 16 at hd 128 (glm4)
]


def _tc_inputs(case, dev, seed=0):
    B, Sq, Sk, H, Kh, hd, _, _, fused = case
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s, dtype=np.float32)).to(dev, torch.bfloat16)
    if fused:
        q = mk(B, Sq, 3 * H * hd)[..., :H * hd].reshape(B, Sq, H, hd)
        assert not q.is_contiguous()
    else:
        q = mk(B, Sq, H, hd)
    return q, mk(B, Sk, Kh, hd), mk(B, Sk, Kh, hd)


@pytest.mark.parametrize("case", TC_CASES)
def test_tensor_core_route_matches_plain_and_repeats_bitwise(case, dev):
    causal, window = case[6], case[7]
    q, k, v = _tc_inputs(case, dev)
    assert route(q.dtype, q.shape[-1]) == "tensor_core"
    n0 = dict(flash_attention_fwd_kernel.launches_by_route)
    out, lse = flash_attention_fwd_kernel(q, k, v, causal=causal,
                                          window=window)
    out2, lse2 = flash_attention_fwd_kernel(q, k, v, causal=causal,
                                            window=window)
    torch.cuda.synchronize()
    by_route = flash_attention_fwd_kernel.launches_by_route
    assert by_route["tensor_core"] - n0["tensor_core"] == 2
    assert by_route["cuda_core"] == n0["cuda_core"]
    # no atomics and no kv split: the same inputs give the same bits
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    ref_out, ref_lse = attention_ref(q, k, v, causal=causal, window=window)
    tol_o, tol_l = TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), ref_out.float(), atol=tol_o,
                               rtol=tol_o)
    torch.testing.assert_close(lse, ref_lse, atol=tol_l, rtol=tol_l)


# K2/K3 on the tensor-core route: TC_CASES (Sq 1 / 17 / 1000, cross
# length, window 100, GQA rep 4, MHA, hd 128), with q, k and v all cut from
# one fused qkv tensor where the last field says so, plus a causal cross
# length (kv tiles past Sq get no query) and a non-causal window
TC_BWD_CASES = TC_CASES + [
    (1, 64, 300, 4, 2, 64, True, None, False),
    (1, 400, 400, 4, 1, 128, False, 150, True),
]


def _tc_bwd_inputs(case, dev, seed=0):
    B, Sq, Sk, H, Kh, hd, _, _, fused = case
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s, dtype=np.float32)).to(dev, torch.bfloat16)
    if fused:
        qkv = mk(B, Sq, (H + 2 * Kh) * hd)
        q = qkv[..., :H * hd].reshape(B, Sq, H, hd)
        k = qkv[..., H * hd:(H + Kh) * hd].reshape(B, Sk, Kh, hd)
        v = qkv[..., (H + Kh) * hd:].reshape(B, Sk, Kh, hd)
        assert not (q.is_contiguous() or k.is_contiguous())
    else:
        q, k, v = mk(B, Sq, H, hd), mk(B, Sk, Kh, hd), mk(B, Sk, Kh, hd)
    return q, k, v, mk(B, Sq, H, hd)


@pytest.mark.parametrize("case", TC_BWD_CASES)
def test_tensor_core_bwd_matches_plain_and_repeats_bitwise(case, dev):
    causal, window = case[6], case[7]
    mask = dict(causal=causal, window=window)
    q, k, v, do = _tc_bwd_inputs(case, dev)
    assert route(q.dtype, q.shape[-1]) == "tensor_core"
    out, lse = attention_ref(q, k, v, **mask)
    delta = row_delta(out, do)
    kernels = (flash_attention_bwd_dq_kernel, flash_attention_bwd_dkv_kernel)
    n0 = [dict(fn.launches_by_route) for fn in kernels]
    dq = flash_attention_bwd_dq_kernel(q, k, v, do, lse, delta, **mask)
    dq2 = flash_attention_bwd_dq_kernel(q, k, v, do, lse, delta, **mask)
    dk, dv = flash_attention_bwd_dkv_kernel(q, k, v, do, lse, delta, **mask)
    dk2, dv2 = flash_attention_bwd_dkv_kernel(q, k, v, do, lse, delta, **mask)
    torch.cuda.synchronize()
    for fn, before in zip(kernels, n0):
        assert fn.launches_by_route["tensor_core"] - \
            before["tensor_core"] == 2
        assert fn.launches_by_route["cuda_core"] == before["cuda_core"]
    # no atomics and a fixed order: the same inputs give the same bits
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2) and \
        torch.equal(dv, dv2)
    want = attention_bwd_ref(q, k, v, out, lse, do, **mask)
    for g, w in zip((dq, dk, dv), want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        torch.testing.assert_close(g, w, atol=BWD_TOL, rtol=BWD_TOL)


def test_routes_follow_the_table(dev):
    lib, bwd = library(), bwd_library()
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        for hd in range(16, 257, 16):
            want = route(dtype, hd)
            for fn in (lib.flash_fwd_route, bwd.flash_bwd_route):
                assert ("tensor_core" if fn(code, hd)
                        else "cuda_core") == want
    # f32 and bf16 at another head dim launch the CUDA-core kernels
    kernels = (flash_attention_fwd_kernel, flash_attention_bwd_dq_kernel,
               flash_attention_bwd_dkv_kernel)
    for dtype, hd in ((torch.float32, 64), (torch.bfloat16, 32)):
        q, k, v = (x.to(dtype) for x in _inputs(
            (1, 70, 70, 2, 1, hd, True, None), torch.float32, dev))
        n0 = [dict(fn.launches_by_route) for fn in kernels]
        out, lse = flash_attention_fwd_kernel(q, k, v, causal=True,
                                              window=None)
        flash_attention_bwd_kernel(q, k, v, out, lse, row_delta(out, out),
                                   causal=True, window=None)
        for fn, before in zip(kernels, n0):
            by_route = fn.launches_by_route
            assert by_route["cuda_core"] - before["cuda_core"] == 1
            assert by_route["tensor_core"] == before["tensor_core"]


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
    """On its route (bf16 at hp 64/128 with N a multiple of 16 on the tensor
    cores), and two launches bitwise equal."""
    from repro_torch.kernels.ssd_scan.kernel import route, ssd_scan_kernel
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref
    dtype = getattr(torch, dtype)
    x, dt, A, B, C = _ssd_inputs(case, dtype, dev)
    assert not x.is_contiguous()
    n0 = ssd_scan_kernel.launches
    r0 = dict(ssd_scan_kernel.launches_by_route)
    y, h = ssd_scan_kernel(x, dt, A, B, C, chunk=case[-1])
    y2, h2 = ssd_scan_kernel(x, dt, A, B, C, chunk=case[-1])
    torch.cuda.synchronize()
    assert ssd_scan_kernel.launches == n0 + 2
    want = route(dtype, case[3], case[5])
    assert want == ("tensor_core" if dtype == torch.bfloat16
                    and case[3] in (64, 128) else "cuda_core")
    assert {k: v - r0[k] for k, v in
            ssd_scan_kernel.launches_by_route.items()} == \
        {k: 2 * (k == want) for k in r0}
    assert torch.equal(y, y2) and torch.equal(h, h2)
    assert y.dtype == dtype and h.dtype == torch.float32
    yr, hr = ssd_chunked_ref(x, dt, A, B, C, case[-1])
    tol = SSD_TOL[dtype]
    torch.testing.assert_close(y.float(), yr.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(h, hr, atol=5e-4, rtol=5e-4)


def test_ssd_routes_follow_the_table(dev):
    from repro_torch.kernels.ssd_scan import kernel as ssd
    lib = ssd.library()
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        for hp in range(16, 129, 16):
            for N in (8, 16, 24, 64, 128):
                assert lib.ssd_scan_route(code, hp, N) == \
                    (ssd.route(dtype, hp, N) == "tensor_core")


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
    # the tensor-core route reads rows by 16-byte cp.async: a row stride of
    # 68 bf16 (136 bytes) is refused, never sent to the CUDA cores
    x, dt, A, B, C = _ssd_inputs((1, 64, 2, 64, 1, 16, 16), torch.bfloat16,
                                 dev)
    wide = torch.zeros((1, 64, 2, 68), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        ssd_scan_kernel(wide[..., :64], dt, A, B, C, chunk=16)


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


def test_a_dropped_engine_frees_the_card_without_the_collector(dev):
    """After ``del engine`` the card's allocated memory returns to its
    value before the engine was built, with the cyclic collector off: the
    engine's stats hold it by a weak reference, so no cycle keeps its
    params and decode state alive.  A first run outside the count sets up
    what stays for the process (cuBLAS workspaces)."""
    import gc
    from repro_torch.configs import get_reduced
    from repro_torch.models import init_params
    from repro_torch.serve import Request, ServeEngine
    cfg = get_reduced("granite-3-2b")

    def engine_run():
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
        engine = ServeEngine(cfg, params, slots=4, cache_len=128, device=dev)
        engine.submit(Request(rid=0, prompt=np.arange(9), max_tokens=4))
        assert len(engine.run()[0].generated) == 4
        return engine

    engine_run()                      # the warm-up, dropped at once
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    gc.disable()
    try:
        engine = engine_run()
        assert torch.cuda.memory_allocated() > before
        del engine
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated() == before
    finally:
        gc.enable()


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b",
                                  "jamba-1.5-large-398b"])
def test_moe_and_hybrid_serve_on_the_card(arch, dev):
    """The reduced MoE and hybrid stacks (f32) through the engine on the
    card: K1 in every attention layer and K4 in every SSD layer of every
    prefill, and a prefill through the kernels on the card agrees with the
    plain versions on the CPU on the same weights (the MoE's dispatch and
    combine included)."""
    import dataclasses
    from repro_torch.configs import get_reduced
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_kernel
    from repro_torch.launch.serve import serve_main
    from repro_torch.models import init_params, prefill
    cfg = get_reduced(arch)
    kinds = cfg.layer_kinds()
    n1, n4 = flash_attention_fwd_kernel.launches, ssd_scan_kernel.launches
    res = serve_main(arch, requests=6, max_tokens=4, device="cuda")
    assert res["requests"] == 6 and res["tokens"] == 24
    assert flash_attention_fwd_kernel.launches - n1 == \
        res["flash_attention_launches"] == \
        kinds.count("attn") * res["prefill_calls"]
    assert ssd_scan_kernel.launches - n4 == res["ssd_scan_launches"] == \
        kinds.count("ssm") * res["prefill_calls"]
    params = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    toks = torch.randint(0, cfg.vocab, (3, 70),
                         generator=torch.Generator().manual_seed(2))
    lens = torch.tensor([70, 33, 5])
    want = prefill(params, cfg, {"tokens": toks}, 128, lengths=lens)

    def to_dev(tree):
        if isinstance(tree, dict):
            return {k: to_dev(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_dev(v) for v in tree]
        return tree.to(dev)
    on_card = to_dev(params)
    c = dataclasses.replace(cfg, attention_backend="cuda",
                            mixer_backend="cuda")
    got = prefill(on_card, c, {"tokens": toks.to(dev)}, 128,
                  lengths=lens.to(dev))
    torch.testing.assert_close(got[0].cpu(), want[0], atol=5e-4, rtol=5e-4)
    assert set(got[1]) == set(want[1])
    for name, t in want[1].items():
        torch.testing.assert_close(got[1][name].cpu(), t, atol=5e-4,
                                   rtol=5e-4)


def test_scheduler_eviction_resume_is_token_identical_on_the_card(dev):
    """The reduced granite in f32 on the card through the continuous
    scheduler: an oversubscribed KV pool (8 blocks of 8 for 3 slots of
    64) evicts, and re-prefilling prompt + generated through K1 resumes
    greedy decode token for token as in an unconstrained run."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import init_params
    from repro_torch.serve import Request, ServeScheduler
    cfg = get_reduced("granite-3-2b")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, cfg.vocab, size=int(rng.integers(4, 12)))
               for _ in range(6)]
    runs = []
    for pool in ({}, dict(max_kv_blocks=8, kv_block_size=8)):
        sched = ServeScheduler(cfg, params, slots=3, cache_len=64,
                               device=dev, **pool)
        for i, p in enumerate(prompts):
            sched.submit(Request(rid=i, prompt=p, max_tokens=20))
        n0 = flash_attention_fwd_kernel.launches
        sched.run()
        assert flash_attention_fwd_kernel.launches - n0 == \
            cfg.n_layers * sched.stats["prefill_calls"]
        runs.append(sched)
    free, tight = runs
    assert ({r.rid: r.generated for r in tight.completed}
            == {r.rid: r.generated for r in free.completed})
    assert len(tight.completed) == 6
    assert tight.stats["evictions"] > 0 and free.stats["evictions"] == 0
    assert tight.kv.used_blocks == 0


PN_CASES = [
    # R, C, row stride (None: packed rows)
    (4096, 4, None),
    (1000, 13, None),     # ragged R, 13 bands
    (1000, 1, None),      # one band
    (3, 3, None),         # fewer elements than one vector of four
    (777, 5, 8),          # rows further apart than the bands
    (65537, 3, None),     # R * C not a multiple of four
]


def _pn_inputs(R, C, ld, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    base = torch.from_numpy((rng.gamma(2.0, 500.0, size=(R, ld or C)))
                            .astype(np.float32)).to(dev, dtype)
    x = base[:, :C]
    lo = torch.from_numpy(rng.uniform(0, 300, (1, C)).astype(np.float32))
    hi = lo + torch.from_numpy(rng.uniform(500, 3000, (1, C))
                               .astype(np.float32))
    return x, lo.to(dev), hi.to(dev)


@pytest.mark.parametrize("case", PN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_percentile_norm_kernel_matches_plain(case, dtype, dev):
    from repro_torch.kernels.percentile_norm.kernel import (
        percentile_norm_kernel)
    from repro_torch.kernels.percentile_norm.ref import stretch_ref
    R, C, ld = case
    x, lo, hi = _pn_inputs(R, C, ld, getattr(torch, dtype), dev)
    n0 = percentile_norm_kernel.launches
    out = percentile_norm_kernel(x, lo, hi)
    torch.cuda.synchronize()
    assert percentile_norm_kernel.launches == n0 + 1
    assert out.dtype == torch.float32 and out.shape == (R, C)
    # the same operations in the same order: equal bit for bit
    torch.testing.assert_close(out, stretch_ref(x, lo, hi), atol=0, rtol=0)


def test_percentile_norm_kernel_keeps_nan_and_constant_bands(dev):
    from repro_torch.kernels.percentile_norm.kernel import (
        percentile_norm_kernel)
    from repro_torch.kernels.percentile_norm.ref import stretch_ref
    x, lo, hi = _pn_inputs(1001, 3, None, torch.float32, dev)
    x[5, 1] = float("nan")
    x[7, 0] = -float("inf")
    hi[0, 2] = lo[0, 2]                    # a constant band: 1e-12 guard
    out = percentile_norm_kernel(x, lo, hi)
    want = stretch_ref(x, lo, hi)
    assert torch.isnan(out[5, 1]) and torch.isnan(out).sum() == 1
    assert out[7, 0] == 0
    torch.testing.assert_close(out, want, atol=0, rtol=0, equal_nan=True)
    assert torch.isfinite(out[:, 2]).all()


def test_percentile_normalize_routes_to_k5_and_trains(dev):
    from repro_torch.kernels.percentile_norm import percentile_normalize
    from repro_torch.kernels.percentile_norm.kernel import (
        percentile_norm_kernel)
    rng = np.random.default_rng(1)
    img = torch.from_numpy(rng.gamma(2.0, 500.0, size=(64, 64, 3))
                           .astype(np.float32)).to(dev).requires_grad_(True)
    co = torch.from_numpy(rng.standard_normal((64, 64, 3))
                          .astype(np.float32)).to(dev)
    n0 = percentile_norm_kernel.launches
    out = percentile_normalize(img)
    assert percentile_norm_kernel.launches == n0 + 1
    g, = torch.autograd.grad((out * co).sum(), img)
    plain = percentile_normalize(img, backend="torch")
    assert percentile_norm_kernel.launches == n0 + 1
    torch.testing.assert_close(out, plain, atol=0, rtol=0)
    g_plain, = torch.autograd.grad((plain * co).sum(), img)
    torch.testing.assert_close(g, g_plain, atol=0, rtol=0)


def test_percentile_norm_unsupported_inputs_raise(dev):
    from repro_torch.kernels.percentile_norm.kernel import (
        percentile_norm_kernel)
    x, lo, hi = _pn_inputs(64, 4, None, torch.float32, dev)
    with pytest.raises(ValueError, match="bands must be contiguous"):
        percentile_norm_kernel(x.t().contiguous().t(), lo, hi)
    with pytest.raises(TypeError):
        percentile_norm_kernel(x.half(), lo, hi)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        percentile_norm_kernel(x, lo.cpu(), hi)
    with pytest.raises(ValueError, match="must be"):
        percentile_norm_kernel(x, lo[:, :2], hi)


def test_vision_main_on_the_card(dev):
    """The reduced vision CLI on the card: every scene and composite goes
    through K5."""
    from repro_torch.launch.vision import main
    out = main(["--device", "cuda", "--scenes", "4", "--size", "128",
                "--chip", "32", "--epochs", "1", "--pairs", "5",
                "--pair-size", "32", "--cf-steps", "2"])
    assert out["percentile_norm_launches"] == 4 + 2 * 5
    assert np.isfinite(out["models"][0]["final_loss"])
