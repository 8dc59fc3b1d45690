"""The port's SSD scan (``repro_torch.kernels.ssd_scan``) against the JAX
package on the same numpy inputs: the plain chunked scan against the
reference's sequential oracle ``ssd_ref``, its model scan ``ssd_chunked``
and its Pallas ``ssd_scan`` in interpret mode; the port's oracle against
the reference's; and the gradients of the port's ``autograd.Function``
against ``jax.grad`` through the reference's ``ssd_scan``.

The cases are the reference's (``tests/test_kernels.py``), with g > 1
(head h reads group h // (nh / g)) and a ragged S (130 over chunks of 32).
Tolerances (atol = rtol): f32 y 1e-4, tighter than the reference's own
5e-4 against the oracle (the largest error seen here is 1.6e-5 relative to
1 + |y|, at |y| up to 153); bf16 y 1e-2 (y is rounded to bf16 in both
packages from f32 values that differ by summation order, and one bf16 ulp
is 2**-8 relative); h_final, f32 in every case, 5e-4.  Gradients: 2e-4
in f32 (both sides differentiate the same chunked formulation).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import SSMConfig as JSSMConfig  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_ref as jax_ssd_ref  # noqa: E402
from repro.models.ssm import ssd_chunked as jax_ssd_chunked  # noqa: E402
from repro_torch.configs import SSMConfig  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as K  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (ssd_chunked_ref,  # noqa: E402
                                              ssd_ref)
from repro_torch.models.ssm import ssd_chunked  # noqa: E402
from torch_one_thread import one_thread  # noqa: E402,F401

CASES = [
    # Bs, S, nh, hp, g, N, chunk
    (2, 64, 4, 16, 1, 16, 16),
    (1, 96, 8, 32, 2, 32, 32),
    (2, 130, 4, 16, 4, 8, 32),      # ragged S: the tail chunk is short
    (1, 128, 2, 64, 1, 64, 64),
]
IDS = ["g1", "g2", "g4-ragged", "hp64"]
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (np.float32, jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-4, "bfloat16": 1e-2}
H_TOL = 5e-4


def _inputs(case, seed=0):
    Bs, S, nh, hp, g, N, _ = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bs, S, nh, hp), dtype=np.float32)
    dt = np.logaddexp(rng.standard_normal((Bs, S, nh)), 0).astype(np.float32)
    A = -np.exp(rng.standard_normal(nh) * 0.3).astype(np.float32)
    B = rng.standard_normal((Bs, S, g, N), dtype=np.float32)
    C = rng.standard_normal((Bs, S, g, N), dtype=np.float32)
    return x, dt, A, B, C


def _both(arrays, dtype):
    """(jax arrays, torch tensors): x, B and C in ``dtype``, dt and A f32."""
    _, jdt, tdt = DTYPES[dtype]
    x, dt, A, B, C = arrays
    j = (jnp.asarray(x, jdt), jnp.asarray(dt), jnp.asarray(A),
         jnp.asarray(B, jdt), jnp.asarray(C, jdt))
    t = (torch.from_numpy(x).to(tdt), torch.from_numpy(dt),
         torch.from_numpy(A), torch.from_numpy(B).to(tdt),
         torch.from_numpy(C).to(tdt))
    return j, t


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_scan_matches_jax_oracle(case, dtype):
    j, t = _both(_inputs(case), dtype)
    y, h = ssd_chunked_ref(*t, case[-1])
    yr, hr = jax_ssd_ref(*j)
    assert y.dtype == t[0].dtype and h.dtype == torch.float32
    _close(y, yr, TOL[dtype])
    _close(h, hr, H_TOL)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_port_oracle_matches_jax_oracle(case, dtype):
    j, t = _both(_inputs(case, seed=1), dtype)
    y, h = ssd_ref(*t)
    yr, hr = jax_ssd_ref(*j)
    _close(y, yr, TOL[dtype])
    _close(h, hr, H_TOL)


@pytest.mark.parametrize("with_h0", [False, True], ids=["h0-zero", "h0"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_model_scan_matches_jax_ssd_chunked(case, dtype, with_h0):
    Bs, _, nh, hp, _, N, chunk = case
    arrays = _inputs(case, seed=2)
    j, t = _both(arrays, dtype)
    h0 = None
    if with_h0:
        h0 = np.random.default_rng(3).standard_normal(
            (Bs, nh, hp, N), dtype=np.float32)
    y, h = ssd_chunked(*t, SSMConfig(chunk=chunk),
                       h0=None if h0 is None else torch.from_numpy(h0))
    yr, hr = jax_ssd_chunked(*j, JSSMConfig(chunk=chunk),
                             h0=None if h0 is None else jnp.asarray(h0))
    _close(y, yr, TOL[dtype])
    _close(h, hr, H_TOL)


# Pallas in interpret mode is slow on the CPU: two cases, g > 1 among them
PALLAS_CASES = [CASES[1], CASES[2]]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", PALLAS_CASES, ids=["g2", "g4-ragged"])
def test_ssd_scan_matches_pallas_interpret(case, dtype):
    j, t = _both(_inputs(case, seed=4), dtype)
    y, h = ssd_scan(*t, chunk=case[-1], return_state=True)
    yr, hr = jax_ssd_scan(*j, chunk=case[-1], head_block=2, interpret=True,
                          return_state=True)
    _close(y, yr, TOL[dtype])
    _close(h, hr, H_TOL)


@pytest.mark.parametrize("case", PALLAS_CASES, ids=["g2", "g4-ragged"])
def test_function_grads_match_jax_grad(case):
    """Gradients of the port's Function (forward and its recompute on the
    CPU) against jax.grad through the reference's custom-VJP ssd_scan, with
    cotangents on both y and the final state."""
    Bs, S, nh, hp, g, N, chunk = case
    arrays = _inputs(case, seed=5)
    rng = np.random.default_rng(6)
    cy = rng.standard_normal((Bs, S, nh, hp), dtype=np.float32)
    ch = rng.standard_normal((Bs, nh, hp, N), dtype=np.float32)

    def f(x, dt, A, B, C):
        y, h = jax_ssd_scan(x, dt, A, B, C, chunk=chunk, head_block=2,
                            interpret=True, return_state=True)
        return jnp.sum(y * cy) + jnp.sum(h * ch)

    want = jax.grad(f, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, arrays))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    y, h = ssd_scan(*ins, chunk=chunk, return_state=True)
    loss = (y * torch.from_numpy(cy)).sum() + (h * torch.from_numpy(ch)).sum()
    got = torch.autograd.grad(loss, ins)
    for name, a, b in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        np.testing.assert_allclose(_np(a), _np(b), atol=2e-4, rtol=2e-4,
                                   err_msg=name)


def test_function_grads_match_plain_autograd_in_bf16():
    """In bf16 the Function's gradients come back in the inputs' dtypes and
    equal autograd through the plain scan (the recompute path)."""
    case = CASES[2]
    _, t = _both(_inputs(case, seed=7), "bfloat16")
    ins = [a.clone().requires_grad_(True) for a in t]
    co = torch.from_numpy(np.random.default_rng(8).standard_normal(
        t[0].shape, dtype=np.float32))
    got = torch.autograd.grad(
        (ssd_scan(*ins, chunk=32).float() * co).sum(), ins)
    want = torch.autograd.grad(
        (ssd_chunked_ref(*ins, 32)[0].float() * co).sum(), ins)
    for a, b, src in zip(got, want, t):
        assert a.dtype == src.dtype
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_zero_dt_freezes_the_state():
    """Rows with dt = 0 (a right-padded prompt) leave the final state as it
    was at the last real row, across a chunk boundary, as the engine's
    bucketed prefill needs."""
    case = (2, 100, 4, 16, 2, 16, 32)
    x, dt, A, B, C = map(torch.from_numpy, _inputs(case, seed=9))
    dt_pad = dt.clone()
    dt_pad[:, 41:] = 0
    _, h_pad = ssd_scan(x, dt_pad, A, B, C, chunk=32, return_state=True)
    _, h_cut = ssd_scan(x[:, :41], dt[:, :41], A, B[:, :41], C[:, :41],
                        chunk=32, return_state=True)
    torch.testing.assert_close(h_pad, h_cut, atol=1e-5, rtol=1e-5)
    assert torch.isfinite(h_pad).all()


def test_cpu_tensors_take_the_plain_version():
    case = CASES[1]
    _, t = _both(_inputs(case, seed=10), "float32")
    before = K.ssd_scan_kernel.launches
    auto = ssd_scan(*t, chunk=32, return_state=True)
    plain = ssd_scan(*t, chunk=32, return_state=True, backend="torch")
    cuda = ssd_scan(*t, chunk=32, return_state=True, backend="cuda")
    assert K.ssd_scan_kernel.launches == before
    for a, b, c in zip(auto, plain, cuda):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_bad_calls_raise():
    case = CASES[0]
    _, (x, dt, A, B, C) = _both(_inputs(case), "float32")
    with pytest.raises(ValueError, match="unknown kernel backend"):
        ssd_scan(x, dt, A, B, C, backend="pallas")
    with pytest.raises(ValueError, match="multiple of g"):
        ssd_scan(x[:, :, :3], dt[:, :, :3], A[:3], B.expand(-1, -1, 2, -1),
                 C.expand(-1, -1, 2, -1))
    meta = torch.empty(B.shape, device="meta")
    with pytest.raises(ValueError, match="all lie on the CPU or all on"):
        ssd_scan(x, dt, A, meta, C)


def test_kernel_wrapper_checks_before_building():
    """The CUDA wrapper refuses what the kernel does not take, without a
    card and without building: CPU tensors, head dims that are not a
    multiple of 16, states wider than 128, mixed dtypes."""
    case = (1, 40, 4, 32, 2, 16, 16)
    _, (x, dt, A, B, C) = _both(_inputs(case), "float32")
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        K.ssd_scan_kernel(x, dt, A, B, C, chunk=16)
    with pytest.raises(ValueError, match="head_dim 24"):
        K.ssd_scan_kernel(x[..., :24], dt, A, B, C, chunk=16)
    wide = torch.zeros(1, 40, 2, 200)
    with pytest.raises(ValueError, match="d_state 200"):
        K.ssd_scan_kernel(x, dt, A, wide, wide, chunk=16)
    with pytest.raises(TypeError, match="share one dtype"):
        K.ssd_scan_kernel(x, dt, A, B.bfloat16(), C, chunk=16)
    with pytest.raises(TypeError, match="dt and A must be float32"):
        K.ssd_scan_kernel(x, dt.double(), A, B, C, chunk=16)


def test_kernel_wrapper_checks_tma_alignment_before_building():
    """On the tensor-core route (bf16 at hp 64 or 128, N a multiple of 16)
    TMA reads x, B and C: a base off 16 bytes, or a stride that is not
    whole 16 bytes on a dim longer than 1, is refused before the device
    check and without a card or a build.  A dim of size 1 may have any
    stride (its map takes the packed one), and the CUDA-core route takes
    the same misaligned views."""
    case = (1, 40, 4, 64, 1, 16, 16)
    _, (x, dt, A, B, C) = _both(_inputs(case), "bfloat16")
    assert K.route(x.dtype, 64, 16) == "tensor_core"
    assert not any(K.tma_misaligned(t) for t in (x, B, C))
    # a base 2 bytes past 16-byte alignment, and a head stride of 68 bf16
    # (136 bytes)
    shifted = torch.zeros(1, 40, 4, 72, dtype=torch.bfloat16)[..., 1:65]
    wide = torch.zeros(1, 40, 4, 68, dtype=torch.bfloat16)[..., :64]
    # a row stride of 20 bf16 (40 bytes) for B
    rows = torch.zeros(1, 40, 1, 20, dtype=torch.bfloat16)[..., :16]
    for name, args in (("x", (shifted, dt, A, B, C)),
                       ("x", (wide, dt, A, B, C)),
                       ("B", (x, dt, A, rows, C)),
                       ("C", (x, dt, A, B, rows))):
        assert K.tma_misaligned(args[0 if name == "x" else
                                     3 if name == "B" else 4])
        with pytest.raises(ValueError, match=f"{name}: the tensor-core "
                                             f"route reads it by TMA"):
            K.ssd_scan_kernel(*args, chunk=16)
    # size-1 dims (batch, group) with odd strides pass to the device check
    odd = torch.zeros(40 * 16, dtype=torch.bfloat16).as_strided(
        (1, 40, 1, 16), (999, 16, 7, 1))
    assert not K.tma_misaligned(odd)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        K.ssd_scan_kernel(x, dt, A, odd, odd, chunk=16)
    # f32 takes the CUDA cores, where a head stride of 66 floats (264
    # bytes) is no fault
    wide32 = torch.zeros(1, 40, 4, 66)[..., :64]
    assert K.tma_misaligned(wide32)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        K.ssd_scan_kernel(wide32, dt, A, B.float(), C.float(), chunk=16)


@pytest.mark.parametrize("hp,N,Q", [(64, 128, 256), (128, 128, 256),
                                    (32, 32, 32), (64, 128, 64)])
def test_shared_memory_fits_a_block(hp, N, Q):
    """The serving shape (mamba2: hp 64, N 128, Q 256), jamba's widths
    (hp 128), the reduced config and Q 64 all fit one block's shared
    memory; the state alone at hp 64 x N 128 is 32 KB of f32."""
    assert K.smem_bytes(hp, N, Q) <= K.MAX_SMEM
    assert K.smem_bytes(64, 128, 256) - K.smem_bytes(64, 128, 0) == 2 * 4 * 256
