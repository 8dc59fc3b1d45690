"""The dry run on the ``meta`` device (``repro_torch.launch.dryrun``) and
the kernels' meta route.

* ``param_specs`` gives the reference's ``M.param_specs`` tree for every
  arch: the same checkpoint keys, shapes and dtypes, on ``meta``.
* Each kernel's meta formula equals ``FlopCounterMode``'s count of its
  plain version where both do the same arithmetic (non-causal attention's
  forward), and differs from it elsewhere by exactly the products the
  kernel skips (the SSD scan's upper triangles) or recomputes (the flash
  backward's S and dP).
* A full-width cell (stablelm-1.6b x train_4k, 256 x 4096) traces ``ok``
  without allocating a CPU tensor of a parameter's size, and its traced
  FLOPs match the analytic count once the count is made to do what the
  trainer does (see :func:`test_full_width_cell_traces`).
* hubert-xlarge x decode_32k is recorded as skipped.
"""
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.convert import _items, slot_prefix  # noqa: E402
from repro_torch.kernels.flash_attention import meta as FM  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_bwd_ref, attention_mask, attention_ref)
from repro_torch.kernels.ssd_scan import meta as SM  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import plain_backward  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.models.model import param_specs, period_len  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from torch_one_thread import one_thread  # noqa: E402,F401


def _flops(fn, *args, **kw) -> int:
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kw)
    return counter.get_total_flops()


def _meta(*tensors):
    return [torch.empty(t.shape, dtype=t.dtype, device="meta")
            for t in tensors]


# ------------------------------------------------------------ param specs
def _port_flat(params, period):
    """The port's tree as the reference's flat checkpoint keys -> (shape,
    dtype name): layer p*P + j is row p of ``periods/slot{j}/...``."""
    flat = {k: (tuple(t.shape), str(t.dtype).split(".")[1])
            for k, t in _items({k: v for k, v in params.items()
                                if k != "layers"})}
    layers = params["layers"]
    for j in range(period):
        rows = [dict(_items(layer)) for layer in layers[j::period]]
        for key, t in rows[0].items():
            flat[slot_prefix(j) + key] = ((len(rows), *t.shape),
                                          str(t.dtype).split(".")[1])
    return flat


@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_equal_the_reference(arch):
    ref = {"/".join(str(getattr(k, "key", k)) for k in path):
           (tuple(s.shape), str(s.dtype))
           for path, s in jax.tree_util.tree_flatten_with_path(
               JM.param_specs(jax_config(arch)))[0]}
    cfg = get_config(arch)
    params = param_specs(cfg)
    assert {t.device.type for t in tree_leaves(params)} == {"meta"}
    assert _port_flat(params, period_len(cfg)) == ref


# -------------------------------------------------------- kernel formulas
def _qkv(B, Sq, Sk, H, Kh, hd, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, Sq, H, hd, generator=g),
            torch.randn(B, Sk, Kh, hd, generator=g),
            torch.randn(B, Sk, Kh, hd, generator=g))


@pytest.mark.parametrize("dims", [(2, 48, 48, 4, 2, 16),
                                  (1, 40, 56, 2, 2, 8)])
def test_flash_formulas_against_the_plain_count(dims):
    """Non-causal, every (q, k) pair is admitted and the kernels do the
    plain version's products: K1 the forward's 4*hd a pair.  The plain
    backward forms S and dP once (10*hd); K2 (6*hd) and K3 (8*hd) each
    form them, so together they do 4*hd a pair more."""
    B, Sq, Sk, H, Kh, hd = dims
    q, k, v = _qkv(*dims)
    out, lse = attention_ref(q, k, v, causal=False)
    plain_fwd = _flops(attention_ref, q, k, v, causal=False)
    plain_bwd = _flops(attention_bwd_ref, q, k, v, out, lse, out,
                       causal=False)
    mq, mk, mv, mo = _meta(q, k, v, out)
    mlse, = _meta(lse)
    assert _flops(FM.flash_fwd_meta, mq, mk, mv, causal=False,
                  window=None) == plain_fwd
    pairs = B * H * Sq * Sk
    dq = _flops(torch.ops.repro_torch.flash_bwd_dq, mq, mk, mv, mo, mlse,
                mlse, False, None)
    dkv = _flops(torch.ops.repro_torch.flash_bwd_dkv, mq, mk, mv, mo, mlse,
                 mlse, False, None)
    assert (dq, dkv) == (6 * hd * pairs, 8 * hd * pairs)
    assert dq + dkv == plain_bwd + 4 * hd * pairs
    # the meta outputs have the kernels' shapes and dtypes
    o, l = FM.flash_fwd_meta(mq, mk, mv, causal=False, window=None)
    assert (o.shape, o.dtype, l.shape, l.dtype) == (
        out.shape, out.dtype, lse.shape, torch.float32)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 7),
                                           (False, 5), (False, None)])
@pytest.mark.parametrize("sq,sk", [(33, 33), (20, 45), (45, 20)])
def test_admitted_pairs_are_the_masks(sq, sk, causal, window):
    """Where the mask binds the kernels skip what it leaves out; the pairs
    the formulas count are the plain version's mask."""
    mask = attention_mask(sq, sk, causal=causal, window=window)
    assert FM.valid_pairs(sq, sk, causal, window) == int(mask.sum())


def _ssd_inputs(Bs, S, nh, hp, g, N, requires_grad=False):
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(Bs, S, nh, hp, generator=gen)
    dt = torch.rand(Bs, S, nh, generator=gen)
    A = -torch.rand(nh, generator=gen)
    B = torch.randn(Bs, S, g, N, generator=gen)
    C = torch.randn(Bs, S, g, N, generator=gen)
    return [t.requires_grad_(requires_grad) for t in (x, dt, A, B, C)]


@pytest.mark.parametrize("dims", [(2, 16, 4, 8, 2, 4), (1, 24, 6, 4, 3, 8)])
def test_ssd_formulas_against_the_plain_count(dims):
    """The inter-chunk and state products are the plain scan's.  Within a
    chunk of Q rows the plain scan forms the whole (Q, Q) square of C B^T
    and of M x, the kernel its causal half with the diagonal: Q (Q - 1)
    fewer products of g N and of nh hp per chunk.  The backward is
    autograd of the plain scan (3 F less the first chunk's inter-chunk
    gradient), counted here from the op itself."""
    Bs, S, nh, hp, g, N = dims
    x, dt, A, B, C = _ssd_inputs(*dims)
    xs, Bsh = tuple(x.shape), tuple(B.shape)
    for Q in (4, 8):
        nc = S // Q
        assert SM.kernel_flops(xs, Bsh, Q) == (
            _flops(ssd_chunked_ref, x, dt, A, B, C, Q)
            - Bs * nc * Q * (Q - 1) * (g * N + nh * hp))
        assert SM.plain_flops(xs, Bsh, Q) == _flops(ssd_chunked_ref, x, dt,
                                                    A, B, C, Q)
        leaves = _ssd_inputs(*dims, requires_grad=True)
        with FlopCounterMode(display=False) as counter:
            # the differentiable op, on the CPU: the plain forward, and the
            # backward that recomputes it, as on the card
            y, h = ssd_scan(*leaves, chunk=Q, return_state=True,
                            backend="cuda")
            fwd = counter.get_total_flops()
            (y.sum() + h.sum()).backward()
        assert counter.get_total_flops() - fwd == SM.backward_flops(
            xs, Bsh, Q)
        m = [torch.empty(t.shape, device="meta", requires_grad=True)
             for t in leaves]
        assert _flops(lambda: sum(o.sum() for o in ssd_scan(
            *m, chunk=Q, return_state=True)).backward()) == (
                SM.kernel_flops(xs, Bsh, Q) + SM.backward_flops(xs, Bsh, Q))
        assert m[0].grad.shape == x.shape and m[3].grad.shape == B.shape


@pytest.mark.parametrize("dims", [(2, 16, 4, 8, 2, 4), (1, 24, 6, 4, 3, 8)])
def test_ssd_backward_workspace_is_the_plain_backward(dims):
    """The meta route's backward allocates only the gradients; the dry run
    adds what the card's backward (autograd of the plain scan) holds
    beyond its inputs, traced on meta.  It is what the same code holds on
    CPU tensors."""
    Bs, S, nh, hp, g, N = dims
    x, dt, A, B, C = _ssd_inputs(*dims)
    x, B, C = (t.to(torch.bfloat16) for t in (x, B, C))
    dy = torch.randn(x.shape).to(torch.bfloat16)
    dh = torch.randn(Bs, nh, hp, N)
    args = (x, dt, A, B, C, dy, dh)
    for Q in (4, 8):
        live = D.LivePeak()
        for t in args:
            live.track(t)
        held = live.now
        with live:
            plain_backward(*args, Q)
        specs = D._specs(args + (Q,))
        assert D.ssd_backward_workspace(specs) == live.peak - held > 0


def test_cpu_tensors_keep_their_path():
    """A CPU tensor still takes the plain versions: the meta operators
    have no CPU kernel."""
    q, k, v = _qkv(1, 8, 8, 2, 2, 4)
    with pytest.raises(NotImplementedError):
        torch.ops.repro_torch.flash_fwd(q, k, v, True, None)


# ------------------------------------------------------ full-width cell
class _LargestCPUTensor(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.numel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else [out]):
            if isinstance(t, torch.Tensor) and t.device.type != "meta":
                self.numel = max(self.numel, t.numel())
        return out


@pytest.fixture(scope="module")
def stablelm_cell(tmp_path_factory):
    watch = _LargestCPUTensor()
    out = tmp_path_factory.mktemp("dryrun")
    with watch:
        rec = D.run_one("stablelm-1.6b", "train_4k", False, "fsdp_tp",
                        str(out))
    return rec, watch.numel, out


def test_full_width_cell_traces(stablelm_cell):
    """stablelm-1.6b x train_4k (256 x 4096, remat) on meta.

    Traced FLOPs = the analytic count (4 x the forward: forward, remat's
    recompute, a backward of twice the forward; attention at 4*hd per
    pair over S^2/2 pairs)
      + 6*hd per admitted (q, k) pair, head and attention layer: K2 and K3
        recompute S and dP, and the analytic model counts the backward's
        attention as twice the forward's;
      - one forward of the head (2 V d per scored position): the chunked
        loss runs outside the checkpointed layers, so its logits are not
        recomputed;
      - one forward of each layer's down projection (2 d_ff d per token):
        the non-reentrant checkpoint stops recomputing once every saved
        tensor is back, so a layer's last product runs once.
    The analytic count with the first term alone is 7.0% above the trace;
    with all three the two agree to 1e-3."""
    rec, _, out = stablelm_cell
    assert rec["status"] == "ok", rec.get("error")
    assert rec["traced"] == "meta: kernel formulas; world 1, dp"
    cfg = get_config("stablelm-1.6b")
    S, B = 4096, 256
    L, H, hd, d = cfg.n_layers, cfg.n_heads, cfg.head_dim, cfg.d_model
    want = (rec["analytic_flops_one_chip"]
            + 6 * hd * H * B * L * FM.valid_pairs(S, S, True, None)
            - 2 * cfg.vocab * d * B * (S - 1)
            - L * 2 * cfg.d_ff * d * B * S)
    assert rec["traced_flops"] == pytest.approx(want, rel=1e-3)
    by_op = rec["traced_flops_by_op"]
    pairs = FM.valid_pairs(S, S, True, None) * B * H * L
    assert by_op["repro_torch.flash_fwd"] == 2 * 4 * hd * pairs
    assert by_op["repro_torch.flash_bwd_dq"] == 6 * hd * pairs
    assert by_op["repro_torch.flash_bwd_dkv"] == 8 * hd * pairs
    nbytes = rec["bytes"]
    p = cfg.param_count() * 2                                  # bf16
    assert nbytes["params"] == nbytes["grads"] == p
    assert nbytes["optimizer_state"] == 2 * p                  # AdamW m, v
    assert nbytes["inputs"] == B * S * 4
    # every layer's input (B, S, d) in bf16 is kept for its recompute
    assert nbytes["saved_activations"] > L * B * S * d * 2
    # the peak holds at least what the backward starts from
    assert rec["peak_bytes"] > (nbytes["params"] + nbytes["optimizer_state"]
                                + nbytes["saved_activations"])
    assert rec["fits_one_card"] is False
    assert rec["max_batch_one_card"] == 16
    assert rec["peak_bytes_one_card"] <= D.one_card_budget()
    assert rec["roofline"]["dominant"] in ("compute_s", "memory_s",
                                           "collective_s")
    saved = json.loads((out / "stablelm-1.6b_train_4k_16x16_fsdp_tp.json")
                       .read_text())
    assert saved["traced_flops"] == rec["traced_flops"]


def test_full_width_cell_allocates_no_parameter(stablelm_cell):
    _, largest, _ = stablelm_cell
    assert largest < get_config("stablelm-1.6b").d_model


def test_encoder_decode_is_skipped(tmp_path):
    rec = D.run_one("hubert-xlarge", "decode_32k", False, "fsdp_tp",
                    str(tmp_path))
    assert rec["status"] == "skipped"
    assert rec["reason"] == "encoder-only: no decode step"
    assert (tmp_path / "hubert-xlarge_decode_32k_16x16_fsdp_tp.json").exists()


def test_one_card_fit_halves_from_the_data_shard():
    gb = 1e9
    fixed = {"params": 10 * gb, "grads": 10 * gb, "optimizer_state": 20 * gb,
             "inputs": 0, "decode_state": 0, "saved_activations": 0}

    def traced(peak, **kinds):
        return {"bytes": dict(fixed, **kinds), "peak_bytes": peak}

    # 40 GB fixed against 68 GB (80 less the 15% reserve): a peak of 1 GB
    # a row more makes 56 GB at 16 rows; of 3 GB a row 88 GB, at 8 rows
    # 64 GB
    assert D.one_card_fit(traced(40 * gb + 256 * gb), 256) == (False, 16)
    assert D.one_card_fit(traced(40 * gb + 256 * 3 * gb), 256) == (False, 8)
    assert D.peak_at(traced(40 * gb + 256 * 3 * gb), 256, 8) == 64 * gb
    assert D.one_card_fit(traced(100 * gb, params=70 * gb), 256) == (
        False, 0)
    # a shape whose whole batch fits keeps batch // 16
    assert D.one_card_fit(traced(50 * gb), 32) == (True, 2)


def test_live_peak_counts_storages_while_alive():
    """Views and in-place results add nothing; a freed storage leaves the
    count and its serial is not reused."""
    live = D.LivePeak()
    with live:
        a = torch.empty(1000, device="meta")            # 4 000 bytes
        b = a.view(10, 100)
        a.add_(1)
        c = torch.empty(500, dtype=torch.bfloat16, device="meta")
        assert live.now == live.peak == 5000
        first = live.track(c)
        del c
        assert live.now == 4000
        d = torch.empty(250, device="meta")
        assert live.track(d) != first and live.track(b) == live.track(a)
    assert live.peak == 5000 and live.now == 5000
