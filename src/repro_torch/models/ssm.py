"""Mamba2 block — SSD (state-space duality, arXiv:2405.21060).  Port of
``repro.models.ssm``.

Prefill uses the chunked SSD form: intra-chunk terms are dense (Q x Q)
masked products and inter-chunk terms a recurrence over chunk states.
``mixer_backend`` picks the scan: the hand-written CUDA kernel K4 through
:func:`repro_torch.kernels.ssd_scan.ssd_scan` (``"cuda"``, and ``"auto"``
on CUDA tensors), or the plain chunked scan :func:`ssd_chunked`
(``"torch"``, and ``"auto"`` on CPU tensors).  Decode is the O(1)
recurrent update :func:`ssd_decode`, plain tensor code: the JAX package
has no kernel for it.

Under a :class:`repro_torch.sharding.ShardCtx` whose ``seq`` axis has an
extent above 1 (``fsdp_sp`` on a mesh with a ``model`` axis) the mixer
takes the reference's sequence-parallel scan, :func:`ssd_seq_parallel`,
as the reference's ``ssm_apply`` does.  Its segments are folded into the
batch, so that one scan call covers them all (K4 on CUDA tensors, the
plain chunked scan on CPU tensors); the cross-segment combine and the
local correction are plain tensor code, as in the reference.  Unlike the
reference, which leaves its Pallas kernel under a multi-device ctx
(``pallas_call`` has no GSPMD rule), the port's tensors are a rank's own,
so K4 stays on the sharded path.  A rank of a data grid holds its rows
whole: its ctx has one segment, and the scan is the one above.

Across ranks (``sp``, a :class:`repro_torch.sharding.sp.SP`: ``fsdp_sp``
on a model axis) each rank holds one segment, its block of the
sequence: the causal conv takes the previous rank's last ``W - 1``
inputs (the halo), K4 runs the segment from a zero state in one launch,
the segments' final states and decays are all-gathered and combined in
f32 (:func:`ssd_seq_ranks`), and the rank adds its incoming state's
correction.  Every rank computes the final state from the gathered
ones, and the last rank's halo rows are the prefill's conv state.  A
block shorter than the chunk (or than ``W - 1``) takes the reference's
fallback, the whole-sequence scan that GSPMD gathers for: the mixer's
input is gathered over the model group (``SP.gather_seq``, whose
backward reduce-scatters), the whole sequence runs (K4 on CUDA tensors)
and the rank keeps its block of the output; the state is the whole
sequence's.  The decode step (:func:`ssm_decode_step`) runs on the
rules' blocks of the state: the rank convolves its ``C / M`` channels of
``[x, B, C]`` from its columns of the projections, the post-conv row is
all-gathered (``gather_channels``), and the rank steps its ``nh /
M`` heads, the gated norm's sum of squares and ``out``'s partial sums
all-reduced (a dim ``M`` does not divide is whole on every rank, and
needs neither).

Under a model axis (``tp``, a :class:`repro_torch.sharding.tp.TP`) the
mixer runs on the rank's ``nh / M`` heads through K4 (or the plain scan
on CPU tensors), with the B/C groups those heads read; ``in_z``,
``in_x``, ``in_dt`` are column-parallel and ``out`` row-parallel.  The
gated RMSNorm is over the whole ``d_inner``, as in the reference, so its
sum of squares is all-reduced over ``model``.  The conv weights are
split over the concatenated ``[x, B, C]`` channels, so a rank gathers
them and keeps its own channels.  The decode state is the rules' block,
as under ``fsdp_sp``: the rank's heads (``h``) and its ``C / M``
channels of ``[x, B, C]`` (``conv``).  So a prefill's conv rows of the
rank's x columns and groups are resharded to that channel block
(``TP.reshard_conv``), and a decode step (:func:`_decode_tp`) gathers
the token's whole ``[x, B, C]`` row from the ranks' columns, convolves
the rank's channel block and gathers the post-conv row before its heads'
step.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels.common import resolve_backend
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref
from repro_torch.models.layers import dense, dense_init, norm_apply
from repro_torch.sharding.ctx import axis_extent_of
from repro_torch.sharding.sp import RAGGED_NEXT, short_block


def ssm_init(generator: torch.Generator, d_model: int, cfg: SSMConfig,
             dtype, device) -> dict:
    g = generator
    di = cfg.d_inner(d_model)
    nh = cfg.n_heads(d_model)
    gN = cfg.n_groups * cfg.d_state
    conv_ch = di + 2 * gN
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_z": dense_init(g, d_model, di, dtype, device),
        "in_x": dense_init(g, d_model, di, dtype, device),
        "in_B": dense_init(g, d_model, gN, dtype, device),
        "in_C": dense_init(g, d_model, gN, dtype, device),
        "in_dt": dense_init(g, d_model, nh, dtype, device),
        "dt_bias": torch.zeros((nh,), **f32),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        "D": torch.ones((nh,), **f32),
        "conv_w": (torch.randn((cfg.conv_width, conv_ch), generator=g, **f32)
                   * 0.1).to(dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "norm_scale": torch.ones((di,), dtype=dtype, device=device),
        "out": dense_init(g, di, d_model, dtype, device),
    }


def _causal_conv(x, w, b, halo=None):
    """Depthwise causal conv.  x: (B,S,C), w: (W,C); ``halo`` (B,W-1,C)
    are the inputs before x's first row (zeros by default)."""
    W, S = w.shape[0], x.shape[1]
    xp = (F.pad(x, (0, 0, W - 1, 0)) if halo is None
          else torch.cat([halo.to(x.dtype), x], dim=1))
    return sum(xp[:, i:i + S, :] * w[i] for i in range(W)) + b


def _conv_decode(state, xnew, w, b):
    """state: (B, W-1, C); xnew: (B, C) -> (out (B,C), new_state)."""
    window = torch.cat([state, xnew[:, None, :]], dim=1)      # (B,W,C)
    out = torch.einsum("bwc,wc->bc", window, w) + b
    return out, window[:, 1:, :]


def ssd_chunked(x, dt, A, B_, C_, cfg: SSMConfig, h0=None):
    """Chunked SSD scan, plain PyTorch.  x: (B,S,nh,hp); dt: (B,S,nh)
    (post-softplus, f32); A: (nh,) negative; B_, C_: (B,S,g,N).  Returns
    ``(y (B,S,nh,hp), h_final (B,nh,hp,N) f32)``.  The reference's model
    scan and its kernel's plain twin do the same arithmetic term for term,
    so this is the kernel's plain version at the config's chunk."""
    return ssd_chunked_ref(x, dt, A, B_, C_, cfg.chunk, h0=h0)


def ssd_decode(h, x, dt, A, B_, C_):
    """Single-token recurrence.  x: (B,nh,hp); dt: (B,nh); B_/C_: (B,g,N);
    h: (B,nh,hp,N).  Returns ``(y (B,nh,hp), h_new)``."""
    rep = x.shape[1] // B_.shape[1]
    Bh = B_.repeat_interleave(rep, dim=1)                # (B,nh,N)
    Ch = C_.repeat_interleave(rep, dim=1)
    a = torch.exp(dt * A)                                # (B,nh)
    h_new = a[:, :, None, None] * h + torch.einsum(
        "bhp,bhn->bhpn", x * dt[..., None], Bh)
    y = torch.einsum("bhpn,bhn->bhp", h_new, Ch)
    return y, h_new


def _seq_shards(S: int) -> int:
    """Sequence shard count from the active ctx (``fsdp_sp``'s ``seq``
    axis), else 1; 1 too when it does not divide ``S``."""
    g = axis_extent_of("seq")
    return g if (g > 1 and S % g == 0) else 1


def _scan(x, dt, A, B_, C_, cfg: SSMConfig, backend: str):
    """``(y, h_final)`` of the chunked scan: K4 on CUDA tensors (and
    ``backend="cuda"``), the plain scan otherwise."""
    if resolve_backend(backend, x) == "cuda":
        return ssd_scan(x, dt, A, B_, C_, chunk=cfg.chunk,
                        return_state=True, backend="cuda")
    return ssd_chunked(x, dt, A, B_, C_, cfg)


def ssd_seq_parallel(x, dt, A, B_, C_, cfg: SSMConfig, n_seg: int,
                     backend: str = "auto"):
    """Sequence-parallel SSD (the reference's): the chunk recurrence is
    an associative scan, so each of ``n_seg`` sequence segments runs from
    a zero state, the segments' final states are combined in one tiny
    scan over the segments, and each segment adds the incoming state's
    correction.  The segments are folded into the batch: one scan call
    runs them all.  Shapes and return as :func:`ssd_chunked`."""
    Bsz, S, nh, hp = x.shape
    g, N = B_.shape[2], B_.shape[3]
    rep = nh // g
    Sl = S // n_seg

    def fold(t):
        return t.reshape((Bsz * n_seg, Sl) + tuple(t.shape[2:]))

    y_loc, h_seg = _scan(fold(x), fold(dt), A, fold(B_), fold(C_), cfg,
                         backend)
    h_seg = h_seg.reshape(Bsz, n_seg, nh, hp, N)

    # per-segment total decay and incoming states (the tiny combine)
    la_seg = torch.cumsum(dt.reshape(Bsz, n_seg, Sl, nh) * A, dim=2)
    seg_decay = torch.exp(la_seg[:, :, -1, :])               # (B,n_seg,nh)
    h = torch.zeros_like(h_seg[:, 0])
    h_ins = []
    for s in range(n_seg):
        h_ins.append(h)
        h = seg_decay[:, s, :, None, None] * h + h_seg[:, s]
    h_in = torch.stack(h_ins, dim=1)                      # (B,n_seg,nh,hp,N)

    # local correction: y[t] += C_t . (exp(la_local[t]) * h_in[segment])
    Ch = C_.reshape(Bsz, n_seg, Sl, g, N).float().repeat_interleave(
        rep, dim=3)                                       # (B,n_seg,Sl,nh,N)
    y_corr = torch.einsum("bsthn,bshpn->bsthp",
                          Ch * torch.exp(la_seg)[..., None], h_in)
    y = y_loc.reshape(Bsz, n_seg, Sl, nh, hp) + y_corr.to(y_loc.dtype)
    # h, after the last segment, is the final state
    return y.reshape(Bsz, S, nh, hp), h


def ssd_seq_ranks(x, dt, A, B_, C_, cfg: SSMConfig, sp,
                  backend: str = "auto"):
    """:func:`ssd_seq_parallel` with one segment a rank: the rank's
    block ``x`` (B,Sl,nh,hp) etc. runs from a zero state (K4 on CUDA
    tensors), the ranks' final states and decays are exchanged
    (``sp.exchange_states``), and the block adds the correction of its
    incoming state.  Returns ``(y (B,Sl,nh,hp), h_final (B,nh,hp,N))``,
    the final state the whole sequence's."""
    rep = x.shape[2] // B_.shape[2]
    y_loc, h_seg = _scan(x, dt, A, B_, C_, cfg, backend)
    la = torch.cumsum(dt * A, dim=1)                         # (B,Sl,nh)
    h_in, h_final = sp.exchange_states(h_seg, torch.exp(la[:, -1]))
    Ch = C_.float().repeat_interleave(rep, dim=2)            # (B,Sl,nh,N)
    y_corr = torch.einsum("bthn,bhpn->bthp",
                          Ch * torch.exp(la)[..., None], h_in)
    return y_loc + y_corr.to(y_loc.dtype), h_final


def _gated_norm(params, y, z, tp):
    """The gated RMSNorm of ``y * silu(z)`` over the whole d_inner
    (eps 1e-6, in f32): under ``tp`` the rank's columns, the sum of
    squares all-reduced."""
    if tp is None:
        return norm_apply("rmsnorm", {"scale": params["norm_scale"]},
                          y * F.silu(z))
    v = y * F.silu(z)
    vf = v.float()
    ss = tp.psum(vf.square().sum(dim=-1, keepdim=True))
    var = ss / (vf.shape[-1] * tp.M)
    return (vf * torch.rsqrt(var + 1e-6)
            * params["norm_scale"].float()).to(v.dtype)


def _local(params, cfg: SSMConfig, d: int, tp):
    """``(params, heads, groups)``: as given, or the rank's under
    ``tp``."""
    if tp is None:
        return params, cfg.n_heads(d), cfg.n_groups
    return tp.ssm(params, cfg, d)


def ssm_apply(params: dict, x: torch.Tensor, cfg: SSMConfig,
              return_state: bool = False, seq_len=None,
              backend: str = "auto", tp=None, sp=None):
    """Training/prefill Mamba2 block.  x: (B,S,d) -> (B,S,d).

    ``seq_len`` ((B,) int, optional) marks the true per-row sequence length
    of right-padded batches: dt is zeroed past ``seq_len``, so the
    recurrent state is frozen at the last real token (exp(0) = 1 decay,
    zero contribution), and the returned conv state is the window ending at
    the last real token.  Outputs at padded positions are garbage and must
    be ignored by the caller.  With ``return_state`` it also returns the
    decode state ``{"h": (B,nh,hp,N) f32, "conv": (B,W-1,C) in x's dtype}``
    (under ``tp``: the rank's heads and channels).  Under ``sp`` x is the
    rank's block of the sequence and the state the whole sequence's.
    """
    B, S, d = x.shape
    W = cfg.conv_width
    if sp is not None and seq_len is not None:
        raise NotImplementedError(RAGGED_NEXT)
    if sp is not None and short_block(cfg, S):
        # the reference's fallback below the chunk: the whole sequence
        got = ssm_apply(params, sp.gather_seq(x), cfg, return_state,
                        backend=backend)
        if not return_state:
            return sp.narrow(got)
        return sp.narrow(got[0]), got[1]
    params, nh, groups = _local(params, cfg, d, tp)
    if tp is not None:
        x = tp.enter(x)
    di = nh * cfg.head_dim
    gN = groups * cfg.d_state

    z = dense(params["in_z"], x)
    xc = dense(params["in_x"], x)
    Bc = dense(params["in_B"], x)
    Cc = dense(params["in_C"], x)
    dt = dense(params["in_dt"], x).float()

    conv_in = torch.cat([xc, Bc, Cc], dim=-1)
    halo = last = None
    if sp is not None:
        halo, last = sp.halo(conv_in[:, S - (W - 1):])
    conv_out = F.silu(_causal_conv(conv_in, params["conv_w"],
                                   params["conv_b"], halo))
    xc, Bc, Cc = torch.split(conv_out, [di, gN, gN], dim=-1)

    dt = F.softplus(dt + params["dt_bias"])
    if seq_len is not None:
        in_seq = (torch.arange(S, device=x.device)[None, :]
                  < seq_len.to(x.device)[:, None])               # (B,S)
        dt = dt * in_seq[..., None].to(dt.dtype)
    A = -torch.exp(params["A_log"])
    # views of conv_out: the kernel reads them through their strides
    xh = xc.reshape(B, S, nh, cfg.head_dim)
    Bg = Bc.reshape(B, S, groups, cfg.d_state)
    Cg = Cc.reshape(B, S, groups, cfg.d_state)

    n_seg = _seq_shards(S)
    if sp is not None:
        y, h_final = ssd_seq_ranks(xh, dt, A, Bg, Cg, cfg, sp, backend)
    elif n_seg > 1 and (S // n_seg) >= cfg.chunk:
        y, h_final = ssd_seq_parallel(xh, dt, A, Bg, Cg, cfg, n_seg,
                                      backend)
    else:
        y, h_final = _scan(xh, dt, A, Bg, Cg, cfg, backend)
    y = y + params["D"].to(y.dtype)[None, None, :, None] * xh
    y = _gated_norm(params, y.reshape(B, S, di), z, tp)
    out = dense(params["out"], y)
    if tp is not None:
        out = tp.exit(out)
    if not return_state:
        return out
    if sp is not None:
        conv_state = last
    elif seq_len is None:
        # a copy, not a view: a view of the last W-1 rows would keep the
        # whole (B, S, C) conv input alive in every layer's decode state
        conv_state = (conv_in[:, -(W - 1):, :].clone() if S >= W - 1
                      else F.pad(conv_in, (0, 0, W - 1 - S, 0)))
    else:
        # per-row window of the last W-1 real inputs (zeros before the
        # sequence start, as decode's zeroed conv state for short prompts)
        idx = (seq_len.to(x.device).long()[:, None] - (W - 1)
               + torch.arange(W - 1, device=x.device)[None, :])
        got = torch.gather(conv_in, 1, idx.clamp(0, S - 1)[..., None]
                           .expand(B, W - 1, conv_in.shape[-1]))
        conv_state = torch.where((idx >= 0)[..., None], got, 0.0)
    return out, {"h": h_final, "conv": conv_state.to(x.dtype)}


def ssm_state_init(batch: int, d_model: int, cfg: SSMConfig, dtype,
                   device) -> dict:
    """The zeroed decode state."""
    nh = cfg.n_heads(d_model)
    conv_ch = nh * cfg.head_dim + 2 * cfg.n_groups * cfg.d_state
    return {
        "h": torch.zeros((batch, nh, cfg.head_dim, cfg.d_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, conv_ch),
                            dtype=dtype, device=device),
    }


def ssm_decode_step(params: dict, state: dict, x: torch.Tensor,
                    cfg: SSMConfig, tp=None, sp=None):
    """One-token decode.  x: (B,1,d) -> (y (B,1,d), new_state); under
    ``tp`` or ``sp`` the state is the rank's block of it (:func:`_decode_sp`,
    :func:`_decode_tp`)."""
    if sp is not None:
        return _decode_sp(params, state, x, cfg, sp)
    if tp is not None:
        return _decode_tp(params, state, x, cfg, tp)
    B, _, d = x.shape
    nh, groups = cfg.n_heads(d), cfg.n_groups
    di = nh * cfg.head_dim
    gN = groups * cfg.d_state
    xt = x[:, 0, :]

    z = dense(params["in_z"], xt)
    xc = dense(params["in_x"], xt)
    Bc = dense(params["in_B"], xt)
    Cc = dense(params["in_C"], xt)
    dt = dense(params["in_dt"], xt).float()

    conv_in = torch.cat([xc, Bc, Cc], dim=-1)               # (B, C)
    conv_out, new_conv = _conv_decode(state["conv"], conv_in,
                                      params["conv_w"], params["conv_b"])
    conv_out = F.silu(conv_out)
    xc, Bc, Cc = torch.split(conv_out, [di, gN, gN], dim=-1)

    dt = F.softplus(dt + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    xh = xc.reshape(B, nh, cfg.head_dim).float()
    Bg = Bc.reshape(B, groups, cfg.d_state).float()
    Cg = Cc.reshape(B, groups, cfg.d_state).float()

    y, h_new = ssd_decode(state["h"], xh, dt, A, Bg, Cg)
    y = y + params["D"][None, :, None] * xh
    y = _gated_norm(params, y.reshape(B, di).to(x.dtype), z, None)
    out = dense(params["out"], y)
    return out[:, None, :], {"h": h_new, "conv": new_conv}


def _columns(params, xt, keys, lo: int, hi: int):
    """Columns ``[lo, hi)`` of ``xt`` times the concatenation of the
    projections ``keys`` ((name, width) in order), without forming it."""
    parts, start = [], 0
    for key, width in keys:
        a, b = max(lo, start), min(hi, start + width)
        if a < b:
            parts.append(xt @ params[key]["w"][:, a - start:b - start])
        start += width
    return torch.cat(parts, dim=-1)


def _conv_channels(state, row, w, b, axis, C: int):
    """The decode conv of the rank's block of the ``[x, B, C]`` channels:
    ``row`` (B, c) the token's, ``w``/``b`` those channels' weights,
    ``state`` their rows.  Returns the whole post-conv row (B, ``C``),
    the blocks gathered over ``axis`` where they are split
    (``gather_channels``), and the new state block."""
    conv_out, new_conv = _conv_decode(state, row, w, b)
    conv_out = F.silu(conv_out)
    if row.shape[-1] < C:
        conv_out = axis.gather_channels(conv_out)
    return conv_out, new_conv


def _step_heads(conv_out, dt, p: dict, h, cfg: SSMConfig, nh: int,
                h0: int, h1: int):
    """The SSD step of heads ``[h0, h1)`` from the token's whole post-conv
    ``[x, B, C]`` row ``conv_out`` (B, C), their ``dt`` (B, h1-h0) f32
    before the softplus and ``p``'s ``dt_bias``, ``A_log`` and ``D`` at
    those heads; ``h`` their state.  Returns ``(y (B, (h1-h0) hp) f32,
    new h)``."""
    B = conv_out.shape[0]
    hp, N, g = cfg.head_dim, cfg.d_state, cfg.n_groups
    di, gN = nh * hp, g * N
    xc, Bc, Cc = torch.split(conv_out, [di, gN, gN], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xc.reshape(B, nh, hp)[:, h0:h1].float()
    # each head's group, per head: B and C of the heads
    Bh = Bc.reshape(B, g, N).repeat_interleave(nh // g, dim=1)[:, h0:h1]
    Ch = Cc.reshape(B, g, N).repeat_interleave(nh // g, dim=1)[:, h0:h1]
    y, h_new = ssd_decode(h, xh, dt, A, Bh.float(), Ch.float())
    y = y + p["D"][None, :, None] * xh
    return y.reshape(B, -1), h_new


def _decode_sp(params, state, x, cfg: SSMConfig, sp):
    """:func:`ssm_decode_step` on the rank's blocks of the state, the
    weights whole: ``conv`` holds channels ``[c0, c1)`` of ``[x, B, C]``
    and ``h`` heads ``[h0, h1)`` (``sp.span``; whole where ``M`` does not
    divide).  The rank convolves its channels, the post-conv row is
    gathered where the channels are split, and the rank steps its heads;
    where they are split the gated norm's sum of squares and ``out``'s
    partial sums are all-reduced."""
    B, _, d = x.shape
    nh, hp, gN = cfg.n_heads(d), cfg.head_dim, cfg.n_groups * cfg.d_state
    di = nh * hp
    c0, c1 = sp.span(di + 2 * gN)
    h0, h1 = sp.span(nh)
    xt = x[:, 0, :]

    conv_in = _columns(params, xt, (("in_x", di), ("in_B", gN),
                                    ("in_C", gN)), c0, c1)
    conv_out, new_conv = _conv_channels(state["conv"], conv_in,
                                        params["conv_w"][:, c0:c1],
                                        params["conv_b"][c0:c1], sp,
                                        di + 2 * gN)

    z = xt @ params["in_z"]["w"][:, h0 * hp:h1 * hp]
    dt = (xt @ params["in_dt"]["w"][:, h0:h1]).float()
    y, h_new = _step_heads(conv_out, dt, {k: params[k][h0:h1] for k in
                                          ("dt_bias", "A_log", "D")},
                           state["h"], cfg, nh, h0, h1)
    split = h1 - h0 < nh
    y = _gated_norm({"norm_scale": params["norm_scale"][h0 * hp:h1 * hp]},
                    y.to(x.dtype), z, sp if split else None)
    out = y @ params["out"]["w"][h0 * hp:h1 * hp]
    if split:
        out = sp.allreduce(out, "tp_allreduce")
    return out[:, None, :], {"h": h_new, "conv": new_conv}


def _decode_tp(params, state, x, cfg: SSMConfig, tp):
    """:func:`ssm_decode_step` under ``fsdp_tp``, the state on the rules'
    blocks: ``h`` the rank's heads ``[h0, h1)`` (its ``Plan``'s), ``conv``
    channels ``[c0, c1)`` of ``[x, B, C]`` (``tp.span``).  The rank
    computes its x columns and its groups' B and C (column-parallel, as
    in prefill), the token's whole ``[x, B, C]`` row is all-gathered
    (``TP.gather_xbc``), the rank convolves its channel block with its
    model blocks of ``conv_w``/``conv_b`` (the rules split them over the
    same channels), the post-conv row is gathered where the channels
    are split (``conv_allgather``), and the rank steps its heads: the
    gated norm's sum of squares and ``out``'s partial sums all-reduced."""
    B, _, d = x.shape
    local, _, _ = tp.ssm(params, cfg, d, conv=False)
    nh, hp = cfg.n_heads(d), cfg.head_dim
    C = nh * hp + 2 * cfg.n_groups * cfg.d_state
    h0, h1 = tp.plan.ssm_heads
    c0, c1 = tp.span(C)
    xt = tp.enter(x)[:, 0, :]

    row = tp.gather_xbc(torch.cat([xt @ local[k]["w"] for k in
                                   ("in_x", "in_B", "in_C")], -1), cfg)
    conv_out, new_conv = _conv_channels(state["conv"], row[:, c0:c1],
                                        local["conv_w"], local["conv_b"], tp,
                                        C)

    z = xt @ local["in_z"]["w"]
    dt = (xt @ local["in_dt"]["w"]).float()
    y, h_new = _step_heads(conv_out, dt, local, state["h"], cfg, nh, h0, h1)
    y = _gated_norm(local, y.to(x.dtype), z, tp)
    out = tp.exit(y @ local["out"]["w"])
    return out[:, None, :], {"h": h_new, "conv": new_conv}
