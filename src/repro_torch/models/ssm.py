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

The reference's sequence-parallel scan (``ssd_seq_parallel``) serves
sequence-sharded meshes and belongs to the distributed slice; it is not
ported.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels.common import resolve_backend
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref
from repro_torch.models.layers import dense, dense_init, norm_apply


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


def _causal_conv(x, w, b):
    """Depthwise causal conv.  x: (B,S,C), w: (W,C)."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
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


def ssm_apply(params: dict, x: torch.Tensor, cfg: SSMConfig,
              return_state: bool = False, seq_len=None,
              backend: str = "auto"):
    """Training/prefill Mamba2 block.  x: (B,S,d) -> (B,S,d).

    ``seq_len`` ((B,) int, optional) marks the true per-row sequence length
    of right-padded batches: dt is zeroed past ``seq_len``, so the
    recurrent state is frozen at the last real token (exp(0) = 1 decay,
    zero contribution), and the returned conv state is the window ending at
    the last real token.  Outputs at padded positions are garbage and must
    be ignored by the caller.  With ``return_state`` it also returns the
    decode state ``{"h": (B,nh,hp,N) f32, "conv": (B,W-1,C) in x's dtype}``.
    """
    B, S, d = x.shape
    di = cfg.d_inner(d)
    nh = cfg.n_heads(d)
    gN = cfg.n_groups * cfg.d_state

    z = dense(params["in_z"], x)
    xc = dense(params["in_x"], x)
    Bc = dense(params["in_B"], x)
    Cc = dense(params["in_C"], x)
    dt = dense(params["in_dt"], x).float()

    conv_in = torch.cat([xc, Bc, Cc], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, params["conv_w"],
                                   params["conv_b"]))
    xc, Bc, Cc = torch.split(conv_out, [di, gN, gN], dim=-1)

    dt = F.softplus(dt + params["dt_bias"])
    if seq_len is not None:
        in_seq = (torch.arange(S, device=x.device)[None, :]
                  < seq_len.to(x.device)[:, None])               # (B,S)
        dt = dt * in_seq[..., None].to(dt.dtype)
    A = -torch.exp(params["A_log"])
    # views of conv_out: the kernel reads them through their strides
    xh = xc.reshape(B, S, nh, cfg.head_dim)
    Bg = Bc.reshape(B, S, cfg.n_groups, cfg.d_state)
    Cg = Cc.reshape(B, S, cfg.n_groups, cfg.d_state)

    if resolve_backend(backend, xh) == "cuda":
        y, h_final = ssd_scan(xh, dt, A, Bg, Cg, chunk=cfg.chunk,
                              return_state=True, backend="cuda")
    else:
        y, h_final = ssd_chunked(xh, dt, A, Bg, Cg, cfg)
    y = y + params["D"].to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(B, S, di)
    y = norm_apply("rmsnorm", {"scale": params["norm_scale"]},
                   y * F.silu(z))
    out = dense(params["out"], y)
    if not return_state:
        return out
    W = cfg.conv_width
    if seq_len is None:
        conv_state = (conv_in[:, -(W - 1):, :] if S >= W - 1
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
    di = cfg.d_inner(d_model)
    nh = cfg.n_heads(d_model)
    conv_ch = di + 2 * cfg.n_groups * cfg.d_state
    return {
        "h": torch.zeros((batch, nh, cfg.head_dim, cfg.d_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, conv_ch),
                            dtype=dtype, device=device),
    }


def ssm_decode_step(params: dict, state: dict, x: torch.Tensor,
                    cfg: SSMConfig):
    """One-token decode.  x: (B,1,d) -> (y (B,1,d), new_state)."""
    B, _, d = x.shape
    di = cfg.d_inner(d)
    nh = cfg.n_heads(d)
    gN = cfg.n_groups * cfg.d_state
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
    Bg = Bc.reshape(B, cfg.n_groups, cfg.d_state).float()
    Cg = Cc.reshape(B, cfg.n_groups, cfg.d_state).float()

    y, h_new = ssd_decode(state["h"], xh, dt, A, Bg, Cg)
    y = y + params["D"][None, :, None] * xh
    y = y.reshape(B, di).to(x.dtype)
    y = norm_apply("rmsnorm", {"scale": params["norm_scale"]},
                   y * F.silu(z))
    out = dense(params["out"], y)
    return out[:, None, :], {"h": h_new, "conv": new_conv}
