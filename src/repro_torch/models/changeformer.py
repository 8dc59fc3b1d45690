"""ChangeFormer-style siamese change-detection transformer (paper
Sect. III-C, after Bandara & Patel 2022): a shared hierarchical
transformer encoder applied to both timestamps, per-stage difference
modules, and a lightweight MLP decoder that fuses multi-scale differences
into a 2-class change map.  Port of ``repro.models.changeformer``.

As in the reference, attention is the plain whole-row
``models.layers.naive_attention``, not the flash kernel; the GELU is the
tanh form (``jax.nn.gelu``'s default); ``_ln`` has eps 1e-6 and no bias;
the 2x bilinear resize is ``F.interpolate(mode="bilinear",
align_corners=False)``, which agrees with ``jax.image.resize`` when
upsampling.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.common import resolve_device
from repro_torch.models.layers import naive_attention
from repro_torch.models.segmentation import (_upsample, conv, conv_init,
                                             group_norm, he_normal,
                                             pixel_xent)


def _block_init(generator, dim, heads, device, mlp_ratio=4):
    def w(d_in, d_out):
        return {"w": he_normal(generator, (d_in, d_out), d_in, device)}
    return {
        "qkv": w(dim, 3 * dim),
        "proj": w(dim, dim),
        "fc1": w(dim, mlp_ratio * dim),
        "fc2": w(mlp_ratio * dim, dim),
        "n1": torch.ones((dim,), device=device),
        "n2": torch.ones((dim,), device=device),
    }


def _ln(x, scale):
    return F.layer_norm(x, x.shape[-1:], scale, None, 1e-6)


def _block_apply(p, x, H: int):
    B, T, D = x.shape
    h = _ln(x, p["n1"])
    qkv = (h @ p["qkv"]["w"]).reshape(B, T, 3, H, D // H)
    out = naive_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                          causal=False, window=None)
    x = x + out.reshape(B, T, D) @ p["proj"]["w"]
    h = _ln(x, p["n2"])
    x = x + F.gelu(h @ p["fc1"]["w"], approximate="tanh") @ p["fc2"]["w"]
    return x


def changeformer_init(generator: torch.Generator, in_ch=3, classes=2,
                      dims=(32, 64), depths=(2, 2), heads=(2, 4),
                      device=None):
    """Random f32 parameters from ``generator``, on ``device`` (``cuda``
    unless given)."""
    device = resolve_device(device)
    stages = []
    c = in_ch
    for si, d in enumerate(dims):
        stages.append({
            "patch": conv_init(generator, 3, 3, c, d, device),
            "blocks": [_block_init(generator, d, heads[si], device)
                       for _ in range(depths[si])],
            # difference module: conv over concat(a, b, |a-b|)
            "diff": conv_init(generator, 3, 3, 3 * d, d, device),
        })
        c = d
    return {
        "stages": stages,
        "dec1": conv_init(generator, 1, 1, sum(dims), dims[-1], device),
        "dec2": conv_init(generator, 3, 3, dims[-1], dims[-1], device),
        "head": conv_init(generator, 1, 1, dims[-1], classes, device),
    }


DEFAULT_HEADS = (2, 4)


def _encode(stages, x, heads=DEFAULT_HEADS):
    feats = []
    for si, st in enumerate(stages):
        x = F.relu(group_norm(conv(st["patch"], x, stride=2)))
        B, H, W, D = x.shape
        t = x.reshape(B, H * W, D)
        for blk in st["blocks"]:
            t = _block_apply(blk, t, heads[si])
        x = t.reshape(B, H, W, D)
        feats.append(x)
    return feats


def changeformer_apply(params, img_a, img_b, heads=DEFAULT_HEADS):
    """img_a/img_b: (B, H, W, C) two timestamps -> (B, H, W, classes)."""
    fa = _encode(params["stages"], img_a, heads)
    fb = _encode(params["stages"], img_b, heads)
    diffs = []
    H0, W0 = fa[0].shape[1], fa[0].shape[2]
    for st, a, b in zip(params["stages"], fa, fb):
        d = F.relu(conv(st["diff"], torch.cat([a, b, (a - b).abs()],
                                              dim=-1)))
        if d.shape[1] != H0:
            d = F.interpolate(d.permute(0, 3, 1, 2), size=(H0, W0),
                              mode="bilinear",
                              align_corners=False).permute(0, 2, 3, 1)
        diffs.append(d)
    y = torch.cat(diffs, dim=-1)
    y = F.relu(conv(params["dec1"], y))
    y = F.relu(group_norm(conv(params["dec2"], y)))
    y = conv(params["head"], y)
    return _upsample(y, 2)


def changeformer_loss(params, a, b, masks):
    return pixel_xent(changeformer_apply(params, a, b), masks)
