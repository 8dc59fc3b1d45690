"""Semantic-segmentation model family from the paper's burned-area study:
U-Net, U-Net++, DeepLabV3, DeepLabV3+ (Table IV).  Port of
``repro.models.segmentation``.

Parameters are plain nested dicts and lists of tensors, as in the
reference, and keep its layout: activations are NHWC and convolution
weights HWIO, so a checkpoint of either package loads in the other
unchanged (``repro_torch.convert.vision_params_from_flat``).  A
convolution permutes its weight to OIHW at use and runs on the NCHW view
``x.permute(0, 3, 1, 2)`` of the NHWC activations, which is a
channels-last tensor and costs no copy.

Numerical points where PyTorch's defaults differ from the reference's:
- XLA's ``SAME`` padding puts the odd pixel at the end (a 3x3 stride-2
  convolution on an even size pads (0, 1)), where ``padding=1`` pads
  (1, 1); :func:`conv` computes XLA's pads itself.
- ``_pool`` is ``SAME`` max pooling, which pads with -inf at the end:
  ``max_pool2d(..., ceil_mode=True)``.
- ``group_norm`` picks ``g = min(8, C)`` and decrements until it divides
  C; channel c falls in group ``c // (C / g)``, as in ``F.group_norm``;
  no affine, eps 1e-5.
"""
from __future__ import annotations

import functools
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels.common import resolve_device


def he_normal(generator: torch.Generator, shape, fan_in: int,
              device) -> torch.Tensor:
    """``jax.nn.initializers.he_normal()``: a normal truncated at two
    standard deviations, scaled to variance 2 / fan_in (the reference's
    RNG gives other numbers; tests load its weights instead)."""
    std = (2.0 / fan_in) ** 0.5 / 0.87962566103423978
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w * std


def conv_init(generator, kh, kw, cin, cout, device) -> dict:
    return {"w": he_normal(generator, (kh, kw, cin, cout), kh * kw * cin,
                           device),
            "b": torch.zeros((cout,), dtype=torch.float32, device=device)}


def same_pads(size: int, k: int, stride: int, dilation: int):
    """XLA's ``SAME`` padding of one spatial dim: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def conv(params, x, stride=1, dilation=1):
    """``SAME`` convolution.  x: (N, H, W, Cin); w: (kh, kw, Cin, Cout)."""
    w = params["w"]
    (h0, h1) = same_pads(x.shape[1], w.shape[0], stride, dilation)
    (w0, w1) = same_pads(x.shape[2], w.shape[1], stride, dilation)
    xc = x.permute(0, 3, 1, 2)
    if (h0, w0) == (h1, w1):
        pad = (h0, w0)
    else:
        xc = F.pad(xc, (w0, w1, h0, h1))
        pad = 0
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), None, stride, pad, dilation)
    return y.permute(0, 2, 3, 1) + params["b"]


def group_norm(x, groups=8, eps=1e-5):
    C = x.shape[-1]
    g = min(groups, C)
    while C % g:
        g -= 1
    return F.group_norm(x.permute(0, 3, 1, 2), g, eps=eps).permute(0, 2, 3, 1)


def double_conv_init(generator, cin, cout, device):
    return {"c1": conv_init(generator, 3, 3, cin, cout, device),
            "c2": conv_init(generator, 3, 3, cout, cout, device)}


def double_conv(params, x):
    x = F.relu(group_norm(conv(params["c1"], x)))
    return F.relu(group_norm(conv(params["c2"], x)))


def _pool(x):
    y = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2, ceil_mode=True)
    return y.permute(0, 2, 3, 1)


def _upsample(x, factor=2):
    """Nearest resize by an integer factor."""
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=factor,
                      mode="nearest")
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------- U-Net
def unet_init(generator, in_ch=3, classes=2, width=16, depth=4, device=None):
    enc, dec = [], []
    c = in_ch
    for i in range(depth):
        enc.append(double_conv_init(generator, c, width * 2 ** i, device))
        c = width * 2 ** i
    for i in range(depth - 1):
        cin = width * 2 ** (depth - 1 - i) + width * 2 ** (depth - 2 - i)
        dec.append(double_conv_init(generator, cin,
                                    width * 2 ** (depth - 2 - i), device))
    return {"enc": enc, "dec": dec,
            "head": conv_init(generator, 1, 1, width, classes, device)}


def unet_apply(params, x):
    skips = []
    for i, p in enumerate(params["enc"]):
        x = double_conv(p, x)
        if i < len(params["enc"]) - 1:
            skips.append(x)
            x = _pool(x)
    for p, skip in zip(params["dec"], reversed(skips)):
        x = _upsample(x)
        x = torch.cat([x, skip], dim=-1)
        x = double_conv(p, x)
    return conv(params["head"], x)


# ------------------------------------------------------------- U-Net++
def unetpp_init(generator, in_ch=3, classes=2, width=16, depth=3,
                device=None):
    """Nested U-Net: node X[i][j] refines upsampled X[i+1][j-1] with dense
    skips from X[i][0..j-1]."""
    enc = []
    c = in_ch
    for i in range(depth + 1):
        enc.append(double_conv_init(generator, c, width * 2 ** i, device))
        c = width * 2 ** i
    nodes = {}
    for j in range(1, depth + 1):
        for i in range(depth + 1 - j):
            ci = width * 2 ** i
            cin = ci * j + width * 2 ** (i + 1)
            nodes[f"{i}_{j}"] = double_conv_init(generator, cin, ci, device)
    return {"enc": enc, "nodes": nodes,
            "head": conv_init(generator, 1, 1, width, classes, device)}


def unetpp_apply(params, x):
    depth = len(params["enc"]) - 1
    X: Dict[str, torch.Tensor] = {}
    cur = x
    for i, p in enumerate(params["enc"]):
        cur2 = double_conv(p, cur)
        X[f"{i}_0"] = cur2
        cur = _pool(cur2)
    for j in range(1, depth + 1):
        for i in range(depth + 1 - j):
            ups = _upsample(X[f"{i + 1}_{j - 1}"])
            cat = torch.cat([X[f"{i}_{k}"] for k in range(j)] + [ups],
                            dim=-1)
            X[f"{i}_{j}"] = double_conv(params["nodes"][f"{i}_{j}"], cat)
    return conv(params["head"], X[f"0_{depth}"])


# ------------------------------------------------------------ DeepLabV3
def _backbone_init(generator, in_ch, width, device):
    return [
        double_conv_init(generator, in_ch, width, device),          # /1
        double_conv_init(generator, width, width * 2, device),      # /2
        double_conv_init(generator, width * 2, width * 4, device),  # /4
        double_conv_init(generator, width * 4, width * 8, device),  # /8
    ]


def _backbone_apply(blocks, x):
    low = None
    for i, p in enumerate(blocks):
        x = double_conv(p, x)
        if i == 1:
            low = x
        if i < 2:
            x = _pool(x)
    return x, low


ASPP_RATES = (1, 6, 12)


def aspp_init(generator, cin, cout, rates=ASPP_RATES, device=None):
    return {
        "branches": [conv_init(generator, 3 if r > 1 else 1,
                               3 if r > 1 else 1, cin, cout, device)
                     for r in rates],
        "pool_proj": conv_init(generator, 1, 1, cin, cout, device),
        "proj": conv_init(generator, 1, 1, cout * (len(rates) + 1), cout,
                          device),
    }


def aspp_apply(params, x, rates=ASPP_RATES):
    outs = [F.relu(conv(p, x, dilation=r))
            for p, r in zip(params["branches"], rates)]
    gp = x.mean(dim=(1, 2), keepdim=True)
    gp = F.relu(conv(params["pool_proj"], gp))
    gp = gp.expand(outs[0].shape)
    cat = torch.cat(outs + [gp], dim=-1)
    return F.relu(conv(params["proj"], cat))


def deeplabv3_init(generator, in_ch=3, classes=2, width=16, plus=False,
                   device=None):
    p = {"backbone": _backbone_init(generator, in_ch, width, device),
         "aspp": aspp_init(generator, width * 8, width * 4, device=device),
         "head": conv_init(generator, 1, 1, width * 4, classes, device)}
    if plus:
        p["low_proj"] = conv_init(generator, 1, 1, width * 2, width, device)
        p["dec"] = double_conv_init(generator, width * 4 + width, width * 4,
                                    device)
    return p


def deeplabv3_apply(params, x, plus=False):
    feats, low = _backbone_apply(params["backbone"], x)
    y = aspp_apply(params["aspp"], feats)
    if plus:
        y = _upsample(y, 2)
        low = F.relu(conv(params["low_proj"], low))
        y = double_conv(params["dec"], torch.cat([y, low], dim=-1))
        y = conv(params["head"], y)
        return _upsample(y, 2)
    y = conv(params["head"], y)
    return _upsample(y, 4)


# ------------------------------------------------------------- registry
SEG_MODELS = {
    "unet": (unet_init, unet_apply),
    "unetpp": (unetpp_init, unetpp_apply),
    "deeplabv3": (deeplabv3_init,
                  lambda p, x: deeplabv3_apply(p, x, plus=False)),
    "deeplabv3plus": (functools.partial(deeplabv3_init, plus=True),
                      lambda p, x: deeplabv3_apply(p, x, plus=True)),
}


def seg_init(name, generator: torch.Generator, in_ch=3, classes=2,
             width=16, device=None):
    """Random f32 parameters of ``name`` from ``generator``, on ``device``
    (``cuda`` unless given)."""
    return SEG_MODELS[name][0](generator, in_ch=in_ch, classes=classes,
                               width=width, device=resolve_device(device))


def seg_apply(name, params, x):
    return SEG_MODELS[name][1](params, x)


def pixel_xent(logits, masks):
    """Mean cross entropy of (..., classes) logits against integer
    masks."""
    ll = F.log_softmax(logits, dim=-1)
    return -ll.gather(-1, masks.long()[..., None]).mean()


def seg_loss(name, params, images, masks):
    return pixel_xent(seg_apply(name, params, images), masks)


def seg_metrics(logits, masks, positive: int = 1) -> Dict[str, torch.Tensor]:
    """Paper Table IV metrics for the positive (burned/changed) class."""
    pred = logits.argmax(dim=-1)
    tp = ((pred == positive) & (masks == positive)).sum()
    fp = ((pred == positive) & (masks != positive)).sum()
    fn = ((pred != positive) & (masks == positive)).sum()
    prec = tp / torch.clamp(tp + fp, min=1)
    rec = tp / torch.clamp(tp + fn, min=1)
    f1 = 2 * prec * rec / torch.clamp(prec + rec, min=1e-9)
    iou = tp / torch.clamp(tp + fp + fn, min=1)
    acc = (pred == masks).float().mean()
    return {"precision": prec, "recall": rec, "f1": f1, "iou": iou,
            "accuracy": acc}
