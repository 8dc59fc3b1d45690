"""The flash-attention kernels on the ``meta`` device: shapes and counted
work, nothing run.

A meta tensor has a shape and a dtype and no data, so neither the CUDA
kernels nor their plain versions can run on one.  When the dry run traces
a step on ``meta`` (:mod:`repro_torch.launch.dryrun`), the differentiable
op (:mod:`.ops`) calls these operators in place of K1, K2 and K3.  Each
gives its kernel's output shapes and dtypes, and registers with
``torch.utils.flop_counter`` the operations its kernel does on these
inputs, so ``FlopCounterMode`` counts the kernel's work, not the plain
version's:

* K1 (forward): QK^T and PV, 4*hd per admitted (q, k) pair and head;
* K2 (dQ): S = QK^T again, dP = dO V^T and dS K, 6*hd;
* K3 (dK, dV): S, dP, P^T dO and dS^T Q, 8*hd.

The plain whole-row versions compute every (q, k) pair, masked or not;
the kernels skip the tiles the mask leaves empty.  The operators have a
``Meta`` implementation only: a CPU or CUDA tensor that reached one would
raise, and none does (the op sends those to the plain versions and the
kernels, as before).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

# the products per admitted (q, k) pair and head, in units of hd
FWD_PER_PAIR, DQ_PER_PAIR, DKV_PER_PAIR = 4, 6, 8


def valid_pairs(sq: int, sk: int, causal: bool, window: Optional[int],
                q_offset: int = 0) -> int:
    """Number of (q, k) pairs the kernels' mask admits: ``k < Sk``, ``k <=
    q`` when causal, ``k > q - window`` with a window, query row i at ``q =
    q_offset + i`` and key j at ``j``."""
    q = q_offset + np.arange(sq, dtype=np.int64)
    hi = np.minimum(sk - 1, q) if causal else np.full(sq, sk - 1)
    lo = (np.maximum(0, q - window + 1) if window
          else np.zeros(sq, np.int64))
    return int(np.maximum(0, hi - lo + 1).sum())


def pair_flops(per_pair: int, q_shape, k_shape, causal: bool,
               window: Optional[int], q_offset: int = 0) -> int:
    """``per_pair * hd`` operations per admitted pair, head and row."""
    B, Sq, H, hd = q_shape
    return per_pair * hd * B * H * valid_pairs(Sq, k_shape[1], causal,
                                               window, q_offset)


_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("flash_fwd(Tensor q, Tensor k, Tensor v, bool causal, "
            "SymInt? window, int q_offset=0) -> (Tensor, Tensor)")
_LIB.define("flash_bwd_dq(Tensor q, Tensor k, Tensor v, Tensor do, "
            "Tensor lse, Tensor delta, bool causal, SymInt? window, "
            "int q_offset=0) -> Tensor")
_LIB.define("flash_bwd_dkv(Tensor q, Tensor k, Tensor v, Tensor do, "
            "Tensor lse, Tensor delta, bool causal, SymInt? window, "
            "int q_offset=0) -> (Tensor, Tensor)")


def _fwd(q, k, v, causal, window, q_offset=0):
    B, Sq, H, hd = q.shape
    return (q.new_empty((B, Sq, H, hd)),
            q.new_empty((B * H, Sq), dtype=torch.float32))


def _dq(q, k, v, do, lse, delta, causal, window, q_offset=0):
    return q.new_empty(q.shape, dtype=torch.float32)


def _dkv(q, k, v, do, lse, delta, causal, window, q_offset=0):
    return (k.new_empty(k.shape, dtype=torch.float32),
            v.new_empty(v.shape, dtype=torch.float32))


_LIB.impl("flash_fwd", _fwd, "Meta")
_LIB.impl("flash_bwd_dq", _dq, "Meta")
_LIB.impl("flash_bwd_dkv", _dkv, "Meta")


@register_flop_formula(torch.ops.repro_torch.flash_fwd)
def _fwd_flops(q_shape, k_shape, v_shape, causal, window, q_offset=0, *,
               out_shape=None, **kwargs) -> int:
    return pair_flops(FWD_PER_PAIR, q_shape, k_shape, causal, window,
                      q_offset)


@register_flop_formula(torch.ops.repro_torch.flash_bwd_dq)
def _dq_flops(q_shape, k_shape, v_shape, do_shape, lse_shape, delta_shape,
              causal, window, q_offset=0, *, out_shape=None,
              **kwargs) -> int:
    return pair_flops(DQ_PER_PAIR, q_shape, k_shape, causal, window,
                      q_offset)


@register_flop_formula(torch.ops.repro_torch.flash_bwd_dkv)
def _dkv_flops(q_shape, k_shape, v_shape, do_shape, lse_shape, delta_shape,
               causal, window, q_offset=0, *, out_shape=None,
               **kwargs) -> int:
    return pair_flops(DKV_PER_PAIR, q_shape, k_shape, causal, window,
                      q_offset)


def flash_fwd_meta(q, k, v, *, causal: bool, window: Optional[int],
                   q_offset: int = 0):
    """K1's outputs on meta tensors: ``(out (B,Sq,H,hd) in q's dtype, lse
    (B*H, Sq) f32)``."""
    return torch.ops.repro_torch.flash_fwd(q, k, v, causal, window,
                                           q_offset)


def flash_bwd_meta(q, k, v, do, lse, delta, *, causal: bool,
                   window: Optional[int], q_offset: int = 0):
    """K2's and K3's outputs on meta tensors: ``(dq, dk, dv)``, f32."""
    dq = torch.ops.repro_torch.flash_bwd_dq(q, k, v, do, lse, delta, causal,
                                           window, q_offset)
    dk, dv = torch.ops.repro_torch.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                causal, window, q_offset)
    return dq, dk, dv
