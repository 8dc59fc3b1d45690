"""The SSD scan on the ``meta`` device: shapes and counted work, nothing
run.

When the dry run traces a step on ``meta`` (:mod:`repro_torch.launch.
dryrun`), the differentiable scan (:mod:`.ops`) calls these operators in
place of K4 and of its backward.  Each gives the output shapes and dtypes
and registers with ``torch.utils.flop_counter`` the operations done on
these inputs:

* the forward is K4's work (``chip_smoke.py::ssd_bound``'s count): per
  chunk of ``qc`` rows, ``2 qc(qc+1)/2 N`` per group for the causal half
  of C B^T, and per head ``2 qc(qc+1)/2 hp`` (intra-chunk), ``2 qc N hp``
  (inter-chunk) and ``2 qc N hp`` (the state update);
* the backward is what runs on the card too: autograd of the plain
  chunked scan (``ref.ssd_chunked_ref``, the reference's ``_ssd_bwd``),
  which recomputes the forward and differentiates it.  Counted as a
  formula, not a trace (a trace of the plain scan's Python loop over
  chunks takes minutes at full width): the plain forward computes the
  whole (Q, Q) square, ``F = Bs nc (2 g Q^2 N + 2 nh Q^2 hp + 4 nh Q N hp)``
  over ``nc`` chunks of ``Q`` padded rows; each of its products is
  differentiated with respect to both operands (2 F), except the first
  chunk's inter-chunk product, whose carried state starts at zero and
  needs no gradient (``2 Bs nh Q N hp``).  So the backward is
  ``3 F - 2 Bs nh Q N hp``.

The operators have a ``Meta`` implementation only; CPU and CUDA tensors
never reach them.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula


def kernel_flops(x_shape, B_shape, chunk: int) -> int:
    """K4's operations on x (Bs, S, nh, hp) and B (Bs, S, g, N)."""
    Bs, S, nh, hp = x_shape
    g, N = B_shape[2], B_shape[3]
    chunks = [min(chunk, S - c0) for c0 in range(0, S, chunk)]
    return Bs * sum(g * qc * (qc + 1) * N
                    + nh * (qc * (qc + 1) * hp + 4 * qc * N * hp)
                    for qc in chunks)


def plain_flops(x_shape, B_shape, chunk: int) -> int:
    """The plain chunked scan's forward products (S padded to chunks of
    ``Q = min(chunk, S)``, each chunk's whole (Q, Q) square)."""
    Bs, S, nh, hp = x_shape
    g, N = B_shape[2], B_shape[3]
    Q = min(chunk, S)
    nc = -(-S // Q)
    return Bs * nc * (2 * g * Q * Q * N + 2 * nh * Q * Q * hp
                      + 4 * nh * Q * N * hp)


def backward_flops(x_shape, B_shape, chunk: int) -> int:
    """The backward's products: the plain scan recomputed and
    differentiated (see the module docstring)."""
    Bs, S, nh, hp = x_shape
    N = B_shape[3]
    Q = min(chunk, S)
    return 3 * plain_flops(x_shape, B_shape, chunk) - 2 * Bs * nh * Q * N * hp


_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("ssd_scan(Tensor x, Tensor dt, Tensor A, Tensor B, Tensor C, "
            "SymInt chunk) -> (Tensor, Tensor)")
_LIB.define("ssd_scan_bwd(Tensor x, Tensor dt, Tensor A, Tensor B, "
            "Tensor C, Tensor dy, Tensor dh, SymInt chunk) "
            "-> (Tensor, Tensor, Tensor, Tensor, Tensor)")


def _fwd(x, dt, A, B, C, chunk):
    Bs, S, nh, hp = x.shape
    return (x.new_empty(x.shape),
            x.new_empty((Bs, nh, hp, B.shape[3]), dtype=torch.float32))


def _bwd(x, dt, A, B, C, dy, dh, chunk):
    return tuple(t.new_empty(t.shape) for t in (x, dt, A, B, C))


_LIB.impl("ssd_scan", _fwd, "Meta")
_LIB.impl("ssd_scan_bwd", _bwd, "Meta")


@register_flop_formula(torch.ops.repro_torch.ssd_scan)
def _fwd_flops(x_shape, dt_shape, A_shape, B_shape, C_shape, chunk, *args,
               out_shape=None, **kwargs) -> int:
    return kernel_flops(x_shape, B_shape, chunk)


@register_flop_formula(torch.ops.repro_torch.ssd_scan_bwd)
def _bwd_flops(x_shape, dt_shape, A_shape, B_shape, *args, out_shape=None,
               **kwargs) -> int:
    return backward_flops(x_shape, B_shape, args[-1])


def ssd_scan_meta(x, dt, A, B, C, chunk: int):
    """K4's outputs on meta tensors: ``(y in x's dtype, h_final (Bs, nh,
    hp, N) f32)``."""
    return torch.ops.repro_torch.ssd_scan(x, dt, A, B, C, chunk)


def ssd_scan_bwd_meta(x, dt, A, B, C, dy, dh, chunk: int):
    """The backward's gradients on meta tensors, one per input."""
    return torch.ops.repro_torch.ssd_scan_bwd(x, dt, A, B, C, dy, dh, chunk)
