"""The per-batch work on packed rows: the inference forward and the
training op, counterparts of the JAX package's ops/fused_step.py
``fused_infer_q``, ``make_fused_training_loss`` and
``make_indexed_training_loss``.

The (B, M) fp32 X never exists. A training step touches the packed batch in
three passes, as the JAX op does (per head for the decoder plane):

  forward:   xv (K2)           Xp = X @ V
             encoder           qs = softmax(heads(relu(common(rmsnorm(Xp)))))
             loss_dq_dp (K4)   logged epochs, merged program: the BCE sum,
                               with dq and dP (unscaled) kept for the
                               backward
             bce_sum (K6)      logged epochs, split program: the BCE sum
  backward:  dq_dp (K3)        unlogged epochs, and logged ones under the
                               split program: dq and dP from the loss
                               cotangent g
             encoder backward  ordinary autograd (the JAX op's jax.vjp)
             dv (K5)           dV = X^T dXp

as two ``torch.autograd.Function``s: :class:`XV` (forward K2, backward K5)
and :class:`PlaneBCE` (the decoder plane's BCE of one head: K4 forward on
logged epochs, or K6 forward and K3 backward under the split program; on
unlogged epochs a zero loss that still carries the graph, and K3 in the
backward). Each kernel wrapper takes its plain PyTorch version on CPU
tensors.

The batch is gathered (its own (B, W) rows) or, with ``blk_idx``, indexed
(K7): the resident rows and the int32 ids of its ``blk``-row blocks, which
every kernel reads in place. That is one op with an optional block index,
as on the card it is one argument of the same kernels; the backward keeps
the resident tensor by reference, never a copy.

On a grid of ranks (parallel/grid.py), ``snp_group`` sums the SNP block's
partial Xp over the data row's snp group right after K2
(parallel/sharded_step.py ``PsumSnp``: the all_reduce forward, and the
all_reduce of the cotangent before K5 backward), as the JAX op's
``snp_axis`` psums (ops/fused_step.py:826-827, :889-892). The kernels see
the local block and do not change.

Gradient semantics are the JAX package's ops/loss.py (torch BCE backward,
boundary-inclusive clamp gradient). ``masked=False`` is for batches of
all-real rows: padded packed bits decode to x = 0 and padded P columns are
exactly 0 from init on (models/qp.py init_params), so every padded-column
term is exactly 0 without the mask (the JAX package's
ops/fused_step.py:788-798).
"""
from typing import Dict, Optional, Tuple

import torch

from .bce_sum import bce_sum
from .dq_dp import dq_dp
from .dv import dv
from .xv import xv


def _psum_snp(Xp: torch.Tensor, snp_group) -> torch.Tensor:
    if snp_group is None:
        return Xp
    from ..parallel.sharded_step import PsumSnp
    return PsumSnp.apply(Xp, snp_group)


def fused_infer_q(encoder, packed: torch.Tensor, no_missing: bool = False,
                  snp_group=None) -> Dict[str, torch.Tensor]:
    """``encoder`` is a models.qp.QPEncoder on ``packed``'s device; returns
    {head key: Q (B, k)}. ``snp_group``: the parallel.grid.Grid whose snp
    group holds the other SNP blocks of these rows (``packed`` and V are
    this rank's block)."""
    return encoder.encode_from_xp(
        _psum_snp(xv(packed, encoder.V, no_missing), snp_group))


class XV(torch.autograd.Function):
    """Xp = X @ V (K2); the backward is dV = X^T dXp (K5)."""

    @staticmethod
    def forward(ctx, V, packed, no_missing, blk_idx, blk):
        ctx.save_for_backward(packed, blk_idx)
        ctx.no_missing, ctx.blk = no_missing, blk
        return xv(packed, V, no_missing, blk_idx, blk)

    @staticmethod
    def backward(ctx, dXp):
        packed, blk_idx = ctx.saved_tensors
        return (dv(packed, dXp.contiguous(), ctx.no_missing, blk_idx,
                   ctx.blk), None, None, None, None)


class PlaneBCE(torch.autograd.Function):
    """Sum of BCE(clamp(q @ P, 0, 1), x) over one head's batch plane,
    weighted by col_mask[m] * row_w[b] when ``masked``.

    ``logged`` and ``merged``: the forward runs K4 and returns the loss,
    keeping dq and dP (unscaled) for the backward, which scales them by the
    loss cotangent. ``logged``, not ``merged`` (the split program): the
    forward runs K6 for the loss, the backward K3 with the loss cotangent as
    its g. Not ``logged``: the forward returns 0 and runs no pass (the value
    is not wanted), and the backward runs K3. At g = 1 the merged and split
    gradients are the same numbers: K3 and K4 share their arithmetic."""

    @staticmethod
    def forward(ctx, q, P, packed, col_mask, row_w, masked, no_missing,
                logged, merged, blk_idx, blk):
        ctx.merged = logged and merged
        args = (packed, q, P, col_mask, row_w)
        if ctx.merged:
            dq, dP, loss = dq_dp(*args, 1.0, masked, no_missing,
                                 with_loss=True, blk_idx=blk_idx, blk=blk)
            ctx.save_for_backward(dq, dP)
            return loss
        ctx.save_for_backward(*args, blk_idx)
        ctx.masked, ctx.no_missing, ctx.blk = masked, no_missing, blk
        if logged:
            return bce_sum(*args, masked, no_missing, blk_idx, blk)
        return q.new_zeros(())

    @staticmethod
    def backward(ctx, g):
        if ctx.merged:
            dq, dP = ctx.saved_tensors
            dP = dP * g
        else:
            packed, q, P, col_mask, row_w, blk_idx = ctx.saved_tensors
            dq, dP, _ = dq_dp(packed, q, P, col_mask, row_w, g, ctx.masked,
                              ctx.no_missing, blk_idx=blk_idx, blk=ctx.blk)
        return (dq * g, dP) + (None,) * 9


def fused_training_loss(model, packed: torch.Tensor, col_mask: torch.Tensor,
                        row_w: torch.Tensor, masked: bool, no_missing: bool,
                        logged: bool, merged: bool = True,
                        blk_idx: Optional[torch.Tensor] = None, blk: int = 1,
                        snp_group=None
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(BCE loss summed over heads in ascending K, {head: Q}) of a
    models.qp.QPModel on one packed batch: ``packed`` (B, W) uint8, or the
    resident rows with ``blk_idx`` (int32, B / blk block ids) for an indexed
    batch. ``loss.backward()`` fills the gradients of V, the encoder and
    every P through K3 (or K4's), the encoder's autograd and K5. The loss is
    0 on unlogged steps (``logged=False``); on logged ones it comes from K4
    (``merged``, the default) or K6 (the split program). ``snp_group``: as
    in :func:`fused_infer_q`; the loss is then this rank's part of the
    plane's BCE (its rows, its SNP block)."""
    Xp = _psum_snp(XV.apply(model.V, packed, no_missing, blk_idx, blk),
                   snp_group)
    qs = model.encode_from_xp(Xp)
    loss = None
    for hk, q in qs.items():
        term = PlaneBCE.apply(q, model.decoders[hk], packed, col_mask, row_w,
                              masked, no_missing, logged, merged, blk_idx,
                              blk)
        loss = term if loss is None else loss + term
    return loss, qs
