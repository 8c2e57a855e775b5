"""The per-batch work on packed rows: the inference forward and the
training op, counterparts of the JAX package's ops/fused_step.py
``fused_infer_q`` and ``make_fused_training_loss``.

The (B, M) fp32 X never exists. A training step touches the packed batch in
three passes, as the JAX op does:

  forward:   xv (K2)           Xp = X @ V
             encoder           qs = softmax(heads(relu(common(rmsnorm(Xp)))))
             loss_dq_dp (K4)   logged epochs only: the BCE sum, with dq and
                               dP (unscaled) kept for the backward
  backward:  dq_dp (K3)        unlogged epochs: dq and dP from the loss
                               cotangent g
             encoder backward  ordinary autograd (the JAX op's jax.vjp)
             dv (K5)           dV = X^T dXp

as two ``torch.autograd.Function``s: :class:`XV` (forward K2, backward K5)
and :class:`PlaneBCE` (the decoder plane's BCE: K4 forward on logged
epochs; on unlogged epochs a zero loss that still carries the graph, and
K3 in the backward). Each kernel wrapper takes its plain PyTorch version on
CPU tensors.

Gradient semantics are the JAX package's ops/loss.py (torch BCE backward,
boundary-inclusive clamp gradient). ``masked=False`` is for batches of
all-real rows: padded packed bits decode to x = 0 and padded P columns are
exactly 0 from init on (models/qp.py init_params), so every padded-column
term is exactly 0 without the mask (the JAX package's
ops/fused_step.py:788-798).
"""
from typing import Dict, Tuple

import torch

from .dq_dp import dq_dp
from .dv import dv
from .xv import xv


def fused_infer_q(encoder, packed: torch.Tensor, no_missing: bool = False
                  ) -> Dict[str, torch.Tensor]:
    """``encoder`` is a models.qp.QPEncoder on ``packed``'s device; returns
    {head key: Q (B, k)}."""
    return encoder.encode_from_xp(xv(packed, encoder.V, no_missing))


class XV(torch.autograd.Function):
    """Xp = X @ V (K2); the backward is dV = X^T dXp (K5)."""

    @staticmethod
    def forward(ctx, V, packed, no_missing):
        ctx.save_for_backward(packed)
        ctx.no_missing = no_missing
        return xv(packed, V, no_missing)

    @staticmethod
    def backward(ctx, dXp):
        (packed,) = ctx.saved_tensors
        return dv(packed, dXp.contiguous(), ctx.no_missing), None, None


class PlaneBCE(torch.autograd.Function):
    """Sum of BCE(clamp(q @ P, 0, 1), x) over the batch plane, weighted by
    col_mask[m] * row_w[b] when ``masked``.

    ``logged``: the forward runs K4 and returns the loss, keeping dq and dP
    (unscaled) for the backward, which scales them by the loss cotangent.
    Otherwise the forward returns 0 and runs no pass (the value is not
    wanted), and the backward runs K3 with the loss cotangent as its g."""

    @staticmethod
    def forward(ctx, q, P, packed, col_mask, row_w, masked, no_missing,
                logged):
        ctx.logged = logged
        if logged:
            dq, dP, loss = dq_dp(packed, q, P, col_mask, row_w, 1.0, masked,
                                 no_missing, with_loss=True)
            ctx.save_for_backward(dq, dP)
            return loss
        ctx.save_for_backward(q, P, packed, col_mask, row_w)
        ctx.masked, ctx.no_missing = masked, no_missing
        return q.new_zeros(())

    @staticmethod
    def backward(ctx, g):
        if ctx.logged:
            dq, dP = ctx.saved_tensors
            dP = dP * g
        else:
            q, P, packed, col_mask, row_w = ctx.saved_tensors
            dq, dP, _ = dq_dp(packed, q, P, col_mask, row_w, g, ctx.masked,
                              ctx.no_missing)
        return dq * g, dP, None, None, None, None, None, None


def fused_training_loss(model, packed: torch.Tensor, col_mask: torch.Tensor,
                        row_w: torch.Tensor, masked: bool, no_missing: bool,
                        logged: bool
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(BCE loss summed over heads, {head: Q}) of a models.qp.QPModel on
    one packed batch (B, W) uint8; ``loss.backward()`` fills the gradients
    of V, the encoder and every P through K3 (or K4's), the encoder's
    autograd and K5. The loss is 0 on unlogged steps (``logged=False``)."""
    Xp = XV.apply(model.V, packed, no_missing)
    qs = model.encode_from_xp(Xp)
    loss = None
    for hk, q in qs.items():
        term = PlaneBCE.apply(q, model.decoders[hk], packed, col_mask, row_w,
                              masked, no_missing, logged)
        loss = term if loss is None else loss + term
    return loss, qs
