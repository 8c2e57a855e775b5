"""The training losses with torch's own BCE, clamp and CE numerics.

``clamped_bce_sum`` is the reference's decoder-output clamp plus summed BCE
(torch.nn.BCELoss(reduction='sum') of clamp(Q @ P, 0, 1) against x =
genotype/2) as one op, the counterpart of the JAX package's ops/loss.py
``clamped_bce_sum``:
  * each log term is clamped at -100 (torch's BCE forward);
  * the backward is (rec - x) / max(rec (1 - rec), 1e-12) (torch's BCE
    backward);
  * the [0, 1] clamp passes the gradient on its boundary (inclusive), as
    torch.clamp's backward does; outside it the gradient is 0.
The column mask (SNP padding) and row weights (batch padding) weight both
value and gradient. Only the reconstruction is differentiable: x and the
masks get zero cotangents (they are data, never parameters).

``softmax_cross_entropy_sum`` is the supervised term, the counterpart of the
JAX package's ops/loss.py ``softmax_cross_entropy_sum``.
"""
import torch

from .fused import GRAD_EPS, bce_elem


class _ClampedBCESum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, raw_rec, x, col_mask, row_weight):
        ctx.save_for_backward(raw_rec, x, col_mask, row_weight)
        rec = torch.clamp(raw_rec, 0.0, 1.0)
        elem = bce_elem(rec, x) * col_mask[None, :] * row_weight[:, None]
        return elem.sum()

    @staticmethod
    def backward(ctx, g):
        raw_rec, x, col_mask, row_weight = ctx.saved_tensors
        rec = torch.clamp(raw_rec, 0.0, 1.0)
        drec = (rec - x) / torch.clamp_min(rec * (1.0 - rec), GRAD_EPS)
        inside = (raw_rec >= 0.0) & (raw_rec <= 1.0)
        draw = torch.where(inside, drec, torch.zeros_like(drec))
        draw = draw * col_mask[None, :] * row_weight[:, None] * g
        zeros = [torch.zeros_like(t) if need else None
                 for t, need in zip((x, col_mask, row_weight),
                                    ctx.needs_input_grad[1:])]
        return (draw, *zeros)


def clamped_bce_sum(raw_rec: torch.Tensor, x: torch.Tensor,
                    col_mask: torch.Tensor,
                    row_weight: torch.Tensor) -> torch.Tensor:
    """Sum over (B, M) of BCE(clamp(raw_rec, 0, 1), x) * col_mask[m] *
    row_weight[b].

    raw_rec: (B, M) pre-clamp reconstruction Q @ P; x: (B, M) targets in
    [0, 1]; col_mask: (M,) 1 for real SNP columns, 0 for padding;
    row_weight: (B,) 1 for real samples, 0 for padded batch rows."""
    return _ClampedBCESum.apply(raw_rec, x, col_mask, row_weight)


def softmax_cross_entropy_sum(logits: torch.Tensor, labels: torch.Tensor,
                              row_weight: torch.Tensor) -> torch.Tensor:
    """torch.nn.CrossEntropyLoss(reduction='sum') of ``logits`` (B, k)
    against ``labels`` (B,) int, each row weighted by ``row_weight``.

    The reference feeds the *softmaxed* Q into CrossEntropyLoss as if it
    were logits (its model/neural_admixture.py:472-473); callers reproduce
    that by passing probabilities here."""
    logz = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels[:, None].to(torch.int64))[:, 0]
    return torch.sum((logz - picked) * row_weight)
