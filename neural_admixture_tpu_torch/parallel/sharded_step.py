"""The training step and the Q pass on a (data, snp) grid of ranks: the
JAX package's parallel/sharded_step.py (its XLA path's geometry), with the
port's kernels on each rank's block.

Per rank (d, s) of a D x S grid (parallel/grid.py):

    xb_loc  (B/D, W/S)   its data row's slice of the batch, its SNP block
    V_loc   (m/S, D)     rows of V
    P_k_loc (k, m/S)     columns of each P
    encoder              RMSNorm, common MLP, heads: replicated

  forward:   Xp = PsumSnp(xv(xb_loc, V_loc))    one (B/D, D) all_reduce
                                                over the snp group
             Q  = encoder(Xp)                   the same on the S ranks
             loss_loc = BCE(Q P_loc, X_loc)     K3/K4/K6 on the local plane
                        [+ w CE / S]            CE counted once per row
  backward:  of loss_loc alone: differentiating the summed loss would scale
             every gradient by the number of ranks; PsumSnp's backward
             all_reduces dXp over the snp group before K5;
  then:      the V and P gradients summed over the data group, the
             encoder's over the world, the loss (logged steps) over the
             world; Adam and the P clamp run on each rank's slice.

The step's ``na.forward`` span (utils/trace.py) holds the forward, its
``na.backward`` the backward and the sums after it.
"""
from typing import Dict, List, Optional

import numpy as np
import torch

from ..io.stage import HostStager
from ..ops.fused_step import fused_infer_q, fused_training_loss
from ..ops.loss import softmax_cross_entropy_sum
from ..train.chunked import chunked_forward
from ..utils.trace import span
from .distributed import gather_ragged_rows
from .grid import DATA_AXIS, SNP_AXIS, Grid


class PsumSnp(torch.autograd.Function):
    """Sum over the snp group, with the transpose that is right for a sum of
    per-rank losses: every rank's loss consumes the summed Xp, so the true
    cotangent of a rank's partial is the sum of the snp group's cotangents,
    not its own (which plain autograd through an all_reduce would give). The
    JAX package's ``_psum_snp`` custom VJP."""

    @staticmethod
    def forward(ctx, x, grid: Grid):
        ctx.grid = grid
        return grid.psum_(x.clone(), SNP_AXIS, "xp_snp")

    @staticmethod
    def backward(ctx, g):
        return ctx.grid.psum_(g.contiguous().clone(), SNP_AXIS,
                              "dxp_snp"), None


def _psum_flat(grads: List[torch.Tensor], grid: Grid, axes, label: str
               ) -> None:
    """Sum ``grads`` in place over ``axes`` in one collective."""
    flat = grid.psum_(torch.cat([g.reshape(-1) for g in grads]), axes, label)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def reduce_grads(model, grid: Grid) -> None:
    """Accumulate the gradients across the ranks that share each parameter:
    V rows and P columns over the data group (the cross-snp coupling of dV
    came through PsumSnp), the encoder over the world."""
    plane = [model.V] + list(model.decoders.values())
    ids = {id(p) for p in plane}
    _psum_flat([p.grad for p in plane], grid, DATA_AXIS, "grad_data")
    _psum_flat([p.grad for p in model.parameters() if id(p) not in ids],
               grid, (DATA_AXIS, SNP_AXIS), "grad_world")


def make_sharded_loss_and_grad(grid: Grid, supervised: bool,
                               supervised_loss_weight: float = 0.0):
    """(model, xb, row_w, col_mask, pops_b, masked, no_missing, logged,
    merged) -> loss, filling ``.grad`` of every parameter of this rank's
    models.qp.QPModel slice with the grid-wide gradient.

    ``xb`` (B/D, W/S) packed rows, ``row_w`` and ``pops_b`` (B/D,) and
    ``col_mask`` (m/S,) are this rank's blocks. The loss is the world's sum
    on ``logged`` steps, and this rank's part otherwise (never logged).
    ``masked``, ``no_missing``, ``logged``, ``merged``: as in
    ops/fused_step.py fused_training_loss."""
    n_snp = grid.n_snp

    def loss_and_grad(model, xb, row_w, col_mask, pops_b, masked: bool,
                      no_missing: bool, logged: bool, merged: bool = True):
        with span("forward"):
            loss, qs = fused_training_loss(model, xb, col_mask, row_w,
                                           masked, no_missing, logged,
                                           merged, snp_group=grid)
            if supervised:
                # Q is the same on the snp group's ranks; divide so that the
                # sum over the grid counts each row's CE once.
                from ..train.engine import smallest_head
                loss = loss + supervised_loss_weight * \
                    softmax_cross_entropy_sum(qs[smallest_head(qs)], pops_b,
                                              row_w) / n_snp
        with span("backward"):
            loss.backward()
            reduce_grads(model, grid)
            loss = loss.detach()
            if logged:
                loss = grid.psum_(loss.clone(), (DATA_AXIS, SNP_AXIS),
                                  "loss")
        return loss

    return loss_and_grad


def infer_q_sharded(encoder, grid: Grid, packed, n_rows: int,
                    batch: int = 1024, no_missing: bool = False,
                    stager: Optional[HostStager] = None
                    ) -> Dict[str, np.ndarray]:
    """The encoder pass over this data row's first ``n_rows`` rows of
    ``packed`` (its SNP block: a tensor on the rank's device, or a host
    array whose chunks go through ``stager``, by default one of the rank's
    thread share made here) in chunks of at most ``batch`` rows: xv on the
    block, the sum over the snp group, the encoder. A chunk holds the same
    bytes either way. Returns {head: Q} of every data row's rows
    concatenated in data-row order, on every rank."""
    qs: Dict[str, np.ndarray] = {}
    if n_rows:
        chunk = min(n_rows, batch)
        own = None
        if isinstance(packed, np.ndarray) and stager is None:
            stager = own = HostStager(grid.device, chunk, packed.shape[1],
                                      gather_threads=grid.gather_threads)
        try:
            with torch.no_grad():
                qs = chunked_forward(
                    lambda b: fused_infer_q(encoder, b, no_missing,
                                            snp_group=grid),
                    packed, n_rows, chunk, grid.device, stager=stager)
        finally:
            if own is not None:
                own.close()
    else:
        qs = {f"k{k}": np.zeros((0, k), np.float32) for k in encoder.ks}
    return {hk: gather_ragged_rows(q, grid) for hk, q in qs.items()}
