"""Smoke run of the PyTorch/CUDA port on one CUDA card: ``python3 chip_smoke.py``.

Builds every kernel of the port from ``neural_admixture_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card, drives the main
paths (projective inference: ``infer_q`` and the ``infer`` CLI; training:
``launch_training`` and the ``train`` CLI) at full width, times them, and
checks their output. Phases, in order; any failure ends the run with a
non-zero exit and no result line:

  1. environment: a CUDA card is required; prints its name and power limit;
  2. build: compiles the kernels (nvcc, one process per source, in
     parallel), prints build seconds and each instance's ptxas registers
     and spills;
  2b. tsan: the native host decoder (native/bed_decode.cpp) under
     ThreadSanitizer on the card's host, as ``python -m
     neural_admixture_tpu_torch.native.tsan`` runs it (g++ -fsanitize=thread,
     native/tsan_test.cpp): its canary race reported, every threaded entry
     point on two or more threads, results checked, no report; its seconds;
  3. kernel vs plain: xv, dq_dp, loss_dq_dp, dv and bce_sum against their
     plain versions at small ragged shapes that together reach every
     template instance of csrc/*.cu (XV_CASES, DQ_DP_CASES, DV_CASES,
     BCE_SUM_CASES, INDEXED_CASES; K5 past one launch at D > 8 with its
     16-byte loads on and off, also on rows 4 bytes past an aligned
     address; bce_sum's term alone against float64 on 2^24 (r, code)
     pairs, and bce_sum also on adversarial
     planes: r in [1e-9, 1e-3] at x = 0, r exactly 0 and 1 at every code,
     r within 2^-20 of 1 at code 2, and loss_dq_dp on the same planes;
     xv also on a V with a 1000-fold
     spike in every 512-SNP chunk, dv on a dXp with a 1000-fold spike in
     every 256-row chunk on a row of mostly 0 codes, and on a batch that
     takes two launches by rows); the indexed form of each (K7:
     a block index into resident rows) against the plain version and bit
     for bit against the same kernel on the gathered batch; dq_dp at g = 1
     bit for bit against loss_dq_dp;
  4. full width: infer_q at N=4096, M=1,000,000, K=8, H=1024, D=8, batch 1024
     (seeded random rows and weights), its batches staged through the
     pinned ring (io/stage.py); counts the kernel launches, times the
     kernel, its plain version and each part of a batch; the parent's
     pageable path and a path that registers the host rows with the CUDA
     runtime instead, timed beside it, each with a Q bit-equal to its;
  4b. readers (host clock, phase 4's rows): the native host library built
     with g++ (native/build.py); phase 4's rows, flipped, written as a BED,
     a PGEN of mode 0x01 (the same bytes), 0x02 and 0x10 of storage 8 at
     full width, each read back by the port's packed reader (storage 8
     natively and, over its first 65,536 variants, through the pure
     decoder; the BED natively, and against its NumPy twin on a BED of the
     first 131,072 variants) byte-equal to phase 4's rows, and infer_q on
     the storage-8 read's rows with phase 4's Q bit for bit; compressed
     0x10 and 0x11 PGENs of N=4096 and 2,048 variants of every record type
     (the port's writer) through the native and the pure decoder, and a
     VCF of N=4096 and 2,000 of phase 4's variants; the native call
     counters must move; seconds and GB/s of input of each read;
  5. CLI: a seeded K=7 checkpoint, then ``infer`` on the demo BED on the card
     and on the CPU, compared;
  6. full width: training on phase 4's rows (RSVD, PCA, GMM, P init, two
     epochs of batch 800 with sample_block 16, the Q pass and the
     log-likelihood); the step-0 loss against plain autograd, every
     training kernel against its plain version at batch 800 and timed, the
     launch counts, Q, P and the padded P columns checked;
  6b. full width, multi-head: K = 2..10 (9 heads) on phase 4's rows with
     phase 6's V, three 2-epoch runs from the same start: the default
     program, NA_TPU_INDEXED=1 and NA_TPU_INDEXED=1 NA_TPU_SPLIT_LOSS=1;
     exact launch counts of each, the runs held to each other, the indexed
     forms, bce_sum and the gather they replace timed at batch 800, and
     dq_dp and loss_dq_dp per head;
  6c. full width, host streaming and checkpoints (K = 8, phase 6's rows,
     V, P init and resident run): 2-epoch streamed runs bit-equal to the
     resident ones on the default and the split program (exact launch
     counts), a step's host gather, copy and compute, streamed and resident
     samples/s; 2 epochs with a checkpoint every epoch resumed (streamed)
     to 3, bit-equal to 3 uninterrupted epochs, with the save and load
     seconds; the streamed RSVD and PCA projection bit-equal to phase 6's;
  6d. full width, grids of ranks (K = 8, phase 4's rows, phase 6's V and P
     init, 2 epochs): 2 x 1 and 2 x 2 grids of ranks on the one card over
     gloo (parallel/distributed.py spawn_grid), each held to the one-rank
     run emulating their layout (NA_TPU_EMULATE_PROC_SHARDS=2,2) by the
     trajectory rule, exact launch counts on every rank, the sharded
     infer_q (2 x 2) against phase 4's Q, the rows= RSVD (2 x 1) against
     phase 6's V; a one-rank NCCL grid against phase 6's run; a 2 x 1
     grid over NCCL across two cards where the machine has two; each
     rank's warm step split into compute (CUDA events) and each
     collective (host clock, bytes);
  6e. full width, streaming and checkpoints on a grid (phase 6d's data and
     init): a 2 x 2 grid of gloo ranks on the one card runs (a) resident
     under NA_TPU_STRATIFIED=1 with a checkpoint every epoch, (b) streamed
     by the auto policy (NA_TPU_HBM_CAPACITY_GB between a rank's streamed
     and resident estimates) and (c) streamed, resumed from (a)'s epoch-1
     file; (b) and (c) bit-equal to (a) on every rank, exact launches per
     rank, no exchange collective; the file's size, format and mesh shape,
     its save and load seconds; each rank's warm step (compute between
     collectives, each collective), host gather rate, the pinned copy of a
     step's slice and samples/s streamed beside resident; the staged grid
     infer_q bit-equal to the block uploaded whole and to 6d's;
  6f. full width, cross-validation, restarts and a traced run (K = 8,
     phase 4's rows, 2 epochs): run_cross_validation over 3 folds, each
     fold's seconds (RSVD, init, training, projection, LL), its cv_error
     against the card's log-likelihood of the same Q and P (rtol 1e-5) and
     its exact launches; fit_restarts with R = 2 on one PCA projection,
     restart 0 equal to phase 6's run and the kept restart bit for bit its
     run rebuilt by hand; phase 6's run under ``profile_dir``, bit-equal to
     it, the trace's K2-K5 counts equal to the launch counters, each
     epoch's time traced against untraced and the device's busy share over
     each epoch span;
  7. CLI: ``train`` on the demo BED on the card and on the CPU (K = 7, a
     K range 2..4, and supervised with the argmax labels of the reference's
     K = 7 Q, which name 5 populations): the output files, the .npz through
     ``infer``, the demo's golden measures, and the two runs held to each
     other by the trajectory rule; on the card ``--stream 1`` writes the
     resident run's .Q and .P byte for byte, a ``--checkpoint_every``
     run sent SIGTERM exits 143 and its ``--resume`` finishes, and the
     demo's dosages written as a mode-0x10 PGEN and a VCF train to the BED
     run's .Q and .P byte for byte (logging "Input format is PGEN." /
     "VCF.") and ``infer`` on them writes the BED's .Q; ``train --num_gpus
     2`` on one card logs the clamp and writes the ``--num_gpus 1`` run's
     .Q byte for byte; a grid of two CPU ranks (``--num_gpus 0 --mesh
     2x1``; a grid on cards needs a card a rank) with ``--stream 1``
     writes the .Q and .P of the resident grid under NA_TPU_STRATIFIED=1
     byte for byte, and one with ``--checkpoint_every 2`` sent SIGTERM
     exits 143, then its ``--resume`` exits 0; on the card ``--cv 3
     --min_k 2 --max_k 4 --profile_dir`` writes the csv, four traces and the
     .Q and .P of the run without them byte for byte, ``--k 7
     --init_restarts 3`` keeps a log-likelihood no lower than the one run's,
     and on two CPU ranks ``--mesh 2x1 --init_restarts 2`` exits 0;
  A/B (only with ``--ab DIR``): the kernels of DIR, a copy of another
     commit's csrc/ with the same C interfaces (the parent's), built into
     DIR/build while the phases run, timed against the checkout's in the
     order parent, change, change, parent: K2 (B = 800 and 1024), K5
     gathered and indexed at B = 800 and at the remainder B = 96, K3, K4
     and K6 per head of K = 2..10 (K3 and K4 also at B = 4096), a warm
     unlogged and a warm logged training step at K = 8 and K = 2..10, a
     warm logged step of the split program at K = 2..10, and infer_q
     (ab.json, beside the ptxas logs); each instance's ptxas line of DIR's
     build against the checkout's, and the SASS instructions an element of
     the main loop of the cells' K3 and K4 instances in both;
  8. the run's seconds, the card's name and power limit, one JSON line with
     every kernel's numbers (those of the phases run; launches: phases 6,
     6b, 6c's streamed runs, 6d's and 6e's ranks and 6f, summed, with 6d's
     and 6e's per rank in ``grid_launches_per_rank``);
  9. the last line: {"ok": true, "device": {...}}.

``--phases env,build,kernels`` runs only those phases (a short check of a
kernel change); the default is every phase.

Imports nothing of JAX or of the JAX package.
"""
import contextlib
import ctypes
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from neural_admixture_tpu_torch import _build  # noqa: E402
from neural_admixture_tpu_torch.infer import infer_q  # noqa: E402
from neural_admixture_tpu_torch.io.packed import (  # noqa: E402
    pack_2bit_rows, unpack_2bit_rows)
from neural_admixture_tpu_torch.io.stage import (  # noqa: E402
    HostStager, gather_rows)
from neural_admixture_tpu_torch.io.writers import (  # noqa: E402
    save_checkpoint, save_config)
from neural_admixture_tpu_torch.models import qp  # noqa: E402
from neural_admixture_tpu_torch.models.qp import params_from_numpy  # noqa: E402
from neural_admixture_tpu_torch.ops.bce_sum import (  # noqa: E402
    bce_sum, bce_sum_plain)
from neural_admixture_tpu_torch.ops.dq_dp import dq_dp, dq_dp_plain  # noqa: E402
from neural_admixture_tpu_torch.ops import dv as dv_ops  # noqa: E402
from neural_admixture_tpu_torch.ops.dv import dv, dv_plain  # noqa: E402
from neural_admixture_tpu_torch.ops.fused import (  # noqa: E402
    bce_elem, draw_tile, unpack_dosage)
from neural_admixture_tpu_torch.ops.fused_step import (  # noqa: E402
    fused_training_loss)
from neural_admixture_tpu_torch.ops.loglikelihood import (  # noqa: E402
    loglikelihood_packed)
from neural_admixture_tpu_torch.ops.loss import clamped_bce_sum  # noqa: E402
from neural_admixture_tpu_torch.ops.pack import (  # noqa: E402
    batch_rows, gather_batch, packed_has_missing)
from neural_admixture_tpu_torch.ops.rsvd import rsvd  # noqa: E402
from neural_admixture_tpu_torch.ops.xv import xv, xv_plain  # noqa: E402
from neural_admixture_tpu_torch.train.engine import (  # noqa: E402
    CKPT_FORMAT, NeuralAdmixtureTrainer, TrainConfig, block_geometry,
    epoch_plan)
from neural_admixture_tpu_torch.train.init import (  # noqa: E402
    init_p_unsupervised, project_pca)
from neural_admixture_tpu_torch.utils.seeding import generator  # noqa: E402

SEED = 0
# H100 SXM data sheet: the HBM3 rate, and the peak rate of each type of
# operation: fp32 on the CUDA cores, TF32 and int8 on the tensor cores
# (dense).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"fp32": 67e12, "tf32": 495e12, "int8": 1979e12}
# Full width: bench.py's M, N, K and the CLI defaults for D, H and batch.
N_FULL, M_FULL, K_FULL, D_FULL, H_FULL, BATCH = 4096, 1_000_000, 8, 8, 1024, 1024
# Training at full width: the train CLI's batch and sample_block defaults
# (bench.py:22-31); two epochs, the first logged (K4) and the second not (K3).
TRAIN_BATCH, BLOCK, TRAIN_EPOCHS = 800, 16, 2
# Multi-head at full width: the K sweep of the reference's default range and
# of bench.py:333-369, one head per K.
KS_SWEEP = list(range(2, 11))
PROGRAMS = {"default": {}, "indexed": {"NA_TPU_INDEXED": "1"},
            "indexed+split": {"NA_TPU_INDEXED": "1",
                              "NA_TPU_SPLIT_LOSS": "1"}}
PROGRAM_VARS = ("NA_TPU_INDEXED", "NA_TPU_SPLIT_LOSS", "NA_TPU_FORCE_MASKED")
# The programs phase 6c streams at K = 8 (gathered: streamed batches are
# never indexed).
PROGRAMS_K8 = {"default": {}, "split": {"NA_TPU_SPLIT_LOSS": "1"}}
FSP = "neural_admixture_tpu/ops/fused_step.py"
LANE = 2048
DEMO_BED = os.path.join(REPO, "demo", "data", "demo_data.bed")
DEMO_Q_EXPECTED = os.path.join(REPO, "demo", "expected",
                               "demo_run.7.Q.expected")
DEMO_P_EXPECTED = os.path.join(REPO, "demo", "expected",
                               "demo_run.7.P.expected")
GOLDEN_LL = -326_814  # tests/test_train_demo.py:77-86


def phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def done(t0):
    print(f"   ({time.perf_counter() - t0:.1f} s)", flush=True)


def cuda_ms(fn, reps):
    """Mean device time of ``fn()`` over ``reps`` calls, after one warm-up."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_params(rng, m, m_pad, D, H, ks):
    """Seeded weights in the JAX package's layout: V (m_pad, D) with zero
    padding rows, torch.nn.Linear's uniform(+-1/sqrt(fan_in)) for the
    linears, RMSNorm scale 1."""
    V = np.zeros((m_pad, D), np.float32)
    V[:m] = rng.normal(size=(m, D)) / np.sqrt(m)

    def linear(fan_in, fan_out):
        b = 1.0 / np.sqrt(fan_in)
        return {"kernel": rng.uniform(-b, b, (fan_in, fan_out)).astype(np.float32),
                "bias": rng.uniform(-b, b, fan_out).astype(np.float32)}

    return {"V": V, "rmsnorm": {"weight": np.ones(D, np.float32)},
            "common": linear(D, H),
            "heads": {f"k{k}": linear(H, k) for k in sorted(ks)}}


def random_packed(rng, n, m, m_pad, missing=True):
    """(n, m_pad/4) packed rows of uniform codes over {0,1,2} (and 3 when
    ``missing``), padding columns zero."""
    if missing:
        packed = rng.integers(0, 256, size=(n, m_pad // 4), dtype=np.uint8)
    else:
        # bytes whose four fields avoid code 3
        ok = np.array([b for b in range(256)
                       if all((b >> s) & 3 != 3 for s in (0, 2, 4, 6))],
                      np.uint8)
        packed = ok[rng.integers(0, ok.size, size=(n, m_pad // 4))]
    if m % 4:
        packed[:, m // 4] &= np.uint8((1 << (2 * (m % 4))) - 1)
    packed[:, -(-m // 4):] = 0
    return packed


def spike_v(rng, m, D):
    """V (m, D) fp32 that the fixed point of the xv kernel finds hard: in
    column 0 a single entry of every 512-SNP chunk is 1000 times the rest
    (each chunk's scale is set by the spike)."""
    V = rng.uniform(-1.0, 1.0, size=(m, D)).astype(np.float32)
    for c0 in range(0, m, 512):
        V[c0 + rng.integers(0, min(512, m - c0)), 0] = 1000.0 * rng.choice(
            [-1.0, 1.0])
    return V


def spike_dv_case(rng, B, m, D, missing, chunk=256):
    """Packed rows (B, m/4) and dXp (B, D) that the fixed point of the dv
    kernel finds hard: in column 0 of dXp one row of every ``chunk`` rows
    (the kernel's scale chunk, csrc/dv.cu kChunkRows) is 1000 times the
    rest, and that row's codes are 0 at 95% of the SNPs, so that most
    outputs sum only the small rows, which the chunk's scale cuts
    coarsest."""
    packed = random_packed(rng, B, m, m, missing)
    dXp = rng.normal(size=(B, D)).astype(np.float32)
    dXp[:, 0] = rng.uniform(-1.0, 1.0, size=B)
    for c0 in range(0, B, chunk):
        r = c0 + rng.integers(0, min(chunk, B - c0))
        dXp[r, 0] = 1000.0 * rng.choice([-1.0, 1.0])
        codes = np.where(rng.uniform(size=m) < 0.05, 2, 0).reshape(-1, 4)
        packed[r] = (codes << (2 * np.arange(4))).sum(1).astype(np.uint8)
    return packed, dXp


def check_xv(packed, V, no_missing, **ix):
    """Kernel vs plain on the card. Tolerance: fp32 sums in another order,
    |d| <= 1e-5 * sum_m |x||V| + 1e-6 per element. ``ix``: the block index
    of an indexed batch (blk_idx, blk), given to both."""
    got = xv(packed, V, no_missing, **ix)
    torch.cuda.synchronize()
    want = xv_plain(packed, V, **ix)
    scale = xv_plain(packed, V.abs(), **ix)
    err = (got - want).abs()
    bound = 1e-5 * scale + 1e-6
    if not bool((err <= bound).all()):
        raise AssertionError(
            f"xv disagrees with xv_plain: max |d| {err.max().item():.3e}, "
            f"worst |d|/bound {(err / bound).max().item():.3f}")
    return err.max().item(), (err / (scale + 1e-30)).max().item()


# Inputs of the dq_dp checks are multiples of 2^-10. Every partial sum of
# raw = q @ P is then exact in fp32 (|q_j P_j| summed stays below 2, at most
# 21 significant bits), so the kernel and its plain version see the same raw
# whatever their summation order, and the comparison measures only the order
# of the dq, dP and loss sums. With arbitrary fp32 inputs, a raw within
# rounding of the clamp edge 0 or 1 flips draw between 0 and
# (rec - x) / (rec (1 - rec)), which is as large as 1e12: no per-element
# tolerance covers that, and training never meets it (q >= 0 and P in
# [0, 1] there, so raw has no cancellation).
DYADIC = 1024.0


def _q_rows(rng, B, k):
    """Dirichlet rows on the 2^-10 grid, each summing exactly to 1; every
    fifth row one-hot."""
    q = np.floor(rng.dirichlet(np.ones(k), size=B) * DYADIC) / DYADIC
    q[:, -1] = 1.0 - q[:, :-1].sum(axis=1)
    for b in range(0, B, 5):
        q[b] = 0.0
        q[b, (b // 5) % k] = 1.0
    return q.astype(np.float32)


def _relative_p(rng, k, m):
    """P (k, m) on the 2^-10 grid from U(-0.1, 1.1), so that raw = q @ P
    leaves [0, 1]; column 0 all zeros (raw exactly 0) and column 1 all ones
    (raw exactly 1, as q's rows sum to 1), and 0 and 1 exactly at random
    places besides."""
    P = np.round(rng.uniform(-0.1, 1.1, size=(k, m)) * DYADIC) / DYADIC
    P[:, 0] = 0.0
    P[:, 1] = 1.0
    return P.astype(np.float32)


def _dq_dp_scales(packed, q, P, col_mask, row_w, g, masked, **ix):
    """The plain version's sums over absolute values: sum_m |draw||P| for
    dq, sum_b |g q||draw| for dP, sum |elem| for the loss."""
    x = unpack_dosage(gather_batch(packed, ix.get("blk_idx"),
                                   ix.get("blk", 1)))
    mask_rw = (col_mask[None, :] * row_w[:, None]) if masked else None
    draw, elem = draw_tile(q, P, x, mask_rw, with_loss=True)
    return (draw.abs() @ P.abs().T, (q * g).abs().T @ draw.abs(),
            elem.abs().sum())


def check_dq_dp(packed, q, P, col_mask, row_w, g, masked, no_missing,
                with_loss, **ix):
    """Kernel vs plain on the card. Tolerance: fp32 sums in another order,
    |d| <= 1e-5 * (the same sum over absolute values) + 1e-6 per element of
    dq, dP and the loss. Returns the largest |d|."""
    got = dq_dp(packed, q, P, col_mask, row_w, g, masked, no_missing,
                with_loss, **ix)
    torch.cuda.synchronize()
    want = dq_dp_plain(packed, q, P, col_mask, row_w, g, masked, with_loss,
                       **ix)
    scales = _dq_dp_scales(packed, q, P, col_mask, row_w, g, masked, **ix)
    worst = 0.0
    for name, a, b, sc in zip(("dq", "dP", "loss"), got, want, scales):
        if not with_loss and name == "loss":
            continue
        err = (a - b).abs()
        bound = 1e-5 * sc + 1e-6
        if not bool((err <= bound).all()):
            raise AssertionError(
                f"dq_dp ({name}) disagrees with dq_dp_plain: max |d| "
                f"{err.max().item():.3e}, worst |d|/bound "
                f"{(err / bound).max().item():.3f}")
        worst = max(worst, err.max().item())
    return worst


def check_dv(packed, dXp, no_missing, **ix):
    """Kernel vs plain on the card: |d| <= 1e-5 * sum_b |x||dXp| + 1e-6.
    Returns max |d| and max |d| / sum_b |x||dXp|."""
    got = dv(packed, dXp, no_missing, **ix)
    torch.cuda.synchronize()
    want = dv_plain(packed, dXp, **ix)
    scale = dv_plain(packed, dXp.abs(), **ix)
    err = (got - want).abs()
    bound = 1e-5 * scale + 1e-6
    if not bool((err <= bound).all()):
        raise AssertionError(
            f"dv disagrees with dv_plain: max |d| {err.max().item():.3e}, "
            f"worst |d|/bound {(err / bound).max().item():.3f}")
    return err.max().item(), (err / (scale + 1e-30)).max().item()


def check_bce_sum(packed, q, P, col_mask, row_w, masked, no_missing, **ix):
    """Kernel vs plain on the card: |d| <= 1e-5 * sum |elem| + 1e-6 (fp32
    sums in another order). Returns |d|."""
    got = bce_sum(packed, q, P, col_mask, row_w, masked, no_missing, **ix)
    torch.cuda.synchronize()
    want = bce_sum_plain(packed, q, P, col_mask, row_w, masked, **ix)
    scale = _dq_dp_scales(packed, q, P, col_mask, row_w, 1.0, masked,
                          **ix)[2]
    err = (got - want).abs().item()
    if not err <= 1e-5 * scale.item() + 1e-6:
        raise AssertionError(f"bce_sum disagrees with bce_sum_plain: |d| "
                             f"{err:.3e} on {want.item():.6e}")
    return err


BCE_PLANES = ("random", "small_r", "edges", "near_one")


def bce_plane(rng, kind, B, M, k, missing):
    """(G (B, M) uint8 codes, q (B, k), P (k, M)) of an adversarial decoder
    plane for bce_sum, fp32 (a copy of tests/test_torch_port_bce_sum.py's
    bce_plane, which the card's machine cannot import):

    * small_r: x = 0 everywhere (codes 0, or 0 and 3), P = 10^U(-9, -3), so
      r = q P in [1e-9, 1e-3], where log(1 - r) in fp32 would lose the loss
      and only log1p keeps it;
    * edges: q on the 2^-10 grid with rows summing to 1; P columns by turns
      all 0 (r = 0, as the padded columns), all 1 (r = 1 exactly) and on
      the grid in (-0.1, 1.1) (raw outside [0, 1] clamps), every code;
    * near_one: one-hot q rows, P = 1 - u 2^-24 for u in 1..16, so that
      r = P exactly within 2^-20 of 1, code 2 (with ``missing``, a quarter
      code 3).
    """
    q = rng.dirichlet(np.ones(k), size=B)
    if kind == "small_r":
        G = 3 * (rng.uniform(size=(B, M)) < 0.25) if missing else \
            np.zeros((B, M))
        P = 10.0 ** rng.uniform(-9, -3, size=(k, M))
    elif kind == "edges":
        G = rng.integers(0, 4 if missing else 3, size=(B, M))
        q = np.floor(q * 1024.0) / 1024.0
        q[:, -1] = 1.0 - q[:, :-1].sum(axis=1)
        P = np.round(rng.uniform(-0.1, 1.1, size=(k, M)) * 1024) / 1024
        P[:, 0::3], P[:, 1::3] = 0.0, 1.0
    else:
        G = np.where(rng.uniform(size=(B, M)) < (0.25 if missing else 0.0),
                     3, 2)
        q = np.eye(k)[np.arange(B) % k]
        P = 1.0 - rng.integers(1, 17, size=(k, M)) * 2.0 ** -24
    return (G.astype(np.uint8), q.astype(np.float32), P.astype(np.float32))


def on_card(packed, dev, offset=0):
    """The uint8 array ``packed`` on the card, starting ``offset`` bytes past
    the start of its allocation (4: rows aligned to 4 bytes but not to 16,
    which turns off the kernels' 16-byte loads)."""
    buf = torch.empty(packed.size + offset, dtype=torch.uint8, device=dev)
    out = buf[offset:].view(packed.shape)
    out.copy_(torch.from_numpy(packed))
    return out


def check_indexed(dev, rng, n_rows, blk, nbk, m, k, D, missing, masked,
                  offset=0):
    """Every kernel on an indexed batch (``nbk`` shuffled blocks of ``blk``
    rows of ``n_rows`` resident rows, ``offset`` bytes into their
    allocation): against its plain version, and bit for bit against the
    same kernel on the gathered batch. Returns the largest |d| against the
    plain versions."""
    no_missing = not missing
    resident = on_card(random_packed(rng, n_rows, m, m, missing), dev,
                       offset)
    ix = {"blk_idx": torch.from_numpy(rng.permutation(n_rows // blk)[:nbk]
                                      .astype(np.int32)).to(dev),
          "blk": blk}
    xb = gather_batch(resident, ix["blk_idx"], blk).contiguous()
    B = nbk * blk
    q = torch.from_numpy(_q_rows(rng, B, k)).to(dev)
    P = torch.from_numpy(_relative_p(rng, k, m)).to(dev)
    cm = torch.from_numpy((rng.uniform(size=m) > 0.1).astype(np.float32)
                          ).to(dev)
    rw = torch.from_numpy((rng.uniform(size=B) > 0.2).astype(np.float32)
                          ).to(dev)
    V = torch.from_numpy(rng.normal(size=(m, D)).astype(np.float32)).to(dev)
    dXp = torch.from_numpy(rng.normal(size=(B, D)).astype(np.float32)).to(dev)
    worst = max(check_xv(resident, V, no_missing, **ix)[0],
                check_dv(resident, dXp, no_missing, **ix)[0],
                check_dq_dp(resident, q, P, cm, rw, 2.5, masked, no_missing,
                            False, **ix),
                check_dq_dp(resident, q, P, cm, rw, 1.0, masked, no_missing,
                            True, **ix),
                check_bce_sum(resident, q, P, cm, rw, masked, no_missing,
                              **ix))
    pairs = {
        "xv": lambda **a: (xv(a.pop("p"), V, no_missing, **a),),
        "dv": lambda **a: (dv(a.pop("p"), dXp, no_missing, **a),),
        "dq_dp": lambda **a: dq_dp(a.pop("p"), q, P, cm, rw, 2.5, masked,
                                   no_missing, **a)[:2],
        "loss_dq_dp": lambda **a: dq_dp(a.pop("p"), q, P, cm, rw, 1.0, masked,
                                        no_missing, True, **a),
        "bce_sum": lambda **a: (bce_sum(a.pop("p"), q, P, cm, rw, masked,
                                        no_missing, **a),),
    }
    for name, fn in pairs.items():
        got, want = fn(p=resident, **ix), fn(p=xb)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{name}: the indexed form differs from the "
                                 f"gathered form (blk={blk}, k={k})")
    return worst


def phase_env():
    t = phase("1. environment")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    done(t)
    return card


def ptxas_functions(log):
    """[(entry function, registers, spill stores in bytes, ptxas line)] from
    nvcc's -Xptxas -v output, names as mangled; the line is its stack, spill
    and register lines joined."""
    import re
    out, name, spill, text = [], None, 0, []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill, text = m.group(1), 0, []
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = int(m.group(1))
            text.append(line.strip())
        m = re.search(r"Used (\d+) registers.*", line)
        if m and name:
            text.append(m.group(0).strip())
            out.append((name, int(m.group(1)), spill, "; ".join(text)))
            name = None
    return out


def unhashed(fn):
    """A mangled kernel name without the hash that nvcc gives the anonymous
    namespace of each build, so that two builds' instances compare."""
    import re
    return re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", fn)


def ptxas_summary(log):
    """(functions, min and max registers, largest spill stores in bytes)
    from nvcc's -Xptxas -v output."""
    fns = ptxas_functions(log)
    regs = [r for _, r, _, _ in fns]
    return len(fns), min(regs, default=0), max(regs, default=0), \
        max((sp for _, _, sp, _ in fns), default=0)


def phase_build():
    """Builds every kernel; returns {source: nvcc's -Xptxas -v log}."""
    t = phase("2. build")
    logs = {}
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    for name, info in _build.build().items():
        n, r_min, r_max, spill = ptxas_summary(info["log"])
        print(f"   {name}: {info['seconds']:.1f} s -> {info['path'].name}; "
              f"ptxas: {n} functions, {r_min}-{r_max} registers, spill "
              f"stores {spill} bytes at most")
        for fn, regs, sp, _ in ptxas_functions(info["log"]):  # each one
            print(f"     ptxas {fn}: {regs} registers, spill stores "
                  f"{sp} bytes")
        logs[name] = info["log"]
        with open(os.path.join(out_dir, f"ptxas_{name}.log"), "w") as fb:
            fb.write(info["log"])
    done(t)
    return logs


def phase_tsan():
    """The native host decoder under ThreadSanitizer on the card's host:
    ``python -m neural_admixture_tpu_torch.native.tsan`` in its own process,
    as a user runs it (the canary reported, every threaded entry point on
    two or more threads, no report)."""
    t = phase("2b. native host decoder under ThreadSanitizer")
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "neural_admixture_tpu_torch.native.tsan"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    for line in res.stdout.splitlines():
        print(f"   {line}")
    if res.returncode != 0:
        raise RuntimeError(f"the ThreadSanitizer runner failed (exit "
                           f"{res.returncode}):\n{res.stderr[-4000:]}")
    print(f"   tsan runner: exit 0 in {time.perf_counter() - t0:.1f} s on "
          f"{os.cpu_count()} cores")
    done(t)


def check_division(dev, n=1 << 24):
    """dq_dp's branch-free division of the elementwise step bit for bit
    against '/' (IEEE, div.rn.f32) on n pairs from its domain: a = rec - x,
    b = max(rec (1 - rec), 1e-12) for rec uniform on [0, 1], log-uniform
    down to 2^-149 (denormals), near 1 and exactly 0, 1/2 and 1, and x in
    {0, 1/2, 1}, and a few a = -0. Returns the share of pairs the kernel
    hands to '/'."""
    lib = _build.load("dq_dp")
    vp = ctypes.c_void_p
    lib.na_dq_dp_div_check.argtypes = [vp, vp, vp, vp, ctypes.c_longlong, vp]
    lib.na_dq_dp_div_check.restype = ctypes.c_int
    gen = torch.Generator(device=dev).manual_seed(SEED)
    u = torch.rand(n, device=dev, generator=gen)
    kind = torch.randint(0, 4, (n,), device=dev, generator=gen)
    e = torch.rand(n, device=dev, generator=gen) * 150.0
    rec = torch.where(kind == 0, u, torch.where(
        kind == 1, torch.exp2(-e), torch.where(
            kind == 2, 1.0 - torch.exp2(-e * 0.16), 0.5 * torch.floor(3 * u))))
    rec = rec.clamp(0.0, 1.0)
    x = 0.5 * torch.randint(0, 3, (n,), device=dev, generator=gen).float()
    a = rec - x
    a[:64] = -0.0  # never made by the kernel; '/' takes it
    b = torch.clamp_min(rec * (1.0 - rec), 1e-12)
    fast, ieee = torch.empty_like(a), torch.empty_like(a)
    err = lib.na_dq_dp_div_check(a.data_ptr(), b.data_ptr(), fast.data_ptr(),
                                 ieee.data_ptr(), n,
                                 torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    if err != 0:
        raise RuntimeError(f"division check launch failed: CUDA error {err}")
    taken = ~torch.isnan(fast)
    if not torch.equal(fast[taken].view(torch.int32),
                       ieee[taken].view(torch.int32)):
        bad = (fast[taken].view(torch.int32)
               != ieee[taken].view(torch.int32)).sum().item()
        raise AssertionError(f"dq_dp's division differs from '/' in {bad} "
                             f"of {n} pairs")
    return 1.0 - taken.float().mean().item()


def check_bce_term(dev, n=1 << 24):
    """The one-log term of bce_sum and loss_dq_dp (csrc/bce.cuh
    bce_elem_code), through bce_sum's term check, on the card
    against the clamped BCE in float64 on n (r, code) pairs: r uniform on
    [0, 1], log-uniform from 1e-45 to 1, and within 2^-4 of 1 on the 2^-24
    grid, besides 0, 1 and denormals below e^-100; codes 0-3. Per element
    within 1e-6 of the float64 term, never NaN, and bit for bit ops/fused.py
    bce_elem (torch's logf and log1pf on the card) wherever a clamp decides
    the term: r = 0 and r = 1 at every code, r below e^-100 at codes 1 and 2
    (at codes 0 and 3 such an r gives r itself, -log1p(-r), exactly).
    Returns the largest |d| / |float64 term|."""
    lib = _build.load("bce_sum")
    vp = ctypes.c_void_p
    lib.na_bce_sum_term_check.argtypes = [vp, vp, vp, ctypes.c_longlong, vp]
    lib.na_bce_sum_term_check.restype = ctypes.c_int
    gen = torch.Generator(device=dev).manual_seed(SEED)
    kind = torch.randint(0, 3, (n,), device=dev, generator=gen)
    u = torch.rand(n, device=dev, generator=gen)
    lg = -45.0 * torch.rand(n, device=dev, generator=gen, dtype=torch.float64)
    near = torch.randint(1, 1 << 20, (n,), device=dev, generator=gen)
    r = torch.where(kind == 0, u.double(), torch.where(
        kind == 1, 10.0 ** lg, 1.0 - near.double() * 2.0 ** -24)).float()
    tiny = float(np.finfo(np.float32).smallest_subnormal)
    clamped = torch.tensor([0.0, 1.0] + [m * tiny for m in (1, 2, 3, 10, 26)],
                           device=dev)
    r[:4 * len(clamped)] = clamped.repeat(4)
    code = torch.randint(0, 4, (n,), device=dev, generator=gen,
                         dtype=torch.int32)
    code[:4 * len(clamped)] = torch.arange(
        4, device=dev, dtype=torch.int32).repeat_interleave(len(clamped))
    out = torch.empty_like(r)
    err = lib.na_bce_sum_term_check(r.data_ptr(), code.data_ptr(),
                                    out.data_ptr(), n,
                                    torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    if err != 0:
        raise RuntimeError(f"term check launch failed: CUDA error {err}")
    x = torch.where(code == 3, 0, code).double() / 2
    r64 = r.double()
    e64 = -(x * torch.clamp_min(torch.log(r64), -100.0)
            + (1 - x) * torch.clamp_min(torch.log1p(-r64), -100.0))
    d = (out.double() - e64).abs()
    if torch.isnan(out).any() or not bool((d <= 1e-6 * e64.abs()).all()):
        bad = (d > 1e-6 * e64.abs()) | torch.isnan(out)
        raise AssertionError(
            f"bce_sum's term off the float64 BCE at {int(bad.sum())} of {n} "
            f"(r, code), e.g. r={r[bad][:3].tolist()} code="
            f"{code[bad][:3].tolist()}")
    head = slice(0, 4 * len(clamped))
    want = bce_elem(r[head], x[head].float())
    by_clamp = (code[head] == 1) | (code[head] == 2) | (r[head] == 0) | \
        (r[head] == 1)
    if not torch.equal(out[head][by_clamp].view(torch.int32),
                       want[by_clamp].view(torch.int32)) or \
            not torch.equal(out[head][~by_clamp], r[head][~by_clamp]):
        raise AssertionError("bce_sum's term differs from bce_elem where a "
                             "clamp decides it")
    return (d / e64.abs().clamp_min(1e-300)).max().item()


# Phase 3's cases. Together they reach every template instance that the
# dispatchers of csrc/*.cu can reach, and every tile edge of each kernel
# (tests/test_torch_port_race.py maps them through the dispatch rules):
# K2 NT (D <= 8, 16, 32) x NO_MISSING x INDEXED, 12 instances; K3/K4 KT
# (k <= 4, 8, 16) x MASKED x NO_MISSING x WITH_LOSS x INDEXED, 48; K5
# NO_MISSING x INDEXED, 4, each over one launch's rows with D > 8 and with
# vec16 on (W4 % 4 == 0, 16-byte aligned rows) and off (W4 % 4 != 0, or
# rows 4 bytes past an aligned address); K6 KS (k <= 8, 16) x MASKED x
# NO_MISSING, 8, gathered and indexed. ``offset``: the packed rows start
# that many bytes past an aligned allocation (on_card).

# xv (B, M, D, missing in data, no_missing flag, spike, offset): B not a
# multiple of the 16-row tile, M not a multiple of the 512-SNP chunk (and
# M / 4 not of 16 bytes: the kernel's word-by-word loads), D from 1 to 32
# (n-tiles 1, 2, 4), with and without code 3; 1100 rows at D = 8, 520 at
# D = 12 and 300 at D = 32 take two launches by rows; spike: V with one
# entry of every 512-SNP chunk 1000 times the rest (spike_v).
XV_CASES = [(37, 4000, 4, True, False, False, 0),
            (37, 4000, 4, False, True, False, 0),
            (130, 16400, 8, True, False, False, 0),
            (130, 16400, 8, False, True, False, 0),
            (130, 16400, 8, False, False, False, 0),
            (65, 6160, 5, True, False, False, 0),
            (9, 8192, 16, True, False, False, 0),
            (70, 8192, 32, False, True, False, 0),
            (1, 2048, 8, True, False, False, 0),
            (17, 6160, 1, True, False, False, 0),
            (800, 8192, 1, False, True, False, 0),
            (1100, 4112, 8, True, False, False, 0),
            (300, 2064, 32, True, False, False, 0),
            (130, 16400, 8, True, False, True, 0),
            (800, 8192, 8, False, True, True, 0),
            (130, 16384, 8, True, False, False, 0),
            (15, 4000, 1, True, False, True, 0),
            (520, 2064, 12, False, True, False, 0),
            (130, 16384, 8, True, False, False, 4)]
# dq_dp and loss_dq_dp (B, m_pad, k, missing in data, no_missing, g): B
# ragged against the 16-row groups of the mma tiles and the 8 warps (1, 15,
# 17, 600), m_pad not a multiple of the 128-SNP tile, k in {2, 7, 8, 9, 16}
# (templates 4, 8, 16); each case masked and unmasked, with and without the
# loss, and K3 at g = 1 bit for bit against K4's dq and dP. (900, 16) and
# (1700, 8): more rows than one launch of the k = 16 and k = 8 instances
# stages (816, 1536), so a second launch adds into dP and the loss.
DQ_DP_CASES = [(1, 2064, 2, True, False, 1.0), (9, 4112, 7, True, False, 2.5),
               (37, 6160, 8, False, True, 1.0),
               (96, 8208, 8, True, False, 2.5),
               (130, 4144, 16, False, False, 1.0),
               (37, 4112, 16, True, False, 2.5),
               (600, 2064, 16, True, False, 2.5),
               (1, 2080, 16, False, True, 1.0),
               (15, 2064, 9, True, False, 2.5),
               (17, 4144, 2, False, True, 1.0),
               (15, 2080, 16, False, False, 2.5),
               (17, 2064, 9, False, True, 1.0),
               (600, 4112, 2, True, False, 1.0),
               (600, 2080, 9, False, True, 2.5),
               (900, 2064, 16, True, False, 2.5),
               (1700, 2064, 8, False, True, 1.0)]
# dv (B, m_pad, D, missing in data, no_missing, spike, offset): B not a
# multiple of the 32-row k-step (1, 9, 33, 37, 130, 300) and over one
# 256-row scale chunk, m_pad not a multiple of the 512-SNP tile (and
# m_pad / 16 not of 4 words: the kernel's 4-byte copies), D from 1 to 32
# (one launch per 8 columns), with and without code 3; DV_SPLIT rows, more
# than one launch takes (na_dv_rows_per_launch, 2048), at D = 8 and 5, and
# at D = 9 to 16 with vec16 on, off by W4 and off by the offset; spike:
# spike_dv_case.
DV_SPLIT = 2100
DV_CASES = [(1, 2064, 4, True, False, False, 0),
            (9, 4112, 5, True, False, False, 0),
            (37, 6160, 8, False, True, False, 0),
            (96, 8208, 8, True, False, False, 0),
            (130, 4144, 16, False, False, False, 0),
            (37, 4112, 32, True, False, False, 0),
            (300, 2064, 32, True, False, False, 0),
            (33, 2064, 1, True, False, False, 0),
            (800, 8192, 1, False, True, False, 0),
            (DV_SPLIT, 2064, 8, True, False, False, 0),
            (DV_SPLIT, 4096, 5, False, True, False, 0),
            (800, 8192, 8, True, False, True, 0),
            (800, 8208, 8, False, True, True, 0),
            (300, 4112, 1, True, False, True, 0),
            (DV_SPLIT, 2112, 12, True, False, False, 0),
            (DV_SPLIT, 2064, 13, True, False, False, 0),
            (DV_SPLIT, 2112, 12, True, False, False, 4),
            (DV_SPLIT, 2112, 9, False, True, False, 0),
            (DV_SPLIT, 2064, 16, False, True, False, 0),
            (DV_SPLIT, 2112, 10, False, True, False, 4)]
# bce_sum and loss_dq_dp (B, m_pad, k): k in {1, 7, 16} (both bce_sum
# instances, KS = 1 and 2; loss_dq_dp at KT 4, 8 and 16), each with and
# without code 3 in the data (no_missing set when there is none), masked
# and unmasked, on the random planes of q and P above and on the
# adversarial planes of bce_plane, where the one-log term of both is
# hardest; (900, 16) and (1700, 7) stage their rows in two passes.
BCE_SUM_CASES = [(9, 4112, 1), (96, 8208, 7), (600, 2064, 16),
                 (900, 2064, 16), (1700, 2064, 7)]
# indexed forms (n_rows resident, blk, blocks, m_pad, k, D, missing,
# masked, offset): blocks of 1 and of 16 rows over resident arrays larger
# than the batch, in shuffled order; the last six take dv past one launch
# at D > 8 with vec16 on, off by W4 and off by the offset, without and
# with code 3, and reach the indexed instances that the others miss.
INDEXED_CASES = [(300, 1, 37, 4112, 7, 8, True, True, 0),
                 (300, 1, 130, 2064, 16, 32, False, False, 0),
                 (640, 16, 5, 6160, 8, 8, True, False, 0),
                 (640, 16, 38, 2064, 16, 5, False, True, 0),
                 (300, 1, 15, 2080, 2, 4, False, True, 0),
                 (1000, 1, 17, 2064, 9, 8, True, True, 0),
                 (1000, 1, 900, 2064, 16, 8, True, False, 0),
                 (2200, 1, 2100, 2064, 8, 8, True, False, 0),
                 (2200, 1, 2100, 2112, 3, 12, True, True, 0),
                 (2200, 1, 2100, 2064, 4, 16, False, False, 0),
                 (2200, 1, 2100, 2112, 2, 24, True, False, 4),
                 (2200, 1, 2100, 2112, 6, 13, False, True, 4),
                 (2200, 1, 2100, 2112, 8, 9, False, False, 0),
                 (2200, 1, 2100, 2064, 5, 10, True, True, 0)]


def phase_kernels(dev):
    """Every kernel against its plain version at small ragged shapes."""
    t = phase("3. kernels vs their plain versions")
    share = check_division(dev)
    print(f"   dq_dp's branch-free division: bit-equal to '/' on 2^24 pairs "
          f"of its domain; {share:.2e} of them taken by '/' instead")
    rel = check_bce_term(dev)
    print(f"   the one-log term of bce_sum and loss_dq_dp: on 2^24 (r, code) "
          f"pairs within "
          f"{rel:.2e} of the float64 BCE (rule 1e-6), no NaN, bit-equal to "
          "bce_elem where a clamp decides it")
    rng = np.random.default_rng(SEED)
    for B, M, D, missing, no_missing, spike, offset in XV_CASES:
        packed = on_card(random_packed(rng, B, M, M, missing), dev, offset)
        V = torch.from_numpy(spike_v(rng, M, D) if spike else rng.normal(
            size=(M, D)).astype(np.float32)).to(dev)
        a, r = check_xv(packed, V, no_missing)
        print(f"   xv B={B} M={M} D={D} missing={missing} "
              f"no_missing={no_missing} spike={spike} offset={offset}: "
              f"max|d| {a:.3e}, max|d|/sum|x||V| {r:.3e}")
    for B, m, k, missing, no_missing, g in DQ_DP_CASES:
        packed = torch.from_numpy(random_packed(rng, B, m, m, missing)).to(dev)
        q = torch.from_numpy(_q_rows(rng, B, k)).to(dev)
        P = torch.from_numpy(_relative_p(rng, k, m)).to(dev)
        cm = torch.from_numpy((rng.uniform(size=m) > 0.1).astype(np.float32)
                              ).to(dev)
        rw = torch.from_numpy((rng.uniform(size=B) > 0.2).astype(np.float32)
                              ).to(dev)
        for masked in (True, False):
            for with_loss in (False, True):
                e = check_dq_dp(packed, q, P, cm, rw, g, masked, no_missing,
                                with_loss)
                print(f"   {'loss_dq_dp' if with_loss else 'dq_dp'} B={B} "
                      f"m_pad={m} k={k} missing={missing} "
                      f"no_missing={no_missing} g={g} masked={masked}: "
                      f"max|d| {e:.3e}")
            k3 = dq_dp(packed, q, P, cm, rw, 1.0, masked, no_missing)
            k4 = dq_dp(packed, q, P, cm, rw, 1.0, masked, no_missing, True)
            if not (torch.equal(k3[0], k4[0]) and torch.equal(k3[1], k4[1])):
                raise AssertionError(f"K3 at g = 1 differs from K4 (B={B}, "
                                     f"k={k}, masked={masked})")
        print(f"   B={B} k={k}: K3 at g = 1 bit-equal to K4's dq and dP, "
              "masked and unmasked")
    if DV_SPLIT <= dv_ops.rows_per_launch():
        raise AssertionError(f"DV_SPLIT ({DV_SPLIT}) no longer passes one "
                             f"launch of dv ({dv_ops.rows_per_launch()} rows)")
    for B, m, D, missing, no_missing, spike, offset in DV_CASES:
        if spike:
            packed, dXp = spike_dv_case(rng, B, m, D, missing)
        else:
            packed = random_packed(rng, B, m, m, missing)
            dXp = rng.normal(size=(B, D)).astype(np.float32)
        a, r = check_dv(on_card(packed, dev, offset),
                        torch.from_numpy(dXp).to(dev), no_missing)
        print(f"   dv B={B} m_pad={m} D={D} missing={missing} "
              f"no_missing={no_missing} spike={spike} offset={offset}: "
              f"max|d| {a:.3e}, max|d|/sum|x||dXp| {r:.3e}")
    for B, m, k in BCE_SUM_CASES:
        for plane in BCE_PLANES:
            for missing in (True, False):
                if plane == "random":
                    packed = random_packed(rng, B, m, m, missing)
                    q, P = _q_rows(rng, B, k), _relative_p(rng, k, m)
                else:
                    G, q, P = bce_plane(rng, plane, B, m, k, missing)
                    packed = pack_2bit_rows(G)
                packed, q, P = (torch.from_numpy(a).to(dev)
                                for a in (packed, q, P))
                cm = torch.from_numpy((rng.uniform(size=m) > 0.1)
                                      .astype(np.float32)).to(dev)
                rw = torch.from_numpy((rng.uniform(size=B) > 0.2)
                                      .astype(np.float32)).to(dev)
                for masked in (True, False):
                    e = check_bce_sum(packed, q, P, cm, rw, masked,
                                      not missing)
                    e4 = check_dq_dp(packed, q, P, cm, rw, 1.0, masked,
                                     not missing, True)
                    print(f"   bce_sum and loss_dq_dp {plane} B={B} "
                          f"m_pad={m} k={k} missing={missing} "
                          f"no_missing={not missing} masked={masked}: "
                          f"|d| {e:.3e}, max|d| {e4:.3e}")
    for case in INDEXED_CASES:
        e = check_indexed(dev, rng, *case)
        print(f"   indexed n_rows={case[0]} blk={case[1]} blocks={case[2]} "
              f"m_pad={case[3]} k={case[4]} D={case[5]} missing={case[6]} "
              f"masked={case[7]} offset={case[8]}: xv, dv, dq_dp, "
              f"loss_dq_dp, bce_sum within "
              f"the plain tolerance (max|d| {e:.3e}) and bit-equal to the "
              "gathered form")
    done(t)


def phase_infer(dev):
    """The main path of projective inference at full width."""
    t = phase("4. full width: infer_q")
    m_pad = -(-M_FULL // LANE) * LANE
    W = m_pad // 4
    rng = np.random.default_rng(SEED)
    packed = random_packed(rng, N_FULL, M_FULL, m_pad, missing=True)
    params = random_params(rng, M_FULL, m_pad, D_FULL, H_FULL, [K_FULL])
    n_batches = -(-N_FULL // BATCH)
    print(f"   N={N_FULL} M={M_FULL} m_pad={m_pad} K={K_FULL} H={H_FULL} "
          f"D={D_FULL} batch={BATCH}: {n_batches} batches of "
          f"{BATCH * W / 1e6:.1f} MB packed")
    xv.launches = 0
    torch.cuda.synchronize()
    t_run = time.perf_counter()
    (Q,) = infer_q(params, packed, N_FULL, [K_FULL], BATCH, dev)
    torch.cuda.synchronize()
    wall_first = time.perf_counter() - t_run
    launches = xv.launches
    if launches != n_batches:
        raise AssertionError(f"xv launched {launches} times on the main "
                             f"path, expected {n_batches}")
    if Q.shape != (N_FULL, K_FULL) or not np.isfinite(Q).all():
        raise AssertionError(f"bad Q: shape {Q.shape}, finite "
                             f"{np.isfinite(Q).all()}")
    if not np.allclose(Q.sum(1), 1.0, atol=1e-5):
        raise AssertionError("Q rows do not sum to 1")
    t_run = time.perf_counter()
    infer_q(params, packed, N_FULL, [K_FULL], BATCH, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    print(f"   infer_q: {launches} xv launches; wall {wall_first:.3f} s "
          f"(first), {wall:.3f} s (second)")

    model = params_from_numpy(params, [K_FULL], dev)
    blk = torch.from_numpy(packed[:BATCH]).to(dev)
    with torch.no_grad():
        xp_k = xv(blk, model.V)
        torch.cuda.synchronize()
        xp_p = xv_plain(blk, model.V)
        scale = xv_plain(blk, model.V.abs())
        err = (xp_k - xp_p).abs()
        if not bool((err <= 1e-5 * scale + 1e-6).all()):
            raise AssertionError(f"full-width xv disagrees: {err.max():.3e}")
        full_err = err.max().item()
        # Q from the plain projection, through the same encoder. Tolerance
        # 1e-4 absolute: Q moves with the rounding of Xp above.
        q_plain = model.encode_from_xp(xp_p)[f"k{K_FULL}"].cpu().numpy()
        dq = np.abs(q_plain - Q[:BATCH]).max()
        if dq > 1e-4:
            raise AssertionError(f"full-width Q vs plain: max|d| {dq:.3e}")
        print(f"   batch 0: xv max|d| {full_err:.3e} vs plain; Q max|d| "
              f"{dq:.3e} vs the plain path")

        ms = cuda_ms(lambda: xv(blk, model.V, False), 20)
        plain_ms = cuda_ms(lambda: xv_plain(blk, model.V), 3)
        enc_ms = cuda_ms(lambda: model.encode_from_xp(xp_k), 20)
    # The parent's pageable path (train/chunked.py before the stager): per
    # batch a pageable host->device copy, the forward, Q back to the host;
    # split on the host clock, and its Q against the staged infer_q's.
    split = dict.fromkeys(("weights", "scan", "rows->card", "forward",
                           "Q->host"), 0.0)
    t_s = time.perf_counter()
    model = params_from_numpy(params, [K_FULL], dev)
    torch.cuda.synchronize()
    split["weights"] = time.perf_counter() - t_s
    t_s = time.perf_counter()
    no_missing = not packed_has_missing(packed)
    split["scan"] = time.perf_counter() - t_s
    q_pageable = []
    with torch.no_grad():
        for i in range(0, N_FULL, BATCH):
            t_s = time.perf_counter()
            b = torch.from_numpy(packed[i:i + BATCH]).to(dev)
            torch.cuda.synchronize()
            t_f = time.perf_counter()
            q = model(b, no_missing)[f"k{K_FULL}"]
            torch.cuda.synchronize()
            t_q = time.perf_counter()
            q_pageable.append(q.cpu().numpy())
            t_e = time.perf_counter()
            split["rows->card"] += t_f - t_s
            split["forward"] += t_q - t_f
            split["Q->host"] += t_e - t_q
    pageable_wall = sum(split.values())
    if not np.array_equal(np.concatenate(q_pageable), Q):
        raise AssertionError("staged infer_q's Q differs from the pageable "
                             "path's")
    print("   pageable path (the parent's), host clock, ms in all: "
          + ", ".join(f"{k} {1e3 * v:.3f}" for k, v in split.items())
          + f"; Q bit-equal to the staged infer_q's")
    h2d_ms = cuda_ms(lambda: torch.from_numpy(packed[:BATCH]).to(dev), 5)
    # Pinning a batch-sized slot: PyTorch's pinned allocator (cudaHostAlloc,
    # the process's first pinned block) against the stager's registration.
    t_s = time.perf_counter()
    pinned = torch.from_numpy(packed[:BATCH]).pin_memory()
    pin_alloc_s = time.perf_counter() - t_s
    staged = {level: staged_batches(params, packed, dev, Q, level)
              for level in (2, 1, 0)}
    h2d_pinned_ms = cuda_ms(lambda: pinned.to(dev, non_blocking=True), 5)
    gather = {}
    for threads in (1, 4, 8):
        gather[threads] = 1e3 * host_gather_s(packed, pinned.numpy(),
                                              threads)
    reg = infer_registered(params, packed, dev, Q)
    _, _, n_bytes, n_ops = work_shapes(BATCH, W, K_FULL)["xv"]
    bound_ms, bound_by = bound(n_bytes, n_ops)
    print(f"   per batch of {BATCH}: xv kernel {ms:.4f} ms (bound "
          f"{bound_ms:.4f} ms by {bound_by}: {n_bytes / 1e6:.1f} MB, "
          f"{ops_text(n_ops)}; {100 * bound_ms / ms:.1f}% of it), "
          f"xv_plain {plain_ms:.3f} ms")
    print(f"   per batch: host->device copy {h2d_ms:.3f} ms pageable "
          f"({BATCH * W / h2d_ms / 1e6:.2f} GB/s), {h2d_pinned_ms:.3f} ms "
          f"pinned ({BATCH * W / h2d_pinned_ms / 1e6:.2f} GB/s); encoder "
          f"{enc_ms:.4f} ms; kernel {ms:.4f} ms")
    print(f"   pinning {BATCH * W / 1e6:.1f} MB: pin_memory() "
          f"{1e3 * pin_alloc_s:.1f} ms (cudaHostAlloc)")
    for level, st in staged.items():
        print(f"   NA_TPU_STREAM_PREFETCH={level}: the stager's host slots "
              f"({st['pinned'] / 1e6:.1f} MB) allocated, pre-faulted and "
              f"registered (cudaHostRegister) {1e3 * st['setup']:.1f} ms, "
              f"released {1e3 * st['release']:.1f} ms; its batches alone "
              f"(the ring built beforehand) "
              f"{1e3 * st['batches'] / n_batches:.3f} ms a batch, gather "
              f"{1e3 * st['gather'] / n_batches:.3f} ms a batch (host "
              f"clock); Q bit-equal")
    print("   per batch, the host gather into a pinned slot (host clock, "
          "contiguous rows): " + ", ".join(
              f"{t} thread{'s' * (t > 1)} {g:.3f} ms "
              f"({BATCH * W / g / 1e6:.2f} GB/s)" for t, g in gather.items()))
    print(f"   per batch, wall: staged infer_q (a: gathered into the pinned "
          f"ring) {1e3 * wall_first / n_batches:.3f} ms first call, "
          f"{1e3 * wall / n_batches:.3f} ms second; pageable (the parent's) "
          f"{1e3 * pageable_wall / n_batches:.3f} ms; registered (b: "
          f"cudaHostRegister of all rows, slices copied from them) "
          f"{1e3 * reg['wall'] / n_batches:.3f} ms, plus "
          f"{1e3 * reg['register']:.1f} ms to register and "
          f"{1e3 * reg['unregister']:.1f} ms to unregister "
          f"{packed.nbytes / 1e9:.2f} GB (copy {reg['copy_ms']:.3f} ms a "
          "batch); Q of (b) bit-equal")
    del blk, pinned, model
    done(t)
    return packed, params, Q


# Per packed byte (4 fields, low bits first): the minor-allele flip
# (0 <-> 2, 1 and 3 kept), and the PLINK 1 code of each field's dosage
# (dosage 0 -> 0b11, 1 -> 0b10, 2 -> 0b00, 3 -> 0b01).
def _byte_lut(field_map):
    return np.array([sum(field_map[(b >> (2 * i)) & 3] << (2 * i)
                         for i in range(4)) for b in range(256)], np.uint8)


FLIP_CODE = np.array([2, 1, 0, 3], np.uint8)
FLIP_BYTE = _byte_lut(FLIP_CODE)
BED_BYTE = _byte_lut([3, 2, 0, 1])
# Variants of the compressed PGENs (N_FULL samples each) and of the VCF
# (N_FULL sample columns): the port's PGEN writer tries every record type
# for each variant (≈ 5 ms a variant at N = 4096) and the VCF parser reads
# about 1 M fields/s, so these two are cut in variants.
M_COMPRESSED, M_VCF = 2048, 2000
# The pure-Python PGEN decoder reads the full-width storage-8 file only this
# far (it decodes variant by variant); the native one reads all of it. The
# BED reader's NumPy twin, which took three times native's time on the whole
# file on an H100's 8-core host, is timed against native on a BED of the
# first M_TWIN variants.
PURE_WINDOW = 65536
M_TWIN = 131072
GT_TEXT = ("0/0", "0/1", "1/1", "./.")


def variant_major(packed_blk):
    """Sample-major packed rows (N, bw), N a multiple of 4 -> variant-major
    records (4 bw, N/4): the 2-bit codes of one variant, 4 samples a byte,
    low bits first (the record layout of PLINK 1 BED and PGEN modes 0x02
    and storage 8)."""
    n, bw = packed_blk.shape
    q = packed_blk.reshape(n // 4, 4, bw)
    out = np.empty((bw, 4, n // 4), np.uint8)
    for j in range(4):  # the variant within a packed byte
        acc = np.zeros((n // 4, bw), np.uint8)
        for i in range(4):  # the sample within a record byte
            acc |= ((q[:, i, :] >> (2 * j)) & 3) << (2 * i)
        out[:, j, :] = acc.T
    return out.reshape(4 * bw, n // 4)


def write_full_width(d, packed, n, m, block_bytes=4096):
    """The flipped codes of ``packed`` (n, m/4 + padding) as a PLINK BED
    (.bed/.fam), a PGEN mode 0x01 (the same bytes, hard-linked, and a
    .psam), a mode-0x02 PGEN and a mode-0x10 PGEN of storage 8, written in
    one pass over SNP blocks of ``block_bytes`` packed columns. The readers
    flip them back: the codes are uniform over {0, 1, 2, 3}, so the mean
    counting missing as 3 is about 1.5 either way."""
    paths = {"bed": os.path.join(d, "full.bed"),
             "0x01": os.path.join(d, "full01.pgen"),
             "0x02": os.path.join(d, "full02.pgen"),
             "storage8": os.path.join(d, "full8.pgen")}
    with open(paths["bed"], "wb") as fb, open(paths["0x02"], "wb") as f2, \
            open(paths["storage8"], "wb") as f8:
        fb.write(b"\x6c\x1b\x01")
        dims = np.asarray([m, n], "<u4").tobytes()
        f2.write(b"\x6c\x1b\x02" + dims)
        f8.write(b"\x6c\x1b\x10" + dims + bytes([8]))
        for w0 in range(0, m // 4, block_bytes):
            rec = variant_major(packed[:, w0:min(w0 + block_bytes, m // 4)])
            fb.write(BED_BYTE[FLIP_BYTE[rec]].tobytes())
            flipped = FLIP_BYTE[rec].tobytes()
            f2.write(flipped)
            f8.write(flipped)
    names = "".join(f"s{i}\n" for i in range(n))
    with open(os.path.join(d, "full.fam"), "w") as fb:
        fb.write("".join(f"f{i} s{i} 0 0 0 -9\n" for i in range(n)))
    os.link(paths["bed"], paths["0x01"])
    with open(os.path.join(d, "full01.psam"), "w") as fb:
        fb.write("#IID\n" + names)
    return paths


def mixed_genotypes(rng, n, m):
    """(n, m) dosages whose variants take every PGEN record type in turn:
    dense random (plain), a few non-reference calls (difflist against hom
    ref), two common values (onebit), near copies and near inverted copies
    of the previous variant (LD), a few calls against hom alt and against
    missing."""
    G = np.zeros((n, m), np.uint8)
    for v in range(m):
        kind = v % 7
        few = rng.choice(n, size=max(2, n // 200), replace=False)
        if kind == 0:
            G[:, v] = rng.integers(0, 4, n)
        elif kind == 1:
            G[few, v] = rng.integers(1, 4, few.size)
        elif kind == 2:
            G[:, v] = rng.choice([0, 2], n)
            G[few, v] = rng.integers(1, 4, few.size)
        elif kind in (3, 4):
            G[:, v] = G[:, v - 1] if kind == 3 else \
                np.array([2, 1, 0, 3], np.uint8)[G[:, v - 1]]
            G[few, v] = rng.integers(0, 4, few.size)
        elif kind == 5:
            G[:, v] = 2
            G[few, v] = rng.integers(0, 2, few.size)
        else:
            G[:, v] = 3
            G[few, v] = rng.integers(0, 3, few.size)
    return G


def write_vcf(path, G):
    """A VCF of dosages G (n, m): one GT column per sample."""
    n, m = G.shape
    with open(path, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
                 "FILTER\tINFO\tFORMAT\t"
                 + "\t".join(f"s{i}" for i in range(n)) + "\n")
        gt = np.array(GT_TEXT)
        for v in range(m):
            fh.write(f"1\t{v + 1}\trs{v}\tA\tG\t.\tPASS\t.\tGT\t"
                     + "\t".join(gt[G[:, v]]) + "\n")


def expected_packed(G, lane=LANE):
    """What the packed readers return for dosages G (n, m): the biallelic
    codes flipped when their mean (missing counted as 3) is >= 1, packed
    and padded to ``lane`` SNPs (io/bed.py read_bed_packed's contract)."""
    if G.mean() >= 1:
        G = np.where(G == 3, 3, 2 - G.astype(np.int16)).astype(np.uint8)
    return pack_2bit_rows(G, m_pad=-(-G.shape[1] // lane) * lane)


def timed_read(fn, path, nbytes, want, what):
    """One read on the host clock; checks the packed rows against ``want``
    byte for byte and prints seconds and GB/s of input. Returns the rows."""
    t_s = time.perf_counter()
    packed, n, m = fn(path)
    secs = time.perf_counter() - t_s
    if packed.shape != want.shape or not np.array_equal(packed, want):
        raise AssertionError(f"{what}: packed rows differ from the expected "
                             f"ones ({packed.shape} vs {want.shape})")
    print(f"   {what}: {secs:.3f} s, {nbytes / secs / 1e9:.3f} GB/s of "
          f"{nbytes / 1e6:.1f} MB input; N={n} M={m}; bytes equal")
    return packed


def phase_readers(dev, packed, params, Q_want):
    """The port's readers (io/bed.py, io/pgen.py, io/pgen_standard.py,
    io/vcf.py) on files of phase 4's rows, on the host clock."""
    from unittest import mock

    from neural_admixture_tpu_torch.io.bed import read_bed_packed
    from neural_admixture_tpu_torch.io.pgen import read_pgen_packed
    from neural_admixture_tpu_torch.io.pgen_standard import (
        StandardPgen, write_pgen_standard)
    from neural_admixture_tpu_torch.io.vcf import read_vcf_packed
    from neural_admixture_tpu_torch.native import bed_native
    from neural_admixture_tpu_torch.native import build as native_build
    t = phase("4b. readers: BED, PGEN 0x01/0x02/0x10/0x11 and VCF into "
              "packed rows (host clock)")
    cores = len(os.sched_getaffinity(0))
    built_before = native_build.lib_path().exists()
    t_s = time.perf_counter()
    if not (bed_native.available() and bed_native.pgen_available()):
        raise AssertionError("the native host library did not build")
    build_s = time.perf_counter() - t_s
    lib = os.path.relpath(bed_native.library_path(), REPO)
    print(f"   native host library ({lib}): "
          + ("loaded, built before this run" if built_before else
             f"built with g++ in {build_s:.2f} s")
          + f"; host: {os.cpu_count()} cores, {cores} usable")
    n, m = N_FULL, M_FULL
    rec_bytes = -(-n // 4) * m
    with tempfile.TemporaryDirectory() as d:
        t_s = time.perf_counter()
        paths = write_full_width(d, packed, n, m)
        print(f"   wrote the BED, PGEN 0x01 (the same bytes), 0x02 and "
              f"storage-8 0x10 of N={n}, M={m} ({rec_bytes / 1e9:.3f} GB "
              f"each) in {time.perf_counter() - t_s:.1f} s")
        bed_native.reset_calls()
        timed_read(
            read_bed_packed, paths["bed"], rec_bytes, packed,
            "BED, native (na_bed_to_packed)")
        calls = bed_native.call_counts()
        if calls["bed_to_packed"] == 0:
            raise AssertionError(f"the BED read made no native call: {calls}")
        # Native against the NumPy twin on a BED of the first M_TWIN
        # variants.
        m_twin = min(M_TWIN, m)
        twin_bed = os.path.join(d, "twin.bed")
        with open(paths["bed"], "rb") as fa, open(twin_bed, "wb") as fb:
            fb.write(fa.read(3 + m_twin * (-(-n // 4))))
        shutil.copy(os.path.join(d, "full.fam"),
                    os.path.join(d, "twin.fam"))
        twin_want = packed[:, :-(-m_twin // LANE) * LANE // 4].copy()
        twin_want[:, m_twin // 4:] = 0
        twin_bytes = m_twin * (-(-n // 4))
        timed_read(read_bed_packed, twin_bed, twin_bytes, twin_want,
                   f"BED of the first {m_twin} variants, native")
        calls = bed_native.call_counts()
        with mock.patch.object(bed_native, "available", lambda: False):
            timed_read(read_bed_packed, twin_bed, twin_bytes, twin_want,
                       f"BED of the first {m_twin} variants, NumPy twin")
        if bed_native.call_counts() != calls:
            raise AssertionError("the NumPy twin called the library")
        os.unlink(twin_bed)
        for mode in ("0x01", "0x02"):
            timed_read(
                read_pgen_packed, paths[mode], rec_bytes, packed,
                f"PGEN {mode} (NumPy, fixed width)")
        rows = timed_read(
            read_pgen_packed, paths["storage8"], rec_bytes, packed,
            "PGEN 0x10 storage 8, native (na_pgen_decode2)")
        if bed_native.pgen_decode.calls == 0:
            raise AssertionError("the PGEN read made no native call")
        # The pure decoder on the first PURE_WINDOW variants: it runs
        # variant by variant in Python.
        v1 = min(PURE_WINDOW, m)
        want_cols = np.ascontiguousarray(
            unpack_2bit_rows(packed[:, :v1 // 4], v1).T)
        with mock.patch.object(bed_native, "pgen_available", lambda: False):
            reader = StandardPgen(paths["storage8"])
            t_s = time.perf_counter()
            got = reader.read_block(0, v1)
            secs = time.perf_counter() - t_s
        if not np.array_equal(got, FLIP_CODE[want_cols]):
            raise AssertionError("the pure decoder's storage-8 block differs")
        print(f"   PGEN 0x10 storage 8, pure decoder, variants [0, {v1}): "
              f"{secs:.3f} s, {-(-n // 4) * v1 / secs / 1e9:.3f} GB/s "
              f"(the full file at that rate: {secs * m / v1:.1f} s); codes "
              "equal")

        t_s = time.perf_counter()
        (Q_rows,) = infer_q(params, rows, n, [K_FULL], BATCH, dev)
        torch.cuda.synchronize()
        if not np.array_equal(Q_rows, Q_want):
            raise AssertionError("infer_q on the PGEN-read rows gives "
                                 "another Q than phase 4's")
        print(f"   infer_q on the rows of the storage-8 read: "
              f"{time.perf_counter() - t_s:.3f} s; Q bit-equal to phase 4's")
        del rows, got
        for path in paths.values():
            os.unlink(path)

        rng = np.random.default_rng(SEED + 4)
        Gc = mixed_genotypes(rng, n, M_COMPRESSED)
        want = expected_packed(Gc)
        for mode in (0x10, 0x11):
            path = os.path.join(d, f"c{mode:x}.pgen")
            t_s = time.perf_counter()
            vrtypes = write_pgen_standard(path, Gc, mode=mode)
            size = os.path.getsize(path) + (
                os.path.getsize(path + ".pgi") if mode == 0x11 else 0)
            print(f"   wrote a mode-{mode:#04x} PGEN of N={n}, "
                  f"M={M_COMPRESSED} ({size / 1e6:.2f} MB, record types "
                  f"{sorted(set(vrtypes))}) with the port's writer in "
                  f"{time.perf_counter() - t_s:.1f} s")
            for how in ("native", "pure"):
                before = bed_native.pgen_decode.calls
                with contextlib.nullcontext() if how == "native" else \
                        mock.patch.object(bed_native, "pgen_available",
                                          lambda: False):
                    timed_read(
                        read_pgen_packed, path, size, want,
                        f"PGEN {mode:#04x}, {how} decoder")
                if (bed_native.pgen_decode.calls > before) != \
                        (how == "native"):
                    raise AssertionError(f"{how}: native calls "
                                         f"{bed_native.pgen_decode.calls}")

        path = os.path.join(d, "v.vcf")
        Gv = unpack_2bit_rows(packed[:, :M_VCF // 4], M_VCF)
        t_s = time.perf_counter()
        write_vcf(path, FLIP_CODE[Gv])
        size = os.path.getsize(path)
        print(f"   wrote a VCF of N={n}, M={M_VCF} ({size / 1e6:.1f} MB) in "
              f"{time.perf_counter() - t_s:.1f} s")
        want = expected_packed(FLIP_CODE[Gv])
        if not np.array_equal(want, packed[:, :want.shape[1]] * (
                np.arange(want.shape[1]) < M_VCF // 4)):
            raise AssertionError("the VCF's expected rows are not phase 4's")
        timed_read(read_vcf_packed, path, size, want,
                                       "VCF (NumPy parser)")
    print(f"   native calls: {bed_native.call_counts()}")
    done(t)



def host_gather_s(packed, out, threads, reps=3):
    """Best host-clock seconds of gathering one batch of contiguous rows
    into ``out`` (a pinned slot's array) split over ``threads`` threads, as
    the stager's gather (io/stage.py gather_rows)."""
    from concurrent.futures import ThreadPoolExecutor
    rows = np.arange(out.shape[0], dtype=np.int64)
    cuts = np.linspace(0, len(rows), threads + 1).astype(int)
    best = float("inf")
    with ThreadPoolExecutor(threads) as pool:
        for _ in range(reps):
            t_s = time.perf_counter()
            futs = [pool.submit(gather_rows, packed, rows[a:b], out[a:b])
                    for a, b in zip(cuts[:-1], cuts[1:])]
            for f in futs:
                f.result()
            best = min(best, time.perf_counter() - t_s)
    return best


def staged_batches(params, packed, dev, Q_want, level):
    """infer_q's loop with the stager (prefetch ``level``) built
    beforehand: host-clock seconds of the stager's set-up, of the batches
    (through ``chunked_forward``, as infer_q), of their gathers and of the
    stager's release, and its pinned bytes; checks Q bit for bit."""
    from neural_admixture_tpu_torch.train.chunked import chunked_forward
    out = {}
    model = params_from_numpy(params, [K_FULL], dev)
    no_missing = not packed_has_missing(packed)
    torch.cuda.synchronize()
    t_s = time.perf_counter()
    stager = HostStager(dev, BATCH, packed.shape[1], prefetch=level)
    out["setup"] = time.perf_counter() - t_s
    out["pinned"] = sum(h.numel() for h in stager._host)
    t_s = time.perf_counter()
    with torch.no_grad():
        qs = chunked_forward(lambda b: model(b, no_missing), packed, N_FULL,
                             BATCH, dev, stager=stager)
    out["batches"] = time.perf_counter() - t_s
    out["gather"] = stager.gather_seconds
    t_s = time.perf_counter()
    stager.close()
    out["release"] = time.perf_counter() - t_s
    if not np.array_equal(qs[f"k{K_FULL}"], Q_want):
        raise AssertionError("staged batches' Q differs from infer_q's")
    return out


def infer_registered(params, packed, dev, Q_want):
    """Way (b) of pinning for infer: register the whole host array with the
    CUDA runtime once and copy each batch's rows straight from it (no host
    memcpy), on a side stream into two device slots. Returns host-clock
    seconds of the registration, the batches and the unregistration, and
    the copy's ms a batch (CUDA events); checks Q bit for bit. The wall
    counts what infer_q's does: the weights, the missing-code scan and the
    batches."""
    cudart = torch.cuda.cudart()
    host = torch.from_numpy(packed)
    W = packed.shape[1]
    out = {}
    t_s = time.perf_counter()
    err = int(cudart.cudaHostRegister(host.data_ptr(), packed.nbytes, 0))
    out["register"] = time.perf_counter() - t_s
    if err:
        raise RuntimeError(f"cudaHostRegister failed: error {err}")
    try:
        torch.cuda.synchronize()
        t_s = time.perf_counter()  # as infer_q: weights, scan, batches
        model = params_from_numpy(params, [K_FULL], dev)
        no_missing = not packed_has_missing(packed)
        slots = [torch.empty((BATCH, W), dtype=torch.uint8, device=dev)
                 for _ in range(2)]
        side = torch.cuda.Stream(dev)
        freed = [None, None]
        parts = []
        with torch.no_grad():
            for j, i in enumerate(range(0, N_FULL, BATCH)):
                s = j % 2
                with torch.cuda.stream(side):
                    if freed[s] is not None:
                        side.wait_event(freed[s])
                    slots[s].copy_(host[i:i + BATCH], non_blocking=True)
                    copied = torch.cuda.Event()
                    copied.record(side)
                torch.cuda.current_stream(dev).wait_event(copied)
                parts.append(model(slots[s], no_missing)[f"k{K_FULL}"])
                freed[s] = torch.cuda.Event()
                freed[s].record()
            Q = torch.cat(parts).cpu().numpy()
        out["wall"] = time.perf_counter() - t_s
        out["copy_ms"] = cuda_ms(
            lambda: slots[0].copy_(host[:BATCH], non_blocking=True), 5)
    finally:
        t_s = time.perf_counter()
        err = int(cudart.cudaHostUnregister(host.data_ptr()))
        out["unregister"] = time.perf_counter() - t_s
    if err:
        raise RuntimeError(f"cudaHostUnregister failed: error {err}")
    if not np.array_equal(Q, Q_want):
        raise AssertionError("(b)'s Q differs from the staged infer_q's")
    return out


def phase_cli_infer():
    t = phase("5. CLI: infer on the demo BED, card vs CPU")
    from neural_admixture_tpu_torch.io.bed import read_bed_dims
    n_demo, m_demo = read_bed_dims(DEMO_BED)
    m_pad_demo = -(-m_demo // LANE) * LANE
    rng = np.random.default_rng(SEED + 1)
    demo_params = random_params(rng, m_demo, m_pad_demo, 8, 1024, [7])
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(demo_params, "smoke", d)
        save_config("smoke", d, ks=[7], num_features=m_pad_demo,
                    hidden_size=1024, num_snps=m_demo)
        qs = {}
        for tag, gpus in (("gpu", "1"), ("cpu", "0")):
            t_cli = time.perf_counter()
            subprocess.run(
                [sys.executable, "-m", "neural_admixture_tpu_torch.entry",
                 "infer", "--name", "smoke", "--save_dir", d, "--data_path",
                 DEMO_BED, "--out_name", tag, "--num_gpus", gpus],
                cwd=REPO, check=True, stdout=subprocess.DEVNULL)
            qs[tag] = np.loadtxt(os.path.join(d, f"{tag}.7.Q"))
            print(f"   infer --num_gpus {gpus}: "
                  f"{time.perf_counter() - t_cli:.1f} s")
    for tag, q in qs.items():
        if q.shape != (n_demo, 7) or not np.allclose(q.sum(1), 1.0,
                                                     atol=1e-5):
            raise AssertionError(f"{tag} Q: shape {q.shape} or row sums off")
    dq = np.abs(qs["gpu"] - qs["cpu"]).max()
    if not np.allclose(qs["gpu"], qs["cpu"], rtol=2e-5, atol=2e-6):
        raise AssertionError(f"card vs CPU Q: max|d| {dq:.3e}")
    print(f"   .7.Q ({n_demo}, 7), card vs CPU max|d| {dq:.3e} "
          "(tolerance rtol 2e-5, atol 2e-6)")
    done(t)



def bound(n_bytes, n_ops):
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of the bytes over the HBM rate and the operations over the
    peak rate of their type (``n_ops``: {type: count}; the times of the
    types added), from the H100 SXM data sheet."""
    t_b = n_bytes / HBM_BYTES_PER_S
    t_o = sum(n / PEAK_OPS_PER_S[kind] for kind, n in n_ops.items())
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def ops_text(n_ops):
    return ", ".join(f"{n / 1e9:.2f} G {kind}" for kind, n in n_ops.items())


def assert_trajectory_close(got, want, lr, rtol=5e-3, atol=5e-4,
                            outlier_frac=0.005):
    """A copy of tests/conftest.py's rule for two training runs of
    different programs (that file imports JAX): every element within
    10 * lr, at most 0.5% of them outside rtol/atol (Adam maps near-zero
    gradients to +-lr whatever their rounding)."""
    d = np.abs(np.asarray(got) - np.asarray(want))
    if d.max() > 10 * lr:
        raise AssertionError(f"max|d| {d.max():.3e} > {10 * lr:.1e}")
    frac = (d > rtol * np.abs(want) + atol).mean()
    if frac > outlier_frac:
        raise AssertionError(f"{frac:.2%} of elements outside rtol {rtol} "
                             f"(max|d| {d.max():.3e})")
    return d.max(), frac


def demo_gates(Q, P):
    """tests/test_train_demo.py's measures against demo/expected/: matched
    Q correlations (mean, second smallest) and P correlations (mean,
    smallest), columns matched by the Hungarian method."""
    from scipy.optimize import linear_sum_assignment
    Q_ref = np.genfromtxt(DEMO_Q_EXPECTED)
    P_ref = np.genfromtxt(DEMO_P_EXPECTED)
    K = Q.shape[1]
    corr = np.array([[np.corrcoef(Q[:, i], Q_ref[:, j])[0, 1]
                      for j in range(K)] for i in range(K)])
    rows, cols = linear_sum_assignment(-np.nan_to_num(corr))
    perm = np.empty(K, dtype=int)
    perm[cols] = rows
    q_corr = corr[rows, cols]
    p_corr = [np.corrcoef(P[:, perm[j]], P_ref[:, j])[0, 1] for j in range(K)]
    return (np.mean(q_corr), np.sort(q_corr)[1], np.mean(p_corr),
            np.min(p_corr))


def kernel_entry(name, source, replaces, launches, err, ms, plain_ms,
                 n_bytes, n_ops):
    """One kernel's entry of the ``kernels`` line; ``replaces`` is a line of
    the JAX package's ops/fused_step.py."""
    bound_ms, bound_by = bound(n_bytes, n_ops)
    print(f"   {name}: {ms:.4f} ms per call at B={TRAIN_BATCH} (bound "
          f"{bound_ms:.4f} ms by {bound_by}: {n_bytes / 1e6:.1f} MB, "
          f"{ops_text(n_ops)}; {100 * bound_ms / ms:.1f}% of it), "
          f"plain {plain_ms:.3f} ms, max|d| vs plain {err:.3e}, "
          f"{launches} launches on the training path")
    return {"name": name, "route": "cuda",
            "source": f"neural_admixture_tpu_torch/csrc/{source}",
            "replaces": f"{FSP}:{replaces}",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def phase_train(dev, packed):
    """The main path of training at full width: RSVD -> PCA -> GMM ->
    2 epochs (epoch 0 logged: K4; epoch 1 not: K3) -> Q pass -> LL."""
    t = phase("6. full width: train (RSVD, GMM, 2 epochs, Q pass, LL)")
    m_pad = packed.shape[1] * 4
    W = m_pad // 4
    k, B = K_FULL, TRAIN_BATCH
    setup = {}
    t_s = time.perf_counter()
    packed_dev = torch.from_numpy(packed).to(dev)
    V = rsvd(packed_dev, N_FULL, M_FULL, D_FULL, SEED)
    setup["RSVD"] = time.perf_counter() - t_s
    t_s = time.perf_counter()
    x_pca = project_pca(packed_dev, V, N_FULL)
    torch.cuda.synchronize()
    setup["PCA"] = time.perf_counter() - t_s
    t_s = time.perf_counter()
    P_init = init_p_unsupervised(packed_dev, V, N_FULL, M_FULL, [k], SEED,
                                 x_pca=x_pca)
    setup["GMM"] = time.perf_counter() - t_s
    del packed_dev

    # Step 0 as the trainer will draw it (utils/seeding.py streams): its
    # initial parameters and the first full batch of epoch 0.
    _, nb, _, n_rows = block_geometry(N_FULL, B, BLOCK)
    init = qp.init_params(generator(SEED, 0), V.T, P_init, H_FULL, [k],
                          m_pad)
    idx_full, _ = epoch_plan(generator(SEED, 1, 0), N_FULL, B, BLOCK, n_rows)
    row_order = np.random.default_rng(SEED).permutation(N_FULL)
    rows = (idx_full[0][:, None] * BLOCK + np.arange(BLOCK)).ravel()
    xb = torch.from_numpy(packed[row_order[rows]]).to(dev)
    no_missing = not packed_has_missing(packed)
    model = qp.params_from_numpy(init, [k], dev)
    cm = (torch.arange(m_pad, device=dev) < M_FULL).to(torch.float32)
    rw = torch.ones(B, device=dev)
    loss_k, _ = fused_training_loss(model, xb, cm, rw, False, no_missing,
                                    True)
    with torch.no_grad():
        X = unpack_dosage(xb)
        recs, _ = model.forward_train(X)
        loss_t = clamped_bce_sum(recs[f"k{k}"], X, cm, rw)
        del X, recs
        rel = abs(loss_k.item() - loss_t.item()) / abs(loss_t.item())
        if rel > 1e-5:
            raise AssertionError(f"step-0 loss: kernels {loss_k.item()} vs "
                                 f"plain {loss_t.item()} (rel {rel:.2e})")
        print(f"   step-0 loss: kernels {loss_k.item():.6e}, plain autograd "
              f"{loss_t.item():.6e}, rel {rel:.2e} (tolerance 1e-5)")

        # Each kernel at the training batch, against its plain version (the
        # tolerances of phase 3), then timed.
        V_d, P = model.V.detach(), model.decoders[f"k{k}"].detach()
        q = model.encode_from_xp(xv(xb, V_d, no_missing))[f"k{k}"]
        dXp = torch.from_numpy(np.random.default_rng(SEED).normal(
            size=(B, D_FULL)).astype(np.float32)).to(dev)
        errs = {"xv": check_xv(xb, V_d, no_missing)[0],
                "dq_dp": check_dq_dp(xb, q, P, cm, rw, 1.0, False,
                                     no_missing, False),
                "loss_dq_dp": check_dq_dp(xb, q, P, cm, rw, 1.0, False,
                                          no_missing, True),
                "dv": check_dv(xb, dXp, no_missing)[0]}
        runs = {
            "xv": (lambda: (xv(xb, V_d, no_missing),),
                   lambda: (xv_plain(xb, V_d),)),
            "dq_dp": (lambda: dq_dp(xb, q, P, cm, rw, 1.0, False,
                                    no_missing)[:2],
                      lambda: dq_dp_plain(xb, q, P, cm, rw, 1.0, False)[:2]),
            "loss_dq_dp": (lambda: dq_dp(xb, q, P, cm, rw, 1.0, False,
                                         no_missing, True),
                           lambda: dq_dp_plain(xb, q, P, cm, rw, 1.0, False,
                                               True)),
            "dv": (lambda: (dv(xb, dXp, no_missing),),
                   lambda: (dv_plain(xb, dXp),)),
        }
        timing = {name: (errs[name], cuda_ms(kern, 20), cuda_ms(plain, 3))
                  for name, (kern, plain) in runs.items()}
        del model, loss_k, loss_t

    reset_counts()
    cfg = TrainConfig(epochs=TRAIN_EPOCHS, batch_size=B, seed=SEED,
                      hidden_size=H_FULL, n_components=D_FULL, ks=[k],
                      progress=False, sample_block=BLOCK, device=str(dev))
    trainer = NeuralAdmixtureTrainer(cfg)
    torch.cuda.synchronize()
    t_s = time.perf_counter()
    Qs, Ps, params = trainer.launch_training(P_init, packed, V, M_FULL,
                                             N_FULL)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_s
    counts = read_counts()
    want = expected_counts("default", nb, 1, -(-N_FULL // 1024))
    if counts != want:
        raise AssertionError(f"launches on the training path {counts}, "
                             f"expected {want}")
    t_s = time.perf_counter()
    ll = loglikelihood_packed(packed, M_FULL, Ps[0], Qs[0],
                              device_threshold=0, device=dev)
    setup["LL"] = time.perf_counter() - t_s
    Q, P_out = Qs[0], Ps[0]
    if Q.shape != (N_FULL, k) or not np.isfinite(Q).all() or \
            not np.allclose(Q.sum(1), 1.0, atol=1e-5):
        raise AssertionError(f"bad Q: shape {Q.shape}")
    if P_out.min() < 0 or P_out.max() > 1:
        raise AssertionError("P outside [0, 1]")
    if np.any(params["decoders"][f"k{k}"][:, M_FULL:] != 0):
        raise AssertionError("padded P columns moved off 0")
    if not np.isfinite(ll):
        raise AssertionError(f"log-likelihood {ll}")
    steps = ", ".join(f"epoch {e}: {1e3 * s:.1f} ms ({1e3 * s / nb:.2f} ms "
                      "per step)" for e, s in enumerate(trainer.epoch_seconds))
    print(f"   N={N_FULL} M={M_FULL} m_pad={m_pad} K={k} D={D_FULL} "
          f"H={H_FULL} batch {B} (+ remainder), sample_block {BLOCK}: "
          f"{nb} steps per epoch; launches "
          + ", ".join(f"{n} {c}" for n, c in counts.items() if c))
    rate = N_FULL * TRAIN_EPOCHS / trainer.train_seconds
    print(f"   epoch walls: {steps}; train {rate:,.0f} samples/s "
          f"({trainer.train_seconds:.3f} s for {TRAIN_EPOCHS} epochs); "
          f"launch_training wall {wall:.3f} s")
    print(f"   logged loss (epoch 0) {trainer.logged_losses[0]:.6e}; "
          f"log-likelihood {ll:.6e}; padded P columns exactly 0")
    print("   set-up, host clock: " + ", ".join(
        f"{n} {s:.3f} s" for n, s in setup.items()))
    print("   launch_training around the epochs, host clock: " + ", ".join(
        f"{n} {s:.3f} s" for n, s in trainer.phase_seconds.items()))

    shapes = work_shapes(B, W, k)
    kernels = []
    for name in ("xv", "dq_dp", "loss_dq_dp", "dv"):
        err, ms, plain_ms = timing[name]
        kernels.append(kernel_entry(name, *shapes[name][:2], counts[name],
                                    err, ms, plain_ms, *shapes[name][2:]))
    done(t)
    return kernels, {"V": V, "P_init": P_init, "x_pca": x_pca,
                     "setup": setup, "run": (Qs, Ps, params),
                     "trainer": trainer, "ll": ll}


def work_shapes(B, W, k, D=D_FULL):
    """{kernel: (source, TPU kernel line, bytes, {type: operations})} of
    one call at batch B, W packed bytes a row, k columns of q and P: each
    input read once, each output written once; an FMA counts as 2
    operations, a logarithm as 1. xv computes its products on the int8
    tensor cores, three for each (one for each int8 piece of V), dv four
    for each (one for each int8 piece of dXp); dq_dp
    computes raw = q P and dq = draw P^T on the tensor cores in 3xTF32
    (three TF32 products for each), dP = q^T draw and the logarithms on
    the CUDA cores in fp32; bce_sum computes raw as dq_dp does, and its
    work counts the two logarithms of the loss term whatever the kernel
    spends on them (it spends one)."""
    m_pad = 4 * W
    n_pk, n_p, n_q = B * W, k * m_pad * 4, B * k * 4
    product = 2 * k * B * m_pad
    return {
        "xv": ("xv.cu", 99, n_pk + m_pad * D * 4 + B * D * 4,
               {"int8": 3 * 2 * B * m_pad * D}),
        "dq_dp": ("dq_dp.cu", 168, n_pk + 2 * n_p + 2 * n_q,
                  {"tf32": 2 * 3 * product, "fp32": product}),
        "loss_dq_dp": ("dq_dp.cu", 247, n_pk + 2 * n_p + 2 * n_q + 4,
                       {"tf32": 2 * 3 * product,
                        "fp32": product + 2 * B * m_pad}),
        "dv": ("dv.cu", 319, n_pk + B * D * 4 + m_pad * D * 4,
               {"int8": 4 * 2 * B * m_pad * D}),
        "bce_sum": ("bce_sum.cu", 136, n_pk + n_p + n_q + 4,
                    {"tf32": 3 * product, "fp32": 2 * B * m_pad}),
    }


def heads_bound(B, W, ks, name):
    """bound() of one launch of kernel ``name`` for each head k of ``ks``."""
    parts = [work_shapes(B, W, k)[name] for k in ks]
    n_ops = {}
    for part in parts:
        for kind, n in part[3].items():
            n_ops[kind] = n_ops.get(kind, 0) + n
    return bound(sum(part[2] for part in parts), n_ops)


COUNTERS = {  # entry of the kernels line -> (wrapper, counter)
    "xv": (xv, "launches"), "dq_dp": (dq_dp, "launches"),
    "loss_dq_dp": (dq_dp, "loss_launches"), "dv": (dv, "launches"),
    "bce_sum": (bce_sum, "launches"),
    "xv_indexed": (xv, "indexed_launches"),
    "dq_dp_indexed": (dq_dp, "indexed_launches"),
    "loss_dq_dp_indexed": (dq_dp, "indexed_loss_launches"),
    "dv_indexed": (dv, "indexed_launches"),
    "bce_sum_indexed": (bce_sum, "indexed_launches"),
}


def reset_counts():
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)


def read_counts():
    return {name: getattr(fn, attr) for name, (fn, attr) in COUNTERS.items()}


def expected_counts(program, nb, n_heads, n_q):
    """Launches of a 2-epoch run (epoch 0 logged, epoch 1 not) of nb steps
    an epoch, nb - 1 full batches and one remainder, then the Q pass."""
    want = dict.fromkeys(COUNTERS, 0)
    full, rem, steps = nb - 1, 1, 2 * nb
    if program == "default":
        want.update(xv=steps + n_q, dv=steps, loss_dq_dp=nb * n_heads,
                    dq_dp=nb * n_heads)
        return want
    if program == "split":  # gathered; the logged epoch's K4 is K6 + K3
        want.update(xv=steps + n_q, dv=steps, bce_sum=nb * n_heads,
                    dq_dp=2 * nb * n_heads)
        return want
    want.update(xv=2 * rem + n_q, xv_indexed=2 * full, dv=2 * rem,
                dv_indexed=2 * full)
    if program == "indexed":
        want.update(loss_dq_dp=rem * n_heads,
                    loss_dq_dp_indexed=full * n_heads,
                    dq_dp=rem * n_heads, dq_dp_indexed=full * n_heads)
    else:  # indexed+split: the logged epoch's K4 becomes K6 + K3
        want.update(bce_sum=rem * n_heads, bce_sum_indexed=full * n_heads,
                    dq_dp=2 * rem * n_heads,
                    dq_dp_indexed=2 * full * n_heads)
    return want


def phase_multihead(dev, packed, V):
    """Full-width multi-head training, K = 2..10: three 2-epoch runs of
    launch_training from the same initial parameters and plans, one per
    program choice; then every indexed form, bce_sum and the gather the
    indexed form saves, timed at batch 800."""
    t = phase("6b. full width, multi-head K = 2..10: default, indexed, "
              "indexed + split programs")
    m_pad = packed.shape[1] * 4
    W = m_pad // 4
    B, ks = TRAIN_BATCH, KS_SWEEP
    t_s = time.perf_counter()
    packed_dev = torch.from_numpy(packed).to(dev)
    P_init = init_p_unsupervised(packed_dev, V, N_FULL, M_FULL, ks, SEED)
    del packed_dev
    print(f"   P init, {len(ks)} GMM fits (host) and the projection: "
          f"{time.perf_counter() - t_s:.3f} s")
    _, nb, _, n_rows = block_geometry(N_FULL, B, BLOCK)
    init = qp.init_params(generator(SEED, 0), V.T, P_init, H_FULL, ks, m_pad)
    plan_list = [epoch_plan(generator(SEED, 1, e), N_FULL, B, BLOCK, n_rows)
                 for e in range(TRAIN_EPOCHS)]
    n_q = -(-N_FULL // 1024)
    runs = {}
    for program, env in PROGRAMS.items():
        for var in PROGRAM_VARS:
            os.environ.pop(var, None)
        os.environ.update(env)
        cfg = TrainConfig(epochs=TRAIN_EPOCHS, batch_size=B, seed=SEED,
                          hidden_size=H_FULL, n_components=D_FULL, ks=ks,
                          progress=False, sample_block=BLOCK,
                          device=str(dev))
        trainer = NeuralAdmixtureTrainer(cfg)
        reset_counts()
        torch.cuda.synchronize()
        t_s = time.perf_counter()
        Qs, Ps, params = trainer.launch_training(
            P_init, packed, V, M_FULL, N_FULL, init_params=init,
            plans=lambda e: plan_list[e])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_s
        counts = read_counts()
        for var in PROGRAM_VARS:
            os.environ.pop(var, None)
        want = expected_counts(program, nb, len(ks), n_q)
        if counts != want:
            raise AssertionError(f"{program}: launches {counts}, expected "
                                 f"{want}")
        for i, k in enumerate(ks):
            if Qs[i].shape != (N_FULL, k) or not np.isfinite(Qs[i]).all() \
                    or not np.allclose(Qs[i].sum(1), 1.0, atol=1e-5):
                raise AssertionError(f"{program}: bad Q for K={k}")
            if Ps[i].min() < 0 or Ps[i].max() > 1 or \
                    np.any(params["decoders"][f"k{k}"][:, M_FULL:] != 0):
                raise AssertionError(f"{program}: bad P for K={k}")
        runs[program] = (Qs, Ps, params, trainer.logged_losses[0])
        e0, e1 = trainer.epoch_seconds
        print(f"   {program}: launches "
              + ", ".join(f"{n} {c}" for n, c in counts.items() if c)
              + f" (as expected); epoch walls {1e3 * e0:.1f} ms (logged), "
              f"{1e3 * e1:.1f} ms ({1e3 * e1 / nb:.2f} ms a step); "
              f"{N_FULL * TRAIN_EPOCHS / trainer.train_seconds:,.0f} train "
              f"samples/s over {TRAIN_EPOCHS} epochs, "
              f"{N_FULL / e1:,.0f} in epoch 1; launch_training wall "
              f"{wall:.3f} s; logged loss {trainer.logged_losses[0]:.6e}")
        runs[program] += (counts,)

    def flat(run):
        Qs, Ps, params = run[:3]
        leaves = {f"Q{k}": q for k, q in zip(ks, Qs)}
        leaves.update({f"P{k}": p for k, p in zip(ks, Ps)})
        leaves["V"] = params["V"]
        leaves.update({f"{hk}/{n}": a for hk, d in params["heads"].items()
                       for n, a in d.items()})
        leaves.update({f"common/{n}": a for n, a in params["common"].items()})
        leaves["rmsnorm"] = params["rmsnorm"]["weight"]
        return leaves

    ref = flat(runs["default"])
    for program in ("indexed", "indexed+split"):
        got = flat(runs[program])
        d_max = max(float(np.abs(got[n] - ref[n]).max()) for n in ref)
        equal = all(np.array_equal(got[n], ref[n]) for n in ref)
        for n in ref:
            assert_trajectory_close(got[n], ref[n], lr=2e-3)
        rel = abs(runs[program][3] - runs["default"][3]) / \
            abs(runs["default"][3])
        if rel > 1e-5:
            raise AssertionError(f"{program}: logged loss rel {rel:.2e}")
        print(f"   {program} vs default: every parameter, Q and P max|d| "
              f"{d_max:.3e} (bit-equal: {equal}; trajectory rule met); "
              f"logged loss rel {rel:.2e} (tolerance 1e-5)")

    # Timing at the training batch: the first full batch of epoch 0 from
    # the trainer's resident layout, K = 8's head and all nine.
    row_order = np.random.default_rng(SEED).permutation(N_FULL)
    resident = torch.from_numpy(packed[row_order]).to(dev)
    blk_idx = torch.from_numpy(plan_list[0][0][0].astype(np.int32)).to(dev)
    ix = {"blk_idx": blk_idx, "blk": BLOCK}
    rows = batch_rows(blk_idx, BLOCK)
    xb = resident.index_select(0, rows)
    no_missing = not packed_has_missing(packed)
    model = qp.params_from_numpy(init, ks, dev)
    cm = (torch.arange(m_pad, device=dev) < M_FULL).to(torch.float32)
    rw = torch.ones(B, device=dev)
    dXp = torch.from_numpy(np.random.default_rng(SEED).normal(
        size=(B, D_FULL)).astype(np.float32)).to(dev)
    with torch.no_grad():
        V_d = model.V.detach()
        qs = model.encode_from_xp(xv(xb, V_d, no_missing))
        P_d = {hk: P.detach() for hk, P in model.decoders.items()}
        q8, P8 = qs["k8"], P_d["k8"]
        errs = {"bce_sum": check_bce_sum(xb, q8, P8, cm, rw, False,
                                         no_missing),
                "xv_indexed": check_xv(resident, V_d, no_missing, **ix)[0],
                "dq_dp_indexed": check_dq_dp(resident, q8, P8, cm, rw, 1.0,
                                             False, no_missing, False, **ix),
                "loss_dq_dp_indexed": check_dq_dp(resident, q8, P8, cm, rw,
                                                  1.0, False, no_missing,
                                                  True, **ix),
                "dv_indexed": check_dv(resident, dXp, no_missing,
                                       **ix)[0],
                "bce_sum_indexed": check_bce_sum(resident, q8, P8, cm, rw,
                                                 False, no_missing, **ix)}
        calls = {
            "xv": lambda **a: xv(a.pop("p"), V_d, no_missing, **a),
            "dq_dp": lambda **a: dq_dp(a.pop("p"), q8, P8, cm, rw, 1.0,
                                       False, no_missing, **a),
            "loss_dq_dp": lambda **a: dq_dp(a.pop("p"), q8, P8, cm, rw, 1.0,
                                            False, no_missing, True, **a),
            "dv": lambda **a: dv(a.pop("p"), dXp, no_missing, **a),
            "bce_sum": lambda **a: bce_sum(a.pop("p"), q8, P8, cm, rw, False,
                                           no_missing, **a),
        }
        plains = {
            "xv": lambda **a: xv_plain(resident, V_d, **a),
            "dq_dp": lambda **a: dq_dp_plain(resident, q8, P8, cm, rw, 1.0,
                                             False, **a),
            "loss_dq_dp": lambda **a: dq_dp_plain(resident, q8, P8, cm, rw,
                                                  1.0, False, True, **a),
            "dv": lambda **a: dv_plain(resident, dXp, **a),
            "bce_sum": lambda **a: bce_sum_plain(resident, q8, P8, cm, rw,
                                                 False, **a),
        }
        timing = {}
        for name, fn in calls.items():
            gathered = cuda_ms(lambda: fn(p=xb), 20)
            indexed = cuda_ms(lambda: fn(p=resident, **ix), 20)
            timing[name + "_indexed"] = (indexed,
                                         cuda_ms(lambda: plains[name](**ix),
                                                 3))
            print(f"   {name} at K = 8, B = {B}: gathered {gathered:.4f} ms, "
                  f"indexed {indexed:.4f} ms")
            if name == "bce_sum":
                timing[name] = (gathered,
                                cuda_ms(lambda: bce_sum_plain(
                                    xb, q8, P8, cm, rw, False), 3))
        gather_ms = cuda_ms(lambda: resident.index_select(0, rows), 20)
        heads9 = cuda_ms(lambda: [bce_sum(xb, qs[hk], P_d[hk], cm, rw, False,
                                          no_missing) for hk in qs], 20)
        dq9 = cuda_ms(lambda: [dq_dp(xb, qs[hk], P_d[hk], cm, rw, 1.0, False,
                                     no_missing) for hk in qs], 10)
        loss9 = cuda_ms(lambda: [dq_dp(xb, qs[hk], P_d[hk], cm, rw, 1.0,
                                       False, no_missing, True)
                                 for hk in qs], 10)
        per_head = {hk: (cuda_ms(lambda: dq_dp(xb, qs[hk], P_d[hk], cm, rw,
                                               1.0, False, no_missing), 10),
                         cuda_ms(lambda: dq_dp(xb, qs[hk], P_d[hk], cm, rw,
                                               1.0, False, no_missing, True),
                                 10))
                    for hk in qs}
    b9, b3, b4 = (heads_bound(B, W, ks, name)
                  for name in ("bce_sum", "dq_dp", "loss_dq_dp"))
    gb = bound(2 * B * W, {})
    print(f"   the gather the indexed form saves (index_select of {B} rows, "
          f"{B * W / 1e6:.1f} MB read and written): {gather_ms:.4f} ms "
          f"(bound {gb[0]:.4f} ms by bytes)")
    print("   per head, B = 800, ms: " + ", ".join(
        f"{hk} dq_dp {a:.4f} / loss_dq_dp {b:.4f}"
        for hk, (a, b) in per_head.items()))
    print(f"   over the 9 heads (one launch each), B = {B}: bce_sum "
          f"{heads9:.4f} ms (bound {b9[0]:.4f} ms by {b9[1]}), dq_dp "
          f"{dq9:.4f} ms (bound {b3[0]:.4f}), loss_dq_dp {loss9:.4f} ms "
          f"(bound {b4[0]:.4f})")
    del resident, xb, model
    shapes = work_shapes(B, W, 8)
    kernels = []
    totals = {n: sum(run[4][n] for run in runs.values()) for n in COUNTERS}
    for name in ("bce_sum", "xv_indexed", "dq_dp_indexed",
                 "loss_dq_dp_indexed", "dv_indexed", "bce_sum_indexed"):
        base = name.replace("_indexed", "")
        src, line, n_bytes, n_ops = shapes[base]
        ms, plain_ms = timing[name]
        kernels.append(kernel_entry(
            name, src, 579 if name.endswith("_indexed") else line,
            totals[name], errs[name], ms, plain_ms, n_bytes, n_ops))
    done(t)
    return kernels


def add_launches(kernels, counts):
    """Add a later path's launches (``counts``: kernels-line name -> n) to
    the entries of the ``kernels`` line."""
    for entry in kernels:
        entry["launches"] += counts.get(entry["name"], 0)


def same_run(a, b):
    """Are two launch_training results (Qs, Ps, params) equal bit for
    bit?"""
    from neural_admixture_tpu_torch.io.writers import _flatten
    return all(np.array_equal(x, y) for x, y in zip(a[0] + a[1],
                                                    b[0] + b[1])) and all(
        np.array_equal(x, _flatten(b[2])[n])
        for n, x in _flatten(a[2]).items())


def phase_stream(dev, packed, trained):
    """Host-streamed training at full width (phase 4's rows, phase 6's V,
    P init and resident run, K = 8, batch 800, sample_block 16): 2-epoch
    streamed runs bit-equal to resident ones on the default and the split
    program, the split of a step into the host gather, the copy and the
    compute, a run resumed from a checkpoint bit-equal to an uninterrupted
    one, and the streamed RSVD and PCA projection bit-equal to the
    resident ones. Returns the streamed runs' launches."""
    t = phase("6c. full width: streamed training, checkpoint/resume")
    from neural_admixture_tpu_torch.train.engine import INFER_BATCH
    W = packed.shape[1]
    m_pad, k, B = 4 * W, K_FULL, TRAIN_BATCH
    _, nb, _, n_rows = block_geometry(N_FULL, B, BLOCK)
    n_q = -(-N_FULL // INFER_BATCH)
    V, P_init = trained["V"], trained["P_init"]
    streamed_counts = dict.fromkeys(COUNTERS, 0)

    def train(epochs, program, stream, **kw):
        os.environ.update(PROGRAMS_K8[program])
        cfg = TrainConfig(epochs=epochs, batch_size=B, seed=SEED,
                          hidden_size=H_FULL, n_components=D_FULL, ks=[k],
                          progress=False, sample_block=BLOCK,
                          device=str(dev), stream=stream, **kw)
        trainer = NeuralAdmixtureTrainer(cfg)
        reset_counts()
        torch.cuda.synchronize()
        t_s = time.perf_counter()
        out = trainer.launch_training(P_init, packed, V, M_FULL, N_FULL)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_s
        counts = read_counts()
        for var in PROGRAM_VARS:
            os.environ.pop(var, None)
        if trainer._streamed != stream:
            raise AssertionError(f"asked stream={stream}, ran "
                                 f"{trainer._streamed}")
        if stream:
            for n, c in counts.items():
                streamed_counts[n] += c
        return out, trainer, counts, wall

    def rate(trainer):
        return N_FULL * len(trainer.epoch_seconds) / trainer.train_seconds

    # Streamed against resident, 2 epochs: the default program against
    # phase 6's resident run, the split program against its own.
    runs = {}
    for program, resident in (("default", (trained["run"],
                                           trained["trainer"])),
                              ("split", None)):
        if resident is None:
            out, tr, _, _ = train(TRAIN_EPOCHS, program, False)
            resident = (out, tr)
        out, tr, counts, wall = train(TRAIN_EPOCHS, program, True)
        want = expected_counts(program, nb, 1, n_q)
        if counts != want:
            raise AssertionError(f"streamed {program}: launches {counts}, "
                                 f"expected {want}")
        if not same_run(out, resident[0]):
            raise AssertionError(f"streamed {program} run differs from the "
                                 "resident one")
        runs[program] = (tr, resident[1])
        e_s, e_r = tr.epoch_seconds[1], resident[1].epoch_seconds[1]
        print(f"   {program} program: streamed = resident bit for bit "
              f"(Q, P, every parameter); launches "
              + ", ".join(f"{n} {c}" for n, c in counts.items() if c)
              + f" (as expected); epoch 1 streamed {1e3 * e_s:.1f} ms "
              f"({1e3 * e_s / nb:.2f} ms a step, {N_FULL / e_s:,.0f} "
              f"samples/s), resident {1e3 * e_r:.1f} ms ({1e3 * e_r / nb:.2f} "
              f"ms a step, {N_FULL / e_r:,.0f} samples/s); over "
              f"{TRAIN_EPOCHS} epochs streamed {rate(tr):,.0f} samples/s, "
              f"resident {rate(resident[1]):,.0f}; "
              f"launch_training wall {wall:.3f} s; the stager's gathers "
              f"{1e3 * tr.stager.gather_seconds:.1f} ms for "
              f"{tr.stager.bytes_gathered / 1e9:.2f} GB")

    # The other prefetch levels (the default on the card is 2), default
    # program: the same run, epoch 1's wall.
    for level in ("1", "0"):
        os.environ["NA_TPU_STREAM_PREFETCH"] = level
        try:
            out, tr, _, _ = train(TRAIN_EPOCHS, "default", True)
        finally:
            del os.environ["NA_TPU_STREAM_PREFETCH"]
        if tr.stager.prefetch != int(level) or \
                not same_run(out, trained["run"]):
            raise AssertionError(f"NA_TPU_STREAM_PREFETCH={level}: run "
                                 "differs from the resident one")
        e_s = tr.epoch_seconds[1]
        print(f"   NA_TPU_STREAM_PREFETCH={level}, default program: "
              f"streamed = resident bit for bit; epoch 1 {1e3 * e_s:.1f} ms "
              f"({1e3 * e_s / nb:.2f} ms a step, {N_FULL / e_s:,.0f} "
              "samples/s)")

    # A streamed step's parts at epoch 1: the host gather of its rows
    # through the pre-shuffle (host clock), the pinned copy and a resident
    # unlogged step (CUDA events).
    row_order = np.random.default_rng(SEED).permutation(N_FULL)
    host_row = np.concatenate([row_order, np.full(n_rows - N_FULL, -1)])
    idx_full, idx_rem = epoch_plan(generator(SEED, 1, 1), N_FULL, B, BLOCK,
                                   n_rows)
    jobs = [host_row[np.minimum((np.asarray(i)[:, None] * BLOCK
                                 + np.arange(BLOCK)).ravel(), n_rows - 1)]
            for i in list(idx_full) + [idx_rem]]
    stager = HostStager(dev, B, W, prefetch=1)  # a whole batch a slot
    pinned = stager._host[0]
    t_s = time.perf_counter()
    for job in jobs:
        stager._gather(packed, job, 0)
    gather_ms = 1e3 * (time.perf_counter() - t_s) / len(jobs)
    dev_buf = torch.empty((B, W), dtype=torch.uint8, device=dev)
    copy_ms = cuda_ms(lambda: dev_buf.copy_(pinned, non_blocking=True), 10)
    stager.close()
    dev_buf.copy_(torch.from_numpy(packed[row_order[:B]]))
    init = qp.init_params(generator(SEED, 0), V.T, P_init, H_FULL, [k],
                          m_pad)
    model = qp.params_from_numpy(init, [k], dev)
    cm = (torch.arange(m_pad, device=dev) < M_FULL).to(torch.float32)
    no_missing = not packed_has_missing(packed)
    compute_ms = cuda_ms(step_fn(model, dev_buf, cm,
                                 torch.ones(B, device=dev), no_missing), 10)
    del dev_buf, pinned, model
    print(f"   a streamed step at epoch 1, ms: host gather {gather_ms:.3f} "
          f"(host clock, {B} rows through the pre-shuffle, "
          f"{stager.gather_threads} threads; "
          f"{B * W / gather_ms / 1e6:.2f} GB/s), pinned copy {copy_ms:.3f} "
          f"({B * W / copy_ms / 1e6:.2f} GB/s), compute (a resident "
          f"unlogged step) {compute_ms:.3f} (CUDA events); the stager "
          f"overlaps them, so a step takes at least "
          f"{max(gather_ms, copy_ms, compute_ms):.3f}")

    # Resume: 2 epochs with a checkpoint every epoch, resumed (streamed) to
    # 3, against 3 uninterrupted resident epochs.
    with tempfile.TemporaryDirectory() as d:
        ck = os.path.join(d, "smoke_ckpt.npz")
        full, _, _, _ = train(3, "default", False)
        _, first, _, _ = train(2, "default", False, checkpoint_every=1,
                               checkpoint_path=ck)
        size = os.path.getsize(ck)
        with np.load(ck) as f:
            if bytes(f["format"]).decode() != CKPT_FORMAT or \
                    int(f["epoch"]) != 2:
                raise AssertionError("checkpoint format or epoch")
        resumed, second, counts, _ = train(3, "default", True,
                                           checkpoint_every=1,
                                           checkpoint_path=ck, resume=True)
    if not same_run(resumed, full):
        raise AssertionError("resumed run differs from the uninterrupted one")
    print(f"   resume: 2 resident epochs, checkpoint every epoch, resumed "
          f"streamed to 3 = 3 uninterrupted resident epochs bit for bit; "
          f"checkpoint {size / 1e6:.1f} MB, save "
          f"{first.phase_seconds['save']:.3f} s, load "
          f"{second.phase_seconds['load']:.3f} s (host clock); "
          f"the resumed epoch's launches "
          + ", ".join(f"{n} {c}" for n, c in counts.items() if c))

    # The streamed set-up against phase 6's resident one.
    t_s = time.perf_counter()
    V_s = rsvd(packed, N_FULL, M_FULL, D_FULL, SEED, device=dev, stream=True)
    rsvd_s = time.perf_counter() - t_s
    if not np.array_equal(V_s, V):
        raise AssertionError("streamed RSVD differs from the resident one")
    t_s = time.perf_counter()
    x_s = project_pca(packed, V, N_FULL, device=dev, stream=True)
    torch.cuda.synchronize()
    pca_s = time.perf_counter() - t_s
    if not torch.equal(x_s, trained["x_pca"]):
        raise AssertionError("streamed PCA projection differs from the "
                             "resident one")
    setup = trained["setup"]
    print(f"   streamed set-up = resident bit for bit: RSVD {rsvd_s:.3f} s "
          f"(resident {setup['RSVD']:.3f} s), PCA projection {pca_s:.3f} s "
          f"(resident {setup['PCA']:.3f} s), host clock")
    done(t)
    return streamed_counts


# Phase 6d's grids of ranks on the one card, over gloo (NCCL refuses two
# ranks on one device): (data, snp).
GRID_SHAPES = ((2, 1), (2, 2))
# The collectives of a training step, in the order a step calls them.
GRID_LABELS = ("exchange", "xp_snp", "dxp_snp", "grad_data", "grad_world")


def grid_rank(grid, packed_path, V, P_init, infer_params, with_rsvd):
    """One rank of phase 6d (a module-level function: ranks start with
    ``spawn``): its data row's rows of phase 4's matrix, optionally the
    ``rows=`` RSVD, 2 epochs of training with the grid's profile on and
    the launches counted, and optionally the sharded infer_q with phase
    4's weights. Returns what the phase checks and prints."""
    from neural_admixture_tpu_torch.infer import infer_q_mesh
    from neural_admixture_tpu_torch.utils.logger import log
    log.setLevel("WARNING")  # the trainer's log lines, once per rank
    packed = np.load(packed_path, mmap_mode="r")
    cfg = TrainConfig(epochs=TRAIN_EPOCHS, batch_size=TRAIN_BATCH, seed=SEED,
                      hidden_size=H_FULL, n_components=D_FULL, ks=[K_FULL],
                      progress=False, sample_block=BLOCK,
                      device=str(grid.device))
    trainer = NeuralAdmixtureTrainer(cfg, grid=grid)
    start, end, _ = trainer.sample_shard(packed.shape[1] * 4, N_FULL)
    local = np.array(packed[start:end])  # a writable copy of the mmap
    out = {"at": (grid.d, grid.s), "rows": (start, end)}
    if with_rsvd:
        torch.cuda.synchronize()
        t_s = time.perf_counter()
        out["V"] = rsvd(torch.from_numpy(local).to(grid.device), N_FULL,
                        M_FULL, D_FULL, SEED, rows=(start, end), grid=grid)
        out["rsvd_s"] = time.perf_counter() - t_s
    reset_counts()
    grid.start_profile()
    Qs, Ps, _ = trainer.launch_training(P_init, local, V, M_FULL, N_FULL,
                                        host_rows=(start, end))
    grid.stop_profile()
    out["counts"] = read_counts()
    out["profiles"] = trainer.epoch_profiles
    out["epoch_s"] = trainer.epoch_seconds
    out["loss"] = trainer.logged_losses[0]
    out["Q"] = Qs[0]
    if grid.rank == 0:
        out["P"] = Ps[0]
    if infer_params is not None:
        reset_counts()
        out["infer_Q"] = infer_q_mesh(infer_params, local, N_FULL, [K_FULL],
                                      BATCH, grid)[0]
        out["infer_counts"] = read_counts()
    return out


def print_grid_steps(tag, results, nb, how):
    """Each rank's warm step (epoch 1's steps averaged): wall (host clock),
    compute between collectives (CUDA events) and each collective (host
    clock, bytes off the rank)."""
    for r in results:
        prof = r["profiles"][1]
        parts = ", ".join(
            f"{lab} {1e3 * prof.seconds[lab] / nb:.3f} ms"
            + (f" ({prof.bytes[lab] / nb / 1e6:.2f} MB)"
               if prof.bytes.get(lab) else "")
            for lab in GRID_LABELS if lab in prof.seconds)
        print(f"   {tag} rank at {r['at']}: warm step "
              f"{1e3 * r['epoch_s'][1] / nb:.3f} ms: compute "
              f"{prof.compute_ms / nb:.3f} ms (CUDA events), {parts}; {how}")


def phase_grid(dev, card, packed, trained, infer_params, infer_Q):
    """Training and inference over grids of ranks at full width (phase 4's
    rows, phase 6's V and P init, K = 8, batch 800, sample_block 16, 2
    epochs): 2 x 1 and 2 x 2 grids of ranks sharing the card over gloo
    against the one-rank run emulating their layout
    (NA_TPU_EMULATE_PROC_SHARDS=2,2), exact launch counts per rank, the
    sharded infer_q (2 x 2) against phase 4's Q, the rows= RSVD (2 x 1)
    against phase 6's V; a one-rank NCCL grid against phase 6's run; two
    cards over NCCL where there are two. Returns {kernel: launches} of the
    grid runs, the per-rank counts and the 2 x 2 ranks' infer_q Qs."""
    t = phase("6d. grid: 2x1 and 2x2 gloo grids on one card, a 1-rank NCCL "
              "group")
    from neural_admixture_tpu_torch.parallel.distributed import spawn_grid
    V, P_init = trained["V"], trained["P_init"]
    W = packed.shape[1]
    _, nb, _, _ = block_geometry(N_FULL, TRAIN_BATCH, BLOCK, 2)
    torch.cuda.empty_cache()
    os.environ["NA_TPU_EMULATE_PROC_SHARDS"] = "2,2"
    try:
        ref_tr = NeuralAdmixtureTrainer(TrainConfig(
            epochs=TRAIN_EPOCHS, batch_size=TRAIN_BATCH, seed=SEED,
            hidden_size=H_FULL, n_components=D_FULL, ks=[K_FULL],
            progress=False, sample_block=BLOCK, device=str(dev)))
        ref = ref_tr.launch_training(P_init, packed, V, M_FULL, N_FULL)
    finally:
        del os.environ["NA_TPU_EMULATE_PROC_SHARDS"]
    print(f"   one rank emulating 2 data rows: epoch 1 "
          f"{1e3 * ref_tr.epoch_seconds[1] / nb:.3f} ms a step")
    totals, per_rank = {}, {}
    how = f"gloo through host memory, ranks sharing one card ({card})"
    with tempfile.TemporaryDirectory() as d:
        packed_path = os.path.join(d, "packed.npy")
        np.save(packed_path, packed)
        runs = {}
        for shape in GRID_SHAPES + ((1, 1),):
            n = shape[0] * shape[1]
            nccl = shape == (1, 1)
            t_s = time.perf_counter()
            runs[shape] = spawn_grid(
                grid_rank, *shape, devices=["cuda:0"] * n,
                backend="nccl" if nccl else "gloo",
                args=(packed_path, V, P_init,
                      infer_params if shape == (2, 2) else None,
                      shape == (2, 1)))
            print(f"   {shape[0]}x{shape[1]} "
                  f"{'NCCL' if nccl else 'gloo'}: {n} rank(s) started, ran "
                  f"and ended in {time.perf_counter() - t_s:.1f} s")
        two_cards = torch.cuda.device_count() >= 2
        if two_cards:
            runs["2x1 nccl"] = spawn_grid(
                grid_rank, 2, 1, devices=["cuda:0", "cuda:1"],
                backend="nccl",
                args=(packed_path, V, P_init, None, False))

    for key, results in runs.items():
        tag = (f"{key[0]}x{key[1]}" + (" NCCL" if key == (1, 1) else
                                        " gloo")
               if isinstance(key, tuple) else key)
        D = 1 if key == (1, 1) else 2
        n_local = N_FULL // D
        want = expected_counts("default", nb, 1, -(-n_local // BATCH))
        for r in results:
            if r["counts"] != want:
                raise AssertionError(f"{tag} rank at {r['at']}: launches "
                                     f"{r['counts']}, expected {want}")
        per_rank[tag] = [r["counts"] for r in results]
        for r in results:
            for name, c in r["counts"].items():
                totals[name] = totals.get(name, 0) + c
        if key == (1, 1):
            want_run = trained["run"]
            exact = (np.array_equal(results[0]["Q"], want_run[0][0])
                     and np.array_equal(results[0]["P"], want_run[1][0]))
        else:
            want_run = ref
            exact = None
        d_p = assert_trajectory_close(results[0]["P"], want_run[1][0],
                                      lr=2e-3)
        for r in results:
            d_q = assert_trajectory_close(r["Q"], want_run[0][0], lr=2e-3)
        print(f"   {tag}: every rank's launches as expected "
              + ", ".join(f"{n} {c}" for n, c in want.items() if c)
              + f"; logged loss {results[0]['loss']:.6e}; P max|d| "
              f"{d_p[0]:.3e}, Q max|d| {d_q[0]:.3e} against "
              + ("phase 6's one-rank run" if key == (1, 1) else
                 "the one-rank run emulating 2 data rows")
              + (f" (bit-equal: {exact})" if exact is not None else ""))
        print_grid_steps(tag, results, nb,
                         "NCCL, one rank: its collectives copy"
                         if key == (1, 1) else
                         "NCCL across two cards" if key == "2x1 nccl"
                         else how)
    if not two_cards:
        print(f"   NCCL across cards did not run: "
              f"{torch.cuda.device_count()} card on this machine")

    for r in runs[(2, 2)]:
        np.testing.assert_allclose(r["infer_Q"], infer_Q, rtol=2e-5,
                                   atol=2e-6)
        want = dict.fromkeys(COUNTERS, 0)
        want["xv"] = -(-(N_FULL // 2) // BATCH)
        if r["infer_counts"] != want:
            raise AssertionError(f"sharded infer_q launches "
                                 f"{r['infer_counts']}, expected {want}")
    d_inf = max(np.abs(r["infer_Q"] - infer_Q).max() for r in runs[(2, 2)])
    print(f"   2x2 sharded infer_q: every rank's Q within rtol 2e-5, atol "
          f"2e-6 of phase 4's (max|d| {d_inf:.3e}); {want['xv']} xv launches "
          f"a rank")
    V_one = trained["V"]
    for r in runs[(2, 1)]:
        for c in range(D_FULL):
            np.testing.assert_allclose(
                r["V"][c], V_one[c], rtol=0,
                atol=2e-4 * np.abs(V_one[c]).max(), err_msg=f"component {c}")
    d_v = max(np.abs(r["V"] - V_one).max() for r in runs[(2, 1)])
    print(f"   2x1 rows= RSVD: every rank's V within 2e-4 of each "
          f"component's largest of phase 6's (max|d| {d_v:.3e}); "
          + ", ".join(f"rank at {r['at']} {r['rsvd_s']:.3f} s"
                      for r in runs[(2, 1)]) + " (host clock)")
    done(t)
    return totals, per_rank, [r["infer_Q"] for r in runs[(2, 2)]]


# Phase 6e's grid: a 2 x 2 grid of ranks on the one card, over gloo.
STREAM_GRID = (2, 2)


def stream_estimates(m_pad, k=K_FULL, shape=STREAM_GRID):
    """A rank's resident and streamed device estimates (bytes) in phase 6e,
    the trainer's terms (train/engine.py _capacity_policy): its block of
    the data row's rows, its slice of a batch and its SNP block of the
    plane state (V and the P rows, four f32 copies each)."""
    n_data, n_snp = shape
    w_loc = m_pad // 4 // n_snp
    b_round, _, _, n_rows = block_geometry(N_FULL, TRAIN_BATCH, BLOCK, n_data)
    plane = m_pad * (D_FULL + k) * 4 * 4 // n_snp
    streamed = b_round // n_data * w_loc + plane
    return n_rows // n_data * w_loc + streamed, streamed


def grid_stream_rank(grid, packed_path, V, P_init, infer_params, ckpt,
                     cap_gb):
    """One rank of phase 6e (module level: ranks start with ``spawn``): (a)
    resident under NA_TPU_STRATIFIED=1, 2 epochs, a checkpoint every epoch
    (the epoch-1 file kept); (b) the auto policy under NA_TPU_HBM_CAPACITY_GB
    = ``cap_gb``, 2 epochs; (c) the same, resumed from (a)'s epoch-1 file;
    each with the grid's profile on and the launches counted; the staged
    infer_q_mesh against the sharded pass over the block uploaded whole;
    the copy of a step's slice from a pinned slot. Compares the runs in the
    rank; returns what the phase checks and prints."""
    from neural_admixture_tpu_torch.infer import infer_q_mesh
    from neural_admixture_tpu_torch.parallel.grid import shard_params
    from neural_admixture_tpu_torch.parallel.sharded_step import (
        infer_q_sharded)
    from neural_admixture_tpu_torch.utils.logger import log
    log.setLevel("WARNING")  # the trainer's log lines, once per rank

    class KeepingTrainer(NeuralAdmixtureTrainer):
        """Keeps each checkpoint as ``path.{epoch}``."""
        def _save_checkpoint(self, epoch, model, opt):
            super()._save_checkpoint(epoch, model, opt)
            if self.grid.rank == 0:
                shutil.copy(self.cfg.checkpoint_path,
                            f"{self.cfg.checkpoint_path}.{epoch}")

    packed = np.load(packed_path, mmap_mode="r")
    dev = grid.device
    probe = NeuralAdmixtureTrainer(TrainConfig(
        sample_block=BLOCK, batch_size=TRAIN_BATCH, device=str(dev)),
        grid=grid)
    start, end, _ = probe.sample_shard(packed.shape[1] * 4, N_FULL)
    local = np.array(packed[start:end])  # a writable copy of the mmap

    def run(env, **kw):
        os.environ.update(env)
        try:
            trainer = KeepingTrainer(TrainConfig(
                batch_size=TRAIN_BATCH, seed=SEED, hidden_size=H_FULL,
                n_components=D_FULL, ks=[K_FULL], progress=False,
                sample_block=BLOCK, device=str(dev),
                **{"checkpoint_path": ckpt, **kw}), grid=grid)
            reset_counts()
            grid.start_profile()
            torch.cuda.synchronize()
            t_s = time.perf_counter()
            result = trainer.launch_training(P_init, local, V, M_FULL,
                                             N_FULL, host_rows=(start, end))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t_s
            grid.stop_profile()
        finally:
            for var in env:
                del os.environ[var]
        stager = trainer.stager
        return result, {
            "counts": read_counts(), "profiles": trainer.epoch_profiles,
            "epoch_s": trainer.epoch_seconds,
            "train_s": trainer.train_seconds, "wall": wall,
            "streamed": trainer._streamed,
            "phase_s": dict(trainer.phase_seconds),
            "gather": (stager.gather_seconds, stager.bytes_gathered,
                       stager.gather_threads) if stager else None}

    cap = {"NA_TPU_HBM_CAPACITY_GB": repr(cap_gb)}
    res_a, a = run({"NA_TPU_STRATIFIED": "1"}, epochs=TRAIN_EPOCHS,
                   stream=False, checkpoint_every=1)
    res_b, b = run(cap, epochs=TRAIN_EPOCHS)
    res_c, c = run(cap, epochs=TRAIN_EPOCHS, checkpoint_path=f"{ckpt}.1",
                   resume=True)
    out = {"at": (grid.d, grid.s), "a": a, "b": b, "c": c,
           "b_equal": same_run(res_b, res_a),
           "c_equal": same_run(res_c, res_a)}
    del res_a, res_b, res_c

    # Grid infer: staged (infer_q_mesh) against the block uploaded whole.
    rows = N_FULL // grid.n_data
    reset_counts()
    torch.cuda.synchronize()
    t_s = time.perf_counter()
    out["infer_Q"] = infer_q_mesh(infer_params, local[:rows], N_FULL,
                                  [K_FULL], BATCH, grid)[0]
    torch.cuda.synchronize()
    out["infer_staged_s"] = time.perf_counter() - t_s
    out["infer_counts"] = read_counts()
    w_loc = packed.shape[1] // grid.n_snp
    model = params_from_numpy(shard_params(infer_params, grid.n_snp, grid.s),
                              [K_FULL], device=dev)
    no_missing = not packed_has_missing(packed)
    torch.cuda.synchronize()
    t_s = time.perf_counter()
    block = torch.from_numpy(np.ascontiguousarray(
        local[:rows, grid.s * w_loc:(grid.s + 1) * w_loc])).to(dev)
    whole = infer_q_sharded(model, grid, block, rows, BATCH,
                            no_missing)[f"k{K_FULL}"]
    torch.cuda.synchronize()
    out["infer_whole_s"] = time.perf_counter() - t_s
    out["infer_equal"] = np.array_equal(out["infer_Q"], whole)

    # The pinned copy of a step's slice (the ranks copy at once, as in a
    # streamed step).
    slice_rows = TRAIN_BATCH // grid.n_data
    stager = HostStager(dev, slice_rows, w_loc, prefetch=1)
    dev_buf = torch.empty((slice_rows, w_loc), dtype=torch.uint8, device=dev)
    out["copy_ms"] = cuda_ms(lambda: dev_buf.copy_(stager._host[0],
                                                   non_blocking=True), 10)
    out["slice_bytes"] = slice_rows * w_loc
    stager.close()
    return out


def phase_grid_stream(dev, card, packed, trained, infer_params, infer_Qs):
    """Streaming and checkpoints on a 2 x 2 grid of ranks sharing the card
    over gloo, at full width (phase 4's rows, phase 6's V and P init, K = 8,
    batch 800, sample_block 16): (a) resident under NA_TPU_STRATIFIED=1
    with a checkpoint every epoch, (b) streamed by the auto policy, (c)
    streamed and resumed from (a)'s epoch-1 file; (b) and (c) bit-equal to
    (a) on every rank, exact launches per rank, no exchange; the staged
    grid infer against the uploaded block and phase 4's Q. Returns
    {kernel: launches} of the runs and the per-rank counts."""
    t = phase("6e. grid: streamed and checkpointed 2x2 gloo grid on one card")
    from neural_admixture_tpu_torch.parallel.distributed import spawn_grid
    from neural_admixture_tpu_torch.train.engine import INFER_BATCH
    V, P_init = trained["V"], trained["P_init"]
    m_pad = packed.shape[1] * 4
    n_data, n_snp = STREAM_GRID
    _, nb, _, _ = block_geometry(N_FULL, TRAIN_BATCH, BLOCK, n_data)
    resident_b, streamed_b = stream_estimates(m_pad)
    # Between the two estimates, over HBM_BUDGET_FRAC (0.9).
    cap_gb = (resident_b + streamed_b) / 2 / 0.9 / 2**30
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        packed_path = os.path.join(d, "packed.npy")
        np.save(packed_path, packed)
        ckpt = os.path.join(d, "grid_ckpt.npz")
        t_s = time.perf_counter()
        results = spawn_grid(
            grid_stream_rank, n_data, n_snp, devices=["cuda:0"] * 4,
            backend="gloo", args=(packed_path, V, P_init, infer_params, ckpt,
                                  cap_gb))
        spawn_s = time.perf_counter() - t_s
        size = os.path.getsize(f"{ckpt}.1")
        with np.load(f"{ckpt}.1") as f:
            meta = json.loads(bytes(f["meta"]).decode())
            if bytes(f["format"]).decode() != CKPT_FORMAT or \
                    int(f["epoch"]) != 1 or \
                    meta["mesh_shape"] != list(STREAM_GRID) or \
                    f["param/V"].shape != (m_pad, D_FULL):
                raise AssertionError("grid checkpoint: format, epoch, mesh "
                                     "or width")
    print(f"   {n_data}x{n_snp} gloo: 4 ranks started, ran (a), (b), (c) and "
          f"infer and ended in {spawn_s:.1f} s; a rank's estimates: resident "
          f"{resident_b / 1e6:.1f} MB, streamed {streamed_b / 1e6:.1f} MB; "
          f"NA_TPU_HBM_CAPACITY_GB={cap_gb:.4f} between them")
    n_local = N_FULL // n_data
    n_q = -(-n_local // INFER_BATCH)
    want = expected_counts("default", nb, 1, n_q)
    want_c = dict.fromkeys(COUNTERS, 0)  # epoch 1 (unlogged), the Q pass
    want_c.update(xv=nb + n_q, dv=nb, dq_dp=nb)
    totals, per_rank = {}, {}
    for key, expect in (("a", want), ("b", want), ("c", want_c)):
        per_rank[f"2x2 6e ({key})"] = [r[key]["counts"] for r in results]
        for r in results:
            if r[key]["counts"] != expect:
                raise AssertionError(f"6e ({key}) rank at {r['at']}: "
                                     f"launches {r[key]['counts']}, expected "
                                     f"{expect}")
            for name, c in r[key]["counts"].items():
                totals[name] = totals.get(name, 0) + c
            if any("exchange" in p.seconds for p in r[key]["profiles"]):
                raise AssertionError(f"6e ({key}): rows were exchanged")
    for r in results:
        if r["a"]["streamed"] or not (r["b"]["streamed"]
                                      and r["c"]["streamed"]):
            raise AssertionError(f"6e rank at {r['at']}: (a) must be "
                                 "resident, (b) and (c) streamed")
        if not (r["b_equal"] and r["c_equal"]):
            raise AssertionError(f"6e rank at {r['at']}: (b) = (a) "
                                 f"{r['b_equal']}, (c) = (a) {r['c_equal']}")
        if not (r["infer_equal"] and np.array_equal(r["infer_Q"], infer_Qs[
                r["at"][0] * n_snp + r["at"][1]])):
            raise AssertionError(f"6e rank at {r['at']}: staged grid infer "
                                 "differs from the uploaded block or 6d")
    print(f"   (b) streamed by the auto policy = (a) resident stratified bit "
          f"for bit on every rank (Q, P, every parameter); (c) resumed "
          f"streamed from (a)'s epoch-1 file = (a) bit for bit; launches "
          f"exact a rank: (a), (b) "
          + ", ".join(f"{n} {c}" for n, c in want.items() if c)
          + "; (c) " + ", ".join(f"{n} {c}" for n, c in want_c.items() if c)
          + "; no exchange collective in any run")
    r0 = results[0]
    print(f"   checkpoint {size / 1e6:.1f} MB at full width (mesh_shape "
          f"{list(STREAM_GRID)}), save {r0['a']['phase_s']['save']:.3f} s "
          f"(rank 0: the snp group's gathers and the write); load "
          + ", ".join(f"{r['c']['phase_s']['load']:.3f}" for r in results)
          + " s a rank (host clock)")
    for key, label in (("a", "resident"), ("b", "streamed")):
        print_grid_steps(f"6e ({key}) {label}", [
            {"at": r["at"], "profiles": r[key]["profiles"],
             "epoch_s": r[key]["epoch_s"]} for r in results], nb,
            f"gloo through host memory, ranks sharing one card ({card})")
    for r in results:
        g_s, g_b, threads = r["b"]["gather"]
        rate = g_b / g_s if g_s else float("nan")
        e_a, e_b = r["a"]["epoch_s"][1], r["b"]["epoch_s"][1]
        print(f"   6e rank at {r['at']}: epoch 1 streamed {N_FULL / e_b:,.0f} "
              f"samples/s, resident {N_FULL / e_a:,.0f} (the epoch's steps, "
              f"its checkpoint apart); (b) over 2 epochs "
              f"{2 * N_FULL / r['b']['train_s']:,.0f}; host gather "
              f"{g_b / 1e6:.1f} MB on {threads} threads at {rate / 1e9:.2f} "
              f"GB/s ({1e3 * r['slice_bytes'] / rate:.3f} ms for a step's "
              f"{r['slice_bytes'] / 1e6:.1f} MB slice); pinned copy of the "
              f"slice {r['copy_ms']:.3f} ms ({r['slice_bytes'] / r['copy_ms'] / 1e6:.2f} "
              f"GB/s, CUDA events, the 4 ranks at once); infer staged "
              f"{r['infer_staged_s']:.3f} s, uploaded block "
              f"{r['infer_whole_s']:.3f} s, Q bit-equal to each other and "
              f"to 6d's; xv {r['infer_counts']['xv']}")
    done(t)
    return totals, per_rank


def phase_cv(dev, packed, trained):
    """Cross-validation, restarts and a traced run at full width (phase 4's
    rows, K = 8, batch 800, sample_block 16, 2 epochs). CV: 3 folds through
    train/cv.py run_cross_validation, each fold's seconds by part, its
    cv_error against the card's log-likelihood of the same Q and P, its
    exact launches; restarts: R = 2 through train/run.py fit_restarts on one
    PCA projection, restart 0 equal to phase 6's run and the kept one bit
    for bit its restart rebuilt by hand; the trace: phase 6's run under
    ``profile_dir``, bit-equal to it, K2-K5 in the trace as often as the
    counters say, each epoch's busy share. Returns the phase's launches."""
    from neural_admixture_tpu_torch.train import init as init_mod
    from neural_admixture_tpu_torch.train.cv import (run_cross_validation,
                                                     run_fold)
    from neural_admixture_tpu_torch.train.run import fit_restarts
    from neural_admixture_tpu_torch.utils import trace as tr
    t = phase("6f. full width: cross-validation (3 folds), restarts (R = 2), "
              "a traced run")
    k, V, P_init = K_FULL, trained["V"], trained["P_init"]
    nb = block_geometry(N_FULL, TRAIN_BATCH, BLOCK)[1]
    n_q = -(-N_FULL // 1024)
    totals = dict.fromkeys(COUNTERS, 0)

    def config(**kw):
        return TrainConfig(**{
            "epochs": TRAIN_EPOCHS, "batch_size": TRAIN_BATCH, "seed": SEED,
            "hidden_size": H_FULL, "n_components": D_FULL, "ks": [k],
            "progress": False, "sample_block": BLOCK, "device": str(dev),
            **kw})

    def add(counts):
        for name, c in counts.items():
            totals[name] += c

    # Cross-validation: each fold's launches, parts and cv_error.
    folds = []

    def fold(packed_tr, packed_val, *args):
        reset_counts()
        res = run_fold(packed_tr, packed_val, *args)
        counts = read_counts()
        n_tr, n_val = packed_tr.shape[0], packed_val.shape[0]
        want = expected_counts("default", block_geometry(
            n_tr, TRAIN_BATCH, BLOCK)[1], 1, -(-n_tr // 1024)
            + -(-n_val // 1024))
        if counts != want:
            raise AssertionError(f"fold {len(folds) + 1}: launches {counts}, "
                                 f"expected {want}")
        card = -loglikelihood_packed(packed_val, M_FULL, res.Ps[0],
                                     res.q_val[0], device_threshold=0,
                                     device=dev) / n_val
        rel = abs(card - res.errors[0]) / abs(res.errors[0])
        if not np.isfinite(res.errors[0]) or rel > 1e-5:
            raise AssertionError(f"fold {len(folds) + 1}: cv_error "
                                 f"{res.errors[0]} against the card's "
                                 f"{card} (rel {rel:.2e})")
        add(counts)
        folds.append(res)
        print(f"   fold {len(folds)}: {n_tr} train / {n_val} held out; "
              + ", ".join(f"{n} {s:.3f} s" for n, s in res.seconds.items())
              + f"; cv_error {res.errors[0]:.6f} (the card's fp32-block LL "
              f"of the same Q and P: rel {rel:.2e}, tolerance 1e-5); launches "
              + ", ".join(f"{c} {n}" for n, c in counts.items() if c),
              flush=True)
        return res

    with tempfile.TemporaryDirectory() as d:
        t_s = time.perf_counter()
        out = run_cross_validation(packed, N_FULL, M_FULL, [k], 3, SEED,
                                   config(), "cv", d, fold=fold)
        cv_s = time.perf_counter() - t_s
        with open(os.path.join(d, "cv.cv_errors.csv")) as f:
            rows = f.read().splitlines()
    mean = float(np.mean([f.errors[0] for f in folds]))
    if len(folds) != 3 or rows[0] != "K,cv_error_mean,cv_error_std" or \
            rows[1] != f"{k},{out[k][0]:.6f},{out[k][1]:.6f}" or \
            out[k][0] != mean:
        raise AssertionError(f"CV output {rows}, {out}")
    print(f"   run_cross_validation, 3 folds: {cv_s:.1f} s; CV error (K={k}) "
          f"{out[k][0]:.6f} ± {out[k][1]:.6f}; csv {rows[1]!r}")

    # Restarts: one projection, restart r from seed + r, the best kept.
    calls = [0]
    real_project = init_mod.project_pca

    def counting(*args, **kw):
        calls[0] += 1
        return real_project(*args, **kw)

    every = []

    def lls_of(Qs, Ps):
        every.append([loglikelihood_packed(packed, M_FULL, P, Q,
                                           device_threshold=0, device=dev)
                      for Q, P in zip(Qs, Ps)])
        return every[-1]

    init_mod.project_pca = counting
    try:
        packed_dev = torch.from_numpy(packed).to(dev)
        x_pca = init_mod.pca_coords(packed_dev, V, N_FULL)
        del packed_dev
        reset_counts()
        t_s = time.perf_counter()
        best, Qs, Ps, params, lls = fit_restarts(
            NeuralAdmixtureTrainer(config()), packed, V, M_FULL, N_FULL, [k],
            2, SEED, lls_of, x_pca=x_pca)
        restarts_s = time.perf_counter() - t_s
        counts = read_counts()
    finally:
        init_mod.project_pca = real_project
    want = {n: 2 * c for n, c in expected_counts("default", nb, 1,
                                                 n_q).items()}
    if counts != want or calls[0] != 1:
        raise AssertionError(f"restarts: launches {counts}, expected {want}; "
                             f"{calls[0]} projections")
    if every[0][0] != trained["ll"]:
        raise AssertionError(f"restart 0's log-likelihood {every[0][0]} is "
                             f"not phase 6's {trained['ll']}")
    add(counts)
    P_r = init_p_unsupervised(None, V, N_FULL, M_FULL, [k], SEED + best,
                              x_pca=x_pca)
    rebuilt = NeuralAdmixtureTrainer(config(seed=SEED + best)
                                     ).launch_training(P_r, packed, V,
                                                       M_FULL, N_FULL)
    if not same_run(rebuilt, (Qs, Ps, params)):
        raise AssertionError(f"the kept restart {best} is not its run "
                             "rebuilt by hand")
    print(f"   fit_restarts R=2: {restarts_s:.1f} s; log-likelihoods "
          + ", ".join(f"restart {r} {ll[0]:.6e}" for r, ll in
                      enumerate(every))
          + f" (restart 0 = phase 6's); kept restart {best}, bit for bit its "
          f"run rebuilt by hand; {calls[0]} PCA projection; launches "
          + ", ".join(f"{c} {n}" for n, c in counts.items() if c))

    # The trace of phase 6's run.
    with tempfile.TemporaryDirectory() as d:
        reset_counts()
        trainer = NeuralAdmixtureTrainer(config(profile_dir=d))
        run = trainer.launch_training(P_init, packed, V, M_FULL, N_FULL)
        counts = read_counts()
        path = os.path.join(d, "epochs_rank0.json")
        size = os.path.getsize(path)
        events = tr.load_events(path)
    if not same_run(run, trained["run"]):
        raise AssertionError("the traced run is not phase 6's bit for bit")
    add(counts)
    traced = tr.kernel_counts(events)
    want = {n: counts[n] for n in traced}
    want["xv"] -= n_q  # the Q pass runs after the trace
    if traced != want:
        raise AssertionError(f"the trace's kernels {traced}, the counters' "
                             f"{want}")
    spans = tr.epoch_spans(events)
    if [name for name, _, _ in spans] != [f"epoch {e}" for e in
                                          range(TRAIN_EPOCHS)]:
        raise AssertionError(f"epoch spans {spans}")
    untraced = trained["trainer"].epoch_seconds
    print(f"   traced run: bit for bit phase 6's; trace {size / 1e6:.1f} MB; "
          "kernels in the trace " + ", ".join(
              f"{c} {n}" for n, c in traced.items() if c)
          + " = the counters' (less the Q pass's xv)")
    for (name, a, b), s_traced, s_plain in zip(
            spans, trainer.epoch_seconds, untraced):
        in_span = tr.kernel_counts(events, a, b)
        print(f"   {name}: traced {1e3 * s_traced:.1f} ms against untraced "
              f"{1e3 * s_plain:.1f} ms (phase 6); span {(b - a) / 1e3:.1f} "
              f"ms, device busy {100 * tr.busy_share(events, a, b):.1f}% "
              "(kernels, copies and memsets over the span); kernels "
              + ", ".join(f"{c} {n}" for n, c in in_span.items() if c))
    done(t)
    return totals


def phase_cli_train(dev):
    """``train`` on the demo BED through the CLI, on the card and on the
    CPU, for one K, a K range and supervised mode: the output files, one
    log-likelihood line per K, the .npz loading into ``infer``, and the two
    runs held to each other by the trajectory rule."""
    t = phase("7. CLI: train on the demo BED, card vs CPU (K = 7, K = 2..4, "
              "supervised)")
    from neural_admixture_tpu_torch.io.bed import read_bed_packed
    from neural_admixture_tpu_torch.io.writers import load_checkpoint
    packed, N, M = read_bed_packed(DEMO_BED)
    with tempfile.TemporaryDirectory() as d:
        # Supervised labels: P{argmax} of the reference's K = 7 Q, per row.
        # Only 5 of its 7 columns are ever the largest, and the label count
        # must equal K (train/init.py encode_populations), so K = 5.
        argmax = np.genfromtxt(DEMO_Q_EXPECTED).argmax(1)
        names, labels = np.unique([f"P{j}" for j in argmax],
                                  return_inverse=True)
        k_sup = len(names)
        pops_path = os.path.join(d, "labels.txt")
        with open(pops_path, "w") as fb:
            fb.write("\n".join(f"P{j}" for j in argmax) + "\n")
        configs = {"k7": (["--k", "7"], [7]),
                   "k2to4": (["--min_k", "2", "--max_k", "4"], [2, 3, 4]),
                   "sup": (["--k", str(k_sup), "--pops_path", pops_path],
                           [k_sup])}
        for cfg_name, (flags, ks) in configs.items():
            out = {}
            for tag, gpus, device in (("gpu", "1", dev), ("cpu", "0", "cpu")):
                name = f"{cfg_name}_{tag}"
                t_cli = time.perf_counter()
                r = subprocess.run(
                    [sys.executable, "-m", "neural_admixture_tpu_torch.entry",
                     "train", *flags, "--data_path", DEMO_BED, "--save_dir",
                     d, "--name", name, "--epochs", "5", "--seed", "42",
                     "--num_gpus", gpus, "--no_progress"],
                    cwd=REPO, check=True, capture_output=True, text=True)
                secs = time.perf_counter() - t_cli
                log_lines = r.stderr.splitlines() + r.stdout.splitlines()
                names = sorted(f for f in os.listdir(d)
                               if f.startswith(name + ".")
                               or f.startswith(name + "_"))
                want = sorted([f"{name}.{k}.{m}" for k in ks
                               for m in ("Q", "P")]
                              + [f"{name}{s}" for s in (".npz", ".pt",
                                                        "_config.json")])
                if names != want:
                    raise AssertionError(f"{name} wrote {names}")
                with open(os.path.join(d, f"{name}_config.json")) as fb:
                    if json.load(fb)["ks"] != ks:
                        raise AssertionError(f"{name}: config ks")
                ll_lines = [ln for ln in log_lines if "Log-likelihood" in ln]
                if len(ll_lines) != len(ks) or (len(ks) > 1 and not all(
                        f"for K={k}:" in ln for k, ln in zip(ks, ll_lines))):
                    raise AssertionError(f"{name}: log-likelihood lines "
                                         f"{ll_lines}")
                Qs = [np.loadtxt(os.path.join(d, f"{name}.{k}.Q")) for k in ks]
                Ps = [np.loadtxt(os.path.join(d, f"{name}.{k}.P")) for k in ks]
                Qi = infer_q(load_checkpoint(name, d), packed, N, ks,
                             device=device)
                lls = []
                for k, Q, P, q_inf in zip(ks, Qs, Ps, Qi):
                    if Q.shape != (N, k) or P.shape != (M, k) or \
                            not np.allclose(Q.sum(1), 1.0, atol=1e-5) or \
                            P.min() < 0 or P.max() > 1:
                        raise AssertionError(f"{name}: bad Q or P for K={k}")
                    if not np.allclose(q_inf, Q, rtol=1e-5, atol=1e-6):
                        raise AssertionError(
                            f"{name}: infer from the .npz gives another Q for "
                            f"K={k} ({np.abs(q_inf - Q).max()})")
                    lls.append(loglikelihood_packed(packed, M, P, Q))
                    if not np.isfinite(lls[-1]):
                        raise AssertionError(f"{name}: log-likelihood "
                                             f"{lls[-1]}")
                throughput = [ln.strip() for ln in log_lines
                              if "throughput" in ln]
                msg = (f"   train {cfg_name} --num_gpus {gpus}: {secs:.1f} s; "
                       f"{throughput[0] if throughput else ''}; "
                       f"log-likelihood " + ", ".join(
                           f"K={k} {ll:,.1f}" for k, ll in zip(ks, lls)))
                if cfg_name == "k7":
                    gates = demo_gates(Qs[0], Ps[0])
                    # The golden measures are reported, not required: at
                    # seed 42 the port's GMM draws (a torch.Generator, not
                    # jax.random) land in a basin that misses them after 5
                    # epochs, as about half of the JAX package's own seeds
                    # do (ROADMAP.md Queue 3, a known difference).
                    golden = (lls[0] > GOLDEN_LL and gates[0] > 0.78
                              and gates[1] > 0.85 and gates[2] > 0.93
                              and gates[3] > 0.80)
                    msg += (f" (golden {GOLDEN_LL:,}); matched Q corr mean "
                            f"{gates[0]:.4f}, 2nd smallest {gates[1]:.4f}; P "
                            f"corr mean {gates[2]:.4f}, min {gates[3]:.4f}: "
                            f"golden measures "
                            f"{'met' if golden else 'missed'}")
                if cfg_name == "sup":
                    agree = float((Qs[0].argmax(1) == labels).mean())
                    msg += f"; argmax Q agrees with the labels on {agree:.3f}"
                print(msg + "; .npz -> infer Q agrees")
                out[tag] = (Qs, Ps, lls)
            for k, P_gpu, P_cpu, Q_gpu, Q_cpu, ll_g, ll_c in zip(
                    ks, out["gpu"][1], out["cpu"][1], out["gpu"][0],
                    out["cpu"][0], out["gpu"][2], out["cpu"][2]):
                d_max, frac = assert_trajectory_close(P_gpu, P_cpu, lr=2e-3)
                print(f"   {cfg_name} K={k} card vs CPU P: max|d| "
                      f"{d_max:.3e}, {frac:.3%} outside rtol 5e-3 / atol "
                      f"5e-4 (rule: max|d| <= 0.02, <= 0.5%); Q max|d| "
                      f"{np.abs(Q_gpu - Q_cpu).max():.3e}; log-likelihood "
                      f"{ll_g:,.1f} vs {ll_c:,.1f}")
        cli_stream_and_preempt(d)
        cli_grid_stream_and_preempt(d)
        cli_other_formats(d)
        cli_clamp(d)
        cli_cv_restarts_trace(d, packed, M)
    done(t)


def cli_cv_restarts_trace(d, packed, M):
    """On the card: ``--cv 3 --min_k 2 --max_k 4 --profile_dir`` writes the
    csv, a trace for each fold and the fit (its epoch spans, the kernels in
    them, the busy share), and the .Q and .P of the run without them
    (``k2to4_gpu``) byte for byte; ``--k 7 --init_restarts 3`` logs its
    three restarts and keeps a log-likelihood no lower than the one run's
    (``k7_gpu``, its restart 0); on two CPU ranks ``--mesh 2x1
    --init_restarts 2`` exits 0."""
    from neural_admixture_tpu_torch.utils import trace as tr

    def cli(name, *flags, gpus="1"):
        t_cli = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "neural_admixture_tpu_torch.entry",
             "train", "--data_path", DEMO_BED, "--save_dir", d, "--name",
             name, "--seed", "42", "--num_gpus", gpus, "--no_progress",
             *flags], cwd=REPO, capture_output=True, text=True)
        if r.returncode:
            raise AssertionError(f"train {name}: exit {r.returncode}\n"
                                 f"{r.stdout[-3000:]}{r.stderr[-3000:]}")
        return r.stdout.splitlines(), time.perf_counter() - t_cli

    def ll(name, k):
        return loglikelihood_packed(
            packed, M, np.loadtxt(os.path.join(d, f"{name}.{k}.P")),
            np.loadtxt(os.path.join(d, f"{name}.{k}.Q")))

    traces = os.path.join(d, "traces")
    lines, secs = cli("k2to4_cv", "--min_k", "2", "--max_k", "4", "--epochs",
                      "5", "--cv", "3", "--profile_dir", traces)
    with open(os.path.join(d, "k2to4_cv.cv_errors.csv")) as f:
        rows = f.read().splitlines()
    if [r.split(",")[0] for r in rows] != ["K", "2", "3", "4"]:
        raise AssertionError(f"--cv 3 wrote {rows}")
    for k in (2, 3, 4):
        for m in ("Q", "P"):
            with open(os.path.join(d, f"k2to4_cv.{k}.{m}"), "rb") as fa, \
                    open(os.path.join(d, f"k2to4_gpu.{k}.{m}"), "rb") as fb:
                if fa.read() != fb.read():
                    raise AssertionError(f"--cv 3 --profile_dir wrote "
                                         f"another .{k}.{m}")
    names = sorted(os.listdir(traces))
    if names != ["epochs_rank0.json"] + [f"epochs_rank0_{i}.json"
                                         for i in (1, 2, 3)]:
        raise AssertionError(f"traces {names}")
    events = tr.load_events(os.path.join(traces, "epochs_rank0_3.json"))
    spans = tr.epoch_spans(events)
    if [n for n, _, _ in spans] != [f"epoch {e}" for e in range(5)]:
        raise AssertionError(f"the fit's epoch spans {spans}")
    kernels = tr.kernel_counts(events)
    if not all(kernels[n] for n in ("xv", "dq_dp", "loss_dq_dp", "dv")):
        raise AssertionError(f"the fit's trace holds kernels {kernels}")
    print(f"   train K=2..4 --cv 3 --profile_dir --num_gpus 1: {secs:.1f} s; "
          + "; ".join(ln.strip() for ln in lines if "CV error (K=" in ln)
          + "; .Q and .P byte for byte the run without --cv; 4 traces (3 "
          "folds, the fit); the fit's kernels " + ", ".join(
              f"{c} {n}" for n, c in kernels.items() if c)
          + "; busy " + ", ".join(
              f"{n} {100 * tr.busy_share(events, a, b):.1f}%"
              for n, a, b in spans))

    lines, secs = cli("k7_r3", "--k", "7", "--epochs", "5",
                      "--init_restarts", "3")
    started = [ln.strip() for ln in lines if "Restart " in ln]
    if started != [f"Restart {r + 1}/3 (seed {42 + r})..." for r in
                   range(3)]:
        raise AssertionError(f"--init_restarts 3 logged {started}")
    ll3, ll1 = ll("k7_r3", 7), ll("k7_gpu", 7)
    if ll3 < ll1 - 1e-6:
        raise AssertionError(f"--init_restarts 3 kept LL {ll3} below the one "
                             f"run's {ll1}")
    gates = demo_gates(np.loadtxt(os.path.join(d, "k7_r3.7.Q")),
                       np.loadtxt(os.path.join(d, "k7_r3.7.P")))
    print(f"   train K=7 --init_restarts 3 --num_gpus 1: {secs:.1f} s; "
          f"log-likelihood {ll3:,.1f} against one run's {ll1:,.1f} (golden "
          f"{GOLDEN_LL:,}); matched Q corr mean {gates[0]:.4f}, 2nd smallest "
          f"{gates[1]:.4f}; P corr mean {gates[2]:.4f}, min {gates[3]:.4f}")

    lines, secs = cli("g_r2", "--k", "2", "--epochs", "4", "--batch_size",
                      "64", "--hidden_size", "32", "--mesh", "2x1",
                      "--init_restarts", "2", gpus="0")
    print(f"   train --num_gpus 0 --mesh 2x1 --init_restarts 2: {secs:.1f} s; "
          + "; ".join(ln.strip() for ln in lines
                      if "Restart " in ln or "Log-likelihood" in ln))


def cli_stream_and_preempt(d):
    """On the card: ``train --stream 1`` writes the .Q and .P that the
    resident run (``k7_gpu``, --stream auto) wrote, byte for byte; a
    ``--checkpoint_every`` run sent SIGTERM after its first checkpoint
    exits 143 with the log line, and its ``--resume`` finishes with rc 0."""
    def cli(*flags):
        return [sys.executable, "-u", "-m", "neural_admixture_tpu_torch.entry",
                "train", "--data_path", DEMO_BED, "--save_dir", d,
                "--num_gpus", "1", "--no_progress", *flags]

    t_cli = time.perf_counter()
    r = subprocess.run(cli("--k", "7", "--name", "k7_stream", "--epochs", "5",
                           "--seed", "42", "--stream", "1"),
                       cwd=REPO, check=True, capture_output=True, text=True)
    if "Host-streaming (out-of-core) training" not in r.stdout:
        raise AssertionError("--stream 1 did not stream")
    for m in ("Q", "P"):
        with open(os.path.join(d, f"k7_stream.7.{m}"), "rb") as fa, \
                open(os.path.join(d, f"k7_gpu.7.{m}"), "rb") as fb:
            if fa.read() != fb.read():
                raise AssertionError(f"--stream 1 wrote another .{m}")
    print(f"   train K=7 --stream 1 --num_gpus 1: "
          f"{time.perf_counter() - t_cli:.1f} s; .7.Q and .7.P byte for byte "
          f"those of --stream auto (resident)")

    epochs = 300
    pre = cli("--k", "2", "--name", "pre", "--epochs", str(epochs), "--seed",
              "3", "--batch_size", "64", "--hidden_size", "32",
              "--checkpoint_every", "5")
    ckpt = os.path.join(d, "pre_ckpt.npz")
    t_cli = time.perf_counter()
    p = subprocess.Popen(pre, cwd=REPO, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 300
        while not os.path.exists(ckpt) and time.time() < deadline:
            if p.poll() is not None:
                raise AssertionError("the run ended before its first "
                                     "checkpoint:\n" + p.communicate()[0])
            time.sleep(0.02)
        p.send_signal(signal.SIGTERM)
        out = p.communicate(timeout=300)[0]
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
    if p.returncode != 143 or "SIGTERM received: resumable checkpoint " \
            "saved at epoch" not in out:
        raise AssertionError(f"SIGTERM: exit {p.returncode}\n{out[-3000:]}")
    with np.load(ckpt) as f:
        stopped = int(f["epoch"])
    secs = time.perf_counter() - t_cli
    t_cli = time.perf_counter()
    r = subprocess.run(pre + ["--resume"], cwd=REPO, capture_output=True,
                       text=True)
    if r.returncode != 0 or f"Resuming from epoch {stopped}." not in r.stdout:
        raise AssertionError(f"--resume: exit {r.returncode}\n"
                             f"{r.stdout[-3000:]}{r.stderr[-3000:]}")
    Q = np.loadtxt(os.path.join(d, "pre.2.Q"))
    if Q.shape != (105, 2) or not np.allclose(Q.sum(1), 1.0, atol=1e-5):
        raise AssertionError("resumed run: bad Q")
    print(f"   train K=2 --checkpoint_every 5 --num_gpus 1, SIGTERM after "
          f"the first checkpoint: exit 143 at epoch {stopped} of {epochs} "
          f"({secs:.1f} s); --resume: rc 0, resumed from epoch {stopped} "
          f"({time.perf_counter() - t_cli:.1f} s)")


def cli_grid_stream_and_preempt(d):
    """A grid of two CPU ranks on the demo (``--num_gpus 0 --mesh 2x1``: a
    grid on the card needs a card a rank): ``--stream 1`` writes the .Q and
    .P of the resident grid under NA_TPU_STRATIFIED=1 byte for byte; a
    ``--checkpoint_every 2`` run sent SIGTERM after its first checkpoint
    exits 143 (the ``train`` process forwards it to its ranks), and its
    ``--resume`` exits 0."""
    def cli(name, epochs, *flags):
        return [sys.executable, "-u", "-m", "neural_admixture_tpu_torch.entry",
                "train", "--k", "2", "--data_path", DEMO_BED, "--save_dir", d,
                "--name", name, "--epochs", str(epochs), "--seed", "3",
                "--batch_size", "64", "--hidden_size", "32", "--no_progress",
                "--num_gpus", "0", "--mesh", "2x1", *flags]

    t_cli = time.perf_counter()
    r = subprocess.run(cli("g_stream", 4, "--stream", "1"), cwd=REPO,
                       capture_output=True, text=True)
    if r.returncode or "Host-streaming (out-of-core) training" not in r.stdout:
        raise AssertionError(f"--mesh 2x1 --stream 1: exit {r.returncode}\n"
                             f"{r.stdout[-3000:]}{r.stderr[-3000:]}")
    subprocess.run(cli("g_strat", 4), cwd=REPO, check=True,
                   capture_output=True, text=True,
                   env={**os.environ, "NA_TPU_STRATIFIED": "1"})
    for m in ("Q", "P"):
        with open(os.path.join(d, f"g_stream.2.{m}"), "rb") as fa, \
                open(os.path.join(d, f"g_strat.2.{m}"), "rb") as fb:
            if fa.read() != fb.read():
                raise AssertionError(f"--mesh 2x1 --stream 1 wrote another "
                                     f".{m} than the stratified grid")
    print(f"   train --num_gpus 0 --mesh 2x1 --stream 1 and the resident "
          f"grid under NA_TPU_STRATIFIED=1: {time.perf_counter() - t_cli:.1f}"
          f" s; .2.Q and .2.P byte for byte")

    epochs = 60
    pre = cli("g_pre", epochs, "--checkpoint_every", "2")
    ckpt = os.path.join(d, "g_pre_ckpt.npz")
    t_cli = time.perf_counter()
    p = subprocess.Popen(pre, cwd=REPO, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 300
        while not os.path.exists(ckpt) and time.time() < deadline:
            if p.poll() is not None:
                raise AssertionError("the grid run ended before its first "
                                     "checkpoint:\n" + p.communicate()[0])
            time.sleep(0.02)
        p.send_signal(signal.SIGTERM)
        out = p.communicate(timeout=300)[0]
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
    if p.returncode != 143 or "SIGTERM received: resumable checkpoint " \
            "saved at epoch" not in out:
        raise AssertionError(f"grid SIGTERM: exit {p.returncode}\n"
                             f"{out[-3000:]}")
    with np.load(ckpt) as f:
        stopped = int(f["epoch"])
    secs = time.perf_counter() - t_cli
    t_cli = time.perf_counter()
    r = subprocess.run(pre + ["--resume"], cwd=REPO, capture_output=True,
                       text=True)
    if r.returncode != 0 or f"Resuming from epoch {stopped}." not in r.stdout:
        raise AssertionError(f"grid --resume: exit {r.returncode}\n"
                             f"{r.stdout[-3000:]}{r.stderr[-3000:]}")
    print(f"   train --num_gpus 0 --mesh 2x1 --checkpoint_every 2, SIGTERM "
          f"to the train process after the first checkpoint: exit 143 at "
          f"epoch {stopped} of {epochs} ({secs:.1f} s); --resume: rc 0 "
          f"({time.perf_counter() - t_cli:.1f} s)")


def cli_clamp(d):
    """``train --num_gpus 2`` on a machine of one card: the JAX package's
    clamp warning, then the ``--num_gpus 1`` run (``k7_gpu``) byte for
    byte."""
    if torch.cuda.device_count() != 1:
        print(f"   train --num_gpus 2: not run ({torch.cuda.device_count()} "
              "cards: no clamp to show)")
        return
    t_cli = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "neural_admixture_tpu_torch.entry", "train",
         "--k", "7", "--data_path", DEMO_BED, "--save_dir", d, "--name",
         "k7_clamp", "--epochs", "5", "--seed", "42", "--num_gpus", "2",
         "--no_progress"], cwd=REPO, check=True, capture_output=True,
        text=True)
    warning = ("Requested 2 devices, but only 1 are available. Using 1 "
               "devices.")
    if warning not in r.stdout + r.stderr:
        raise AssertionError("train --num_gpus 2 logged no clamp warning")
    with open(os.path.join(d, "k7_clamp.7.Q"), "rb") as fa, \
            open(os.path.join(d, "k7_gpu.7.Q"), "rb") as fb:
        if fa.read() != fb.read():
            raise AssertionError("--num_gpus 2 on one card wrote another .Q")
    print(f"   train K=7 --num_gpus 2 on one card: "
          f"{time.perf_counter() - t_cli:.1f} s; '{warning}', then .7.Q "
          "byte for byte that of --num_gpus 1")


def cli_other_formats(d):
    """On the card: the demo BED's dosages (before the flip) written as a
    mode-0x10 PGEN with the port's writer and as a VCF; ``train`` on each
    writes the .Q and .P of the BED run (``k7_gpu``) byte for byte and logs
    the input format, and ``infer`` of that model on the PGEN and the VCF
    writes the .Q of ``infer`` on the BED."""
    from neural_admixture_tpu_torch.io.bed import read_bed
    from neural_admixture_tpu_torch.io.pgen_standard import (
        write_pgen_standard)
    G = read_bed(DEMO_BED)
    t_s = time.perf_counter()
    paths = {"PGEN": os.path.join(d, "demo.pgen"),
             "VCF": os.path.join(d, "demo.vcf")}
    write_pgen_standard(paths["PGEN"], G)
    pgen_s = time.perf_counter() - t_s
    write_vcf(paths["VCF"], G)
    print(f"   the demo as a mode-0x10 PGEN (port's writer, {pgen_s:.1f} s) "
          f"and a VCF ({time.perf_counter() - t_s - pgen_s:.1f} s)")

    def cli(*argv):
        r = subprocess.run([sys.executable, "-m",
                            "neural_admixture_tpu_torch.entry", *argv,
                            "--num_gpus", "1"],
                           cwd=REPO, check=True, capture_output=True,
                           text=True)
        return r.stdout

    def same_bytes(a, b):
        with open(os.path.join(d, a), "rb") as fa, \
                open(os.path.join(d, b), "rb") as fb:
            return fa.read() == fb.read()

    cli("infer", "--name", "k7_gpu", "--save_dir", d, "--data_path",
        DEMO_BED, "--out_name", "inf_BED")
    for fmt, path in paths.items():
        t_cli = time.perf_counter()
        out = cli("train", "--k", "7", "--data_path", path, "--save_dir", d,
                  "--name", f"k7_{fmt}", "--epochs", "5", "--seed", "42",
                  "--no_progress")
        if f"    Input format is {fmt}." not in out.splitlines():
            raise AssertionError(f"train on the {fmt} did not log its format")
        for m in ("Q", "P"):
            if not same_bytes(f"k7_{fmt}.7.{m}", f"k7_gpu.7.{m}"):
                raise AssertionError(f"train on the {fmt} wrote another .{m}")
        secs = time.perf_counter() - t_cli
        t_cli = time.perf_counter()
        cli("infer", "--name", "k7_gpu", "--save_dir", d, "--data_path",
            path, "--out_name", f"inf_{fmt}")
        if not same_bytes(f"inf_{fmt}.7.Q", "inf_BED.7.Q"):
            raise AssertionError(f"infer on the {fmt} wrote another .Q")
        print(f"   train K=7 on the {fmt} --num_gpus 1: {secs:.1f} s, logs "
              f"'Input format is {fmt}.', .7.Q and .7.P byte for byte the "
              f"BED run's; infer on it: {time.perf_counter() - t_cli:.1f} s, "
              ".7.Q byte for byte infer on the BED")


def step_fn(model, xb, cm, rw, no_missing, logged=False, merged=True):
    """One training step of the trainer (train/engine.py): the fused loss,
    its backward, Adam and the P clamp. Unlogged: K2, K3 per head, K5;
    ``logged``: K4 per head in the forward instead of K3 (``merged``), or
    under the split program K6 per head in the forward and K3 in the
    backward."""
    opt = torch.optim.Adam(model.parameters(), lr=2e-3, betas=(0.9, 0.95),
                           eps=1e-8)

    def step():
        opt.zero_grad(set_to_none=True)
        loss, _ = fused_training_loss(model, xb, cm, rw, False, no_missing,
                                      logged, merged)
        loss.backward()
        opt.step()
        model.restrict_P()
    return step


def template_args(fn):
    """A mangled kernel instance named by its template arguments, e.g.
    ``dq_dp_kernel<8,0,0,1,0>``."""
    import re
    m = re.search(r"\d([a-z][a-z_0-9]*kernel)I((?:L[ib]\d+E)+)E", fn)
    if not m:
        return fn
    return (f"{m.group(1)}<"
            + ",".join(re.findall(r"L[ib](\d+)E", m.group(2))) + ">")


def dq_dp_sass(lib_path):
    """The main loop of the cells' K3 and K4 instances (gathered, unmasked,
    NO_MISSING false) at KT 4, 8 and 16 in the SASS of a dq_dp library,
    through tools/cuda_sass_loops.py: {"KT kt K3|K4": {"loop": its
    instructions, "hmma": its tensor-core products, "per_element": the
    instructions over the elements one iteration gives a lane}}. An
    iteration takes HMMA / (6 KS NS) 16-row groups (three products each for
    raw and dq, a step and head slice), and a group is 4 NS elements a
    lane."""
    from tools import cuda_sass_loops as sl
    sass = subprocess.run([sl.cuobjdump(), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    fns = sl.functions(sass)
    out = {}
    for kt in (4, 8, 16):
        ks, ns = (kt + 7) // 8, 1 if kt == 16 else 2
        for wl in (False, True):
            tag = f"dq_dp_kernelILi{kt}ELb0ELb0ELb{int(wl)}ELb0E"
            (insns,) = [v for fn, v in fns.items() if tag in fn]
            n, hmma = sl.busiest_loop(insns, "HMMA")
            elems = hmma / (6 * ks * ns) * 4 * ns
            out[f"KT {kt} {'K4' if wl else 'K3'}"] = {
                "loop": n, "hmma": hmma, "per_element": n / elems}
    return out


def phase_ab(dev, parent_dir, parent_build, logs):
    """This checkout's kernels against another version of them (``--ab DIR``:
    DIR a copy of another commit's ``csrc/``, built into DIR/build by
    ``parent_build``, a future of _build.build, while the other phases
    ran), in one process on one card, in the order parent, change, change,
    parent. Each turn times, at B = 800 on full-width rows, K2 and K5 at
    D = 8 (K5 gathered and indexed, at B = 800 and at the remainder
    B = 96), K3, K4 and K6 per head of K = 2..10, a warm unlogged training
    step at K = 8 and at K = 2..10, a warm logged step (K4 per head) at
    K = 8 and K = 2..10 and one of the split program (K6 + K3 per head) at
    K = 2..10; K3 and K4 per head also at B = 4096 (the B = 800 rows over
    again); K2 also at B = 1024, the infer batch, and infer_q over N = 4096
    full-width rows (host clock, the mean of 3 runs after one). The
    wrappers reach the parent's libraries through _build.load; a kernel
    that DIR lacks runs the checkout's in both. First it holds each kernel
    instance's ptxas line (stack, spills, registers) of DIR's build against
    the checkout's (``logs``: phase 2's ptxas logs, or empty), printing
    those that differ, and counts the instructions of the main loop of the
    cells' K3 and K4 instances in both builds' SASS (dq_dp_sass). Writes
    chiprun_out/ab.json: the lines, the counts and the times."""
    t = phase(f"A/B: {parent_dir} (parent) vs this checkout's kernels")
    built = parent_build.result()
    mine_built = _build.build()  # built here unless phase 2 ran
    for name, info in mine_built.items():
        logs.setdefault(name, info["log"])
    results = {"ptxas": {}, "sass": {}}
    for name, info in built.items():
        n, r_min, r_max, spill = ptxas_summary(info["log"])
        print(f"   parent {name}: ptxas: {n} functions, {r_min}-{r_max} "
              f"registers, spill stores {spill} bytes at most")
        lines = {}
        for side, log in (("parent", info["log"]),
                          ("change", logs.get(name, ""))):
            for fn, _, _, text in ptxas_functions(log):
                lines.setdefault(unhashed(fn), {})[side] = text
        results["ptxas"][name] = lines
        differ = [fn for fn, v in lines.items()
                  if v.get("parent") != v.get("change")]
        print(f"     {len(lines) - len(differ)} of {len(lines)} instances "
              "with the parent's ptxas line; the others:")
        for fn in differ:
            print(f"     {template_args(fn)}: parent {lines[fn].get('parent')}"
                  f" | change {lines[fn].get('change')}")
    for side, info in (("parent", built["dq_dp"]),
                       ("change", mine_built["dq_dp"])):
        results["sass"][side] = dq_dp_sass(info["path"])
        print(f"   {side} dq_dp SASS, main loop (instructions, HMMA, an "
              "element): " + ", ".join(
                  f"{kid} {v['loop']} / {v['hmma']} / "
                  f"{v['per_element']:.1f}"
                  for kid, v in results["sass"][side].items()))
    parent_libs = {name: ctypes.CDLL(str(info["path"]))
                   for name, info in built.items()}
    change_load = _build.load
    loads = {"change": change_load,
             "parent": lambda name: parent_libs.get(name) or change_load(name)}

    m_pad = -(-M_FULL // LANE) * LANE
    rng = np.random.default_rng(SEED + 2)
    B = TRAIN_BATCH
    xb = torch.from_numpy(random_packed(rng, B, M_FULL, m_pad)).to(dev)
    no_missing = not packed_has_missing(xb.cpu().numpy())
    cm = (torch.arange(m_pad, device=dev) < M_FULL).to(torch.float32)
    rw = torch.ones(B, device=dev)
    dXp = torch.from_numpy(rng.standard_normal((B, D_FULL)).astype(
        np.float32)).to(dev)
    # K5's indexed form reads xb as the resident rows, in shuffled blocks
    # of BLOCK rows; the remainder batch is the first 96 rows
    rem = 96
    perm = rng.permutation(B // BLOCK).astype(np.int32)
    ix800 = {"blk_idx": torch.from_numpy(perm).to(dev), "blk": BLOCK}
    ix96 = {"blk_idx": torch.from_numpy(perm[:rem // BLOCK]).to(dev),
            "blk": BLOCK}
    xb96, dXp96 = xb[:rem].contiguous(), dXp[:rem].contiguous()
    models = {}
    for name, ks in (("K=8", [K_FULL]), ("K=2..10", KS_SWEEP)):
        params = random_params(rng, M_FULL, m_pad, D_FULL, H_FULL, ks)
        params["decoders"] = {
            f"k{k}": np.where(np.arange(m_pad) < M_FULL, rng.uniform(
                0.05, 0.95, (k, m_pad)), 0.0).astype(np.float32)
            for k in ks}
        models[name] = qp.params_from_numpy(params, ks, dev)
    xb_inf = torch.from_numpy(random_packed(rng, BATCH, M_FULL, m_pad)
                              ).to(dev)
    inf_missing = packed_has_missing(xb_inf.cpu().numpy())
    rows_inf = random_packed(rng, N_FULL, M_FULL, m_pad)
    params_inf = random_params(rng, M_FULL, m_pad, D_FULL, H_FULL, [K_FULL])

    def infer_ms():
        infer_q(params_inf, rows_inf, N_FULL, [K_FULL], BATCH, dev)
        t_s = time.perf_counter()
        for _ in range(3):
            infer_q(params_inf, rows_inf, N_FULL, [K_FULL], BATCH, dev)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t_s) / 3

    with torch.no_grad():
        m9 = models["K=2..10"]
        qs = m9.encode_from_xp(xv(xb, m9.V, no_missing))
        heads = {hk: (qs[hk].contiguous(), m9.decoders[hk].detach())
                 for hk in qs}
        # K3 and K4 also at the k8 cell's batch: xb's rows over again
        xb4k = xb.repeat(-(-4096 // B), 1)[:4096].contiguous()
        qs4k = m9.encode_from_xp(xv(xb4k, m9.V, no_missing))
        heads4k = {hk: qs4k[hk].contiguous() for hk in qs4k}
    rw4k = torch.ones(4096, device=dev)
    try:
        for turn, which in enumerate(("parent", "change", "change",
                                      "parent")):
            _build.load = loads[which]
            row = {}
            with torch.no_grad():
                row["K2"] = cuda_ms(lambda: xv(xb, m9.V, no_missing), 10)
                row["K2 B=1024"] = cuda_ms(
                    lambda: xv(xb_inf, m9.V, not inf_missing), 10)
                row["K5"] = cuda_ms(lambda: dv(xb, dXp, no_missing), 10)
                row["K5 indexed"] = cuda_ms(
                    lambda: dv(xb, dXp, no_missing, **ix800), 10)
                row["K5 B=96"] = cuda_ms(
                    lambda: dv(xb96, dXp96, no_missing), 10)
                row["K5 B=96 indexed"] = cuda_ms(
                    lambda: dv(xb, dXp96, no_missing, **ix96), 10)
                for hk, (q, P) in heads.items():
                    row[f"K3 {hk}"] = cuda_ms(lambda: dq_dp(
                        xb, q, P, cm, rw, 1.0, False, no_missing), 10)
                    row[f"K4 {hk}"] = cuda_ms(lambda: dq_dp(
                        xb, q, P, cm, rw, 1.0, False, no_missing, True), 10)
                    row[f"K6 {hk}"] = cuda_ms(lambda: bce_sum(
                        xb, q, P, cm, rw, False, no_missing), 10)
                for hk, (_, P) in heads.items():
                    q = heads4k[hk]
                    row[f"K3 {hk} B=4096"] = cuda_ms(lambda: dq_dp(
                        xb4k, q, P, cm, rw4k, 1.0, False, no_missing), 5)
                    row[f"K4 {hk} B=4096"] = cuda_ms(lambda: dq_dp(
                        xb4k, q, P, cm, rw4k, 1.0, False, no_missing, True),
                        5)
            for name, model in models.items():
                row[f"step {name}"] = cuda_ms(
                    step_fn(model, xb, cm, rw, no_missing), 10)
            for name, model in models.items():
                row[f"logged step {name}"] = cuda_ms(step_fn(
                    model, xb, cm, rw, no_missing, logged=True), 10)
            row["logged split step K=2..10"] = cuda_ms(step_fn(
                models["K=2..10"], xb, cm, rw, no_missing, logged=True,
                merged=False), 10)
            row["infer_q"] = infer_ms()
            for kid in ("K3", "K4", "K6"):
                row[f"{kid} sum of heads"] = sum(
                    row[f"{kid} {hk}"] for hk in heads)
            for kid in ("K3", "K4"):
                row[f"{kid} sum of heads B=4096"] = sum(
                    row[f"{kid} {hk} B=4096"] for hk in heads)
            results[f"{turn + 1}:{which}"] = row
            print(f"   {turn + 1}. {which}: " + ", ".join(
                f"{n} {v:.4f}" for n, v in row.items()), flush=True)
    finally:
        _build.load = change_load
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "ab.json"), "w") as fb:
        json.dump(results, fb, indent=1)
    done(t)


PHASES = ("env", "build", "tsan", "kernels", "infer", "readers", "cli_infer",
          "train", "multihead", "stream", "grid", "grid_stream", "cv",
          "cli_train")


def parse_args(argv):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated phases to run, in their fixed "
                    "order (default: all): " + ", ".join(PHASES) + "; "
                    "readers and train need infer, multihead, stream, "
                    "grid and cv need train, grid_stream needs grid")
    ap.add_argument("--ab", default=None, metavar="DIR",
                    help="also time the kernels built from DIR (a copy of "
                    "another commit's csrc/, e.g. the parent's unpacked "
                    "with git archive into a git-ignored directory) "
                    "against this checkout's, after the other phases")
    args = ap.parse_args(argv)
    args.phases = [p for p in args.phases.split(",") if p]
    bad = sorted(set(args.phases) - set(PHASES))
    if bad:
        ap.error(f"unknown phases {bad}; choose from {list(PHASES)}")
    for need, what in (("infer", "readers"), ("infer", "train"),
                       ("train", "multihead"), ("train", "stream"),
                       ("train", "grid"), ("train", "cv"),
                       ("grid", "grid_stream")):
        if what in args.phases and need not in args.phases:
            ap.error(f"phase {what} needs phase {need}")
    return args


def main(argv=None):
    t_run = time.perf_counter()
    args = parse_args(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing to check.", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    for var in PROGRAM_VARS:  # every phase picks its program itself
        os.environ.pop(var, None)
    # fp32 products in full fp32 for the plain versions (the default, stated)
    torch.backends.cuda.matmul.allow_tf32 = False
    run = set(args.phases)
    card = phase_env()
    parent_build = None
    if args.ab:  # nvcc on DIR's sources runs beside the phases
        from concurrent.futures import ThreadPoolExecutor
        pool = ThreadPoolExecutor(1)
        parent_build = pool.submit(_build.build, None,
                                   os.path.abspath(args.ab))
        pool.shutdown(wait=False)
    logs = phase_build() if "build" in run else {}
    if "tsan" in run:
        phase_tsan()
    kernels = []
    if "kernels" in run:
        phase_kernels(dev)
    if "infer" in run:
        packed, infer_params, infer_Q = phase_infer(dev)
    if "readers" in run:
        phase_readers(dev, packed, infer_params, infer_Q)
    if "cli_infer" in run:
        phase_cli_infer()
    if "train" in run:
        k_train, trained = phase_train(dev, packed)
        kernels += k_train
    if "multihead" in run:
        kernels += phase_multihead(dev, packed, trained["V"])
    if "stream" in run:
        add_launches(kernels, phase_stream(dev, packed, trained))
    if "grid" in run:
        totals, per_rank, grid_Qs = phase_grid(dev, card, packed, trained,
                                               infer_params, infer_Q)
        if "grid_stream" in run:
            more, more_per_rank = phase_grid_stream(
                dev, card, packed, trained, infer_params, grid_Qs)
            for name, c in more.items():
                totals[name] = totals.get(name, 0) + c
            per_rank.update(more_per_rank)
        add_launches(kernels, totals)
        for entry in kernels:
            entry["grid_launches_per_rank"] = {
                tag: [c[entry["name"]] for c in counts]
                for tag, counts in per_rank.items()}
    if "cv" in run:
        add_launches(kernels, phase_cv(dev, packed, trained))
    if "infer" in run:
        del packed
    if "cli_train" in run:
        phase_cli_train(dev)
    if parent_build is not None:
        phase_ab(dev, args.ab, parent_build, logs)

    print(f"chip_smoke: phases {','.join(args.phases)} passed in "
          f"{time.perf_counter() - t_run:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
