"""Smoke run of the PyTorch/CUDA port on one CUDA card: ``python3 chip_smoke.py``.

Builds every kernel of the port from ``neural_admixture_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card, drives the main
path (projective inference, ``infer_q`` and the ``infer`` CLI) at full width,
times it, and checks its output. Phases, in order; any failure ends the run
with a non-zero exit and no result line:

  1. environment: a CUDA card is required; prints its name and power limit;
  2. build: compiles the kernels (nvcc), prints build seconds and ptxas info;
  3. kernel vs plain: xv against xv_plain at several small shapes;
  4. full width: infer_q at N=4096, M=1,000,000, K=8, H=1024, D=8, batch 1024
     (seeded random rows and weights); counts the kernel launches, times the
     kernel, its plain version and each part of a batch;
  5. CLI: a seeded K=7 checkpoint, then ``infer`` on the demo BED on the card
     and on the CPU, compared;
  6. one JSON line with every kernel's numbers;
  7. the last line: {"ok": true, "device": {...}}.

Imports nothing of JAX or of the JAX package.
"""
import json
import os
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
from neural_admixture_tpu_torch.io.writers import (  # noqa: E402
    save_checkpoint, save_config)
from neural_admixture_tpu_torch.models.qp import params_from_numpy  # noqa: E402
from neural_admixture_tpu_torch.ops.pack import packed_has_missing  # noqa: E402
from neural_admixture_tpu_torch.ops.xv import xv, xv_plain  # noqa: E402

SEED = 0
# H100 SXM data sheet: HBM3 rate and the fp32 rate of the CUDA cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# Full width: bench.py's M, N, K and the CLI defaults for D, H and batch.
N_FULL, M_FULL, K_FULL, D_FULL, H_FULL, BATCH = 4096, 1_000_000, 8, 8, 1024, 1024
LANE = 2048
DEMO_BED = os.path.join(REPO, "demo", "data", "demo_data.bed")


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


def check_xv(packed, V, no_missing):
    """Kernel vs plain on the card. Tolerance: fp32 sums in another order,
    |d| <= 1e-5 * sum_m |x||V| + 1e-6 per element."""
    got = xv(packed, V, no_missing)
    torch.cuda.synchronize()
    want = xv_plain(packed, V)
    scale = xv_plain(packed, V.abs())
    err = (got - want).abs()
    bound = 1e-5 * scale + 1e-6
    if not bool((err <= bound).all()):
        raise AssertionError(
            f"xv disagrees with xv_plain: max |d| {err.max().item():.3e}, "
            f"worst |d|/bound {(err / bound).max().item():.3f}")
    return err.max().item(), (err / (scale + 1e-30)).max().item()


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing to check.", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)

    t = phase("1. environment")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    done(t)

    t = phase("2. build")
    for name, info in _build.build().items():
        print(f"   {name}: {info['seconds']:.1f} s -> {info['path'].name}")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("     " + line.strip())
    done(t)

    t = phase("3. xv kernel vs xv_plain")
    rng = np.random.default_rng(SEED)
    # (B, M, D, missing in data, no_missing flag): B not a multiple of the
    # block's rows, M not a multiple of the 512-SNP chunk, D in {4, 8} and
    # the other template widths, with and without code 3.
    cases = [(37, 4000, 4, True, False), (37, 4000, 4, False, True),
             (130, 16400, 8, True, False), (130, 16400, 8, False, True),
             (130, 16400, 8, False, False), (65, 6160, 5, True, False),
             (9, 8192, 16, True, False), (70, 8192, 32, False, True),
             (1, 2048, 8, True, False)]
    for B, M, D, missing, no_missing in cases:
        packed = torch.from_numpy(random_packed(rng, B, M, M, missing)).to(dev)
        V = torch.from_numpy(rng.normal(size=(M, D)).astype(np.float32)).to(dev)
        a, r = check_xv(packed, V, no_missing)
        print(f"   B={B} M={M} D={D} missing={missing} no_missing={no_missing}:"
              f" max|d| {a:.3e}, max|d|/sum|x||V| {r:.3e}")
    done(t)

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
    # Host-clock split of one infer_q run into its steps: weights to the
    # card, the missing-code scan, then per batch the rows to the card, the
    # forward (xv + encoder) and Q back to the host.
    split = dict.fromkeys(("weights", "scan", "rows->card", "forward",
                           "Q->host"), 0.0)
    t_s = time.perf_counter()
    model = params_from_numpy(params, [K_FULL], dev)
    torch.cuda.synchronize()
    split["weights"] = time.perf_counter() - t_s
    t_s = time.perf_counter()
    no_missing = not packed_has_missing(packed)
    split["scan"] = time.perf_counter() - t_s
    with torch.no_grad():
        for i in range(0, N_FULL, BATCH):
            t_s = time.perf_counter()
            b = torch.from_numpy(packed[i:i + BATCH]).to(dev)
            torch.cuda.synchronize()
            t_f = time.perf_counter()
            q = model(b, no_missing)[f"k{K_FULL}"]
            torch.cuda.synchronize()
            t_q = time.perf_counter()
            q.cpu().numpy()
            t_e = time.perf_counter()
            split["rows->card"] += t_f - t_s
            split["forward"] += t_q - t_f
            split["Q->host"] += t_e - t_q
    print("   infer_q steps, host clock, ms in all: " + ", ".join(
        f"{k} {1e3 * v:.3f}" for k, v in split.items()))
    h2d_ms = cuda_ms(lambda: torch.from_numpy(packed[:BATCH]).to(dev), 5)
    pinned = torch.from_numpy(packed[:BATCH]).pin_memory()
    h2d_pinned_ms = cuda_ms(lambda: pinned.to(dev, non_blocking=True), 5)
    n_bytes = BATCH * W + m_pad * D_FULL * 4 + BATCH * D_FULL * 4
    n_flop = 2 * BATCH * m_pad * D_FULL
    t_bytes, t_flop = n_bytes / HBM_BYTES_PER_S, n_flop / FP32_FLOP_PER_S
    bound_ms = 1e3 * max(t_bytes, t_flop)
    bound_by = "bytes" if t_bytes >= t_flop else "operations"
    print(f"   per batch of {BATCH}: xv kernel {ms:.4f} ms (bound "
          f"{bound_ms:.4f} ms by {bound_by}: {n_bytes / 1e6:.1f} MB, "
          f"{n_flop / 1e9:.2f} GFLOP fp32; {100 * bound_ms / ms:.1f}% of it), "
          f"xv_plain {plain_ms:.3f} ms")
    print(f"   per batch: host->device copy {h2d_ms:.3f} ms pageable "
          f"({BATCH * W / h2d_ms / 1e6:.2f} GB/s), {h2d_pinned_ms:.3f} ms "
          f"pinned; encoder {enc_ms:.4f} ms; kernel {ms:.4f} ms; "
          f"infer_q wall {1e3 * wall / n_batches:.3f} ms per batch")
    kernels = [{"name": "xv", "route": "cuda",
                "source": "neural_admixture_tpu_torch/csrc/xv.cu",
                "replaces": "neural_admixture_tpu/ops/fused_step.py:99",
                "launches": launches, "max_abs_err": full_err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None}]
    del blk, pinned, model
    done(t)

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

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
