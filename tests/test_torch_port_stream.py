"""Host streaming (out-of-core) in the port, on the CPU, against its
resident path and against the JAX package.

  * the trainer: a streamed run equals the resident run exactly (Q, P and
    every parameter ``torch.equal``) at ``sample_block`` 1 and 8, under the
    default, split, force-masked and indexed programs, supervised, and at
    every ``NA_TPU_STREAM_PREFETCH`` level (the counterparts of
    tests/test_stream.py:55, :125, :171, :383); from the JAX package's init
    and plans it tracks the JAX engine's streamed run under
    ``assert_trajectory_close``;
  * the set-up: the streamed RSVD, PCA projection and supervised means
    equal the resident ones exactly, and the JAX package's streamed ones
    within tests/test_torch_port_train.py's tolerances; the
    log-likelihood's streamed device blocks equal resident blocks exactly;
  * the auto policy under NA_TPU_HBM_CAPACITY_GB and its log lines, and the
    variable's validation (tests/test_stream.py:364);
  * the stager's ring: bytes, order and zero rows at every prefetch level,
    slot reuse, early close and its refusals;
  * under ``--stream 1`` the CLI never turns the whole packed matrix into a
    tensor (a spy on the upload);
  * on the card (``cuda`` marker): the staged batch equals the pageable one,
    a streamed step equals a resident one, and a streamed run allocates
    less than the packed matrix.

The JAX package and the tests' helpers are imported inside the tests that
use them, so that on the card ``python -m pytest --noconftest -m cuda
tests/test_torch_port_stream.py`` runs where JAX is not installed.
"""
import logging

import numpy as np
import pytest
import torch

from neural_admixture_tpu_torch.io.packed import pack_with_padding
from neural_admixture_tpu_torch.io.stage import HostStager, gather_rows
from neural_admixture_tpu_torch.ops.loglikelihood import (
    _device_block, loglikelihood_packed)
from neural_admixture_tpu_torch.ops.pack import unpack_genotypes
from neural_admixture_tpu_torch.ops.rsvd import rsvd
from neural_admixture_tpu_torch.train.engine import (
    NeuralAdmixtureTrainer, TrainConfig)
from neural_admixture_tpu_torch.train.init import (init_p_supervised_packed,
                                                   project_pca)
from neural_admixture_tpu_torch.utils.hbm import (hbm_capacity_bytes,
                                                  should_stream_host)

N, M, K, B = 61, 700, 3, 24
PROGRAMS = {"default": {}, "split": {"NA_TPU_SPLIT_LOSS": "1"},
            "masked": {"NA_TPU_FORCE_MASKED": "1"},
            "indexed": {"NA_TPU_INDEXED": "1"}}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _data(seed=3, n=N, m=M, k=K, d=4, missing=True):
    rng = np.random.default_rng(seed)
    G = rng.integers(0, 4 if missing else 3, size=(n, m)).astype(np.uint8)
    packed, _ = pack_with_padding(G)
    V = (rng.normal(size=(d, m)) * 0.1).astype(np.float32)
    P0 = rng.uniform(0.2, 0.8, size=(k, m)).astype(np.float32)
    return packed, V, P0


def _train(stream, blk=8, epochs=3, pops=None, device="cpu", **kw):
    packed, V, P0 = _data()
    cfg = TrainConfig(epochs=epochs, batch_size=B, learning_rate=1e-3,
                      seed=11, hidden_size=16, n_components=4, ks=[K],
                      progress=False, sample_block=blk, device=device,
                      stream=stream, **kw)
    tr = NeuralAdmixtureTrainer(cfg)
    Qs, Ps, params = tr.launch_training(P0, packed, V, M, N, pops=pops)
    return Qs, Ps, params, tr


def _assert_runs_equal(a, b):
    (Qa, Pa, pa), (Qb, Pb, pb) = a[:3], b[:3]
    from neural_admixture_tpu_torch.io.writers import _flatten
    for x, y in zip(Qa + Pa, Qb + Pb):
        assert torch.equal(torch.from_numpy(x), torch.from_numpy(y))
    fa, fb = _flatten(pa), _flatten(pb)
    assert fa.keys() == fb.keys()
    for name in fa:
        assert torch.equal(torch.from_numpy(fa[name]),
                           torch.from_numpy(fb[name])), name
    assert a[3].logged_losses == b[3].logged_losses


@pytest.mark.parametrize("program", list(PROGRAMS))
@pytest.mark.parametrize("blk", [1, 8])
def test_streamed_trainer_equals_resident(monkeypatch, blk, program):
    for var, val in PROGRAMS[program].items():
        monkeypatch.setenv(var, val)
    resident = _train(False, blk)
    streamed = _train(True, blk)
    assert not resident[3]._streamed and streamed[3]._streamed
    assert streamed[3].stager.bytes_gathered > 0
    assert resident[3].logged_losses  # epoch 0 logged
    _assert_runs_equal(streamed, resident)


def test_streamed_supervised_equals_resident():
    pops = np.random.default_rng(5).integers(0, K, size=N)
    _assert_runs_equal(_train(True, pops=pops), _train(False, pops=pops))


@pytest.mark.parametrize("prefetch", ["0", "1", "2"])
def test_stream_prefetch_levels_equal_resident(monkeypatch, prefetch):
    monkeypatch.setenv("NA_TPU_STREAM_PREFETCH", prefetch)
    streamed = _train(True)
    assert streamed[3].stager.prefetch == int(prefetch)
    _assert_runs_equal(streamed, _train(False))


def test_streamed_run_tracks_jax_engine(caplog):
    """The port's streamed run from the JAX package's init and plans against
    the JAX engine's streamed run (XLA path), as
    tests/test_torch_port_train.py:296 holds the resident runs."""
    from neural_admixture_tpu.train import engine as jengine
    from tests.conftest import assert_trajectory_close
    from tests.test_torch_port_train import (_flat, _jax_init_and_plans,
                                             _jax_losses)
    n, m, k, H, D, b, lr, seed, blk = 100, 6000, 3, 32, 4, 40, 2e-3, 5, 16
    packed, V, P0 = _data(10, n, m, k, D)
    m_pad = packed.shape[1] * 4
    kw = dict(epochs=2, batch_size=b, learning_rate=lr, seed=seed,
              hidden_size=H, n_components=D, ks=[k], progress=False,
              sample_block=blk, stream=True)
    caplog.set_level(logging.INFO)
    jtr = jengine.NeuralAdmixtureTrainer(jengine.TrainConfig(
        use_pallas=False, mesh_shape=(1, 1), **kw))
    Qj, Pj, pj = jtr.launch_training(P0, packed, V, m, n)
    assert jtr._streamed
    (loss_j,) = _jax_losses(caplog)
    params, plans = _jax_init_and_plans(seed, V, P0, H, [k], m_pad, n, b,
                                        blk, 2)
    tr = NeuralAdmixtureTrainer(TrainConfig(device="cpu", **kw))
    Qt, Pt, pt = tr.launch_training(P0, packed, V, m, n, init_params=params,
                                    plans=lambda e: plans[e])
    assert tr._streamed
    np.testing.assert_allclose(tr.logged_losses[0], loss_j, rtol=1e-5)
    assert_trajectory_close(Pt[0], Pj[0], lr)
    assert_trajectory_close(Qt[0], Qj[0], lr)
    for name, want in _flat(pj).items():
        assert_trajectory_close(_flat(pt)[name], want, lr)


@pytest.mark.parametrize("missing", [True, False])
def test_streamed_rsvd_equals_resident_and_jax(missing):
    from neural_admixture_tpu.ops.rsvd import rsvd as jrsvd
    n, m = 60, 700
    packed, _, _ = _data(4, n, m, missing=missing)
    block = 4 * packed.shape[1] * 4 * 7  # 7-row blocks
    resident = rsvd(torch.from_numpy(packed), n, m, k=5, seed=7,
                    block_bytes=block)
    streamed = rsvd(packed, n, m, k=5, seed=7, block_bytes=block,
                    stream=True)
    assert torch.equal(torch.from_numpy(streamed), torch.from_numpy(resident))
    want = jrsvd(packed, n, m, k=5, seed=7, block_rows=16, stream=True)
    for c in range(5):  # per component, as tests/test_stream.py:195
        np.testing.assert_allclose(streamed[c], want[c], rtol=0,
                                   atol=2e-4 * np.abs(want[c]).max(),
                                   err_msg=f"component {c}")


def test_streamed_pca_equals_resident_and_jax():
    from neural_admixture_tpu.train.init import project_pca as jproject
    n, m = 33, 500
    packed, _, _ = _data(5, n, m)
    V = np.random.default_rng(6).normal(size=(3, m)).astype(np.float32)
    block = 4 * packed.shape[1] * 4 * 5
    resident = project_pca(torch.from_numpy(packed), V, n, block_bytes=block)
    streamed = project_pca(packed, V, n, block_bytes=block, stream=True)
    assert torch.equal(streamed, resident)
    want = np.asarray(jproject(packed, V, n, block_rows=16, stream=True))
    np.testing.assert_allclose(streamed.numpy(), want, rtol=2e-5, atol=2e-5)


def test_streamed_supervised_init_equals_resident_and_jax():
    from neural_admixture_tpu.train.init import (
        init_p_supervised_packed as jinit)
    n, m, k = 50, 700, 3
    packed, _, _ = _data(9, n, m)
    y = np.random.default_rng(9).integers(0, k, size=n)
    block = 7 * 8 * packed.shape[1] * 4
    resident = init_p_supervised_packed(torch.from_numpy(packed), y, k, m,
                                        block_bytes=block)
    streamed = init_p_supervised_packed(packed, y, k, m, block_bytes=block,
                                        stream=True)
    assert torch.equal(torch.from_numpy(streamed), torch.from_numpy(resident))
    np.testing.assert_array_equal(streamed, jinit(packed, y, k, m, block=7))


def test_streamed_loglikelihood_blocks_equal_resident():
    """The device branch streams its 1 GB blocks; the sum is that of the
    same blocks read from resident rows, in the same order."""
    n, m, k = 50, 700, 4
    packed, _, _ = _data(12, n, m)
    rng = np.random.default_rng(13)
    P = rng.uniform(0.0, 1.0, size=(m, k))
    Q = rng.dirichlet(np.ones(k), size=n)
    got = loglikelihood_packed(packed, m, P, Q, device_threshold=0)
    P32 = torch.from_numpy(P.astype(np.float32))
    Q32 = torch.from_numpy(Q.astype(np.float32))
    want = _device_block(unpack_genotypes(torch.from_numpy(packed))[:, :m],
                         P32, Q32, 1e-6)  # one block: n rows < 1 GB
    assert got == want


def test_set_up_streams_by_its_estimate(monkeypatch):
    """stream=None (the set-up's auto mode) streams a host array only when
    its footprint does not fit: the packed rows, or the footprint given
    (the RSVD's, ops/rsvd.py resident_bytes)."""
    from neural_admixture_tpu_torch.io.stage import PackedRows
    from neural_admixture_tpu_torch.ops.rsvd import resident_bytes
    packed, _, _ = _data()
    monkeypatch.setenv("NA_TPU_HBM_CAPACITY_GB",
                       repr(packed.nbytes / 0.9 / 2**30 * 1.01))
    assert PackedRows(packed, N, 8, stream=None).resident is not None
    big = resident_bytes(N, packed.shape[1], 8)
    assert big > packed.nbytes
    assert PackedRows(packed, N, 8, stream=None,
                      footprint=big).host is not None
    tensor = PackedRows(torch.from_numpy(packed), N, 8, stream=None,
                        footprint=big)
    assert tensor.resident is not None  # a tensor is resident already


def _policy_trainer(stream, cap_gb, monkeypatch, caplog):
    monkeypatch.setenv("NA_TPU_HBM_CAPACITY_GB", repr(cap_gb))
    caplog.clear()
    caplog.set_level(logging.INFO)
    out = _train(stream, epochs=1)
    return out[3], [r.getMessage() for r in caplog.records]


def test_auto_stream_policy(monkeypatch, caplog):
    """stream=None streams only when the resident estimate does not fit
    and the streamed one does; --stream 1 streams whatever the capacity."""
    packed, _, _ = _data()
    m_pad = packed.shape[1] * 4
    n_rows = 64  # block_geometry(61, 24, 8): 2 full batches + 16 rows
    data_b = n_rows * packed.shape[1]
    batch_b = B * m_pad // 4
    plane = m_pad * (4 + K) * 4 * 4
    gib = 2**30
    between = (batch_b + plane + data_b / 2) / 0.9 / gib
    tr, lines = _policy_trainer(None, 16.0, monkeypatch, caplog)
    assert not tr._streamed
    assert not any("Host-streaming" in ln or "HBM need" in ln
                   for ln in lines)
    tr, lines = _policy_trainer(None, between, monkeypatch, caplog)
    assert tr._streamed
    want = (f"    Host-streaming (out-of-core) training: packed genotypes "
            f"({data_b / gib:.1f} GiB) stay in host memory; estimated "
            f"per-chip HBM need drops to ~{(batch_b + plane) / gib:.1f} GiB.")
    assert want in lines
    tiny = (batch_b + plane) / 2 / 0.9 / gib  # neither fits
    tr, lines = _policy_trainer(None, tiny, monkeypatch, caplog)
    assert not tr._streamed
    assert (f"    Estimated per-chip HBM need "
            f"~{(data_b + batch_b + plane) / gib:.1f} GiB exceeds "
            f"~{tiny:.0f} GiB capacity; training will likely OOM. Use "
            f"--stream 1 (single-device out-of-core).") in lines
    tr, lines = _policy_trainer(True, 16.0, monkeypatch, caplog)
    assert tr._streamed and any("Host-streaming" in ln for ln in lines)


def test_hbm_capacity_env_validation(monkeypatch):
    """The JAX package's errors (tests/test_stream.py:364), word for word."""
    from neural_admixture_tpu.utils.hbm import \
        hbm_capacity_bytes as jcapacity
    monkeypatch.setenv("NA_TPU_HBM_CAPACITY_GB", "2")
    assert hbm_capacity_bytes() == jcapacity() == 2 * 2**30
    assert hbm_capacity_bytes("cpu") == 2 * 2**30
    assert not should_stream_host(int(1.7 * 2**30))
    assert should_stream_host(int(1.9 * 2**30))
    for bad in ("sixteen", "0", "-1"):
        monkeypatch.setenv("NA_TPU_HBM_CAPACITY_GB", bad)
        with pytest.raises(ValueError, match="NA_TPU_HBM_CAPACITY_GB") as e:
            hbm_capacity_bytes()
        with pytest.raises(ValueError) as ej:
            jcapacity()
        assert str(e.value) == str(ej.value)
    monkeypatch.delenv("NA_TPU_HBM_CAPACITY_GB")
    assert hbm_capacity_bytes() == hbm_capacity_bytes("cpu") == 16 * 2**30


def _jobs(rng, n_src, n_jobs, rows):
    jobs = []
    for j in range(n_jobs):
        job = rng.integers(0, n_src, size=rng.integers(1, rows + 1))
        job[rng.random(job.shape) < 0.2] = -1
        jobs.append(job.astype(np.int64))
    return jobs


@pytest.mark.parametrize("threads", [1, 3])
@pytest.mark.parametrize("prefetch", [0, 1, 2])
def test_stager_hands_over_every_job_in_order(prefetch, threads):
    """Jobs of 1-9 rows, a fifth of them zero rows, each gather cut over
    ``threads`` threads."""
    rng = np.random.default_rng(0)
    src = rng.integers(0, 256, size=(40, 12), dtype=np.uint8)
    jobs = _jobs(rng, 40, 25, 9)
    stager = HostStager("cpu", 9, 12, prefetch=prefetch)
    stager.gather_threads = threads
    got = [b.clone() for b in stager.batches(src, iter(jobs))]
    assert len(got) == len(jobs)
    for job, b in zip(jobs, got):
        want = np.where((job >= 0)[:, None], src[np.maximum(job, 0)], 0)
        assert torch.equal(b, torch.from_numpy(want))
    assert stager.bytes_gathered == sum(map(len, jobs)) * 12
    # The ring is allocated once: a second pass reuses the same two slots.
    again = [b.data_ptr() for b in stager.batches(src, iter(jobs))]
    assert set(again) <= {h.data_ptr() for h in stager._host}


def test_stager_keeps_a_batch_until_the_next_is_asked_for():
    """While the caller holds batch i, the worker may fill only the other
    slot: batch i's bytes do not change until batch i+1 is asked for."""
    rng = np.random.default_rng(1)
    src = rng.integers(0, 256, size=(64, 16), dtype=np.uint8)
    jobs = [rng.permutation(64)[:8] for _ in range(30)]
    stager = HostStager("cpu", 8, 16, prefetch=1)
    import time
    for job, b in zip(jobs, stager.batches(src, iter(jobs))):
        time.sleep(0.001)  # the worker runs ahead meanwhile
        assert torch.equal(b, torch.from_numpy(src[job]))


def test_stager_close_early_and_refusals(monkeypatch):
    src = np.zeros((10, 8), np.uint8)
    stager = HostStager("cpu", 4, 8, prefetch=1)
    it = stager.batches(src, (np.arange(4) for _ in range(100)))
    next(it)
    it.close()  # a pending prefetch is waited for, the worker stopped
    with pytest.raises(ValueError, match="does not fit"):
        list(stager.batches(src, [np.arange(5)]))
    with pytest.raises(ValueError, match="outside the 10 host rows"):
        list(stager.batches(src, [np.array([10])]))
    with pytest.raises(ValueError, match="C-contiguous uint8 rows of 8"):
        list(stager.batches(np.zeros((10, 16), np.uint8)[:, ::2], []))
    out = np.ones((3, 8), np.uint8)
    gather_rows(np.arange(80, dtype=np.uint8).reshape(10, 8),
                np.array([2, -1]), out)
    assert (out[0] == np.arange(16, 24)).all() and not out[1].any() \
        and (out[2] == 1).all()
    monkeypatch.setenv("NA_TPU_STREAM_PREFETCH", "3")
    with pytest.raises(ValueError, match="NA_TPU_STREAM_PREFETCH"):
        HostStager("cpu", 1, 8)


@pytest.mark.parametrize("stream,uploads", [("1", False), ("0", True)])
def test_cli_stream_never_uploads_the_packed_matrix(monkeypatch, tmp_path,
                                                    stream, uploads):
    """A spy on every way a host array becomes a tensor: under --stream 1
    no tensor is ever made of the whole packed matrix (a view of the
    reader's array with all N rows) -- not for the RSVD, the init, the
    trainer, the Q pass or the log-likelihood; under --stream 0 the spy
    sees the upload."""
    from neural_admixture_tpu_torch import entry as tentry
    from neural_admixture_tpu_torch.train import run as trun
    from tests.conftest import DEMO_BED
    read, whole = trun.read_packed, []

    def spy_read(path):
        out = read(path)
        whole.append(out[0])
        return out

    seen = []

    def spied(fn):
        def wrapper(data, *a, **kw):
            if isinstance(data, np.ndarray) and whole and \
                    np.may_share_memory(data, whole[0]) and \
                    data.shape[0] >= whole[0].shape[0]:
                seen.append(fn.__name__)
            return fn(data, *a, **kw)
        wrapper.__name__ = fn.__name__
        return wrapper

    monkeypatch.setattr(trun, "read_packed", spy_read)
    for name in ("from_numpy", "as_tensor", "tensor"):
        monkeypatch.setattr(torch, name, spied(getattr(torch, name)))
    argv = ["train", "--k", "3", "--data_path", DEMO_BED, "--save_dir",
            str(tmp_path), "--name", "s", "--epochs", "2", "--seed", "1",
            "--num_gpus", "0", "--no_progress", "--stream", stream]
    assert tentry.main(argv) == 0
    assert bool(seen) == uploads, seen


def _card_case(seed=0, n=1000, m=40_000):
    rng = np.random.default_rng(seed)
    G = rng.integers(0, 4, size=(n, m)).astype(np.uint8)
    return pack_with_padding(G)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("piece_rows", [None, 37])
@pytest.mark.parametrize("prefetch", [0, 1, 2])
def test_staged_batches_equal_pageable_on_card(cuda_device, monkeypatch,
                                               prefetch, piece_rows):
    from neural_admixture_tpu_torch.io import stage
    packed = _card_case()
    if piece_rows:  # level 2 copies a job in several pieces
        monkeypatch.setattr(stage, "PIECE_BYTES", piece_rows *
                            packed.shape[1])
    rng = np.random.default_rng(1)
    jobs = _jobs(rng, packed.shape[0], 12, 300)
    stager = HostStager(cuda_device, 300, packed.shape[1], prefetch=prefetch)
    assert all(h.is_pinned() for h in stager._host)
    assert stager.piece_rows == (piece_rows if piece_rows and prefetch == 2
                                 else 300)
    for job, b in zip(jobs, stager.batches(packed, iter(jobs))):
        want = np.where((job >= 0)[:, None], packed[np.maximum(job, 0)], 0)
        assert b.device.type == "cuda"
        assert torch.equal(b.cpu(), torch.from_numpy(want))


@pytest.mark.cuda
def test_streamed_run_equals_resident_on_card(cuda_device):
    resident = _train(False, device=str(cuda_device))
    streamed = _train(True, device=str(cuda_device))
    _assert_runs_equal(streamed, resident)


@pytest.mark.cuda
def test_streamed_run_allocates_less_than_the_packed_rows(cuda_device):
    """N = 4096 rows of 40,960 SNPs (42 MB packed), batch 64: a streamed
    run's peak allocation (two 1024-row slots for the Q pass) stays below
    the packed matrix."""
    n, m = 4096, 40_960
    rng = np.random.default_rng(2)
    packed = pack_with_padding(rng.integers(0, 3, size=(n, m)).astype(
        np.uint8))[0]
    V = (rng.normal(size=(4, m)) * 0.01).astype(np.float32)
    P0 = rng.uniform(0.2, 0.8, size=(2, m)).astype(np.float32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cfg = TrainConfig(epochs=1, batch_size=64, seed=0, hidden_size=16,
                      n_components=4, ks=[2], progress=False,
                      sample_block=16, device=str(cuda_device), stream=True)
    NeuralAdmixtureTrainer(cfg).launch_training(P0, packed, V, m, n)
    assert torch.cuda.max_memory_allocated() - base < packed.nbytes
