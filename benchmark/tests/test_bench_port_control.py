"""The control on the card: the reference put in the program's place with
TF32 products fails the cell's limits, and so do the half-batch and the
unchanged-state faults, over the first steps and at the window's replayed
steps. At a size a test run holds; the cells' own sizes are read by
``benchmark/control.py`` (PERF.md gives those readings)."""
import time

import pytest
import torch

from benchmark import control, harness, spec


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["train_k2to10_b800", "train_k8_b4096"])
def test_control_and_faults_fail_the_limits(cuda_device, name):
    cell = spec.load_cell(name, spec.HERE.rsplit("/", 1)[0])
    # the cell's model and batch; three full batches and a remainder of a
    # panel at a quarter of the cell's SNPs
    batch = int(cell.config["batch_size"])
    cell.traffic = dict(cell.traffic, samples=4 * batch + 1000,
                        snps=262144)
    limits = cell.workload["limits"]
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        out = control.readings(cell, seed, cuda_device)
        for kind in ("control", "half", "still"):
            assert any(out[kind][k] > limits[k] for k in limits
                       if k in out[kind]), (kind, out[kind], limits)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["train_k2to10_b800", "train_k8_b4096"])
def test_window_control_and_half_batch_fail_the_limits(cuda_device, name):
    cell = spec.load_cell(name, spec.HERE.rsplit("/", 1)[0])
    batch = int(cell.config["batch_size"])
    cell.traffic = dict(cell.traffic, samples=4 * batch + 1000,
                        snps=262144)
    limits = cell.workload["limits"]
    for seed in (2**31 + 4, 2**31 + 5, 2**31 + 6):
        res = harness.run(cell, seed, 0.5, False, cuda_device,
                          time.perf_counter(), controls=True)
        assert res["correct"], res["checks"]
        for kind in ("control", "half"):
            got = res["readings"][kind]
            assert any(got[k] > limits[k] for k in limits if k in got), \
                (kind, got, limits)
