"""Several processes and hosts: the launcher of a grid's ranks, the
multi-host configuration, and the host-level helpers that set-up and
results need (the JAX package's parallel/distributed.py).

The JAX package runs one process per host, each seeing its local devices.
The port runs one process per device (a rank of a parallel/grid.py
``Grid``): each host starts its own ranks with the ``spawn`` start method
(:func:`spawn_grid`), and the ranks of every host join one
torch.distributed world. Host h's local rank i is global rank
h * local_ranks + i, and a host's local ranks cover whole data rows.

A D x S grid computes what the JAX package computes in a D-process run on a
(D, S) mesh: data row d plays process d. So the sample-row helpers below
(:func:`rows_per_process`, :func:`host_sample_shard`) take the data row as
the process, and the host-level reductions (:func:`allsum_hosts`,
:func:`gather_ragged_rows`) run over the data group, where the JAX package's
run over its processes; the S ranks of a data row compute the same values.

Copies of the JAX package's numpy helpers, kept here: the port imports
nothing of that package.
"""
import contextlib
import os
import pickle
import signal
import socket
import tempfile
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.logger import log, setup_logging
from .grid import DATA_AXIS, SNP_AXIS, Grid, map_leaves, param_specs


@dataclass(frozen=True)
class Hosts:
    """This host's place in a run over several hosts: the rendezvous
    address ``host:port`` (the coordinator, which runs global rank 0), the
    number of hosts and this host's index."""
    coordinator: str
    count: int
    index: int


def maybe_initialize_distributed(coordinator_address: Optional[str] = None,
                                 num_processes: Optional[int] = None,
                                 process_id: Optional[int] = None
                                 ) -> Optional[Hosts]:
    """This host's :class:`Hosts` when the run spans several hosts, from the
    arguments or the JAX package's variables NA_TPU_COORDINATOR,
    NA_TPU_NUM_PROCESSES (the number of hosts, as the JAX package counts
    processes) and NA_TPU_PROCESS_ID; None on one host.

    A partial configuration raises: every host would believe it is the
    master, duplicate the run and race on the output files. The process
    group itself starts in each rank (:func:`spawn_grid`)."""
    setup_logging()
    coord = coordinator_address or os.environ.get("NA_TPU_COORDINATOR")
    nproc = num_processes if num_processes is not None else \
        int(os.environ.get("NA_TPU_NUM_PROCESSES", "0") or 0)
    pid = process_id if process_id is not None else \
        (os.environ.get("NA_TPU_PROCESS_ID") or None)  # "" == unset
    if (coord or nproc > 1 or pid is not None) \
            and not (coord and nproc > 1 and pid is not None):
        raise ValueError(
            "Incomplete multi-process configuration: set ALL of "
            "NA_TPU_COORDINATOR, NA_TPU_NUM_PROCESSES (> 1), and "
            "NA_TPU_PROCESS_ID (or none of them). Got coordinator="
            f"{coord!r}, num_processes={nproc}, process_id={pid!r}.")
    if not coord:
        return None
    pid = int(pid)
    if not 0 <= pid < nproc:
        raise ValueError(f"NA_TPU_PROCESS_ID {pid} is not within "
                         f"[0, {nproc})")
    log.info(f"    Distributed: host {pid}/{nproc} via {coord}")
    return Hosts(coord, nproc, pid)


def is_master() -> bool:
    """Rank 0, or a run without a process group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def shutdown_distributed() -> None:
    """Tear down this rank's process group if there is one (the reference's
    process-group teardown on failure), so that a failing rank leaves its
    peers an error instead of a collective that never completes."""
    if dist.is_initialized():
        try:
            dist.destroy_process_group()
        except RuntimeError as exc:  # a peer already gone
            log.warning(f"    Process group teardown: {exc}")


def rows_per_process(N: int, d_sz: int, n_proc: int, quantum: int = 1) -> int:
    """Padded per-process resident-row count: N rounded up to
    lcm(d_sz, n_proc, quantum), divided evenly (the JAX package's formula,
    shared by :func:`host_sample_shard` and the trainer's layout)."""
    q = np.lcm(np.lcm(d_sz, n_proc), quantum)
    return int(((N + q - 1) // q) * q) // n_proc


def host_sample_shard(N: int, data_axis_size: int, quantum: int = 1,
                      index: int = 0, count: int = 1
                      ) -> Tuple[int, int, int]:
    """Process ``index`` of ``count``'s sample rows: (start, end,
    rows_per_process). Rows [start, end) are its own; its resident block is
    zero-padded to rows_per_process rows. On a grid, the process is the
    data row (``index`` = d, ``count`` = D). A tail process may own only
    padding: start and end are clamped to N."""
    if data_axis_size % count:
        raise ValueError(f"data axis ({data_axis_size}) must spread evenly "
                         f"over {count} processes")
    rows_pp = rows_per_process(N, data_axis_size, count, quantum)
    start = min(index * rows_pp, N)
    return start, min(start + rows_pp, N), rows_pp


def _as_comm(x: np.ndarray, grid: Grid) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(grid.comm_device)


def allsum_hosts(x: np.ndarray, grid: Optional[Grid]) -> np.ndarray:
    """Elementwise sum of a host array over the data rows (the data group;
    every column gets the same sum)."""
    x = np.asarray(x)
    if grid is None:
        return x
    t = grid.psum_(_as_comm(x, grid), DATA_AXIS, "allsum_hosts")
    return t.cpu().numpy()


def gather_ragged_rows(local: np.ndarray, grid: Optional[Grid]
                       ) -> np.ndarray:
    """The data rows' row blocks (unequal row counts allowed) concatenated
    in data-row order, on every rank."""
    local = np.asarray(local)
    if grid is None:
        return local
    counts = [int(c) for c in grid.all_gather(
        torch.tensor([local.shape[0]], dtype=torch.int64,
                     device=grid.comm_device), DATA_AXIS, "gather_counts")]
    padded = np.zeros((max(counts),) + local.shape[1:], local.dtype)
    padded[:local.shape[0]] = local
    parts = grid.all_gather(_as_comm(padded, grid), DATA_AXIS,
                            "gather_rows")
    return np.concatenate([p[:n].cpu().numpy()
                           for p, n in zip(parts, counts)], axis=0)


def gather_snp(tree: Dict, grid: Optional[Grid], label: str) -> Dict:
    """A numpy dict in the parameters' layout (the parameters, or one of
    Adam's moments of each) whole, on every rank of the snp group: the V
    and P slices gathered in order, the replicated leaves as this rank
    holds them. The inverse of parallel/grid.py shard_params."""
    if grid is None or grid.n_snp == 1:
        return tree

    def gather(a, spec):
        if SNP_AXIS not in spec:
            return a
        parts = grid.all_gather(_as_comm(a, grid), SNP_AXIS, label)
        return np.concatenate([p.cpu().numpy() for p in parts],
                              axis=spec.index(SNP_AXIS))
    return map_leaves(gather, tree, param_specs(tree))


def to_host(model, grid: Optional[Grid]):
    """A models.qp model's parameters as a full numpy dict (the JAX
    package's layout), on every rank (:func:`gather_snp`)."""
    from ..models.qp import params_to_numpy
    return gather_snp(params_to_numpy(model), grid, "to_host")


def free_port() -> int:
    """A TCP port that was free on this host a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@dataclass(frozen=True)
class GridSpec:
    """What every local rank of a host needs to join its grid."""
    n_data: int
    n_snp: int
    devices: Tuple[str, ...]
    backend: str
    init_method: str
    host_index: int
    threads: int


# Exit code of a run preempted by SIGTERM after its checkpoint was saved.
PREEMPTED_EXIT = 143


@dataclass(frozen=True)
class Preempted:
    """What a rank returns when its run saved a checkpoint on SIGTERM and
    exited with PREEMPTED_EXIT (the trainer's SystemExit)."""


def _rank_main(local_rank: int, spec: GridSpec, out_dir: str) -> None:
    """One rank: join the world, build the grid (and, on a card, the kernels:
    local rank 0 builds, the others wait at a barrier), run the call of
    ``out_dir/call.pkl``, ``fn(grid, *args)``, keep its return value (or
    :class:`Preempted`), and tear the group down whatever happens."""
    setup_logging()
    # Written by spawn_grid, in this program.
    with open(os.path.join(out_dir, "call.pkl"), "rb") as f:
        fn, args = pickle.load(f)
    world = spec.n_data * spec.n_snp
    rank = spec.host_index * len(spec.devices) + local_rank
    device = torch.device(spec.devices[local_rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(max(1, spec.threads))
    dist.init_process_group(spec.backend, init_method=spec.init_method,
                            world_size=world, rank=rank)
    try:
        grid = Grid(spec.n_data, spec.n_snp, device,
                    host_ranks=len(spec.devices))
        if device.type == "cuda":
            if local_rank == 0:
                from .. import _build
                _build.build()
            if spec.backend == "nccl":
                dist.barrier(device_ids=[device.index])
            else:
                dist.barrier()
        try:
            result = fn(grid, *args)
        except SystemExit as exc:
            if exc.code != PREEMPTED_EXIT:
                raise
            result = Preempted()
        with open(os.path.join(out_dir, f"rank{local_rank}.pkl"), "wb") as f:
            pickle.dump(result, f, protocol=pickle.HIGHEST_PROTOCOL)
    finally:
        shutdown_distributed()


def spawn_grid(fn: Callable, n_data: int, n_snp: int,
               devices: Optional[Sequence[str]] = None,
               backend: Optional[str] = None, args: tuple = (),
               hosts: Optional[Hosts] = None,
               init_method: Optional[str] = None,
               threads: int = 1) -> List:
    """Start this host's ranks of an ``n_data`` x ``n_snp`` grid, each
    running ``fn(grid, *args)`` (a module-level function: the ranks start
    with ``spawn``); returns their return values in local-rank order.

    ``devices``: one device per local rank (default: the CPU for each);
    ``backend``: "nccl" for CUDA ranks, "gloo" for CPU ranks (the default
    follows the devices; gloo takes CUDA ranks too, staging through host
    memory). ``hosts``: this host's place in a run over several hosts
    (:func:`maybe_initialize_distributed`); the rendezvous is then the
    coordinator's address, else a free local port or ``init_method``.

    A rank that fails ends the others and raises here. While the ranks
    run, SIGTERM to this process reaches every one of them (a scheduler may
    signal only the parent); when the ranks were preempted (their trainers
    agreed on the signal, saved a checkpoint and exited PREEMPTED_EXIT),
    this raises SystemExit(PREEMPTED_EXIT), and so it does when a forwarded
    SIGTERM ended a rank before its trainer could save."""
    n_hosts = hosts.count if hosts else 1
    world = n_data * n_snp
    if world % n_hosts:
        raise ValueError(f"a {n_data}x{n_snp} grid does not spread evenly "
                         f"over {n_hosts} hosts")
    local = world // n_hosts
    if local % n_snp:
        raise ValueError(
            f"each host's ranks must cover whole data rows of the grid: "
            f"{local} local ranks are not divisible by snp axis {n_snp}")
    devices = tuple(devices) if devices is not None else ("cpu",) * local
    if len(devices) != local:
        raise ValueError(f"{len(devices)} devices for {local} local ranks")
    if backend is None:
        backend = ("nccl" if all(torch.device(d).type == "cuda"
                                 for d in devices) else "gloo")
    if init_method is None:
        init_method = (f"tcp://{hosts.coordinator}" if hosts
                       else f"tcp://127.0.0.1:{free_port()}")
    spec = GridSpec(n_data, n_snp, devices, backend, init_method,
                    hosts.index if hosts else 0, threads)
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="na_grid_") as out_dir:
        # The call goes through a file, not the ranks' start-up pipes: a
        # pipe holds 64 KB, and the parent would wait on each rank's start
        # in turn for larger arguments.
        with open(os.path.join(out_dir, "call.pkl"), "wb") as f:
            pickle.dump((fn, args), f, protocol=pickle.HIGHEST_PROTOCOL)
        ctx = mp.start_processes(_rank_main, args=(spec, out_dir),
                                 nprocs=local, join=False,
                                 start_method="spawn")
        with _forward_sigterm(ctx.processes) as signalled:
            try:
                while not ctx.join():
                    pass
            except mp.ProcessExitedException as exc:
                if signalled and exc.exit_code == -signal.SIGTERM:
                    raise SystemExit(PREEMPTED_EXIT) from exc
                raise
        results = []
        for i in range(local):
            # Written by the ranks just started, from this program.
            with open(os.path.join(out_dir, f"rank{i}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    if any(isinstance(r, Preempted) for r in results):
        raise SystemExit(PREEMPTED_EXIT)
    return results


@contextlib.contextmanager
def _forward_sigterm(processes):
    """While inside, SIGTERM to this process is sent on to ``processes``
    (spawned ranks do not inherit this process's handlers); yields a list
    that is non-empty once a SIGTERM came. Signals reach only the main
    thread, so elsewhere this forwards nothing."""
    signalled: List[int] = []
    if threading.current_thread() is not threading.main_thread():
        yield signalled
        return

    def forward(signum, frame):
        signalled.append(signum)
        for p in processes:
            if p.is_alive():
                os.kill(p.pid, signal.SIGTERM)
    prev = signal.signal(signal.SIGTERM, forward)
    try:
        yield signalled
    finally:
        signal.signal(signal.SIGTERM, prev if prev is not None
                      else signal.SIG_DFL)
