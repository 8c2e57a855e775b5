"""The host->device stager: batches of packed rows read from host memory.

The counterpart of the JAX package's host slicing (train/chunked.py:15-63)
and of its double-buffered prefetch (train/engine.py:790-845, ``produce`` /
``consume`` under ``NA_TPU_STREAM_PREFETCH``). One stager serves every path
that reads packed rows from host memory: ``infer``'s batches, the streamed
training steps and Q pass, the streamed RSVD, PCA projection and supervised
means, and the log-likelihood's device blocks.

A job is an int64 vector of source rows, -1 for a zero row; its batch holds
exactly ``src[job]`` (zeros where -1), ``len(job)`` rows, and is handed to
the caller as a tensor on the stager's device. Jobs come from an iterable
that may be lazy, so a run can pipeline across epochs.

On the card:
  * two device slots of ``rows`` rows and a ring of two pinned host slots,
    allocated once per stager, never per batch. The host slots are pinned
    by registering them with the CUDA runtime (``cudaHostRegister``) after
    their pages were faulted in on every gather thread; pinning that fails
    raises (no pageable fallback);
  * a worker thread gathers job i+1's rows (``np.take`` straight into a
    pinned slot, split over ``gather_threads`` threads: numpy releases the
    interpreter lock) while the device runs batch i;
  * the copies run ``non_blocking`` on a side stream; the compute stream
    waits on the job's last copy event before the batch is handed over;
  * a pinned slot is refilled only after its last copy's event completed;
  * a device slot is overwritten only after the work the caller enqueued on
    it: an event recorded on the compute stream when the caller asks for the
    next batch, which the copy stream waits on. The slots live as long as
    the stager, so the caching allocator never hands their memory to
    another stream while a copy is in flight.
On the CPU the same ring and threads run without pinning or streams, and
the host slot itself is the batch.

``NA_TPU_STREAM_PREFETCH`` keeps the JAX package's meaning: 0 serial, 1
gather ahead, 2 gather and copy ahead; all three hand over the same bytes
in the same order. At 0 and 1 a host slot holds a whole job. At 2 the
worker gathers and copies a job in pieces of about ``PIECE_BYTES`` through
two small host slots, so the gather of one piece overlaps the copy of the
last and pinning costs a fraction: on the H100's host pinning cost about
0.5 s a GB, the gather ran at 13-19 GB/s on 8 threads and the copy at
44-54 GB/s (PERF.md). The default is 2 on the card and 1 on the CPU.
"""
import os
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from ..utils.hbm import should_stream_host

# Host slot size at prefetch level 2.
PIECE_BYTES = 32 << 20
# Gather threads of one stager: the cores of the H100's host.
MAX_GATHER_THREADS = 8


def gather_thread_share(host_processes: int = 1) -> int:
    """Gather threads of a stager in one of ``host_processes`` processes
    that share this host's cores (a grid's ranks on one host): its share of
    the cores, at most MAX_GATHER_THREADS and at least 1."""
    return max(1, min(MAX_GATHER_THREADS,
                      (os.cpu_count() or 1) // max(1, host_processes)))


def prefetch_level(device) -> int:
    """NA_TPU_STREAM_PREFETCH: 0, 1 or 2; by default 2 on a CUDA
    ``device``, else 1 (the JAX package's default)."""
    default = "2" if torch.device(device).type == "cuda" else "1"
    level = int(os.environ.get("NA_TPU_STREAM_PREFETCH", default) or 0)
    if level not in (0, 1, 2):
        raise ValueError(f"NA_TPU_STREAM_PREFETCH must be 0, 1 or 2, got "
                         f"{level}")
    return level


def gather_rows(src: np.ndarray, rows: np.ndarray, out: np.ndarray) -> None:
    """``out[:len(rows)] = src[rows]``, zero rows where ``rows`` < 0.

    ``mode="clip"``: numpy buffers ``out`` under the default "raise" mode,
    a second copy of every byte; the rows are checked by the caller."""
    n = len(rows)
    np.take(src, rows, axis=0, out=out[:n], mode="clip")
    pad = rows < 0
    if pad.any():
        out[:n][pad] = 0


def _zero(a: np.ndarray) -> None:
    a[...] = 0


def _release(host, copy_stream, pool) -> None:
    """A stager's end: wait for its copies, unpin its host slots, stop its
    gather threads."""
    if copy_stream is not None:
        copy_stream.synchronize()
        cudart = torch.cuda.cudart()
        for h in host:
            err = int(cudart.cudaHostUnregister(h.data_ptr()))
            if err:
                raise RuntimeError(f"cudaHostUnregister failed: CUDA error "
                                   f"{err}")
    pool.shutdown(wait=True)


class HostStager:
    """Two device slots of ``rows`` x ``width`` uint8 bytes on ``device``
    and a ring of two host slots (see the module docstring).

    ``prefetch``: 0, 1 or 2 (default: NA_TPU_STREAM_PREFETCH). A gather
    is cut over ``gather_threads`` threads (default: the host's cores, up
    to 8; a grid's rank passes its share, :func:`gather_thread_share`).
    ``gather_seconds`` and ``bytes_gathered`` add up the host gather.
    :meth:`close` (or the stager's collection) unpins the host slots."""

    def __init__(self, device, rows: int, width: int,
                 prefetch: Optional[int] = None,
                 gather_threads: Optional[int] = None):
        self.device = torch.device(device)
        self.rows, self.width = int(rows), int(width)
        self.prefetch = (prefetch_level(self.device) if prefetch is None
                         else prefetch)
        self.cuda = self.device.type == "cuda"
        self.gather_threads = (gather_thread_share() if gather_threads is None
                               else max(1, int(gather_threads)))
        self._pool = ThreadPoolExecutor(self.gather_threads)
        # Rows of a host slot: a whole job, or a piece of one (level 2).
        self.piece_rows = self.rows
        if self.cuda and self.prefetch >= 2:
            self.piece_rows = min(self.rows,
                                  max(1, PIECE_BYTES // self.width))
        self._host = [torch.empty((self.piece_rows, self.width),
                                  dtype=torch.uint8) for _ in range(2)]
        self._host_np = [h.numpy() for h in self._host]
        self._copy_stream = None
        if self.cuda:
            self._dev = [torch.empty((self.rows, self.width),
                                     dtype=torch.uint8, device=self.device)
                         for _ in range(2)]
            self._copy_stream = torch.cuda.Stream(self.device)
            # Fault the pages in on every gather thread first: registering
            # untouched memory faults them on one.
            for h in self._host_np:
                self._split(_zero, len(h), h)
            cudart = torch.cuda.cudart()
            for i, h in enumerate(self._host):
                err = int(cudart.cudaHostRegister(h.data_ptr(), h.numel(),
                                                  0))
                if err:
                    for done in self._host[:i]:
                        cudart.cudaHostUnregister(done.data_ptr())
                    raise RuntimeError(
                        f"pinning a {h.numel()}-byte host slot failed "
                        f"(cudaHostRegister: CUDA error {err})")
        self.close = weakref.finalize(self, _release, self._host,
                                      self._copy_stream, self._pool)
        # The event of each host slot's last copy (it is free again once
        # that completed), of each device slot's last copy (its batch is
        # complete) and of the last work on each device slot.
        self._copied = [None, None]
        self._filled = [None, None]
        self._freed = [None, None]
        self._next_host = 0
        self.gather_seconds = 0.0
        self.bytes_gathered = 0

    def _split(self, fn, n: int, *arrays) -> None:
        """``fn(*(a[lo:hi] for a in arrays))`` over ``n`` rows cut evenly
        over the gather threads."""
        cuts = np.linspace(0, n, min(self.gather_threads, n) + 1).astype(
            np.int64)
        futures = [self._pool.submit(fn, *(a[lo:hi] for a in arrays))
                   for lo, hi in zip(cuts[:-1], cuts[1:])]
        for f in futures:
            f.result()

    def _gather(self, src: np.ndarray, rows: np.ndarray, h: int) -> None:
        """Host slot ``h`` <- src[rows], once its last copy completed."""
        if self._copied[h] is not None:
            self._copied[h].synchronize()
        t = time.perf_counter()
        self._split(lambda j, o: gather_rows(src, j, o), len(rows), rows,
                    self._host_np[h])
        self.gather_seconds += time.perf_counter() - t
        self.bytes_gathered += len(rows) * self.width

    def _copy(self, h: int, s: int, off: int, n: int) -> None:
        """Device slot ``s`` rows [off, off + n) <- host slot ``h``."""
        with torch.cuda.device(self.device), \
                torch.cuda.stream(self._copy_stream):
            if off == 0 and self._freed[s] is not None:
                self._copy_stream.wait_event(self._freed[s])
            self._dev[s][off:off + n].copy_(self._host[h][:n],
                                            non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._copy_stream)
            self._copied[h] = self._filled[s] = ev

    def _produce(self, src: np.ndarray, job: np.ndarray, s: int,
                 copy: bool) -> int:
        """Gather job into host slot s (a whole job) or, in pieces, through
        the host ring, copying each piece (``copy``) into device slot s."""
        if len(job) > self.rows:
            raise ValueError(f"a job of {len(job)} rows does not fit the "
                             f"stager's {self.rows}-row slots")
        if len(job) and int(job.max()) >= src.shape[0]:
            raise ValueError(f"job row {int(job.max())} outside the "
                             f"{src.shape[0]} host rows")
        if self.piece_rows == self.rows:
            self._gather(src, job, s)
            if copy and self.cuda:
                self._copy(s, s, 0, len(job))
            return len(job)
        for off in range(0, len(job), self.piece_rows):
            h, self._next_host = self._next_host, 1 - self._next_host
            piece = job[off:off + self.piece_rows]
            self._gather(src, piece, h)
            self._copy(h, s, off, len(piece))
        return len(job)

    def batches(self, src: np.ndarray, jobs: Iterable[np.ndarray]
                ) -> Iterator[torch.Tensor]:
        """For each job, a (len(job), width) uint8 tensor on the device
        holding ``src[job]``. A batch is valid until the next one is asked
        for, or until the next call of this method: its slot is then
        refilled. Close the iterator when leaving it early."""
        if src.dtype != np.uint8 or src.ndim != 2 or \
                src.shape[1] != self.width or not src.flags.c_contiguous:
            raise ValueError(f"src must be C-contiguous uint8 rows of "
                             f"{self.width} bytes, got {src.dtype} "
                             f"{src.shape}")
        if self.cuda:
            # Whatever the caller enqueued before this call may still read
            # either device slot (a batch of an earlier, unfinished call).
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._freed = [ev, ev]
        it = iter(jobs)
        ahead = self.prefetch >= 1
        worker = ThreadPoolExecutor(1) if ahead else None
        pending = None
        try:
            job = next(it, None)
            s = 0
            if ahead and job is not None:
                pending = worker.submit(self._produce, src, job, s,
                                        self.prefetch >= 2)
            while job is not None:
                if ahead:
                    n, pending = pending.result(), None
                else:
                    n = self._produce(src, job, s, True)
                job = next(it, None)
                if ahead and job is not None:
                    pending = worker.submit(self._produce, src, job, 1 - s,
                                            self.prefetch >= 2)
                if not self.cuda:
                    yield torch.from_numpy(self._host_np[s][:n])
                else:
                    if self.prefetch == 1:
                        self._copy(s, s, 0, n)
                    compute = torch.cuda.current_stream(self.device)
                    if n:
                        compute.wait_event(self._filled[s])
                    yield self._dev[s][:n]
                    ev = torch.cuda.Event()
                    ev.record(compute)
                    self._freed[s] = ev
                s = 1 - s
        finally:
            if pending is not None:
                pending.result()
            if worker is not None:
                worker.shutdown(wait=True)
            if self.cuda:
                self._copy_stream.synchronize()


class PackedRows:
    """The first N packed rows, read by a pass in blocks of ``block_rows``
    rows on one device: resident (``packed`` a tensor on that device, or a
    host array uploaded once) or, with ``stream``, streamed from the host
    array through one :class:`HostStager`, which every pass reuses.
    ``stream=None`` streams a host array when ``footprint`` bytes (default:
    its packed rows) would not fit the device (utils/hbm.py).
    ``gather_threads``: the stager's (default: :class:`HostStager`'s)."""

    def __init__(self, packed, N: int, block_rows: int, device=None,
                 stream: Optional[bool] = False,
                 footprint: Optional[int] = None,
                 gather_threads: Optional[int] = None):
        self.N, self.block_rows = int(N), max(1, int(block_rows))
        self.host = self.resident = None
        if isinstance(packed, torch.Tensor):
            self.device = packed.device
            self.resident = packed[:N]
        else:
            self.device = torch.device(device or "cpu")
            if stream is None:
                stream = should_stream_host(
                    footprint or N * packed.shape[1], device=self.device)
            if stream:
                self.host = np.ascontiguousarray(packed[:N])
                self.stager = HostStager(self.device,
                                         min(self.block_rows, max(1, N)),
                                         self.host.shape[1],
                                         gather_threads=gather_threads)
            else:
                self.resident = torch.from_numpy(
                    np.ascontiguousarray(packed[:N])).to(self.device)

    def blocks(self) -> Iterator:
        """(i, rows [i, i + block_rows) on the device), in row order."""
        if self.host is None:
            for i in range(0, self.N, self.block_rows):
                yield i, self.resident[i:i + self.block_rows]
            return
        jobs = (np.arange(i, min(i + self.block_rows, self.N),
                          dtype=np.int64)
                for i in range(0, self.N, self.block_rows))
        for j, blk in enumerate(self.stager.batches(self.host, jobs)):
            yield j * self.block_rows, blk
