"""The (data, snp) grid of ranks: the counterpart of the JAX package's
parallel/mesh.py.

A D x S grid is D * S processes (ranks) of one torch.distributed world,
one device each. Rank r sits at (d, s) = (r // S, r % S):

  * the S ranks of data row d form its *snp group*; they hold the sample
    rows of the JAX package's process d, each the packed bytes of its SNP
    block s;
  * the D ranks of column s form its *data group*; they hold SNP block s
    (packed bytes [s W/S, (s+1) W/S), V rows and P columns [s m/S,
    (s+1) m/S)) of every data row's samples;
  * the world is every rank.

The parameters follow :func:`param_specs`, the JAX package's
parallel/mesh.py param_specs as slicing rules: V by rows and each decoder P
by columns over the snp axis, RMSNorm, the common MLP and the heads
replicated. :func:`shard_params` and :func:`unshard_params` move between a
full numpy parameter dict and the slices of it.

Collectives (:class:`Grid`) run over one of the three groups, named by the
axes they sum over as in ``jax.lax.psum``: NCCL between CUDA ranks, gloo
between CPU ranks. On the gloo backend a CUDA tensor is staged through a
host tensor on every call: one code path chosen by the backend, never a
reaction to a failure. Ranks on one card therefore run over gloo (NCCL
refuses two ranks on one device).

Tracing: :meth:`Grid.start_profile` makes every collective record its
host-clock seconds and bytes under its label, and the device time
between collectives (CUDA events; the host clock on a CPU rank); it costs a
device synchronisation before each collective while on, and nothing while
off.
"""
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..io.stage import gather_thread_share

DATA_AXIS = "data"
SNP_AXIS = "snp"

Axes = Union[str, Tuple[str, ...]]


def param_specs(params: Dict) -> Dict:
    """For each leaf of a parameter dict, the axis of the grid that each of
    its dimensions is sliced over (None: whole), as a tuple; () means
    replicated."""
    specs = {
        "V": (SNP_AXIS, None),
        "rmsnorm": {"weight": ()},
        "common": {"kernel": (), "bias": ()},
        "heads": {hk: {"kernel": (), "bias": ()}
                  for hk in params.get("heads", {})},
    }
    if "decoders" in params:
        specs["decoders"] = {hk: (None, SNP_AXIS)
                             for hk in params["decoders"]}
    return specs


def map_leaves(fn, params: Dict, specs: Dict) -> Dict:
    """``fn(leaf, spec)`` over a parameter dict and its specs."""
    return {k: (map_leaves(fn, v, specs[k]) if isinstance(v, dict)
                else fn(v, specs[k])) for k, v in params.items()}


def shard_params(params: Dict, n_snp: int, s: int) -> Dict:
    """The slice of a full numpy parameter dict that the ranks of column
    ``s`` of an ``n_snp``-wide snp axis hold (contiguous copies)."""
    def cut(a, spec):
        a = np.asarray(a)
        if SNP_AXIS not in spec:
            return a
        axis = spec.index(SNP_AXIS)
        n = a.shape[axis]
        if n % n_snp:
            raise ValueError(f"a dimension of {n} does not split over "
                             f"{n_snp} snp shards")
        w = n // n_snp
        return np.ascontiguousarray(np.take(a, np.arange(s * w, (s + 1) * w),
                                            axis=axis))
    return map_leaves(cut, params, param_specs(params))


def unshard_params(shards: Sequence[Dict]) -> Dict:
    """The inverse of :func:`shard_params`: the full parameter dict from the
    slices of columns 0..S-1, in order."""
    specs = param_specs(shards[0])

    def join(path, spec):
        parts = []
        for sh in shards:
            a = sh
            for key in path:
                a = a[key]
            parts.append(np.asarray(a))
        if SNP_AXIS not in spec:
            return parts[0]
        return np.concatenate(parts, axis=spec.index(SNP_AXIS))

    def walk(tree, spec, path):
        return {k: (walk(v, spec[k], path + (k,)) if isinstance(v, dict)
                    else join(path + (k,), spec[k]))
                for k, v in tree.items()}
    return walk(shards[0], specs, ())


@dataclass
class GridProfile:
    """What the collectives of a window cost: host-clock seconds and bytes
    moved off the rank per label, and the device time between them (ms;
    CUDA events on a CUDA rank, the host clock on a CPU rank)."""
    seconds: Dict[str, float] = field(default_factory=dict)
    bytes: Dict[str, int] = field(default_factory=dict)
    compute_ms: float = 0.0

    def add(self, label: str, seconds: float, nbytes: int) -> None:
        self.seconds[label] = self.seconds.get(label, 0.0) + seconds
        self.bytes[label] = self.bytes.get(label, 0) + nbytes


class Grid:
    """This rank's place on a D x S grid, its three process groups and the
    collectives over them. Built by every rank of an initialised
    torch.distributed world of D * S ranks (every group is created by every
    rank, in one order, as torch.distributed requires). ``host_ranks``:
    the ranks on this rank's host, which share its cores; a host stager of
    this rank gathers on ``gather_threads`` threads, its share."""

    def __init__(self, n_data: int, n_snp: int, device, host_ranks: int = 1):
        self.n_data, self.n_snp = int(n_data), int(n_snp)
        self.gather_threads = gather_thread_share(host_ranks)
        self.rank = dist.get_rank()
        world = dist.get_world_size()
        if world != self.n_data * self.n_snp:
            raise ValueError(f"a {n_data}x{n_snp} grid needs "
                             f"{n_data * n_snp} ranks; the world has {world}")
        self.d, self.s = divmod(self.rank, self.n_snp)
        self.device = torch.device(device)
        self.backend = dist.get_backend()
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError("the NCCL backend needs CUDA ranks")
        # Where the backend takes its tensors: the rank's card for NCCL,
        # host memory for gloo.
        self.comm_device = (self.device if self.backend == "nccl"
                            else torch.device("cpu"))
        self.data_group = self.snp_group = None
        for s in range(self.n_snp):
            g = dist.new_group([d * self.n_snp + s
                                for d in range(self.n_data)])
            if s == self.s:
                self.data_group = g
        for d in range(self.n_data):
            g = dist.new_group([d * self.n_snp + s
                                for s in range(self.n_snp)])
            if d == self.d:
                self.snp_group = g
        self.profile: Optional[GridProfile] = None
        self._segment = None

    @property
    def shape(self) -> Tuple[int, int]:
        return self.n_data, self.n_snp

    def _group(self, axes: Axes):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if set(axes) == {DATA_AXIS, SNP_AXIS}:
            return None  # the world
        if axes == (DATA_AXIS,):
            return self.data_group
        if axes == (SNP_AXIS,):
            return self.snp_group
        raise ValueError(f"unknown grid axes {axes}")

    # -- tracing -----------------------------------------------------------
    def _mark(self):
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def _close_segment(self) -> None:
        end = self._mark()
        if self.device.type == "cuda":
            end.synchronize()
            self.profile.compute_ms += self._segment.elapsed_time(end)
        else:
            self.profile.compute_ms += 1e3 * (end - self._segment)

    def start_profile(self) -> None:
        self.profile = GridProfile()
        self._segment = self._mark()

    def lap_profile(self) -> GridProfile:
        """The profile since the last start or lap; a new one starts."""
        self._close_segment()
        out = self.profile
        self.start_profile()
        return out

    def stop_profile(self) -> GridProfile:
        self._close_segment()
        out, self.profile, self._segment = self.profile, None, None
        return out

    def _collective(self, label: str, nbytes: int, outs: List[torch.Tensor],
                    ins: List[torch.Tensor], op) -> None:
        """Run ``op(*comm_outs, *comm_ins)`` on the backend's tensors: a
        tensor on another device than the backend's goes through a copy
        there, and each output comes back into its tensor."""
        if self.profile is not None:
            self._close_segment()
            t0 = time.perf_counter()
        c_outs = [t if t.device == self.comm_device else
                  t.to(self.comm_device) for t in outs]
        c_ins = [t if t.device == self.comm_device else
                 t.to(self.comm_device) for t in ins]
        op(*c_outs, *c_ins)
        for t, c in zip(outs, c_outs):
            if c is not t:
                t.copy_(c)
        if self.profile is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.profile.add(label, time.perf_counter() - t0, nbytes)
            self._segment = self._mark()

    # -- collectives -------------------------------------------------------
    def psum_(self, t: torch.Tensor, axes: Axes, label: str) -> torch.Tensor:
        """Sum ``t`` in place over the ranks of ``axes``; returns ``t``."""
        group = self._group(axes)
        self._collective(label, t.numel() * t.element_size(), [t], [],
                         lambda c: dist.all_reduce(c, group=group))
        return t

    def all_gather(self, t: torch.Tensor, axes: Axes, label: str
                   ) -> List[torch.Tensor]:
        """Every rank's ``t`` (one shape on every rank) over ``axes``, in
        group order (d for the data axis, s for the snp axis)."""
        group = self._group(axes)
        n = dist.get_world_size(group)
        outs = [torch.empty_like(t) for _ in range(n)]
        self._collective(
            label, t.numel() * t.element_size() * (n - 1), outs, [t],
            lambda *c: dist.all_gather(list(c[:n]), c[n], group=group))
        return outs

    def all_to_all_rows(self, out: torch.Tensor, inp: torch.Tensor,
                        out_rows: List[int], in_rows: List[int],
                        label: str) -> None:
        """Rows ``inp[sum(in_rows[:p]) : ...]`` to data row p, rows from data
        row p into ``out[sum(out_rows[:p]) : ...]``, over the data group."""
        row_bytes = inp[0].numel() * inp.element_size() if len(inp) else 0
        sent = sum(n for p, n in enumerate(in_rows) if p != self.d)
        self._collective(
            label, sent * row_bytes, [out], [inp],
            lambda o, i: dist.all_to_all_single(
                o, i, list(out_rows), list(in_rows), group=self.data_group))
