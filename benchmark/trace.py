"""Reading a torch.profiler Chrome trace of the traced period.

Times are the trace's microseconds. The device's work is the union of its
kernels, copies and memsets (CUPTI's ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` events), clipped to the period: the arithmetic of the
port's utils/trace.py ``busy_share``, copied here so that the yardstick
does not move with the program.

A kernel belongs to a host op when the op (a ``cpu_op`` or
``user_annotation`` event) encloses the kernel's launch on the launching
thread: the launch is the runtime or driver event with the kernel's
``correlation`` id, or else the op with the kernel's ``External id``.
"""
import bisect
import json
from typing import Dict, Iterable, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def load_events(path: str) -> List[Dict]:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _span(e: Dict) -> Tuple[float, float]:
    ts = float(e["ts"])
    return ts, ts + float(e.get("dur", 0.0))


def marker(events: List[Dict], name: str) -> Optional[float]:
    """Start of the first host event called ``name``."""
    ts = [float(e["ts"]) for e in events
          if e.get("cat") in HOST_CATS and e.get("name") == name]
    return min(ts) if ts else None


def device_intervals(events: List[Dict], start: float, end: float
                     ) -> List[Tuple[float, float]]:
    """The device's busy intervals in [start, end), merged and sorted."""
    spans = sorted((max(start, a), min(end, b))
                   for a, b in (_span(e) for e in events
                                if e.get("cat") in DEVICE_CATS))
    merged: List[Tuple[float, float]] = []
    for a, b in spans:
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


def busy_us(events: List[Dict], start: float, end: float) -> float:
    """Microseconds of [start, end) in which the device ran a kernel, a
    copy or a memset (the union of their intervals)."""
    return sum(b - a for a, b in device_intervals(events, start, end))


def device_ops(events: List[Dict], start: float, end: float, top: int = 10
               ) -> List[Tuple[str, float]]:
    """The device operations that took the most time in [start, end), as
    (name, seconds), summed by name."""
    by_name: Dict[str, float] = {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = _span(e)
        a, b = max(a, start), min(b, end)
        if b > a:
            name = e.get("name", e["cat"])[:64]
            by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
    return sorted(by_name.items(), key=lambda kv: -kv[1])[:top]


class HostOps:
    """The host ops of a trace, per thread, for "which ops enclose t".

    Ops of one thread nest (they are a call stack), so each op's parent is
    found once, and a query walks up from the last op that started."""

    def __init__(self, events: Iterable[Dict], skip: Iterable[str] = ()):
        skip = set(skip)
        per_tid: Dict = {}
        self.by_ext: Dict = {}
        for e in events:
            if e.get("cat") not in HOST_CATS or e.get("name") in skip:
                continue
            a, b = _span(e)
            thread = (e.get("pid"), e.get("tid"))
            per_tid.setdefault(thread, []).append((a, -b, e["name"]))
            ext = e.get("args", {}).get("External id")
            if ext is not None:
                self.by_ext[ext] = (thread[0], thread[1], a)
        self.ops, self.starts, self.parent = {}, {}, {}
        for thread, ops in per_tid.items():
            ops = [(a, -nb, name) for a, nb, name in sorted(ops)]
            parent, stack = [], []
            for i, (a, b, _) in enumerate(ops):
                while stack and ops[stack[-1]][1] < b:
                    stack.pop()
                parent.append(stack[-1] if stack else -1)
                stack.append(i)
            self.ops[thread] = ops
            self.starts[thread] = [a for a, _, _ in ops]
            self.parent[thread] = parent

    def enclosing(self, thread, t: float) -> List[Tuple[float, float, str]]:
        """The ops of ``thread`` that enclose ``t``, innermost first."""
        ops = self.ops.get(thread)
        if not ops:
            return []
        j = bisect.bisect_right(self.starts[thread], t) - 1
        parent = self.parent[thread]
        while j >= 0 and ops[j][1] < t:
            j = parent[j]
        out = []
        while j >= 0:
            out.append(ops[j])
            j = parent[j]
        return out

    def innermost(self, t: float) -> Optional[str]:
        """The name of the op, on any thread, that started last among those
        enclosing ``t``."""
        best = None
        for thread in self.ops:
            for a, _, name in self.enclosing(thread, t)[:1]:
                if best is None or a > best[0]:
                    best = (a, name)
        return best[1] if best else None


def idle_gaps(events: List[Dict], start: float, end: float,
              skip: Iterable[str] = (), top: int = 10
              ) -> List[Tuple[str, float]]:
    """The device's idle time in [start, end), summed by the host op that
    was running when each gap began (the innermost enclosing op), as
    (name, seconds), longest first."""
    ops = HostOps(events, skip)
    busy = device_intervals(events, start, end)
    gaps, reach = [], start
    for a, b in busy + [(end, end)]:
        if a > reach:
            gaps.append((reach, a))
        reach = max(reach, b)
    by_name: Dict[str, float] = {}
    for a, b in gaps:
        name = ops.innermost(a) or "(no host op)"
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
    return sorted(by_name.items(), key=lambda kv: -kv[1])[:top]


def launches(events: List[Dict]) -> Dict:
    """correlation id -> (pid, tid, ts) of each kernel launch."""
    out = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                out[corr] = (e.get("pid"), e.get("tid"), float(e["ts"]))
    return out


def kernel_us_under(events: List[Dict], start: float, end: float,
                    op_names: Iterable[str]) -> Optional[float]:
    """Summed device microseconds of the kernels in [start, end) launched
    inside a host op whose name is one of ``op_names``; None when no kernel
    is found there."""
    names = set(op_names)
    ops = HostOps(events)
    launch = launches(events)
    total, found = 0.0, False
    for e in events:
        if e.get("cat") != "kernel":
            continue
        a, b = _span(e)
        if not (start <= a < end):
            continue
        args = e.get("args", {})
        where = launch.get(args.get("correlation"))
        if where is None:
            where = ops.by_ext.get(args.get("External id"))
        if where is None:
            continue
        pid, tid, ts = where
        if any(name in names for _, _, name in ops.enclosing((pid, tid), ts)):
            total += min(b, end) - a
            found = True
    return total if found else None
