"""The program's own spans in the traced period.

The port's epoch loop names what its host is doing with ``record_function``
spans (its utils/trace.py ``span``): ``na.plan`` and ``na.epoch_end`` at
each epoch's boundary, and per step ``na.batch``, ``na.forward``,
``na.backward``, ``na.adam`` and ``na.clamp``. They land in the same trace
as the card's kernels, on one clock, so the device's idle time can be put
down to the span the host was in, and a kernel to the span that launched
it. A trace without any ``na.*`` span (a program that records none) reads
None, never 0.
"""
from typing import Dict, Iterable, List, Optional, Tuple

from benchmark import trace

PREFIX = "na."
STEP = ("na.batch", "na.forward", "na.backward", "na.adam", "na.clamp")
EPOCH_END = ("na.plan", "na.epoch_end")
OPTIMIZER = ("na.adam", "na.clamp")


def has_spans(events: List[Dict]) -> bool:
    return any(e.get("cat") in trace.HOST_CATS
               and e.get("name", "").startswith(PREFIX) for e in events)


def _merge(spans: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


def span_intervals(events: List[Dict], names: Iterable[str], start: float,
                   end: float) -> List[Tuple[float, float]]:
    """The host intervals of the spans called one of ``names``, clipped to
    [start, end), merged and sorted."""
    names = set(names)
    out = []
    for e in events:
        if e.get("cat") in trace.HOST_CATS and e.get("name") in names:
            a = float(e["ts"])
            out.append((max(start, a), min(end, a + float(e.get("dur", 0.0)))))
    return _merge(out)


def idle_intervals(events: List[Dict], start: float, end: float
                   ) -> List[Tuple[float, float]]:
    """[start, end) less the device's busy intervals."""
    out, reach = [], start
    for a, b in trace.device_intervals(events, start, end) + [(end, end)]:
        if a > reach:
            out.append((reach, a))
        reach = max(reach, b)
    return out


def overlap_us(xs: List[Tuple[float, float]],
               ys: List[Tuple[float, float]]) -> float:
    """The length of the intersection of two merged, sorted lists."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_pct(run, names: Iterable[str]) -> Optional[float]:
    """Share of the traced period, in percent, in which the device runs no
    kernel, copy or memset while the host is inside a span of ``names``."""
    begin, end = run.period
    if not run.events or end <= begin or not has_spans(run.events):
        return None
    idle = overlap_us(idle_intervals(run.events, begin, end),
                      span_intervals(run.events, names, begin, end))
    return 100.0 * idle / (end - begin)


def kernel_ms_per_step(run, names: Iterable[str]) -> Optional[float]:
    """Device milliseconds a step of the period's kernels launched inside a
    span of ``names`` (attributed by correlation id, as
    trace.kernel_us_under attributes)."""
    begin, end = run.period
    if (not run.events or end <= begin or not run.period_steps
            or not has_spans(run.events)):
        return None
    us = trace.kernel_us_under(run.events, begin, end, names)
    return None if us is None else us * 1e-3 / len(run.period_steps)
