"""The epoch loop's spans, and reading the Chrome traces that ``train
--profile_dir`` writes (train/engine.py EpochTrace): the ``epoch N`` spans,
the launches of the port's kernels, and the device's busy share over a
window.

:func:`span` names what the program is doing (``na.plan``, ``na.batch``,
``na.forward``, ``na.backward``, ``na.adam``, ``na.clamp``,
``na.epoch_end``) in whatever ``torch.profiler`` trace is recording, on the
clock of the card's kernels; with no profiler recording it costs one check.

Times are the trace's microseconds. A span's window is its host interval;
the device's work in it is the union of its kernels, copies and memsets
(CUPTI's ``kernel``, ``gpu_memcpy`` and ``gpu_memset`` events), clipped to
the window.
"""
import contextlib
import json
import re
from typing import ContextManager, Dict, List, Tuple

import torch

# The main kernel of each wrapper's launch (csrc/*.cu); dq_dp's
# WITH_LOSS instance is loss_dq_dp. An indexed form counts as its kernel.
KERNELS = (("xv_mma_kernel", "xv"), ("dq_dp_kernel", "dq_dp"),
           ("dv_mma_kernel", "dv"), ("bce_sum_kernel", "bce_sum"))
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "na."
_OFF = contextlib.nullcontext()


def span(name: str) -> ContextManager:
    """A ``record_function`` span ``na.<name>`` while a profiler records;
    otherwise one shared no-op context. A span left open across the
    profiler's stop closes without error."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(SPAN_PREFIX + name)
    return _OFF


def load_events(path: str) -> List[Dict]:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def epoch_spans(events: List[Dict]) -> List[Tuple[str, float, float]]:
    """(name, start, end) of each ``epoch N`` span, in order."""
    return sorted(((e["name"], float(e["ts"]), float(e["ts"]) + e["dur"])
                   for e in events if e.get("cat") == "user_annotation"
                   and e.get("name", "").startswith("epoch ")),
                  key=lambda s: s[1])


def _template_args(name: str) -> List[str]:
    """A kernel's template arguments, from its demangled name (``<8,
    false, true, true, false>``) or its mangled one (``ILi8ELb0E...E``)."""
    m = re.search(r"<([^<>]*)>", name)
    if m:
        return [a.strip() for a in m.group(1).split(",")]
    m = re.search(r"I((?:L[ib]\d+E)+)E", name)
    if not m:
        return []
    return [("true" if v == "1" else "false") if t == "b" else v
            for t, v in re.findall(r"L([ib])(\d+)E", m.group(1))]


def kernel_counts(events: List[Dict], start: float = float("-inf"),
                  end: float = float("inf")) -> Dict[str, int]:
    """Launches of each kernel (xv, dq_dp, loss_dq_dp, dv, bce_sum) that
    start in [start, end)."""
    counts = {"xv": 0, "dq_dp": 0, "loss_dq_dp": 0, "dv": 0, "bce_sum": 0}
    for e in events:
        if e.get("cat") != "kernel" or not start <= e["ts"] < end:
            continue
        for marker, kernel in KERNELS:
            if marker in e["name"]:
                if kernel == "dq_dp" and _template_args(
                        e["name"])[3:4] == ["true"]:  # WITH_LOSS
                    kernel = "loss_dq_dp"
                counts[kernel] += 1
                break
    return counts


def busy_share(events: List[Dict], start: float, end: float) -> float:
    """The share of [start, end) in which the device ran a kernel, a copy or
    a memset (the union of their intervals)."""
    spans = sorted((max(start, float(e["ts"])),
                    min(end, float(e["ts"]) + e["dur"]))
                   for e in events if e.get("cat") in DEVICE_CATS)
    busy, reach = 0.0, start
    for a, b in spans:
        a = max(a, reach)
        if b > a:
            busy += b - a
            reach = b
    return busy / (end - start) if end > start else 0.0
