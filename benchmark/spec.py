"""Finding what belongs to a cell, by name, in files of its own.

``BENCHMARK.json`` at the root of the checkout lists the cells and metrics.
Each piece then lives in a file named after it, under this folder:

  workloads/<cell>.json       the cell: config, traffic, chips, why, and
                              the limits of its output check
  configs/<config>.json       the model and the training run: widths, heads,
                              batch, source, reduced, assumed
  traffic/<traffic>.json      the panel: samples, SNPs, the simulation's
                              parameters
  end_to_end/<metric>.py      a reader with ``read(run) -> float | None``
  metrics/<metric>.py         the same, for a per-layer metric

A later cell, configuration or metric is new files and new entries in
``BENCHMARK.json``; nothing here names one.
"""
import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclass
class Cell:
    name: str
    workload: Dict
    config: Dict
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark_json(root: str) -> Dict:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def applies(metric: Dict, cell: str) -> bool:
    """A metric without ``workloads`` is every cell's."""
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, root: str, here: str = HERE) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json, with its files from
    ``here``."""
    bench = benchmark_json(root)
    if name not in {w["name"] for w in bench["workloads"]}:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    workload = _load_json(os.path.join(here, "workloads", f"{name}.json"))
    config = _load_json(os.path.join(here, "configs",
                                     f"{workload['config']}.json"))
    traffic = _load_json(os.path.join(here, "traffic",
                                      f"{workload['traffic']}.json"))
    return Cell(name, workload, config, traffic,
                [m for m in bench["end_to_end"] if applies(m, name)],
                [m for m in bench["per_layer"] if applies(m, name)])


def reader(kind: str, metric: str, here: str = HERE
           ) -> Callable[[object], Optional[float]]:
    """The ``read`` function of ``<kind>/<metric>.py``, loaded by path
    (``kind``: "end_to_end" or "metrics")."""
    path = os.path.join(here, kind, f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
