"""A cell cut to a size the CPU runs in seconds, for the tests."""
import json

from benchmark import spec


def tiny_cell(name="train_k2to10_b800", ks=(2, 3), samples=300, snps=3000,
              batch=64):
    root = spec.HERE.rsplit("/", 1)[0]
    bench = spec.benchmark_json(root)
    cell = spec.load_cell(name, root)
    config = dict(cell.config, ks=list(ks), hidden_size=16, n_components=4,
                  batch_size=batch)
    traffic = dict(cell.traffic, samples=samples, snps=snps, populations=4)
    return spec.Cell(name, json.loads(json.dumps(cell.workload)), config,
                     traffic,
                     [m for m in bench["end_to_end"] if spec.applies(m, name)],
                     [m for m in bench["per_layer"] if spec.applies(m, name)])
