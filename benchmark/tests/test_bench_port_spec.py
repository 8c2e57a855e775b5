"""Cells, configurations, traffic and metrics are found by name in files
of their own: one more of each is new files and new entries, with no edit
to a file that is there."""
import json
import os
import shutil

import pytest

from benchmark import spec

ROOT = os.path.dirname(spec.HERE)
COMPARED = {"loss_gap", "grad_gap", "change_gap_median", "win_loss_gap",
            "win_grad_gap", "win_change_gap", "params_differ",
            "q_gap", "p_outside"}


def test_every_entry_of_benchmark_json_has_its_files():
    bench = spec.benchmark_json(ROOT)
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"], ROOT)
        assert cell.workload["config"] == w["config"]
        assert cell.workload["traffic"] == w["traffic"]
        assert cell.workload["chips"] == w["chips"]
        assert cell.workload["why"] == w["why"]
        assert cell.config["name"] == w["config"]
        assert set(cell.workload["limits"]) == COMPARED
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    for c in bench["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert json.load(open(os.path.join(ROOT, c["file"])))["reduced"] \
            == c["reduced"]
    for m in bench["end_to_end"]:
        assert callable(spec.reader("end_to_end", m["name"]))
    for m in bench["per_layer"]:
        assert callable(spec.reader("metrics", m["name"]))


def test_an_added_cell_config_and_metric_are_found(tmp_path):
    here = tmp_path / "benchmark"
    shutil.copytree(spec.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = spec.benchmark_json(ROOT)
    before = {p: open(os.path.join(here, p)).read()
              for p in ("configs/na_k8.json", "workloads/train_k8_b4096.json")}
    config = dict(json.load(open(here / "configs" / "na_k8.json")),
                  name="na_k4", ks=[4])
    (here / "configs" / "na_k4.json").write_text(json.dumps(config))
    (here / "workloads" / "train_k4_dummy.json").write_text(json.dumps({
        "name": "train_k4_dummy", "config": "na_k4",
        "traffic": "panel_100k_1m", "chips": 1, "why": "a dummy",
        "limits": {"q_gap": 1.0}}))
    (here / "metrics" / "dummy_count.py").write_text(
        "def read(run):\n    return 42.0\n")
    bench["workloads"].append({"name": "train_k4_dummy", "config": "na_k4",
                               "traffic": "panel_100k_1m", "chips": 1,
                               "why": "a dummy"})
    bench["per_layer"].append({
        "name": "dummy_count", "unit": "1", "better": "lower",
        "source": "program_counter", "layer": "training step",
        "moves": "setup_s", "workloads": ["train_k4_dummy"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell("train_k4_dummy", str(tmp_path), str(here))
    assert cell.config["ks"] == [4]
    assert [m["name"] for m in cell.per_layer] == ["dummy_count"]
    assert spec.reader("metrics", "dummy_count", str(here))(None) == 42.0
    old = spec.load_cell("train_k8_b4096", str(tmp_path), str(here))
    assert "dummy_count" not in [m["name"] for m in old.per_layer]
    for p, text in before.items():
        assert open(os.path.join(here, p)).read() == text
    with pytest.raises(KeyError):
        spec.load_cell("no_such_cell", str(tmp_path), str(here))


def test_the_configs_and_the_cells_options_reach_the_trainer():
    from benchmark import harness
    cell = spec.load_cell("train_k8_b4096", ROOT)
    cfg = harness.train_config(cell, 11, 2**31 + 5, "cpu")
    assert (cfg.epochs, cfg.seed, cfg.device, cfg.progress) == \
        (11, 2**31 + 5, "cpu", False)
    assert cfg.stream is False
    for key in ("batch_size", "learning_rate", "hidden_size", "n_components",
                "ks", "log_every", "sample_block"):
        assert getattr(cfg, key) == cell.config[key], key
    # a cell that streams is data: its workload file's train_options
    cell.workload = dict(cell.workload, train_options={"stream": True})
    assert harness.train_config(cell, 1, 1, "cpu").stream is True
    cell.workload = dict(cell.workload, train_options={"no_such": 1})
    with pytest.raises(TypeError):
        harness.train_config(cell, 1, 1, "cpu")
