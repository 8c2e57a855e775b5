"""The no-JAX check compares top-level module names whole, and the
reference imports nothing of the program under test."""
import ast
import os

from benchmark import harness, spec


def test_banned_modules_by_whole_top_level_name():
    mods = ["torch", "numpy.linalg", "neural_admixture_tpu_torch",
            "neural_admixture_tpu_torch.train.engine", "jaxtyping",
            "flaxen", "benchmark.harness"]
    assert harness.banned_modules(mods) == []
    assert harness.banned_modules(mods + ["jax", "jax.numpy", "jaxlib.xla",
                                          "flax.linen",
                                          "neural_admixture_tpu.ops"]) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla",
        "neural_admixture_tpu.ops"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_the_yardstick_imports_neither_jax_nor_the_program():
    for name in ("reference.py", "work.py", "trace.py", "sim.py",
                 "plans.py", "spec.py"):
        mods = list(_imports(os.path.join(spec.HERE, name)))
        assert not harness.banned_modules(mods), name
        assert not [m for m in mods
                    if m.split(".")[0] == "neural_admixture_tpu_torch"], name


def test_no_file_of_the_benchmark_imports_jax():
    for dirpath, _, files in os.walk(spec.HERE):
        for f in files:
            if f.endswith(".py"):
                mods = list(_imports(os.path.join(dirpath, f)))
                assert not harness.banned_modules(mods), f
