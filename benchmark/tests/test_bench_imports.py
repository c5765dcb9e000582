"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: `pb_llm_tpu_torch` is the port, `pb_llm_tpu` the JAX
package); the reference imports nothing of the port; a run without a card,
or without the port beside the benchmark, prints no result."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from .conftest import ROOT

sys.path.insert(0, os.path.join(ROOT, "benchmark"))
from run import FORBIDDEN, forbidden_modules  # noqa: E402

BENCH = os.path.join(ROOT, "benchmark")


def test_top_level_names_are_compared_whole():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "pb_llm_tpu",
             "pb_llm_tpu.core.pbw", "pb_llm_tpu_torch", "pb_llm_tpu_torch.ops.counters",
             "jaxtyping", "flaxen", "benchmark.run", "torch"]
    assert forbidden_modules(names) == ["flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
                                        "pb_llm_tpu", "pb_llm_tpu.core.pbw"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _sources(*parts):
    for dirpath, _, files in os.walk(os.path.join(BENCH, *parts)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_source_imports_jax_and_the_yardstick_imports_no_port():
    for path in _sources():
        tops = {n.split(".", 1)[0] for n in _imports(path)}
        assert not tops & set(FORBIDDEN), path
    for part in ("reference", "weights"):
        for path in _sources(part):
            tops = {n.split(".", 1)[0] for n in _imports(path)}
            assert "pb_llm_tpu_torch" not in tops, path


def _python(code, cwd=ROOT):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_loaded_modules():
    probe = ("import sys; sys.path.insert(0, '.'); {imports}; "
             "print(sorted({{m.split('.')[0] for m in sys.modules}}))")
    ref = _python(probe.format(imports="import benchmark.reference, benchmark.reference.llama, "
                               "benchmark.reference.opt"))
    tops = set(json.loads(ref.stdout.replace("'", '"')))
    assert not tops & (set(FORBIDDEN) | {"pb_llm_tpu_torch"}), ref.stderr
    run = _python(probe.format(imports="import benchmark.harness.runner, benchmark.families.llama, "
                               "benchmark.families.opt, pb_llm_tpu_torch.runtime.server"))
    tops = set(json.loads(run.stdout.replace("'", '"')))
    assert "pb_llm_tpu_torch" in tops and not tops & set(FORBIDDEN), run.stderr


def _run_py(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "mistral-7b.batch",
                           "--seed", str(2**31 + 77), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here: the cuda tests run the cell itself")
    p = _run_py(ROOT)
    assert p.returncode != 0 and p.stdout.strip() == "", p.stderr


def test_benchmark_alone_no_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    p = _run_py(str(tmp_path))
    assert p.returncode != 0 and p.stdout.strip() == "", p.stderr
