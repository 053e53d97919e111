"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port. Top-level module names are compared
whole: the port's name begins with the JAX package's."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "imagetransformations_tpu"}
PORT = "imagetransformations_tpu_torch"
FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def _imported(path: Path) -> set[str]:
    """Top-level names of every absolute import in ``path``."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.partition(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.partition(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(BENCH)) for p in FILES])
def test_no_jax_anywhere(path):
    assert not _imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in _imported(path)
    assert "harness" not in _imported(path)


def test_a_run_loads_no_jax_module():
    """Import every module a run loads (the harness, the reference, the
    port's entries) in a fresh process and list the top-level modules."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from harness import cell, sweep_kind, apply_all_kind, chain_kind, transform_window\n"
        "import controls\n"
        "from imagetransformations_tpu_torch.evalx import harness\n"
        "from imagetransformations_tpu_torch.pipeline import batch, chain\n"
        "from imagetransformations_tpu_torch.models import resnet, imagenet\n"
        "print(sorted(cell.forbidden_modules()))\n" % (str(BENCH), str(BENCH.parent)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_the_port_fails_and_prints_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and benchmark/, the run
    cannot import the port: it exits non-zero and prints no result."""
    import shutil

    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "imagenet-resnet50.chain", "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
