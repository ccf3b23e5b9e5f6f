"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), the
reference imports nothing of the program, and a run without a card or
without the program fails before printing a result."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

from port_bench.tests.conftest import ROOT

BENCH = ROOT / "port_bench"
BANNED = {"jax", "jaxlib", "flax", "channel_pruning_tpu"}
PROGRAM = "channel_pruning_tpu_torch"


def _top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == \
                "import_module" and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def _sources():
    return [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]


def test_nothing_imports_jax_or_the_jax_package():
    for p in _sources():
        assert not (_top_level_imports(p) & BANNED), p


def test_only_the_job_module_imports_the_program():
    for p in _sources():
        if PROGRAM in _top_level_imports(p):
            assert p == BENCH / "job.py", p


def test_nothing_reads_the_jax_benchmark():
    for p in _sources():
        text = p.read_text()
        assert "bench.py" not in text and "BENCH_r" not in text, p


def _run(cwd: Path, env_extra: dict) -> subprocess.CompletedProcess:
    env = {**os.environ, **env_extra}
    return subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                           "vgg16.cp5x", "--seed", "2147483999", "--seconds", "1",
                           "--trace", "0"], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_a_run_without_a_card_fails_with_no_result():
    r = _run(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert '"correct"' not in r.stdout


def test_a_run_without_the_program_fails_with_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path, {"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert '"correct"' not in r.stdout
