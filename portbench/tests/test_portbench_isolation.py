"""What runs on the card imports neither JAX nor the JAX package, the
reference imports nothing of the program, and the harness refuses to print
a result without a card."""
import ast
import json
import os
import subprocess
import sys

import pytest

from portbench import bench

PROGRAM = "feynmandiagram_tpu_torch"


def _imports(path):
    """The top-level names of every module a file imports (absolute ones)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def _py_files(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_file_of_the_harness_imports_jax_or_the_jax_package():
    for path in _py_files(bench.HERE):
        assert not _imports(path) & set(bench.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    files = list(_py_files(os.path.join(bench.HERE, "reference")))
    assert len(files) > 30
    for path in files:
        names = _imports(path)
        assert PROGRAM not in names and "portbench" not in names, path
        with open(path) as f:
            text = f.read()
        assert f"import {PROGRAM}" not in text and f"from {PROGRAM}" not in text, path


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """A whole run (a small cell, eager calls, on the CPU) in a fresh process:
    no module whose top-level name is jax, jaxlib, flax or
    feynmandiagram_tpu is loaded once it is over."""
    code = (
        "import sys, time\n"
        "from portbench import bench\n"
        "from portbench.tests._cells import small_cell, CALL_TRAFFIC, SEED\n"
        "cell = small_cell('gamma4-o4', CALL_TRAFFIC, {'root_err': 1e-5})\n"
        "r = bench.run(cell, seed=SEED, seconds=0.2, trace=False, device='cpu',\n"
        "              t_start=time.perf_counter())\n"
        "assert r['correct'], r\n"
        "print(bench.forbidden_modules(), 'feynmandiagram_tpu_torch' in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=bench.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=bench.ROOT, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_forbidden_names_are_compared_whole():
    sys.modules.setdefault("jaxlike_module_for_test", sys)
    try:
        assert "jaxlike_module_for_test" not in bench.forbidden_modules()
    finally:
        del sys.modules["jaxlike_module_for_test"]


def _run_cli(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "gamma4-o4.call-4096", "--seed", str(2 ** 31 + 3), "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True, cwd=cwd, env=env,
                          timeout=300)


def test_without_a_card_the_harness_exits_nonzero_and_prints_no_result():
    out = _run_cli(bench.ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_with_only_the_benchmark_files_the_harness_prints_no_result(tmp_path):
    import shutil

    shutil.copytree(bench.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(bench.ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    out = _run_cli(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def test_every_cell_names_its_limits_file():
    with open(os.path.join(bench.ROOT, "BENCHMARK.json")) as f:
        cells = [w["name"] for w in json.load(f)["workloads"]]
    for cell in cells:
        assert os.path.exists(os.path.join(bench.HERE, "checks", cell + ".json"))


@pytest.mark.card
def test_a_run_on_the_card_loads_neither(card):
    """The harness's own process on the card, through its command: exit 0,
    one result line whose checks hold."""
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "gamma4-o4.call-4096",
                          "--seed", str(2 ** 31 + 77), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=bench.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
