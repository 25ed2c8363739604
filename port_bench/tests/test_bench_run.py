"""run.py as the driver starts it: no result without a card, and none in a
directory that holds only BENCHMARK.json and the benchmark's files."""

import shutil
import subprocess
import sys

from port_bench.tests.conftest import ROOT

ARGS = ["--workload", "res10-serve-b8", "--seed", str(2 ** 31 + 3), "--seconds", "1",
        "--trace", "0"]


def _run(cwd, env_extra=None):
    import os

    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "BENCH_RUN": "x", **(env_extra or {})}
    return subprocess.run([sys.executable, "port_bench/run.py", *ARGS], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    p = _run(ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = _run(tmp_path)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
