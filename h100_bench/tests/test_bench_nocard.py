"""A run that finds no card fails and prints no result, where it would
otherwise fall back to the CPU; so does a checkout without the program."""

import os
import shutil
import subprocess
import sys

from bench_helpers import HERE, ROOT


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload",
         "harmonic1d.fine", "--seed", str(2 ** 35 + 1), "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        env=env, timeout=300)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(ROOT, env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = _run(tmp_path, env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
