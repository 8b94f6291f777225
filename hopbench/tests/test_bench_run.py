"""The run command: no result without a card, and none from the benchmark's
files alone."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["hopbench/run.py", "--workload", "ffhq64-recon", "--seed", "3000000019", "--seconds", "1", "--trace", "0"]


def _run(cwd):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, *ARGS], cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def _no_result(proc):
    for line in proc.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_fails_without_a_card():
    proc = _run(ROOT)
    assert proc.returncode == 3, proc.stderr
    assert "needs 1 CUDA device" in proc.stderr
    _no_result(proc)


def test_fails_with_the_benchmark_files_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "hopbench", tmp_path / "hopbench", ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    proc = _run(tmp_path)
    assert proc.returncode != 0
    _no_result(proc)
