"""The test processes' torch thread count (the repository's root
conftest.py): under pytest-xdist each worker runs the machine's cores
divided by the workers, at least one; a run without xdist keeps every core;
a caller's own OMP_NUM_THREADS is left as it is. Each case runs pytest in a
subprocess on a copy of the root conftest.py and a test that writes down
what its process sees."""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READING = '''
import os

import torch


def test_reading():
    name = os.environ.get("PYTEST_XDIST_WORKER", "main")
    with open(os.path.join(os.environ["READINGS"], name), "w") as f:
        f.write(f"{torch.get_num_threads()} {os.environ['OMP_NUM_THREADS']} {os.cpu_count()}")
'''


@pytest.mark.parametrize("workers,caller", [(2, None), (2, "3"), (0, None)],
                         ids=["xdist", "xdist_caller_threads", "one_process"])
def test_each_worker_runs_its_share_of_the_cores(tmp_path, workers, caller):
    shutil.copy(os.path.join(ROOT, "conftest.py"), tmp_path / "conftest.py")
    (tmp_path / "test_reading.py").write_text(READING)
    readings = tmp_path / "readings"
    readings.mkdir()
    env = {k: v for k, v in os.environ.items() if not k.startswith(("OMP_NUM_THREADS", "PYTEST_XDIST"))}
    env["READINGS"] = str(readings)
    if caller is not None:
        env["OMP_NUM_THREADS"] = caller
    xdist = ["-p", "xdist", "-n", str(workers)] if workers else []
    run = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", *xdist, "test_reading.py"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    (reading,) = [p.read_text().split() for p in readings.iterdir()]
    threads, omp, cores = (int(x) for x in reading)
    want = int(caller) if caller is not None else max(1, cores // max(1, workers))
    assert threads == omp == want
