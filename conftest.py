"""How many intra-op threads torch runs in each process of a test run,
loaded ahead of tests/conftest.py.

torch gives a process one thread per core. Under pytest-xdist each of the
workers would do so, and the workers would then spend their time
contending for the cores. Each worker gets the cores divided by the number
of workers instead (at least one); a run without xdist keeps every core.
The count goes into OMP_NUM_THREADS, which the ranks a test spawns inherit,
unless the caller has set that variable, and into torch.set_num_threads in
case torch is already imported."""

import os
import sys


def worker_threads(cores, workers: int) -> int:
    """The intra-op threads of each of `workers` test processes on `cores`
    cores (os.cpu_count(): None where unknown)."""
    return max(1, (cores or 1) // workers)


def pytest_configure(config):
    if config.getoption("dist", "no") != "no" and config.getoption("tx", None):
        return  # xdist's controller runs no test; its workers come here on their own
    if "OMP_NUM_THREADS" in os.environ:
        return
    workers = getattr(config, "workerinput", {}).get("workercount", 1)
    threads = worker_threads(os.cpu_count(), workers)
    os.environ["OMP_NUM_THREADS"] = str(threads)
    if "torch" in sys.modules:
        sys.modules["torch"].set_num_threads(threads)
