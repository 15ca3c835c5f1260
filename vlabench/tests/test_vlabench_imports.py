"""Nothing the benchmark imports is JAX or the JAX package: top-level
module names (the part before the first dot) compared whole, since the
PyTorch port's name begins with the JAX package's."""

import ast
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "roboticattack_tpu"}


def sources():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in sources():
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            assert not {n.split(".")[0] for n in names} & FORBIDDEN, (path, names)


def test_loading_every_benchmark_module_loads_no_jax():
    """In a fresh process (the test process has the repository's JAX
    tests beside it): the harness, every driver and metric, the reference
    and the calibration tool."""
    code = (
        "import os, sys; sys.path.insert(0, %r)\n"
        "from vlabench import run, calibrate\n"
        "for kind in ('drivers', 'metrics'):\n"
        "    for f in sorted(os.listdir(os.path.join(run.HERE, kind))):\n"
        "        if f.endswith('.py'): run.load_module(kind, f[:-3])\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n" % ROOT
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode == 0, out.stderr
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "roboticattack_torch" in loaded and not loaded & FORBIDDEN
