"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program: by the whole top-level name of
every module, since the program's name begins with the JAX package's."""
import ast
import json
import os
import subprocess
import sys

from benchmark import run

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = {"jax", "jaxlib", "flax", "diffcloth_tpu"}


def _imports(path: str) -> set:
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def _sources(sub: str):
    for d, _, files in os.walk(os.path.join(HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_sources_name_no_jax():
    for path in _sources(""):
        assert not _imports(path) & JAX, path


def test_reference_sources_name_nothing_of_the_program():
    for path in _sources("reference"):
        assert not _imports(path) & (JAX | {"diffcloth_tpu_torch"}), path


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=run.ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=run.ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    """A whole run of a cell at a tiny size on the CPU, then the process's
    modules."""
    from benchmark.tests.conftest import TINY
    mods = _loaded(
        "import torch; torch.set_num_threads(2)\n"
        "from benchmark import run\n"
        f"run.run_cell('sphere_mu.grad', 3, 0.1, False, device='cpu', "
        f"overrides={TINY['sphere_mu']!r})")
    assert "diffcloth_tpu_torch" in mods and not mods & JAX


def test_the_reference_loads_nothing_of_the_program():
    mods = _loaded("import benchmark.reference.scene, "
                   "benchmark.reference.judge")
    assert not mods & (JAX | {"diffcloth_tpu_torch"})
