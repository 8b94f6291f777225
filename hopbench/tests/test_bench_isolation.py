"""Nothing a cell's run imports is JAX or the JAX package, and the plain
reference imports nothing of the program."""

import ast
import os
import subprocess
import sys
from pathlib import Path

from hopbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "hopbench"


def _roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_import_no_jax():
    files = [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]
    assert len(files) > 15
    bad = {str(f.relative_to(ROOT)): r for f in files for r in _roots(f) if r in harness.FORBIDDEN}
    assert not bad, bad


def test_reference_imports_nothing_of_the_program():
    files = list((BENCH / "reference").rglob("*.py"))
    assert files
    assert {r for f in files for r in _roots(f)} <= {"__future__", "contextlib", "math", "numpy", "torch"}
    code = ("import sys; import hopbench.reference.model; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('hopvae_torch', 'hopvae_tpu', 'jax', 'flax')); "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_what_each_cell_imports_leaves_no_jax_module():
    """Import every module a run of each cell imports (the harness, every
    driver and reader, the program's entry points), then look at
    ``sys.modules`` as the run does once its window has closed."""
    code = (
        "import sys, json; from hopbench import harness, control; "
        "m = harness.load_manifest(); "
        "[harness.load_driver(harness.resolve(w['name']).traffic['kind']) for w in m['workloads']]; "
        "[harness.load_metric(p['name']) for p in m['per_layer']]; "
        "import hopvae_torch.train, hopvae_torch.serving, hopvae_torch.models.hopvae; "
        "bad = harness.forbidden_modules(); print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    monkeypatch.setitem(sys.modules, "hopvae_tpu_extra", sys)
    assert "jaxtyping_like" not in harness.forbidden_modules()
    assert "hopvae_tpu_extra" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax.numpy" in harness.forbidden_modules()
