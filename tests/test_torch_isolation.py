"""The port stands alone: importing it pulls in neither JAX, flax nor the
JAX package, and no source of it (or of chip_smoke.py, the converter
tool and the quickstart) imports them."""

import torch_threads  # noqa: F401 (one torch thread in each test worker)

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "hopvae_tpu")


def test_import_leaves_no_jax_module():
    code = (
        "import sys; import hopvae_torch, hopvae_torch.serving, hopvae_torch.train, chip_smoke, "
        "hopvae_torch.ops.attention, hopvae_torch.ops.attention_cuda, hopvae_torch.models.priors, "
        "hopvae_torch.parallel.mesh, hopvae_torch.data, hopvae_torch.utils.checkpoint, hopvae_torch.utils.flops, "
        "hopvae_torch.utils.benchmark; "
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}); "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_import_no_jax():
    files = sorted((ROOT / "hopvae_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tools" / "torch_convert_checkpoint.py", ROOT / "examples" / "torch_quickstart.py",
    ]
    assert len(files) > 10 and ROOT / "hopvae_torch" / "parallel" / "mesh.py" in files
    assert {ROOT / "hopvae_torch" / "utils" / f"{m}.py" for m in ("flops", "benchmark")} <= set(files)
    bad = {str(f.relative_to(ROOT)): r for f in files for r in _imported_roots(f) if r in FORBIDDEN}
    assert not bad, bad
