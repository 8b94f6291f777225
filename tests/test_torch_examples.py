"""The port's quickstart (``examples/torch_quickstart.py``) stays runnable:
one epoch on the CPU writes its three grids."""

import torch_threads  # noqa: F401 (one torch thread in each test worker)

import math
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "examples"))


def test_torch_quickstart_writes_its_three_grids(tmp_path):
    import torch_quickstart

    out = str(tmp_path / "q")
    res = torch_quickstart.main(["--device", "cpu", "--epochs", "1", "--n-train", "32", "--out", out])
    for name in ("quickstart_inputs.png", "quickstart_recons.png", "quickstart_samples.png"):
        path = os.path.join(out, name)
        assert os.path.exists(path) and open(path, "rb").read(8) == b"\x89PNG\r\n\x1a\n"
    assert res["grids"] == [os.path.join(out, n) for n in torch_quickstart.GRIDS]
    assert math.isfinite(res["recon_mse"]) and math.isfinite(res["aux"])
    assert os.path.exists(res["checkpoint"])
